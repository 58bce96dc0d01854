"""The horizon sweep (polympc_torch/scaling_point.py, the port's twin of
benchmarks/scaling.py) against the JAX package on the CPU.

  * the SQP of a sweep point in float64 at S=2 and S=4, B=4 lanes of
    bench's draw, through both of the port's backends (the plain versions
    of the dense and the BBT epoch on the CPU), against the same lanes in
    the JAX package through its "lu" epoch (scaling.py's "pallas" route
    would run in interpret mode), as ``tests/data/make_scaling_reference.py
    --lanes`` records them in ``scaling_f64_lanes_jax_cpu.npz`` (the JAX
    float64 compile alone would cost this file most of its time): per lane
    status and iterations equal, x within 1e-6;
  * ``run_point`` itself (float32, the certify included) at S=2 and S=4;
  * the route table: each package's fit rules at S = 2, 4, 8, 16 (a
    change to either shows here), the routes the sweep takes and its rows;
  * the JAX record ``tests/data/scaling_jax_cpu.npz`` loads with bench's
    x0s and scaling.py's batch rule.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import single_thread  # noqa: E402,F401
from polympc_torch import scaling_point as sp  # noqa: E402
from polympc_torch.headline import KKT_TOL, bench_x0s  # noqa: E402
from polympc_torch.nlp import refine  # noqa: E402
from polympc_torch.ops.ldlt import LDLT_MAX_K  # noqa: E402
from polympc_torch.parallel import make_batch_solver  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
sys.path.insert(0, DATA)
import make_scaling_reference as msr  # noqa: E402

B = 4
X_TOL = 1e-6
# (S, K, port BBT fits, port dense fits, JAX BBT fits, JAX dense fits)
ROUTE_TABLE = [(2, 132, True, True, True, True),
               (4, 252, True, True, True, False),
               (8, 492, True, False, True, False),
               (16, 972, False, False, False, False)]


LANES_RECORD = os.path.join(DATA, "scaling_f64_lanes_jax_cpu.npz")


@pytest.fixture(scope="module", params=[2, 4], ids=["S2", "S4"])
def jax_point(request):
    """The JAX package's float64 solve of B lanes through "lu"."""
    S = request.param
    rec = np.load(LANES_RECORD)
    return S, {k: rec[f"s{S}_{k}"] for k in ("x", "status", "iters")}


@pytest.mark.parametrize("backend", sp.BACKENDS)
def test_sweep_point_matches_jax_lu_in_float64(jax_point, backend):
    S, want = jax_point
    tr, bounds, prm, settings = sp.sweep_problem(S, backend, "cpu",
                                                 torch.float64)
    x0 = torch.tensor(bench_x0s(B), dtype=torch.float64)
    sols = make_batch_solver(tr, bounds, prm, settings,
                             rollout_guess=True)(x0)
    np.testing.assert_array_equal(sols.status.numpy(), want["status"])
    np.testing.assert_array_equal(sols.iters.numpy(), want["iters"])
    np.testing.assert_allclose(sols.x.numpy(), want["x"], rtol=0,
                               atol=X_TOL)


@pytest.mark.parametrize("S", [2, 4])
def test_run_point_rows_on_the_cpu(S):
    row, lanes = sp.run_point(S, "bbt", B, reps=1, device="cpu",
                              warmup=False)
    assert row["route"] == "bbt" and row["K"] == 60 * S + 12
    assert row["batch"] == B and len(row["walls"]) == 1
    assert row["solved"] == int((lanes["status"] == 1).sum())
    assert row["certified"] == int((lanes["residual"] <= KKT_TOL).sum())
    assert row["certified"] >= 1 and np.isfinite(lanes["residual"]).all()
    assert lanes["x"].shape == (B, 35 * S + 7)
    assert lanes["lam"].shape == (B, 25 * S + 5)


@pytest.mark.parametrize("S,K,pbbt,pdense,jbbt,jdense", ROUTE_TABLE,
                         ids=[f"S{r[0]}" for r in ROUTE_TABLE])
def test_route_table_of_both_packages(S, K, pbbt, pdense, jbbt, jdense):
    from polympc_tpu.ops.admm_epoch import epoch_kernel_fits as j_dense
    from polympc_tpu.ops.bbt_kernel import bbt_kernel_fits as j_bbt
    from polympc_torch.ops.admm_epoch import epoch_kernel_fits
    from polympc_torch.ops.bbt_kernel import bbt_kernel_fits
    tr = sp.sweep_problem(S, "bbt", "cpu")[0]
    jtr = msr.problem(S, jnp.float32)[0]
    n, m = tr.nlp.n, tr.nlp.m
    assert (n + m, jtr.nlp.n, jtr.nlp.m) == (K, n, m)
    assert tr.bbt_structure().k == 72 and sp.batch_of(S) == max(128,
                                                                1024 // S)
    assert bbt_kernel_fits(tr.bbt_structure()) is pbbt
    assert epoch_kernel_fits(n, m) is pdense
    assert bool(j_bbt(jtr.bbt_structure())) is jbbt
    assert bool(j_dense(n, m)) is jdense
    routes = {b: sp.route_of(S, b) for b in sp.BACKENDS + ("auto",)}
    assert routes["bbt"] == ("bbt" if pbbt else "skipped")
    assert routes["dense"] == ("dense_kernel" if pdense else "skipped")
    assert routes["auto"] == ("bbt" if pbbt else "dense_kernel" if pdense
                              else "lu")
    # the certify's float32 Newton solves: the LDL^T kernels up to the
    # JAX package's pallas_fits bound, torch.linalg.solve above, in both
    # packages; the kernels themselves hold K=252
    from polympc_tpu.ops.ldlt import pallas_fits
    assert (K <= refine.REFINE_LDLT_MAX_K) is (S <= 2) is pallas_fits(K)
    assert (K <= LDLT_MAX_K) is (S <= 4)


def test_sweep_rows():
    assert sp.sweep_rows() == [(2, "dense"), (2, "bbt"), (4, "dense"),
                               (4, "bbt"), (8, "dense"), (8, "bbt"),
                               (16, "dense"), (16, "bbt"), (16, "auto")]


def test_scaling_record_loads():
    rec = np.load(os.path.join(DATA, "scaling_jax_cpu.npz"))
    assert rec["segments"].tolist() == list(sp.SEGMENTS)
    assert str(rec["route"]) == "lu" and int(rec["max_iter"]) == sp.MAX_ITER
    for S in sp.SEGMENTS:
        Bs = sp.batch_of(S)
        np.testing.assert_array_equal(rec[f"s{S}_x0s"], bench_x0s(Bs))
        for k in ("status", "iters", "residual", "certified"):
            assert rec[f"s{S}_{k}"].shape == (Bs,), (S, k)
        np.testing.assert_array_equal(rec[f"s{S}_certified"],
                                      rec[f"s{S}_residual"] <= KKT_TOL)
    lanes = np.load(LANES_RECORD)
    assert int(lanes["lanes"]) == B == msr.LANES
    for S in msr.LANES_SEGMENTS:
        n = sp.sweep_problem(S, "bbt", "cpu")[0].nlp.n
        assert lanes[f"s{S}_x"].shape == (B, n)
        assert lanes[f"s{S}_status"].shape == lanes[f"s{S}_iters"].shape \
            == (B,)


def _row(S, backend, launches, route=None):
    tr = sp.sweep_problem(S, backend, "cpu")[0]
    row = {"segments": S, "backend": backend, "K": tr.nlp.n + tr.nlp.m,
           "route": route or sp.route_of(S, backend), "launches": launches}
    if row["route"] == "skipped":
        row["skipped"] = "does not fit"
    return row


# (S, backend, the row's own launches, the route chip_smoke.py reads)
ROW_LAUNCHES = [
    (2, "bbt", {"bbt_epoch": 9, "ldlt_factor_solve": 3, "ldlt_solve": 18},
     "bbt"),
    (2, "dense", {"admm_epoch": 9, "ldlt_factor_solve": 3}, "dense_kernel"),
    (4, "bbt", {"bbt_epoch": 9}, "bbt"),
    (16, "auto", {}, "lu"),
    (16, "bbt", {}, "skipped")]


@pytest.mark.parametrize("S,backend,launches,route", ROW_LAUNCHES,
                         ids=[f"S{r[0]}-{r[1]}" for r in ROW_LAUNCHES])
def test_chip_smoke_reads_each_row_route_from_its_launches(S, backend,
                                                           launches, route):
    """chip_smoke.py reads each sweep row's route from the launches made
    around the row alone: its QPs' epoch kernel, and the LDL^T kernels in
    its certify exactly where K <= REFINE_LDLT_MAX_K."""
    cs = _chip_smoke()
    assert cs.row_route(_row(S, backend, launches),
                        refine.REFINE_LDLT_MAX_K) == route


# rows whose launches contradict their route
BAD_ROWS = [
    (2, "bbt", {"admm_epoch": 9, "ldlt_factor_solve": 3}),   # wrong epoch
    (2, "bbt", {"bbt_epoch": 9, "admm_epoch": 9,
                "ldlt_factor_solve": 3}),                      # two epochs
    (2, "dense", {"ldlt_factor_solve": 3}),                   # no epoch
    (2, "bbt", {"bbt_epoch": 9}),                             # no LDL^T
    (4, "bbt", {"bbt_epoch": 9, "ldlt_factor_solve": 3}),     # LDL^T > 206
    (16, "auto", {"bbt_epoch": 1}),                           # not LU
    (16, "dense", {"admm_epoch": 1})]                         # skipped


@pytest.mark.parametrize("S,backend,launches", BAD_ROWS,
                         ids=[f"{i}-S{r[0]}-{r[1]}"
                              for i, r in enumerate(BAD_ROWS)])
def test_chip_smoke_refuses_a_row_that_did_not_take_its_route(S, backend,
                                                              launches):
    cs = _chip_smoke()
    with pytest.raises(RuntimeError):
        cs.row_route(_row(S, backend, launches), refine.REFINE_LDLT_MAX_K)


def _chip_smoke():
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke
