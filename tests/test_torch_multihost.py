"""The port's multi-process half of ``parallel/`` on four gloo ranks on the
CPU, against the JAX package's sharded results and against its own
results without a mesh, in float64.

One spawned group of four ranks (``tests/_torch_dist_worker.py``, through
``polympc_torch.multichip_point.launch``, joined within 120 s or killed)
computes every sharded result of the port from the numpy inputs made here
and writes it to the test's directory.  The group starts first; meanwhile
this process computes the JAX package's results on the conftest's fake CPU
devices, and hands the ranks the dist inputs as soon as it has them:

  * ``schur_horizon_solve`` and ``schur_horizon_factor`` +
    ``schur_horizon_apply``, without and with a parameter border, lane by
    lane on ``horizon_mesh(4)`` (the port: S=4 over 4 ranks, both KKT
    routes), atol 1e-9;
  * ``long_horizon_newton_step`` (the pendulum, S=8: two segments a
    rank, each rank building only its own blocks) against the JAX
    package's step sharded over ``horizon_mesh(8)``, atol 1e-7, and bit
    for bit against the port's mesh-less step;
  * ``dist_sqp_solve`` on ``horizon_mesh(8)`` (the kite, Chebyshev(5) x 8,
    as tests/test_dist_sqp.py's mesh test, at fewer iterations; the port:
    2 segments a rank),
    status and iterations equal, atol 1e-7; ``dist_refine`` on the mesh
    from that solution, atol 1e-9.

Against the port's own mesh-less results: the same, and
``make_batch_dist_solver`` on a (2, 2) ("dp", "seg") mesh (B=4 kite lanes)
and ``make_batch_solver(mesh=batch_mesh())`` (B=8) per lane; the
``DTensor`` helpers ``process_local_batch`` and ``shard_batch``; the
ValueError where S is not a multiple of the group size; the dry run's
stages (``multichip_point.stages``).  ``initialize_multihost`` is a no-op
in one process.
"""
import concurrent.futures
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist_worker as wk  # noqa: E402
from _torch_parity import single_thread  # noqa: E402,F401
from polympc_tpu.basis import Chebyshev as JChebyshev  # noqa: E402
from polympc_tpu.control.nmpf import augment_ocp as j_augment_ocp  # noqa: E402
from polympc_tpu.models import kite_dynamics as j_kite_dynamics  # noqa: E402
from polympc_tpu.models import kite_output as j_kite_output  # noqa: E402
from polympc_tpu.models import kite_path as j_kite_path  # noqa: E402
from polympc_tpu.parallel import dist_sqp as jd  # noqa: E402
from polympc_tpu.parallel import horizon as jh  # noqa: E402
from polympc_tpu.parallel import long_horizon as jl  # noqa: E402
from polympc_torch.multichip_point import launch  # noqa: E402
from polympc_torch.parallel import initialize_multihost  # noqa: E402

SCHUR_TOL = 1e-9
DIST_TOL = 1e-7
LONG_HORIZON_TOL = 1e-7
REFINE_TOL = 1e-9
JOIN_TIMEOUT = 120.0
# the dry run's stages run in float32 for two SQP iterations: the sharded
# and the mesh-less solves part only by the summation order of batched
# products over fewer segments a process
STAGE_TOL = 1e-3


def _jax_dist():
    ocp = j_augment_ocp(lambda x, u: j_kite_dynamics(x, u), j_kite_output,
                        j_kite_path, nx=3, nu=1, ny=2)
    dtr = jd.dist_transcribe(ocp, JChebyshev(5), wk.DIST_S, 0.0, 2.0)
    return dtr, jd.dist_bounds(dtr, x0=wk.KITE_X0, **wk.KITE_KW)


def _jax_schur(case):
    """JAX's sharded solve and factor + apply of both lanes, under one
    ``jit`` (an eager ``shard_map`` call compiles anew each time)."""
    mesh = jh.horizon_mesh(wk.SCHUR[case][0])
    lanes = wk.schur_lanes(case)

    def one(j):
        border = {n: j[n] for n in ("C", "Dg", "bg") if n in j}
        fac = jh.schur_horizon_factor(
            j["K"], j["E"], j["F"], mesh=mesh, G=j["G"], C=border.get("C"),
            Dg=border.get("Dg"))
        return {"solve": jh.schur_horizon_solve(
            j["K"], j["b"], j["E"], j["F"], j["c"], mesh=mesh, G=j["G"],
            **border), "lu": jh.schur_horizon_apply(fac, j["b"], j["c"],
                                                    bg=border.get("bg"))}

    out = jax.jit(lambda ls: [one(ln) for ln in ls])(
        [{n: jnp.asarray(v) for n, v in ln.items()} for ln in lanes])
    return {r: [o[r] for o in out] for r in ("solve", "lu")}


def _jax_long_horizon():
    """The JAX package's Newton step on the worker's inputs, sharded over
    horizon_mesh(8) (one segment a device)."""
    from polympc_tpu.basis import Chebyshev as JChebyshev
    from polympc_tpu.ocp.ocp import OCP

    def dyn(x, u, p, d, t):
        return jnp.array([x[1], -jnp.sin(x[0]) - 0.2 * x[1] + u[0]])

    def lag(x, u, p, d, t):
        return x @ x + 0.1 * (u @ u)

    lh = jl.LongHorizon(OCP(nx=2, nu=1, dynamics=dyn, lagrange=lag),
                        JChebyshev(4), S=wk.LH_S, t0=0.0, tf=4.0)
    Z, LAM, x0 = (jnp.asarray(a) for a in wk.long_horizon_inputs())
    mesh = jh.horizon_mesh(wk.LH_S)
    return jax.jit(lambda Z, LAM: jl.long_horizon_newton_step(
        lh, Z, LAM, x0, mesh=mesh))(Z, LAM)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    inputs = tmp / "inputs.npz"
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, wk.main, wk.NPROCS, "cpu",
                            (str(inputs), str(tmp)), JOIN_TIMEOUT)
        try:
            dtr, bounds = _jax_dist()
            mesh8 = jh.horizon_mesh(wk.DIST_S)
            W0, P0 = dtr.rollout_guess(
                jnp.asarray(wk.KITE_X0, jnp.float64), d=wk.D)
            jout = jax.jit(lambda W0, P0: jd.dist_sqp_solve(
                dtr, bounds, W0, P0, d=wk.D,
                settings=jd.DistSQPSettings(**wk.DIST_SETTINGS),
                mesh=mesh8))(W0, P0)
            arrays = {"dist_W0": np.asarray(W0)[None],
                      "dist_P0": np.asarray(P0)[None]}
            arrays.update({f"refine_in_{k}": np.asarray(jout[k])[None]
                           for k in wk.SOL_KEYS})
            with open(tmp / "inputs.part", "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp / "inputs.part", inputs)
            jref = jax.jit(lambda *a: jd.dist_refine(
                dtr, bounds, *a, d=wk.D, iters=2, mesh=mesh8))(
                *(jout[k] for k in wk.SOL_KEYS))
            jschur = {case: _jax_schur(case) for case in wk.SCHUR}
            jlh = _jax_long_horizon()
        finally:
            paths = ranks.result(timeout=JOIN_TIMEOUT + 30)
    got = [dict(np.load(p)) for p in paths]
    return {"jout": jout, "jref": jref, "jschur": jschur, "jlh": jlh,
            "ranks": got,
            "port": got[0], "meshless": {
                k[len("meshless_"):]: v for g in got for k, v in g.items()
                if k.startswith("meshless_")}}


def test_every_rank_holds_the_whole_result(run):
    """The replicated loop ends alike on every rank: each rank's W, duals
    and counts equal rank 0's bit for bit."""
    for other in run["ranks"][1:]:
        for k in ("dist_W", "dist_lam_if", "dist_iters", "refine_W",
                  "schur_border_solve_w", "composed_W", "batch_x", "lh_Z"):
            np.testing.assert_array_equal(other[k], run["port"][k], k)


@pytest.mark.parametrize("case", list(wk.SCHUR))
@pytest.mark.parametrize("route", ["solve", "lu", "kernel"])
def test_schur_sharded_matches_jax_and_meshless(run, case, route):
    port, own = run["port"], run["meshless"]
    want = run["jschur"][case]["solve" if route == "solve" else "lu"]
    names = ("w", "mu", "g") if case == "border" else ("w", "mu")
    for j, name in enumerate(names):
        key = f"schur_{case}_{route}_{name}"
        for lane in range(wk.SCHUR_LANES):
            np.testing.assert_allclose(port[key][lane],
                                       np.asarray(want[lane][j]),
                                       rtol=0, atol=SCHUR_TOL, err_msg=key)
        np.testing.assert_allclose(port[key], own[key], rtol=0,
                                   atol=SCHUR_TOL, err_msg=key)


def test_long_horizon_step_sharded_matches_jax_and_meshless(run):
    port, own = run["port"], run["meshless"]
    for name, want in zip(("Z", "LAM", "cont"), run["jlh"]):
        np.testing.assert_array_equal(port[f"lh_{name}"], own[f"lh_{name}"],
                                      name)
        np.testing.assert_allclose(port[f"lh_{name}"], np.asarray(want),
                                   rtol=0, atol=LONG_HORIZON_TOL,
                                   err_msg=name)


def test_dist_sqp_sharded_matches_jax_and_meshless(run):
    port, own, jout = run["port"], run["meshless"], run["jout"]
    assert int(port["dist_status"][0]) == int(jout["status"])
    assert int(port["dist_iters"][0]) == int(jout["iters"])
    assert int(port["dist_qp_iters"][0]) == int(jout["qp_iters"])
    for k in wk.SOL_KEYS:
        np.testing.assert_allclose(port[f"dist_{k}"][0], np.asarray(jout[k]),
                                   rtol=0, atol=DIST_TOL, err_msg=k)
    for k in wk.SOL_KEYS + ("status", "iters", "qp_iters"):
        np.testing.assert_allclose(port[f"dist_{k}"], own[f"dist_{k}"],
                                   rtol=0, atol=DIST_TOL, err_msg=k)


def test_dist_refine_sharded_matches_jax_and_meshless(run):
    port, own = run["port"], run["meshless"]
    for k, want in zip(wk.SOL_KEYS, run["jref"]):
        np.testing.assert_allclose(port[f"refine_{k}"][0], np.asarray(want),
                                   rtol=0, atol=REFINE_TOL, err_msg=k)
        np.testing.assert_allclose(port[f"refine_{k}"], own[f"refine_{k}"],
                                   rtol=0, atol=REFINE_TOL, err_msg=k)


def test_batch_dist_solver_on_a_2x2_mesh_matches_meshless(run):
    port, own = run["port"], run["meshless"]
    for k in ("status", "iters", "qp_iters"):
        np.testing.assert_array_equal(port[f"composed_{k}"],
                                      own[f"composed_{k}"], k)
    for k in ("W", "P"):
        np.testing.assert_allclose(port[f"composed_{k}"],
                                   own[f"composed_{k}"], rtol=0,
                                   atol=DIST_TOL, err_msg=k)
    assert port["composed_W"].shape[:2] == (wk.COMPOSED_B, wk.COMPOSED_S)


def test_batch_solver_on_a_dp_mesh_matches_unsharded(run):
    port, own = run["port"], run["meshless"]
    assert int(port["batch_local_rows"]) == wk.BATCH_B // wk.NPROCS
    for k in ("status", "iters"):
        np.testing.assert_array_equal(port[f"batch_{k}"], own[f"batch_{k}"])
    for k in ("x", "lam"):
        np.testing.assert_allclose(port[f"batch_{k}"], own[f"batch_{k}"],
                                   rtol=0, atol=1e-9, err_msg=k)


def test_local_rows_make_a_global_dtensor(run):
    port = run["port"]
    glob = np.arange(24, dtype=np.float64).reshape(8, 3)
    np.testing.assert_array_equal(port["plb_whole"], glob)
    np.testing.assert_array_equal(port["shard_batch_whole"], glob)
    assert int(port["plb_local_rows"]) == 4
    assert int(port["shard_batch_local_rows"]) == 2


def test_segments_must_be_a_multiple_of_the_group(run):
    msg = str(run["port"]["error_not_a_multiple"])
    assert "multiple of the group size" in msg, msg


@pytest.mark.parametrize("stage", ["dp", "seg", "dp_seg"])
def test_dry_run_stages_match_meshless(run, stage):
    port = run["port"]
    assert int(port[f"stage_{stage}_ranks"]) == wk.NPROCS
    assert float(port[f"stage_{stage}_diff"]) <= STAGE_TOL


def test_initialize_multihost_is_a_noop_in_one_process(monkeypatch):
    import torch.distributed as dist
    for k in ("POLYMPC_COORDINATOR", "POLYMPC_NUM_PROCESSES",
              "POLYMPC_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_multihost(device="cpu") is False
    assert initialize_multihost(num_processes=1, device="cpu") is False
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        initialize_multihost(num_processes=2, device="cpu")
    assert not dist.is_initialized()
