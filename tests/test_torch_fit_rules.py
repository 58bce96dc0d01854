"""The kernels' fit rules and the routes they choose, on the CPU.

The JAX package runs the BBT epoch kernel only for a consistent structure
of the QP's own n and m that the kernel fits, else the dense epoch kernel
where the KKT fits it, else the LU epoch; its refine solves in float32
through the LDL^T kernels only where K fits them.  The port decides the
same way by shape, before any launch (``ops.bbt_kernel.bbt_kernel_fits``,
``qp.box_admm.epoch_route``, ``nlp.refine._newton_kkt_solve``); a wrapper
never falls back on a failed launch.  Checked here:

  * ``bbt_kernel_fits`` on the main paths' structures, at the register
    tile's edge (S=1: k=192 fits at 256 threads only, k=200 fits neither)
    and at the shared-memory edge (S=2, k=168); ``epoch_threads`` raises
    exactly where it is false, before it loads the library;
  * ``epoch_route`` for a fitting, a mismatched, an inconsistent and a
    too-large structure, and for the LU solver;
  * a QP whose structure does not fit solves as the same QP without a
    structure does (float64), and as the LU epoch does;
  * a float32 refine solve above ``refine.REFINE_LDLT_MAX_K`` (K=207)
    takes ``torch.linalg.solve`` and never the LDL^T kernels' entry point,
    K=206 takes the LDL^T route; that bound is the JAX package's
    ``pallas_fits`` rule for its refine solve.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402
from _torch_parity import single_thread  # noqa: E402,F401
from polympc_torch import cstr_point  # noqa: E402
from polympc_torch.headline_table import race_car_problem  # noqa: E402
from polympc_torch.nlp import refine  # noqa: E402
from polympc_torch.ops import _build, bbt_kernel  # noqa: E402
from polympc_torch.ops.admm_epoch import epoch_kernel_fits  # noqa: E402
from polympc_torch.ops.ldlt import LDLT_MAX_K  # noqa: E402
from polympc_torch.ops.structure import bbt_structure  # noqa: E402
from polympc_torch.qp import box_admm_solve  # noqa: E402
from polympc_torch.qp.box_admm import epoch_route  # noqa: E402
from polympc_torch.qp.types import ADMMSettings, QPData  # noqa: E402

# S=1 structures at the sweep's register tile (k = K) and an S=2 one whose
# working set passes a block's shared memory
TILE_192 = bbt_structure(6, 15, 2, 0, 0, 0, 5, 1)
TILE_200 = bbt_structure(7, 13, 2, 0, 0, 0, 6, 1)
SMEM_168 = bbt_structure(11, 12, 3, 0, 0, 0, 5, 2)
LU_341 = bbt_structure(11, 15, 1, 0, 0, 0, 5, 2)


def _cstr_structure():
    return cstr_point.cstr_problem("cpu")[3].qp.structure


def test_bbt_kernel_fits_the_main_paths():
    kite = tp.torch_kite()[3].qp.structure
    race = race_car_problem("cpu")[3].qp.structure
    cstr = _cstr_structure()
    assert (cstr.S, cstr.k, cstr.nx, cstr.a) == (2, 64, 4, 0)
    assert (cstr.n, cstr.m) == (66, 44)
    for st in (kite, race, cstr):
        assert bbt_kernel.bbt_kernel_fits(st)
        assert bbt_kernel._fitting_threads(st) == [128, 256]
        assert bbt_kernel.epoch_smem_bytes(st) <= _build.SMEM_LIMIT_BYTES


def test_bbt_kernel_fit_rule_edges():
    assert (TILE_192.S, TILE_192.k) == (1, 192)
    assert bbt_kernel._fitting_threads(TILE_192) == [256]
    assert (TILE_200.S, TILE_200.k) == (1, 200)
    # its shared memory fits; the register tile (k <= 192) rules it out
    assert bbt_kernel.epoch_smem_bytes(TILE_200) <= _build.SMEM_LIMIT_BYTES
    assert not bbt_kernel.bbt_kernel_fits(TILE_200)
    # the tile holds k=168 at 256 threads; shared memory rules it out
    assert (SMEM_168.S, SMEM_168.k) == (2, 168)
    assert SMEM_168.k <= _build.SWEEP_MAX_K[256]
    assert bbt_kernel.epoch_smem_bytes(SMEM_168) > _build.SMEM_LIMIT_BYTES
    assert not bbt_kernel.bbt_kernel_fits(SMEM_168)


@pytest.mark.parametrize("st", [TILE_200, SMEM_168, LU_341],
                         ids=["tile", "smem", "large"])
def test_epoch_threads_raises_where_nothing_fits(st, monkeypatch):
    def no_library():
        raise AssertionError("the fit rule needs no library")
    monkeypatch.setattr(_build, "library", no_library)
    with pytest.raises(ValueError, match="bbt_kernel_fits"):
        bbt_kernel.epoch_threads(st)


def _kernel_settings(st):
    return ADMMSettings(kkt_solver="kernel", structure=st)


def test_epoch_route_follows_the_jax_order():
    cstr = _cstr_structure()
    kite = tp.torch_kite()[3].qp.structure
    assert epoch_route(66, 44, _kernel_settings(cstr)) == "bbt"
    # a structure of another QP: the dense kernel, as without a structure
    assert epoch_route(66, 44, _kernel_settings(kite)) == "dense_kernel"
    assert epoch_route(66, 44, _kernel_settings(None)) == "dense_kernel"
    # an inconsistent structure (a row of its permutation dropped)
    bad = dataclasses.replace(cstr, perm=(cstr.perm[0][:-1], cstr.perm[1]))
    assert epoch_route(66, 44, _kernel_settings(bad)) == "dense_kernel"
    # structures the BBT kernel does not fit, of their own QPs
    for st in (TILE_200, SMEM_168):
        assert epoch_kernel_fits(st.n, st.m)
        assert epoch_route(st.n, st.m, _kernel_settings(st)) == \
            "dense_kernel"
    assert not epoch_kernel_fits(LU_341.n, LU_341.m)
    assert epoch_route(LU_341.n, LU_341.m, _kernel_settings(LU_341)) == "lu"
    for solver in ("lu", "inverse"):
        assert epoch_route(66, 44, ADMMSettings(
            kkt_solver=solver, structure=cstr)) == "lu"


def _random_qp(n, m, B, seed):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, n, n))
    H = G @ G.transpose(0, 2, 1) / n + np.eye(n)
    A = rng.normal(size=(B, m, n)) / np.sqrt(n)
    c = rng.normal(size=(B, m))
    xb = 1.0 + rng.uniform(size=(B, n))
    return QPData(H=tp.t64(H), h=tp.t64(rng.normal(size=(B, n))),
                  A=tp.t64(A), al=tp.t64(c - 0.5), au=tp.t64(c + 0.5),
                  xl=tp.t64(-xb), xu=tp.t64(xb))


def test_a_structure_that_does_not_fit_solves_the_same_qp():
    """The k=200 structure's QP (n=105, m=91) in float64: through the dense
    epoch as without a structure (identical), and as the LU epoch."""
    st = TILE_200
    qp = _random_qp(st.n, st.m, 2, 5)
    base = ADMMSettings(max_epochs=4, polish=False)
    sols = [box_admm_solve(qp, settings=dataclasses.replace(base, **kw))
            for kw in (dict(kkt_solver="kernel", structure=st),
                       dict(kkt_solver="kernel"), dict(kkt_solver="lu"))]
    for f in ("x", "y", "y_box"):
        assert torch.equal(getattr(sols[0], f), getattr(sols[1], f)), f
        np.testing.assert_allclose(getattr(sols[0], f).numpy(),
                                   getattr(sols[2], f).numpy(), rtol=1e-8,
                                   atol=1e-9, err_msg=f)
    assert torch.equal(sols[0].iters, sols[2].iters)


def _symmetric(K, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(1, K, K))
    M = A + A.transpose(0, 2, 1) + 4.0 * K * np.diag(
        np.where(np.arange(K) % 2, -1.0, 1.0))[None]
    return M, rng.normal(size=(1, K))


def test_refine_route_by_shape(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("ldlt_factor_solve called")
    monkeypatch.setattr(refine, "ldlt_factor_solve", no_kernel)
    M, r = _symmetric(refine.REFINE_LDLT_MAX_K + 1, 1)
    x = refine._newton_kkt_solve(torch.tensor(M, dtype=torch.float32),
                                 torch.tensor(r, dtype=torch.float32))
    x64 = np.linalg.solve(M[0], r[0])
    np.testing.assert_allclose(x[0].double().numpy(), x64, rtol=0,
                               atol=1e-5 * np.abs(x64).max())
    M, r = _symmetric(refine.REFINE_LDLT_MAX_K, 2)
    with pytest.raises(AssertionError, match="ldlt_factor_solve called"):
        refine._newton_kkt_solve(torch.tensor(M, dtype=torch.float32),
                                 torch.tensor(r, dtype=torch.float32))
    # float64 takes torch.linalg.solve at any K
    x = refine._newton_kkt_solve(torch.tensor(M), torch.tensor(r))
    np.testing.assert_allclose(x[0].numpy(), np.linalg.solve(M[0], r[0]),
                               rtol=1e-10)


def test_refine_route_bound_is_the_jax_rule():
    """The refine solve's LDL^T bound is the JAX package's ``pallas_fits``
    rule for its ``_newton_kkt_solve`` (a VMEM bound there), inside what
    the port's kernels hold."""
    from polympc_tpu.ops.ldlt import pallas_fits
    K = refine.REFINE_LDLT_MAX_K
    assert pallas_fits(K) and not pallas_fits(K + 1)
    assert K <= LDLT_MAX_K
