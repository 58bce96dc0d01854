"""The LDL^T kernels' substitution and the launch rules of the LDL^T and
dense-epoch kernels, on the CPU.

The LDL^T kernels (csrc/ldlt.cu) hold each matrix's upper triangle packed
by rows in shared memory and substitute by panels of 32 pivots, in float64
against the float32 factor; ``ops.ldlt.panel_solve_mirror`` is that
substitution in PyTorch.  The dense epoch kernel (csrc/admm_epoch.cu)
holds each instance's packed upper triangle and runs one instance per
warp.  Held here:

  * the mirror against ``ldlt_solve_plain`` in float64, to 1e-12;
  * the mirror against the JAX package's ``ldlt_solve`` (Pallas in
    interpret mode) on the JAX factor, in float64, to 1e-10;
  * on indefinite matrices whose unpivoted factor grows (small leading
    pivots, as the certify's Newton matrices have), the float32 factor
    solved by the mirror in float64: per lane, its residual at most
    chip_smoke.py's LDLT_RES_RATIO times the plain float32 solve's (or
    below LDLT_RES_FLOOR), on the lanes that rule holds;
  * the launch rules: packed offsets, shared memory and blocks per SM, the
    largest K the LDL^T kernels hold, the dense epoch's block and which K
    runs one instance per warp;
  * chip_smoke.py's residual gate (``check_residuals``) on a system whose
    factor pivots at the 1e-6 floor: the mirror passes, some lanes only by
    test (b) against the float64 substitution on the same factor, and a
    perturbed substitution is refused.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import single_thread  # noqa: E402,F401
from polympc_tpu.ops import ldlt as jldlt  # noqa: E402
from polympc_torch.ops import _build, ldlt  # noqa: E402
from polympc_torch.ops import admm_epoch as ae  # noqa: E402

# chip_smoke.py's LDLT_RES_RATIO, LDLT_RES_FLOOR and LDLT_GROWTH
LDLT_RES_RATIO, LDLT_RES_FLOOR, LDLT_GROWTH = 10.0, 1e-5, 1e-3


def _diag_dominant(B, K, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, K, K))
    A = A + A.transpose(0, 2, 1)
    sign = np.where(np.arange(K) < K // 2, 1.0, -1.0)
    A[:, np.arange(K), np.arange(K)] = sign * (np.abs(A).sum(axis=2) + 1.0)
    return A, rng.normal(size=(B, K))


def _rel(got, want):
    return ((got - want).abs().amax(1) / want.abs().amax(1)).max().item()


@pytest.mark.parametrize("K", [8, 33, 70, 165])
def test_panel_solve_mirror_matches_plain(K):
    A, b = _diag_dominant(4, K, K)
    F, d = ldlt.ldlt_factor_plain(torch.as_tensor(A))
    bt = torch.as_tensor(b)
    got = ldlt.panel_solve_mirror(F, d, bt)
    assert got.dtype == torch.float64
    assert _rel(got, ldlt.ldlt_solve_plain(F, d, bt)) <= 1e-12
    # the panel size orders no element's terms differently
    assert torch.equal(got, ldlt.panel_solve_mirror(F, d, bt, panel=8))


def test_panel_solve_mirror_matches_jax():
    K = 40
    A, b = _diag_dominant(3, K, 5)
    F, d = jldlt.ldlt_factor(jnp.asarray(A), interpret=True)
    want = np.asarray(jldlt.ldlt_solve(F, d, jnp.asarray(b), interpret=True))
    F = torch.as_tensor(np.array(F)[:, :K, :K])
    d = torch.as_tensor(np.array(d)[:, :K])
    got = ldlt.panel_solve_mirror(F, d, torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def _growth_case(seed, B=32, K=40):
    """Symmetric indefinite matrices with three small diagonal entries
    (|.| in [1e-3, 1e-2]): the unpivoted factor grows elements some
    hundred times the matrix's."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, K, K))
    A = (A + A.transpose(0, 2, 1)) / 2
    for i in (0, 7, 19):
        A[:, i, i] = rng.uniform(1e-3, 1e-2, B) * rng.choice([-1, 1], B)
    return A, rng.normal(size=(B, K))


@pytest.mark.parametrize("seed", [0, 1])
def test_float64_panels_on_a_growing_factor_keep_the_residual(seed):
    A, b = _growth_case(seed)
    M64, b64 = torch.as_tensor(A), torch.as_tensor(b)
    M32, b32 = M64.float(), b64.float()
    F, d = ldlt.ldlt_factor_plain(M32)
    growth = F.abs().amax((1, 2)) / M32.abs().amax((1, 2))
    assert growth.median().item() > 100.0

    def residual(x):
        r = (M64 @ x.double()[..., None])[..., 0] - b64
        return r.abs().amax(1) / b64.abs().amax(1)

    rp = residual(ldlt.ldlt_solve_plain(F, d, b32))
    xk = ldlt.panel_solve_mirror(F, d, b32)
    assert xk.dtype == torch.float32
    rk = residual(xk)
    live = rp <= LDLT_GROWTH
    assert live.sum().item() >= len(live) // 2
    ok = rk <= torch.clamp(LDLT_RES_RATIO * rp, min=LDLT_RES_FLOOR)
    assert bool(ok[live].all()), (rk / rp)[live].max().item()


def test_launch_rules():
    # packed rows: the row-major order of the upper triangle
    K = 11
    rows, cols = np.triu_indices(K)
    at = [ldlt.packed_offset(j, K) + c - j for j, c in zip(rows, cols)]
    assert at == list(range(K * (K + 1) // 2))
    assert ldlt.packed_offset(K - 1, K) == K * (K + 1) // 2 - 1
    # shared memory sets the occupancy: one wave of 512 matrices at the
    # kite's and the race car's refine sizes (132 SMs)
    assert ldlt.ldlt_smem_bytes(132) == 36696
    assert ldlt.ldlt_smem_bytes(165) == 56760
    assert _build.blocks_per_sm(ldlt.ldlt_smem_bytes(132), 256) == 6
    assert _build.blocks_per_sm(ldlt.ldlt_smem_bytes(165), 256) == 4
    assert 132 * 4 >= 512
    # the largest K a block holds
    assert ldlt.LDLT_MAX_K == 337
    assert ldlt.ldlt_smem_bytes(337) <= _build.SMEM_LIMIT_BYTES
    assert ldlt.ldlt_smem_bytes(338) > _build.SMEM_LIMIT_BYTES
    # the dense epoch: one instance per warp, four per block while four
    # packed triangles fit, fewer above, up to one triangle per block
    assert ae.epoch_threads(47) == ae.epoch_threads(169) == 128
    assert ae.epoch_threads(170) == 96 and ae.epoch_threads(340) == 32
    assert ae.epoch_threads(341) == 0
    assert ae.epoch_smem_bytes(32, 15) == 4 * (47 * 48 // 2) * 4
    assert ae.epoch_smem_bytes(32, 15, threads=32) == 47 * 48 // 2 * 4
    # the spline batch (B = 4096, K = 47) in one wave: 1,024 blocks of
    # four instances over 132 SMs need 8 blocks an SM; the shared memory
    # holds 12 (the occupancy API's count, registers included, is held on
    # the card)
    assert _build.blocks_per_sm(ae.epoch_smem_bytes(32, 15), 128) == 12
    assert -(-4096 // 4) <= 132 * 8
    assert ae.epoch_kernel_fits(200, 140) and not ae.epoch_kernel_fits(
        200, 141)


def _gate_case(K):
    """chip_smoke.py's residual-gate inputs on a system whose factor pivots
    at the 1e-6 floor (tests/_pivot_floor.py): (Ms float64, the float64
    right-hand sides, the plain float32 factor, the plain float32
    solution, the float64 substitution's residual on that factor)."""
    import sys
    from pathlib import Path
    from _pivot_floor import pivot_floor_system
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    M, b = pivot_floor_system(64, K)
    Ms = torch.tensor(M)
    r32 = torch.tensor(b).float()
    xp, Fp, dp = ldlt.ldlt_factor_solve_plain(Ms.float(), r32)
    rs = r32.double()
    r64 = cs.rel_residual(Ms, ldlt.ldlt_solve_plain(Fp.double(),
                                                    dp.double(), rs), rs)
    return cs, Ms, rs, Fp, dp, xp, r64


@pytest.mark.parametrize("K", [125, 252])
def test_residual_gate_passes_the_exact_substitution(K):
    """chip_smoke.py's one residual gate on every path: where the factor
    pivots at the regularisation floor, the kernels' substitution
    (``panel_solve_mirror``, which the card's kernel equals bit for bit)
    passes, some lanes only by test (b), against the float64 substitution
    on the same factor; test (a) alone, against the plain float32 solve,
    would refuse them."""
    cs, Ms, rs, Fp, dp, xp, r64 = _gate_case(K)
    assert dp.abs().min().item() < 2e-6
    xm = ldlt.panel_solve_mirror(Fp, dp, rs.float())
    counts = cs.check_residuals("mirror", cs.rel_residual(Ms, xm, rs),
                                cs.rel_residual(Ms, xp, rs), r64)
    assert counts["gate_by_b_only"] >= 1, counts
    assert counts["gate_by_a"] < counts["gate_live"], counts


@pytest.mark.parametrize("K", [125, 252])
def test_residual_gate_refuses_a_perturbed_substitution(K):
    cs, Ms, rs, Fp, dp, xp, r64 = _gate_case(K)
    xm = ldlt.panel_solve_mirror(Fp, dp, rs.float())
    noise = np.random.default_rng(1).normal(size=xm.shape)
    bad = xm * (1.0 + 1e-2 * torch.as_tensor(noise, dtype=xm.dtype))
    with pytest.raises(RuntimeError, match="pass neither"):
        cs.check_residuals("perturbed", cs.rel_residual(Ms, bad, rs),
                           cs.rel_residual(Ms, xp, rs), r64)
