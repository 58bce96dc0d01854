"""The algorithm of the redesigned CUDA kernels, in plain PyTorch on the CPU.

The BBT epoch kernel (csrc/bbt_epoch.cu) and the explicit-inverse kernel
(csrc/ldlt.cu) invert symmetric quasi-definite blocks in place by an
unpivoted Gauss-Jordan sweep and apply the inverses, where the plain
versions (the JAX algorithm) factor by LDL^T and substitute.  Their
mirrors, ``ops.ldlt.sweep_inverse_mirror`` and
``ops.bbt_kernel.bbt_epoch_mirror`` / ``bbt_solve_mirror``, are held here:

  * the sweep against ``torch.linalg.inv`` and ``ldlt_inverse_plain`` in
    float64 on random quasi-definite K = 8, 72, 96, to 1e-10;
  * the epoch and solve mirrors against ``bbt_epoch_plain`` /
    ``bbt_solve_plain`` in float64 on the kite's structure and a bordered
    one, to 1e-10 (the plain versions' parity with the JAX package is in
    tests/test_torch_ops.py);
  * the precision rule that chip_smoke.py applies to the kernel on the
    kite's first-iterate epoch (condition number near 1e6): in float32 the
    mirror's per-lane error against float64 is at most 10x the plain
    version's, at B=4.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import single_thread  # noqa: E402,F401
from polympc_torch.headline import kite_problem  # noqa: E402
from polympc_torch.nlp.hessian import regularize  # noqa: E402
from polympc_torch.ops import _build, bbt_kernel, ldlt  # noqa: E402
from polympc_torch.ops.structure import (  # noqa: E402
    bbt_structure, gather_blocks, permute_vec, random_bbt_kkt)
from polympc_torch.parallel import pin_initial_state  # noqa: E402
from polympc_torch.qp.box_admm import _build_kkt, penalties  # noqa: E402
from polympc_torch.qp.types import QPData  # noqa: E402

KITE_REFERENCE = os.path.join(os.path.dirname(__file__), "data",
                              "kite_b512_jax_cpu.npz")
SIGMA, ALPHA, ITERS = 1e-6, 1.6, 7
# chip_smoke.py's F64_RATIO and F64_FLOOR
F64_RATIO, F64_FLOOR = 10.0, 1e-4


def _lane_rel(got, want):
    B = got.shape[0]
    return ((got - want).reshape(B, -1).abs().amax(1)
            / want.reshape(B, -1).abs().amax(1))


def _quasi_definite(B, K, seed):
    """Random symmetric quasi-definite [[H, A'], [A, -D]], float64."""
    rng = np.random.default_rng(seed)
    nz = K * 7 // 12
    m = K - nz
    G = rng.normal(size=(B, nz, nz))
    M = np.zeros((B, K, K))
    M[:, :nz, :nz] = G @ G.transpose(0, 2, 1) / nz + np.eye(nz)
    A = rng.normal(size=(B, m, nz))
    M[:, :nz, nz:] = A.transpose(0, 2, 1)
    M[:, nz:, :nz] = A
    M[:, nz:, nz:] = -np.eye(m) * rng.uniform(0.1, 2.0, (B, m, 1))
    return torch.tensor(M)


@pytest.mark.parametrize("K", [8, 72, 96])
def test_sweep_inverse_mirror_matches_inverse(K):
    M = _quasi_definite(3, K, seed=K)
    _build.reset_launches()
    got = ldlt.sweep_inverse_mirror(M)
    assert got.shape == M.shape and got.dtype == torch.float64
    assert _lane_rel(got, torch.linalg.inv(M)).max().item() <= 1e-10
    assert _lane_rel(got, ldlt.ldlt_inverse_plain(M)).max().item() <= 1e-10
    assert _build.LAUNCHES["ldlt_inverse"] == 0


def _structure(name):
    if name == "kite":
        return kite_problem("cpu")[3].qp.structure
    return bbt_structure(11, 5, 2, 0, 2, 0, 5, 2)


def _epoch_case(st, B, seed):
    """A random float64 epoch input in the pattern of ``st``: a
    quasi-definite KKT whose dual diagonal is -1/rho, random h and boxes,
    a random state."""
    rng = np.random.default_rng(seed)
    M = random_bbt_kkt(st, B, seed=seed, dtype=torch.float64, device="cpu")
    n, m = st.n, st.m
    f = lambda *shape: torch.tensor(rng.normal(size=shape))
    rho = -1.0 / torch.diagonal(M, dim1=1, dim2=2)[:, n:]
    rb = torch.full((B, n), 0.1, dtype=torch.float64)
    xl, al = -1.0 - f(B, n).abs(), -1.0 - f(B, m).abs()
    return M, bbt_kernel.prepare_epoch(
        M, f(B, n), al, -al, xl, -xl, rho, rb, 0.1 * f(B, n),
        0.1 * f(B, m), 0.1 * f(B, n), 0.1 * f(B, m), 0.1 * f(B, n), st)


@pytest.mark.parametrize("name", ["kite", "bordered"])
def test_bbt_epoch_mirror_matches_plain(name):
    st = _structure(name)
    _, args = _epoch_case(st, 3, seed=1)
    _build.reset_launches()
    got = bbt_kernel.bbt_epoch_mirror(*args, st, SIGMA, ALPHA, ITERS)
    want = bbt_kernel.bbt_epoch_plain(*args, st, SIGMA, ALPHA, ITERS)
    assert got.shape == want.shape == (3, 3, st.S * st.k + st.a)
    assert _lane_rel(got, want).max().item() <= 1e-10
    assert _build.LAUNCHES["bbt_epoch"] == 0


@pytest.mark.parametrize("name", ["kite", "bordered"])
def test_bbt_solve_mirror_matches_plain(name):
    st = _structure(name)
    M = random_bbt_kkt(st, 3, seed=2, dtype=torch.float64, device="cpu")
    b = torch.tensor(np.random.default_rng(3).normal(size=(3, st.K)))
    blocks = gather_blocks(M, st)
    rhs = permute_vec(b, st, 0.0)
    got = bbt_kernel.bbt_solve_mirror(*blocks, rhs, st)
    want = bbt_kernel.bbt_solve_plain(*blocks, rhs, st)
    assert _lane_rel(got, want).max().item() <= 1e-10


def _kite_first_epoch(B):
    """chip_smoke.py's kernel-1 input at bench's first SQP iterate, for the
    first B lanes of the kite record, float32 on the CPU."""
    tr, bounds, prm, settings = kite_problem("cpu")
    qs, st = settings.qp, settings.qp.structure
    nlp, nx = tr.nlp, tr.ocp.nx
    x0 = torch.as_tensor(np.load(KITE_REFERENCE)["x0s"][:B],
                         dtype=torch.float32)
    bnd, x0sc = pin_initial_state(tr, bounds, x0)
    z0 = tr.rollout_guess(x0, prm)
    z0[:, :nx] = x0sc
    z0 = torch.clamp(z0, min=bnd.lbx, max=bnd.ubx)
    lam0 = torch.zeros((B, nlp.m))
    H = regularize(nlp.lag_hessian(z0, lam0, prm), settings.reg,
                   settings.reg_eps)
    c = nlp.eq(z0, prm)
    qp = QPData(H=H, h=nlp.cost_grad(z0, prm), A=nlp.eq_jac(z0, prm),
                al=-c, au=-c, xl=bnd.lbx - z0, xu=bnd.ubx - z0)
    rho, rb = penalties(torch.full((B,), qs.rho), qp, qs)
    kkt = _build_kkt(qp, rho, rb, qs.sigma)
    z = torch.zeros_like
    args = bbt_kernel.prepare_epoch(kkt, qp.h, qp.al, qp.au, qp.xl, qp.xu,
                                    rho, rb, z(z0), z(c), z(z0), lam0, z(z0),
                                    st)
    return args, st, (qs.sigma, qs.alpha, qs.check_every)


def test_bbt_epoch_mirror_keeps_the_f64_rule_on_the_kite():
    args, st, ep = _kite_first_epoch(4)
    ref = bbt_kernel.bbt_epoch_plain(*(a.double() for a in args), st, *ep)
    plain = bbt_kernel.bbt_epoch_plain(*args, st, *ep)
    mirror = bbt_kernel.bbt_epoch_mirror(*args, st, *ep)
    assert torch.isfinite(mirror).all()
    ep_ = _lane_rel(plain.double(), ref).max().item()
    em = _lane_rel(mirror.double(), ref).max().item()
    assert em <= max(F64_RATIO * ep_, F64_FLOOR), (em, ep_)
