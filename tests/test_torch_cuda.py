"""The hand-written CUDA kernels of polympc_torch against their plain
PyTorch versions, on the card.  Every test is marked ``cuda`` and skips
where there is no card.  This file imports no JAX, so it also runs on a
machine with a card and no JAX (tests/conftest.py imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Inputs are well-conditioned (random diagonally dominant quasi-definite
KKTs in the kite's and the race car's BBT patterns, and in a bordered one;
dense quasi-definite boxADMM KKTs at the spline QP's shape, at K=132 and
box-only; diagonally dominant matrices for the LDL^T factor), so float32
results of kernel and plain version agree to 1e-4 relative.  The BBT
kernels and the explicit inverse compute by another algorithm than their
plain versions (explicit block inverses by a Gauss-Jordan sweep, where the
plain versions substitute through LDL^T factors); against the PyTorch
mirror of their own algorithm they agree to 1e-5 relative per lane.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from polympc_torch.headline import kite_problem  # noqa: E402
from polympc_torch.ops import _build, admm_epoch, bbt_kernel, ldlt  # noqa: E402,E501
from polympc_torch.ops.structure import (  # noqa: E402
    bbt_structure, gather_blocks, permute_vec, random_bbt_kkt,
    unpermute_vec)

SIGMA, ALPHA, ITERS = 1e-6, 1.6, 50
# kernel vs the mirror of its own algorithm: the same operations, summed in
# another order, on well-conditioned inputs
MIRROR_RTOL = 1e-5
STRUCTURES = ["kite", "bordered", "race_car"]


@pytest.fixture
def dev():
    """The card; the test skips where there is none (decided here, not at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there")
    return torch.device("cuda")


def _structure(name):
    """The kite's BBT structure (S=2, k=72), a bordered one (the kite's
    shape with two parameters) and the race car's (S=2, k=96: nx=6, nu=3
    on Chebyshev(5) x 2)."""
    if name == "kite":
        return kite_problem("cpu")[3].qp.structure
    if name == "bordered":
        return bbt_structure(11, 5, 2, 0, 2, 0, 5, 2)
    return bbt_structure(11, 6, 3, 0, 0, 0, 5, 2)


def _lane_rel(got, want):
    """Largest per-lane relative inf-norm difference."""
    B = got.shape[0]
    return ((got - want).reshape(B, -1).abs().amax(1)
            / want.reshape(B, -1).abs().amax(1)).max().item()


def _epoch_case(st, B, dev, seed=0):
    """A random epoch input whose dual diagonal is -1/rho (the ADMM
    iteration's own KKT) and whose primal block is diagonally dominant."""
    rng = np.random.default_rng(seed)
    M = random_bbt_kkt(st, B, seed=seed, device=dev)
    n, m = st.n, st.m
    f = lambda *shape: torch.as_tensor(rng.normal(size=shape),
                                       dtype=torch.float32, device=dev)
    rho = -1.0 / torch.diagonal(M, dim1=1, dim2=2)[:, n:]
    rb = torch.full((B, n), 0.1, device=dev)
    xl, al = -1.0 - f(B, n).abs(), -1.0 - f(B, m).abs()
    zero = lambda k: torch.zeros((B, k), device=dev)
    return M, bbt_kernel.prepare_epoch(M, f(B, n), al, -al, xl, -xl, rho,
                                       rb, zero(n), zero(m), zero(n),
                                       zero(m), zero(n), st)


@pytest.mark.cuda
@pytest.mark.parametrize("border", STRUCTURES, ids=STRUCTURES)
def test_bbt_epoch_kernel_matches_plain(border, dev):
    st = _structure(border)
    _, args = _epoch_case(st, 64, dev)
    _build.reset_launches()
    got = bbt_kernel.bbt_epoch(*args, st, SIGMA, ALPHA, ITERS)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bbt_epoch"] == 1
    want = bbt_kernel.bbt_epoch_plain(*args, st, SIGMA, ALPHA, ITERS)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [128, 256])
@pytest.mark.parametrize("border", STRUCTURES, ids=STRUCTURES)
def test_bbt_epoch_kernel_matches_mirror(border, threads, dev):
    st = _structure(border)
    _, args = _epoch_case(st, 64, dev, seed=5)
    got = bbt_kernel._launch_epoch(*args, st, SIGMA, ALPHA, ITERS, threads)
    want = bbt_kernel.bbt_epoch_mirror(*args, st, SIGMA, ALPHA, ITERS)
    assert _lane_rel(got, want) <= MIRROR_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("border", STRUCTURES, ids=STRUCTURES)
def test_bbt_solve_kernel_matches_mirror(border, dev):
    st = _structure(border)
    M = random_bbt_kkt(st, 64, seed=6, device=dev)
    b = torch.as_tensor(np.random.default_rng(7).normal(size=(64, st.K)),
                        dtype=torch.float32, device=dev)
    blocks = gather_blocks(M, st)
    rhs = permute_vec(b, st, 0.0)
    got = bbt_kernel.bbt_solve(*blocks, rhs, st)
    want = bbt_kernel.bbt_solve_mirror(*blocks, rhs, st)
    assert _lane_rel(got, want) <= MIRROR_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("border", STRUCTURES, ids=STRUCTURES)
def test_bbt_solve_kernel_matches_plain_and_dense(border, dev):
    st = _structure(border)
    M = random_bbt_kkt(st, 64, seed=3, device=dev)
    b = torch.as_tensor(np.random.default_rng(4).normal(size=(64, st.K)),
                        dtype=torch.float32, device=dev)
    blocks = gather_blocks(M, st)
    rhs = permute_vec(b, st, 0.0)
    _build.reset_launches()
    got = bbt_kernel.bbt_solve(*blocks, rhs, st)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bbt_solve"] == 1
    torch.testing.assert_close(
        got, bbt_kernel.bbt_solve_plain(*blocks, rhs, st), rtol=1e-4,
        atol=1e-5)
    x = unpermute_vec(got, st).double()
    res = (M.double() @ x[..., None])[..., 0] - b.double()
    assert res.abs().max().item() <= 1e-4 * b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("K", [8, 132, 200])
def test_ldlt_kernels_match_plain(K, dev):
    rng = np.random.default_rng(K)
    A = rng.normal(size=(64, K, K))
    A = A + A.transpose(0, 2, 1)
    sign = np.where(np.arange(K) < K // 2, 1.0, -1.0)
    A[:, np.arange(K), np.arange(K)] = sign * (np.abs(A).sum(axis=2) + 1.0)
    M = torch.as_tensor(A, dtype=torch.float32, device=dev)
    b = torch.as_tensor(rng.normal(size=(64, K)), dtype=torch.float32,
                        device=dev)
    _build.reset_launches()
    xk, Fk, dk = ldlt.ldlt_factor_solve(M, b)
    xp, Fp, dp = ldlt.ldlt_factor_solve_plain(M, b)
    sk = ldlt.ldlt_solve(Fp, dp, b)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ldlt_factor_solve"] == 1
    assert _build.LAUNCHES["ldlt_solve"] == 1
    upper = torch.triu(torch.ones(K, K, dtype=torch.bool, device=dev), 1)
    torch.testing.assert_close(Fk[:, upper], Fp[:, upper], rtol=1e-4,
                               atol=1e-5)
    for got, want in ((xk, xp), (dk, dp), (sk, xp)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def _dense_epoch_case(n, m, B, dev, seed=0):
    """A batch of quasi-definite boxADMM KKTs built for their own rho/rb
    (primal block H + sigma I + diag(rb) positive definite, dual block
    -1/rho), loose boxes (+-inf) on every fifth variable, and a random
    state."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    H = G @ G.transpose(0, 2, 1) / n + np.eye(n)
    J = rng.standard_normal((B, m, n))
    rho = rng.uniform(0.5, 2.0, (B, m))
    rb = rng.uniform(0.05, 0.2, (B, n))
    K = np.zeros((B, n + m, n + m))
    K[:, :n, :n] = H + SIGMA * np.eye(n) + rb[:, :, None] * np.eye(n)
    K[:, :n, n:] = J.transpose(0, 2, 1)
    K[:, n:, :n] = J
    K[:, n:, n:] = -np.eye(m) / rho[:, :, None]
    al = rng.normal(size=(B, m)) - 2.0
    au = al + rng.uniform(0.5, 3.0, (B, m))
    xl, xu = np.full((B, n), -0.8), np.full((B, n), 0.8)
    xl[:, ::5], xu[:, ::5] = -np.inf, np.inf
    vec = lambda k: rng.normal(size=(B, k)) * 0.1
    arrays = (K, rng.standard_normal((B, n)), al, au, xl, xu, rho, rb,
              vec(n), vec(m), vec(n) + 0.01, vec(m), vec(n))
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(32, 15), (77, 55), (47, 0)],
                         ids=["spline-shape", "K132", "box-only"])
def test_admm_epoch_kernel_matches_plain(n, m, dev):
    args = _dense_epoch_case(n, m, 64, dev, seed=n + m)
    kw = dict(sigma=SIGMA, alpha=ALPHA, iters=25)
    _build.reset_launches()
    got = admm_epoch.admm_epoch_batched(*args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["admm_epoch"] == 1
    want = admm_epoch.admm_epoch_plain(*args, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [8, 47, 165])
def test_ldlt_factor_kernel_matches_plain(K, dev):
    rng = np.random.default_rng(K + 1)
    A = rng.normal(size=(64, K, K))
    A = A + A.transpose(0, 2, 1)
    sign = np.where(np.arange(K) < K // 2, 1.0, -1.0)
    A[:, np.arange(K), np.arange(K)] = sign * (np.abs(A).sum(axis=2) + 1.0)
    M = torch.as_tensor(A, dtype=torch.float32, device=dev)
    _build.reset_launches()
    Fk, dk = ldlt.ldlt_factor(M)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ldlt_factor"] == 1
    Fp, dp = ldlt.ldlt_factor_plain(M)
    upper = torch.triu(torch.ones(K, K, dtype=torch.bool, device=dev), 1)
    torch.testing.assert_close(Fk[:, upper], Fp[:, upper], rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(dk, dp, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_kernels_refuse_float64(dev):
    M = torch.eye(4, dtype=torch.float64, device=dev)[None]
    with pytest.raises(TypeError, match="float32"):
        ldlt.ldlt_factor_solve(M, torch.ones((1, 4), dtype=torch.float64,
                                             device=dev))


def _quasi_definite(batch, nz, m, seed):
    """Symmetric quasi-definite [[H, A'], [A, -D]], float64 numpy."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(batch, nz, nz))
    K = np.zeros((batch, nz + m, nz + m))
    K[:, :nz, :nz] = G @ G.transpose(0, 2, 1) / nz + np.eye(nz)
    A = rng.normal(size=(batch, m, nz))
    K[:, :nz, nz:] = A.transpose(0, 2, 1)
    K[:, nz:, :nz] = A
    K[:, nz:, nz:] = -np.eye(m) * rng.uniform(0.1, 2.0, (batch, m, 1))
    return K


@pytest.mark.cuda
@pytest.mark.parametrize("nz,m", [(5, 3), (42, 30), (99, 70)],
                         ids=["K8", "K72", "K169"])
def test_ldlt_inverse_kernel_matches_plain(nz, m, dev):
    M = torch.as_tensor(_quasi_definite(256, nz, m, seed=nz),
                        dtype=torch.float32, device=dev)
    _build.reset_launches()
    got = ldlt.ldlt_inverse(M)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ldlt_inverse"] == 1
    want = ldlt.ldlt_inverse_plain(M)
    rel = ((got - want).abs().amax((1, 2))
           / want.abs().amax((1, 2))).max().item()
    assert rel <= 1e-4, rel
    assert _build.library().pt_ldlt_inverse_smem_bytes(nz + m) == \
        ldlt.inverse_smem_bytes(nz + m)


@pytest.mark.cuda
@pytest.mark.parametrize("nz,m", [(5, 3), (42, 30), (99, 70), (112, 80)],
                         ids=["K8", "K72", "K169", "K192"])
def test_ldlt_inverse_kernel_matches_mirror(nz, m, dev):
    M = torch.as_tensor(_quasi_definite(128, nz, m, seed=nz + 1),
                        dtype=torch.float32, device=dev)
    got = ldlt.ldlt_inverse(M)
    assert _lane_rel(got, ldlt.sweep_inverse_mirror(M)) <= MIRROR_RTOL


@pytest.mark.cuda
def test_ldlt_inverse_refuses_a_block_too_large(dev):
    ldlt.ldlt_inverse(torch.eye(192, device=dev)[None])
    with pytest.raises(ValueError, match="K=193"):
        ldlt.ldlt_inverse(torch.eye(193, device=dev)[None])
