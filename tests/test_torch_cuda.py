"""The hand-written CUDA kernels of polympc_torch against their plain
PyTorch versions, on the card.  Every test is marked ``cuda`` and skips
where there is no card.  This file imports no JAX, so it also runs on a
machine with a card and no JAX (tests/conftest.py imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Inputs are well-conditioned (random diagonally dominant quasi-definite
KKTs in the kite's BBT pattern, with and without a border; dense
quasi-definite boxADMM KKTs at the spline QP's shape, at K=132 and
box-only; diagonally dominant matrices for the LDL^T factor), so float32
results of kernel and plain version agree to 1e-4 relative.
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


@pytest.fixture
def dev():
    """The card; the test skips where there is none (decided here, not at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there")
    return torch.device("cuda")


def _structure(border):
    if not border:
        return kite_problem("cpu")[3].qp.structure
    return bbt_structure(11, 5, 2, 0, 2, 0, 5, 2)


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
@pytest.mark.parametrize("border", [False, True], ids=["kite", "bordered"])
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
@pytest.mark.parametrize("border", [False, True], ids=["kite", "bordered"])
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
