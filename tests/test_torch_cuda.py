"""The hand-written CUDA kernels of polympc_torch against their plain
PyTorch versions, on the card.  Every test is marked ``cuda`` and skips
where there is no card.  This file imports no JAX, so it also runs on a
machine with a card and no JAX (tests/conftest.py imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Inputs are well-conditioned (random diagonally dominant quasi-definite
KKTs in the kite's, the race car's and the CSTR's BBT patterns, and in a
bordered one;
dense quasi-definite boxADMM KKTs at the spline QP's shape, at K=132 and
box-only; diagonally dominant matrices for the LDL^T factor), so float32
results of kernel and plain version agree to 1e-4 relative.  The BBT
kernels and the explicit inverse compute by another algorithm than their
plain versions (explicit block inverses by a Gauss-Jordan sweep, where the
plain versions substitute through LDL^T factors); against the PyTorch
mirror of their own algorithm they agree to 1e-5 relative per lane.

The fit rules route by shape before any launch, as the JAX package does:
a structure the BBT kernel does not fit, or one of another QP, takes the
dense epoch kernel (or the LU epoch), a float32 refine solve above
``LDLT_MAX_K`` takes ``torch.linalg.solve``; each is held against the
same problem in float64.  The MPC facade runs on the card in float64.
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
STRUCTURES = ["kite", "bordered", "race_car", "cstr"]


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
    shape with two parameters), the race car's (S=2, k=96: nx=6, nu=3 on
    Chebyshev(5) x 2) and the CSTR batch's (S=2, k=64: nx=4, nu=2)."""
    if name == "kite":
        return kite_problem("cpu")[3].qp.structure
    if name == "bordered":
        return bbt_structure(11, 5, 2, 0, 2, 0, 5, 2)
    if name == "cstr":
        return bbt_structure(11, 4, 2, 0, 0, 0, 5, 2)
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


def _diag_dominant(B, K, seed):
    """Symmetric indefinite, diagonally dominant (half the diagonal
    negative) float64 matrices and right-hand sides, numpy."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, K, K))
    A = A + A.transpose(0, 2, 1)
    sign = np.where(np.arange(K) < K // 2, 1.0, -1.0)
    A[:, np.arange(K), np.arange(K)] = sign * (np.abs(A).sum(axis=2) + 1.0)
    return A, rng.normal(size=(B, K))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [8, 132, 200, 252])
def test_ldlt_kernels_match_plain(K, dev):
    A, b = _diag_dominant(64, K, K)
    M = torch.as_tensor(A, dtype=torch.float32, device=dev)
    b = torch.as_tensor(b, dtype=torch.float32, device=dev)
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
@pytest.mark.parametrize("n,m", [(32, 15), (77, 55), (47, 0), (147, 105)],
                         ids=["spline-shape", "K132", "box-only",
                              "sweep-K252"])
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
    A, _ = _diag_dominant(64, K, K + 1)
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
@pytest.mark.parametrize("K", [47, 132, 165])
def test_ldlt_factor_kernel_is_the_plain_factor(K, dev):
    """The packed factor's upper triangle (diagonal d included) and d equal
    the plain version's bit for bit; the strict lower triangle is zero; the
    same factor comes out of ldlt_factor_solve."""
    A, b = _diag_dominant(64, K, K + 2)
    M = torch.as_tensor(A, dtype=torch.float32, device=dev)
    bb = torch.as_tensor(b, dtype=torch.float32, device=dev)
    Fk, dk = ldlt.ldlt_factor(M)
    _, Fs, ds = ldlt.ldlt_factor_solve(M, bb)
    Fp, dp = ldlt.ldlt_factor_plain(M)
    upper = torch.triu(torch.ones(K, K, dtype=torch.bool, device=dev))
    for F, d in ((Fk, dk), (Fs, ds)):
        assert torch.equal(F[:, upper], Fp[:, upper])
        assert torch.equal(d, dp)
        assert torch.count_nonzero(F[:, ~upper]).item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("K", [132, 165])
def test_ldlt_solve_kernel_matches_panel_mirror(K, dev):
    A, b = _diag_dominant(64, K, K + 3)
    M = torch.as_tensor(A, dtype=torch.float32, device=dev)
    bb = torch.as_tensor(b, dtype=torch.float32, device=dev)
    F, d = ldlt.ldlt_factor_plain(M)
    want = ldlt.panel_solve_mirror(F, d, bb)
    for got in (ldlt.ldlt_solve(F, d, bb), ldlt.ldlt_factor_solve(M, bb)[0]):
        assert _lane_rel(got, want) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("K", [200, ldlt.LDLT_MAX_K])
def test_ldlt_kernels_up_to_the_fit_limit(K, dev):
    A, b = _diag_dominant(8, K, K)
    M = torch.as_tensor(A, dtype=torch.float32, device=dev)
    bb = torch.as_tensor(b, dtype=torch.float32, device=dev)
    xk, Fk, dk = ldlt.ldlt_factor_solve(M, bb)
    xp, Fp, dp = ldlt.ldlt_factor_solve_plain(M, bb)
    upper = torch.triu(torch.ones(K, K, dtype=torch.bool, device=dev))
    assert torch.equal(Fk[:, upper], Fp[:, upper])
    assert _lane_rel(xk, xp) <= 1e-4
    assert _lane_rel(ldlt.ldlt_solve(Fp, dp, bb), xp) <= 1e-4
    big = ldlt.LDLT_MAX_K + 1
    with pytest.raises(ValueError, match=f"K={big}"):
        ldlt.ldlt_factor(torch.eye(big, device=dev)[None])


@pytest.mark.cuda
def test_ldlt_shared_memory_sets_the_occupancy(dev):
    """The C and Python shared-memory formulas agree, and at the main
    paths' K (132, 165) the occupancy API's blocks per SM are those of the
    shared-memory formula (six and four), for all three kernels."""
    lib = _build.library()
    for K in (8, 132, 165, ldlt.LDLT_MAX_K):
        assert lib.pt_ldlt_smem_bytes(K) == ldlt.ldlt_smem_bytes(K)
    for K, want in ((132, 6), (165, 4)):
        assert _build.blocks_per_sm(ldlt.ldlt_smem_bytes(K), 256) == want
        for which in range(3):
            assert lib.pt_ldlt_blocks_per_sm(which, K) == want


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 67])
@pytest.mark.parametrize("n,m", [(32, 15), (40, 24), (40, 25), (150, 25),
                                 (300, 40)],
                         ids=["K47", "K64", "K65", "K175", "K340"])
def test_admm_epoch_kernel_batch_and_shape_edges(n, m, B, dev):
    """A batch of one and a batch that leaves the last block of four
    instances short; K = 64 and 65 (two and three register slots a lane),
    K = 175 (three instances a block) and K = 340 (the fit limit, one)."""
    args = _dense_epoch_case(n, m, B, dev, seed=B + n + m)
    kw = dict(sigma=SIGMA, alpha=ALPHA, iters=25)
    got = admm_epoch.admm_epoch_batched(*args, **kw)
    want = admm_epoch.admm_epoch_plain(*args, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    lib = _build.library()
    t = admm_epoch.epoch_threads(n + m)
    assert lib.pt_admm_epoch_smem_bytes(n, m, t) == \
        admm_epoch.epoch_smem_bytes(n, m, t)
    assert lib.pt_admm_epoch_blocks_per_sm(n, m, t) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [32, 64, 96])
def test_admm_epoch_kernel_any_instances_per_block(threads, dev):
    args = _dense_epoch_case(32, 15, 10, dev, seed=threads)
    kw = dict(sigma=SIGMA, alpha=ALPHA, iters=25)
    got = admm_epoch.admm_epoch_batched(*args, threads=threads, **kw)
    want = admm_epoch.admm_epoch_batched(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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


def _random_qp(n, m, B, seed, dev, dtype=torch.float32):
    """A random strictly convex QP with equality-like row boxes."""
    from polympc_torch.qp.types import QPData
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, n, n))
    H = G @ G.transpose(0, 2, 1) / n + np.eye(n)
    A = rng.normal(size=(B, m, n)) / np.sqrt(n)
    c = rng.normal(size=(B, m))
    xb = 1.0 + rng.uniform(size=(B, n))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return QPData(H=t(H), h=t(rng.normal(size=(B, n))), A=t(A),
                  al=t(c - 0.5), au=t(c + 0.5), xl=t(-xb), xu=t(xb))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tile", "smem", "mismatched", "large"])
def test_epoch_routes_by_shape_on_the_card(case, dev):
    """A structure the BBT kernel does not fit (S=1 k=200: the register
    tile; S=2 k=168: shared memory), a structure of another QP (the kite's
    on a CSTR-sized QP) and one too large for the dense kernel too (K=341)
    take the dense epoch kernel, or the LU epoch, without raising: the same
    launches as without a structure, the same result, and the float64
    solve's within 1e-3."""
    import dataclasses
    from polympc_torch.qp import box_admm_solve
    from polympc_torch.qp.box_admm import epoch_route
    from polympc_torch.qp.types import ADMMSettings
    st = {"tile": bbt_structure(7, 13, 2, 0, 0, 0, 6, 1),
          "smem": bbt_structure(11, 12, 3, 0, 0, 0, 5, 2),
          "mismatched": _structure("kite"),
          "large": bbt_structure(11, 15, 1, 0, 0, 0, 5, 2)}[case]
    n, m = (66, 44) if case == "mismatched" else (st.n, st.m)
    assert not bbt_kernel.bbt_kernel_fits(st) or (st.n, st.m) != (n, m)
    qp = _random_qp(n, m, 8, 1, dev)
    s = ADMMSettings(kkt_solver="kernel", max_epochs=6, polish=False)
    route = epoch_route(n, m, dataclasses.replace(s, structure=st))
    assert route == ("lu" if case == "large" else "dense_kernel")
    runs = []
    for structure in (st, None):
        _build.reset_launches()
        sol = box_admm_solve(qp, settings=dataclasses.replace(
            s, structure=structure))
        torch.cuda.synchronize()
        runs.append((sol, dict(_build.LAUNCHES)))
    (a, la), (b, lb) = runs
    assert la == lb and la["bbt_epoch"] == 0
    assert (la["admm_epoch"] > 0) == (route == "dense_kernel")
    for f in ("x", "y", "y_box"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    q64 = type(qp)(*(t.double() for t in qp))
    ref = box_admm_solve(q64, settings=dataclasses.replace(
        s, kkt_solver="lu"))
    torch.testing.assert_close(a.x.double(), ref.x, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_refine_above_the_ldlt_fit_takes_the_lu_solve(dev):
    """An fp32 Newton-KKT solve at K = LDLT_MAX_K + 1 takes
    torch.linalg.solve (no LDL^T launch) and agrees with float64."""
    from polympc_torch.nlp.refine import _newton_kkt_solve
    K = ldlt.LDLT_MAX_K + 1
    rng = np.random.default_rng(8)
    A = rng.normal(size=(4, K, K))
    M = A + A.transpose(0, 2, 1) + 4.0 * K * np.diag(
        np.where(np.arange(K) % 2, -1.0, 1.0))[None]
    r = rng.normal(size=(4, K))
    _build.reset_launches()
    x = _newton_kkt_solve(torch.as_tensor(M, dtype=torch.float32,
                                          device=dev),
                          torch.as_tensor(r, dtype=torch.float32,
                                          device=dev))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ldlt_factor_solve"] == 0
    assert _build.LAUNCHES["ldlt_solve"] == 0
    want = np.linalg.solve(M, r[..., None])[..., 0]
    np.testing.assert_allclose(x.double().cpu().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.cuda
def test_mpc_on_the_card(dev):
    """The robot MPC (tests/test_control.py's set-up) on the card in
    float64: SOLVED, the warm re-solve no slower, and the same trajectory
    as on the CPU within 1e-6."""
    from polympc_torch.basis import Chebyshev, SegmentedBasis
    from polympc_torch.control import MPC
    from polympc_torch.models import robot_ocp
    from polympc_torch.nlp import SQPSettings
    from polympc_torch.qp.types import ADMMSettings
    sols = []
    for device in ("cuda", "cpu"):
        mpc = MPC(robot_ocp(), SegmentedBasis(Chebyshev(5), 2), t0=0.0,
                  tf=2.0, settings=SQPSettings(
                      hessian="exact", max_iter=100,
                      qp=ADMMSettings(eps_abs=1e-6, eps_rel=1e-6,
                                      max_epochs=40)), device=device)
        mpc.set_static_parameters([2.0])
        mpc.control_bounds([-1.5, -0.75], [1.5, 0.75])
        mpc.initial_conditions([0.5, 0.5, 0.5])
        mpc.x_guess([0.5, 0.5, 0.5])
        cold = mpc.solve()
        mpc.initial_conditions([0.51, 0.49, 0.5])
        warm = mpc.solve()
        assert int(cold.status) == int(warm.status) == 1
        assert int(warm.iters) <= int(cold.iters)
        assert mpc.solution_x().device.type == device
        sols.append(mpc.solution_x().cpu())
    torch.testing.assert_close(sols[0], sols[1], rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_qp_solvers_on_the_card(dev):
    """The solver layer's QP entry points on the card at the spline QP
    (B=64): the interior point (float64) equals its CPU run per lane in
    status and iterations and to 1e-9 in x; admm_solve in float32 (the box
    stacked into A, K=79) launches the dense epoch kernel and lands within
    1e-3 of the interior point; the active set returns to the card; the
    VJP's float32 forward through the kernel gives cotangents within 1e-3
    (median) of the float64 CPU ones."""
    from polympc_torch import solvers_point as sp
    from polympc_torch.headline_table import spline_batch, spline_settings
    from polympc_torch.qp import (
        QPData, admm_solve, box_admm_solve, qp_active_set_solve,
        qp_ip_solve)
    qp = spline_batch(64, dev, torch.float64)[1]
    ip = qp_ip_solve(qp)
    ip_cpu = qp_ip_solve(QPData(*(t.cpu() for t in qp)))
    assert torch.equal(ip.status.cpu(), ip_cpu.status)
    assert torch.equal(ip.iters.cpu(), ip_cpu.iters)
    torch.testing.assert_close(ip.x.cpu(), ip_cpu.x, rtol=0, atol=1e-9)
    _build.reset_launches()
    ad = admm_solve(QPData(*(t.float() for t in qp)),
                    settings=spline_settings("kernel"))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["admm_epoch"] > 0
    assert (ad.status == 1).all()
    err = (ad.x.double() - ip.x).abs().amax(1) / (1 + ip.x.abs().amax(1))
    assert err.max().item() <= 1e-3
    act = qp_active_set_solve(QPData(*(t[:8] for t in qp)))
    assert act.x.device.type == "cuda" and (act.status == 1).all()
    torch.testing.assert_close(act.x, ip.x[:8], rtol=0, atol=1e-6)
    grads = []
    for q, s in ((QPData(*(t.float() for t in qp)), "kernel"),
                 (QPData(*(t.cpu() for t in qp)), "lu")):
        wrt = [getattr(q, f).clone().requires_grad_(True)
               for f in sp.VJP_FIELDS]
        q = q._replace(**dict(zip(sp.VJP_FIELDS, wrt)))
        w = torch.as_tensor(sp.vjp_weights(64, 32), dtype=q.h.dtype,
                            device=q.h.device)
        sol = box_admm_solve(q, settings=spline_settings(s))
        g = torch.autograd.grad((w * sol.x).sum(), wrt)
        grads.append(torch.cat([t.detach().double().cpu() for t in g], 1))
    rel = (grads[0] - grads[1]).abs().amax(1) / \
        grads[1].abs().amax(1).clamp(min=1e-30)
    assert rel.median().item() <= 1e-3


@pytest.mark.cuda
def test_nlp_ip_and_lqr_on_the_card(dev):
    """The kite interior point (two lanes, float64) and the batched LQR on
    the card equal their CPU runs: the same statuses and iteration counts,
    cost to 1e-8, P to 1e-9."""
    from polympc_torch import solvers_point as sp
    from polympc_torch.control import lqr
    from polympc_torch.headline import bench_x0s
    from polympc_torch.nlp import nlp_ip_solve
    out = []
    for device in ("cuda", "cpu"):
        tr, bounds, prm, _ = kite_problem(device, torch.float64)
        x0 = torch.as_tensor(bench_x0s(512)[:2], dtype=torch.float64,
                             device=device)
        z0, bnd = sp.kite_ip_start(tr, bounds, x0)
        sol = nlp_ip_solve(tr.nlp, z0, p=prm, bounds=bnd)
        A, B, Q, R = (torch.as_tensor(a, device=device)
                      for a in sp.quadrotor())
        As = torch.as_tensor(sp.quadrotor_batch(4), device=device)
        K, P = lqr(As, B, Q, R)
        out.append((sol, P.cpu()))
    (s_gpu, P_gpu), (s_cpu, P_cpu) = out
    assert torch.equal(s_gpu.status.cpu(), s_cpu.status)
    assert torch.equal(s_gpu.iters.cpu(), s_cpu.iters)
    torch.testing.assert_close(s_gpu.cost.cpu(), s_cpu.cost, rtol=1e-8,
                               atol=0)
    torch.testing.assert_close(P_gpu, P_cpu, rtol=1e-9, atol=1e-9)


@pytest.mark.cuda
def test_admm_epoch_kernel_at_the_ms_kite_first_epoch(dev):
    """Kernel 7 at K=125 (n=75, m=50) on the MS kite batch's first epoch
    (B=64 of bench's lanes): one launch, and its per-lane error against
    the plain version in float64 at most 10x the plain float32 version's
    (or below 1e-4: the KKT's equality rows carry -1/rho with rho = 1e3,
    so both float32 results move with the conditioning); on random
    well-conditioned KKTs of that shape within 1e-4 of the plain version."""
    from polympc_torch import ocp_extras_point as op
    qs, args = op.first_epoch(64, dev)
    assert tuple(args[0].shape) == (64, 125, 125)
    kw = dict(sigma=qs.sigma, alpha=qs.alpha, iters=qs.check_every)
    _build.reset_launches()
    got = torch.cat(admm_epoch.admm_epoch_batched(*args, **kw), 1)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["admm_epoch"] == 1
    p32 = torch.cat(admm_epoch.admm_epoch_plain(*args, **kw), 1)
    p64 = torch.cat(admm_epoch.admm_epoch_plain(
        *(a.double() for a in args), **kw), 1)
    rel = lambda a: ((a.double() - p64).abs().amax(1)
                     / p64.abs().amax(1)).max().item()
    assert torch.isfinite(got).all()
    assert rel(got) <= max(10.0 * rel(p32), 1e-4)
    case = _dense_epoch_case(75, 50, 64, dev, seed=125)
    kw = dict(sigma=SIGMA, alpha=ALPHA, iters=50)
    got = admm_epoch.admm_epoch_batched(*case, **kw)
    want = admm_epoch.admm_epoch_plain(*case, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_kite_ms_path_on_the_card(dev):
    """The MS kite batch's timed unit at B=8 on the card: the dense epoch
    kernel and the LDL^T kernels launch, and at least 7 of the 8 lanes
    certify (float32 iterates: a count, not every lane)."""
    from polympc_torch import ocp_extras_point as op
    _build.reset_launches()
    sols, res = op.batch_fn(8, dev)()
    for k in ("admm_epoch", "ldlt_factor_solve", "ldlt_solve"):
        assert _build.LAUNCHES[k] > 0, k
    assert (res <= op.KKT_TOL).sum().item() >= 7


@pytest.mark.cuda
@pytest.mark.parametrize("K", [125, 252])
def test_residual_gate_on_a_factor_at_the_pivot_floor(K, dev):
    """chip_smoke.py's residual gate with the LDL^T kernel on a system
    whose unpivoted factor pivots at the 1e-6 floor (tests/_pivot_floor.py):
    the kernel's factor is the plain one bit for bit, its solution passes
    the gate, some lanes only by test (b) (against the float64 substitution
    on the same factor), and a perturbed substitution is refused."""
    import sys
    from pathlib import Path
    from _pivot_floor import pivot_floor_system
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    M, b = pivot_floor_system(64, K)
    Ms = torch.as_tensor(M, device=dev)
    M32 = Ms.float().contiguous()
    r32 = torch.as_tensor(b, dtype=torch.float32, device=dev)
    rs = r32.double()
    xk, Fk, dk = ldlt.ldlt_factor_solve(M32, r32)
    xp, Fp, dp = ldlt.ldlt_factor_solve_plain(M32, r32)
    r64 = cs.rel_residual(Ms, ldlt.ldlt_solve_plain(Fp.double(),
                                                    dp.double(), rs), rs)
    torch.cuda.synchronize()
    assert dp.abs().min().item() < 2e-6
    cs.same_factor("ldlt_factor_solve", Fk, dk, Fp, dp)
    rp = cs.rel_residual(Ms, xp, rs)
    counts = cs.check_residuals("ldlt_factor_solve",
                                cs.rel_residual(Ms, xk, rs), rp, r64)
    assert counts["gate_by_b_only"] >= 1, counts
    noise = torch.as_tensor(np.random.default_rng(1).normal(size=xk.shape),
                            dtype=xk.dtype, device=dev)
    with pytest.raises(RuntimeError, match="pass neither"):
        cs.check_residuals("perturbed", cs.rel_residual(
            Ms, xk * (1.0 + 1e-2 * noise), rs), rp, r64)


@pytest.mark.cuda
def test_schur_solve_on_a_one_rank_nccl_group(dev):
    """schur_horizon_solve and factor + apply on a one-rank NCCL group's
    ("seg",) mesh equal the mesh-less ones (the same operations, the
    condensed blocks gathered over one rank)."""
    import torch.distributed as dist
    from polympc_torch.multichip_point import free_port
    from polympc_torch.parallel import horizon as th
    from polympc_torch.parallel import initialize_multihost
    rng = np.random.default_rng(3)
    S, k, p, B = 4, 12, 3, 2
    A = rng.normal(size=(B, S, k, k))
    K = torch.as_tensor(A @ A.transpose(0, 1, 3, 2) / k + np.eye(k),
                        device=dev)
    b = torch.as_tensor(rng.normal(size=(B, S, k)), device=dev)
    c = torch.as_tensor(rng.normal(size=(B, S - 1, p)), device=dev)
    E = np.zeros((p, k))
    F = np.zeros((p, k))
    E[:, k - p:] = np.eye(p)
    F[:, :p] = -np.eye(p)
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        mesh = th.horizon_mesh()
        for got, want in zip(th.schur_horizon_solve(K, b, E, F, c, mesh=mesh),
                             th.schur_horizon_solve(K, b, E, F, c)):
            assert torch.equal(got, want)
        fac = th.schur_horizon_factor(K, E, F, mesh=mesh)
        for got, want in zip(th.schur_horizon_apply(fac, b, c),
                             th.schur_horizon_apply(
                                 th.schur_horizon_factor(K, E, F), b, c)):
            assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_ldlt_lanes_entry_points_on_the_card(dev):
    """The lane-major LDL^T entry points ((K, K, B), the batch last) launch
    the kernels of their batch-first twins and equal them bit for bit."""
    rng = np.random.default_rng(41)
    B, K = 256, 40
    A = rng.normal(size=(B, K, K))
    M = A + A.transpose(0, 2, 1)
    M += np.eye(K) * (np.abs(M).sum(2, keepdims=True) + 1.0) \
        * np.where(np.arange(K) < K // 2, 1.0, -1.0)
    M = torch.as_tensor(M, dtype=torch.float32, device=dev)
    b = torch.as_tensor(rng.normal(size=(B, K)), dtype=torch.float32,
                        device=dev)
    Ml, bl = M.movedim(0, -1), b.movedim(0, -1)
    _build.reset_launches()
    F, d = ldlt.ldlt_factor_lanes(Ml)
    x, F2, d2 = ldlt.ldlt_factor_solve_lanes(Ml, bl)
    xs = ldlt.ldlt_solve_lanes(F, d, bl)
    inv = ldlt.ldlt_inverse_lanes(Ml)
    for name in ("ldlt_factor", "ldlt_factor_solve", "ldlt_solve",
                 "ldlt_inverse"):
        assert _build.LAUNCHES[name] == 1, name
    Fb, db = ldlt.ldlt_factor(M)
    assert torch.equal(F, Fb.movedim(0, -1)) and torch.equal(
        d, db.movedim(0, -1))
    for got, want in zip((x, F2, d2), ldlt.ldlt_factor_solve(M, b)):
        assert torch.equal(got, want.movedim(0, -1))
    assert torch.equal(xs, ldlt.ldlt_solve(Fb, db, b).movedim(0, -1))
    assert torch.equal(inv, ldlt.ldlt_inverse(M).movedim(0, -1))


@pytest.mark.cuda
def test_long_horizon_on_the_card(dev):
    """The long-horizon Newton engine in float64 on the card (S=16, B=2
    from the card path's draw) against the same solve on the CPU: hist
    within 1e-9, Z within 1e-8 (another LU, other summation orders)."""
    from polympc_torch import long_horizon_point as lp
    from polympc_torch.parallel.long_horizon import solve_long_horizon
    lh = lp.long_horizon(16)
    x0 = lp.lane_x0s(2)
    Zc, _, hc = solve_long_horizon(lh, x0, iters=lp.ITERS, device=dev)
    Zh, _, hh = solve_long_horizon(lh, x0, iters=lp.ITERS, device="cpu")
    assert Zc.device.type == "cuda"
    for a, b in zip(hc, hh):
        for k in ("defect", "continuity"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-9)
    np.testing.assert_allclose(Zc.cpu().numpy(), Zh.numpy(), rtol=0,
                               atol=1e-8)
    assert hc[-1]["defect"].max() <= 1e-7


def _derivative_case(name, dev, dtype):
    """The kite's (n=77, m=55) or the race car's (n=99, m=66)
    transcription, its parameters and a state to start the guess from."""
    if name == "kite":
        from polympc_torch.headline import bench_x0s
        tr, _, prm, _ = kite_problem(dev, dtype)
        return tr, prm, torch.as_tensor(bench_x0s(1)[0])
    from polympc_torch.headline_table import RACE_X0, race_car_problem
    tr, _, prm, _, _ = race_car_problem(dev, dtype)
    return tr, prm, torch.as_tensor(RACE_X0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4096, 1, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["kite", "race_car"])
def test_replayed_derivatives_equal_eager_bit_for_bit(name, dtype, B, dev):
    """The gradient, constraints, Jacobian and Lagrangian Hessian replayed
    from CUDA graphs (nlp/graphed.py) equal eager bit for bit, at the
    main path's batch, at one lane and at an odd tail, in the SQP's float32
    and the certify's float64: each key is called at four points (eager,
    capture, replay, replay), every answer is compared with eager only
    after the last call (so a held answer survives the replays after it),
    then once more with a parameter changed between two replays.  The
    first sight is each evaluation's first call in the test, eager on the
    calling thread as every later one (a Hessian's outer reverse pass
    would otherwise take its order from the process's history)."""
    from polympc_torch.nlp import graphed, sqp
    from polympc_torch.utils import timing as tm
    from polympc_torch.utils.precision import full_precision
    tr, prm, x0 = _derivative_case(name, dev, dtype)
    nlp = tr.nlp
    assert (nlp.n, nlp.m) == {"kite": (77, 55), "race_car": (99, 66)}[name]
    gen = torch.Generator(device=dev).manual_seed(B)
    base = tr.initial_guess(x0, dtype=dtype, device=dev)[None]

    def point():
        return (base + 0.01 * torch.randn(B, nlp.n, generator=gen,
                                          dtype=dtype, device=dev),
                torch.randn(B, nlp.m, generator=gen, dtype=dtype,
                            device=dev))
    evals = [(sqp._grad, lambda x, lam, p: (nlp, x, p)),
             (sqp._constraints, lambda x, lam, p: (nlp, x, p)),
             (sqp._jac, lambda x, lam, p: (nlp, x, p)),
             (sqp._lag_hessian, lambda x, lam, p: (nlp, x, lam, p))]
    moved = dict(prm, tf=prm["tf"] * 1.25)
    graphed.clear()
    tm.start_recording()
    try:
        with full_precision():
            for fn, args in evals:
                pts = [point() for _ in range(4)]
                outs = [graphed.call(fn, *args(x, lam, prm))
                        for x, lam in pts]
                x, lam = pts[-1]
                out = graphed.call(fn, *args(x, lam, moved))
                for (x, lam), got in zip(pts, outs):
                    assert torch.equal(got, graphed._eager(
                        fn, args(x, lam, prm))), fn
                assert torch.equal(out, graphed._eager(
                    fn, args(x, lam, moved))), fn
                assert not torch.equal(out, outs[-1]), fn
    finally:
        tm.stop_recording()
        graphed.clear()
    assert tm.recorded().counts == {"derivatives.eager": 4,
                                    "derivatives.capture": 4,
                                    "derivatives.replay": 12}
