"""Parity of the port's structured KKT operations (polympc_torch.ops) with the
JAX package's Pallas kernels, which run here in interpret mode.

  * the plain BBT epoch and the plain BBT factor + solve against
    ``bbt_admm_epoch_batched`` / ``bbt_solve_batched``, on the kite
    structure (no border) and the parking structure (a border), B=3, in
    float64 to 1e-9;
  * the plain LDL^T factor + solve and solve against ``ldlt_factor_solve``
    / ``ldlt_solve`` at K=132 (the refine matrix size of the kite), to
    1e-10;
  * the plain explicit inverse against ``ldlt_inverse`` at (4, 72, 72)
    quasi-definite (the kite's per-segment dist KKT size), to 1e-10
    relative in float64 and 1e-4 in float32, and against
    ``numpy.linalg.inv``;
  * the wrappers' dispatch: a CPU tensor takes the plain version and counts
    no launch; a device without a kernel raises.

The CUDA kernels are held against their plain versions in
tests/test_torch_cuda.py, which runs on a machine with a card and no JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import _torch_parity as tp  # noqa: E402
from polympc_tpu.ops import bbt_kernel as jbk  # noqa: E402
from polympc_tpu.ops import ldlt as jldlt  # noqa: E402
from polympc_tpu.qp.box_admm import _build_kkt as j_build_kkt  # noqa: E402
from polympc_tpu.qp.types import QPData as JQPData  # noqa: E402
from polympc_torch.ops import _build, bbt_kernel, ldlt  # noqa: E402
from polympc_torch.ops.structure import (  # noqa: E402
    bbt_solve_dense, gather_blocks, permute_vec, scatter_solution)
from polympc_torch.qp import box_admm  # noqa: E402
from polympc_torch.qp.types import ADMMSettings  # noqa: E402

B = 3
SIGMA, ALPHA, ITERS = 1e-6, 1.6, 7


def _kkt_case(jtr, seed):
    """The boxADMM KKT of a transcription at a random point (the recipe of
    tests/test_bbt.py: exact Hessian shifted PSD, random penalties), plus
    random epoch data; numpy float64."""
    nlp = jtr.nlp
    n, m = nlp.n, nlp.m
    rng = np.random.default_rng(seed)
    z = jnp.asarray(rng.normal(size=n) * 0.3)
    lam = jnp.asarray(rng.normal(size=m))
    prm = jtr.params(d=[1.0] if jtr.ocp.nd else None, t0=0.0, tf=2.0)
    H = nlp.lag_hessian(z, lam, prm)
    lam_min = jnp.min(jnp.linalg.eigvalsh(H))
    H = H + (jnp.maximum(-lam_min, 0.0) + 0.1) * jnp.eye(n)
    rows = [nlp.eq_jac(z, prm)]
    if nlp.ni:
        rows.append(nlp.ineq_jac(z, prm))
    A = jnp.concatenate(rows, axis=0)
    rho = rng.uniform(0.5, 2.0, size=m)
    rb = rng.uniform(0.05, 0.2, size=n)
    qp = JQPData(H=H, h=jnp.zeros(n), A=A, al=jnp.zeros(m),
                 au=jnp.zeros(m), xl=-jnp.ones(n), xu=jnp.ones(n))
    K = np.asarray(j_build_kkt(qp, jnp.asarray(rho), jnp.asarray(rb), SIGMA))
    al = rng.normal(size=m) - 2.0
    vec = {"h": rng.normal(size=n), "al": al,
           "au": al + rng.uniform(0.5, 3.0, size=m),
           "xl": np.full(n, -0.8), "xu": np.full(n, 0.8), "rho": rho,
           "rb": rb, "x": rng.normal(size=n) * 0.1,
           "z": rng.normal(size=m) * 0.1}
    vec.update(q=vec["x"] + 0.01, y=rng.normal(size=m) * 0.1,
               yb=rng.normal(size=n) * 0.1, b=rng.normal(size=n + m))
    return K, vec


EPOCH_ARGS = ("h", "al", "au", "xl", "xu", "rho", "rb", "x", "z", "q", "y",
              "yb")


@pytest.fixture(scope="module", params=["kite", "parking"])
def bbt_case(request):
    """B distinct KKTs of one structure and the JAX kernels' outputs."""
    if request.param == "kite":
        jtr, ttr = tp.jax_kite()[0], tp.torch_kite()[0]
    else:
        jtr, ttr = tp.jax_parking(), tp.torch_parking()
    cases = [_kkt_case(jtr, seed) for seed in range(B)]
    K = np.stack([c[0] for c in cases])
    vec = {k: np.stack([c[1][k] for c in cases]) for k in cases[0][1]}
    jst = jtr.bbt_structure()
    j = lambda k: jnp.asarray(vec[k])
    epoch = jbk.bbt_admm_epoch_batched(
        jnp.asarray(K), *(j(k) for k in EPOCH_ARGS), st=jst, sigma=SIGMA,
        alpha=ALPHA, iters=ITERS)
    solve = jbk.bbt_solve_batched(jnp.asarray(K), j("b"), st=jst)
    return {"st": ttr.bbt_structure(), "K": K, "vec": vec,
            "epoch": [np.asarray(o) for o in epoch],
            "solve": np.asarray(solve)}


def test_plain_bbt_epoch_matches_jax(bbt_case):
    _build.reset_launches()
    v = {k: tp.t64(a) for k, a in bbt_case["vec"].items()}
    out = bbt_kernel.bbt_admm_epoch_batched(
        tp.t64(bbt_case["K"]), *(v[k] for k in EPOCH_ARGS),
        st=bbt_case["st"], sigma=SIGMA, alpha=ALPHA, iters=ITERS)
    for got, want, name in zip(out, bbt_case["epoch"], "xzqyb"):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9,
                                   err_msg=name)
    assert _build.LAUNCHES["bbt_epoch"] == 0


def test_plain_bbt_solve_matches_jax(bbt_case):
    _build.reset_launches()
    got = bbt_kernel.bbt_solve_batched(tp.t64(bbt_case["K"]),
                                       tp.t64(bbt_case["vec"]["b"]),
                                       st=bbt_case["st"])
    np.testing.assert_allclose(got.numpy(), bbt_case["solve"], rtol=1e-9,
                               atol=1e-9)
    assert _build.LAUNCHES["bbt_solve"] == 0


def test_plain_bbt_solve_matches_dense_oracle(bbt_case):
    st = bbt_case["st"]
    K = tp.t64(bbt_case["K"])
    rhs = permute_vec(tp.t64(bbt_case["vec"]["b"]), st, 0.0)
    blocks = gather_blocks(K, st)
    got = bbt_kernel.bbt_solve_plain(*blocks, rhs, st)
    want = bbt_solve_dense(*blocks, rhs, st)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9,
                               atol=1e-9)
    Sk = st.S * st.k
    x = scatter_solution(got[:, :Sk].reshape(-1, st.S, st.k), got[:, Sk:], st)
    np.testing.assert_allclose((K @ x[..., None])[..., 0].numpy(),
                               bbt_case["vec"]["b"], atol=1e-9)


def test_bbt_epoch_matches_dense_lu_epoch(bbt_case):
    """The structured epoch and the port's dense LU epoch are the same
    iteration."""
    st, vec = bbt_case["st"], bbt_case["vec"]
    v = {k: tp.t64(a) for k, a in vec.items()}
    K = tp.t64(bbt_case["K"])
    from polympc_torch.qp.types import QPData
    qp = QPData(H=None, h=v["h"], A=None, al=v["al"], au=v["au"],
                xl=v["xl"], xu=v["xu"])
    settings = ADMMSettings(sigma=SIGMA, alpha=ALPHA, check_every=ITERS)
    want = box_admm._dense_epoch(K, qp, v["rho"], v["rb"],
                                 tuple(v[k] for k in "x z q y yb".split()),
                                 settings)
    got = bbt_kernel.bbt_admm_epoch_batched(
        K, *(v[k] for k in EPOCH_ARGS), st=st, sigma=SIGMA, alpha=ALPHA,
        iters=ITERS)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-8,
                                   atol=1e-8)


K_REFINE = 132


def _dense_case(seed, K=K_REFINE, batch=B):
    """Symmetric indefinite, diagonally dominant (B, K, K) and rhs."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(batch, K, K))
    A = A + A.transpose(0, 2, 1)
    sign = np.where(np.arange(K) < K // 2, 1.0, -1.0)
    idx = np.arange(K)
    A[:, idx, idx] = sign * (np.abs(A).sum(axis=2) + 1.0)
    return A, rng.normal(size=(batch, K))


@pytest.fixture(scope="module")
def ldlt_case():
    M, b = _dense_case(3)
    x, F, d = jldlt.ldlt_factor_solve(jnp.asarray(M), jnp.asarray(b))
    b2 = np.random.default_rng(4).normal(size=b.shape)
    x2 = jldlt.ldlt_solve(F, d, jnp.asarray(b2))
    return {"M": M, "b": b, "b2": b2, "x": np.asarray(x),
            "F": np.asarray(F), "d": np.asarray(d), "x2": np.asarray(x2)}


def test_plain_ldlt_factor_solve_matches_jax(ldlt_case):
    _build.reset_launches()
    K = K_REFINE
    x, F, d = ldlt.ldlt_factor_solve(tp.t64(ldlt_case["M"]),
                                     tp.t64(ldlt_case["b"]))
    np.testing.assert_allclose(x.numpy(), ldlt_case["x"], rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(F.numpy(), ldlt_case["F"][:, :K, :K],
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(d.numpy(), ldlt_case["d"][:, :K], rtol=1e-10,
                               atol=1e-10)
    assert _build.LAUNCHES["ldlt_factor_solve"] == 0


def test_plain_ldlt_solve_matches_jax(ldlt_case):
    _build.reset_launches()
    K = K_REFINE
    x = ldlt.ldlt_solve(tp.t64(ldlt_case["F"][:, :K, :K]),
                        tp.t64(ldlt_case["d"][:, :K]),
                        tp.t64(ldlt_case["b2"]))
    np.testing.assert_allclose(x.numpy(), ldlt_case["x2"], rtol=1e-10,
                               atol=1e-10)
    assert _build.LAUNCHES["ldlt_solve"] == 0


@pytest.mark.parametrize("call", ["ldlt_factor_solve", "ldlt_solve",
                                  "bbt_epoch", "bbt_solve"])
def test_wrapper_without_kernel_raises(call):
    """A tensor on a device with no kernel and no plain dispatch raises
    instead of falling back."""
    M, b = (tp.t64(a).to("meta") for a in _dense_case(0, K=8, batch=2))
    st = tp.torch_kite()[0].bbt_structure()
    with pytest.raises(ValueError, match="no kernel"):
        if call == "ldlt_factor_solve":
            ldlt.ldlt_factor_solve(M, b)
        elif call == "ldlt_solve":
            ldlt.ldlt_solve(M, b, b)
        else:
            blocks = (torch.empty((2, st.S, st.k, st.k), device="meta"),
                      None, None, None)
            if call == "bbt_epoch":
                bbt_kernel.bbt_epoch(*blocks, None, st, SIGMA, ALPHA, 1)
            else:
                bbt_kernel.bbt_solve(*blocks, None, st)


def test_ldlt_wrappers_check_shapes():
    M, b = (tp.t64(a) for a in _dense_case(0, K=8, batch=2))
    with pytest.raises(ValueError):
        ldlt.ldlt_factor_solve(M, b[:, :4])
    with pytest.raises(ValueError):
        ldlt.ldlt_solve(M, b[:, :4], b)


def _quasi_definite(batch, nz, m, seed):
    """Symmetric quasi-definite (B, nz+m, nz+m) [[H, A'], [A, -D]] with H
    positive definite and D a positive diagonal: the per-segment ADMM KKT
    form the distributed SQP inverts (nz=42, m=30 at the kite's S=8)."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(batch, nz, nz))
    K = np.zeros((batch, nz + m, nz + m))
    K[:, :nz, :nz] = G @ G.transpose(0, 2, 1) / nz + np.eye(nz)
    A = rng.normal(size=(batch, m, nz))
    K[:, :nz, nz:] = A.transpose(0, 2, 1)
    K[:, nz:, :nz] = A
    K[:, nz:, nz:] = -np.eye(m) * rng.uniform(0.1, 2.0, (batch, m, 1))
    return K


@pytest.fixture(scope="module")
def inverse_case():
    """(4, 72, 72) quasi-definite matrices and the JAX package's Pallas
    ldlt_inverse of them (interpret mode) in float64 and float32."""
    M = _quasi_definite(4, 42, 30, seed=8)
    return {"M": M,
            "f64": np.asarray(jldlt.ldlt_inverse(jnp.asarray(M))),
            "f32": np.asarray(jldlt.ldlt_inverse(
                jnp.asarray(M, jnp.float32)))}


def _lane_rel(got, want):
    d = np.abs(got - want).reshape(got.shape[0], -1).max(1)
    return d / np.abs(want).reshape(want.shape[0], -1).max(1)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)],
                         ids=["f64", "f32"])
def test_plain_ldlt_inverse_matches_jax(inverse_case, dtype, tol):
    _build.reset_launches()
    M = inverse_case["M"]
    got = ldlt.ldlt_inverse(torch.tensor(M, dtype=dtype))
    assert got.shape == M.shape and got.dtype == dtype
    want = inverse_case["f64" if dtype == torch.float64 else "f32"]
    assert _lane_rel(got.double().numpy(), want.astype(np.float64)).max() \
        <= tol
    assert _lane_rel(got.double().numpy(), np.linalg.inv(M)).max() <= tol
    assert _build.LAUNCHES["ldlt_inverse"] == 0


def test_ldlt_inverse_wrapper_checks():
    """No kernel on a device without one; a non-square input raises; the
    fit rule (the matrix staged in shared memory in row stride K+1 beside
    four aligned pivot vectors, and held in the sweep's register tile)
    admits K up to 192 at the kernel's 256 threads and refuses, naming the
    shape, above."""
    with pytest.raises(ValueError, match="no kernel"):
        ldlt.ldlt_inverse(torch.empty((2, 8, 8), device="meta"))
    with pytest.raises(ValueError, match=r"\(B, K, K\)"):
        ldlt.ldlt_inverse(torch.zeros((2, 8, 7), dtype=torch.float64))
    assert ldlt.inverse_smem_bytes(192) <= _build.SMEM_LIMIT_BYTES
    assert ldlt.inverse_smem_bytes(72) == (72 * 73 + 4 + 4 * 96) * 4
    assert ldlt._THREADS == 256 and _build.SWEEP_MAX_K[256] == 192
    _build.check_sweep(192, 256, "ldlt_inverse at K=192")
    with pytest.raises(ValueError, match="K=193"):
        _build.check_sweep(193, 256, "ldlt_inverse at K=193")
