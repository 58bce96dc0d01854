"""Parity of the port's batch-first quasi-Newton updates
(polympc_torch/nlp/hessian.py) with the JAX package's per-instance ones
under ``jax.vmap``, in float64 at 1e-12: dense damped BFGS, SR1, and the
collocation block-BFGS with and without a parameter arrow, each on a batch
in which one lane has s = 0 (a degenerate step that must leave its matrix
unchanged) and one lane fails the curvature test (damped).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import single_thread, t64  # noqa: E402,F401
from polympc_tpu.nlp import hessian as jh  # noqa: E402
from polympc_torch.nlp import hessian as th  # noqa: E402

B = 5
ATOL = 1e-12


def _spd(rng, b, n):
    A = rng.normal(size=(b, n, n))
    return A @ A.transpose(0, 2, 1) + n * np.eye(n)


def _steps(rng, b, n):
    """(s, y) per lane: lane 0 a zero step, lane 1 negative curvature
    (s'y < 0, so the BFGS update is damped), the rest random."""
    s = rng.normal(size=(b, n))
    y = rng.normal(size=(b, n))
    s[0] = 0.0
    y[1] = -s[1]
    return s, y


@pytest.mark.parametrize("name", ["bfgs_update", "sr1_update"])
def test_dense_update_matches_jax(name):
    rng = np.random.default_rng(3)
    n = 7
    Bm = _spd(rng, B, n)
    s, y = _steps(rng, B, n)
    want = np.asarray(jax.vmap(getattr(jh, name))(
        jnp.asarray(Bm), jnp.asarray(s), jnp.asarray(y)))
    got = getattr(th, name)(t64(Bm), t64(s), t64(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * np.abs(
        want).max())
    np.testing.assert_array_equal(got[0], Bm[0])
    assert not np.allclose(got[2], Bm[2])


def _block(rng, N, nx, nu, np_):
    spd = lambda k: _spd(rng, B * N, k).reshape(B, N, k, k)
    return (spd(nx), spd(nu), 0.1 * rng.normal(size=(B, N, nx, nu)),
            0.1 * rng.normal(size=(B, N * (nx + nu), np_)),
            _spd(rng, B, np_) if np_ else np.zeros((B, 0, 0)))


@pytest.mark.parametrize("np_", [0, 2])
def test_block_bfgs_matches_jax(np_):
    rng = np.random.default_rng(11 + np_)
    N, nx, nu = 4, 3, 2
    n = N * (nx + nu) + np_
    blocks = _block(rng, N, nx, nu, np_)
    s, y = _steps(rng, B, n)
    jB = jh.BlockHessian(*(jnp.asarray(a) for a in blocks))
    tB = th.BlockHessian(*(t64(a) for a in blocks))

    want = jax.vmap(lambda H, a, b: jh.block_bfgs_update(H, a, b, N, nx, nu))(
        jB, jnp.asarray(s), jnp.asarray(y))
    got = th.block_bfgs_update(tB, t64(s), t64(y), N, nx, nu)
    for f, g, w, old in zip(th.BlockHessian._fields, got, want, blocks):
        w = np.asarray(w)
        scale = max(np.abs(w).max(initial=0.0), 1.0)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL * scale,
                                   err_msg=f)
        np.testing.assert_array_equal(g.numpy()[0], old[0], err_msg=f)

    mv = np.asarray(jax.vmap(lambda H, a: jh.block_hessian_matvec(
        H, a, N, nx, nu))(jB, jnp.asarray(s)))
    np.testing.assert_allclose(
        th.block_hessian_matvec(tB, t64(s), N, nx, nu).numpy(), mv,
        rtol=0, atol=ATOL * np.abs(mv).max())
    dense = np.asarray(jax.vmap(lambda H: jh.assemble_block_hessian(
        H, N, nx, nu))(jB))
    np.testing.assert_array_equal(
        th.assemble_block_hessian(tB, N, nx, nu).numpy(), dense)
    # the block matvec is the assembled matrix's
    np.testing.assert_allclose(np.einsum("bij,bj->bi", dense, s), mv,
                               atol=1e-12 * np.abs(mv).max())


def test_block_identity_matches_jax():
    want = jh.block_hessian_identity(3, 2, 1, 1, jnp.float64)
    got = th.block_hessian_identity(3, 2, 1, 1, B, torch.float64, "cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == (B,) + tuple(w.shape)
        for b in range(B):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
