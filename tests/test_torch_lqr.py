"""Parity of the port's LQR / CARE / Lyapunov solvers
(polympc_torch.control.lqr, BASELINE config 2) with the JAX package's, in
float64 on the CPU: the same seeded numpy systems go to both.  Tolerances:
1e-10 relative on pinv, Lyapunov and the cross-term LQR, 1e-9 on the other
CARE and LQR results (the two packages run the same Newton-Kleinman steps
through LAPACK solves of the same systems), scipy's
CARE solution at the JAX tests' own tolerances, and the gradient through
``care`` against JAX's gradient at 1e-8 relative."""
import importlib

import numpy as np
import pytest
from scipy.linalg import solve_continuous_are

import jax
import jax.numpy as jnp
import torch

jl = importlib.import_module("polympc_tpu.control.lqr")
tl = importlib.import_module("polympc_torch.control.lqr")

from polympc_torch.solvers_point import quadrotor, quadrotor_batch
from tests._torch_parity import single_thread  # noqa: F401

TOL = dict(rtol=1e-10, atol=1e-12)


def _system(n, m, seed):
    """tests/test_control.py's random system."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    B = rng.normal(size=(n, m))
    Qh = rng.normal(size=(n, n))
    Q = Qh @ Qh.T + 0.1 * np.eye(n)
    R = np.diag(rng.uniform(0.5, 2.0, m))
    return A, B, Q, R


def t64(a):
    return torch.tensor(np.asarray(a, np.float64))


def j64(a):
    return jnp.asarray(np.asarray(a, np.float64))


def test_pinv_matches_jax():
    A = np.random.default_rng(0).normal(size=(5, 3))
    np.testing.assert_allclose(tl.pinv(t64(A)).numpy(),
                               np.asarray(jl.pinv(j64(A))), **TOL)
    # batched, with a rank-deficient lane
    As = np.random.default_rng(1).normal(size=(3, 4, 4))
    As[1, :, 3] = As[1, :, 0]
    got = tl.pinv(t64(As)).numpy()
    for b in range(3):
        np.testing.assert_allclose(got[b], np.asarray(jl.pinv(j64(As[b]))),
                                   rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("n", [2, 6, 12])
def test_lyapunov_matches_jax(n):
    rng = np.random.default_rng(n)
    A = rng.normal(size=(n, n)) - 2.0 * n * np.eye(n)
    Qh = rng.normal(size=(n, n))
    Q = Qh @ Qh.T + np.eye(n)
    P = tl.lyapunov(t64(A), t64(Q)).numpy()
    np.testing.assert_allclose(P, np.asarray(jl.lyapunov(j64(A), j64(Q))),
                               **TOL)
    np.testing.assert_allclose(A.T @ P + P @ A + Q, 0.0, atol=1e-9)


@pytest.mark.parametrize("line_search", [False, True])
@pytest.mark.parametrize("seed,nm", [(0, (4, 2)), (1, (12, 4)), (11, (6, 2))])
def test_care_matches_jax(seed, nm, line_search):
    A, B, Q, R = _system(*nm, seed)
    P = tl.care(*map(t64, (A, B, Q, R)), line_search=line_search).numpy()
    Pj = np.asarray(jl.care(*map(j64, (A, B, Q, R)),
                            line_search=line_search))
    np.testing.assert_allclose(P, Pj, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(P, solve_continuous_are(A, B, Q, R),
                               rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("num_newton,line_search",
                         [(12, False), (12, True), (25, True)])
def test_care_stiff_fixture_matches_jax(num_newton, line_search):
    """tests/test_control.py's stiff non-normal instance: the plain
    iteration is far from the solution after 12 steps, the line search
    close; the port's iterates are the JAX package's."""
    from tests.test_control import CARE_STIFF_A, CARE_STIFF_B
    A, B, Q, R = CARE_STIFF_A, CARE_STIFF_B, np.eye(8), 1.445512 * np.eye(2)
    P = tl.care(*map(t64, (A, B, Q, R)), num_newton=num_newton,
                line_search=line_search).numpy()
    Pj = np.asarray(jl.care(*map(j64, (A, B, Q, R)), num_newton=num_newton,
                            line_search=line_search))
    scale = np.abs(Pj).max()
    assert np.abs(P - Pj).max() / scale < 1e-8
    ref = solve_continuous_are(A, B, Q, R)
    err = np.abs(P - ref).max() / np.abs(ref).max()
    if line_search:
        assert err < 1e-4
    else:
        assert err > 1e-2


def test_lqr_quadrotor_matches_jax_and_scipy():
    A, B, Q, R = quadrotor()
    K, P = tl.lqr(*map(t64, (A, B, Q, R)))
    Kj, Pj = jl.lqr(*map(j64, (A, B, Q, R)))
    np.testing.assert_allclose(P.numpy(), np.asarray(Pj), rtol=1e-9,
                               atol=1e-10)
    np.testing.assert_allclose(K.numpy(), np.asarray(Kj), rtol=1e-9,
                               atol=1e-10)
    np.testing.assert_allclose(P.numpy(), solve_continuous_are(A, B, Q, R),
                               rtol=1e-5, atol=1e-7)
    assert np.all(np.linalg.eigvals(A - B @ K.numpy()).real < 0)


def test_lqr_cross_term_matches_jax():
    A, B, Q, R = _system(5, 2, 7)
    M = 0.1 * np.random.default_rng(8).normal(size=(5, 2))
    K, P = tl.lqr(*map(t64, (A, B, Q, R)), M=t64(M))
    Kj, Pj = jl.lqr(*map(j64, (A, B, Q, R)), M=j64(M))
    np.testing.assert_allclose(P.numpy(), np.asarray(Pj), **TOL)
    np.testing.assert_allclose(K.numpy(), np.asarray(Kj), **TOL)
    np.testing.assert_allclose(P.numpy(),
                               solve_continuous_are(A, B, Q, R, s=M),
                               rtol=1e-6, atol=1e-8)


def test_care_gradient_matches_jax():
    """d P[0, 0] / d q_scale with Q scaled by q_scale, through autograd and
    through jax.grad (test_care_jittable_and_differentiable's case)."""
    A, B, Q, R = _system(4, 2, 3)
    q = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    P = tl.care(t64(A), t64(B), q * t64(Q), t64(R))
    (g,) = torch.autograd.grad(P[0, 0], q)
    gj = jax.grad(lambda s: jl.care(j64(A), j64(B), s * j64(Q),
                                    j64(R))[0, 0])(1.0)
    np.testing.assert_allclose(g.item(), float(gj), rtol=1e-8)
    f = lambda s: tl.care(t64(A), t64(B), s * t64(Q), t64(R))[0, 0].item()
    fd = (f(1.0 + 1e-5) - f(1.0 - 1e-5)) / 2e-5
    np.testing.assert_allclose(g.item(), fd, rtol=1e-5)


def test_batched_care_and_lqr_match_per_lane_jax():
    """A (B, n, n) batch (the card path's perturbed quadrotors at B=3)
    against one JAX call per lane."""
    _, B, Q, R = quadrotor()
    As = quadrotor_batch(3)
    K, P = tl.lqr(t64(As), t64(B), t64(Q), t64(R))
    Pc = tl.care(t64(As), t64(B), t64(Q), t64(R), line_search=True)
    assert K.shape == (3, 4, 12) and P.shape == (3, 12, 12)
    for b in range(3):
        Kj, Pj = jl.lqr(j64(As[b]), *map(j64, (B, Q, R)))
        np.testing.assert_allclose(P[b].numpy(), np.asarray(Pj), rtol=1e-9,
                                   atol=1e-10)
        np.testing.assert_allclose(K[b].numpy(), np.asarray(Kj), rtol=1e-9,
                                   atol=1e-10)
        Pcj = jl.care(j64(As[b]), *map(j64, (B, Q, R)), line_search=True)
        np.testing.assert_allclose(Pc[b].numpy(), np.asarray(Pcj),
                                   rtol=1e-9, atol=1e-10)
