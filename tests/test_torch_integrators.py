"""Parity of the port's ODE integrators with the JAX package's, in float64:
``implicit_integrate``, ``radau_integrate`` and ``ps_integrate`` to 1e-10;
``adaptive_integrate`` (TR-BDF2, batch-first with per-lane step control)
with the same accepted and rejected step counts per lane and states to
1e-10, including a lane that exhausts ``max_steps`` and the save grid.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import single_thread  # noqa: E402,F401
from polympc_tpu.basis import Chebyshev as JChebyshev  # noqa: E402
from polympc_tpu.basis import SegmentedBasis as JSegmentedBasis  # noqa: E402
from polympc_tpu.ocp import integrators as J  # noqa: E402
from polympc_torch.basis import Chebyshev, SegmentedBasis  # noqa: E402
from polympc_torch.ocp import integrators as T  # noqa: E402

TOL = dict(rtol=1e-10, atol=1e-10)


def t64(a):
    return torch.tensor(np.asarray(a, np.float64))


def _osc(x, u, t, lib):
    """A forced, damped oscillator: x'' = -x - 0.3 x' + u + sin(t)."""
    return lib.stack([x[1], -x[0] - 0.3 * x[1] + u[0] + lib.sin(t)])


def test_implicit_matches_jax_per_lane():
    U = np.random.default_rng(0).normal(size=(30, 1))
    x0s = np.array([[1.0, 0.0], [-0.5, 2.0]])
    got = T.implicit_integrate(lambda x, u, t: _osc(x, u, t, torch),
                               t64(x0s), 0.0, 3.0, 30, u=t64(U))
    assert got.shape == (2, 31, 2)
    for b, x0 in enumerate(x0s):
        want = J.implicit_integrate(lambda x, u, t: _osc(x, u, t, jnp),
                                    jnp.asarray(x0), 0.0, 3.0, 30,
                                    u=jnp.asarray(U))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), **TOL)


def test_implicit_stiff_one_trajectory():
    f = lambda x, u, t: -1000.0 * x
    got = T.implicit_integrate(f, t64([1.0]), 0.0, 0.1, 10)
    want = J.implicit_integrate(f, jnp.array([1.0]), 0.0, 0.1, 10)
    assert got.shape == (11, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(abs(float(got[-1, 0])), (2 / 3) ** 10,
                               rtol=1e-6)


@pytest.mark.parametrize("order,u", [(2, None), (3, "const")])
def test_radau_matches_jax(order, u):
    uc = np.array([0.4])
    fj = lambda x, u_, t: _osc(x, uc if u_ is None else u_, t, jnp)
    ft = lambda x, u_, t: _osc(x, t64(uc) if u_ is None else u_, t, torch)
    ua = None if u is None else uc
    got = T.radau_integrate(ft, t64([[1.0, 0.0], [0.2, -1.0]]), 0.0, 2.0,
                            8, order=order,
                            u=None if ua is None else t64(ua))
    for b, x0 in enumerate(([1.0, 0.0], [0.2, -1.0])):
        want = J.radau_integrate(fj, jnp.asarray(x0), 0.0, 2.0, 8,
                                 order=order,
                                 u=None if ua is None else jnp.asarray(ua))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), **TOL)


def test_radau_l_stable():
    f = lambda x, u, t: -1000.0 * x
    xr = T.radau_integrate(f, t64([1.0]), 0.0, 1.0, num_steps=10, order=2)
    assert abs(float(xr[-1, 0])) < 1e-8


def test_ps_integrate_matches_jax():
    f = lambda x, u, t: x * (1 - x)
    X, t = T.ps_integrate(f, t64([[0.1], [0.4]]), 0.0, 4.0,
                          SegmentedBasis(Chebyshev(10), 3))
    for b, x0 in enumerate((0.1, 0.4)):
        Xj, tj = J.ps_integrate(f, jnp.array([x0]), 0.0, 4.0,
                                JSegmentedBasis(JChebyshev(10), 3))
        np.testing.assert_allclose(X[b].numpy(), np.asarray(Xj), **TOL)
        np.testing.assert_allclose(t.numpy(), np.asarray(tj), **TOL)
    tt = t.numpy()
    np.testing.assert_allclose(X[0, :, 0].numpy(),
                               1.0 / (1.0 + 9.0 * np.exp(-tt)), atol=1e-7)


def _vdp(x, u, t, lib, mu=30.0):
    return lib.stack([x[1], mu * ((1 - x[0] ** 2) * x[1]) - x[0]])


def test_adaptive_counts_equal_per_lane():
    """Three lanes of a stiff Van der Pol oscillator, each stepping on its
    own: the step counts and endpoints of the JAX loop, lane by lane; the
    first lane finishes while the other two run out of steps (success
    False), so the loop keeps running lanes beside a finished one."""
    x0s = np.array([[2.0, 0.0], [1.0, 0.5], [0.5, -1.0]])
    kw = dict(rtol=1e-6, atol=1e-9, max_steps=300)
    x, (acc, rej, ok) = T.adaptive_integrate(
        lambda x, u, t: _vdp(x, u, t, torch), t64(x0s), 0.0, 8.0, **kw)
    for b, x0 in enumerate(x0s):
        xj, (aj, rj, okj) = J.adaptive_integrate(
            lambda x, u, t: _vdp(x, u, t, jnp), jnp.asarray(x0), 0.0, 8.0,
            **kw)
        assert (int(acc[b]), int(rej[b]), bool(ok[b])) == \
            (int(aj), int(rj), bool(okj)), b
        np.testing.assert_allclose(x[b].numpy(), np.asarray(xj), **TOL)
    assert ok.any() and not ok.all()


def test_adaptive_save_grid_and_control_match_jax():
    ts = np.linspace(0.5, 3.0, 4)
    u = np.array([0.2])
    xs, (acc, rej, ok) = T.adaptive_integrate(
        lambda x, u_, t: _osc(x, u_, t, torch), t64([1.0, 0.0]), 0.0, 3.0,
        u=t64(u), rtol=1e-7, atol=1e-10, ts=ts)
    xj, (aj, rj, okj) = J.adaptive_integrate(
        lambda x, u_, t: _osc(x, u_, t, jnp), jnp.array([1.0, 0.0]), 0.0,
        3.0, u=jnp.asarray(u), rtol=1e-7, atol=1e-10, ts=ts)
    assert xs.shape == (4, 2) and bool(ok) and bool(okj)
    assert (int(acc), int(rej)) == (int(aj), int(rj))
    np.testing.assert_allclose(xs.numpy(), np.asarray(xj), **TOL)


def test_adaptive_reports_failure_on_step_exhaustion():
    f = lambda x, u, t: -x
    kw = dict(rtol=1e-10, atol=1e-14, max_steps=5)
    x, (acc, rej, ok) = T.adaptive_integrate(f, t64([1.0]), 0.0, 1e6, **kw)
    xj, (aj, rj, okj) = J.adaptive_integrate(f, jnp.array([1.0]), 0.0, 1e6,
                                             **kw)
    assert not bool(ok) and not bool(okj)
    assert (int(acc), int(rej)) == (int(aj), int(rj))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **TOL)


def test_adaptive_exponential_accuracy():
    x, (acc, rej, ok) = T.adaptive_integrate(lambda x, u, t: -x, t64([1.0]),
                                             0.0, 2.0, rtol=1e-8, atol=1e-12)
    assert bool(ok)
    np.testing.assert_allclose(float(x[0]), np.exp(-2.0), rtol=1e-5)
