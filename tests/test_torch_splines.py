"""Parity of the port's splines (polympc_torch.basis.splines) with the JAX
package's, in float64: the natural and periodic fits give the same
coefficient tables (the same numpy code, so to 1e-14), evaluation agrees to
1e-12 (negative arguments of the periodic spline included: the race car's s
is unbounded below), so do the derivatives the race car's Hessians take
through the lookup, and barycentric Lagrange interpolation agrees to 1e-12
at and between its nodes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import grad, jacrev, vmap  # noqa: E402

from polympc_tpu.basis import splines as js  # noqa: E402
from polympc_tpu.basis.basis import Chebyshev as JChebyshev  # noqa: E402
from polympc_torch.basis import splines as ts  # noqa: E402
from _torch_parity import single_thread  # noqa: E402,F401

TOL = dict(rtol=1e-12, atol=1e-12)


def _pair(periodic):
    rng = np.random.default_rng(11)
    n = 24
    y = rng.normal(size=n + 1)
    if periodic:
        y[-1] = y[0]
    return (js.fit_cubic_spline(-1.5, 0.25, y, periodic=periodic),
            ts.fit_cubic_spline(-1.5, 0.25, y, periodic=periodic,
                                device="cpu"))


@pytest.mark.parametrize("periodic", [False, True],
                         ids=["natural", "periodic"])
def test_fit_and_eval_match_jax(periodic):
    jsp, tsp = _pair(periodic)
    np.testing.assert_allclose(tsp.coeffs, np.asarray(jsp.coeffs),
                               rtol=1e-14, atol=1e-14)
    assert (tsp.num_segments, tsp.periodic) == (jsp.num_segments, periodic)
    # inside, at knots, outside on both sides (wrapped when periodic)
    x = np.concatenate([np.linspace(-9.0, 12.0, 97), [-1.5, 0.0, 4.5]])
    want = np.asarray(js.cubic_spline_eval(jsp, jnp.asarray(x)))
    got = ts.cubic_spline_eval(tsp, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(ts.cubic_spline_eval_np(tsp, x), want, **TOL)
    assert float(tsp(-7.25)) == pytest.approx(float(jsp(-7.25)), abs=1e-12)


@pytest.mark.parametrize("periodic", [False, True],
                         ids=["natural", "periodic"])
def test_derivatives_through_the_lookup_match_jax(periodic):
    """First and second derivatives of a function of the spline under
    ``vmap``, as the transcription takes them, in float64 and float32."""
    jsp, tsp = _pair(periodic)
    x = np.linspace(-6.0, 8.0, 29)
    jf = lambda s: jnp.sin(js.cubic_spline_eval(jsp, s)) * s
    tf = lambda s: torch.sin(ts.cubic_spline_eval(tsp, s)) * s
    g = vmap(grad(tf))(torch.as_tensor(x))
    h = vmap(jacrev(grad(tf)))(torch.as_tensor(x))
    np.testing.assert_allclose(g.numpy(), np.asarray(
        jax.vmap(jax.grad(jf))(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(
        jax.vmap(jax.grad(jax.grad(jf)))(jnp.asarray(x))), **TOL)
    # float32 takes the float32 table; inside the fitted range it agrees
    # with float64 to float32 rounding
    inside = (x > -1.5) & (x < 4.5)
    g32 = vmap(grad(tf))(torch.as_tensor(x[inside], dtype=torch.float32))
    assert g32.dtype == torch.float32
    np.testing.assert_allclose(g32.numpy(), g.numpy()[inside], rtol=1e-4,
                               atol=1e-4)


def test_spline_derivative_helper_matches_autograd():
    _, tsp = _pair(True)
    x = torch.linspace(-6.0, 8.0, 29, dtype=torch.float64)
    y, dy, ddy = ts._derivatives(tsp, x)
    f = lambda s: ts.cubic_spline_eval(tsp, s)
    torch.testing.assert_close(y, f(x), **TOL)
    torch.testing.assert_close(dy, vmap(grad(f))(x), **TOL)
    torch.testing.assert_close(ddy, vmap(grad(grad(f)))(x), **TOL)


@pytest.mark.parametrize("t", [0.3141, -0.77, 1.0])
def test_lagrange_interp_matches_jax(t):
    b = JChebyshev(6)
    nodes, w = np.asarray(b.nodes), np.asarray(b.bary_w)
    vals = np.random.default_rng(3).normal(size=(len(nodes), 3))
    t = float(nodes[2]) if t == 1.0 else t   # exactly at a node
    want = np.asarray(js.lagrange_interp(nodes, w, vals, t))
    got = ts.lagrange_interp(torch.as_tensor(nodes), torch.as_tensor(w),
                             torch.as_tensor(vals),
                             torch.tensor(t, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
