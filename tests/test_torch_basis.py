"""Parity of the port's collocation bases (polympc_torch.basis) with the JAX
package's: nodes, differentiation matrices, quadrature and barycentric
weights, and the segmented-mesh operators, to 1e-12."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from polympc_tpu.basis import basis as jb  # noqa: E402
from polympc_tpu.basis import nodes as jn  # noqa: E402
from polympc_torch.basis import basis as tb  # noqa: E402
from polympc_torch.basis import nodes as tn  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind,order", [
    ("Chebyshev", 5), ("Chebyshev", 12), ("Legendre", 5), ("Legendre", 9),
    ("LegendreGauss", 4), ("LegendreRadau", 6)])
def test_basis_matches_jax(kind, order):
    a, b = getattr(jb, kind)(order), getattr(tb, kind)(order)
    assert (a.order, a.kind) == (b.order, b.kind)
    for field in ("nodes", "D", "quad_weights", "bary_w"):
        np.testing.assert_allclose(getattr(b, field), getattr(a, field),
                                   err_msg=field, **TOL)
    t = np.linspace(-1.0, 1.0, 7)
    np.testing.assert_allclose(b.interp_matrix(t), a.interp_matrix(t), **TOL)


@pytest.mark.parametrize("fn,args", [
    ("cgl_nodes", (7,)), ("lgl_nodes", (7,)), ("lgl_weights", (6,)),
    ("lg_nodes", (5,)), ("lgr_nodes", (5,)),
    ("clenshaw_curtis_weights", (8,)),
    ("chebyshev_quadrature_weights", (8,))])
def test_nodes_match_jax(fn, args):
    a, b = getattr(jn, fn)(*args), getattr(tn, fn)(*args)
    for x, y in zip(np.atleast_1d(a) if not isinstance(a, tuple) else a,
                    np.atleast_1d(b) if not isinstance(b, tuple) else b):
        np.testing.assert_allclose(y, x, **TOL)


@pytest.mark.parametrize("order,segments", [(5, 2), (3, 4), (6, 1)])
def test_segmented_basis_matches_jax(order, segments):
    a = jb.SegmentedBasis(jb.Chebyshev(order), segments)
    b = tb.SegmentedBasis(tb.Chebyshev(order), segments)
    assert a.num_nodes == b.num_nodes and b.shares_boundary
    np.testing.assert_allclose(b.composite_diff_matrix(0.0, 2.0),
                               a.composite_diff_matrix(0.0, 2.0), **TOL)
    np.testing.assert_allclose(b.quadrature_weights(0.0, 3.0),
                               a.quadrature_weights(0.0, 3.0), **TOL)
    np.testing.assert_allclose(b.time_nodes(0.5, 2.0),
                               a.time_nodes(0.5, 2.0), **TOL)
    np.testing.assert_allclose(b.interp_matrix([0.1, 0.7], 0.0, 1.0),
                               a.interp_matrix([0.1, 0.7], 0.0, 1.0), **TOL)


@pytest.mark.parametrize("kind", ["Chebyshev", "Legendre"])
def test_projection_matches_jax(kind):
    """tests/test_basis.py::test_projection's case: the coefficients and the
    numpy evaluation equal the JAX package's to 1e-12; the torch Clenshaw
    evaluation agrees with them to 1e-12 and with f to the test's 1e-6."""
    from polympc_tpu.basis.projection import project as jproject
    from polympc_torch.basis import project
    f = lambda t: np.exp(-t) * np.sin(3 * t)
    pj = jproject(f, getattr(jb, kind)(12), a=0.0, b=2.0)
    pt = project(f, getattr(tb, kind)(12), a=0.0, b=2.0)
    assert pt.kind == pj.kind
    np.testing.assert_allclose(pt.coeffs, pj.coeffs, **TOL)
    tq = np.linspace(0.0, 2.0, 33)
    np.testing.assert_allclose(pt(tq), pj(tq), **TOL)
    assert float(pt(0.7)) == pytest.approx(float(pj(0.7)), abs=1e-12)
    ev = pt.eval(torch.tensor(tq, dtype=torch.float64))
    assert ev.dtype == torch.float64 and ev.shape == (33,)
    np.testing.assert_allclose(ev.numpy(), pj(tq), **TOL)
    np.testing.assert_allclose(ev.numpy(), f(tq), atol=1e-6)
