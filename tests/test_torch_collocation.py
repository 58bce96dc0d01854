"""The port's standalone collocation operators against the JAX package's in
float64: defects and their per-node block Jacobian, the quadrature cost and
its gradient, and the node-stacked inequalities with their Jacobian, to
1e-12, on the robot (Chebyshev(4) x 3, Mayer) and a Radau mesh.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import single_thread  # noqa: E402,F401
from polympc_tpu import basis as jb  # noqa: E402
from polympc_tpu.models import robot_ocp as j_robot_ocp  # noqa: E402
from polympc_tpu.ocp import collocation as J  # noqa: E402
from polympc_torch import basis as tb  # noqa: E402
from polympc_torch.models import robot_ocp  # noqa: E402
from polympc_torch.ocp import collocation as T  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-12)


def _ineq(lib):
    def g(x, u, p, d, t):
        return lib.stack([u[0] ** 2 * lib.cos(u[1]), x[0] * x[1] + t])
    return g


def _meshes(kind):
    if kind == "lobatto":
        return (jb.SegmentedBasis(jb.Chebyshev(4), 3),
                tb.SegmentedBasis(tb.Chebyshev(4), 3))
    return (jb.SegmentedBasis(jb.LegendreRadau(3), 2),
            tb.SegmentedBasis(tb.LegendreRadau(3), 2))


@pytest.mark.parametrize("kind", ["lobatto", "radau"])
def test_collocation_operators_match_jax(kind):
    jm, tm = _meshes(kind)
    jo, to = j_robot_ocp(), robot_ocp()
    N = tm.num_nodes
    rng = np.random.default_rng(21)
    X, U = rng.normal(size=(N, 3)), rng.normal(size=(N, 2))
    d = np.array([2.0])
    args = dict(t0=0.3, tf=2.1)
    ja = (jnp.asarray(X), jnp.asarray(U), jnp.zeros(0), jnp.asarray(d))
    ta = (torch.tensor(X), torch.tensor(U),
          torch.zeros(0, dtype=torch.float64), torch.tensor(d))

    jd = J.collocate_dynamics(jo.dynamics, jm, 3, 2)
    td = T.collocate_dynamics(to.dynamics, tm, 3, 2)
    assert td.N == jd.N == N
    np.testing.assert_allclose(td.defects(*ta, **args).numpy(),
                               np.asarray(jd.defects(*ja, **args)), **TOL)
    np.testing.assert_allclose(td.jacobian(*ta, **args).numpy(),
                               np.asarray(jd.jacobian(*ja, **args)), **TOL)

    jc = J.collocate_cost(jo.lagrange, jo.mayer, jm)
    tc = T.collocate_cost(to.lagrange, to.mayer, tm)
    np.testing.assert_allclose(float(tc.value(*ta, **args)),
                               float(jc.value(*ja, **args)), **TOL)
    for got, want in zip(tc.gradient(*ta, **args),
                         jc.gradient(*ja, **args)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    jg = J.collocate_constraints(_ineq(jnp), 2, jm, 3, 2)
    tg = T.collocate_constraints(_ineq(torch), 2, tm, 3, 2)
    np.testing.assert_allclose(tg.value(*ta, **args).numpy(),
                               np.asarray(jg.value(*ja, **args)), **TOL)
    np.testing.assert_allclose(tg.jacobian(*ta, **args).numpy(),
                               np.asarray(jg.jacobian(*ja, **args)), **TOL)


def test_collocation_cost_without_mayer_or_lagrange():
    _, tm = _meshes("lobatto")
    X = torch.ones(tm.num_nodes, 3, dtype=torch.float64)
    U = torch.zeros(tm.num_nodes, 2, dtype=torch.float64)
    only_mayer = T.collocate_cost(None, lambda x, p, d: x @ x, tm)
    gX, gU = only_mayer.gradient(X, U)
    assert float(only_mayer.value(X, U)) == 3.0
    np.testing.assert_array_equal(gX[-1].numpy(), [2.0, 2.0, 2.0])
    assert float(gX[:-1].abs().sum()) == 0.0 and float(gU.abs().sum()) == 0.0
