"""Soft defects and parameter identification in the port, against the JAX
package in float64: the soft-defect robot (tests/test_ms.py) with the same
status and iterations, x within 1e-8 and its cost within 10% of the
collocation cost; ``equation_error_fit`` on the noise-free pendulum within
1e-10 of the JAX estimate; ``identify`` (the soft-defect output-error SQP)
with p within 1e-8 of the JAX package's and within 1e-3 of the truth
(tests/test_identification.py's oracle), on a forced system too.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import single_thread  # noqa: E402,F401
from polympc_tpu import basis as jb  # noqa: E402
from polympc_tpu.basis.splines import fit_cubic_spline as j_fit  # noqa: E402
from polympc_tpu.models import robot_ocp as j_robot_ocp  # noqa: E402
from polympc_tpu.nlp import SQPSettings as JSQPSettings  # noqa: E402
from polympc_tpu.nlp import sqp_solve as j_sqp_solve  # noqa: E402
from polympc_tpu.ocp import ocp_bounds as j_ocp_bounds  # noqa: E402
from polympc_tpu.ocp import transcribe as j_transcribe  # noqa: E402
from polympc_tpu.ocp.identification import (  # noqa: E402
    equation_error_fit as j_eef, identify as j_identify)
from polympc_tpu.qp.types import ADMMSettings as JADMMSettings  # noqa: E402
from polympc_torch import basis as tb  # noqa: E402
from polympc_torch.basis.splines import fit_cubic_spline  # noqa: E402
from polympc_torch.models import robot_ocp  # noqa: E402
from polympc_torch.nlp import SQPSettings, sqp_solve  # noqa: E402
from polympc_torch.ocp import (  # noqa: E402
    equation_error_fit, identify, ocp_bounds, transcribe)
from polympc_torch.ocp_extras_point import pendulum_data  # noqa: E402
from polympc_torch.qp.types import ADMMSettings  # noqa: E402

X0 = [0.5, 0.5, 0.5]
P_TRUE = np.array([4.0, 0.3])


def test_soft_defect_robot_matches_jax():
    qp = dict(eps_abs=1e-6, eps_rel=1e-6, max_epochs=40)
    sq = dict(hessian="exact", max_iter=150, eps_prim=5e-3, eps_stat=0.5)
    bkw = dict(ul=[-1.5, -0.75], uu=[1.5, 0.75], x0=X0)
    jtr = j_transcribe(j_robot_ocp(), jb.SegmentedBasis(jb.Chebyshev(5), 2),
                       soft_defects=1e4)
    ttr = transcribe(robot_ocp(), tb.SegmentedBasis(tb.Chebyshev(5), 2),
                     soft_defects=1e4)
    assert ttr.nlp.ne == jtr.nlp.ne == 0
    assert ttr.nlp.eq is ttr.nlp.eq_jac is ttr.nlp.lag_hessian is None
    js = j_sqp_solve(jtr.nlp, jtr.initial_guess(X0),
                     p=jtr.params(d=[2.0], t0=0.0, tf=2.0),
                     bounds=j_ocp_bounds(jtr, **bkw),
                     settings=JSQPSettings(qp=JADMMSettings(**qp), **sq))
    ts = sqp_solve(ttr.nlp, ttr.initial_guess(X0, device="cpu")[None],
                   p=ttr.params(d=[2.0], t0=0.0, tf=2.0, device="cpu"),
                   bounds=ocp_bounds(ttr, device="cpu", **bkw),
                   settings=SQPSettings(qp=ADMMSettings(**qp), **sq))
    assert int(ts.status[0]) == int(js.status) == 1
    assert int(ts.iters[0]) == int(js.iters)
    np.testing.assert_allclose(ts.x[0].numpy(), np.asarray(js.x), rtol=0,
                               atol=1e-8)
    rec = np.load(Path(__file__).parent / "data" / "ocp_extras_jax_cpu.npz")
    c_ps = float(rec["ms_robot_collocation_cost"])
    assert abs(float(ts.cost[0]) - c_ps) / c_ps < 0.1


def _pendulum(lib):
    def f(x, u, p, d, t):
        return lib.stack([x[1], -p[0] * lib.sin(x[0]) - p[1] * x[1]])
    return f


@pytest.fixture(scope="module")
def data():
    """The noise-free pendulum record and its splines in both packages."""
    xs, xdata = pendulum_data("cpu")
    h = 3.0 / (xs.shape[0] - 1)
    sp = [j_fit(0.0, h, xs[:, k]) for k in range(2)]
    return xs, xdata, lambda t: jnp.stack([sp[0](t), sp[1](t)])


def test_equation_error_fit_matches_jax(data):
    _, xdata, jxdata = data
    jmesh = jb.SegmentedBasis(jb.Chebyshev(5), 6)
    tmesh = tb.SegmentedBasis(tb.Chebyshev(5), 6)
    t_nodes = tmesh.time_nodes(0.0, 3.0)
    Xj = jax.vmap(jxdata)(jnp.asarray(t_nodes))
    Xt = torch.func.vmap(xdata)(torch.tensor(t_nodes))
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0,
                               atol=1e-14)
    pj, rj = j_eef(_pendulum(jnp), jmesh, Xj, jnp.zeros((len(t_nodes), 0)),
                   0.0, 3.0, jnp.array([1.0, 1.0]))
    pt, rt = equation_error_fit(_pendulum(torch), tmesh, Xt,
                                torch.zeros(len(t_nodes), 0,
                                            dtype=torch.float64),
                                0.0, 3.0, [1.0, 1.0])
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(float(rt), float(rj), rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(pt.numpy(), P_TRUE, atol=1e-3)


def test_identify_noise_free_matches_jax(data):
    _, xdata, jxdata = data
    kw = dict(n_params=2, nx=2, p0=[1.0, 1.0], pl=[0.1, 0.0],
              pu=[20.0, 5.0])
    jr = j_identify(_pendulum(jnp), jb.SegmentedBasis(jb.Chebyshev(5), 6),
                    jxdata, None, 0.0, 3.0, **kw)
    tr = identify(_pendulum(torch), tb.SegmentedBasis(tb.Chebyshev(5), 6),
                  xdata, None, 0.0, 3.0, device="cpu", **kw)
    assert int(tr.status) == int(jr.status) == 1
    assert int(tr.iters) == int(jr.iters)
    np.testing.assert_allclose(tr.p.numpy(), np.asarray(jr.p), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(tr.p_init.numpy(), np.asarray(jr.p_init),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(tr.p.numpy(), P_TRUE, atol=1e-3)
    np.testing.assert_allclose(tr.X.numpy(), np.asarray(jr.X), rtol=0,
                               atol=1e-8)


def test_forced_identification_matches_jax():
    """xdot = -p0 x + p1 u(t), u = sin(2t): the input through u_data."""
    from polympc_torch.ocp import rk4_integrate
    p_true = torch.tensor([1.5, 2.0], dtype=torch.float64)

    def dyn(lib):
        return lambda x, u, p, d, t: lib.stack([-p[0] * x[0] + p[1] * u[0]])
    u_t = lambda t: torch.sin(2.0 * torch.as_tensor(
        t, dtype=torch.float64))[None]
    u_j = lambda t: jnp.array([jnp.sin(2.0 * t)])
    xs = rk4_integrate(lambda x, u, t: dyn(torch)(x, u_t(t), p_true, None,
                                                  t),
                       torch.tensor([0.5], dtype=torch.float64), 0.0, 4.0,
                       400).numpy()
    h = 4.0 / 400
    sp_t = fit_cubic_spline(0.0, h, xs[:, 0], device="cpu")
    sp_j = j_fit(0.0, h, xs[:, 0])
    kw = dict(n_params=2, nx=1, nu=0, p0=[1.0, 1.0], pl=[0.01, 0.01],
              pu=[10.0, 10.0])
    jr = j_identify(dyn(jnp), jb.SegmentedBasis(jb.Chebyshev(5), 4),
                    lambda t: jnp.stack([sp_j(t)]), u_j, 0.0, 4.0, **kw)
    tr = identify(dyn(torch), tb.SegmentedBasis(tb.Chebyshev(5), 4),
                  lambda t: torch.stack([sp_t(t)]), u_t, 0.0, 4.0,
                  device="cpu", **kw)
    assert int(tr.status) == int(jr.status) == 1
    np.testing.assert_allclose(tr.p.numpy(), np.asarray(jr.p), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(tr.p.numpy(), p_true.numpy(), atol=2e-3)
