"""Radau and Gauss meshes in the port's transcription, against the JAX
package in float64: a Radau transcription's defects with their continuity
rows, the equality Jacobian, the Lagrangian Hessian (with the Mayer term at
the interpolated endpoint) and the node inequalities to 1e-12; the stiff
OCP of tests/test_schemes.py solved on Radau(3) x 4 and Lobatto(3) x 4 with
the same status and iterations and the cost within 1e-9 relative, Radau
closer to the fine-mesh oracle; a Gauss mesh refused; and
``bbt_structure`` None wherever the JAX package's is (Radau, hooks, soft
defects).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parity as tp  # noqa: E402
from _torch_parity import single_thread  # noqa: E402,F401
from polympc_tpu import basis as jb  # noqa: E402
from polympc_tpu.models import parking_ocp as j_parking_ocp  # noqa: E402
from polympc_tpu.models import robot_ocp as j_robot_ocp  # noqa: E402
from polympc_tpu.nlp import SQPSettings as JSQPSettings  # noqa: E402
from polympc_tpu.nlp import sqp_solve as j_sqp_solve  # noqa: E402
from polympc_tpu.ocp import OCP as JOCP  # noqa: E402
from polympc_tpu.ocp import ocp_bounds as j_ocp_bounds  # noqa: E402
from polympc_tpu.ocp import transcribe as j_transcribe  # noqa: E402
from polympc_tpu.qp.types import ADMMSettings as JADMMSettings  # noqa: E402
from polympc_torch import basis as tb  # noqa: E402
from polympc_torch.models import robot_ocp  # noqa: E402
from polympc_torch.nlp import SQPSettings, sqp_solve  # noqa: E402
from polympc_torch.ocp import OCP, ocp_bounds, transcribe  # noqa: E402
from polympc_torch.qp.types import ADMMSettings  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-12)


def _cases():
    return {
        "robot_radau": (j_transcribe(j_robot_ocp(), jb.SegmentedBasis(
            jb.LegendreRadau(3), 3)), transcribe(robot_ocp(),
                                                 tb.SegmentedBasis(
                                                     tb.LegendreRadau(3), 3)),
            {"p": [], "d": [2.0], "t0": 0.0, "tf": 2.0}),
        "parking_radau": (j_transcribe(j_parking_ocp(True), jb.SegmentedBasis(
            jb.LegendreRadau(4), 2)), transcribe(tp.torch_parking_ocp(),
                                                 tb.SegmentedBasis(
                                                     tb.LegendreRadau(4), 2)),
            {"p": [1.3], "d": [2.0], "t0": 0.0, "tf": 1.0}),
    }


@pytest.mark.parametrize("name", ["robot_radau", "parking_radau"])
def test_radau_transcription_matches_jax(name):
    jtr, ttr, prm = _cases()[name]
    nlp, tn = jtr.nlp, ttr.nlp
    N, S, nx = ttr.N, ttr.mesh.num_segments, ttr.ocp.nx
    assert (tn.n, tn.ne, tn.ni) == (nlp.n, nlp.ne, nlp.ni)
    assert tn.ne == N * nx + (S - 1) * nx
    jp = {k: jnp.asarray(v, jnp.float64) for k, v in prm.items()}
    tpr = {k: torch.tensor(np.asarray(v, np.float64)) for k, v in prm.items()}
    z, lam = tp.lane_points(jtr, 3, seed=5)
    zj, lj, zt, lt = jnp.asarray(z), jnp.asarray(lam), torch.tensor(z), \
        torch.tensor(lam)
    vm = lambda f: jax.vmap(f, (0, None))(zj, jp)
    np.testing.assert_allclose(tn.eq(zt, tpr).numpy(), vm(nlp.eq), **TOL)
    np.testing.assert_allclose(tn.eq_jac(zt, tpr).numpy(), vm(nlp.eq_jac),
                               **TOL)
    np.testing.assert_allclose(tn.cost(zt, tpr).numpy(), vm(nlp.cost),
                               **TOL)
    np.testing.assert_allclose(
        tn.lag_hessian(zt, lt, tpr).numpy(),
        jax.vmap(nlp.lag_hessian, (0, 0, None))(zj, lj, jp), **TOL)
    if nlp.ineq is not None:
        np.testing.assert_allclose(tn.ineq(zt, tpr).numpy(),
                                   vm(nlp.ineq), **TOL)
        np.testing.assert_allclose(tn.ineq_jac(zt, tpr).numpy(),
                                   vm(nlp.ineq_jac), **TOL)
    # the Hessian stays block-diagonal (+ the Mayer coupling of the last
    # segment's nodes, + the parameter arrow): the continuity rows are
    # linear and add nothing
    H = tn.lag_hessian(zt, lt, tpr)[0].numpy()
    keep = torch.ones(tn.m, dtype=torch.float64)
    keep[N * nx:tn.ne] = 0.0
    Hc = tn.lag_hessian(zt, lt * keep, tpr)[0].numpy()
    np.testing.assert_allclose(H, Hc, **TOL)


def _stiff(lib_ocp, lib):
    """tests/test_schemes.py's stiff actuator tracking OCP in one package."""
    lam = -50.0
    return lib_ocp(dynamics=lambda x, u, p, d, t: lib.stack(
        [lam * (x[0] - u[0])]), nx=1, nu=1,
        lagrange=lambda x, u, p, d, t: (x[0] - 1.0) ** 2 + 0.1 * u[0] ** 2)


def _stiff_pair(name):
    jbasis, tbasis = {"lobatto": (jb.Legendre(3), tb.Legendre(3)),
                      "radau": (jb.LegendreRadau(3),
                                tb.LegendreRadau(3))}[name]
    qp = dict(eps_abs=1e-9, eps_rel=1e-9, max_epochs=80)
    jtr = j_transcribe(_stiff(JOCP, jnp), jb.SegmentedBasis(jbasis, 4))
    js = j_sqp_solve(jtr.nlp, jtr.initial_guess([0.0]),
                     p=jtr.params(t0=0.0, tf=1.0),
                     bounds=j_ocp_bounds(jtr, x0=[0.0]),
                     settings=JSQPSettings(hessian="exact", max_iter=60,
                                           qp=JADMMSettings(**qp)))
    ttr = transcribe(_stiff(OCP, torch), tb.SegmentedBasis(tbasis, 4))
    ts = sqp_solve(ttr.nlp, ttr.initial_guess([0.0], device="cpu")[None],
                   p=ttr.params(t0=0.0, tf=1.0, device="cpu"),
                   bounds=ocp_bounds(ttr, x0=[0.0], device="cpu"),
                   settings=SQPSettings(hessian="exact", max_iter=60,
                                        qp=ADMMSettings(**qp)))
    return ttr, js, ts


def test_stiff_ocp_radau_beats_lobatto_as_in_jax():
    from polympc_torch.ocp_extras_point import _stiff_solve
    oracle, Xo = _stiff_solve(tb.Legendre(8), 16, "cpu")
    tq = np.linspace(0.0, 1.0, 101)
    errs = {}
    for name in ("lobatto", "radau"):
        ttr, js, ts = _stiff_pair(name)
        assert int(ts.status[0]) == int(js.status) == 1
        assert int(ts.iters[0]) == int(js.iters)
        np.testing.assert_allclose(float(ts.cost[0]), float(js.cost),
                                   rtol=1e-9)
        X = ttr.mesh.interp_matrix(tq, 0.0, 1.0) @ ts.x[0, :ttr.N].numpy()
        errs[name] = (np.abs(X - Xo).max(),
                      abs(float(ts.cost[0]) - oracle["cost"]))
    assert errs["radau"][0] < errs["lobatto"][0]
    assert errs["radau"][1] < errs["lobatto"][1]


def test_gauss_transcription_rejected():
    ocp = OCP(dynamics=lambda x, u, p, d, t: u, nx=1, nu=1,
              lagrange=lambda x, u, p, d, t: x @ x)
    with pytest.raises(NotImplementedError):
        transcribe(ocp, tb.SegmentedBasis(tb.LegendreGauss(4), 1))


def test_terminal_pin_refused_without_tf_node():
    ttr = transcribe(robot_ocp(), tb.SegmentedBasis(tb.LegendreRadau(3), 2))
    with pytest.raises(ValueError):
        ocp_bounds(ttr, xf=[0.0, 0.0, 0.0], device="cpu")


def test_bbt_structure_none_where_jax_is():
    """None for a Radau mesh, for trajectory hooks and for soft defects, in
    both packages; a structure for the plain Lobatto transcription."""
    rate = lambda X, U, P, d, t, ops: (ops.D @ U).reshape(-1)
    jm = lambda: jb.SegmentedBasis(jb.Chebyshev(5), 2)
    tm = lambda: tb.SegmentedBasis(tb.Chebyshev(5), 2)
    pairs = {
        "lobatto": (j_transcribe(j_robot_ocp(), jm()),
                    transcribe(robot_ocp(), tm())),
        "radau": (j_transcribe(j_robot_ocp(), jb.SegmentedBasis(
            jb.LegendreRadau(3), 2)), transcribe(robot_ocp(),
                                                 tb.SegmentedBasis(
                                                     tb.LegendreRadau(3), 2))),
        "hooks": (j_transcribe(dataclasses.replace(
            j_robot_ocp(), trajectory_ineq=rate, ntg=22), jm()),
            transcribe(dataclasses.replace(
                robot_ocp(), trajectory_ineq=rate, ntg=22), tm())),
        "soft": (j_transcribe(j_robot_ocp(), jm(), soft_defects=1e4),
                 transcribe(robot_ocp(), tm(), soft_defects=1e4)),
    }
    for name, (jtr, ttr) in pairs.items():
        js, ts = jtr.bbt_structure(), ttr.bbt_structure()
        assert (js is None) == (ts is None), name
        assert (ts is None) == (name != "lobatto"), name
