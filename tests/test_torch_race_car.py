"""Parity of the port's race-car models (polympc_torch.models.race_car) with
the JAX package's, in float64 on the CPU:

  * the tyre, body, Cartesian, curvilinear and rate-augmented dynamics at
    random states (negative track coordinates included), to 1e-12;
  * the transcribed NLP (the headline harness's Chebyshev(5) x 2 mesh and
    scaling) of the plain and the rate-augmented OCP: constraints, cost
    and the structured derivatives at random points, to 1e-10;
  * a B=2 race-car SQP from the constant guess at a small ``max_iter``,
    both sides through the LU epoch: per-lane status, SQP iterations and
    inner QP iterations equal, x to 1e-6 (the JAX side's interpret-mode
    BBT kernel would triple the compile; the kite's SQP holds that kernel
    path against JAX in tests/test_torch_sqp.py);
  * the port's BBT epoch at the race car's structure (S=2 blocks of k=96,
    K=165) against its LU epoch on the first QP of that SQP, to 1e-9.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parity as tp  # noqa: E402
from _torch_parity import single_thread  # noqa: E402,F401
from polympc_tpu.basis import Chebyshev as JChebyshev  # noqa: E402
from polympc_tpu.basis import SegmentedBasis as JSegmentedBasis  # noqa: E402
from polympc_tpu.models import race_car as jrc  # noqa: E402
from polympc_tpu.nlp.sqp import sqp_solve as j_sqp  # noqa: E402
from polympc_tpu.ocp import ocp_bounds as j_ocp_bounds  # noqa: E402
from polympc_tpu.ocp import transcribe as j_transcribe  # noqa: E402
from polympc_torch import headline_table as ht  # noqa: E402
from polympc_torch.basis import Chebyshev, SegmentedBasis  # noqa: E402
from polympc_torch.models import race_car as trc  # noqa: E402
from polympc_torch.ocp import transcribe  # noqa: E402
from polympc_torch.parallel import make_batch_solver  # noqa: E402
from polympc_torch.utils import convert  # noqa: E402
from polympc_torch.utils import status as st  # noqa: E402

P = jrc.CarParams()
TP = trc.CarParams()
XS = [10.0, 1.0, 1.0, 30.0, 1.0, 1.0]
US = [0.4, 1e4, 1e4]


@pytest.fixture(scope="module")
def tracks():
    return jrc.make_wave_track(), trc.make_wave_track(device="cpu")


def _states(B, seed, nx=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, nx)) * np.array(
        [3.0, 0.5, 0.3, 60.0, 0.5, 0.2, 0.1, 0.1, 500.0, 500.0][:nx])
    x[:, 0] += 12.0
    u = rng.normal(size=(B, 3)) * np.array([0.1, 400.0, 400.0])
    return x, u


def _close(got, want, tol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def test_tyre_and_body_match_jax():
    x, u = _states(16, 1)
    t = torch.as_tensor
    want = jax.vmap(lambda a, b: jrc.lateral_forces(P, a[0], a[1], a[2],
                                                    b[0]))(x, u)
    got = trc.lateral_forces(TP, *(t(x[:, i]) for i in range(3)), t(u[:, 0]))
    for g, w in zip(got, want):
        _close(g, w)
    want = jax.vmap(lambda a, b: jrc.car_body_accels(
        P, a[0], a[1], a[2], b[0], b[1], b[2]))(x, u)
    got = trc.car_body_accels(TP, *(t(x[:, i]) for i in range(3)),
                              *(t(u[:, i]) for i in range(3)))
    for g, w in zip(got, want):
        _close(g, w)
    _close(trc.pacejka_lateral_force(3e3, t(u[:, 0]), 10.0, 1.9, 1.0, 0.97),
           jrc.pacejka_lateral_force(3e3, u[:, 0], 10.0, 1.9, 1.0, 0.97))


def test_dynamics_match_jax(tracks):
    jk, tk = tracks
    x, u = _states(16, 2)
    x10, _ = _states(16, 3, nx=10)
    x10[:, 3] -= 150.0            # behind the start line: s < 0
    t = torch.as_tensor
    _close(trc.car_dynamics_cartesian(t(x), t(u), TP),
           jax.vmap(lambda a, b: jrc.car_dynamics_cartesian(a, b, P))(x, u))
    _close(trc.car_dynamics_curvilinear(t(x), t(u), tk, TP),
           jax.vmap(lambda a, b: jrc.car_dynamics_curvilinear(
               a, b, jk, P))(x, u))
    _close(trc.car_dynamics_rate_augmented(t(x10), t(u), tk, TP, Td=0.05),
           jax.vmap(lambda a, b: jrc.car_dynamics_rate_augmented(
               a, b, jk, P, Td=0.05))(x10, u))


@pytest.mark.parametrize("augmented", [False, True],
                         ids=["plain", "rate-augmented"])
def test_transcription_derivatives_match_jax(tracks, augmented):
    jk, tk = tracks
    nx = 10 if augmented else 6
    xs = XS + [1.0] * (nx - 6)
    jtr = j_transcribe(jrc.race_car_ocp(jk, rate_augmented=augmented),
                       JSegmentedBasis(JChebyshev(5), 2), x_scale=xs,
                       u_scale=US)
    ttr = transcribe(trc.race_car_ocp(tk, rate_augmented=augmented),
                     SegmentedBasis(Chebyshev(5), 2), x_scale=xs, u_scale=US)
    assert (ttr.nlp.n, ttr.nlp.m) == (jtr.nlp.n, jtr.nlp.m)
    rng = np.random.default_rng(7 + nx)
    z = rng.normal(size=(2, jtr.nlp.n)) * 0.3
    z[:, 0:11 * nx:nx] += 1.2                   # vx around 12 m/s
    z[:, 3:11 * nx:nx] -= 3.0                    # s around -90 m
    lam = rng.normal(size=(2, jtr.nlp.m))
    jprm = jtr.params(d=[15.0], t0=0.0, tf=2.0)
    tprm = convert.params({k: np.asarray(v) for k, v in jprm.items()},
                          device="cpu")
    tz, tl = torch.as_tensor(z), torch.as_tensor(lam)
    jz, jl = jnp.asarray(z), jnp.asarray(lam)
    nlp, jnlp = ttr.nlp, jtr.nlp
    jv = lambda f, *a: jax.jit(jax.vmap(f, (0,) * len(a) + (None,)))(
        *a, jprm)
    for got, want in (
            (nlp.eq(tz, tprm), jv(jnlp.eq, jz)),
            (nlp.cost(tz, tprm), jv(jnlp.cost, jz)),
            (nlp.cost_grad(tz, tprm), jv(jax.grad(jnlp.cost), jz)),
            (nlp.eq_jac(tz, tprm), jv(jnlp.eq_jac, jz)),
            (nlp.lag_hessian(tz, tl, tprm), jv(jnlp.lag_hessian, jz, jl))):
        scale = max(1.0, float(np.abs(np.asarray(want)).max()))
        _close(got / scale, np.asarray(want) / scale, tol=1e-10)


@pytest.fixture(scope="module")
def sqp_pair(tracks):
    """The harness's problem and SQP settings at max_iter=6 with the LU
    epoch, two initial states, from the constant guess, in float64 on both
    sides."""
    jk, _ = tracks
    ttr, tb, tprm, cold, _ = ht.race_car_problem("cpu", torch.float64)
    tset = dataclasses.replace(cold, max_iter=6, qp=dataclasses.replace(
        cold.qp, kkt_solver="lu", structure=None))
    x0s = ht.RACE_X0[None].astype(np.float64) + np.array(
        [[0.0] * 6, [0.3, 0.01, 0.0, 0.5, -0.03, 0.01]])
    # each lane starts from the constant guess at its own initial state, as
    # the JAX side below does
    z0 = torch.stack([ttr.initial_guess(x, device="cpu") for x in x0s])
    with tp.one_thread():
        tsol = make_batch_solver(ttr, tb, tprm, tset)(torch.as_tensor(x0s),
                                                      z0)

    jtr = j_transcribe(jrc.race_car_ocp(jk), JSegmentedBasis(JChebyshev(5), 2),
                       x_scale=XS, u_scale=US)
    jb = j_ocp_bounds(jtr, ul=[-0.4, -2e4, -2e4], uu=[0.4, 2e4, 2e4],
                      xl=[1.0, -5.0, -3.0, -1e3, -2.0, -1.0],
                      xu=[40.0, 5.0, 3.0, 1e3, 2.0, 1.0])
    jprm = jtr.params(d=[15.0], t0=0.0, tf=2.0)
    from polympc_tpu.nlp.types import SQPSettings as JSQP
    from polympc_tpu.qp.types import ADMMSettings as JADMM
    q = tset.qp
    jset = JSQP(hessian="exact", max_iter=6, reg="mirror", eps_prim=1e-3,
                eps_dual=1e-3, eps_viol=1e-3, eps_stat=1e-2,
                qp=JADMM(rho=q.rho, eps_abs=q.eps_abs, eps_rel=q.eps_rel,
                         max_epochs=q.max_epochs, check_every=q.check_every,
                         polish=False, kkt_solver="lu"))
    sx = np.asarray(jtr.x_scale)

    def one(x0):
        b = jb._replace(lbx=jb.lbx.at[:6].set(x0 / sx),
                        ubx=jb.ubx.at[:6].set(x0 / sx))
        return j_sqp(jtr.nlp, jtr.initial_guess(x0), p=jprm, bounds=b,
                     settings=jset)

    jsol = jax.jit(jax.vmap(one))(jnp.asarray(x0s))
    return jsol, tsol


def test_race_car_sqp_matches_jax(sqp_pair):
    jsol, tsol = sqp_pair
    for f in ("status", "iters", "qp_iters"):
        np.testing.assert_array_equal(getattr(tsol, f).numpy(),
                                      np.asarray(getattr(jsol, f)),
                                      err_msg=f)
    assert set(tsol.status.tolist()) <= {st.SOLVED, st.MAX_ITER_EXCEEDED}
    for f in ("x", "lam", "lam_box"):
        np.testing.assert_allclose(getattr(tsol, f).numpy(),
                                   np.asarray(getattr(jsol, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


def test_bbt_epoch_at_race_car_structure_matches_lu_epoch():
    """One epoch of the race car's first QP through the BBT epoch (its
    plain version on the CPU) and through the LU epoch, in float64."""
    from polympc_torch.nlp.hessian import regularize
    from polympc_torch.parallel import pin_initial_state
    from polympc_torch.qp import box_admm as tbox
    from polympc_torch.qp.types import QPData
    tr, b, prm, cold, _ = ht.race_car_problem("cpu", torch.float64)
    stc = cold.qp.structure
    assert (stc.S, stc.k, stc.K) == (2, 96, 165)
    x0s = torch.as_tensor(ht.race_car_x0s(3), dtype=torch.float64)
    bnd, x0sc = pin_initial_state(tr, b, x0s)
    z = tr.initial_guess(ht.RACE_X0, device="cpu")[None].repeat(3, 1)
    z[:, :6] = x0sc
    lam = torch.zeros((3, tr.nlp.m), dtype=torch.float64)
    nlp = tr.nlp
    c = nlp.eq(z, prm)
    qp = QPData(H=regularize(nlp.lag_hessian(z, lam, prm), "mirror", 1e-6),
                h=nlp.cost_grad(z, prm), A=nlp.eq_jac(z, prm), al=-c, au=-c,
                xl=bnd.lbx - z, xu=bnd.ubx - z)
    rho, rb = tbox.penalties(torch.full((3,), 1.0, dtype=torch.float64), qp,
                             cold.qp)
    kkt = tbox._build_kkt(qp, rho, rb, cold.qp.sigma)
    state = (torch.zeros_like(z), torch.zeros_like(c), torch.zeros_like(z),
             lam, torch.zeros_like(z))
    got = tbox._epoch(kkt, qp, rho, rb, state, cold.qp)
    with tp.one_thread():
        want = tbox._dense_epoch(kkt, qp, rho, rb, state, cold.qp)
    for g, w in zip(got, want):
        scale = max(1.0, w.abs().max().item())
        torch.testing.assert_close(g / scale, w / scale, rtol=1e-9,
                                   atol=1e-9)
