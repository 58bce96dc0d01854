"""Parity of the port's horizon-partitioned SQP
(polympc_torch/parallel/dist_sqp.py, multihost.py) with the JAX package's
(polympc_tpu/parallel/dist_sqp.py, without a mesh), in float64.

  * the duplicated-segment transcription pieces (picks, times, per-segment
    constraints and cost, rollout guess, bounds) and the fused <-> segment
    layout converters;
  * the inner ADMM ``_dist_admm`` on the random segment QP of
    tests/test_dist_sqp.py (copied here), two lanes at once, with adaptive
    rho off and on, and its INFEASIBLE certificate;
  * the batched ``dist_sqp_solve`` on the kite (Chebyshev(3) x 4 segments,
    two lanes from different x0, one reaching SOLVED and one the iteration
    cap) against ``jax.vmap`` of the JAX package's, through both KKT
    routes; per lane: status, iters, qp_iters and qp_status equal, W within
    1e-8, the iteration trace within 1e-8;
  * a problem with a parameter border and a node inequality (np=1, ng=1:
    the parking OCP) over three SQP iterations, per lane;
  * ``dist_refine`` and ``dist_kkt_residual`` per lane on the JAX
    package's own SQP output, within 1e-10 relative;
  * the card harness (polympc_torch/dist_point.py) on the CPU at B=2.
"""
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parity as tp  # noqa: E402
from _torch_parity import single_thread  # noqa: E402,F401
from polympc_tpu.basis import Chebyshev as JChebyshev  # noqa: E402
from polympc_tpu.control.nmpf import augment_ocp as j_augment_ocp  # noqa: E402
from polympc_tpu.models import kite_dynamics as j_kite_dynamics  # noqa: E402
from polympc_tpu.models import kite_output as j_kite_output  # noqa: E402
from polympc_tpu.models import kite_path as j_kite_path  # noqa: E402
from polympc_tpu.models import parking_ocp as j_parking_ocp  # noqa: E402
from polympc_tpu.parallel import dist_sqp as jd  # noqa: E402
from polympc_torch import dist_point  # noqa: E402
from polympc_torch.basis import Chebyshev  # noqa: E402
from polympc_torch.control.nmpf import augment_ocp  # noqa: E402
from polympc_torch.headline import bench_x0s  # noqa: E402
from polympc_torch.models import (  # noqa: E402
    kite_dynamics, kite_output, kite_path)
from polympc_torch.parallel import dist_sqp as td  # noqa: E402
from polympc_torch.parallel.multihost import (  # noqa: E402
    make_batch_dist_solver, pin_segment_head)
from polympc_torch.utils import convert  # noqa: E402
from polympc_torch.utils import status as st  # noqa: E402

KITE_KW = dict(ul=[-5.0, -10.0], uu=[5.0, 10.0], xl=tp.KITE_XL,
               xu=tp.KITE_XU)
KITE_X0S = np.array([[0.6, 0.4, 0.0, 0.0, 0.05],
                     [0.5, -0.3, 0.2, 1.0, 0.05]])
PARK_KW = dict(ul=[-1.5, -0.75], uu=[1.5, 0.75], gl=[-10.0], gu=[1.5],
               pl=[0.0], pu=[10.0])
PARK_X0S = np.array([[1.5, 0.5, 0.5], [1.2, 0.7, 0.3]])
SOL_KEYS = ("W", "P", "lam_loc", "lam_if", "lam_bw", "lam_bp")


def _kite_pair(order, S):
    jocp = j_augment_ocp(lambda x, u: j_kite_dynamics(x, u), j_kite_output,
                         j_kite_path, nx=3, nu=1, ny=2)
    tocp = augment_ocp(lambda x, u: kite_dynamics(x, u), kite_output,
                       kite_path, nx=3, nu=1, ny=2)
    return (jd.dist_transcribe(jocp, JChebyshev(order), S, 0.0, 2.0),
            td.dist_transcribe(tocp, Chebyshev(order), S, 0.0, 2.0))


def _park_pair(S=4):
    return (jd.dist_transcribe(j_parking_ocp(nonlinear_constraint=True),
                               JChebyshev(5), S, 0.0, 1.0),
            td.dist_transcribe(tp.torch_parking_ocp(), Chebyshev(5), S,
                               0.0, 1.0))


def _park_bounds(jdtr, tdtr):
    """The parking bounds of tests/test_dist_sqp.py: a terminal state box
    of +-0.05 makes the minimum time positive."""
    jb = jd.dist_bounds(jdtr, **PARK_KW)
    tb = td.dist_bounds(tdtr, device="cpu", **PARK_KW)
    tail = slice((jdtr.N - 1) * 3, jdtr.N * 3)
    jb = jb._replace(lbw=jb.lbw.at[-1, tail].set(-0.05),
                     ubw=jb.ubw.at[-1, tail].set(0.05))
    tb.lbw[-1, tail] = -0.05
    tb.ubw[-1, tail] = 0.05
    return jb, tb


def _jax_batch(jdtr, jb, settings, x0s, d, P0=None, refine=True):
    """jit(vmap) of multihost.py's solve_one (each lane pins its own x0 and
    starts from its own rollout guess) plus, per lane, dist_refine(iters=2)
    and the KKT residual before and after, on the JAX solution."""
    nx = jdtr.ocp.nx

    def one(x0):
        b = jb._replace(lbw=jb.lbw.at[0, :nx].set(x0),
                        ubw=jb.ubw.at[0, :nx].set(x0))
        W0, P0_ = jdtr.rollout_guess(x0, d=d)
        if P0 is not None:
            P0_ = jnp.full_like(P0_, P0)
        out = jd.dist_sqp_solve(jdtr, b, W0, P0_, d=d, settings=settings)
        if not refine:
            return out, W0
        args = tuple(out[k] for k in SOL_KEYS)
        r0 = jd.dist_kkt_residual(jdtr, b, *args, d=d)
        ref = jd.dist_refine(jdtr, b, *args, d=d, iters=2)
        return out, W0, r0, ref, jd.dist_kkt_residual(jdtr, b, *ref, d=d)

    return jax.jit(jax.vmap(one))(jnp.asarray(x0s))


@pytest.fixture(scope="module")
def kite():
    jdtr, tdtr = _kite_pair(3, 4)
    jset = jd.DistSQPSettings(max_iter=15, admm_iters=200, trace_iters=5)
    jout, jW0, r0, ref, r1 = _jax_batch(jdtr, jd.dist_bounds(jdtr, **KITE_KW),
                                        jset, KITE_X0S, [0.05])
    tb = td.dist_bounds(tdtr, device="cpu", **KITE_KW)
    x0 = torch.tensor(KITE_X0S)
    W0, P0 = tdtr.rollout_guess(x0, d=[0.05])
    port = {}
    for route in ("lu", "kernel"):
        solve = make_batch_dist_solver(
            tdtr, tb, td.DistSQPSettings(max_iter=15, admm_iters=200,
                                         trace_iters=5, kkt_solver=route),
            d=[0.05])
        port[route] = solve(x0, W0, P0)
    return {"jdtr": jdtr, "tdtr": tdtr, "tb": tb, "x0": x0, "W0": W0,
            "jW0": np.asarray(jW0), "jout": jout, "port": port,
            "jr0": np.asarray(r0), "jref": ref, "jr1": np.asarray(r1)}


@pytest.fixture(scope="module")
def parking():
    jdtr, tdtr = _park_pair()
    jb, tb = _park_bounds(jdtr, tdtr)
    jout, _ = _jax_batch(jdtr, jb, jd.DistSQPSettings(max_iter=3), PARK_X0S,
                         [1.0], P0=0.5, refine=False)
    x0 = torch.tensor(PARK_X0S)
    W0, P0 = tdtr.rollout_guess(x0, d=[1.0])
    P0[:, 0] = 0.5
    solve = make_batch_dist_solver(tdtr, tb, td.DistSQPSettings(max_iter=3),
                                   d=[1.0])
    return {"jout": jout, "port": solve(x0, W0, P0)}


# ---------------------------------------------------------------------------
# transcription pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("problem", ["kite", "parking"])
def test_transcription_pieces_match_jax(problem):
    if problem == "kite":
        (jdtr, tdtr), d = _kite_pair(3, 3), [0.05]
    else:
        (jdtr, tdtr), d = _park_pair(3), [1.0]
    for name in ("N", "kz", "me", "mg", "ml", "p_if", "t_scale"):
        assert getattr(tdtr, name) == getattr(jdtr, name), name
    np.testing.assert_allclose(tdtr.times, np.asarray(jdtr.times), rtol=0,
                               atol=1e-15)
    for a, b in zip(tdtr.picks, jdtr.picks):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    S, kz, np_ = tdtr.S, tdtr.kz, tdtr.ocp.np_
    W = rng.normal(size=(2, S, kz)) * 0.3
    P = rng.uniform(0.5, 1.5, size=(2, np_))
    jt = jnp.asarray(jdtr.times)
    is_last = jnp.arange(S) == S - 1
    mask = jnp.where(jnp.arange(S) == 0, 1.0, 0.0)
    jcon = jax.jit(jax.vmap(lambda Wl, Pl: jax.vmap(
        lambda w, t, m: jdtr.seg_con(w, Pl, t, m, jnp.asarray(d)))(
        Wl, jt, mask)))(jnp.asarray(W), jnp.asarray(P))
    jcost = jax.jit(jax.vmap(lambda Wl, Pl: jnp.sum(jax.vmap(
        lambda w, t, il: jdtr.seg_cost(w, Pl, t, il, jnp.asarray(d)))(
        Wl, jt, is_last))))(jnp.asarray(W), jnp.asarray(P))
    td_ = torch.tensor(d, dtype=torch.float64)
    con = td._all_con(tdtr, tp.t64(W), tp.t64(P), td_)
    cost = td._total_cost(tdtr, tp.t64(W), tp.t64(P), td_)
    np.testing.assert_allclose(con.numpy(), np.asarray(jcon), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(cost.numpy(), np.asarray(jcost), rtol=1e-12,
                               atol=1e-12)
    # the derivative blocks against JAX's jacfwd / jacfwd(grad)
    g, c, J = td._dist_parts(tdtr, tp.t64(W), tp.t64(P), td_)
    lam = rng.normal(size=(2, S, tdtr.ml))
    H = td._hess_blocks(tdtr, tp.t64(W), tp.t64(P), tp.t64(lam), td_)

    def jparts(w, Pl, t, il, mh, ll):
        wp = jnp.concatenate([w, Pl])
        cost_ = lambda v: jdtr.seg_cost(v[:kz], v[kz:], t, il,
                                        jnp.asarray(d))
        con_ = lambda v: jdtr.seg_con(v[:kz], v[kz:], t, mh, jnp.asarray(d))
        lagr = lambda v: cost_(v) + con_(v) @ ll
        return (jax.grad(cost_)(wp), jax.jacfwd(con_)(wp),
                jax.jacfwd(jax.grad(lagr))(wp))

    jg, jJ, jH = jax.jit(jax.vmap(lambda Wl, Pl, Ll: jax.vmap(
        lambda w, t, il, mh, ll: jparts(w, Pl, t, il, mh, ll))(
        Wl, jt, is_last, mask, Ll)))(jnp.asarray(W), jnp.asarray(P),
                                     jnp.asarray(lam))
    for got, want in ((g, jg), (J, jJ), (H, jH)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-11, atol=1e-11)
    # start points
    x0 = PARK_X0S[:1] if problem == "parking" else KITE_X0S[:1]
    Wr, Pr = tdtr.rollout_guess(tp.t64(x0), d=d)
    jWr, jPr = jdtr.rollout_guess(jnp.asarray(x0[0]), d=d)
    np.testing.assert_allclose(Wr[0].numpy(), np.asarray(jWr), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(Pr[0].numpy(), np.asarray(jPr), atol=0)
    Wi, Pi = tdtr.initial_guess(tp.t64(x0))
    jWi, jPi = jdtr.initial_guess(jnp.asarray(x0[0]))
    np.testing.assert_array_equal(Wi[0].numpy(), np.asarray(jWi))
    assert Pi.shape == (1, np_)


def test_dist_bounds_match_jax():
    jdtr, tdtr = _park_pair(3)
    kw = dict(PARK_KW, x0=[1.5, 0.5, 0.5], xl=[-9.0, -8.0, -7.0])
    jb = jd.dist_bounds(jdtr, **kw)
    tb = td.dist_bounds(tdtr, device="cpu", **kw)
    for name in td.DistBounds._fields:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    conv = convert.dist_bounds(jb, device="cpu")
    for name in td.DistBounds._fields:
        np.testing.assert_array_equal(getattr(conv, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    pinned = pin_segment_head(tdtr, tb, torch.tensor(PARK_X0S))
    assert pinned.lbw.shape == (2, tdtr.S, tdtr.kz)
    np.testing.assert_array_equal(pinned.lbw[:, 0, :3].numpy(), PARK_X0S)
    np.testing.assert_array_equal(pinned.ubw[:, 0, :3].numpy(), PARK_X0S)
    np.testing.assert_array_equal(pinned.lbw[:, 1:].numpy(),
                                  tb.lbw[None, 1:].expand(2, -1, -1).numpy())


def test_fused_segment_round_trip_matches_jax():
    jdtr, tdtr = _kite_pair(5, 4)
    rng = np.random.default_rng(0)
    Ng = 5 * 4 + 1
    X = rng.normal(size=(2, Ng, 5))
    U = rng.normal(size=(2, Ng, 2))
    W = td.fused_to_segments(tdtr, tp.t64(X), tp.t64(U))
    for i in range(2):
        np.testing.assert_array_equal(
            W[i].numpy(), np.asarray(jd.fused_to_segments(jdtr, X[i], U[i])))
    X2, U2 = td.segments_to_fused(tdtr, W)
    np.testing.assert_allclose(X2.numpy(), X, atol=1e-12)
    np.testing.assert_allclose(U2.numpy(), U, atol=1e-12)
    # averaging of differing duplicates, as in the JAX package
    W = W + tp.t64(rng.normal(size=W.shape)) * 0.1
    X3, U3 = td.segments_to_fused(tdtr, W)
    jX3, jU3 = jd.segments_to_fused(jdtr, jnp.asarray(W[1].numpy()))
    np.testing.assert_allclose(X3[1].numpy(), np.asarray(jX3), atol=1e-14)
    np.testing.assert_allclose(U3[1].numpy(), np.asarray(jU3), atol=1e-14)


def test_settings_match_jax_and_validate():
    import dataclasses
    jf = {f.name: f.default for f in dataclasses.fields(jd.DistSQPSettings)}
    tf = {f.name: f.default for f in dataclasses.fields(td.DistSQPSettings)}
    assert jf == tf
    assert td.DistSQPSettings(kkt_solver="kernel").validate()
    assert not td.DistSQPSettings(kkt_solver="pallas").validate()
    with pytest.raises(ValueError, match="S >= 2"):
        td.dist_transcribe(tp.torch_parking_ocp(), Chebyshev(5), 1, 0.0, 1.0)


# ---------------------------------------------------------------------------
# the inner ADMM on a random segment QP (tests/test_dist_sqp.py:_segment_qp)
# ---------------------------------------------------------------------------

def _segment_qp(seed=0, S=3, kz=6, ml=4, p_if=2, np_=1):
    """A random segment-structured QP (copied from
    tests/test_dist_sqp.py:_segment_qp, without its fused twin)."""
    rng = np.random.default_rng(seed)
    Hs = np.stack([(lambda a: a @ a.T + np.eye(kz))(
        rng.standard_normal((kz, kz))) for _ in range(S)])
    HsP = rng.standard_normal((S, kz, np_)) * 0.3
    HPP = np.eye(np_) * 2.0
    gW = rng.standard_normal((S, kz))
    gP = rng.standard_normal(np_)
    A = rng.standard_normal((S, ml, kz))
    AP = rng.standard_normal((S, ml, np_)) * 0.2
    al = np.tile(np.array([0.0, 0.0, -1.0, -np.inf]), (S, 1))
    au = np.tile(np.array([0.0, 0.0, 1.0, 2.0]), (S, 1))
    lw = np.full((S, kz), -2.0)
    uw = np.full((S, kz), 2.0)
    lp = np.full(np_, -3.0)
    up = np.full(np_, 3.0)
    Epk = np.zeros((p_if, kz))
    Epk[0, kz - 2] = 1
    Epk[1, kz - 1] = 1
    Fpk = np.zeros((p_if, kz))
    Fpk[0, 0] = -1
    Fpk[1, 1] = -1
    r_if = np.zeros((S - 1, p_if))
    dtr = types.SimpleNamespace(S=S, kz=kz, ml=ml, p_if=p_if,
                                picks=(Epk, Fpk),
                                ocp=types.SimpleNamespace(np_=np_))
    return dtr, (Hs, HsP, HPP, gW, gP, A, AP, al, au, lw, uw, lp, up, r_if)


def _admm_both(adaptive, infeasible=False):
    """Two lanes (seeds 0 and 1): the port's batched _dist_admm and the JAX
    package's, lane by lane."""
    lanes = [_segment_qp(seed) for seed in (0, 1)]
    dtr = lanes[0][0]
    S, kz, ml, p_if, np_ = dtr.S, dtr.kz, dtr.ml, dtr.p_if, dtr.ocp.np_
    args = [list(a) for _, a in lanes]
    if infeasible:
        # local row 2 of every segment must equal 100 with w in [-2, 2]
        for a in args:
            a[7] = a[7].copy()
            a[8] = a[8].copy()
            a[7][:, 2] = 100.0
            a[8][:, 2] = 100.0
    kw = dict(admm_iters=2000, check_every=25, eps_abs=1e-6, eps_rel=1e-6,
              adaptive_rho=adaptive, rho=0.1)
    jouts = [jd._dist_admm(
        dtr, *(jnp.asarray(v) for v in a), jnp.zeros((S, ml)),
        jnp.zeros((S - 1, p_if)), jnp.zeros((S, kz)), jnp.zeros(np_),
        jd.DistSQPSettings(**kw), None, "seg") for a in args]
    stacked = [tp.t64(np.stack([a[i] for a in args])) for i in range(14)]
    z = lambda *shape: torch.zeros((2, *shape), dtype=torch.float64)
    tout = td._dist_admm(dtr, *stacked, z(S, ml), z(S - 1, p_if), z(S, kz),
                         z(np_), td.DistSQPSettings(**kw))
    return jouts, tout


@pytest.mark.parametrize("adaptive", [False, True])
def test_dist_admm_matches_jax(adaptive):
    jouts, tout = _admm_both(adaptive)
    for i, jo in enumerate(jouts):
        assert int(tout[7][i]) == int(jo[7]) == st.SOLVED
        assert int(tout[6][i]) == int(jo[6]) < 2000
        for got, want in zip(tout[:6], jo[:6]):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                       rtol=1e-8, atol=1e-8)
        for got, want in zip(tout[8:], jo[8:]):
            np.testing.assert_allclose(float(got[i]), float(want),
                                       rtol=1e-6, atol=1e-12)


def test_dist_admm_infeasibility_certificate():
    jouts, tout = _admm_both(False, infeasible=True)
    for i, jo in enumerate(jouts):
        assert int(jo[7]) == st.INFEASIBLE
        assert int(tout[7][i]) == st.INFEASIBLE
        assert int(tout[6][i]) == int(jo[6])


# ---------------------------------------------------------------------------
# the batched SQP
# ---------------------------------------------------------------------------

def _compare_lanes(port, jout, w_tol):
    for k in ("status", "iters", "qp_iters", "qp_status"):
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    np.testing.assert_allclose(port["W"].numpy(), np.asarray(jout["W"]),
                               rtol=0, atol=w_tol)
    np.testing.assert_allclose(port["P"].numpy(), np.asarray(jout["P"]),
                               rtol=0, atol=w_tol)


@pytest.mark.parametrize("route", ["lu", "kernel"])
def test_batched_kite_matches_vmap(kite, route):
    port, jout = kite["port"][route], kite["jout"]
    np.testing.assert_allclose(kite["W0"].numpy(), kite["jW0"], rtol=1e-12,
                               atol=1e-12)
    # one lane converges, the other runs into the iteration cap
    assert sorted(np.asarray(jout["status"]).tolist()) == [
        st.SOLVED, st.MAX_ITER_EXCEEDED]
    _compare_lanes(port, jout, 1e-8)
    for k in ("lam_loc", "lam_if", "lam_bw", "violation", "primal_step",
              "cost"):
        np.testing.assert_allclose(port[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-6, atol=1e-8, err_msg=k)
    np.testing.assert_allclose(port["trace"].numpy(),
                               np.asarray(jout["trace"]), rtol=1e-8,
                               atol=1e-8, equal_nan=True)


def test_bordered_parking_matches_vmap(parking):
    """np=1 (a parameter border through the Schur condensation) and ng=1.
    The inner QPs stop at their 200-iteration cap on this KKT (equality
    rows at rho*1e3), whose rounding the ADMM carries through 200
    iterations: W and P agree to 1e-7, the counts exactly."""
    port, jout = parking["port"], parking["jout"]
    assert port["P"].shape == (2, 1)
    assert (port["P"] > 0.5).all()
    _compare_lanes(port, jout, 1e-7)
    np.testing.assert_allclose(port["lam_bp"].numpy(),
                               np.asarray(jout["lam_bp"]), rtol=1e-6,
                               atol=1e-7)


def test_refine_and_residual_match_jax(kite):
    """dist_refine(iters=2) then dist_kkt_residual on the JAX package's own
    SQP output (carried over with convert.dist_solution), per lane."""
    tdtr = kite["tdtr"]
    sol = convert.dist_solution(kite["jout"], device="cpu")
    assert sol["status"].dtype == torch.int32
    b = pin_segment_head(tdtr, kite["tb"], kite["x0"])
    args = [sol[k] for k in SOL_KEYS]
    r0 = td.dist_kkt_residual(tdtr, b, *args, d=[0.05])
    np.testing.assert_allclose(r0.numpy(), kite["jr0"], rtol=1e-10)
    ref = td.dist_refine(tdtr, b, *args, d=[0.05], iters=2)
    for got, want, name in zip(ref, kite["jref"], SOL_KEYS):
        want = np.asarray(want)
        scale = np.abs(want).max(initial=1.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-10 * scale, err_msg=name)
    r1 = td.dist_kkt_residual(tdtr, b, *ref, d=[0.05])
    np.testing.assert_allclose(r1.numpy(), kite["jr1"], rtol=1e-6,
                               atol=1e-14)
    assert (r1.numpy() <= r0.numpy()).all()
    assert (r1.numpy() <= 1e-6).all()      # both lanes certify


def test_dist_point_harness_on_cpu():
    """The card harness's timed unit end to end on the CPU at B=2, cut to
    three SQP iterations: the record's lanes (both KKT routes) are bench's
    draw at B=128, and every lane comes back with its fp64 certificate."""
    rec = np.load(os.path.join(os.path.dirname(__file__), "data",
                               "dist_kite_s8_jax_cpu.npz"))
    np.testing.assert_array_equal(bench_x0s(128), rec["x0s"])
    for pre in ("", "pallas_"):      # the record of each KKT route
        assert rec[pre + "certified"].shape == (128,)
        assert np.isfinite(rec[pre + "residual"]).all()
    out, res, solve_s, cert_s = dist_point.batch_fn(
        2, "cpu", rec["x0s"][:2], max_iter=3)()
    assert solve_s > 0 and cert_s > 0
    extra, lanes = dist_point.summarize(out, res)
    assert extra["batch"] == 2
    assert lanes["residual"].shape == (2,)
    assert np.isfinite(lanes["residual"]).all()
    assert (lanes["iters"] <= 3).all()
    assert extra["certified"] == int(lanes["certified"].sum())
