"""Parity of the port's KKT certification and Newton-KKT refinement
(polympc_torch.nlp.refine, polympc_torch.headline.certify) with the JAX
package's, on the kite at B=4.

Both sides refine the same float32 points (the port's fp32 SQP solutions,
handed to both as numpy), so the comparison never mixes candidate sets.
With a float64 linear solve the refined points agree to 1e-8; with the
float32 LDL^T solve (the certify pass's) the two sum in different orders,
so the certified residuals must agree within 10x or both be below 1e-9,
and the certified masks must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parity as tp  # noqa: E402
from polympc_tpu.nlp.refine import kkt_residual as j_kkt_residual  # noqa
from polympc_tpu.nlp.refine import refine_solution as j_refine  # noqa: E402
from polympc_torch import headline  # noqa: E402
from polympc_torch.nlp.refine import kkt_residual, refine_solution  # noqa
from polympc_torch.parallel import make_batch_solver  # noqa: E402
from polympc_torch.parallel import pin_initial_state  # noqa: E402
from polympc_torch.utils import convert  # noqa: E402

B = 4


def _residuals_agree(got, want):
    got, want = np.asarray(got), np.asarray(want)
    both_tiny = (got < 1e-9) & (want < 1e-9)
    ratio = np.maximum(got, 1e-300) / np.maximum(want, 1e-300)
    assert np.all(both_tiny | ((ratio <= 10.0) & (ratio >= 0.1))), (got,
                                                                   want)


@pytest.fixture(scope="module")
def points():
    """fp32 SQP solutions of bench's first B lanes, and the JAX side's
    per-lane refine closure."""
    ttr, tb, tprm, tset = tp.torch_kite(torch.float32)
    x0s = headline.bench_x0s(512)[:B]
    sol = make_batch_solver(ttr, tb, tprm, tset, rollout_guess=True)(
        torch.as_tensor(x0s))
    pts = {k: getattr(sol, k).numpy() for k in ("x", "lam", "lam_box")}

    jtr, jb, _, _ = tp.jax_kite()
    jprm = jtr.params(d=[0.05], t0=0.0, tf=2.0, dtype=jnp.float64)
    sx = jnp.asarray(jtr.x_scale)
    nx = jtr.ocp.nx

    def j_one(x0, z, lam, lam_box, **kw):
        x0s_ = jnp.asarray(x0, jnp.float64) / sx
        b = jb._replace(lbx=jb.lbx.at[:nx].set(x0s_),
                        ubx=jb.ubx.at[:nx].set(x0s_))
        return j_refine(jtr.nlp, z, lam, lam_box, b, jprm,
                        return_residual=True, **kw)

    return {"x0s": x0s, "pts": pts, "j_one": j_one, "jtr": jtr,
            "jprm": jprm}


def _torch_bounds(x0s):
    ttr, tb, _, _ = tp.torch_kite()
    bnd, _ = pin_initial_state(ttr, tb, tp.t64(x0s))
    return ttr, bnd, ttr.params(d=[0.05], t0=0.0, tf=2.0)


@pytest.mark.parametrize("solve_dtype", ["float64", "float32"])
def test_refine_solution_matches_jax(points, solve_dtype):
    """float64 solves: two Newton steps agree point by point.  float32
    solves: six steps.  After two, lane 1 of bench's batch still differs:
    its first Newton matrix grows factor elements of 3.6e3 over pivots of
    2e-4, so each side's float32 step has a relative residual of 1e-2 to
    5e-2 and the two paths part (residual 4.9e-3 in the JAX package, 7.4e-8
    in the port after two steps); both reach 1e-9 within five."""
    sd = {"float64": None, "float32": "float32"}[solve_dtype]
    iters = 2 if sd is None else 6
    kw = dict(iters=iters, return_last=True)
    if sd:
        kw.update(solve_dtype=jnp.float32, matrix_dtype=jnp.float32)
    p = points["pts"]
    want = jax.vmap(lambda a, b, c, d: points["j_one"](a, b, c, d, **kw))(
        *(jnp.asarray(v) for v in (points["x0s"], p["x"], p["lam"],
                                   p["lam_box"])))
    ttr, bnd, prm = _torch_bounds(points["x0s"])
    tkw = dict(iters=iters, return_last=True, return_residual=True)
    if sd:
        tkw.update(solve_dtype=torch.float32, matrix_dtype=torch.float32)
    got = refine_solution(ttr.nlp, *(torch.as_tensor(p[k]) for k in
                                     ("x", "lam", "lam_box")), bnd, prm,
                          **tkw)
    assert len(got) == len(want) == 7
    _residuals_agree(got[3].numpy(), want[3])
    np.testing.assert_array_equal(got[3].numpy() <= headline.KKT_TOL,
                                  np.asarray(want[3]) <= headline.KKT_TOL)
    if sd is None:
        for g, w in zip(got[:3] + got[4:], want[:3] + want[4:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8,
                                       atol=1e-8)
    else:
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_three_stage_certify_matches_jax(points):
    p = points["pts"]
    one = points["j_one"]
    kw32 = dict(solve_dtype=jnp.float32, matrix_dtype=jnp.float32)

    @jax.jit
    def j_certify(x0s, sx, sl, sb):
        o = jax.vmap(lambda a, b, c, d: one(a, b, c, d, iters=2,
                                            return_last=True, **kw32))(
            x0s, sx, sl, sb)
        r1, zl, laml, lambl = o[3], o[4], o[5], o[6]
        _, i2 = jax.lax.top_k(r1, min(64, B))
        o2 = jax.vmap(lambda a, b, c, d: one(a, b, c, d, iters=2, **kw32))(
            x0s[i2], zl[i2], laml[i2], lambl[i2])
        r = r1.at[i2].set(jnp.minimum(r1[i2], o2[3]))
        _, i3 = jax.lax.top_k(r, min(16, B))
        o3 = jax.vmap(lambda a, b, c, d: one(
            a, b, c, d, iters=10, act_tol=1e-4, solve_ir=6, **kw32))(
            x0s[i3], sx[i3], sl[i3], sb[i3])
        return r.at[i3].set(jnp.minimum(r[i3], o3[3]))

    want = np.asarray(j_certify(*(jnp.asarray(v) for v in (
        points["x0s"], p["x"], p["lam"], p["lam_box"]))))
    ttr, tb, _, _ = tp.torch_kite()
    sols = convert.sqp_solution(_Sol(p))
    got = headline.certify(ttr, torch.as_tensor(points["x0s"]), sols, tb,
                           ttr.params(d=[0.05], t0=0.0, tf=2.0)).numpy()
    _residuals_agree(got, want)
    np.testing.assert_array_equal(got <= headline.KKT_TOL,
                                  want <= headline.KKT_TOL)


class _Sol:
    """A stand-in batched SQP solution carrying only the refined fields."""

    def __init__(self, p):
        self.x, self.lam, self.lam_box = p["x"], p["lam"], p["lam_box"]
        n = p["x"].shape[0]
        self.status = self.iters = self.qp_iters = np.zeros(n, np.int32)
        self.cost = self.primal_step = self.dual_step = \
            self.violation = np.zeros(n)


def test_kkt_residual_matches_jax(points):
    jtr, jprm = points["jtr"], points["jprm"]
    z, lam = tp.lane_points(jtr, B, seed=31, scale=0.2)
    lam_box = np.random.default_rng(32).normal(size=z.shape)
    jb = tp.jax_kite()[1]
    want = jax.vmap(lambda a, b, c: j_kkt_residual(jtr.nlp, a, b, c, jb,
                                                   jprm))(
        jnp.asarray(z), jnp.asarray(lam), jnp.asarray(lam_box))
    ttr, tb, _, _ = tp.torch_kite()
    got = kkt_residual(ttr.nlp, tp.t64(z), tp.t64(lam), tp.t64(lam_box), tb,
                       ttr.params(d=[0.05], t0=0.0, tf=2.0))
    for f in got._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-10,
                                   err_msg=f)
