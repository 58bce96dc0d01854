"""Parity of the port's dense boxADMM epoch, LDL^T factor, Ruiz
equilibration and equilibrated boxADMM solve with the JAX package's, in
float64 on the CPU (the JAX Pallas kernels in interpret mode, the port's
plain versions), and the port's epoch dispatch rules:

  * ``admm_epoch_plain`` against ``admm_epoch_batched`` at the spline QP's
    shape (n=32, m=15), at n=30/m=12 and box-only (m=0), to 1e-9;
  * ``ldlt_factor_plain`` (and the ``ldlt_factor`` wrapper on the CPU)
    against ``ldlt_factor``'s leading K x K block, to 1e-10;
  * ``ruiz_equilibrate`` per lane against the vmapped JAX one, to 1e-12;
  * ``box_admm_solve`` with ``equil_iters=4`` (the spline QP's settings) at
    B=3: status and iterations exact, the solution to 1e-9;
  * a CPU tensor launches no kernel; a KKT too large for a block's shared
    memory takes the LU epoch, decided from the shape.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from polympc_tpu.control.path import spline_fit_qp_data as j_spline_qp  # noqa: E402,E501
from polympc_tpu.ops.admm_epoch import admm_epoch_batched as j_epoch  # noqa: E402,E501
from polympc_tpu.ops.ldlt import ldlt_factor as j_ldlt_factor  # noqa: E402
from polympc_tpu.qp.box_admm import box_admm_solve as j_box  # noqa: E402
from polympc_tpu.qp.ruiz import ruiz_equilibrate as j_ruiz  # noqa: E402
from polympc_tpu.qp.types import ADMMSettings as JADMMSettings  # noqa: E402
from polympc_tpu.qp.types import QPData as JQPData  # noqa: E402
from _torch_parity import single_thread  # noqa: E402,F401
from polympc_torch import headline_table as ht  # noqa: E402
from polympc_torch.ops import _build  # noqa: E402
from polympc_torch.ops import admm_epoch as ae  # noqa: E402
from polympc_torch.ops import ldlt  # noqa: E402
from polympc_torch.qp import box_admm as tbox  # noqa: E402
from polympc_torch.qp.ruiz import ruiz_equilibrate, unscale_solution  # noqa: E402,E501
from polympc_torch.qp.types import QPData  # noqa: E402
from polympc_torch.utils import convert  # noqa: E402

SIGMA, ALPHA = 1e-6, 1.6


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _epoch_case(n, m, B, seed):
    """A batch of quasi-definite boxADMM KKTs built for their own rho/rb
    (the recipe of tests/test_tpu_kernels.py), with loose boxes (+-inf)
    on some rows, and a random state."""
    rng = np.random.default_rng(seed)
    K = np.zeros((B, n + m, n + m))
    rho = rng.uniform(0.5, 2.0, (B, m))
    rb = rng.uniform(0.05, 0.2, (B, n))
    for b in range(B):
        G = rng.standard_normal((n, n))
        H = G @ G.T / n + np.eye(n)
        J = rng.standard_normal((m, n))
        K[b] = np.block([[H + SIGMA * np.eye(n) + np.diag(rb[b]), J.T],
                         [J, -np.diag(1.0 / rho[b])]])
    al = rng.normal(size=(B, m)) - 2.0
    au = al + rng.uniform(0.5, 3.0, (B, m))
    xl = np.full((B, n), -0.8)
    xu = np.full((B, n), 0.8)
    xl[:, ::5], xu[:, ::5] = -np.inf, np.inf
    vec = lambda k, s=0.1: rng.normal(size=(B, k)) * s
    return (K, vec(n, 1.0), al, au, xl, xu, rho, rb, vec(n), vec(m),
            vec(n) + 0.01, vec(m), vec(n))


@pytest.mark.parametrize("n,m", [(32, 15), (30, 12), (20, 0)],
                         ids=["spline-shape", "n30-m12", "box-only"])
def test_admm_epoch_plain_matches_jax(n, m):
    args = _epoch_case(n, m, B=3, seed=n + m)
    kw = dict(sigma=SIGMA, alpha=ALPHA, iters=7)
    want = j_epoch(*(jnp.asarray(a) for a in args), interpret=True, **kw)
    _build.reset_launches()
    got = ae.admm_epoch_batched(*(_t(a) for a in args), **kw)
    plain = ae.admm_epoch_plain(*(_t(a) for a in args), **kw)
    assert sum(_build.LAUNCHES.values()) == 0
    for g, p, w, name in zip(got, plain, want, ("x", "z", "q", "y", "yb")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-9, err_msg=name)
        torch.testing.assert_close(g, p, rtol=0, atol=0)


@pytest.mark.parametrize("K", [8, 47, 61])
def test_ldlt_factor_matches_jax(K):
    rng = np.random.default_rng(K)
    A = rng.normal(size=(3, K, K))
    A = A + A.transpose(0, 2, 1)
    sign = np.where(np.arange(K) < K // 2, 1.0, -1.0)
    A[:, np.arange(K), np.arange(K)] = sign * (np.abs(A).sum(axis=2) + 1.0)
    Fj, dj = j_ldlt_factor(jnp.asarray(A), interpret=True)
    _build.reset_launches()
    F, d = ldlt.ldlt_factor(_t(A))
    assert _build.LAUNCHES["ldlt_factor"] == 0
    assert F.shape == (3, K, K) and d.shape == (3, K)
    np.testing.assert_allclose(F.numpy(), np.asarray(Fj)[:, :K, :K],
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(d.numpy(), np.asarray(dj)[:, :K], rtol=1e-10,
                               atol=1e-10)
    b = _t(rng.normal(size=(3, K)))
    x = ldlt.ldlt_solve(F, d, b)
    np.testing.assert_allclose((_t(A) @ x[..., None])[..., 0].numpy(),
                               b.numpy(), rtol=1e-9, atol=1e-9)


def _spline_lanes(B):
    """The spline-fitting QP with B jittered linear terms (the harness's
    recipe), as numpy: (JAX QPData of one lane, h (B, n))."""
    qp, _ = j_spline_qp(ht.SPLINE_S, ht.SPLINE_Y, 8, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    ys = ht.SPLINE_Y[None] + 0.05 * rng.standard_normal((B, 81))
    hs = np.stack([np.asarray(j_spline_qp(ht.SPLINE_S, yy, 8)[0].h)
                   for yy in ys])
    return qp, hs


def _lanes(qp, hs):
    B = hs.shape[0]
    tile = lambda a: _t(np.broadcast_to(np.asarray(a),
                                        (B,) + np.shape(a)).copy())
    return QPData(tile(qp.H), _t(hs), tile(qp.A), tile(qp.al), tile(qp.au),
                  tile(qp.xl), tile(qp.xu))


def test_ruiz_matches_jax():
    qp, hs = _spline_lanes(2)
    rng = np.random.default_rng(4)
    # a second family with general rows of mixed scale, and a box-only one
    n, m = 9, 4
    A = rng.normal(size=(m, n)) * np.array([1e-2, 1.0, 30.0, 1.0])[:, None]
    G = rng.normal(size=(n, n))
    qp2 = JQPData(H=jnp.asarray(G @ G.T + 1e3 * np.eye(n)),
                  h=jnp.asarray(rng.normal(size=n)), A=jnp.asarray(A),
                  al=jnp.asarray(-np.ones(m)), au=jnp.asarray(np.ones(m)),
                  xl=jnp.asarray(-np.ones(n)), xu=jnp.asarray(np.ones(n)))
    qp3 = qp2._replace(A=jnp.zeros((0, n)), al=jnp.zeros(0),
                       au=jnp.zeros(0))
    cases = [(qp, hs), (qp2, rng.normal(size=(3, n)) * 50.0),
             (qp3, rng.normal(size=(2, n)))]
    for q, h in cases:
        want_qp, want_s = jax.vmap(
            lambda hh: j_ruiz(q._replace(h=hh), iters=4))(jnp.asarray(h))
        got_qp, got_s = ruiz_equilibrate(_lanes(q, h), iters=4)
        for f in QPData._fields:
            np.testing.assert_allclose(getattr(got_qp, f).numpy(),
                                       np.asarray(getattr(want_qp, f)),
                                       rtol=1e-12, atol=1e-12, err_msg=f)
        for f in ("d", "e", "c"):
            np.testing.assert_allclose(getattr(got_s, f).numpy(),
                                       np.asarray(getattr(want_s, f)),
                                       rtol=1e-12, atol=1e-12, err_msg=f)
        x = _t(rng.normal(size=h.shape))
        y = _t(rng.normal(size=(h.shape[0], got_qp.A.shape[1])))
        back = unscale_solution(x, y, x, got_s)
        np.testing.assert_allclose(back[0].numpy(), (got_s.d * x).numpy(),
                                   rtol=1e-15)


@pytest.fixture(scope="module")
def spline_solves():
    """The spline QP at B=3 with the harness's settings: the JAX package's
    vmapped solve (dense epoch kernel in interpret mode) and the port's."""
    qp, hs = _spline_lanes(3)
    jset = JADMMSettings(rho=0.1, eps_abs=1e-4, eps_rel=1e-4, max_epochs=10,
                         check_every=25, equil_iters=4, kkt_solver="pallas")
    want = jax.vmap(lambda h: j_box(qp._replace(h=h), settings=jset))(
        jnp.asarray(hs))
    _build.reset_launches()
    got = tbox.box_admm_solve(_lanes(qp, hs), settings=ht.spline_settings())
    launches = dict(_build.LAUNCHES)
    return want, got, launches, (qp, hs)


def test_equilibrated_solve_matches_jax(spline_solves):
    want, got, launches, _ = spline_solves
    assert sum(launches.values()) == 0
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    for f in ("x", "y", "y_box", "res_prim", "res_dual"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-9,
                                   atol=1e-9, err_msg=f)


def test_equilibrated_warm_start_matches_jax(spline_solves):
    """Warm starts are scaled into the equilibrated problem: a solve warm
    started at the previous solution, without polish, on both sides."""
    want0, _, _, (qp, hs) = spline_solves
    jset = JADMMSettings(rho=0.1, eps_abs=1e-6, eps_rel=1e-6, max_epochs=2,
                         check_every=25, equil_iters=4, kkt_solver="pallas",
                         polish=False)
    x0, y0, yb0 = (np.asarray(a) * 0.9 for a in (want0.x, want0.y,
                                                  want0.y_box))
    want = jax.vmap(lambda h, a, b, c: j_box(
        qp._replace(h=h), x0=a, y0=b, y_box0=c, settings=jset))(
        jnp.asarray(hs), x0, y0, yb0)
    tset = dataclasses.replace(ht.spline_settings(), eps_abs=1e-6,
                               eps_rel=1e-6, max_epochs=2, polish=False)
    got = tbox.box_admm_solve(_lanes(qp, hs), x0=_t(x0), y0=_t(y0),
                              y_box0=_t(yb0), settings=tset)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    for f in ("x", "y", "y_box"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-9,
                                   atol=1e-9, err_msg=f)


def test_epoch_dispatch_by_shape(monkeypatch):
    """kkt_solver="kernel" without a structure runs the dense epoch while
    the KKT's packed triangle fits a block's shared memory (K up to 340),
    and the LU epoch above that."""
    assert ae.epoch_kernel_fits(32, 15) and ae.epoch_kernel_fits(200, 140)
    assert not ae.epoch_kernel_fits(200, 141)
    assert ae.epoch_smem_bytes(32, 15) == 4 * (47 * 48 // 2) * 4
    calls = []
    real = tbox.admm_epoch_batched
    monkeypatch.setattr(tbox, "admm_epoch_batched",
                        lambda *a, **k: calls.append(a[1].shape) or
                        real(*a, **k))
    rng = np.random.default_rng(8)
    settings = dataclasses.replace(ht.spline_settings(), max_epochs=1,
                                   polish=False, equil_iters=0)
    for n, m in ((12, 5), (335, 10)):
        G = rng.normal(size=(n, n))
        qp = JQPData(H=G @ G.T / n + np.eye(n), h=rng.normal(size=n),
                     A=rng.normal(size=(m, n)), al=-np.ones(m),
                     au=np.ones(m), xl=-np.ones(n), xu=np.ones(n))
        tq = convert.qp_data(JQPData(*(np.asarray(a)[None] for a in qp)),
                             device="cpu")
        sol = tbox.box_admm_solve(tq, settings=settings)
        assert torch.isfinite(sol.x).all()
    assert calls == [(1, 12)]


def test_wrappers_raise_off_cpu_and_cuda():
    args = [torch.empty((1, 3, 3), device="meta")] + [
        torch.empty((1, k), device="meta") for k in (2, 1, 1, 2, 2, 1, 2,
                                                     2, 1, 2, 1, 2)]
    with pytest.raises(ValueError, match="no kernel for meta"):
        ae.admm_epoch_batched(*args, sigma=SIGMA, alpha=ALPHA, iters=1)
    with pytest.raises(ValueError, match="no kernel for meta"):
        ldlt.ldlt_factor(args[0])
