"""Parity of the port's path toolchain (polympc_torch.control.path) with the
JAX package's, in float64 on the CPU:

  * ``spline_fit_qp_data``: the same arrays, exactly;
  * ``fit_spline_qp``: the same coefficients to 1e-9;
  * ``track_from_curvature``: the same centerline splines to 1e-12;
  * ``project_on_path_newton`` on a batch of points (with the caller's
    guesses and with the grid seed) against the JAX function per point
    (vmapped), to 1e-9, and ``frame_transform`` on a batch of poses, to
    1e-9;
  * ``project_on_path`` (the SQP oracle, an NLP with n=1 and no
    constraints): the same status and iterations, s to 1e-9.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from polympc_tpu.control import path as jp  # noqa: E402
from polympc_tpu.models import make_wave_track as j_wave  # noqa: E402
from polympc_torch.control import path as tp_  # noqa: E402
from polympc_torch.models import make_wave_track  # noqa: E402
from polympc_torch.qp.types import QPData  # noqa: E402
from _torch_parity import single_thread  # noqa: E402,F401

TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def paths():
    jpath = jp.track_from_curvature(j_wave(200.0, 0.02, 3), s_max=200.0)
    tpath = tp_.track_from_curvature(make_wave_track(200.0, 0.02, 3,
                                                     device="cpu"),
                                     s_max=200.0, device="cpu")
    return jpath, tpath


def _samples():
    s = np.linspace(0.0, 10.0, 81)
    return s, np.sin(0.7 * s) + 0.1 * s


def test_spline_fit_qp_data_arrays_identical():
    s, y = _samples()
    jqp, jh = jp.spline_fit_qp_data(s, y, 8)
    tqp, th = tp_.spline_fit_qp_data(s, y, 8, device="cpu")
    assert th == jh
    for f in QPData._fields:
        got = getattr(tqp, f)
        assert got.shape[0] == 1 and got.dtype == torch.float64
        np.testing.assert_array_equal(got[0].numpy(),
                                      np.asarray(getattr(jqp, f)), err_msg=f)


def test_fit_spline_qp_matches_jax():
    s, y = _samples()
    jsp = jp.fit_spline_qp(s, y, n_segments=8)
    tsp = tp_.fit_spline_qp(s, y, n_segments=8, device="cpu")
    assert (tsp.x0, tsp.h) == (jsp.x0, jsp.h)
    np.testing.assert_allclose(tsp.coeffs, np.asarray(jsp.coeffs), **TOL)


def test_track_from_curvature_matches_jax(paths):
    jpath, tpath = paths
    assert tpath.s_max == jpath.s_max
    for f in ("Xc", "Yc", "psi_c", "kappa"):
        np.testing.assert_allclose(getattr(tpath, f).coeffs,
                                   np.asarray(getattr(jpath, f).coeffs),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    s = np.linspace(-5.0, 205.0, 17)
    np.testing.assert_allclose(
        tpath.position(torch.as_tensor(s)).numpy(),
        np.asarray(jax.vmap(jpath.position)(jnp.asarray(s))), rtol=1e-12,
        atol=1e-12)


def _points(jpath, B, seed):
    """Points near the track (true s, a lateral offset) and guesses."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(2.0, 198.0, B)
    psi = np.asarray(jax.vmap(jpath.psi_c)(jnp.asarray(s)))
    off = rng.uniform(-2.0, 2.0, B)
    X = np.asarray(jax.vmap(jpath.Xc)(jnp.asarray(s))) - off * np.sin(psi)
    Y = np.asarray(jax.vmap(jpath.Yc)(jnp.asarray(s))) + off * np.cos(psi)
    return np.stack([X, Y], 1), s + rng.uniform(-1.5, 1.5, B), psi


@pytest.mark.parametrize("seeded", [True, False], ids=["guess", "grid"])
def test_project_on_path_newton_batch_matches_jax(paths, seeded):
    jpath, tpath = paths
    pts, s0, _ = _points(jpath, 24, seed=5)
    pts[0] = [1e3, 1e3]          # far away: the clipped steps
    want = np.asarray(jax.jit(jax.vmap(
        lambda p, s: jp.project_on_path_newton(jpath, p,
                                               s0=s if seeded else None)))(
        jnp.asarray(pts), jnp.asarray(s0)))
    got = tp_.project_on_path_newton(
        tpath, torch.as_tensor(pts),
        s0=torch.as_tensor(s0) if seeded else None)
    assert got.shape == (24,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    one = tp_.project_on_path_newton(tpath, pts[3], s0=float(s0[3]))
    assert one.dim() == 0 and float(one) == pytest.approx(want[3], abs=1e-9)


def test_frame_transform_batch_matches_jax(paths):
    jpath, tpath = paths
    pts, s0, psi = _points(jpath, 12, seed=6)
    heading = psi + np.linspace(-3.0, 3.0, 12)
    want = jax.jit(jax.vmap(lambda x, y, h: jp.frame_transform(
        jpath, x, y, h)))(*(jnp.asarray(a) for a in (pts[:, 0], pts[:, 1],
                                                      heading)))
    got = tp_.frame_transform(tpath, torch.as_tensor(pts[:, 0]),
                              torch.as_tensor(pts[:, 1]),
                              torch.as_tensor(heading))
    for k in range(3):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL)


def test_project_on_path_sqp_matches_jax(paths):
    """The SQP oracle: an NLP with n=1 and no general constraints (m=0)
    through the batch-first SQP, boxADMM and polish."""
    jpath, tpath = paths
    pt = np.asarray(jpath.position(120.0)) + np.array([0.3, -0.2])
    js, jsol = jp.project_on_path(jpath, jnp.asarray(pt))
    ts_, tsol = tp_.project_on_path(tpath, pt)
    assert int(tsol.status[0]) == int(jsol.status) == 1
    assert int(tsol.iters[0]) == int(jsol.iters)
    assert float(ts_) == pytest.approx(float(js), abs=1e-9)
    s_n = tp_.project_on_path_newton(tpath, pt)
    assert float(s_n) == pytest.approx(float(ts_), abs=1e-6)
    s, w, th = tp_.frame_transform(tpath, pt[0], pt[1], 0.0, method="sqp")
    assert float(s) == pytest.approx(float(ts_), abs=1e-12)
