"""The port's utilities beside the JAX package's, in float64: the
quaternion algebra, the smooth switch, ``rk4_step_fn`` and the
controllability / observability matrices to 1e-14, the linear-system checks
equal; ``is_psd`` and ``print_qp``'s text equal; the RBF kernel, gradient
and Hessian to 1e-12; ``Timer``, ``time_fn`` and ``trace`` on the CPU.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import single_thread  # noqa: E402,F401
from polympc_tpu import utils as J  # noqa: E402
from polympc_tpu.qp.types import QPData as JQPData  # noqa: E402
from polympc_torch import utils as T  # noqa: E402
from polympc_torch.qp.types import QPData  # noqa: E402

TOL = dict(rtol=1e-14, atol=1e-14)


def t64(a):
    return torch.tensor(np.asarray(a, np.float64))


@pytest.mark.parametrize("name", ["t1_quat", "t2_quat", "t3_quat"])
def test_axis_quaternions_match_jax(name):
    for ang in (0.0, 0.7, -2.3):
        np.testing.assert_allclose(
            getattr(T, name)(t64(ang)).numpy(),
            np.asarray(getattr(J, name)(jnp.asarray(ang))), **TOL)


def test_quaternion_algebra_matches_jax():
    rng = np.random.default_rng(4)
    q1, q2 = rng.normal(size=4), rng.normal(size=4)
    q1 /= np.linalg.norm(q1)
    v = rng.normal(size=3)
    np.testing.assert_allclose(
        T.quat_multiply(t64(q1), t64(q2)).numpy(),
        np.asarray(J.quat_multiply(jnp.asarray(q1), jnp.asarray(q2))), **TOL)
    np.testing.assert_allclose(T.quat_inverse(t64(q1)).numpy(),
                               np.asarray(J.quat_inverse(jnp.asarray(q1))),
                               **TOL)
    np.testing.assert_allclose(
        T.quat_transform(t64(q1), t64(v)).numpy(),
        np.asarray(J.quat_transform(jnp.asarray(q1), jnp.asarray(v))), **TOL)
    # a z-rotation by T3 is the z-axis direction cosine matrix
    a = 0.6
    c, s = np.cos(a), np.sin(a)
    dcm = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    np.testing.assert_allclose(
        T.quat_transform(T.t3_quat(t64(a)), t64([1.0, 2.0, 3.0])).numpy(),
        dcm @ [1.0, 2.0, 3.0], atol=1e-12)


def test_scalar_helpers_match_jax():
    for x in (-10.0, -0.3, 0.0, 0.4, 10.0):
        np.testing.assert_allclose(
            float(T.heaviside(t64(x), 2.0)),
            float(J.heaviside(jnp.asarray(x), 2.0)), **TOL)
    assert T.deg2rad(180.0) == float(J.deg2rad(180.0))
    f_t = lambda x, u: torch.stack([x[1], -x[0] + u[0]])
    f_j = lambda x, u: jnp.stack([x[1], -x[0] + u[0]])
    np.testing.assert_allclose(
        T.rk4_step_fn(f_t, 0.01)(t64([1.0, 0.5]), t64([0.2])).numpy(),
        np.asarray(J.rk4_step_fn(f_j, 0.01)(jnp.asarray([1.0, 0.5]),
                                             jnp.asarray([0.2]))), **TOL)


def test_linear_system_matches_jax():
    rng = np.random.default_rng(8)
    F, G, H = rng.normal(size=(4, 4)), rng.normal(size=(4, 2)), \
        rng.normal(size=(1, 4))
    np.testing.assert_allclose(T.controllability_matrix(F, G).numpy(),
                               np.asarray(J.controllability_matrix(F, G)),
                               **TOL)
    np.testing.assert_allclose(T.observability_matrix(F, H).numpy(),
                               np.asarray(J.observability_matrix(F, H)),
                               **TOL)
    cases = [
        (F, G, H),
        (np.array([[-1.0, 0.0], [0.0, 2.0]]), np.array([[0.0], [1.0]]),
         np.array([[1.0, 0.0]])),
        (np.array([[-1.0, 0.0], [0.0, 2.0]]), np.array([[1.0], [0.0]]),
         np.array([[0.0, 1.0]])),
        (np.array([[-1.0, 0.0], [0.0, -2.0]]), np.eye(2),
         np.array([[1.0, 0.0]])),
    ]
    for F_, G_, H_ in cases:
        js, ts = J.LinearSystem(F_, G_, H_), T.LinearSystem(F_, G_, H_)
        for check in ("is_controllable", "is_observable",
                      "is_stabilizable", "is_detectable"):
            assert getattr(ts, check)() == getattr(js, check)(), check
    with pytest.raises(ValueError):
        T.LinearSystem(F, G).is_observable()


def test_is_psd_and_print_qp_match_jax(capsys):
    for M in (np.eye(3), np.diag([1.0, -0.1]), np.diag([1.0, -1e-9])):
        assert T.is_psd(t64(M)) == J.is_psd(M)
        assert T.is_psd(t64(M), tol=1e-8) == J.is_psd(M, tol=1e-8)
    rng = np.random.default_rng(2)
    f = {"H": np.eye(2) * 2.0, "h": rng.normal(size=2),
         "A": rng.normal(size=(1, 2)), "al": np.array([-1.0]),
         "au": np.array([1.0]), "xl": np.array([-np.inf, 0.0]),
         "xu": np.array([np.inf, 1.0])}
    want = J.print_qp(JQPData(**{k: jnp.asarray(v) for k, v in f.items()}))
    got = T.print_qp(QPData(**{k: t64(v) for k, v in f.items()}))
    assert got == want
    assert want in capsys.readouterr().out


def test_rbf_matches_jax():
    x, c, gamma = [0.5, -0.3, 0.2], [0.1, 0.2, -0.4], 0.7
    np.testing.assert_allclose(
        float(T.rbf_kernel(t64(x), t64(c), gamma)),
        float(J.rbf_kernel(jnp.asarray(x), jnp.asarray(c), gamma)),
        rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(T.rbf_grad(t64(x), t64(c), gamma).numpy(),
                               np.asarray(J.rbf_grad(x, c, gamma)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(T.rbf_hessian(t64(x), t64(c), gamma).numpy(),
                               np.asarray(J.rbf_hessian(x, c, gamma)),
                               rtol=1e-12, atol=1e-12)


def test_timer_and_time_fn_on_the_cpu(tmp_path):
    a = T.get_time()
    assert T.get_time() >= a
    x = torch.ones(64)
    with T.Timer() as t:
        t.block_on(x * 2.0)
    assert t.elapsed >= 0.0
    stats = T.time_fn(lambda v: v + 1.0, torch.zeros(4), iters=5, batch=16)
    assert stats.iters == 5 and stats.batch == 16
    assert stats.solves_per_s > 0 and "solves/s" in str(stats)
    assert abs(stats.mean_s * 5 - stats.total_s) < 1e-12
    with T.trace(str(tmp_path / "prof")) as prof:
        torch.ones(8) @ torch.ones(8)
    assert len(prof.key_averages()) > 0
    trace = tmp_path / "prof" / "trace.json"
    assert os.path.getsize(trace) > 0
    json.loads(trace.read_text())
    # an exception inside the block still writes the trace
    with pytest.raises(ValueError):
        with T.trace(str(tmp_path / "failed")):
            torch.ones(8) @ torch.ones(8)
            raise ValueError("inside the trace")
    json.loads((tmp_path / "failed" / "trace.json").read_text())
