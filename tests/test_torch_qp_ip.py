"""Parity of the port's interior-point QP solver (polympc_torch.qp.ip) with
the JAX package's, in float64 on the CPU, on the cases of the interior-point
section of tests/test_qp.py.  Each case goes through the port as one batch
and through the JAX function lane by lane (its test vmaps it): per lane the
status and iteration count are equal, x agrees to 1e-10 and the duals y,
y_box to 1e-8 (a dual is the ratio of a complementarity product near the
1e-8 tolerance to its slack, so last-bit differences grow there)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from polympc_tpu.qp import QPData as JQPData
from polympc_tpu.qp.ip import qp_ip_solve as j_qp_ip_solve
from polympc_torch.qp import IPSettings, QPData, qp_ip_solve
from polympc_torch.utils import status as st

from tests._torch_parity import single_thread  # noqa: F401

INF = np.inf
TOL = dict(rtol=1e-10, atol=1e-10)


def simple(hscale=1.0):
    """The canonical reference QP (admm_solver_test.cpp:19-45)."""
    return dict(H=[[4.0, 1.0], [1.0, 2.0]], h=[hscale, hscale],
                A=[[1.0, 1.0]], al=[1.0], au=[1.0], xl=[0.0, 0.0],
                xu=[0.7, 0.7])


def random_qp(rng, n=10, m=6):
    """tests/test_qp.py::test_ip_random_qps's draw."""
    M = rng.normal(size=(n, n))
    H = M @ M.T + 0.5 * np.eye(n)
    h = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    x_feas = rng.normal(size=n) * 0.5
    Ax = A @ x_feas
    return dict(H=H, h=h, A=A, al=Ax - rng.uniform(0.1, 1.0, m),
                au=Ax + rng.uniform(0.1, 1.0, m),
                xl=x_feas - rng.uniform(0.1, 2.0, n),
                xu=x_feas + rng.uniform(0.1, 2.0, n))


def unbounded():
    return dict(H=[[2.0, 0.0], [0.0, 2.0]], h=[-2.0, -4.0],
                A=np.zeros((0, 2)), al=np.zeros(0), au=np.zeros(0),
                xl=[-INF, -INF], xu=[INF, INF])


def cases():
    rng = np.random.default_rng(3)
    return {"simple": [simple()],
            "random": [random_qp(rng) for _ in range(5)],
            "unbounded": [unbounded()],
            "vmap": [simple(1 + 0.1 * i) for i in range(8)]}


def as_arrays(qps):
    return {f: np.stack([np.asarray(q[f], np.float64) for q in qps])
            for f in JQPData._fields}


def check_parity(qps, settings=IPSettings()):
    arr = as_arrays(qps)
    sol = qp_ip_solve(QPData(*(torch.tensor(arr[f]) for f in
                               QPData._fields)), settings)
    for b in range(len(qps)):
        js = j_qp_ip_solve(JQPData(*(jnp.asarray(arr[f][b])
                                     for f in JQPData._fields)))
        assert int(sol.status[b]) == int(js.status)
        assert int(sol.iters[b]) == int(js.iters)
        np.testing.assert_allclose(sol.x[b].numpy(), np.asarray(js.x),
                                   **TOL)
        for f in ("y", "y_box"):
            np.testing.assert_allclose(getattr(sol, f)[b].numpy(),
                                       np.asarray(getattr(js, f)),
                                       err_msg=f, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(sol.res_prim[b].item(),
                                   float(js.res_prim), rtol=1e-6, atol=1e-12)
    return sol


@pytest.mark.parametrize("name", ["simple", "random", "unbounded", "vmap"])
def test_ip_matches_jax(name):
    sol = check_parity(cases()[name])
    assert (sol.status == st.SOLVED).all()
    if name == "simple":
        np.testing.assert_allclose(sol.x[0].numpy(), [0.3, 0.7], atol=1e-6)
    if name == "unbounded":
        np.testing.assert_allclose(sol.x[0].numpy(), [1.0, 2.0], atol=1e-7)


def test_ip_mixed_batch_max_iter_lanes_match_jax():
    """One batch of every case at max_iter=6: lanes that stop on their own
    and lanes cut at the cap keep their own counts and statuses."""
    qps = [q for qs in cases().values() for q in qs
           if np.asarray(q["A"]).shape == (1, 2)]
    sol = qp_ip_solve(QPData(*(torch.tensor(as_arrays(qps)[f])
                               for f in QPData._fields)),
                      IPSettings(max_iter=6))
    from polympc_tpu.qp.ip import IPSettings as JIPSettings
    for b, q in enumerate(qps):
        js = j_qp_ip_solve(JQPData(*(jnp.asarray(np.asarray(q[f], float))
                                     for f in JQPData._fields)),
                           JIPSettings(max_iter=6))
        assert int(sol.status[b]) == int(js.status)
        assert int(sol.iters[b]) == int(js.iters)
        np.testing.assert_allclose(sol.x[b].numpy(), np.asarray(js.x), **TOL)
