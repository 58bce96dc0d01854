"""Parity of the port's native active-set QP solver
(polympc_torch.qp.active_set, its own copy of qpmad.cpp built by its own
loader) with the JAX package's, in float64 on the CPU: the cases of
tests/test_active_set.py, as one batch through the port and lane by lane
through the JAX function, agree per lane in status and iteration count and
to 1e-12 in x, y and y_box (the same source built with the same compiler
and flags); and the port's copy of the source is the JAX package's, byte
for byte."""
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from polympc_tpu.qp.active_set import qp_active_set_solve as j_solve
from polympc_tpu.qp.types import QPData as JQPData
from polympc_torch import native
from polympc_torch.qp import QPData, qp_active_set_solve
from polympc_torch.utils import status as st

ROOT = Path(__file__).resolve().parents[1]
INF = np.inf
TOL = dict(rtol=1e-12, atol=1e-12)


def random_case(trial, n=10, m=6):
    """tests/test_active_set.py::test_random_qp_matches_admm's draw."""
    rng = np.random.default_rng(trial)
    Q = rng.normal(size=(n, n))
    H = Q @ Q.T + n * np.eye(n)
    h = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    al = rng.uniform(-2, -0.5, m)
    au = rng.uniform(0.5, 2, m)
    if trial % 3 == 0:
        au[:2] = al[:2]
    xl = rng.uniform(-3, -1, n)
    xu = rng.uniform(1, 3, n)
    if trial % 4 == 0:
        xl[0], xu[1] = -INF, INF
    return dict(H=H, h=h, A=A, al=al, au=au, xl=xl, xu=xu)


def small_cases():
    """The canonical QP, a box-only QP, an infeasible and a
    not-positive-definite one (each is a batch of its own)."""
    return {
        "canonical": dict(H=[[4.0, 1.0], [1.0, 2.0]], h=[1.0, 1.0],
                          A=[[1.0, 1.0]], al=[1.0], au=[1.0], xl=[0.0, 0.0],
                          xu=[0.7, 0.7]),
        "box_only": dict(H=2.0 * np.eye(3), h=[-2.0, 0.0, 2.0],
                         A=np.zeros((0, 3)), al=np.zeros(0), au=np.zeros(0),
                         xl=np.full(3, -5.0), xu=np.full(3, 5.0)),
        "infeasible": dict(H=np.eye(1), h=np.zeros(1), A=[[1.0]], al=[1.0],
                           au=[INF], xl=[-INF], xu=[-1.0]),
        "not_pd": dict(H=[[0.0, 0.0], [0.0, 1.0]], h=np.ones(2),
                       A=np.zeros((0, 2)), al=np.zeros(0), au=np.zeros(0),
                       xl=np.full(2, -1.0), xu=np.full(2, 1.0)),
    }


def check(qps):
    arr = {f: np.stack([np.asarray(q[f], np.float64) for q in qps])
           for f in QPData._fields}
    sol = qp_active_set_solve(QPData(*(torch.tensor(arr[f])
                                       for f in QPData._fields)))
    for b in range(len(qps)):
        js = j_solve(JQPData(*(jnp.asarray(arr[f][b])
                               for f in JQPData._fields)))
        assert int(sol.status[b]) == int(js.status)
        assert int(sol.iters[b]) == int(js.iters)
        for f in ("x", "y", "y_box"):
            np.testing.assert_allclose(getattr(sol, f)[b].numpy(),
                                       np.asarray(getattr(js, f)),
                                       err_msg=f, **TOL)
    return sol


def test_source_is_the_jax_packages_byte_for_byte():
    ours = (ROOT / "polympc_torch" / "native" / "qpmad.cpp").read_bytes()
    theirs = (ROOT / "polympc_tpu" / "native" / "qpmad.cpp").read_bytes()
    assert ours == theirs
    assert native.BUILD_DIR == ROOT / "build" / "polympc_torch_native"


@pytest.mark.parametrize("name", ["canonical", "box_only", "infeasible",
                                  "not_pd"])
def test_small_cases_match_jax(name):
    sol = check([small_cases()[name]])
    want = {"canonical": st.SOLVED, "box_only": st.SOLVED,
            "infeasible": st.INFEASIBLE, "not_pd": st.UNSOLVED}[name]
    assert int(sol.status[0]) == want
    if name == "canonical":
        np.testing.assert_allclose(sol.x[0].numpy(), [0.3, 0.7], atol=1e-10)


def test_random_batch_matches_jax():
    sol = check([random_case(t) for t in range(8)])
    assert (sol.status == st.SOLVED).all()
    assert sol.x.dtype == torch.float64 and sol.x.device.type == "cpu"


def test_results_follow_the_callers_dtype():
    q = random_case(1)
    qp = QPData(*(torch.tensor(np.asarray(q[f])[None], dtype=torch.float32)
                  for f in QPData._fields))
    sol = qp_active_set_solve(qp)
    assert sol.x.dtype == torch.float32 and sol.status.dtype == torch.int32
    assert int(sol.status[0]) == st.SOLVED
