"""Parity of the port's trust-region, projected-gradient and pseudo-arc-
length continuation solvers (polympc_torch.nlp.tr, nlp.psarc) with the JAX
package's, in float64 on the CPU, on the cases of tests/test_tr.py and
tests/test_psarc.py.

  * trust region and projected gradient: per lane status and iteration
    count equal, x to 1e-10 (the same Newton / projected steps; a batch
    through the port against one JAX call per start point);
  * psarc: the same convergence, step count and continuation path (lambda
    log) to 1e-6, the root to 1e-8 (each corrector is an SQP solve whose
    boxADMM stops at eps 1e-8, so the points agree to that order).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from polympc_tpu.nlp import PsarcSettings as JPsarcSettings
from polympc_tpu.nlp import projected_gradient_solve as j_gradproj
from polympc_tpu.nlp import psarc_solve as j_psarc
from polympc_tpu.nlp import trust_region_solve as j_tr
from polympc_torch.nlp import (
    PsarcSettings, projected_gradient_solve, psarc_solve, trust_region_solve)
from polympc_torch.utils import status as st

from tests._torch_parity import single_thread  # noqa: F401

TOL = dict(rtol=1e-10, atol=1e-10)


def qp_pair():
    """The reference's SimpleQP: H = diag(10, 0.1), h = (-1, -2)."""
    H, h = np.array([[10.0, 0.0], [0.0, 0.1]]), np.array([-1.0, -2.0])
    Hj, hj = jnp.asarray(H), jnp.asarray(h)
    Ht, ht = torch.tensor(H), torch.tensor(h)
    return (lambda x: 0.5 * x @ (Hj @ x) + hj @ x,
            lambda x: 0.5 * x @ (Ht @ x) + ht @ x)


def rosenbrock(x):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def check_lanes(sol, jsols):
    for b, js in enumerate(jsols):
        assert int(sol.status[b]) == int(js.status)
        assert int(sol.iters[b]) == int(js.iters)
        np.testing.assert_allclose(sol.x[b].numpy(), np.asarray(js.x), **TOL)


@pytest.mark.parametrize("case", ["simple_qp", "rosenbrock", "batch",
                                  "max_iter"])
def test_trust_region_matches_jax(case):
    fj, ft = qp_pair() if case == "simple_qp" else (rosenbrock, rosenbrock)
    x0s = {"simple_qp": [[0.0, 0.0]], "rosenbrock": [[0.0, 0.0]],
           "batch": [[0.0, 0.0], [-1.0, 1.5], [2.0, 2.0]],
           "max_iter": [[-1.9, 2.0]]}[case]
    kw = {"simple_qp": {}, "max_iter": {"max_iter": 3}}.get(
        case, {"max_iter": 200})
    sol = trust_region_solve(ft, torch.tensor(x0s, dtype=torch.float64), **kw)
    check_lanes(sol, [j_tr(fj, jnp.asarray(x0), **kw) for x0 in x0s])
    want = st.MAX_ITER_EXCEEDED if case == "max_iter" else st.SOLVED
    assert (sol.status == want).all()


def test_trust_region_unbatched_start():
    _, ft = qp_pair()
    sol = trust_region_solve(ft, torch.zeros(2, dtype=torch.float64))
    assert sol.x.shape == (2,) and int(sol.status) == st.SOLVED
    np.testing.assert_allclose(sol.x.numpy(), [0.1, 20.0], atol=1e-4)


@pytest.mark.parametrize("start", [[0.0, 0.0], [5.0, -5.0]])
def test_projected_gradient_matches_jax(start):
    """tests/test_tr.py's box QP and active-bound cases, with the
    reference's Armijo sign kept in both packages."""
    fj, ft = qp_pair()
    kw = dict(lb=[-1.0, -1.0], ub=[1.0, 1.0], max_iter=500)
    sol = projected_gradient_solve(ft, torch.tensor([start],
                                                    dtype=torch.float64),
                                   **kw)
    check_lanes(sol, [j_gradproj(fj, jnp.asarray(start), **kw)])
    assert int(sol.status[0]) == st.SOLVED
    np.testing.assert_allclose(sol.x[0].numpy(), [0.1, 1.0], atol=1e-5)


def psarc_cases():
    A = np.array([[3.0, 1.0], [1.0, 2.0]])
    b = np.array([1.0, -1.0])
    return {
        "cubic": (lambda x: jnp.array([x[0] ** 3 - 3 * x[0] - x[1],
                                       x[1] - 2.0]),
                  lambda x: torch.stack([x[0] ** 3 - 3 * x[0] - x[1],
                                         x[1] - 2.0]),
                  [0.5, 0.0], {}),
        "linear": (lambda x: jnp.asarray(A) @ x - jnp.asarray(b),
                   lambda x: torch.tensor(A) @ x - torch.tensor(b),
                   [0.0, 0.0], {}),
        "bounded": (lambda x: jnp.array([x[0] ** 2 - 4.0, x[1] - 1.0]),
                    lambda x: torch.stack([x[0] ** 2 - 4.0, x[1] - 1.0]),
                    [1.0, 0.5], {"h0": 0.5, "bounds": True}),
    }


@pytest.mark.parametrize("case", ["cubic", "linear", "bounded"])
def test_psarc_matches_jax(case):
    Fj, Ft, x0, kw = psarc_cases()[case]
    bounded = kw.pop("bounds", False)
    jkw = dict(settings=JPsarcSettings(**kw))
    tkw = dict(settings=PsarcSettings(**kw))
    if bounded:
        jkw.update(lbx=jnp.zeros(2), ubx=jnp.full(2, 10.0))
        tkw.update(lbx=torch.zeros(2, dtype=torch.float64),
                   ubx=torch.full((2,), 10.0, dtype=torch.float64))
    res = psarc_solve(Ft, torch.tensor(x0, dtype=torch.float64), **tkw)
    jres = j_psarc(Fj, jnp.asarray(x0), **jkw)
    assert res.converged and jres.converged
    assert res.steps == jres.steps
    np.testing.assert_allclose(res.lambda_log, jres.lambda_log, rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), atol=1e-8)
    assert float(Ft(res.x).abs().max()) < 1e-6
