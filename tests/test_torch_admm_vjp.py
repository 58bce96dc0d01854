"""Parity of the port's stacked OSQP splitting (``admm_solve``) and of the
implicit-differentiation VJP of ``box_admm_solve`` with the JAX package's,
in float64 on the CPU.

  * ``admm_solve``: per lane status and iteration count equal, x and the
    duals to 1e-9 (the same ADMM iterations through LAPACK LU solves), the
    final adaptive penalty to 1e-4 (1e-2 at eps 1e-9, where the residuals
    it is the ratio of sit at the rounding floor);
  * the VJP: every cotangent (H, h, A, al, au, xl, xu) of a seeded
    weighting of (x, y, y_box) against ``jax.vjp`` to 1e-7 relative to the
    largest entry (both sides solve the same regularised active-set
    system; the forward solves agree to ~1e-12, far inside the active-set
    tolerance 10 eps_abs + 1e-8);
  * a finite-difference check of d x / d h (tests/test_qp.py's
    ``test_grad_through_solve`` case, its atol 1e-3);
  * a call with no field requiring grad takes the plain solve and never
    enters the ``autograd.Function``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from polympc_tpu.qp import ADMMSettings as JADMMSettings
from polympc_tpu.qp import QPData as JQPData
from polympc_tpu.qp import admm_solve as j_admm_solve
from polympc_tpu.qp import box_admm_solve as j_box_admm_solve
from polympc_torch.qp import ADMMSettings, QPData, admm_solve, box_admm_solve
from polympc_torch.qp import box_admm
from polympc_torch.utils import status as st

from tests._torch_parity import single_thread  # noqa: F401

TIGHT = dict(eps_abs=1e-9, eps_rel=1e-9, max_epochs=100)


def random_qps(B, seed, n=8, m=5, eq_rows=1):
    """tests/test_qp.py::test_random_qps_kkt's draw, with ``eq_rows``
    equality rows and a box tight enough to be active on some lanes."""
    rng = np.random.default_rng(seed)
    out = {f: [] for f in JQPData._fields}
    for _ in range(B):
        M = rng.normal(size=(n, n))
        x_feas = rng.normal(size=n) * 0.5
        A = rng.normal(size=(m, n))
        Ax = A @ x_feas
        al = Ax - rng.uniform(0.1, 1.0, m)
        au = Ax + rng.uniform(0.1, 1.0, m)
        al[:eq_rows] = au[:eq_rows] = Ax[:eq_rows]
        vals = dict(H=M @ M.T + 0.5 * np.eye(n), h=3.0 * rng.normal(size=n),
                    A=A, al=al, au=au,
                    xl=x_feas - rng.uniform(0.05, 0.5, n),
                    xu=x_feas + rng.uniform(0.05, 0.5, n))
        for f in out:
            out[f].append(vals[f])
    return {f: np.stack(v) for f, v in out.items()}


def simple():
    return {f: np.asarray(v, np.float64)[None] for f, v in dict(
        H=[[4.0, 1.0], [1.0, 2.0]], h=[1.0, 1.0], A=[[1.0, 1.0]], al=[1.0],
        au=[1.0], xl=[0.0, 0.0], xu=[0.7, 0.7]).items()}


def t_qp(arr, requires_grad=False):
    return QPData(*(torch.tensor(arr[f], requires_grad=requires_grad)
                    for f in QPData._fields))


def j_qp(arr, b):
    return JQPData(*(jnp.asarray(arr[f][b]) for f in JQPData._fields))


@pytest.mark.parametrize("case", ["simple", "random"])
def test_admm_solve_matches_jax(case):
    arr = simple() if case == "simple" else random_qps(4, 0)
    kw = {} if case == "simple" else TIGHT
    sol = admm_solve(t_qp(arr), settings=ADMMSettings(**kw))
    for b in range(arr["h"].shape[0]):
        js = j_admm_solve(j_qp(arr, b), settings=JADMMSettings(**kw))
        assert int(sol.status[b]) == int(js.status) == st.SOLVED
        assert int(sol.iters[b]) == int(js.iters)
        for f in ("x", "y", "y_box"):
            np.testing.assert_allclose(getattr(sol, f)[b].numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-9, atol=1e-9, err_msg=f)
        # the adaptive penalty is a ratio of residuals, which sit at the
        # rounding floor at the tight tolerance: it agrees to 1e-2 there
        np.testing.assert_allclose(sol.rho[b].numpy(), np.asarray(js.rho),
                                   rtol=1e-4 if case == "simple" else 1e-2)
    if case == "simple":
        np.testing.assert_allclose(sol.x[0].numpy(), [0.3, 0.7], atol=1e-2)


@pytest.mark.parametrize("seed", [1, 2])
def test_vjp_cotangents_match_jax(seed):
    B = 4
    arr = random_qps(B, seed, eq_rows=2)
    rng = np.random.default_rng(100 + seed)
    wx, wy, wb = (rng.normal(size=arr[k].shape[:2]) for k in ("h", "al",
                                                              "xl"))
    qp = t_qp(arr, requires_grad=True)
    sol = box_admm_solve(qp, settings=ADMMSettings(**TIGHT))
    loss = (torch.sum(sol.x * torch.tensor(wx))
            + torch.sum(sol.y * torch.tensor(wy))
            + torch.sum(sol.y_box * torch.tensor(wb)))
    grads = torch.autograd.grad(loss, list(qp))
    js_settings = JADMMSettings(**TIGHT)
    n_active = 0
    for b in range(B):
        def f(q):
            s = j_box_admm_solve(q, settings=js_settings)
            return s.x, s.y, s.y_box
        (jx, _, _), vjp = jax.vjp(f, j_qp(arr, b))
        np.testing.assert_allclose(sol.x[b].detach().numpy(),
                                   np.asarray(jx), rtol=1e-9, atol=1e-10)
        (jbar,) = vjp((jnp.asarray(wx[b]), jnp.asarray(wy[b]),
                       jnp.asarray(wb[b])))
        for f_name, g in zip(QPData._fields, grads):
            want = np.asarray(getattr(jbar, f_name))
            scale = max(np.abs(want).max(), 1.0)
            assert np.abs(g[b].numpy() - want).max() / scale < 1e-7, f_name
        x = np.asarray(jx)
        n_active += int(((x - arr["xl"][b] <= 1e-7)
                         | (arr["xu"][b] - x <= 1e-7)).sum())
    assert n_active > 0   # the box cotangents were exercised


def test_vjp_matches_finite_differences():
    """d x[0] / d h[0] on the canonical QP with an inactive box."""
    arr = simple()
    arr["xu"] = np.array([[10.0, 10.0]])
    s = ADMMSettings(**TIGHT)

    def solve_x0(h1, grad=False):
        a = {k: v.copy() for k, v in arr.items()}
        qp = t_qp(a)
        h = torch.tensor([[h1, 1.0]], dtype=torch.float64,
                         requires_grad=grad)
        return box_admm_solve(qp._replace(h=h), settings=s).x[0, 0], h

    x0, h = solve_x0(1.0, grad=True)
    (g,) = torch.autograd.grad(x0, h)
    eps = 1e-4
    fd = (solve_x0(1.0 + eps)[0] - solve_x0(1.0 - eps)[0]) / (2 * eps)
    np.testing.assert_allclose(g[0, 0].item(), fd.item(), atol=1e-3)


def test_solve_without_grad_takes_the_plain_path(monkeypatch):
    """No field requires grad (or grad is off): the raw solve runs and the
    autograd.Function is never entered; with a field requiring grad it is."""
    entered = []
    apply = box_admm._ImplicitQP.apply

    def spy(*a):
        entered.append(1)
        return apply(*a)
    monkeypatch.setattr(box_admm._ImplicitQP, "apply", spy)
    arr = random_qps(2, 3)
    plain = box_admm_solve(t_qp(arr))
    assert not entered and not plain.x.requires_grad
    with torch.no_grad():
        box_admm_solve(t_qp(arr, requires_grad=True))
    assert not entered
    graded = box_admm_solve(t_qp(arr, requires_grad=True))
    assert entered == [1] and graded.x.requires_grad
    np.testing.assert_array_equal(graded.x.detach().numpy(),
                                  plain.x.numpy())
    np.testing.assert_array_equal(graded.status.numpy(),
                                  plain.status.numpy())
