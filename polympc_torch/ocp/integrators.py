"""ODE integrators — the port of polympc_tpu/ocp/integrators.py.

  - ``rk4_step`` / ``rk4_integrate``: explicit RK4 (the reference's
    ``ODESolver`` RK4, src/integration/integrator.cpp:68-111), one
    trajectory;
  - ``implicit_integrate``: trapezoidal rule with a fixed-iteration
    exact-Jacobian Newton corrector (stiff-capable);
  - ``radau_integrate``: Radau IIA collocation (stiffly accurate,
    L-stable);
  - ``adaptive_integrate``: TR-BDF2 with embedded error control (the
    CVODES analogue);
  - ``ps_integrate``: damped Newton on the square pseudospectral system
    D X = scale * f(X) with the initial row pinned (``PSODESolver``).

The implicit integrators are batch-first: ``x0`` is (nx,) or (B, nx) and
the result carries the same leading axis.  ``f(x, u, t)`` acts on one lane
(x (nx,), t a 0-dim tensor) and runs over the lanes with
``torch.func.vmap``; its Jacobians come from ``torch.func.jacrev``.  ``u``
is None, a constant control (nu,), or a per-step sequence, shared by all
lanes, as in the JAX package.  ``adaptive_integrate`` replaces the JAX
``lax.while_loop`` by a loop over the lanes still running: each lane keeps
its own step size, accept/reject history and save index, and in float64
its accepted and rejected step counts equal the JAX package's.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jacrev, vmap

from polympc_torch.basis.basis import SegmentedBasis
from polympc_torch.utils.precision import full_precision

__all__ = ["rk4_step", "rk4_integrate", "implicit_integrate",
           "radau_integrate", "adaptive_integrate", "ps_integrate"]


def rk4_step(f, x, u, t, h):
    """One classical Runge-Kutta-4 step (ref: integrator.cpp:68-91)."""
    k1 = f(x, u, t)
    k2 = f(x + 0.5 * h * k1, u, t + 0.5 * h)
    k3 = f(x + 0.5 * h * k2, u, t + 0.5 * h)
    k4 = f(x + h * k3, u, t + h)
    return x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def rk4_integrate(f, x0, t0, tf, num_steps: int, u=None):
    """Integrate x' = f(x, u, t) over [t0, tf] with num_steps RK4 steps.

    u: None, a constant control vector, or a (num_steps, nu) sequence
    (zero-order hold per step).  Returns the (num_steps+1, nx) trajectory
    in the dtype and on the device of x0.
    """
    x = torch.as_tensor(x0)
    h = (tf - t0) / num_steps
    f_, U = _controls(f, u, num_steps, x)
    traj = [x]
    for k in range(num_steps):
        x = rk4_step(f_, x, U[k], t0 + k * h, h)
        traj.append(x)
    return torch.stack(traj)


def _lanes(x0):
    """x0 as (B, nx) and whether the caller gave one trajectory."""
    x = torch.as_tensor(x0)
    return (x[None], True) if x.ndim == 1 else (x, False)


def _controls(f, u, steps, x):
    """(f_ (x, u, t) on one lane, U (steps, nu)) from the JAX package's
    control conventions."""
    if u is None:
        return (lambda xx, u_, t: f(xx, None, t)), x.new_zeros((steps, 0))
    u = torch.as_tensor(u, dtype=x.dtype, device=x.device)
    return f, (u.expand(steps, *u.shape) if u.ndim == 1 else u)


def _out(traj, single):
    """Stack per-step (B, nx) states into (B, steps+1, nx), or drop the
    lane axis of one trajectory."""
    X = torch.stack(traj, dim=1)
    return X[0] if single else X


@full_precision()
def implicit_integrate(f, x0, t0, tf, num_steps: int, u=None,
                       newton_iters: int = 8):
    """Stiff-capable trapezoidal integration with a Newton corrector.

    Solves  x_{k+1} = x_k + h/2 (f(x_k) + f(x_{k+1}))  per step with
    ``newton_iters`` exact-Jacobian Newton iterations, warm started from an
    explicit Euler predictor.  Returns the (num_steps+1, nx) trajectory,
    or (B, num_steps+1, nx) for x0 (B, nx).
    """
    x, single = _lanes(x0)
    B, nx = x.shape
    h = (tf - t0) / num_steps
    f_, U = _controls(f, u, num_steps, x)
    In = torch.eye(nx, dtype=x.dtype, device=x.device)
    fb = vmap(f_, in_dims=(0, None, None))
    jb = vmap(jacrev(f_), in_dims=(0, None, None))
    traj = [x]
    for k in range(num_steps):
        t = torch.as_tensor(t0 + k * h, dtype=x.dtype, device=x.device)
        uk = U[k]
        fx = fb(x, uk, t)
        xn = x + h * fx
        for _ in range(newton_iters):
            g = xn - x - 0.5 * h * (fx + fb(xn, uk, t + h))
            J = In - 0.5 * h * jb(xn, uk, t + h)
            xn = xn - torch.linalg.solve(J, g)
        x = xn
        traj.append(x)
    return _out(traj, single)


@full_precision()
def radau_integrate(f, x0, t0, tf, num_steps: int, order: int = 3, u=None,
                    newton_iters: int = 10):
    """Radau IIA collocation integrator: stiffly accurate and L-stable.

    Per step of size h: stages at the flipped Legendre-Gauss-Radau points
    (c_s = 1, s = order+1); the defect D_aug @ [x_k; X] = (h/2) f(X) is
    enforced at the stage rows by a fixed-iteration exact-Jacobian Newton
    solve, and the last stage is the step's endpoint.  Order 2s-1.
    Returns the (num_steps+1, nx) trajectory of step endpoints, or
    (B, num_steps+1, nx) for x0 (B, nx).
    """
    from polympc_torch.basis.nodes import diff_matrix, lgr_nodes
    stages, _ = lgr_nodes(order, flip=True)
    s_n = stages.shape[0]
    D_aug = diff_matrix(np.concatenate([[-1.0], stages]))
    x, single = _lanes(x0)
    B, nx = x.shape
    c = lambda a: torch.as_tensor(a, dtype=x.dtype, device=x.device)
    D0, DS = c(D_aug[1:, 0]), c(D_aug[1:, 1:])
    c_t = c((stages + 1.0) * 0.5)
    h = (tf - t0) / num_steps
    f_, U = _controls(f, u, num_steps, x)

    def residual(Xf, xk, uk, ts):
        X = Xf.reshape(s_n, nx)
        F = vmap(f_, in_dims=(0, None, 0))(X, uk, ts)
        return (D0[:, None] * xk[None, :] + DS @ X - 0.5 * h * F
                ).reshape(-1)

    rb = vmap(residual, in_dims=(0, 0, None, None))
    jb = vmap(jacrev(residual), in_dims=(0, 0, None, None))
    traj = [x]
    for k in range(num_steps):
        t = c(t0 + k * h)
        ts = t + c_t * h
        uk = U[k]
        Xf = x.repeat(1, s_n)
        for _ in range(newton_iters):
            r = rb(Xf, x, uk, ts)
            Xf = Xf - torch.linalg.solve(jb(Xf, x, uk, ts), r)
        x = Xf.reshape(B, s_n, nx)[:, -1]
        traj.append(x)
    return _out(traj, single)


# TR-BDF2 constants (Hosea & Shampine, MATLAB's ode23tb): gamma, the shared
# diagonal d, the 3rd-order error quadrature through {0, gamma, 1}, and the
# BDF2 stage's combination
_G = 2.0 - np.sqrt(2.0)
_D = 1.0 - 1.0 / np.sqrt(2.0)
_W0 = 0.5 - 1.0 / (6.0 * _G)
_W1 = 1.0 / (6.0 * _G * (1.0 - _G))
_W2 = (1.0 / 3.0 - _G / 2.0) / (1.0 - _G)
_C2 = (1.0 - _G) ** 2 / (_G * (2.0 - _G))
_C1 = 1.0 / (_G * (2.0 - _G))


@full_precision()
def adaptive_integrate(f, x0, t0, tf, u=None, rtol: float = 1e-6,
                       atol: float = 1e-9, max_steps: int = 10_000,
                       newton_iters: int = 6, h0=None, ts=None):
    """Adaptive-step stiff integration: TR-BDF2 with embedded error control.

    Both implicit stages and the stiff error filter share the matrix
    M = I - d*h*J (d = 1 - 1/sqrt(2)), factored once per step attempt:

      stage 1 (TR):    x_g  - d*h*f(x_g)  = x_n + d*h*f(x_n)
      stage 2 (BDF2):  x_1  - d*h*f(x_1)  = (x_g - (1-g)^2 x_n) / (g*(2-g))
      error:           est  = M^-1 (x_n + h*(w0 f_n + w1 f_g + w2 f_1) - x_1)

    accepted when the weighted RMS norm is at most 1; step-size update
    0.9 * err^(-1/3) clipped to [0.2, 5] (at most 0.5 after a rejection).
    At most ``max_steps`` attempts per lane; modified Newton per stage
    (``newton_iters`` fixed iterations on the frozen factor).

    x0 (nx,) or (B, nx); u None or a constant control vector shared by the
    lanes.  ts: optional increasing save grid in (t0, tf], shared — steps
    land exactly on each save point; returns (xs (len(ts), nx), stats),
    else (x(tf), stats), with a leading lane axis for x0 (B, nx).
    stats = (n_accepted, n_rejected, success) per lane (0-dim for one
    trajectory), success False where max_steps was exhausted before tf.
    """
    x, single = _lanes(x0)
    B, nx = x.shape
    dt, dev = x.dtype, x.device
    if u is None:
        f_ = lambda xx, t: f(xx, None, t)
    else:
        uc = torch.as_tensor(u, dtype=dt, device=dev)
        f_ = lambda xx, t: f(xx, uc, t)
    fb = vmap(f_)
    jb = vmap(jacrev(f_))
    c = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    t0_, tf_ = c(t0), c(tf)
    span = tf_ - t0_
    tsave = tf_[None] if ts is None else c(ts)
    n_save = tsave.shape[0]
    h_init = span * 1e-3 if h0 is None else c(h0)
    tiny = float(np.finfo(np.float64).tiny * 1e10) if dt == torch.float64 \
        else 1e-30
    In = torch.eye(nx, dtype=dt, device=dev)

    def attempt(x, t, h):
        """One TR-BDF2 step of each lane (x (b, nx), t, h (b,)): the new
        state and the weighted error norm (inf where not finite)."""
        hc, dh = h[:, None], (_D * h)[:, None]
        fn = fb(x, t)
        M = In - (_D * h)[:, None, None] * jb(x, t)
        LU, piv = torch.linalg.lu_factor(M)
        solve = lambda r: torch.linalg.lu_solve(LU, piv, r[..., None])[..., 0]
        rhs1 = x + dh * fn
        tg = t + _G * h
        xg = x + (_G * hc) * fn
        for _ in range(newton_iters):
            xg = xg - solve(xg - dh * fb(xg, tg) - rhs1)
        fg = fb(xg, tg)
        rhs2 = _C1 * xg - _C2 * x
        t1 = t + h
        x1 = xg + ((1.0 - _G) * hc) * fg
        for _ in range(newton_iters):
            x1 = x1 - solve(x1 - dh * fb(x1, t1) - rhs2)
        f1 = fb(x1, t1)
        est = solve(x + hc * (_W0 * fn + _W1 * fg + _W2 * f1) - x1)
        sc = atol + rtol * torch.maximum(torch.abs(x), torch.abs(x1))
        err = torch.sqrt(torch.mean((est / sc) ** 2, dim=1))
        bad = ~torch.isfinite(x1).all(1)
        return x1, torch.where(bad, torch.full_like(err, float("inf")), err)

    S = {"x": x, "t": t0_.expand(B).clone(),
         "h": torch.minimum(h_init, tsave[0] - t0_).expand(B).clone(),
         "i": torch.zeros(B, dtype=torch.int64, device=dev),
         "xs": x.new_zeros((B, n_save, nx)),
         "acc": torch.zeros(B, dtype=torch.int32, device=dev),
         "rej": torch.zeros(B, dtype=torch.int32, device=dev),
         "k": torch.zeros(B, dtype=torch.int32, device=dev)}
    save_slot = torch.arange(n_save, device=dev)
    while True:
        idx = torch.nonzero((S["i"] < n_save) & (S["k"] < max_steps)
                            ).flatten()
        if idx.numel() == 0:
            break
        s = {k: v.index_select(0, idx) for k, v in S.items()}
        i_cl = torch.clamp(s["i"], max=n_save - 1)
        t_target = tsave[i_cl]
        h_try = torch.clamp(torch.minimum(s["h"], t_target - s["t"]),
                            min=tiny)
        x1, err = attempt(s["x"], s["t"], h_try)
        accept = err <= 1.0
        fac = torch.clamp(0.9 * torch.pow(torch.clamp(err, min=1e-16),
                                          -1.0 / 3.0), 0.2, 5.0)
        h_next = torch.where(accept, h_try * fac,
                             h_try * torch.clamp(fac, max=0.5))
        h_next = torch.minimum(h_next, span)
        t2 = torch.where(accept, s["t"] + h_try, s["t"])
        x2 = torch.where(accept[:, None], x1, s["x"])
        hit = accept & (t2 >= t_target - 1e-12 * torch.abs(span))
        put = (hit[:, None] & (save_slot[None] == i_cl[:, None]))[:, :, None]
        new = {"x": x2, "t": t2, "h": h_next,
               "i": s["i"] + hit.to(torch.int64),
               "xs": torch.where(put, x2[:, None, :], s["xs"]),
               "acc": s["acc"] + accept.to(torch.int32),
               "rej": s["rej"] + (~accept).to(torch.int32),
               "k": s["k"] + 1}
        for k, v in new.items():
            S[k] = S[k].index_copy(0, idx, v)
    stats = (S["acc"], S["rej"], S["i"] >= n_save)
    out = S["xs"][:, 0] if ts is None else S["xs"]
    if single:
        return out[0], tuple(v[0] for v in stats)
    return out, stats


@full_precision()
def ps_integrate(f, x0, t0, tf, mesh: SegmentedBasis, u=None,
                 newton_iters: int = 20, damping: float = 1.0):
    """Pseudospectral ODE solve: the trajectory X on the collocation grid
    with  Dg X = scale * f(X)  and X[0] = x0, by damped Newton on the square
    system (the role of PSODESolver's Ipopt solve,
    chebyshev_integrator.hpp:17-170).  Returns (X (N, nx), time grid (N,)),
    X (B, N, nx) for x0 (B, nx)."""
    x, single = _lanes(x0)
    B, nx = x.shape
    N, NS = mesh.num_nodes, mesh.num_segments
    dt, dev = x.dtype, x.device
    Dg = torch.as_tensor(mesh.composite_diff_matrix(0.0, 2.0 * NS),
                         dtype=dt, device=dev)
    t = t0 + (tf - t0) * torch.as_tensor(mesh.time_nodes(0.0, 1.0),
                                         dtype=dt, device=dev)
    scale = (tf - t0) / (2.0 * NS)
    f_, U = _controls(f, u, N, x)
    first = (torch.arange(N, device=dev) == 0)[:, None]

    def res_flat(Xf, xi):
        X = Xf.reshape(N, nx)
        R = Dg @ X - scale * vmap(f_)(X, U, t)
        # the first row is the initial condition
        return torch.where(first, X - xi[None, :], R).reshape(-1)

    rb = vmap(res_flat)
    jb = vmap(jacrev(res_flat))
    Xf = x.repeat(1, N)
    for _ in range(newton_iters):
        Xf = Xf - damping * torch.linalg.solve(jb(Xf, x), rb(Xf, x))
    X = Xf.reshape(B, N, nx)
    return (X[0] if single else X), t
