"""The plain reference's collocation NLP, KKT residual and plant.

Everything here is float64 PyTorch (or float32 where a control asks for a
lower precision), written from the mathematics and independent of the
program under test:

* Chebyshev-Gauss-Lobatto nodes on [-1, 1], ascending, with the classic
  closed-form differentiation matrix (negative-sum diagonal) and the
  Clenshaw-Curtis weights (Trefethen, *Spectral Methods in MATLAB*,
  ``cheb.m`` and ``clencurt.m``);
* S segments sharing their boundary node; at a shared node the defect row is
  the left segment's one-sided derivative, and node 0 has its own row;
* one lane's decision vector z = [X (N*nx, node-major); U (N*nu)] in scaled
  units (physical = scale * z), defects Dg X~ - h f(x, u) / sx with
  h = (tf - t0) / (2 S), cost h * sum_k w_k L(x_k, u_k) + Mayer(x_{N-1});
* the unscaled KKT error: stationarity |grad f + J' lam + lam_box|_inf, the
  worst violation of the rows (all equalities) and of the box, and the worst
  complementarity |dual| * distance to the nearer finite bound;
* the SQP's own stopping quantities at a point: its infinity-norm violation,
  the stationarity and the dual scale max(1, |lam|_inf, |lam_box|_inf), and
  the objective;
* a classical RK4 plant.

``precision`` is "fp64" (the reference), "fp32" (every operation in
float32) or "tf32" (float32 with the operands of every matrix product,
the quadrature's weighted sum among them, rounded to TF32's 10-bit
mantissa, as the tensor cores round them).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, jacrev, vmap

PRECISIONS = ("fp64", "fp32", "tf32")


def cgl_diff(order: int):
    """Ascending Chebyshev-Gauss-Lobatto nodes x_j = -cos(pi j / N) and the
    (N+1, N+1) differentiation matrix on [-1, 1]."""
    n = order
    j = np.arange(n + 1)
    x = -np.cos(np.pi * j / n)
    c = np.where((j == 0) | (j == n), 2.0, 1.0) * (-1.0) ** j
    dx = x[:, None] - x[None, :]
    D = np.outer(c, 1.0 / c) / (dx + np.eye(n + 1))
    D -= np.diag(D.sum(axis=1))
    return x, D


def clenshaw_curtis(order: int) -> np.ndarray:
    """Clenshaw-Curtis weights at the CGL nodes (symmetric, so the node order
    does not matter)."""
    n = order
    theta = np.pi * np.arange(n + 1) / n
    w = np.zeros(n + 1)
    v = np.ones(n - 1)
    inner = theta[1:n]
    if n % 2 == 0:
        w[0] = w[n] = 1.0 / (n * n - 1)
        for k in range(1, n // 2):
            v -= 2.0 * np.cos(2 * k * inner) / (4 * k * k - 1)
        v -= np.cos(n * inner) / (n * n - 1)
    else:
        w[0] = w[n] = 1.0 / (n * n)
        for k in range(1, (n - 1) // 2 + 1):
            v -= 2.0 * np.cos(2 * k * inner) / (4 * k * k - 1)
    w[1:n] = 2.0 * v / n
    return w


def composite(order: int, segments: int):
    """Global differentiation matrix and quadrature weights of ``segments``
    unit segments (each of length 2) sharing boundary nodes."""
    _, D = cgl_diff(order)
    w = clenshaw_curtis(order)
    N = order * segments + 1
    Dg = np.zeros((N, N))
    wg = np.zeros(N)
    for s in range(segments):
        i0 = s * order
        r0 = 1 if s > 0 else 0
        Dg[i0 + r0:i0 + order + 1, i0:i0 + order + 1] = D[r0:]
        wg[i0:i0 + order + 1] += w
    return Dg, wg


def round_tf32(t):
    """float32 rounded to nearest at TF32's 10 explicit mantissa bits (the
    tensor cores' input rounding), by Veltkamp's split with 2^13 + 1: plain
    arithmetic, which ``vmap`` batches."""
    c = t * 8193.0
    return c - (c - t)


def _dtype(precision):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    return torch.float64 if precision == "fp64" else torch.float32


class CollocationNLP:
    """One OCP on Chebyshev(order) x segments: the lane functions and their
    batched evaluation.  ``model`` has nx, nu, dynamics(x, u),
    lagrange(x, u) and mayer(x), physical units, one node at a time."""

    def __init__(self, model, order, segments, t0, tf, x_scale=None,
                 u_scale=None):
        self.model = model
        self.nx, self.nu = model.nx, model.nu
        self.N = order * segments + 1
        self.n = self.N * (self.nx + self.nu)
        self.m = self.N * self.nx
        Dg, wg = composite(order, segments)
        self.h = (tf - t0) / (2.0 * segments)
        self._np = {"Dg": Dg, "w": wg,
                    "sx": np.ones(self.nx) if x_scale is None
                    else np.asarray(x_scale, np.float64),
                    "su": np.ones(self.nu) if u_scale is None
                    else np.asarray(u_scale, np.float64)}
        self._cache = {}

    def const(self, name, dtype, device):
        key = (name, dtype, torch.device(device))
        t = self._cache.get(key)
        if t is None:
            t = torch.as_tensor(self._np[name], dtype=dtype, device=device)
            self._cache[key] = t
        return t

    def split(self, z):
        N, nx, nu = self.N, self.nx, self.nu
        X = z[..., :N * nx].reshape(*z.shape[:-1], N, nx)
        U = z[..., N * nx:N * (nx + nu)].reshape(*z.shape[:-1], N, nu)
        return X, U

    def physical(self, z):
        """Scaled z (..., n) -> physical X (..., N, nx), U (..., N, nu)."""
        X, U = self.split(z)
        sx = self.const("sx", z.dtype, z.device)
        su = self.const("su", z.dtype, z.device)
        return X * sx, U * su

    def lane_fns(self, dtype, device, precision):
        """(cost(z), constraints(z)) of one lane, z (n,)."""
        Dg = self.const("Dg", dtype, device)
        w = self.const("w", dtype, device)
        sx = self.const("sx", dtype, device)
        su = self.const("su", dtype, device)
        if precision == "tf32":
            Dg = round_tf32(Dg)
        model, h, nx, nu, N = self.model, self.h, self.nx, self.nu, self.N

        def parts(z):
            Xs = z[:N * nx].reshape(N, nx)
            Us = z[N * nx:].reshape(N, nu)
            return Xs, Xs * sx, Us * su

        def constraints(z):
            Xs, x, u = parts(z)
            f = vmap(model.dynamics)(x, u)
            if precision == "tf32":
                Xs = round_tf32(Xs)
            return (Dg @ Xs - h * f / sx).reshape(N * nx)

        def cost(z):
            _, x, u = parts(z)
            L = vmap(model.lagrange)(x, u)
            wq = w
            if precision == "tf32":
                wq, L = round_tf32(w), round_tf32(L)
            return h * (wq @ L) + model.mayer(x[N - 1])
        return cost, constraints

    def evaluate(self, z, precision="fp64"):
        """(g (B, n), c (B, m), J (B, m, n)) at the lanes z (B, n)."""
        dt = _dtype(precision)
        z = z.to(dt)
        cost, con = self.lane_fns(dt, z.device, precision)
        return vmap(grad(cost))(z), vmap(con)(z), vmap(jacrev(con))(z)

    def costs(self, z, precision="fp64"):
        """The objective (B,) at the lanes z (B, n)."""
        dt = _dtype(precision)
        z = z.to(dt)
        cost, _ = self.lane_fns(dt, z.device, precision)
        return vmap(cost)(z)

    def pinned_bounds(self, lbx, ubx, x0):
        """Per-lane box bounds (B, n) from the shared scaled bounds (n,) with
        node 0's states pinned to each lane's physical x0 (B, nx)."""
        B = x0.shape[0]
        sx = self.const("sx", x0.dtype, x0.device)
        lo = lbx.to(x0.dtype).expand(B, self.n).clone()
        up = ubx.to(x0.dtype).expand(B, self.n).clone()
        lo[:, :self.nx] = x0 / sx
        up[:, :self.nx] = x0 / sx
        return lo, up


def _amax(v):
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return torch.clamp(torch.amax(v, dim=-1), min=0.0)


def _jt_lam(J, lam, precision):
    Jt = J.transpose(1, 2)
    if precision == "tf32":
        Jt, lam = round_tf32(Jt), round_tf32(lam)
    return (Jt @ lam[..., None])[..., 0]


def _box_distance(z, lo, up):
    inf = torch.full_like(z, float("inf"))
    d_lo = torch.where(torch.isfinite(lo), z - lo, inf)
    d_up = torch.where(torch.isfinite(up), up - z, inf)
    d = torch.minimum(torch.abs(d_lo), torch.abs(d_up))
    return torch.where(torch.isfinite(d), d, torch.zeros_like(d))


def stopping_parts(nlp, z, lam, lam_box, lo, up, precision="fp64"):
    """Per lane (B,) the KKT residual's three parts and the SQP's stopping
    quantities: dict of stationarity, feasibility, complementarity, kkt (the
    max of the three), violation (the SQP's infinity-norm violation) and
    lam_scale."""
    dt = _dtype(precision)
    z, lam, lam_box = z.to(dt), lam.to(dt), lam_box.to(dt)
    lo, up = lo.to(dt), up.to(dt)
    g, c, J = nlp.evaluate(z, precision)
    stat = _amax(torch.abs(g + _jt_lam(J, lam, precision) + lam_box))
    viol_x = _amax(torch.maximum(torch.clamp(z - up, min=0.0),
                                 torch.clamp(lo - z, min=0.0)))
    viol_c = _amax(torch.abs(c))
    feas = torch.maximum(viol_c, viol_x)
    comp = torch.maximum(_amax(torch.abs(lam) * torch.abs(c)),
                         _amax(torch.abs(lam_box) * _box_distance(z, lo, up)))
    lam_scale = torch.clamp(torch.maximum(_amax(torch.abs(lam)),
                                          _amax(torch.abs(lam_box))), min=1.0)
    return {"stationarity": stat, "feasibility": feas,
            "complementarity": comp,
            "kkt": torch.maximum(stat, torch.maximum(feas, comp)),
            "violation": feas, "lam_scale": lam_scale}


def rk4(f, x, u, dt: float, substeps: int):
    """x after ``dt`` seconds of x' = f(x, u) with u held, by ``substeps``
    classical Runge-Kutta steps."""
    h = dt / substeps
    for _ in range(substeps):
        k1 = f(x, u)
        k2 = f(x + 0.5 * h * k1, u)
        k3 = f(x + 0.5 * h * k2, u)
        k4 = f(x + h * k3, u)
        x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return x
