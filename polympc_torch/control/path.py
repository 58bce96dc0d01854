"""Path parametrisation and localisation for path-following NMPC — the
port of polympc_tpu/control/path.py.

  * ``spline_fit_qp_data`` / ``fit_spline_qp``: fit an equidistant cubic
    spline to samples as an equality-constrained least-squares QP
    (H = D D', h = -D y, continuity equalities; applications.rst:404-481),
    solved with boxADMM;
  * ``PathFrame`` / ``track_from_curvature``: a Cartesian path
    (X_c(s), Y_c(s), psi_c(s), kappa_c(s)) as splines;
  * ``project_on_path_newton``: the projection min_s ||p - p_c(s)||^2,
    0 <= s <= s_max, as a fixed number of clipped Newton steps, batch-first
    over (B,) points; ``project_on_path``: the same NLP through the dense
    SQP solver (the accuracy oracle);
  * ``frame_transform``: Cartesian (X, Y, psi) -> curvilinear (s, w, theta)
    (applications.rst:349-358).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from polympc_torch.basis.splines import (
    CubicSpline, _derivatives, cubic_spline_eval_np, fit_cubic_spline,
)
from polympc_torch.nlp.sqp import sqp_solve
from polympc_torch.nlp.types import NLP, NLPBounds, SQPSettings
from polympc_torch.qp.box_admm import box_admm_solve
from polympc_torch.qp.types import ADMMSettings, QPData

__all__ = ["fit_spline_qp", "spline_fit_qp_data", "PathFrame",
           "track_from_curvature", "frame_transform", "project_on_path",
           "project_on_path_newton"]


def _spline_fit_arrays(s, y, n_segments: int):
    """The spline-fitting QP as numpy float64 arrays
    (H, h, A, b, segment length)."""
    s = np.asarray(s, np.float64)
    y = np.asarray(y, np.float64)
    smax = s[-1] - s[0]
    h = smax / n_segments
    n = 4 * n_segments

    # sample matrix: row i = [1, ds, ds^2, ds^3] in the sample's segment
    seg = np.clip(((s - s[0]) / h).astype(int), 0, n_segments - 1)
    ds = s - s[0] - seg * h
    Dt = np.zeros((len(s), n))
    for k in range(4):
        Dt[np.arange(len(s)), 4 * seg + k] = ds ** k

    H = Dt.T @ Dt + 1e-9 * np.eye(n)
    hvec = -Dt.T @ y

    # continuity equalities at interior knots + initial value pin
    rows = []
    rhs = []
    r0 = np.zeros(n)
    r0[0] = 1.0
    rows.append(r0)
    rhs.append(y[0])
    for j in range(n_segments - 1):
        val = np.zeros(n)
        val[4 * j: 4 * j + 4] = [1.0, h, h ** 2, h ** 3]
        val[4 * (j + 1)] = -1.0
        rows.append(val)
        rhs.append(0.0)
        der = np.zeros(n)
        der[4 * j: 4 * j + 4] = [0.0, 1.0, 2 * h, 3 * h ** 2]
        der[4 * (j + 1) + 1] = -1.0
        rows.append(der)
        rhs.append(0.0)
    return H, hvec, np.stack(rows), np.asarray(rhs), h


def spline_fit_qp_data(s: np.ndarray, y: np.ndarray, n_segments: int,
                       dtype=torch.float64, device="cuda"):
    """Assemble the spline-fitting QP (applications.rst:430-481) in numpy
    float64 and return (QPData with a lane axis of 1, segment length h).

    The decision vector stacks 4 Horner coefficients per segment
    (n = 4*n_segments).  Objective 1/2||D'P - y||^2: H = D D', h = -D y,
    with D the block-diagonal Vandermonde of local offsets.  Equalities pin
    y(0) to the first sample and make value and first derivative continuous
    at the interior knots (applications.rst:414-424).
    """
    H, hvec, A, b, h = _spline_fit_arrays(s, y, n_segments)
    n = 4 * n_segments
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)[None]
    qp = QPData(H=t(H), h=t(hvec), A=t(A), al=t(b), au=t(b),
                xl=t(np.full(n, -np.inf)), xu=t(np.full(n, np.inf)))
    return qp, h


def fit_spline_qp(s, y, n_segments: int,
                  settings: ADMMSettings | None = None,
                  dtype=torch.float64, device="cuda") -> CubicSpline:
    """Fit an equidistant cubic spline by solving the constrained LS QP
    with boxADMM (the reference solves the same QP with its ADMM solver,
    applications.rst:483-484)."""
    settings = settings or ADMMSettings(rho=0.1, eps_abs=1e-8, eps_rel=1e-8,
                                        max_epochs=40, equil_iters=4)
    qp, h = spline_fit_qp_data(s, y, n_segments, dtype=dtype, device=device)
    sol = box_admm_solve(qp, settings=settings)
    coeffs = sol.x[0].detach().cpu().numpy().reshape(n_segments, 4)
    return CubicSpline(x0=float(np.asarray(s)[0]), h=float(h),
                       coeffs=coeffs, device=device)


@dataclasses.dataclass(frozen=True)
class PathFrame:
    """A Cartesian track centerline parametrised by arc length s."""
    Xc: CubicSpline
    Yc: CubicSpline
    psi_c: CubicSpline
    kappa: CubicSpline
    s_max: float

    @property
    def device(self):
        return self.Xc.device

    def position(self, s):
        """(..., 2) centerline points at arc lengths s (...)."""
        return torch.stack([self.Xc(s), self.Yc(s)], dim=-1)


def track_from_curvature(kappa: CubicSpline, s_max: float,
                         n_samples: int = 1001, x0=(0.0, 0.0),
                         psi0: float = 0.0, device="cuda") -> PathFrame:
    """Integrate a curvature profile into a Cartesian centerline:
    psi_c' = kappa(s), X_c' = cos(psi_c), Y_c' = sin(psi_c) (build-time
    numpy quadrature; fine grid + trapezoid)."""
    s = np.linspace(0.0, s_max, n_samples)
    kap = cubic_spline_eval_np(kappa, s)
    psi = psi0 + np.concatenate([[0.0], np.cumsum(
        0.5 * (kap[1:] + kap[:-1]) * np.diff(s))])
    cx = np.cos(psi)
    sx = np.sin(psi)
    X = x0[0] + np.concatenate([[0.0], np.cumsum(
        0.5 * (cx[1:] + cx[:-1]) * np.diff(s))])
    Y = x0[1] + np.concatenate([[0.0], np.cumsum(
        0.5 * (sx[1:] + sx[:-1]) * np.diff(s))])
    hs = s[1] - s[0]
    return PathFrame(Xc=fit_cubic_spline(0.0, hs, X, device=device),
                     Yc=fit_cubic_spline(0.0, hs, Y, device=device),
                     psi_c=fit_cubic_spline(0.0, hs, psi, device=device),
                     kappa=kappa, s_max=float(s_max))


def _points(path: PathFrame, point, dtype):
    return torch.as_tensor(point, dtype=dtype, device=path.device)


def _grid_seed(path: PathFrame, point, n_grid, dtype):
    """Per-lane best of n_grid equally spaced arc lengths, point (B, 2)."""
    grid = torch.linspace(0.0, path.s_max, n_grid, dtype=dtype,
                          device=path.device)
    d2 = torch.sum((path.position(grid)[None] - point[:, None]) ** 2, dim=-1)
    return grid[torch.argmin(d2, dim=1)]


def _projection_nlp(path: PathFrame) -> NLP:
    def cost(z, p):
        d = path.position(z[:, 0]) - p
        return torch.sum(d * d, dim=-1)
    return NLP(cost=cost, n=1)


def project_on_path(path: PathFrame, point, s0=None,
                    settings: SQPSettings | None = None,
                    n_grid: int = 64, dtype=torch.float64):
    """min_s ||p - p_c(s)||^2 s.t. 0 <= s <= s_max for one point (2,) via
    the dense SQP solver (the reference's frame-transform NLP,
    applications.rst:495-505), as a one-lane batch.

    Warm-startable: pass the previous s as s0 (the per-control-step usage);
    otherwise a coarse grid scan seeds the solve.  Returns (s_star, sol).
    """
    point = _points(path, point, dtype)
    if s0 is None:
        s0 = _grid_seed(path, point[None], n_grid, dtype)[0]
    bounds = NLPBounds(
        lbx=torch.zeros(1, dtype=dtype, device=path.device),
        ubx=torch.full((1,), path.s_max, dtype=dtype, device=path.device),
        gl=torch.zeros(0, dtype=dtype, device=path.device),
        gu=torch.zeros(0, dtype=dtype, device=path.device))
    settings = settings or SQPSettings(
        hessian="exact", max_iter=12,
        qp=ADMMSettings(rho=1.0, eps_abs=1e-9, eps_rel=1e-9, max_epochs=8))
    z0 = torch.as_tensor(s0, dtype=dtype, device=path.device).reshape(1, 1)
    sol = sqp_solve(_projection_nlp(path), z0, p=point, bounds=bounds,
                    settings=settings)
    return sol.x[0, 0], sol


def project_on_path_newton(path: PathFrame, point, s0=None,
                           n_newton: int = 6, n_grid: int = 128,
                           dtype=torch.float64):
    """min_s ||p - p_c(s)||^2, 0 <= s <= s_max, by a grid seed (or the
    caller's previous s) and ``n_newton`` clipped Newton steps — the
    latency-class solver for the frame-transform NLP.

    point (B, 2) or (2,); s0 (B,), a scalar or None.  Returns s* (B,) (or a
    0-dim tensor for one point).  Each step is projected onto [0, s_max];
    where the curvature of the distance is not positive the step is a
    gradient step; no step is longer than 0.1 * s_max.  The derivatives
    are those of the cubic pieces, what automatic differentiation of the
    spline evaluation gives.
    """
    point = _points(path, point, dtype)
    single = point.dim() == 1
    point = point.reshape(-1, 2)
    if s0 is None:
        s = _grid_seed(path, point, n_grid, dtype)
    else:
        s = torch.as_tensor(s0, dtype=dtype, device=path.device).reshape(-1)
        s = s.expand(point.shape[0]).clone()
    max_step = 0.1 * path.s_max
    for _ in range(n_newton):
        X, dX, ddX = _derivatives(path.Xc, s)
        Y, dY, ddY = _derivatives(path.Yc, s)
        ex, ey = X - point[:, 0], Y - point[:, 1]
        g = 2.0 * (ex * dX + ey * dY)
        h = 2.0 * (dX * dX + ex * ddX + dY * dY + ey * ddY)
        step = g / torch.where(h > 1e-9, h, torch.ones_like(h))
        s = torch.clamp(s - torch.clamp(step, -max_step, max_step),
                        0.0, path.s_max)
    return s[0] if single else s


def frame_transform(path: PathFrame, X, Y, psi, s0=None,
                    dtype=torch.float64, method: str = "newton"):
    """Cartesian pose -> curvilinear (s, w, theta)
    (applications.rst:349-358).

    w > 0 left of the centerline; theta = psi - psi_c wrapped to
    [-pi, pi).  X, Y, psi are scalars or (B,) tensors for
    ``method="newton"`` (the projected-Newton projection); ``method="sqp"``
    projects one pose through the dense SQP solver.
    """
    X, Y, psi = (_points(path, v, dtype) for v in (X, Y, psi))
    pts = torch.stack([X, Y], dim=-1)
    if method == "newton":
        s = project_on_path_newton(path, pts, s0=s0, dtype=dtype)
    elif method == "sqp":
        s, _ = project_on_path(path, pts, s0=s0, dtype=dtype)
    else:
        raise ValueError(f"method must be 'newton' or 'sqp', got {method!r}")
    psic = path.psi_c(s)
    w = (Y - path.Yc(s)) * torch.cos(psic) - (X - path.Xc(s)) * torch.sin(
        psic)
    theta = torch.remainder(psi - psic + math.pi, 2 * math.pi) - math.pi
    return s, w, theta
