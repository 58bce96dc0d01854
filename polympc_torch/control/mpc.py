"""User-facing MPC facade — the port of polympc_tpu/control/mpc.py
(``MPC<OCP, Solver>``, mpc_wrapper.hpp:18-300).

A thin stateful layer over the batch-first solvers: it stores bounds,
guesses and static data as tensors on its device, and ``solve()`` runs one
``sqp_solve`` (or, with ``solver="ip"``, ``nlp_ip_solve``) call with one
lane, keeping primal and dual state between
calls for warm-started re-solves (mpc_wrapper.hpp:190-205,
sqp_base.hpp:613-615).  Results come back unbatched, as the JAX facade's
do.  Node 0 is t0, so the initial condition pins node 0.

For batches, call ``sqp_solve`` on the transcription directly
(``polympc_torch.parallel.make_batch_solver``).
"""
from __future__ import annotations

import torch

from polympc_torch.basis.basis import Chebyshev, SegmentedBasis
from polympc_torch.nlp.ip import IPNLPSettings, nlp_ip_solve
from polympc_torch.nlp.sqp import sqp_solve
from polympc_torch.nlp.types import NLPBounds, SQPSettings
from polympc_torch.ocp.ocp import OCP
from polympc_torch.ocp.transcription import pack_z, split_z, transcribe
from polympc_torch.utils.checkpoint import load_pytree, save_pytree

__all__ = ["MPC"]


class MPC:
    def __init__(self, ocp: OCP, mesh: SegmentedBasis | None = None,
                 t0: float = 0.0, tf: float = 1.0,
                 settings: SQPSettings | IPNLPSettings =
                 SQPSettings(hessian="exact"),
                 x_scale=None, u_scale=None, p_scale=None,
                 dtype=torch.float64, solver: str = "sqp",
                 device="cuda"):
        """solver: "sqp" (SQP + boxADMM, the reference's MPC default) or
        "ip" (the interior point, the reference's Ipopt-backed path,
        ipopt_interface.hpp:387-495)."""
        if solver not in ("sqp", "ip"):
            raise ValueError("solver must be 'sqp' or 'ip'")
        # settings/solver consistency: only the untouched default
        # SQPSettings is replaced by IPNLPSettings() for solver="ip";
        # explicitly tuned settings of the wrong type are an error
        if solver == "ip" and not isinstance(settings, IPNLPSettings):
            if settings == SQPSettings(hessian="exact"):
                settings = IPNLPSettings()
            else:
                raise TypeError(
                    "solver='ip' requires IPNLPSettings; got explicitly "
                    f"configured {type(settings).__name__}")
        if solver == "sqp" and not isinstance(settings, SQPSettings):
            raise TypeError(
                "solver='sqp' requires SQPSettings; got "
                f"{type(settings).__name__}")
        self.solver = solver
        self.ocp = ocp
        self.mesh = mesh if mesh is not None else SegmentedBasis(
            Chebyshev(5), 2)
        self.tr = transcribe(ocp, self.mesh, x_scale=x_scale,
                             u_scale=u_scale, p_scale=p_scale)
        self.settings = settings
        self.dtype = dtype
        self.device = torch.device(device)
        N, nx, nu, np_ = self.tr.N, ocp.nx, ocp.nu, ocp.np_
        full = lambda shape, v: torch.full(shape, v, dtype=dtype,
                                           device=self.device)
        inf = float("inf")
        # per-node trajectory bounds (mpc_wrapper.hpp:103-181)
        self._Xl, self._Xu = full((N, nx), -inf), full((N, nx), inf)
        self._Ul, self._Uu = full((N, nu), -inf), full((N, nu), inf)
        self._pl, self._pu = full((np_,), -inf), full((np_,), inf)
        self._gl, self._gu = full((ocp.ng,), -inf), full((ocp.ng,), inf)
        self._x0 = None
        self._x0_relax = None
        self._d = full((ocp.nd,), 0.0)
        self._t0 = torch.as_tensor(t0, dtype=dtype, device=self.device)
        self._tf = torch.as_tensor(tf, dtype=dtype, device=self.device)
        self._z = self.tr.initial_guess(dtype=dtype, device=self.device)
        self._lam = full((self.tr.nlp.m,), 0.0)
        self._lam_box = full((self.tr.nlp.n,), 0.0)
        self._solution = None

    def _t(self, v):
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def _scale(self, which):
        return self._t(getattr(self.tr, which))

    # ---- bound management (mpc_wrapper.hpp:103-181) ----
    def control_bounds(self, lbu, ubu):
        N = self.tr.N
        self._Ul = self._t(lbu)[None].repeat(N, 1)
        self._Uu = self._t(ubu)[None].repeat(N, 1)

    def state_bounds(self, lbx, ubx):
        N = self.tr.N
        self._Xl = self._t(lbx)[None].repeat(N, 1)
        self._Xu = self._t(ubx)[None].repeat(N, 1)

    def state_trajectory_bounds(self, Xl, Xu):
        """Per-node (N, nx) state bounds (mpc_wrapper.hpp:121-139)."""
        self._Xl = self._t(Xl)
        self._Xu = self._t(Xu)

    def control_trajectory_bounds(self, Ul, Uu):
        self._Ul = self._t(Ul)
        self._Uu = self._t(Uu)

    def final_state_bounds(self, lbxf, ubxf):
        self._Xl = self._Xl.clone()
        self._Xu = self._Xu.clone()
        self._Xl[-1] = self._t(lbxf)
        self._Xu[-1] = self._t(ubxf)

    def parameters_bounds(self, lbp, ubp):
        self._pl = self._t(lbp)
        self._pu = self._t(ubp)

    def constraints_bounds(self, gl, gu):
        self._gl = self._t(gl)
        self._gu = self._t(gu)

    def set_static_parameters(self, d):
        self._d = self._t(d)

    def set_time_limits(self, t0, tf):
        """Runtime horizon change (continuous_ocp.hpp:147)."""
        self._t0 = self._t(t0)
        self._tf = self._t(tf)

    def initial_conditions(self, x0, relax=None):
        """Pin the first state node to x0 (mpc_wrapper.hpp:89-99).

        relax: optional (nx,) per-state half-widths — state i's initial
        condition becomes the box [x0_i - relax_i, x0_i + relax_i] instead
        of an exact pin (the reference's NMPF relaxes its virtual path
        states this way, nmpf.hpp:456-466).
        """
        self._x0 = self._t(x0)
        self._x0_relax = None if relax is None else torch.abs(self._t(relax))

    # ---- warm-start guesses (mpc_wrapper.hpp:190-205) ----
    def x_guess(self, X):
        _, U, P = self._split(self._z)
        X = self._t(X) / self._scale("x_scale")
        if X.ndim == 1:
            X = X[None].repeat(self.tr.N, 1)
        else:
            X = X.reshape(self.tr.N, -1)
        self._z = pack_z(X, U, P)

    def u_guess(self, U):
        X, _, P = self._split(self._z)
        U = self._t(U) / self._scale("u_scale")
        if U.ndim == 1:
            U = U[None].repeat(self.tr.N, 1)
        self._z = pack_z(X, U, P)

    def p_guess(self, p):
        X, U, _ = self._split(self._z)
        self._z = pack_z(X, U, self._t(p) / self._scale("p_scale"))

    def lam_guess(self, lam):
        self._lam = self._t(lam)

    def _split(self, z):
        return split_z(z, self.ocp.nx, self.ocp.nu, self.tr.N, self.ocp.np_)

    # ---- checkpoint / resume (no reference analogue: the C++ warm start
    # lives only in memory, sqp_base.hpp:613-615) ----
    def warm_state(self):
        """The warm-start tuple: (z, lam, lam_box)."""
        return (self._z, self._lam, self._lam_box)

    def save_state(self, path):
        save_pytree(path, self.warm_state())

    def load_state(self, path):
        self._z, self._lam, self._lam_box = load_pytree(
            path, self.warm_state())

    # ---- solve ----
    def solve(self):
        N = self.tr.N
        sx, su, sp = (self._scale(k) for k in ("x_scale", "u_scale",
                                                "p_scale"))
        Xl, Xu = self._Xl.clone(), self._Xu.clone()
        if self._x0 is not None:
            if self._x0_relax is None:
                Xl[0] = self._x0
                Xu[0] = self._x0
            else:
                # relaxed IC box (nmpf.hpp:456-466): overwrites the global
                # state bounds at the initial node, like the reference
                Xl[0] = self._x0 - self._x0_relax
                Xu[0] = self._x0 + self._x0_relax
            # seed the guess's first state node with x0 (scaled internally)
            X, U, P = self._split(self._z)
            X = X.clone()
            X[0] = self._x0 / sx
            self._z = pack_z(X, U, P)
        lbx = torch.cat([(Xl / sx).reshape(-1), (self._Ul / su).reshape(-1),
                         self._pl / sp])
        ubx = torch.cat([(Xu / sx).reshape(-1), (self._Uu / su).reshape(-1),
                         self._pu / sp])
        bounds = NLPBounds(lbx=lbx, ubx=ubx, gl=self._gl.repeat(N),
                           gu=self._gu.repeat(N))
        prm = {"p": self._t(torch.zeros(self.ocp.np_)), "d": self._d,
               "t0": self._t0, "tf": self._tf}
        if self.solver == "ip":
            sol = nlp_ip_solve(self.tr.nlp, self._z[None], p=prm,
                               bounds=bounds, lam0=self._lam[None],
                               settings=self.settings)
        else:
            sol = sqp_solve(self.tr.nlp, self._z[None], p=prm,
                            bounds=bounds, lam0=self._lam[None],
                            lam_box0=self._lam_box[None],
                            settings=self.settings)
        sol = sol._replace(**{f: v[0] for f, v in zip(sol._fields, sol)
                              if v is not None})
        self._solution = sol
        self._z = sol.x
        self._lam = sol.lam
        self._lam_box = sol.lam_box
        return sol

    # ---- solution access (mpc_wrapper.hpp:230-295) ----
    @property
    def info(self):
        return self._solution

    def solution_x(self):
        return self.tr.unpack(self._solution.x)[0]

    def solution_u(self):
        return self.tr.unpack(self._solution.x)[1]

    def solution_p(self):
        return self.tr.unpack(self._solution.x)[2]

    def solution_x_at(self, t):
        """Lagrange-interpolated state at arbitrary t in [t0, tf]
        (mpc_wrapper.hpp:245-281)."""
        P = self.mesh.interp_matrix(t, float(self._t0), float(self._tf))
        return self._t(P) @ self.solution_x()

    def solution_u_at(self, t):
        P = self.mesh.interp_matrix(t, float(self._t0), float(self._tf))
        return self._t(P) @ self.solution_u()
