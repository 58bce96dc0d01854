"""Multiple-shooting transcription: OCP -> batch-first NLP — the port of
polympc_tpu/ocp/multiple_shooting.py.

The reference's ``MSChebyshev`` symbolic transcription
(src/chebyshev_ms.hpp:15-69): one constant control per segment, states only
at segment boundaries, per-segment RK4 shooting with a trapezoid Lagrange
term along each shot, and continuity equality constraints
x_{s+1} - Phi(x_s, u_s) = 0.

Decision vector of one lane: z = [X (NS+1, nx); U (NS, nu); P (np_,)].
Every NLP callable takes z (B, n); the B*NS shots of a batch run as one
``torch.func.vmap`` over (lane, segment) per RK4 stage.  As in the JAX
package the NLP carries no structured derivatives: the SQP and the certify
differentiate the whole vector (``nlp.sqp.derivative_fns``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.func import vmap

from polympc_torch.nlp.types import NLP, NLPBounds
from polympc_torch.ocp.integrators import rk4_step
from polympc_torch.ocp.ocp import OCP

__all__ = ["MSTranscription", "transcribe_ms", "ms_bounds"]


def _split_ms(z, nx, nu, NS, np_):
    """z (..., n) -> (X (..., NS+1, nx), U (..., NS, nu), P (..., np_))."""
    lead = z.shape[:-1]
    X = z[..., :(NS + 1) * nx].reshape(*lead, NS + 1, nx)
    U = z[..., (NS + 1) * nx:(NS + 1) * nx + NS * nu].reshape(*lead, NS, nu)
    P = z[..., (NS + 1) * nx + NS * nu:]
    return X, U, P


@dataclasses.dataclass(frozen=True)
class MSTranscription:
    ocp: OCP
    num_segments: int
    steps_per_segment: int
    nlp: NLP

    @property
    def n_vars(self) -> int:
        return self.nlp.n

    def split(self, z):
        """z (..., n) -> (X (..., NS+1, nx), U (..., NS, nu), P)."""
        return _split_ms(z, self.ocp.nx, self.ocp.nu, self.num_segments,
                         self.ocp.np_)

    def pack(self, X, U, P=None):
        lead = X.shape[:-2]
        parts = [X.reshape(*lead, -1), U.reshape(*lead, -1)]
        if P is not None and self.ocp.np_:
            parts.append(P.reshape(*lead, -1))
        return torch.cat(parts, dim=-1)

    def initial_guess(self, x0=None, dtype=torch.float64, device="cuda"):
        """x0 tiled over the NS+1 nodes (zeros without x0), zero controls
        and parameters: the (n,) decision vector, or (B, n) for x0 (B, nx).
        """
        NS, ocp = self.num_segments, self.ocp
        if x0 is None:
            X = torch.zeros((NS + 1, ocp.nx), dtype=dtype, device=device)
        else:
            x0 = torch.as_tensor(x0, dtype=dtype, device=device)
            X = x0[..., None, :].expand(*x0.shape[:-1], NS + 1, ocp.nx)
        lead = X.shape[:-2]
        U = torch.zeros((*lead, NS, ocp.nu), dtype=dtype, device=device)
        P = torch.zeros((*lead, ocp.np_), dtype=dtype, device=device)
        return self.pack(X, U, P)

    def params(self, p=None, d=None, t0=0.0, tf=1.0, dtype=torch.float64,
               device="cuda"):
        mk = lambda v, size: torch.zeros(size, dtype=dtype, device=device) \
            if v is None else torch.as_tensor(v, dtype=dtype, device=device)
        return {"p": mk(p, self.ocp.np_), "d": mk(d, self.ocp.nd),
                "t0": torch.as_tensor(t0, dtype=dtype, device=device),
                "tf": torch.as_tensor(tf, dtype=dtype, device=device)}


def transcribe_ms(ocp: OCP, num_segments: int,
                  steps_per_segment: int = 4) -> MSTranscription:
    """The multiple-shooting NLP of ``ocp``: NS segments of equal length,
    ``steps_per_segment`` RK4 steps each; ne = NS*nx continuity rows,
    ni = (NS+1)*ng node inequalities (the last node takes the last
    segment's control)."""
    NS, K = num_segments, steps_per_segment
    nx, nu, np_, ng = ocp.nx, ocp.nu, ocp.np_, ocp.ng
    n = (NS + 1) * nx + NS * nu + np_
    ne = NS * nx
    ni = (NS + 1) * ng

    def _segments(z, prm):
        """Per-shot arguments over (lane, segment): start states, controls,
        parameters (B*NS, .), start times (B*NS,), the step h, and B."""
        B = z.shape[0]
        X, U, P = _split_ms(z, nx, nu, NS, np_)
        seg_dt = (prm["tf"] - prm["t0"]) / NS
        ar = torch.arange(NS, dtype=z.dtype, device=z.device)
        t_s = prm["t0"] + seg_dt * ar
        return (X[:, :-1].reshape(B * NS, nx), U.reshape(B * NS, nu),
                P[:, None, :].expand(B, NS, np_).reshape(B * NS, np_),
                t_s[None, :].expand(B, NS).reshape(B * NS), seg_dt / K, B)

    def _shoot(xs, us, Ps, ts, h, d, with_cost):
        """RK4-shoot every segment (rows of xs); returns the end states and
        the trapezoid-integrated Lagrange term of each shot."""
        f = vmap(lambda x, u, p, t: ocp.dynamics(x, u, p, d, t))
        L = vmap(lambda x, u, p, t: ocp.lagrange(x, u, p, d, t))
        acc = xs.new_zeros(xs.shape[0])
        x = xs
        for k in range(K):
            t = ts + k * h
            if with_cost:
                l0 = L(x, us, Ps, t)
            x2 = rk4_step(lambda xx, uu, tt: f(xx, uu, Ps, tt), x, us, t, h)
            if with_cost:
                l1 = L(x2, us, Ps, t + h)
                acc = acc + 0.5 * h * (l0 + l1)
            x = x2
        return x, acc

    def eq_fn(z, prm):
        """Continuity X[1:] - Phi(X[:-1], U), (B, NS*nx) row-major."""
        xs, us, Ps, ts, h, B = _segments(z, prm)
        x_end, _ = _shoot(xs, us, Ps, ts, h, prm["d"], False)
        X = _split_ms(z, nx, nu, NS, np_)[0]
        return (X[:, 1:] - x_end.reshape(B, NS, nx)).reshape(B, ne)

    def cost_fn(z, prm):
        """Trapezoid Lagrange cost along the shots + Mayer at X[-1]."""
        B = z.shape[0]
        total = z.new_zeros(B)
        if ocp.lagrange is not None:
            xs, us, Ps, ts, h, _ = _segments(z, prm)
            _, costs = _shoot(xs, us, Ps, ts, h, prm["d"], True)
            total = total + costs.reshape(B, NS).sum(dim=1)
        if ocp.mayer is not None:
            X, _, P = _split_ms(z, nx, nu, NS, np_)
            d = prm["d"]
            total = total + vmap(lambda x, p: ocp.mayer(x, p, d))(X[:, -1], P)
        return total

    ineq_fn = None
    if ocp.ineq is not None:
        def ineq_fn(z, prm):
            """Node inequalities at the NS+1 nodes, the last node with the
            last segment's control."""
            B = z.shape[0]
            X, U, P = _split_ms(z, nx, nu, NS, np_)
            d = prm["d"]
            seg_dt = (prm["tf"] - prm["t0"]) / NS
            t_n = prm["t0"] + seg_dt * torch.arange(NS + 1, dtype=z.dtype,
                                                    device=z.device)
            U_ext = torch.cat([U, U[:, -1:]], dim=1)
            G = vmap(lambda x, u, p, t: ocp.ineq(x, u, p, d, t))(
                X.reshape(B * (NS + 1), nx), U_ext.reshape(B * (NS + 1), nu),
                P[:, None, :].expand(B, NS + 1, np_).reshape(
                    B * (NS + 1), np_),
                t_n[None, :].expand(B, NS + 1).reshape(B * (NS + 1)))
            return G.reshape(B, ni)

    nlp = NLP(cost=cost_fn, n=n, eq=eq_fn, ne=ne, ineq=ineq_fn, ni=ni)
    return MSTranscription(ocp=ocp, num_segments=NS, steps_per_segment=K,
                           nlp=nlp)


def ms_bounds(tr: MSTranscription, xl=None, xu=None, ul=None, uu=None,
              pl=None, pu=None, gl=None, gu=None, x0=None, xf=None,
              dtype=torch.float64, device="cuda") -> NLPBounds:
    """Bound assembly for the multiple-shooting layout (shared by all
    lanes): x0/xf pin the first/last state node, the other bounds broadcast
    over nodes and segments."""
    ocp, NS = tr.ocp, tr.num_segments
    inf = float("inf")

    def fill(v, size, default):
        if v is None:
            return torch.full((size,), default, dtype=dtype, device=device)
        return torch.as_tensor(v, dtype=dtype, device=device)

    Xl = fill(xl, ocp.nx, -inf)[None].repeat(NS + 1, 1)
    Xu = fill(xu, ocp.nx, inf)[None].repeat(NS + 1, 1)
    if x0 is not None:
        Xl[0] = Xu[0] = fill(x0, ocp.nx, 0.0)
    if xf is not None:
        Xl[-1] = Xu[-1] = fill(xf, ocp.nx, 0.0)
    lbx = torch.cat([Xl.reshape(-1), fill(ul, ocp.nu, -inf).repeat(NS),
                     fill(pl, ocp.np_, -inf)])
    ubx = torch.cat([Xu.reshape(-1), fill(uu, ocp.nu, inf).repeat(NS),
                     fill(pu, ocp.np_, inf)])
    GL = fill(gl, ocp.ng, -inf).repeat(NS + 1)
    GU = fill(gu, ocp.ng, inf).repeat(NS + 1)
    return NLPBounds(lbx=lbx, ubx=ubx, gl=GL, gu=GU)
