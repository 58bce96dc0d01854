"""Horizon (sequence) partitioning: Schur-complement condensation of the
segment-coupled KKT — the port of polympc_tpu/parallel/horizon.py without
a device mesh (one card), batch-first.

Every segment s owns a private variable block w_s; interface i glues
segments i and i+1 by  E w_i + F w_{i+1} [+ G_i mu_i] = c_i  (E picks the
tail of segment i, F minus the head of segment i+1), and an optional global
border g (optimised parameters) couples every segment through columns C_s
and rows  sum_s C_s' w_s + Dg g = bg.  Eliminating every w_i locally (a
dense solve or explicit inverse per segment) leaves a small dense interface
system in the multipliers mu ((S-1)*p unknowns, plus the a border
unknowns):

  - E K_i^{-1} F' mu_{i-1}
  - (E K_i^{-1} E' + F K_{i+1}^{-1} F') mu_i
  - F K_{i+1}^{-1} E' mu_{i+1}  =  c_i - E K_i^{-1} b_i - F K_{i+1}^{-1} b_{i+1}

Shapes carry a leading lane axis B: K (B, S, k, k), b (B, S, k), c
(B, S-1, p), G (B, S-1, p, p), C (B, S, k, a), Dg (B, a, a), bg (B, a);
the picks E, F (p, k) are shared.  Every lane is its own system.

With a ``mesh`` (a ``torch.distributed`` device mesh: :func:`horizon_mesh`,
or ``multihost.mesh_2d``), the per-segment elimination is split over the
processes of its ``axis`` group, the JAX package's ``shard_map`` form.  The
inputs are the whole arrays on every process (the caller's loop holds them
replicated); each of the n processes eliminates its own S/n consecutive
segments, the condensed blocks (XE, XF, w0, and XC with a border) are
``all_gather``ed over the group, the small interface system is solved on
every process alike, each back-substitutes its own segments, and w is
``all_gather``ed so every process returns the whole (B, S, k) solution.
c and C are inputs the processes already hold whole, so they cross no
wire.  S must be a multiple of n: the JAX ``shard_map`` path asks for
n == S, its GSPMD-composed ``make_batch_dist_solver`` for any multiple, and
the port takes the composed rule for both.  Without a mesh the same code
runs with every segment local and no collective.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from polympc_torch.ops.ldlt import ldlt_inverse
from polympc_torch.parallel.mesh import mesh_device_type
from polympc_torch.utils.precision import full_precision

__all__ = ["schur_horizon_solve", "schur_horizon_factor",
           "schur_horizon_apply", "assemble_dense_horizon", "horizon_mesh"]

KKT_SOLVERS = ("lu", "kernel")


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _interface_system(Sloc, E, F, SX, G=None, Dg=None, bg=None):
    """Build and solve the interface system of every lane from the condensed
    per-segment quantities (see :func:`_condense_local`).  Returns
    (mu (B, S-1, p), g (B, a))."""
    XE = Sloc["XE"]
    B, p = XE.shape[0], E.shape[0]
    a = 0 if Dg is None else Dg.shape[-1]
    if SX - 1 == 0 and a == 0:
        return XE.new_zeros((B, 0, p)), XE.new_zeros((B, 0))
    M = _interface_matrix(Sloc, E, F, SX, G=G, Dg=Dg)
    r = _interface_rhs(Sloc, E, F, SX, bg=bg)
    return _interface_split(torch.linalg.solve(M, r), SX, p, a)


def _interface_split(sol, SX, p, a):
    nI = SX - 1
    B = sol.shape[0]
    return sol[:, :nI * p].reshape(B, nI, p), sol[:, nI * p:nI * p + a]


def _interface_matrix(Sloc, E, F, SX, G=None, Dg=None):
    """The dense interface matrix of every lane (B, nI*p + a, nI*p + a),
    independent of the right-hand side, so factorising callers invert it
    once per epoch.  Its blocks are written by slice assignment: block row
    i holds -(E XE_i + F XF_{i+1} - G_i) on the diagonal, -E XF_i left of
    it and -F XE_{i+1} right of it."""
    XE, XF = Sloc["XE"], Sloc["XF"]
    B, p = XE.shape[0], E.shape[0]
    nI = SX - 1
    a = 0 if Dg is None else Dg.shape[-1]
    if nI == 0:
        if a:
            return Dg - torch.einsum("bska,bskc->bac", Sloc["C"], Sloc["XC"])
        return XE.new_zeros((B, 0, 0))
    diag = E @ XE[:, :-1] + F @ XF[:, 1:]                  # (B, nI, p, p)
    if G is not None:
        diag = diag - G
    lower = E @ XF[:, :-1]                                # couples mu_{i-1}
    upper = F @ XE[:, 1:]                                 # couples mu_{i+1}
    nR = nI * p + a
    M = XE.new_zeros((B, nR, nR))
    blocks = M[:, :nI * p, :nI * p].view(B, nI, p, nI, p)
    # diagonal(..., dim1=1, dim2=3) is (B, p, p, nI): block (i, i + offset)
    torch.diagonal(blocks, 0, 1, 3).copy_(-diag.permute(0, 2, 3, 1))
    if nI > 1:
        torch.diagonal(blocks, -1, 1, 3).copy_(
            -lower[:, 1:].permute(0, 2, 3, 1))
        torch.diagonal(blocks, 1, 1, 3).copy_(
            -upper[:, :-1].permute(0, 2, 3, 1))
    if a:
        XC, C = Sloc["XC"], Sloc["C"]                     # (B, S, k, a)
        # border columns of the mu rows: -(E XC_i + F XC_{i+1})
        colg = -(E @ XC[:, :-1] + F @ XC[:, 1:])          # (B, nI, p, a)
        M[:, :nI * p, nI * p:] = colg.reshape(B, nI * p, a)
        # border rows over mu_i: -(C_i' XE_i + C_{i+1}' XF_{i+1})
        rows_mu = -(C[:, :-1].transpose(-1, -2) @ XE[:, :-1]
                    + C[:, 1:].transpose(-1, -2) @ XF[:, 1:])  # (B,nI,a,p)
        M[:, nI * p:, :nI * p] = rows_mu.permute(0, 2, 1, 3).reshape(
            B, a, nI * p)
        M[:, nI * p:, nI * p:] = Dg - torch.einsum("bska,bskc->bac", C, XC)
    return M


def _interface_rhs(Sloc, E, F, SX, bg=None):
    """Interface right-hand side (B, nI*p + a), from w0 = K^{-1} b and c."""
    w0 = Sloc["w0"]
    B = w0.shape[0]
    nI = SX - 1
    parts = []
    if nI:
        rhs = Sloc["c"] - w0[:, :-1] @ E.T - w0[:, 1:] @ F.T
        parts.append(rhs.reshape(B, -1))
    if "C" in Sloc and bg is not None:
        parts.append(bg - torch.einsum("bska,bsk->ba", Sloc["C"], w0))
    if not parts:
        return w0.new_zeros((B, 0))
    return torch.cat(parts, dim=1)


def _condense_local(K, b, E, F, C=None):
    """Per-segment dense elimination: K^{-1}E', K^{-1}F', K^{-1}b (and
    K^{-1}C with a border), every segment of every lane in one batched
    solve."""
    p = E.shape[0]
    lead = K.shape[:-2]
    cols = [E.T.expand(*lead, -1, -1), F.T.expand(*lead, -1, -1),
            b[..., None]]
    if C is not None:
        cols.append(C)
    sol = torch.linalg.solve(K, torch.cat(cols, dim=-1))
    XC = sol[..., 2 * p + 1:] if C is not None else None
    return sol[..., :p], sol[..., p:2 * p], sol[..., 2 * p], XC


def _picks(E, F, like):
    return (torch.as_tensor(E, dtype=like.dtype, device=like.device),
            torch.as_tensor(F, dtype=like.dtype, device=like.device))


def _back_sub(w0, XE, XF, XC, mu, g, lo=0):
    """w_i = w0_i - XE_i mu_i - XF_i mu_{i-1} [- XC_i g] for the segments
    lo .. lo + w0.shape[1] - 1."""
    pad = mu.new_zeros((mu.shape[0], 1, mu.shape[2]))
    mu_pad = torch.cat([pad, mu, pad], dim=1)
    hi = lo + w0.shape[1]
    w = w0 - _mv(XE, mu_pad[:, lo + 1:hi + 1]) - _mv(XF, mu_pad[:, lo:hi])
    if XC is not None:
        w = w - _mv(XC, g[:, None, :])
    return w


def horizon_mesh(n=None, axis: str = "seg"):
    """1-D ``torch.distributed`` device mesh over the segment axis: one
    process per rank of the default group (initialised first, e.g. by
    ``multihost.initialize_multihost``); ``n`` must be that group's size
    (every process takes part in the mesh)."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"horizon_mesh({n}): the process group has {world} "
                         "processes, and every one is in the mesh")
    return init_device_mesh(mesh_device_type(), (world,),
                            mesh_dim_names=(axis,))


def _segments(mesh, axis, S):
    """(group, lo, hi): this process's consecutive segments lo .. hi - 1
    of the ``axis`` group of ``mesh``, or (None, 0, S) without a mesh."""
    if mesh is None:
        return None, 0, S
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    if S % n:
        raise ValueError(f"{S} segments over a {axis!r} group of {n} "
                         "processes: S must be a multiple of the group size")
    lo = mesh.get_local_rank(axis) * (S // n)
    return group, lo, lo + S // n


def _gather(t, group):
    """The (B, S, ...) whole of every process's (B, S/n, ...) segments, in
    group-rank order (the identity without a group)."""
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=1)


@full_precision()
def schur_horizon_solve(K, b, E, F, c, G=None, C=None, Dg=None, bg=None,
                        mesh=None, axis: str = "seg"):
    """Solve every lane's segment-coupled KKT system by Schur condensation.

    K (B, S, k, k): per-segment symmetric (quasi-definite) KKT blocks.
    b (B, S, k): per-segment right-hand sides.
    E, F (p, k): interface picks (interface i: E w_i + F w_{i+1}
        [+ G_i mu_i] = c_i).
    c (B, S-1, p): interface right-hand sides.
    G: optional (B, S-1, p, p) interface diagonal block (ADMM-relaxed
        continuity rows carry -diag(1/rho)).
    C/Dg/bg: optional global border: C (B, S, k, a), rows
        sum_s C_s' w_s + Dg g = bg with Dg (B, a, a), bg (B, a).
    mesh/axis: split the elimination over the ``axis`` group of a device
        mesh (see the module docstring); every process passes the whole
        arrays and gets the whole answer.

    Returns (w (B, S, k), mu (B, S-1, p)), or (w, mu, g) with a border.
    """
    S = b.shape[1]
    group, lo, hi = _segments(mesh, axis, S)
    E, F = _picks(E, F, K)
    XE, XF, w0, XC = _condense_local(K[:, lo:hi], b[:, lo:hi], E, F,
                                     None if C is None else C[:, lo:hi])
    Sloc = {"XE": _gather(XE, group), "XF": _gather(XF, group),
            "w0": _gather(w0, group), "c": c}
    if C is not None:
        Sloc.update({"XC": _gather(XC, group), "C": C})
    mu, g = _interface_system(Sloc, E, F, S, G=G, Dg=Dg, bg=bg)
    w = _gather(_back_sub(w0, XE, XF, XC, mu, g, lo), group)
    return (w, mu, g) if C is not None else (w, mu)


@full_precision()
def schur_horizon_factor(K, E, F, G=None, C=None, Dg=None,
                         kkt_solver: str = "lu", mesh=None,
                         axis: str = "seg"):
    """Everything right-hand-side independent of
    :func:`schur_horizon_solve`: the per-segment explicit inverses, the
    condensed blocks XE = K^{-1}E', XF = K^{-1}F' (and XC = K^{-1}C) and the
    inverse of the interface matrix, for callers that solve one KKT against
    many right-hand sides (each distributed-ADMM epoch runs ``check_every``
    iterations on one factorisation); every :func:`schur_horizon_apply` is
    then batched matvecs.

    kkt_solver="kernel" inverts the segment blocks with ``ops.ldlt_inverse``
    (the hand-written unpivoted LDL^T kernel for CUDA float32, its plain
    version on the CPU; the quasi-definite KKT licenses the unpivoted
    factor); "lu" with ``torch.linalg.inv`` (pivoted LU).  With a ``mesh``
    each process inverts and condenses only its own segments (B * S/n
    blocks), gathers the condensed blocks over the ``axis`` group and
    inverts the interface matrix like every other process; the factor
    carries the mesh and axis, and :func:`schur_horizon_apply` splits the
    same way.  Returns an opaque dict for :func:`schur_horizon_apply`.
    """
    if kkt_solver not in KKT_SOLVERS:
        raise ValueError(f"kkt_solver={kkt_solver!r}: expected one of "
                         f"{KKT_SOLVERS}")
    S, k = K.shape[1], K.shape[2]
    group, lo, hi = _segments(mesh, axis, S)
    E, F = _picks(E, F, K)
    Kl = K[:, lo:hi]
    inv = ldlt_inverse if kkt_solver == "kernel" else torch.linalg.inv
    Kinv = inv(Kl.reshape(-1, k, k)).reshape(Kl.shape)
    XE, XF = Kinv @ E.T, Kinv @ F.T
    Sloc = {"XE": _gather(XE, group), "XF": _gather(XF, group)}
    XC = None
    if C is not None:
        XC = Kinv @ C[:, lo:hi]
        Sloc.update({"XC": _gather(XC, group), "C": C})
    M = _interface_matrix(Sloc, E, F, S, G=G, Dg=Dg)
    Minv = torch.linalg.inv(M) if M.shape[-1] else M
    return {"Kinv": Kinv, "XE": XE, "XF": XF, "XC": XC, "C": C,
            "Minv": Minv, "E": E, "F": F, "S": S, "p": E.shape[0],
            "a": 0 if C is None else C.shape[-1], "mesh": mesh,
            "axis": axis, "group": group, "lo": lo, "hi": hi}


@full_precision()
def schur_horizon_apply(fac, b, c, bg=None):
    """Solve every lane's segment-coupled KKT for one right-hand side with a
    :func:`schur_horizon_factor`: batched matvecs only (and, for a factor
    made on a mesh, two ``all_gather``s over its group: w0 and w).

    Returns (w (B, S, k), mu (B, S-1, p)), or (w, mu, g) when the factor
    carries a border.
    """
    S, p, a = fac["S"], fac["p"], fac["a"]
    E, F, group, lo = fac["E"], fac["F"], fac["group"], fac["lo"]
    w0 = _mv(fac["Kinv"], b[:, lo:fac["hi"]])
    Sloc = {"w0": _gather(w0, group), "c": c}
    if a:
        Sloc["C"] = fac["C"]
    r = _interface_rhs(Sloc, E, F, S, bg=bg if a else None)
    sol = _mv(fac["Minv"], r) if r.shape[-1] else r
    mu, g = _interface_split(sol, S, p, a)
    w = _gather(_back_sub(w0, fac["XE"], fac["XF"], fac["XC"], mu, g, lo),
                group)
    return (w, mu, g) if a else (w, mu)


def assemble_dense_horizon(K, b, E, F, c, G=None, C=None, Dg=None, bg=None):
    """Oracle for one lane: the full coupled KKT assembled dense and solved
    with numpy (K (S, k, k), b (S, k), c (S-1, p), G (S-1, p, p), C
    (S, k, a), Dg (a, a), bg (a,)).

    Layout: [w_0 ... w_{S-1}, mu_0 ... mu_{S-2} (, g)].  Returns
    (w (S, k), mu (S-1, p)) or (w, mu, g), as numpy arrays.
    """
    Kn, bn = np.asarray(K), np.asarray(b)
    S, k = bn.shape
    En, Fn, cn = np.asarray(E), np.asarray(F), np.asarray(c)
    p = En.shape[0]
    a = 0 if C is None else np.asarray(C).shape[-1]
    n = S * k + (S - 1) * p + a
    M = np.zeros((n, n), dtype=Kn.dtype)
    r = np.zeros(n, dtype=Kn.dtype)
    for i in range(S):
        sl = slice(i * k, (i + 1) * k)
        M[sl, sl] = Kn[i]
        r[sl] = bn[i]
        if i < S - 1:
            mi = slice(S * k + i * p, S * k + (i + 1) * p)
            M[sl, mi] = En.T
            M[mi, sl] = En
        if i > 0:
            mi = slice(S * k + (i - 1) * p, S * k + i * p)
            M[sl, mi] = Fn.T
            M[mi, sl] = Fn
        if a:
            gi = slice(S * k + (S - 1) * p, n)
            M[sl, gi] = np.asarray(C)[i]
            M[gi, sl] = np.asarray(C)[i].T
    for i in range(S - 1):
        mi = slice(S * k + i * p, S * k + (i + 1) * p)
        r[mi] = cn[i]
        if G is not None:
            M[mi, mi] = np.asarray(G)[i]
    if a:
        gi = slice(S * k + (S - 1) * p, n)
        M[gi, gi] = np.asarray(Dg)
        r[gi] = np.asarray(bg)
    sol = np.linalg.solve(M, r)
    w = sol[:S * k].reshape(S, k)
    mu = sol[S * k:S * k + (S - 1) * p].reshape(S - 1, p)
    if a:
        return w, mu, sol[S * k + (S - 1) * p:]
    return w, mu
