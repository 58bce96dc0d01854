"""Small solver utilities (ref: src/solvers/utils.hpp:17-39) — the port of
polympc_tpu/utils/solver_utils.py.

``block_diag_scatter`` assembles per-node blocks into block-diagonal
matrices; ``is_psd`` is the reference's eigenvalue
positive-semidefiniteness check; ``print_qp`` pretty-prints a QPData for
debugging.  ``rbf_kernel`` and its derivative helpers replace the
reference's hand-specialised AD showcase (src/autodiff/rbf_kernel.hpp:18-95):
one tensor function under ``torch.func.grad`` / ``hessian``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, hessian

__all__ = ["block_diag_scatter", "is_psd", "print_qp", "rbf_kernel",
           "rbf_grad", "rbf_hessian"]


def block_diag_scatter(blocks):
    """Dense block-diagonal matrices from per-node blocks, by direct scatter.

    ``blocks`` is (..., N, r, c); the result is (..., N*r, N*c) with
    blocks[..., k, :, :] at the k-th diagonal block — the collocation NLP's
    block-diagonal assembly (the reference's per-node sparse inserts,
    continuous_ocp.hpp:852-876) in O(N r c) writes.
    """
    *lead, N, r, c = blocks.shape
    out = blocks.new_zeros((*lead, N, r, N, c))
    idx = torch.arange(N, device=blocks.device)
    out[..., idx, :, idx, :] = blocks.movedim(-3, 0) if lead else blocks
    return out.reshape(*lead, N * r, N * c)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def is_psd(H, tol: float = 0.0) -> bool:
    """Eigenvalue PSD check (utils.hpp:24-33), in float64 on the host; a
    batch (..., n, n) is PSD when every matrix is."""
    w = np.linalg.eigvalsh(np.asarray(_np(H), np.float64))
    return bool(np.all(w >= -abs(tol)))


def print_qp(qp) -> str:
    """Human-readable QP dump (utils.hpp:17-22).  Returns the string and
    prints it; n and m are read from the last axes, so a batched QPData
    prints every lane."""
    with np.printoptions(precision=4, suppress=True):
        s = (f"QP(n={qp.H.shape[-1]}, m={qp.A.shape[-2]})\n"
             f"H =\n{_np(qp.H)}\nh = {_np(qp.h)}\n"
             f"A =\n{_np(qp.A)}\n"
             f"al = {_np(qp.al)}\nau = {_np(qp.au)}\n"
             f"xl = {_np(qp.xl)}\nxu = {_np(qp.xu)}")
    print(s)
    return s


def rbf_kernel(x, c, gamma: float = 1.0):
    """Gaussian RBF k(x, c) = exp(-gamma ||x - c||^2)
    (rbf_kernel.hpp:18-95)."""
    x = torch.as_tensor(x)
    d = x - torch.as_tensor(c, dtype=x.dtype, device=x.device)
    return torch.exp(-gamma * (d @ d))


def rbf_grad(x, c, gamma: float = 1.0):
    """d k / d x — one ``torch.func.grad`` replaces the adscalar
    specialisation."""
    x = torch.as_tensor(x)
    c = torch.as_tensor(c, dtype=x.dtype, device=x.device)
    return grad(rbf_kernel)(x, c, gamma)


def rbf_hessian(x, c, gamma: float = 1.0):
    """d^2 k / d x^2 — replaces the outer_adscalar specialisation."""
    x = torch.as_tensor(x)
    c = torch.as_tensor(c, dtype=x.dtype, device=x.device)
    return hessian(rbf_kernel)(x, c, gamma)
