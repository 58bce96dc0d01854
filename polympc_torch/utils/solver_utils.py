"""Small tensor helpers shared by the solvers."""
from __future__ import annotations

import torch

__all__ = ["block_diag_scatter"]


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
