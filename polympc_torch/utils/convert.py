"""Carry state across from the JAX package: its parameter dicts,
``NLPBounds``, ``SQPSolution``, ``QPData`` and plain KKT/QP arrays, given as
numpy arrays (or anything ``numpy.asarray`` takes), become the port's types
on a chosen device and dtype, so both packages can compute on identical
inputs.  Every function puts its tensors on the card unless the caller
names another device.  Nothing here imports the JAX package."""
from __future__ import annotations

import numpy as np
import torch

from polympc_torch.nlp.types import NLPBounds, SQPSolution
from polympc_torch.qp.types import QPData

__all__ = ["tensor", "params", "bounds", "sqp_solution", "qp_data"]


def tensor(a, dtype=torch.float64, device="cuda"):
    """One array -> tensor; integer and boolean arrays keep their kind."""
    arr = np.asarray(a)
    if arr.dtype.kind in "iub":
        return torch.as_tensor(arr.copy(), device=device)
    return torch.as_tensor(np.array(arr, dtype=np.float64), dtype=dtype,
                           device=device)


def params(prm, dtype=torch.float64, device="cuda"):
    """A transcription parameter dict {"p", "d", "t0", "tf"}."""
    return {k: tensor(v, dtype, device) for k, v in prm.items()}


def bounds(b, dtype=torch.float64, device="cuda") -> NLPBounds:
    """Anything with lbx/ubx/gl/gu fields -> the port's NLPBounds."""
    return NLPBounds(*(tensor(getattr(b, f), dtype, device)
                       for f in NLPBounds._fields))


def qp_data(qp, dtype=torch.float64, device="cuda") -> QPData:
    """Anything with H/h/A/al/au/xl/xu fields -> the port's QPData."""
    return QPData(*(tensor(getattr(qp, f), dtype, device)
                    for f in QPData._fields))


def sqp_solution(sol, dtype=torch.float64, device="cuda") -> SQPSolution:
    """A (batched) SQP solution -> the port's SQPSolution; status and
    iteration counts become int32."""
    out = {}
    for f in SQPSolution._fields:
        t = tensor(getattr(sol, f), dtype, device)
        if f in ("status", "iters", "qp_iters"):
            t = t.to(torch.int32)
        out[f] = t
    return SQPSolution(**out)
