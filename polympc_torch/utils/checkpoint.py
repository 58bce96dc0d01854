"""Warm-start checkpoint / resume — the port of
polympc_tpu/utils/checkpoint.py over a flat tuple of tensors.

The reference keeps its warm start only in memory (sqp_base.hpp:613-615);
a controller restart should resume from the last warm start rather than
re-converging cold.  The state is written to one ``.npz`` in the JAX
package's layout (``leaf_0``, ``leaf_1``, ... and a ``__treedef__``
string), so a file either package wrote for ``MPC.warm_state()`` loads in
the other: the port records its own structure string and accepts the JAX
package's for a flat tuple of the same length.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["save_pytree", "load_pytree"]


def _normalize(path) -> str:
    """np.savez appends '.npz' when missing; normalise so save/load agree
    (save_state('warm') -> load_state('warm') must find the same file)."""
    return str(path) if str(path).endswith(".npz") else str(path) + ".npz"


def _structure(n: int) -> str:
    return f"polympc_torch flat tuple of {n} tensors"


def _jax_structure(n: int) -> str:
    """The JAX package's treedef string of a flat tuple of n leaves."""
    return "PyTreeDef((" + ", ".join(["*"] * n) + "))"


def save_pytree(path, leaves) -> None:
    """Serialise a flat tuple of tensors to ``path`` (.npz)."""
    arrays = {f"leaf_{i}": t.detach().cpu().numpy()
              for i, t in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        _structure(len(leaves)).encode(), dtype=np.uint8)
    np.savez(_normalize(path), **arrays)


def load_pytree(path, like):
    """Restore a flat tuple saved by :func:`save_pytree` (or by the JAX
    package's ``save_pytree`` for a flat tuple).

    ``like`` supplies the leaf count, shapes, dtypes and devices; the
    stored structure, leaf count and shapes must match it.
    """
    path = _normalize(path)
    data = np.load(path)
    n = len(like)
    if "__treedef__" in data:
        saved = bytes(data["__treedef__"]).decode()
        if saved not in (_structure(n), _jax_structure(n)):
            raise ValueError(
                f"checkpoint {path} structure does not match 'like':\n"
                f"  saved: {saved}\n  like:  {_structure(n)}")
    loaded = []
    for i, ref in enumerate(like):
        key = f"leaf_{i}"
        if key not in data:
            raise ValueError(
                f"checkpoint {path} has {i} leaves, expected {n}")
        arr = data[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"leaf {i}: checkpoint shape {arr.shape} != "
                f"{tuple(ref.shape)}")
        loaded.append(torch.as_tensor(arr, dtype=ref.dtype,
                                      device=ref.device))
    return tuple(loaded)
