"""CUDA-graph replay of the model derivatives, keyed by what a call shows.

The solvers evaluate the NLP's gradient, constraints, Jacobian and
Lagrangian Hessian through ``nlp.sqp.derivative_fns`` and
``nlp.sqp.exact_hessian_fn``: per-node ``torch.func`` transforms that
dispatch a few thousand small operators a call.  On a card the host's
dispatch of those operators is the whole cost, and the card waits.
:func:`call` runs such an evaluation ``fn(*args)`` and, where the inputs
allow, replays it from a CUDA graph instead of dispatching it again.

The key of a call is ``fn`` itself; the shape, dtype and device of every
tensor argument (a dict's tensors included); the value of every other
argument (an NLP, a Python float: a capture bakes them in); and the
matmul precision flags that select kernels.  What a call does rests on
the key alone:

  * a call with no tensor on a card runs eager, uncounted; one whose
    tensors are not all plain contiguous tensors on one card, that need no
    grad and start where a fresh allocation starts (not a subclass, a
    ``torch.func`` wrapper or an offset view), or with an argument that
    cannot be hashed, runs eager every time;
  * the first call with a key runs eager: it also fills every constant
    the evaluation makes once per device (``ocp.transcription._Consts``),
    whose host-to-device copies a capture would refuse;
  * the second warms up on a side stream and captures the graph, with
    every tensor argument copied into a static input buffer;
  * later calls copy their tensors (the parameter dict's too, so a value
    changed between calls is honoured) into those buffers and replay;
  * a key whose capture raised runs eager for good.

Every evaluation, eager or captured, runs its reverse passes on the
calling thread (``torch.autograd.set_multithreading_enabled(False)``).
On a card the autograd engine would hand them to its device thread, whose
node numbers it compares with the calling thread's when it orders the
outer pass of a Hessian: the order, and so the float32 sums, would depend
on the process's history.  On one thread eager is a function of its
inputs, and a replay launches eager's kernels in eager's order and
returns eager's bits.  Each graph keeps a private memory
pool (replays come in any order, so graphs cannot share one), at most
``MAX_GRAPHS`` of them, evicted least recently used first; the outputs
are copied out of the graph's buffers before they are returned, so an
answer the caller holds survives the next replay.

Counters (``utils.timing.count``), one a call on the card:
``derivatives.replay``, ``derivatives.eager`` and ``derivatives.capture``.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from polympc_torch.utils.timing import count

__all__ = ["call", "clear", "MAX_GRAPHS"]

# captured graphs held at once; each holds its own memory pool
MAX_GRAPHS = 32
# keys remembered at once (seen once, or holding a graph)
MAX_KEYS = 1024

# the caching allocator's alignment of a fresh block, in bytes
_ALIGN = 512

_SEEN = object()     # a key seen once, not captured
_EAGER = object()    # a call on the card that cannot be captured
_keys: OrderedDict = OrderedDict()   # key -> _SEEN or a graph, LRU first
_refused: set = set()                # keys whose capture raised
_streams: dict = {}                  # device index -> capture stream
_is_wrapped = getattr(torch._C._functorch, "is_functorch_wrapped_tensor",
                      lambda t: False)


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, dict):
            yield from (v for v in a.values() if isinstance(v, torch.Tensor))


def _on_card(t):
    return t.is_cuda


def _capturable(tensors):
    """Plain contiguous tensors on one card that need no grad, each at the
    start of an allocation's alignment, as the static buffers are: a
    reduction's or a GEMM's kernel may choose its order by the address."""
    dev = tensors[0].device
    return all(type(t) is torch.Tensor and t.device == dev
               and not t.requires_grad and t.is_contiguous()
               and t.data_ptr() % _ALIGN == 0 and not _is_wrapped(t)
               for t in tensors)


def _spec(a):
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), a.dtype, a.device)
    if isinstance(a, dict):
        return tuple((k, _spec(v)) for k, v in a.items())
    return a


def _key(fn, args):
    """The call's key: None for a call off the card (eager, uncounted),
    ``_EAGER`` for a call on the card that cannot be captured."""
    tensors = list(_tensors(args))
    if not any(_on_card(t) for t in tensors):
        return None
    if not _capturable(tensors):
        return _EAGER
    m = torch.backends.cuda.matmul
    key = (fn, tuple(_spec(a) for a in args),
           m.allow_tf32, m.allow_fp16_reduced_precision_reduction,
           m.allow_bf16_reduced_precision_reduction,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    try:
        hash(key)
    except TypeError:
        return _EAGER
    return key


def _static(args):
    """The arguments with every tensor copied into a buffer of its own."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            a = a.clone()
        elif isinstance(a, dict):
            a = {k: v.clone() if isinstance(v, torch.Tensor) else v
                 for k, v in a.items()}
        out.append(a)
    return out


def _copy_in(static, args):
    for s, a in zip(static, args):
        if isinstance(a, torch.Tensor):
            s.copy_(a)
        elif isinstance(a, dict):
            for k, v in a.items():
                if isinstance(v, torch.Tensor):
                    s[k].copy_(v)


def _copy_out(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(o.clone() for o in out)


def _eager(fn, args):
    """``fn(*args)`` with its reverse passes on the calling thread (module
    docstring)."""
    with torch.autograd.set_multithreading_enabled(False):
        return fn(*args)


def _record(fn, inputs):
    """Warm ``fn(*inputs)`` up on a side stream and capture it there:
    returns (replay, outputs), the graph's outputs overwritten by each
    replay."""
    dev = next(_tensors(inputs)).device
    with torch.cuda.device(dev):
        stream = _streams.get(dev.index)
        if stream is None:
            stream = _streams[dev.index] = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            _eager(fn, inputs)
            graph.capture_begin()
            try:
                outputs = _eager(fn, inputs)
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
    return graph.replay, outputs


class _Graph:
    """One captured call: its static inputs, its replay, its outputs."""

    def __init__(self, fn, args):
        self.inputs = _static(args)
        self.replay, self.outputs = _record(fn, self.inputs)

    def __call__(self, args):
        _copy_in(self.inputs, args)
        self.replay()
        return _copy_out(self.outputs)


def _evict():
    """Drop the least recently used graphs past ``MAX_GRAPHS``, then the
    least recently used keys past ``MAX_KEYS``."""
    graphs = [k for k, v in _keys.items() if v is not _SEEN]
    for k in graphs[:max(0, len(graphs) - MAX_GRAPHS)]:
        del _keys[k]
    while len(_keys) > MAX_KEYS:
        _keys.popitem(last=False)


def call(fn, *args):
    """``fn(*args)``, replayed from a CUDA graph where the key of the call
    has been seen before (module docstring).  ``fn`` returns a tensor or a
    tuple of tensors."""
    key = _key(fn, args)
    if key is None:
        return _eager(fn, args)
    if key is _EAGER or key in _refused:
        count("derivatives.eager")
        return _eager(fn, args)
    entry = _keys.get(key)
    if entry is None:
        _keys[key] = _SEEN
        _evict()
        count("derivatives.eager")
        return _eager(fn, args)
    _keys.move_to_end(key)
    if entry is _SEEN:
        try:
            entry = _Graph(fn, args)
        except Exception:
            del _keys[key]
            _refused.add(key)
            count("derivatives.eager")
            return _eager(fn, args)
        _keys[key] = entry
        _evict()
        count("derivatives.capture")
    else:
        count("derivatives.replay")
    return entry(args)


def clear():
    """Forget every key and graph (and which captures raised)."""
    _keys.clear()
    _refused.clear()
