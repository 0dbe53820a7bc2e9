"""Batch-global gates of the tick: the JAX tick's `lax.cond`s (sound-op
drain, channel advance, stick to floor, body activity, pair activity).

A gate runs a branch only when a predicate over the whole batch holds,
and otherwise hands on its inputs unchanged. In eager mode `read` copies
the predicate to the host (one sync, counted in `host_reads`) and the
branch is a Python `if`. While a CUDA graph captures (inside
`capturing(pool)`), `read` hands the device predicate on, and
`gate`/`branch` capture each branch into a CUDA graph conditional node
(an if node, csrc/graph_cond.cu; an else is a second if node on the
negated predicate): the graph then decides on the device on every
replay, and no host branch runs.

Branch outputs are (nested tuples, lists or dicts of) tensors. `warm_up()`
runs every gated branch eagerly whatever its predicate, so that everything
a branch loads or caches (kernel libraries, constants) exists before a
capture.
"""

from __future__ import annotations

import contextlib
import functools
import gc

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

host_reads = 0
_warming = False
_pool = None  # the memory pool of the graph being captured (`capturing`)
_depth = []  # body streams of the if nodes being captured, outermost first


def read(pred: torch.Tensor):
    """The gate predicate pred ([] bool): a Python bool in eager mode, the
    device tensor itself while the current stream captures a graph."""
    global host_reads
    if pred.is_cuda and torch.cuda.is_current_stream_capturing():
        return pred
    host_reads += 1
    return bool(pred)


def gate(pred, fn, passthrough):
    """fn() where pred holds, else passthrough() (the untouched inputs);
    pred comes from `read`."""
    if not isinstance(pred, torch.Tensor):
        return _host_branch(pred, fn, passthrough)
    leaves, spec = tree_flatten(passthrough())
    out = [t.clone() for t in leaves]  # the closed gate's values
    with _if_node(pred):
        _copy_into(out, fn(), spec)
    return tree_unflatten(out, spec)


def branch(pred, if_true, if_false):
    """if_true() where pred holds, else if_false(); both return the same
    structure of tensors of the same shapes. pred comes from `read`."""
    if not isinstance(pred, torch.Tensor):
        return _host_branch(pred, if_true, if_false)
    with _if_node(pred):
        leaves, spec = tree_flatten(if_true())
        out = [torch.empty_like(t) for t in leaves]
        for o, r in zip(out, leaves):
            o.copy_(r)
    with _if_node(pred, negate=True):
        _copy_into(out, if_false(), spec)
    return tree_unflatten(out, spec)


def _host_branch(pred, if_true, if_false):
    if _warming:
        taken, other = if_true(), if_false()
        return taken if pred else other
    return if_true() if pred else if_false()


def select(pred, a, b):
    """a where pred holds, else b, for tensors of one shape."""
    if not isinstance(pred, torch.Tensor):
        return a if pred else b
    return torch.where(pred, a, b)


@contextlib.contextmanager
def warm_up():
    """Run both sides of every gate eagerly; results are those of eager
    mode."""
    global _warming
    before, _warming = _warming, True
    try:
        yield
    finally:
        _warming = before


@contextlib.contextmanager
def capturing(pool):
    """Mark a capture as open: the gates' conditional nodes go into the
    graph the current stream captures, their allocations into `pool`
    (the graph's torch.cuda.graph_pool_handle()). Enter it before the
    capture begins: it collects Python's garbage and holds the cyclic
    collector off until it exits. A map's or bundle's graphs refer back
    to it, so an earlier graph that nothing else holds dies only in a
    cyclic collection; PyTorch's capture no longer collects on entry, and
    a collection during a capture destroyed such a graph and freed its
    pool mid-capture, and the capture of an if node's body then crashed
    (cudaStreamEndCapture, a segmentation fault)."""
    global _pool
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    before, _pool = _pool, pool
    try:
        yield
    finally:
        _pool = before
        if enabled:
            gc.enable()


@functools.cache
def _cond_lib():
    import ctypes

    from c_game_engine_tpu_torch.ops.build import KernelLibrary

    lib = KernelLibrary("graph_cond")
    p, i = ctypes.c_void_p, ctypes.c_int
    return (lib.fn("graph_if_begin", [p, p, i, p]), lib.fn("graph_if_end", [p]),
            lib.fn("graph_stream_create", [ctypes.POINTER(p)]), lib.fn("graph_cond_load", []))


def prepare(device):
    """Load the if-node helper and make its body streams on `device`,
    before a capture: two nesting levels (the pair gate inside the body
    gate)."""
    from c_game_engine_tpu_torch.ops.build import check

    check(_cond_lib()[3](), "graph_cond_load")
    for d in range(2):
        _body_stream(d, torch.device(device))


@functools.cache
def _body_stream(depth, device):
    """A stream of our own for the bodies at one nesting depth (never one
    of PyTorch's pooled streams, which a capture may be using)."""
    import ctypes

    from c_game_engine_tpu_torch.ops.build import check

    out = ctypes.c_void_p()
    check(_cond_lib()[2](ctypes.byref(out)), "graph_stream_create")
    return torch.cuda.ExternalStream(out.value, device=device)


@contextlib.contextmanager
def _if_node(pred, negate=False):
    """Capture the block into an if node on pred (csrc/graph_cond.cu). Its
    ops run on a body stream whose allocations go to the graph's pool."""
    from c_game_engine_tpu_torch.ops.build import check

    if _pool is None:
        raise RuntimeError("a gate met a capturing stream outside gates.capturing(pool)")
    begin, end = _cond_lib()[:2]
    dev, pool = pred.device, _pool
    body = _body_stream(len(_depth), dev)
    check(begin(torch.cuda.current_stream(dev).cuda_stream, pred.data_ptr(), int(negate), body.cuda_stream),
          "graph_if_begin")
    # the pool takes the allocations of one stream at a time: the body's
    # while it is captured, then the enclosing stream's again
    torch._C._cuda_endAllocateToPool(dev.index, pool)
    _depth.append(body)
    try:
        with torch.cuda.stream(body):
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev.index, pool)
            try:
                yield
            finally:
                torch._C._cuda_endAllocateToPool(dev.index, pool)
                err = end(body.cuda_stream)
        check(err, "graph_if_end")
    finally:
        _depth.pop()
        torch._C._cuda_beginAllocateCurrentStreamToPool(dev.index, pool)


def _copy_into(out, result, spec):
    leaves, got = tree_flatten(result)
    if got != spec or len(leaves) != len(out):
        raise ValueError(f"gate branches return different structures: {got} and {spec}")
    for o, r in zip(out, leaves):
        if r.shape != o.shape or r.dtype != o.dtype:
            raise ValueError(f"gate branches return {tuple(r.shape)} {r.dtype} and {tuple(o.shape)} {o.dtype}")
        o.copy_(r)
