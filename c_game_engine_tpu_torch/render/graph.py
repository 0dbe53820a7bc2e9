"""Frame batches as captured CUDA graphs: the counterpart of `jax.jit`
over render_batch and over the vmapped render_with_hud
(c_game_engine_tpu/render/raster.py), as models/graph.py is of the jitted
tick scan.

A RenderGraph owns static buffers: the state leaves the frame reads and
the output frames. It captures one call of a frame function (render/
raster.py's render_batch_eager or the HUD frame) on those buffers. The
reveal overflow inside it is a `core/gates.py` branch, so the capture holds
a conditional node whose body is the full-frame re-shade, and a replay
decides on the device: no host read, no copy from the host.

`run(states)` copies the read leaves in, replays, and returns a clone of
the frames, so the caller never holds a buffer the next replay writes.

Before the capture one eager call runs both sides of the overflow gate
(gates.warm_up), so every kernel library and cached constant exists; the
counts it bumps are put back. That call also finds the leaves the frame
reads: those whose storage an op of the call takes. A capture that fails
raises; nothing falls back to the eager path.

A bundle keeps one graph per key (`RenderBundle.graphs`): the function
name, the options (among them the resolved route and render/raster.py's
CULL_MODE, read at each call), the batch. A graph captured with another
map object is replaced, its buffers and pool freed first.
"""

from __future__ import annotations

import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from c_game_engine_tpu_torch.core import gates
from c_game_engine_tpu_torch.core.state import tree_leaves, tree_map
from c_game_engine_tpu_torch.utils import counters


class _Reads(TorchDispatchMode):
    """The storages (data pointers) of every tensor an op under the mode
    takes."""

    def __init__(self):
        super().__init__()
        self.storages = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for a in tree_flatten((args, kwargs))[0]:
            if isinstance(a, torch.Tensor):
                self.storages.add(a.untyped_storage().data_ptr())
        return func(*args, **(kwargs or {}))


class RenderGraph:
    """One captured call of `fn(states) -> frames` on the batch of
    `states`. Attributes after construction: `reads` (the names of the
    state leaves copied in on each run), `capture_s` (capture and
    instantiation, seconds), `pool_bytes` (device memory the capture
    reserved: the graph's private pool)."""

    def __init__(self, cmap, states, fn):
        dev = states.player.pos.device
        if dev.type != "cuda":
            raise ValueError(f"a render graph runs on a CUDA device, not {dev}: use render_batch_eager")
        self.cmap = cmap
        snap = counters.snapshot()
        try:
            with gates.warm_up(), _Reads() as seen:
                fn(states)
            torch.cuda.synchronize(dev)
        finally:
            counters.restore(snap)
        self.state = tree_map(torch.clone, states)
        self.reads = [k for k, v in tree_leaves(states) if v.untyped_storage().data_ptr() in seen.storages]
        buffers = dict(tree_leaves(self.state))
        self._buffers = [buffers[k] for k in self.reads]
        gates.prepare(dev)
        self.graph, pool = torch.cuda.CUDAGraph(), torch.cuda.graph_pool_handle()
        with gates.capturing(pool):  # before the capture begins: it collects garbage
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()  # as torch.cuda.graph does on entry, so the difference below is the pool
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            with torch.cuda.graph(self.graph, pool=pool):
                self.out = fn(self.state)
            torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def run(self, states):
        """Copy the read leaves of `states` in, replay, return new frames."""
        leaves = dict(tree_leaves(states))
        for k, d in zip(self.reads, self._buffers):
            s = leaves[k]
            if s.shape != d.shape or s.dtype != d.dtype:
                raise ValueError(f"state leaf {k} {tuple(s.shape)} {s.dtype} does not fit the graph's "
                                 f"{tuple(d.shape)} {d.dtype}")
            d.copy_(s)
        self.graph.replay()
        return self.out.clone()


def replay(bundle, cmap, states, key, fn):
    """The frames of `fn(states)` through the bundle's graph for `key`
    and the batch of `states`, captured on first use."""
    key = (*key, states.player.pos.shape[0])
    graph = bundle.graphs.get(key)
    if graph is not None and graph.cmap is not cmap:
        del bundle.graphs[key], graph
        graph = None
    if graph is None:
        graph = bundle.graphs[key] = RenderGraph(cmap, states, fn)
    return graph.run(states)
