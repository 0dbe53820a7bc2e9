"""The tick as one captured CUDA graph per (map, batch), and one more with
a collect_fn: the counterpart of `jax.jit` over the tick scan
(c_game_engine_tpu/models/sim.py::rollout, bench.py:34).

A TickGraph owns static buffers: the state, a stream of up to CAP ticks
of actions, a device tick counter and, with a collect_fn, CAP rows of
collected output. It captures one tick: read row t of the action stream
(t the counter), `step_batch`, write collect_fn(new state) into row t,
copy the new state into the static state buffers, advance t. The tick's
gates are conditional nodes of the graph (core/gates.py).

`run(state, actions)` copies the state in, then for each chunk of up to
CAP ticks copies that chunk of actions into the stream, sets t to 0 and
replays the graph once a tick; the final state (and the collected rows)
are cloned out, so the caller never holds a buffer the next replay
writes. Replays are bit-equal to the eager loop (models/sim.py::
rollout_eager) on the same card.

Before the capture, warm-up ticks run eagerly with both sides of every
gate (gates.warm_up), so every kernel library, cuBLAS handle and cached
constant exists; the counts they bump are put back. A capture that fails
raises; nothing falls back to the eager loop.
"""

from __future__ import annotations

import time

import torch

from c_game_engine_tpu_torch.core import gates
from c_game_engine_tpu_torch.core.actions import Actions
from c_game_engine_tpu_torch.core.state import tree_leaves, tree_map
from c_game_engine_tpu_torch.core.step import step_batch
from c_game_engine_tpu_torch.utils import counters

CAP = 240  # ticks of actions held on the card: bench.py's stream
WARMUP_TICKS = 2


def _leaves(tree):
    return [t for _, t in tree_leaves(tree)]


class TickGraph:
    """One captured tick of `cmap` at the batch of `state`. Attributes
    after construction: `capture_s` (capture and instantiation, seconds),
    `pool_bytes` (device memory the capture reserved: the graph's private
    pool of intermediates)."""

    def __init__(self, cmap, state, collect_fn=None):
        dev = cmap.device
        if dev.type != "cuda":
            raise ValueError(f"a tick graph runs on a CUDA device, not {dev}: use models/sim.py::rollout_eager")
        self.cmap, self.collect_fn = cmap, collect_fn
        self.batch = state.tick.shape[0]
        self.state = tree_map(torch.clone, state)
        self.stream = Actions.zeros((CAP, self.batch), device=dev)
        self.t = torch.zeros(1, dtype=torch.long, device=dev)
        self._warm_up(state)
        self.collected = None
        if collect_fn is not None:
            self.collected = tree_map(
                lambda x: torch.empty((CAP, *x.shape), dtype=x.dtype, device=dev), collect_fn(state)
            )
        gates.prepare(dev)
        self.graph, pool = torch.cuda.CUDAGraph(), torch.cuda.graph_pool_handle()
        with gates.capturing(pool):  # before the capture begins: it collects garbage
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()  # as torch.cuda.graph does on entry, so the difference below is the pool
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            with torch.cuda.graph(self.graph, pool=pool):
                self._tick()
            torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def _warm_up(self, state):
        snap = counters.snapshot()
        try:
            with gates.warm_up():
                st = state
                for _ in range(WARMUP_TICKS):
                    st = step_batch(self.cmap, st, Actions.zeros((self.batch,), device=self.cmap.device))
                if self.collect_fn is not None:
                    self.collect_fn(st)
            torch.cuda.synchronize(self.cmap.device)
        finally:
            counters.restore(snap)

    def _tick(self):
        row = lambda x: x.index_select(0, self.t)[0]
        new = step_batch(self.cmap, self.state, tree_map(row, self.stream))
        if self.collected is not None:
            for buf, v in zip(_leaves(self.collected), _leaves(self.collect_fn(new))):
                buf.index_copy_(0, self.t, v[None])
        dst, src = _leaves(self.state), _leaves(new)
        static = {d.untyped_storage().data_ptr() for d in dst}
        # a new leaf that is a view of another static buffer is cloned
        # before any buffer is written
        src = [s if s is d or s.untyped_storage().data_ptr() not in static else s.clone()
               for s, d in zip(src, dst)]
        for d, s in zip(dst, src):
            if s is not d:
                d.copy_(s)
        self.t.add_(1)

    def load(self, state):
        """Copy `state` into the static state buffers."""
        for d, s in zip(_leaves(self.state), _leaves(state)):
            if s.shape != d.shape or s.dtype != d.dtype:
                raise ValueError(f"state leaf {tuple(s.shape)} {s.dtype} does not fit the graph's "
                                 f"{tuple(d.shape)} {d.dtype}")
            d.copy_(s)

    def run(self, state, actions: Actions):
        """Replay one tick per row of a [T, B, ...] action stream from
        `state`. Returns (final state, stacked collect_fn rows [T, ...] or
        None), both new tensors."""
        n = actions.move.shape[0]
        if actions.move.shape[1:] != self.stream.move.shape[1:]:
            raise ValueError(f"actions {tuple(actions.move.shape)} for a graph of batch {self.batch}")
        self.load(state)
        out = None
        if self.collected is not None:
            out = tree_map(lambda x: torch.empty((n, *x.shape[1:]), dtype=x.dtype, device=x.device),
                           self.collected)
        for c0 in range(0, n, CAP):
            c = min(CAP, n - c0)
            for d, s in zip(_leaves(self.stream), _leaves(actions)):
                d[:c].copy_(s[c0:c0 + c])
            self.t.zero_()
            for _ in range(c):
                self.graph.replay()
            if out is not None:
                for d, s in zip(_leaves(out), _leaves(self.collected)):
                    d[c0:c0 + c].copy_(s[:c])
        return tree_map(torch.clone, self.state), out


def tick_graph(cmap, state, collect_fn=None) -> TickGraph:
    """The map's cached graph for the batch of `state` (CompiledMap.graphs),
    captured from `state` on first use. A map keeps at most two graphs per
    batch: one without a collect_fn and one with. The second is replaced,
    its buffers and pool freed first, when `collect_fn` is another object
    than the one it captured: pass the same function to reuse it, since a
    new lambda on every call captures anew on every call."""
    key = (state.tick.shape[0], collect_fn is not None)
    graph = cmap.graphs.get(key)
    if graph is not None and graph.collect_fn is not collect_fn:
        del cmap.graphs[key]
        graph = None
    if graph is None:
        graph = cmap.graphs[key] = TickGraph(cmap, state, collect_fn)
    return graph
