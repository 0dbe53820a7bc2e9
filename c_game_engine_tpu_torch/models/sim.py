"""Batched map simulation entry points (counterpart of
c_game_engine_tpu/models/sim.py): B environments step in lockstep.

On a CUDA device `rollout` and `rollout_collect` replay one captured CUDA
graph of the tick per tick (models/graph.py; the JAX package's `jax.jit`
over a `lax.scan`); `rollout_eager` is the Python loop over ticks, which
the CPU takes and the graph is held to.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import torch

from c_game_engine_tpu_torch.core.actions import Actions
from c_game_engine_tpu_torch.core.state import EnvState, load_map, reset, tree_map
from c_game_engine_tpu_torch.core.step import step_batch

MAPS = Path(__file__).resolve().parents[1] / "maps"


def reset_batch(cmap, batch: int, save=None, frame=None) -> EnvState:
    """Fresh state broadcast over a batch axis. `save` (a batched SaveData)
    and `frame` ([B] i32) carry over across a map change."""
    single = reset(cmap)
    out = tree_map(lambda x: x.unsqueeze(0).expand(batch, *x.shape).contiguous(), single)
    if save is not None:
        out = out.replace(save=save)
    if frame is not None:
        out = out.replace(frame=frame)
    return out


def change_map(new_cmap, old_state: EnvState) -> EnvState:
    """ChangeMapByName: fresh state on `new_cmap` carrying the batch's
    SaveData and the uptime frame counter."""
    batch = old_state.tick.shape[0]
    return reset_batch(new_cmap, batch, save=old_state.save, frame=old_state.frame)


def bench_actions(ticks: int, batch: int, device="cuda") -> Actions:
    """The bench.py action stream [ticks, batch]: hold W (move z = -1) and
    turn 0.01 rad per tick."""
    acts = Actions.zeros((ticks, batch), device=device)
    acts.move[..., 1] = -1.0
    acts.look[..., 0] = 0.01
    return acts


def rollout_eager(cmap, state: EnvState, actions: Actions) -> EnvState:
    """Step through a [T, B, ...] action stream tick by tick in Python;
    returns the final state."""
    for t in range(actions.move.shape[0]):
        state = step_batch(cmap, state, actions[t])
    return state


def rollout(cmap, state: EnvState, actions: Actions) -> EnvState:
    """Step through a [T, B, ...] action stream; returns the final state.
    CUDA tensors replay the map's tick graph, CPU tensors run
    `rollout_eager`."""
    if state.tick.is_cuda:
        from c_game_engine_tpu_torch.models.graph import tick_graph

        return tick_graph(cmap, state).run(state, actions)[0]
    return rollout_eager(cmap, state, actions)


def step_one(cmap, state: EnvState, actions: Actions) -> EnvState:
    """One tick of a batch: `rollout` of the one-row stream `actions`
    [B, ...] (the map's tick graph on a card, step_batch on the CPU)."""
    return rollout(cmap, state, tree_map(lambda x: x[None], actions))


def rollout_collect_eager(cmap, state: EnvState, actions: Actions, collect_fn):
    """rollout_collect tick by tick in Python."""
    rows = []
    for t in range(actions.move.shape[0]):
        state = step_batch(cmap, state, actions[t])
        rows.append(collect_fn(state))
    return state, tree_map(lambda *xs: torch.stack(xs), rows[0], *rows[1:])


def rollout_collect(cmap, state: EnvState, actions: Actions, collect_fn):
    """Like rollout, also stacking collect_fn(state) after each tick:
    returns (final state, [T, ...] stacked output). collect_fn returns a
    tensor or a Struct of tensors. On a CUDA device it is captured into the
    tick graph, which the map keeps until another collect_fn object comes:
    a new function object (a lambda written in the call) costs a new
    capture on every call, two warm-up ticks and about as much pool memory
    as `rollout`'s graph (PERF.md §5). CPU tensors run
    `rollout_collect_eager`."""
    if state.tick.is_cuda:
        from c_game_engine_tpu_torch.models.graph import tick_graph

        return tick_graph(cmap, state, collect_fn).run(state, actions)
    return rollout_collect_eager(cmap, state, actions, collect_fn)


@dataclass
class BatchedSim:
    """A map with its batched entry points (`reset()`, `step(state,
    actions)`, `rollout(state, actions)`)."""

    cmap: Any
    batch: int
    reset: Any
    step: Any
    rollout: Any

    @property
    def name(self) -> str:
        return self.cmap.aux["name"] if self.cmap.aux else "map"


def load_named_map(map_name: str, device="cuda", search_paths=None):
    """A map on `device`: a `.gmap` or editor-JSON source path, compiled by
    the port's compiler through the compile cache (compiler/cache.py; its
    assets resolved under `search_paths`, default
    compiler/models.py::DEFAULT_SEARCH_PATHS), as the JAX make_sim compiles
    its source; an exported map's .npz path (its .json beside it); or the
    name of a committed map (c_game_engine_tpu_torch/maps/<name>)."""
    path = Path(map_name)
    if path.suffix in (".gmap", ".json"):
        from c_game_engine_tpu_torch.compiler.cache import load_compiled

        return load_compiled(path, search_paths, with_bundle=False, device=device)[0]
    if path.suffix != ".npz":
        path = MAPS / f"{map_name}.npz"
    return load_map(path, path.with_suffix(".json"), device)


def make_sim(map_source: str, batch: int = 4096, jit: bool = True, device="cuda", search_paths=None) -> BatchedSim:
    """BatchedSim on a map of `load_named_map` (a `.gmap` or `.json` source
    path is compiled, a name loads its committed files). jit=True steps and
    rolls out through the CUDA tick graph and raises on a CPU device;
    jit=False runs the eager tick."""
    cmap = load_named_map(map_source, device, search_paths)
    if jit and cmap.device.type != "cuda":
        raise ValueError(f"make_sim(jit=True) captures a CUDA graph; device {cmap.device} has none "
                         "(pass jit=False for the eager tick)")
    step, roll = (step_one, rollout) if jit else (step_batch, rollout_eager)
    return BatchedSim(cmap=cmap, batch=batch, reset=lambda: reset_batch(cmap, batch),
                      step=functools.partial(step, cmap), rollout=functools.partial(roll, cmap))
