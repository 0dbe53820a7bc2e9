"""Batched map simulation entry points (counterpart of
c_game_engine_tpu/models/sim.py): B environments step in lockstep; the
fixed-timestep loop is a Python loop over ticks.
"""

from __future__ import annotations

from c_game_engine_tpu_torch.core.actions import Actions
from c_game_engine_tpu_torch.core.state import EnvState, reset, tree_map
from c_game_engine_tpu_torch.core.step import step_batch


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


def rollout(cmap, state: EnvState, actions: Actions) -> EnvState:
    """Step through a [T, B, ...] action stream; returns the final state."""
    for t in range(actions.move.shape[0]):
        state = step_batch(cmap, state, actions[t])
    return state
