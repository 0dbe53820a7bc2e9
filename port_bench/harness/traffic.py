"""The one traffic generator: a mix's parameters (traffic/<mix>.json) and a
seed give every env its own action for every tick.

A mix draws `episodes` episodes of `episode_ticks` ticks for `envs` envs
from its own `pool_seed`. Each env draws a new action every
`action_repeat` ticks: move x and z each from `move`, the yaw delta
uniform on +-`yaw_per_tick` rad and the pitch delta uniform on
+-`pitch_per_tick` rad, and each button of `buttons` down with its
probability; the other buttons stay up. The run's seed then deals each
episode's streams out to the envs in an order of its own, so that every
seed runs the same set of streams (the work a tick does depends on what
the agents do: drawing the streams anew from each seed moved steps/s by
3% between seeds), and each env sees other streams. Actions are flat
rows of ACTION_DIM floats in the order the port's `Actions.from_flat`
reads: move x, move z, yaw, pitch, then BUTTONS.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BUTTONS = ("JUMP", "INTERACT", "SLOW", "SPRINT", "NOCLIP", "FREECAM", "ITEM_NEXT", "ITEM_PREV", "FIRE", "ALT_FIRE")
ACTION_DIM = 4 + len(BUTTONS)


def draws(mix: dict, seed: int) -> np.ndarray:
    """[episodes, draws per episode, envs, ACTION_DIM] float32: the mix's
    streams, each episode's dealt to the envs in the order `seed` gives."""
    out = _pool(mix)
    rng = np.random.default_rng(seed)
    for e in range(out.shape[0]):
        out[e] = out[e][:, rng.permutation(out.shape[2])]
    return out


def _pool(mix: dict) -> np.ndarray:
    rng = np.random.default_rng(mix["pool_seed"])
    e, b = mix["episodes"], mix["envs"]
    d = math.ceil(mix["episode_ticks"] / mix["action_repeat"])
    out = np.zeros((e, d, b, ACTION_DIM), np.float32)
    move = np.asarray(mix["move"], np.float32)
    out[..., 0:2] = move[rng.integers(0, len(move), size=(e, d, b, 2), dtype=np.int8)]
    for col, key in ((2, "yaw_per_tick"), (3, "pitch_per_tick")):
        out[..., col] = (rng.random((e, d, b), dtype=np.float32) * 2.0 - 1.0) * np.float32(mix[key])
    for name, p in mix["buttons"].items():
        out[..., 4 + BUTTONS.index(name)] = rng.random((e, d, b), dtype=np.float32) < p
    return out


class Pool:
    """A mix's actions for a run: `tick(e, t)` is the [envs, ACTION_DIM]
    row of tick t of episode e (episodes cycle), in pinned host memory on a
    card so that its copy to the card is asynchronous; `stream(e)` is the
    whole episode [episode_ticks, envs, ACTION_DIM] on the device."""

    def __init__(self, mix: dict, seed: int, device: torch.device):
        self.mix, self.device = mix, device
        self.repeat, self.ticks = mix["action_repeat"], mix["episode_ticks"]
        host = torch.from_numpy(draws(mix, seed))
        self.host = host.pin_memory() if device.type == "cuda" else host
        self._streams = {}

    def tick(self, e: int, t: int) -> torch.Tensor:
        return self.host[e % self.host.shape[0], t // self.repeat]

    def stream(self, e: int) -> torch.Tensor:
        e %= self.host.shape[0]
        if e not in self._streams:
            rows = self.host[e].to(self.device).repeat_interleave(self.repeat, dim=0)
            self._streams[e] = rows[: self.ticks].contiguous()
        return self._streams[e]
