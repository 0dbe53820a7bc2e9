"""The observation an agent reads after each tick: a fixed list of state
leaves (dotted names, traffic/<mix>.json's `observe`), each flattened per
env and cast to float32, side by side: [B, D]."""

from __future__ import annotations

import torch


def leaf(state, name: str) -> torch.Tensor:
    for part in name.split("."):
        state = getattr(state, part)
    return state


def observation(state, names) -> torch.Tensor:
    parts = [leaf(state, n) for n in names]
    b = parts[0].shape[0]
    return torch.cat([p.reshape(b, -1).to(torch.float32) for p in parts], dim=1)


class Observer:
    """`observation` over a fixed list as one function object, so that a
    graph that captures it (rollout_collect's) is captured once."""

    def __init__(self, names):
        self.names = list(names)

    def __call__(self, state) -> torch.Tensor:
        return observation(state, self.names)
