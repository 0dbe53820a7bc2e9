"""What decides `correct`: the program's outputs from the window against
the plain reference, after the window has closed and the program is
freed.

Closed loops keep a sample of the window's steps, drawn from the seed
(a reservoir over every step, resets included): the state the step took,
the action row, the state it returned and what the agent received (the
observation on the host, or the frame batch). The reference steps the
taken state with the same actions and renders its own new state. The
first reset of the window is held to the reference's reset. A stream
keeps one segment, drawn the same way: the reference runs from its own
reset through the segment's first `stream_ticks` ticks and its
observations are held to the program's.

Numbers (each beside its limit in checks/<cell>.json):
  reset_off     elements of the program's reset state that differ from the
                reference's (an exact comparison)
  state_gap     widest gap over every leaf of the new states, |p - r| / (1 + |r|)
  obs_gap       the same over the observations the agent received
  frame_px_off  share of the frames' pixels with a channel off by more than 1/255
"""

from __future__ import annotations

import math
import random

import torch

from harness.observe import observation
from harness.reference import leaves


class Reservoir:
    """A uniform sample of at most k of the items offered, decided by a
    generator seeded from the run's seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items = k, random.Random(seed), []

    def offer(self, i: int, make):
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = self.rng.randrange(i + 1)
            if j < self.k:
                self.items[j] = make()


def rel_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    p, r = p.double().reshape(-1), r.to(p.device).double().reshape(-1)
    if p.shape != r.shape:
        return math.inf
    if p.numel() == 0:
        return 0.0
    gap = (p - r).abs() / (1.0 + r.abs())
    same_nan = p.isnan() & r.isnan()
    gap = torch.where(same_nan, 0.0, torch.nan_to_num(gap, nan=math.inf, posinf=math.inf))
    return float(gap.max())


def state_gap(prog, ref) -> float:
    got = dict(leaves(prog))
    worst = 0.0
    for name, r in leaves(ref):
        worst = max(worst, rel_gap(got[name], r) if name in got else math.inf)
    return worst


def reset_off(prog, ref) -> int:
    got = dict(leaves(prog))
    off = 0
    for name, r in leaves(ref):
        p = got.get(name)
        if p is None or p.shape != r.shape:
            off += max(r.numel(), 1)
            continue
        p, r = p.double(), r.to(p.device).double()
        off += int((~((p == r) | (p.isnan() & r.isnan()))).sum())
    return off


def frame_px_off(frames: torch.Tensor, ref: torch.Tensor) -> float:
    return float(((frames.float() - ref.to(frames.device).float()).abs() > 1.0 / 255.0).any(-1).float().mean())


def closed_numbers(ref, samples, first_reset, names, pixels: bool) -> tuple:
    """samples: [(state taken, action row, state returned, what the agent
    received)]. Returns (each sample's numbers, the widest of each)."""
    per = [{"reset_off": float(reset_off(first_reset, ref.reset()))}]
    for taken, row, new, got in samples:
        r = ref.step(taken, ref.actions(row.to(ref.cmap.tri16.device)))
        n = {"state_gap": state_gap(new, r)}
        if pixels:
            n["frame_px_off"] = frame_px_off(got, ref.render(r))
        else:
            n["obs_gap"] = rel_gap(got, observation(r, names))
        per.append(n)
    return per, widest(per)


def stream_numbers(ref, samples, ticks: int, names) -> tuple:
    """samples: [(the reset state the segment took, its [T, B,
    ACTION_DIM] actions, its [T, B, D] collected observations)]; the
    reference runs each from its own reset through `ticks` ticks."""
    per = []
    for taken, rows, got in samples:
        r = ref.reset()
        per.append({"reset_off": float(reset_off(taken, r))})
        for t in range(min(ticks, rows.shape[0])):
            r = ref.step(r, ref.actions(rows[t]))
            per.append({"obs_gap": rel_gap(got[t], observation(r, names))})
    return per, widest(per)


def widest(per) -> dict:
    out = {}
    for n in per:
        for k, v in n.items():
            out[k] = max(out.get(k, v), v)
    return out


def judge(numbers: dict, limits: dict) -> bool:
    return all(k in limits and v <= limits[k] for k, v in numbers.items())
