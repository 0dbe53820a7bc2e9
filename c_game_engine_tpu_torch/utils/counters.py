"""Counts kept on the device: kernel launches (one per kernel wrapper,
named after the kernel) and the body-activity gate's open ticks
("body_gate").

Each count is an int64 scalar per device, bumped by an `add_` issued
where the counted thing happens. Inside a captured CUDA graph (and inside
a conditional node of one) that `add_` is captured too, so every replay
counts, and a capture alone counts nothing. Reading a count (`read`) is a
host sync.
"""

from __future__ import annotations

import torch

_counts: dict[tuple[str, torch.device], torch.Tensor] = {}


def bump(name: str, device) -> None:
    """Add one to the count `name` on `device`."""
    key = (name, torch.device(device))
    t = _counts.get(key)
    if t is None:
        if key[1].type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"count {name!r} first bumped while a CUDA graph captures: run the tick "
                               "eagerly once before capturing it")
        t = _counts[key] = torch.zeros((), dtype=torch.int64, device=key[1])
    t.add_(1)


def read(name: str) -> int:
    """The count `name`, summed over devices."""
    return sum(int(t) for (n, _), t in _counts.items() if n == name)


def reset() -> None:
    """Set every count to 0."""
    for t in _counts.values():
        t.zero_()


def snapshot() -> dict:
    return {k: t.clone() for k, t in _counts.items()}


def restore(snap: dict) -> None:
    """Put every count back to what `snapshot()` saw (0 for a count made
    since)."""
    for k, t in _counts.items():
        if k in snap:
            t.copy_(snap[k])
        else:
            t.zero_()
