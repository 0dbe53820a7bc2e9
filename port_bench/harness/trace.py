"""A torch.profiler window read as a timeline: the device's intervals (its
kernels, copies and fills) and the host's ranges, both on the profiler's
clock, inside the harness's range `port_bench.window`."""

from __future__ import annotations

import functools
import re
from dataclasses import dataclass, field

import torch

WINDOW = "port_bench.window"
PREFIX = "port_bench."
# the profiler's own work on the host (CUPTI's activity buffers): while it
# runs the host issues nothing, so the device's idle time under it is the
# instrument's and is left out of the window
STALLS = ("Buffer Flush", "Activity Buffer Request")


@dataclass
class Timeline:
    window: tuple  # (start, end) seconds
    device: list = field(default_factory=list)  # [(name, start, end)]
    host: list = field(default_factory=list)  # [(name, start, end)]

    @functools.cached_property
    def window_s(self) -> float:
        """The window's length less the idle time under the profiler's
        own stalls."""
        return self.window[1] - self.window[0] - sum(e - s for s, e in stalled_idle(self))


def from_profiler(prof) -> Timeline:
    cuda = torch.autograd.DeviceType.CUDA
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        span = (e.name(), e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9)
        if e.device_type() == cuda:
            # the host's ranges are mirrored on the device's timeline: no work
            if not (e.is_user_annotation() or span[0].startswith(PREFIX)):
                device.append(span)
        else:
            host.append(span)
            if span[0] == WINDOW:
                window = span[1:]
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    return Timeline(window, device, host)


def union(intervals, lo, hi) -> list:
    """The merged [(start, end)] of the intervals, clipped to [lo, hi]."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def subtract(intervals, cuts) -> list:
    """[[start, end]] of `intervals` with `cuts` taken out; both sorted
    and disjoint (as `union` gives them)."""
    out, j = [], 0
    for s, e in intervals:
        while j < len(cuts) and cuts[j][1] <= s:
            j += 1
        k = j
        while k < len(cuts) and cuts[k][0] < e:
            if cuts[k][0] > s:
                out.append([s, cuts[k][0]])
            s = max(s, cuts[k][1])
            if s >= e:
                break
            k += 1
        if s < e:
            out.append([s, e])
    return out


def idle(tl: Timeline) -> list:
    """The stretches of the window in which nothing ran on the device."""
    lo, hi = tl.window
    return subtract([[lo, hi]], union([(s, e) for _, s, e in tl.device], lo, hi))


def stalled_idle(tl: Timeline) -> list:
    """The device's idle stretches that lie under the profiler's stalls."""
    stalls = union([(s, e) for n, s, e in tl.host if n in STALLS], *tl.window)
    gaps = idle(tl)
    return subtract(gaps, subtract(gaps, stalls))


def busy_s(tl: Timeline) -> float:
    """Seconds of the window in which some operation ran on the device."""
    return sum(e - s for s, e in union([(s, e) for _, s, e in tl.device], *tl.window))


def kernel(tl: Timeline, name: str) -> tuple:
    """(device seconds, launches) of the kernel `name` in the window."""
    pat = re.compile(rf"\b{re.escape(name)}\b")
    lo, hi = tl.window
    hits = [(s, e) for n, s, e in tl.device if pat.search(n) and lo <= s < hi]
    return sum(e - s for s, e in hits), len(hits)


def short_name(name: str, width: int = 100) -> str:
    """A kernel's name without its return type and arguments, cut to
    `width` characters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            cut = i
            break
    name = name[:cut]
    return name if len(name) <= width else name[: width - 3] + "..."


def device_ops(tl: Timeline, n: int = 10) -> list:
    """[[name, seconds]] of the n device operations that took most time
    (summed by full name, shown by short_name)."""
    lo, hi = tl.window
    total = {}
    for name, s, e in tl.device:
        if lo <= s < hi:
            total[name] = total.get(name, 0.0) + (e - s)
    return [[short_name(k), v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def _host_label(tl: Timeline, t: float) -> str:
    """What the host was doing at t: the innermost harness range and the
    innermost other host range that cover t."""
    cover = [(e - s, name) for name, s, e in tl.host if s <= t < e and name != WINDOW]
    ours = sorted(c for c in cover if c[1].startswith(PREFIX))
    other = sorted(c for c in cover if not c[1].startswith(PREFIX))
    parts = [ours[0][1][len(PREFIX):]] if ours else []
    parts += [other[0][1]] if other else []
    return " / ".join(parts) or "outside every range"


def idle_gaps(tl: Timeline, n: int = 10) -> list:
    """[[what the host was doing, seconds]] of the n longest stretches of
    the window in which nothing ran on the device, the profiler's stalls
    left out."""
    stalls = union([(s, e) for n, s, e in tl.host if n in STALLS], *tl.window)
    gaps = sorted(((e - s, s) for s, e in subtract(idle(tl), stalls)), reverse=True)
    return [[_host_label(tl, s + g / 2), g] for g, s in gaps[:n]]
