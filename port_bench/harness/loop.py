"""The agent loop a cell's traffic describes, timed.

closed: each step hands every env its own action row (pinned host
memory, copied to the card asynchronously), calls the program's step
(BatchedSim.step) once, and waits for the observation: the state
observation copied to pinned host memory, or the frame batch the program
renders from the new state (render_batch), ready on the card. Every
`episode_ticks` steps the whole batch resets (reset_batch), inside the
step that follows.

stream: each call resets the batch and hands rollout_collect one
episode's [episode_ticks, envs] action stream, with the observation as
its collect_fn (one function object, so its graph is captured once); the
trajectories stay on the card.

Each call is timed by CUDA events recorded on the stream: from before the
actions are handed over (and the reset issued) until the observation is
ready, and around the program's call into the tick and into the frame
batch; the host clock times the entry's call and the window.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch
from torch.profiler import record_function

from harness.observe import Observer


class Clock:
    """Marks on the device's stream (CUDA events) on a card, host times on
    the CPU (the CPU runs only in the harness's own tests). A call reads
    its marks before the next call makes new ones, so the events are a
    small ring made once: the window allocates none."""

    RING = 8

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.events = [torch.cuda.Event(enable_timing=True) for _ in range(self.RING)]
            self.next = 0

    def mark(self):
        if self.cuda:
            ev = self.events[self.next]
            self.next = (self.next + 1) % self.RING
            ev.record()
            return ev
        return time.perf_counter()

    def wait(self, mark):
        if self.cuda:
            mark.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def nonsky(frames: torch.Tensor) -> torch.Tensor:
    """The share of a frame batch's pixels that differ from their frame's
    top-left pixel by more than 12 in the sum of the 8-bit channels (the
    non-sky coverage of benchmarks/run_all.py::bench_render), over every
    frame of the batch; a device scalar."""
    u8 = (frames.clamp(0.0, 1.0) * 255.0).to(torch.uint8).to(torch.int32)
    return ((u8 - u8[:, :1, :1, :]).abs().sum(-1) > 12).float().mean()


@dataclass
class Calls:
    """What one stretch of calls measured."""

    calls: int = 0
    ticks: int = 0
    seconds: float = 0.0
    step_ms: list = field(default_factory=list)  # each call, actions handed over to observation ready
    tick_ms: list = field(default_factory=list)  # each call into the tick (a stream: the whole segment)
    render_ms: list = field(default_factory=list)  # each call into the frame batch
    entry_host_ms: list = field(default_factory=list)  # each step call on the host clock
    cov_min: torch.Tensor | None = None


class Loop:
    def __init__(self, prog, pool, mix: dict, device: torch.device):
        self.prog, self.pool, self.mix, self.device = prog, pool, mix, device
        self.kind, self.pixels = mix["loop"], mix["observation"] == "pixels"
        self.observer = Observer(mix["observe"])
        self.clock = Clock(device)
        self.ticks = mix["episode_ticks"]
        self.e, self.t, self.state = 0, 0, None
        self.host_obs = None
        if self.kind == "stream":
            self.streams = [prog.actions(pool.stream(e)) for e in range(mix["episodes"])]

    def _range(self, name, on):
        return record_function(f"port_bench.{name}") if on else contextlib.nullcontext()

    def run(self, seconds=None, calls=None, keep=None, ranges=False, coverage=False, ticks=None) -> Calls:
        """Calls until `seconds` have passed or `calls` are made; `keep(i,
        sample)` sees each call's sample; `ticks` cuts a stream call short."""
        out = Calls()
        t0 = time.perf_counter()
        while True:
            if self.kind == "closed":
                m = self._step(out, keep, ranges, coverage)
            else:
                m = self._segment(out, keep, ranges, ticks)
            out.step_ms.append(self.clock.ms(m[0], m[-1]))
            out.tick_ms.append(self.clock.ms(m[1], m[2]))
            if self.pixels:
                out.render_ms.append(self.clock.ms(m[2], m[3]))
            out.calls += 1
            if (seconds is not None and time.perf_counter() - t0 >= seconds) or out.calls == calls:
                break
        out.seconds = time.perf_counter() - t0
        return out

    def _step(self, out, keep, ranges, coverage):
        prog, clock = self.prog, self.clock
        m0 = clock.mark()
        taken = self.state
        if self.t == 0:
            with self._range("reset", ranges):
                taken = prog.reset()
        with self._range("actions", ranges):
            row = self.pool.tick(self.e, self.t)
            acts = prog.actions(row.to(self.device, non_blocking=True))
        m1 = clock.mark()
        h0 = time.perf_counter()
        with self._range("step", ranges):
            new = prog.step(taken, acts)
        out.entry_host_ms.append((time.perf_counter() - h0) * 1e3)
        m2 = clock.mark()
        if self.pixels:
            with self._range("render", ranges):
                got = prog.render(new)
            m3 = clock.mark()
            if coverage:
                c = nonsky(got)
                out.cov_min = c if out.cov_min is None else torch.minimum(out.cov_min, c)
            marks = (m0, m1, m2, m3)
        else:
            with self._range("observe", ranges):
                obs = self.observer(new)
                if self.host_obs is None:
                    self.host_obs = torch.empty(obs.shape, dtype=obs.dtype,
                                                pin_memory=self.device.type == "cuda")
                self.host_obs.copy_(obs, non_blocking=True)
                got = self.host_obs
            marks = (m0, m1, m2)
        end = clock.mark()
        with self._range("wait", ranges):
            clock.wait(end)
        if keep is not None:
            keep(out.calls, lambda: (taken, row, new, got.clone() if got is self.host_obs else got), self.t == 0)
        self.state = new
        out.ticks += 1
        self.t += 1
        if self.t == self.ticks:
            self.t, self.e = 0, self.e + 1
        return (*marks, end)

    def _segment(self, out, keep, ranges, ticks):
        prog, clock = self.prog, self.clock
        m0 = clock.mark()
        with self._range("reset", ranges):
            taken = prog.reset()
        acts = self.streams[self.e % len(self.streams)]
        if ticks is not None:
            acts = acts[:ticks]
        m1 = clock.mark()
        with self._range("collect", ranges):
            self.state, traj = prog.collect(taken, acts, self.observer)
        m2 = clock.mark()
        end = clock.mark()
        with self._range("wait", ranges):
            clock.wait(end)
        if keep is not None:
            e = self.e
            keep(out.calls, lambda: (taken, self.pool.stream(e), traj), True)
        out.ticks += acts.move.shape[0]
        self.e += 1
        return (m0, m1, m2, end)
