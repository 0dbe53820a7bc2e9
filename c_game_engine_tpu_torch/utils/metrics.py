"""Host-side performance instrumentation (counterpart of
c_game_engine_tpu/utils/metrics.py).

TickBenchmark stands in for the reference's FrameBenchmark (avg/min/max
frame time, FrameBenchmark.c:20-92) and RateGraph for its FrameGrapher
(a 30-sample ring at 100 ms, FrameGrapher.c:16-62); profile_trace records
a torch.profiler trace. TickBenchmark reads the host clock: a caller that
times work on the card synchronizes the device inside the timed block
(`torch.cuda.synchronize()`), as the JAX callers block on their result.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class TickBenchmark:
    """avg/min/max wall time per batched tick (FrameBenchmark equivalent)."""

    count: int = 0
    total: float = 0.0
    best: float = float("inf")
    worst: float = 0.0
    _t: float | None = None

    def start(self):
        self._t = time.perf_counter()

    def stop(self):
        dt = time.perf_counter() - self._t
        self.count += 1
        self.total += dt
        self.best = min(self.best, dt)
        self.worst = max(self.worst, dt)
        return dt

    @contextlib.contextmanager
    def tick(self):
        self.start()
        yield
        self.stop()

    def report(self, batch: int = 1) -> str:
        if not self.count:
            return "no samples"
        avg = self.total / self.count
        return (
            f"ticks={self.count} avg={avg * 1e3:.2f}ms min={self.best * 1e3:.2f}ms "
            f"max={self.worst * 1e3:.2f}ms -> {batch / avg:,.0f} env-steps/s"
        )


@dataclass
class RateGraph:
    """Fixed-size sample ring of rates (FrameGrapher equivalent: 30 samples,
    0.1 s interval)."""

    max_samples: int = 30
    interval: float = 0.1
    samples: list = field(default_factory=list)
    _count: int = 0
    _last: float = field(default_factory=time.perf_counter)

    def add_event(self, n: int = 1):
        self._count += n
        now = time.perf_counter()
        if now - self._last >= self.interval:
            self.samples.append(self._count / (now - self._last))
            self._count = 0
            self._last = now
            if len(self.samples) > self.max_samples:
                self.samples.pop(0)

    def sparkline(self) -> str:
        if not self.samples:
            return ""
        blocks = "▁▂▃▄▅▆▇█"
        hi = max(self.samples) or 1.0
        return "".join(blocks[min(int(s / hi * 7.99), 7)] for s in self.samples)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """torch.profiler over the block, CPU activity and, where a CUDA device
    is present, CUDA activity; on exit the trace is written to
    `logdir/trace.json` (Chrome trace format). Yields the profiler, whose
    `key_averages()` the caller may read after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
