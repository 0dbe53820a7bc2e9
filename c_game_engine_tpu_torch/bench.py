"""Benchmark: batched physics steps per second on one GPU (counterpart of
bench.py).

    python3 -m c_game_engine_tpu_torch.bench [map]

(map: a committed map's name, default arena, or a `.gmap` or editor-JSON
source path, which the port compiles through its compile cache;
bench.py's test.gmap is one such path where the reference assets are
present.) BENCH_BATCH envs
(default 4096) run BENCH_TICKS ticks (default 240) of
models/sim.py::bench_actions (hold W, turn 0.01 rad a tick) through the
map's tick graph: the graph is captured first (its seconds are reported
apart), one rollout of the same stream shape warms up, and one more is
timed. Prints ONE JSON line with bench.py's keys (metric, value, unit,
vs_baseline against its 1,000,000 steps/s target) and the map, the card's
`nvidia-smi` name and power limit, and the capture seconds.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

TARGET = 1_000_000.0  # bench.py's baseline, steps/s


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of
    the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bench(map_name="arena", batch=4096, n_ticks=240) -> dict:
    import torch

    from c_game_engine_tpu_torch.models.graph import tick_graph
    from c_game_engine_tpu_torch.models.sim import bench_actions, make_sim

    sim = make_sim(map_name, batch)
    state, acts = sim.reset(), bench_actions(n_ticks, batch)
    graph = tick_graph(sim.cmap, state)
    out = sim.rollout(state, acts)  # warm-up with the timed stream's shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sim.rollout(state, acts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(out.player.pos).all()) or int(out.tick[0]) != n_ticks:
        raise AssertionError(f"bench on {map_name}: final state not finite or at tick {int(out.tick[0])}")
    steps = batch * n_ticks / dt
    name, power = (s.strip() for s in card_line().split(","))
    return {"metric": f"combined physics steps/sec/chip ({batch} envs, {sim.name})",
            "value": round(steps, 1), "unit": "steps/s", "vs_baseline": round(steps / TARGET, 4),
            "map": sim.name, "card": name, "power_limit": power,
            "capture_s": round(graph.capture_s, 3), "graph_pool_bytes": graph.pool_bytes}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(bench(argv[0] if argv else "arena", int(os.environ.get("BENCH_BATCH", "4096")),
                           int(os.environ.get("BENCH_TICKS", "240")))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
