"""The benchmark of the PyTorch and CUDA port: one cell of BENCHMARK.json,
run once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up loads the cell's map through the port, makes the traffic's actions
from the seed, and warms up every call the window makes (the tick graph's
capture, the render graph's, the collect graph's). The window then runs
the cell's agent loop (harness/loop.py) for `--seconds`. With --trace 0
the result line holds the cell's end-to-end metrics, with --trace 1 its
per-layer metrics, read after the window from the calls' CUDA events,
the program's device counts, a torch.profiler window of a few calls and
what one eager call hands a function of the port, each as the metric's
reader declares (harness/spec.py). A metric that BENCHMARK.json lists
for the cell by name and that reads nothing fails the run. After the
window the program is freed and its outputs are held to the plain
reference (harness/check.py).

The last line of standard output is one JSON object: correct,
attempted, failed, metrics, device, (with --trace 1) breakdown, and
checks, each number compared beside its limit; the same numbers are the
last lines of standard error. A run without a CUDA card, or with fewer
cards than the cell asks for, exits 1 and prints no result, as does a
run after which the process holds a module of JAX or of the JAX package.

`--control tf32|bf16` puts the reference in the program's place in a
lower precision (harness/reference.py::Control), to show the comparison
fails it; the benchmark's own runs do not use it.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(ROOT))
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton_cache")):
    os.environ[var] = str(ROOT / "build" / "port_bench" / sub)
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "c_game_engine_tpu")


def note(text: str) -> None:
    print(f"port_bench: {text}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, taken whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_query() -> subprocess.Popen:
    """nvidia-smi's name, power limit and clocks of the cards, started in
    the background (it takes a while); `card_line` reads it."""
    return subprocess.Popen(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def card_line(query: subprocess.Popen) -> str:
    out, err = query.communicate()
    return out.strip() or f"nvidia-smi: {err.strip()}"


def run_cell(cell, seed, seconds, trace, device, control=None, fault=None, t_process=None):
    """Run `cell` once; returns the result dict (without printing)."""
    import torch

    from harness import check, trace as tr
    from harness.loop import Loop
    from harness.program import Program
    from harness.reference import Control, Reference, full_float32
    from harness.spec import metric_module
    from harness.traffic import Pool

    t_process = T_PROCESS if t_process is None else t_process
    full_float32()
    mix, config, limits = cell.traffic, cell.config, cell.checks["limits"]
    pixels, batch = mix["observation"] == "pixels", mix["envs"]
    if control is None:
        prog = Program(config, batch, device, pixels)
    else:
        prog = Control(config, batch, device, pixels, control)
    if fault is not None:
        prog = fault(prog)
    note(f"program loaded at {time.perf_counter() - t_process:.3f} s")
    mods = {m["name"]: metric_module(m["name"]) for m in (cell.per_layer if trace else cell.end_to_end)}
    counters = sorted({c for mod in mods.values() for c in getattr(mod, "COUNTERS", ())})
    captures = sorted({mod.CAPTURE for mod in mods.values() if hasattr(mod, "CAPTURE")})
    pool = Pool(mix, seed, device)
    loop = Loop(prog, pool, mix, device)
    note(f"traffic made at {time.perf_counter() - t_process:.3f} s")
    # warm-up: every call the window makes, the first of each capturing its graph
    loop.e = mix["episodes"] - 1
    loop.run(calls=mix["warmup_calls"])
    loop.e, loop.t = 0, 0
    counts0 = {k: prog.counter(k) for k in counters}
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    kept = check.Reservoir(cell.checks["sample_calls"], seed)
    first = {}

    def keep(i, make, is_reset):
        if is_reset and "reset" not in first:
            first["reset"] = make()[0]
        kept.offer(i, make)

    # set-up's objects out of the collector's way: a full collection in
    # the window then walks only what the window made
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_process
    note(f"warmed up at {setup_s:.3f} s")
    win = loop.run(seconds=seconds, keep=keep, coverage=bool(trace) and pixels)
    gc.unfreeze()
    counts = {k: prog.counter(k) - counts0[k] for k in counters}
    rec = {"cell": cell, "window": win, "setup_s": setup_s, "counts": counts, "envs": batch, "pixels": pixels,
           "loop": mix["loop"], "timeline": None, "traced_ticks": 0, "captured": {}}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": cell.chips,
                "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0}
    breakdown = None
    if trace:
        n = config["trace_calls"] if mix["loop"] == "closed" else 1
        stream_ticks = None if mix["loop"] == "closed" else config["trace_ticks"]
        activity = torch.profiler.ProfilerActivity
        activities = [activity.CPU] + ([activity.CUDA] if device.type == "cuda" else [])
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(tr.WINDOW):
                traced = loop.run(calls=n, ranges=True, ticks=stream_ticks)
        rec["timeline"], rec["traced_ticks"] = tr.from_profiler(prof), traced.ticks
        del prof
        tl = rec["timeline"]
        dev_info["busy_s"], dev_info["window_s"] = tr.busy_s(tl), tl.window_s
        breakdown = {"device_ops": tr.device_ops(tl), "idle_gaps": tr.idle_gaps(tl)}
        if control is None:
            row = prog.actions(pool.tick(0, 0).to(device))
            for cap in captures:
                rec["captured"][cap] = prog.capture(*cap, loop.state, row)

    # a metric that BENCHMARK.json lists for this cell by name has to read;
    # one listed for every cell is left out where it finds nothing
    metrics, missing = {}, []
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = mods[m["name"]].read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        elif "workloads" in m:
            missing.append(m["name"])

    # the program's outputs against the plain reference, the program freed
    t_check = time.perf_counter()
    samples = kept.items
    taken_reset = first.get("reset")
    loop = pool = None
    prog.close()
    ref = Reference(config, batch, device, pixels)
    if mix["loop"] == "closed":
        per, numbers = check.closed_numbers(ref, samples, taken_reset, mix["observe"], pixels)
    else:
        per, numbers = check.stream_numbers(ref, samples, cell.checks["stream_ticks"], mix["observe"])
    note(f"window {win.calls} calls in {win.seconds:.3f} s; reference check {time.perf_counter() - t_check:.3f} s "
         f"over {len(samples)} samples")
    failed = sum(not check.judge(p, limits) for p in per)
    correct = check.judge(numbers, limits) and failed == 0
    result = {"correct": correct, "attempted": win.calls, "failed": failed, "metrics": metrics,
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["missing"] = missing  # main() takes it out of the line
    result["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32", "bf16"))
    args = ap.parse_args(argv)

    from harness.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        note(f"the cell needs {cell.chips} CUDA card(s), this machine has {n}")
        return 1
    query = card_query()
    torch.set_num_threads(2)
    note(f"{args.workload} seed {args.seed}; card found at {time.perf_counter() - T_PROCESS:.3f} s")
    result = run_cell(cell, args.seed, args.seconds, args.trace, torch.device("cuda", 0), control=args.control)
    note(f"card {card_line(query)}")
    bad = forbidden_modules()
    if bad:
        note(f"the process holds modules of {', '.join(bad)}")
        return 1
    missing = result.pop("missing")
    if missing:
        note(f"metrics listed for {args.workload} read nothing: {', '.join(missing)}")
        return 1
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
