"""One process of a multi-process run of the port (the counterpart of
tests/multihost_worker.py: docs/MULTIHOST.md's recipe executed), which
tests/test_torch_multihost.py and chip_smoke.py launch in two processes:

    python3 -m c_game_engine_tpu_torch.parallel.worker PHASE OUTDIR \\
        --coordinator HOST:PORT --processes N --rank R \\
        [--map arena] [--batch 256] [--ticks 8] [--cpu] [--timeout S]

(under torchrun, without --coordinator, --processes and --rank). Each
process joins the group (parallel/distributed.py; its card, or the CPU
with --cpu), builds its envs of a global batch of `--batch` envs
(parallel/mesh.py::shard_sim) and steps them through the map's tick graph
(models/sim.py::rollout; the eager tick on the CPU) with
long_run.walk_and_turn's per-env stream, each process computing its envs'
actions from the global env index.

Phases:
  start   a fresh batch, `ticks` of the stream through
          mesh.sharded_rollout, then a distributed checkpoint
          OUTDIR/ckpt.npz (utils/checkpoint.py: the gathered state,
          written by process 0) and the gathered player positions
          OUTDIR/pos_start.npy (process 0)
  resume  a fresh process group restores this process's envs of
          OUTDIR/ckpt.npz, steps `ticks` more, and writes the gathered
          final state OUTDIR/final.npz (a distributed checkpoint again)
          and OUTDIR/pos_resume.npy

Every process writes OUTDIR/rank<R>_<phase>.json: its envs, its
rollout's seconds, steps/s and wall-clock start and end (the processes
start it together, after a barrier; on a card after its tick graph is
captured), the kernels' launches in it (utils/counters.py), the start
phase's sharded_rollout metrics, the seconds of the checkpoint's gather
and write, and the files under OUTDIR it opened for writing or renamed
(an audit hook: only process 0 may have written a checkpoint). The last
line of a process that succeeded is WORKER_OK; one that failed prints
"worker rank R: PHASE failed after S s: ..." on stderr and exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from c_game_engine_tpu_torch.long_run import walk_and_turn
from c_game_engine_tpu_torch.models.graph_check import kernel_counts
from c_game_engine_tpu_torch.models.sim import load_named_map
from c_game_engine_tpu_torch.parallel import distributed
from c_game_engine_tpu_torch.parallel.mesh import (
    gather_states,
    make_mesh,
    rollout_shards,
    shard_sim,
    sharded_rollout,
    split,
)
from c_game_engine_tpu_torch.utils import counters
from c_game_engine_tpu_torch.utils.checkpoint import load_checkpoint_shard, save_checkpoint

PHASES = ("start", "resume")
CHECKPOINT = {"start": "ckpt.npz", "resume": "final.npz"}


def run_phase(phase: str, out: Path, map_name: str, batch: int, ticks: int) -> dict:
    """One phase in this process of the group; returns its figures."""
    mesh = make_mesh()
    cmap = load_named_map(map_name, mesh[0])
    cmaps, states, _ = shard_sim(cmap, batch, mesh)
    envs = distributed.env_range(batch)
    if phase == "resume":
        states = split(load_checkpoint_shard(out / CHECKPOINT["start"], gather_states(states)), mesh)
    stream = walk_and_turn(ticks, len(envs), mesh[0], envs.start)
    on_card = mesh[0].type == "cuda"
    capture_s = []
    if on_card:
        from c_game_engine_tpu_torch.models.graph import tick_graph

        for cm, st in zip(cmaps, states):
            with torch.cuda.device(cm.device):
                capture_s.append(tick_graph(cm, st).capture_s)
    distributed.sync_global_devices(f"cge_worker_rollout:{phase}")
    counters.reset()
    wall0, t0 = time.time(), time.perf_counter()
    metrics = None
    if phase == "start":
        final, metrics = sharded_rollout(cmap, mesh, batch, ticks, stream[0])
    else:
        final = gather_states(rollout_shards(cmaps, states, split(stream, mesh, axis=1)))
    if on_card:
        torch.cuda.synchronize()
    dt, wall1 = time.perf_counter() - t0, time.time()
    launches = kernel_counts()
    pos = distributed.process_allgather(final.player.pos)
    if distributed.process_index() == 0:
        np.save(out / f"pos_{phase}.npy", pos.numpy())
    path = out / CHECKPOINT[phase]
    t0 = time.perf_counter()
    save_checkpoint(path, final)
    checkpoint_s = time.perf_counter() - t0
    return {
        "phase": phase, "rank": distributed.process_index(), "processes": distributed.process_count(),
        "map": map_name, "batch": batch, "envs": [envs.start, envs.stop], "ticks": ticks,
        "device": str(mesh[0]), "card": torch.cuda.get_device_name(mesh[0]) if on_card else None,
        "rollout_s": dt, "steps_per_s": len(envs) * ticks / dt, "wall": [wall0, wall1],
        "capture_s": capture_s, "launches": launches,
        "metrics": None if metrics is None else {k: float(v) for k, v in metrics.items()},
        "checkpoint": path.name, "checkpoint_s": checkpoint_s,
        "checkpoint_mtime_ns": path.stat().st_mtime_ns,
    }


def _record_writes(out: Path, writes: list):
    """An audit hook that lists every file under `out` opened for writing
    or renamed into place."""
    root = str(out.resolve())
    flags_w = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND

    def hook(event, args):
        if event == "open":
            path, mode, flags = args
            writing = (isinstance(mode, str) and any(c in mode for c in "wax+")) or (
                isinstance(flags, int) and flags & flags_w)
        elif event == "os.rename":
            path, writing = args[1], True
        else:
            return
        if writing and isinstance(path, (str, os.PathLike)) and os.path.abspath(path).startswith(root):
            writes.append(os.path.relpath(os.path.abspath(path), root))

    return hook


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m c_game_engine_tpu_torch.parallel.worker")
    ap.add_argument("phase", choices=PHASES)
    ap.add_argument("outdir")
    ap.add_argument("--coordinator", help="host:port of process 0 (default: torchrun's environment)")
    ap.add_argument("--processes", type=int)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--map", default="arena")
    ap.add_argument("--batch", type=int, default=256, help="global envs")
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the eager tick)")
    ap.add_argument("--timeout", type=float, default=distributed.TIMEOUT_S,
                    help="seconds to wait for the other processes, at start-up and in every collective")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    # one thread a process: the processes share the host's cores, and the
    # one-process run they are held to computes alike
    torch.set_num_threads(1)
    out = Path(args.outdir)
    out.mkdir(parents=True, exist_ok=True)
    writes = []
    sys.addaudithook(_record_writes(out, writes))
    rank = args.rank if args.rank is not None else os.environ.get("RANK", "?")
    try:
        distributed.initialize(args.coordinator, args.processes, args.rank, device="cpu" if args.cpu else None,
                               timeout_s=args.timeout)
        figures = run_phase(args.phase, out, args.map, args.batch, args.ticks)
        distributed.sync_global_devices(f"cge_worker_done:{args.phase}")
        figures["writes"] = sorted(set(writes))
        (out / f"rank{figures['rank']}_{args.phase}.json").write_text(json.dumps(figures))
    except Exception as e:  # noqa: BLE001 - the process's boundary: report, exit non-zero
        traceback.print_exc()
        print(f"worker rank {rank}: {args.phase} failed after {time.perf_counter() - t0:.1f} s: "
              f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        distributed.shutdown()
    print("WORKER_OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
