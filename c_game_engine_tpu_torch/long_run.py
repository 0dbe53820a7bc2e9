"""Checkpointed long run (counterpart of examples/long_run.py).

    python3 -m c_game_engine_tpu_torch.long_run [map] [total_ticks] [segment]
    python3 -m torch.distributed.run --nproc_per_node N -m c_game_engine_tpu_torch.long_run ...

(defaults: arena, 1200 ticks, segments of 300; CGE_BATCH envs, default
512; map: a committed map's name or a `.gmap` or editor-JSON source path,
compiled by the port, models/sim.py::load_named_map; CGE_CKDIR the
checkpoint directory, default a new temporary one). The env axis is
sharded over the mesh (parallel/mesh.py; every visible card, or the CPU
with `--cpu`); each shard runs segments of the map's tick graph
(models/sim.py::rollout; the eager tick on the CPU) with a per-env
walk-and-turn stream (strafe sin(0.37 i), hold W, turn 0.01 cos(0.11 i)
rad a tick, i the env index). The whole state is checkpointed after each
segment (utils/checkpoint.py), and the run ends with the bitwise resume
proof: restore the second-to-last checkpoint, run one segment again, and
compare every leaf with the uninterrupted run's final state with
`torch.equal`.

Under torchrun (WORLD_SIZE > 1) the same loop runs in a process group
(parallel/distributed.py), one process a card: CGE_BATCH is the global
batch, each process steps its envs (their actions computed from the
global env index), process 0 writes each checkpoint of the gathered state
and prints the log, and the resume proof restores this process's envs of
the checkpoint in every process and compares the gathered leaves. The
default checkpoint directory is process 0's; a group across hosts needs
a CGE_CKDIR that every host sees.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from pathlib import Path

import torch

from c_game_engine_tpu_torch.core.actions import Actions
from c_game_engine_tpu_torch.core.state import tree_leaves
from c_game_engine_tpu_torch.models.sim import load_named_map
from c_game_engine_tpu_torch.parallel import distributed
from c_game_engine_tpu_torch.parallel.mesh import gather_states, make_mesh, rollout_shards, shard_sim, split
from c_game_engine_tpu_torch.utils.checkpoint import load_checkpoint_shard, save_checkpoint


def walk_and_turn(ticks: int, batch: int, device, offset: int = 0) -> Actions:
    """examples/long_run.py's stream, the same action on every tick, of
    the `batch` envs from global env index `offset` on."""
    i = torch.arange(offset, offset + batch, dtype=torch.float32, device=device)
    one = Actions.zeros((batch,), device=device).replace(
        move=torch.stack([torch.sin(i * 0.37), -torch.ones(batch, device=device)], -1),
        look=torch.stack([0.01 * torch.cos(i * 0.11), torch.zeros(batch, device=device)], -1),
    )
    return Actions(*(x.expand(ticks, *x.shape) for x in (one.move, one.look, one.buttons)))


def run(map_name="arena", total_ticks=1200, segment=300, batch=512, device="cuda", ckdir=None, log=print):
    """Run, checkpoint and prove the resume over make_mesh() (every card;
    `[device]` on the CPU; this process's device in a process group, where
    `batch` is global and only process 0 logs); returns a summary dict
    with this process's final state. Raises if the replayed segment
    differs from the uninterrupted run."""
    if total_ticks < 2 * segment or total_ticks % segment:
        raise ValueError(f"total_ticks {total_ticks} must be a multiple of segment {segment}, at least two")
    device = torch.device(device)
    procs = distributed.process_count()
    log = log if distributed.process_index() == 0 else (lambda line: None)
    mesh = make_mesh() if device.type == "cuda" or procs > 1 else make_mesh(devices=[device])
    log(f"mesh: {len(mesh)} device(s) ({', '.join(str(d) for d in mesh)})"
        + (f" in each of {procs} processes" if procs > 1 else ""))
    cmap = load_named_map(map_name, mesh[0])
    cmaps, states, _ = shard_sim(cmap, batch, mesh)
    envs = distributed.env_range(batch)
    streams = split(walk_and_turn(segment, len(envs), mesh[0], envs.start), mesh, axis=1)
    if not ckdir:
        made = tempfile.mkdtemp(prefix="cge_longrun_") if distributed.process_index() == 0 else None
        ckdir = distributed.broadcast_str(made)
    ckdir = Path(ckdir)
    t0 = time.perf_counter()
    for done in range(segment, total_ticks + 1, segment):
        states = rollout_shards(cmaps, states, streams)
        state = gather_states(states)
        save_checkpoint(ckdir / f"ck_{done:08d}.npz", state)
        rate = batch * done / (time.perf_counter() - t0)
        log(f"tick {done}/{total_ticks}  {rate:,.0f} env-steps/s  checkpoint -> ck_{done:08d}.npz")

    prev = ckdir / f"ck_{total_ticks - segment:08d}.npz"
    replay = gather_states(rollout_shards(cmaps, split(load_checkpoint_shard(prev, state), mesh), streams))
    whole, whole_replay = (distributed.process_allgather(s) for s in (state, replay))
    leaves = list(zip(tree_leaves(whole), tree_leaves(whole_replay)))
    differ = [name for (name, a), (_, b) in leaves if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"resume from {prev.name} differs from the uninterrupted run in {differ}")
    log(f"resume proof: restored {prev.name}, re-ran {segment} ticks -> BITWISE equal to the "
        f"uninterrupted run ({len(leaves)} leaves)")
    mean = whole.player.pos.mean(0).tolist()
    log(f"final mean player pos: {[round(x, 3) for x in mean]}")
    return {"map": cmap.aux["name"], "batch": batch, "ticks": total_ticks, "segment": segment,
            "devices": len(mesh), "processes": procs, "leaves": len(leaves),
            "env_steps_per_s": batch * total_ticks / (time.perf_counter() - t0),
            "final_state": state, "checkpoints": ckdir}


def main(argv) -> int:
    device = "cpu" if "--cpu" in argv else "cuda"
    args = [a for a in argv if a != "--cpu"]
    if device == "cuda" and not torch.cuda.is_available():
        print("long_run: no CUDA device (pass --cpu for the eager tick on the CPU)", file=sys.stderr)
        return 2
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        distributed.initialize(device="cpu" if device == "cpu" else None)
    try:
        run(args[0] if args else "arena", int(args[1]) if len(args) > 1 else 1200,
            int(args[2]) if len(args) > 2 else 300, int(os.environ.get("CGE_BATCH", "512")), device,
            os.environ.get("CGE_CKDIR"))
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
