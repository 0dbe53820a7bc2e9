"""Checkpointed long run (counterpart of examples/long_run.py).

    python3 -m c_game_engine_tpu_torch.long_run [map] [total_ticks] [segment]

(defaults: arena, 1200 ticks, segments of 300; CGE_BATCH envs, default
512; map: a committed map's name or a `.gmap` or editor-JSON source path,
compiled by the port, models/sim.py::load_named_map). The env axis is sharded over the mesh (parallel/mesh.py; every
visible card, or the CPU with `--cpu`); each shard runs segments of the
map's tick graph (models/sim.py::rollout; the eager tick on the CPU) with
a per-env walk-and-turn stream (strafe sin(0.37 i), hold W, turn
0.01 cos(0.11 i) rad a tick, i the env index). The whole state is
checkpointed after each segment (utils/checkpoint.py), and the run ends
with the bitwise resume proof: restore the second-to-last checkpoint, run
one segment again, and compare every leaf with the uninterrupted run's
final state with `torch.equal`.
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
from c_game_engine_tpu_torch.parallel.mesh import gather_states, make_mesh, rollout_shards, shard_sim, split
from c_game_engine_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint


def walk_and_turn(ticks: int, batch: int, device) -> Actions:
    """examples/long_run.py's stream, the same action on every tick."""
    i = torch.arange(batch, dtype=torch.float32, device=device)
    one = Actions.zeros((batch,), device=device).replace(
        move=torch.stack([torch.sin(i * 0.37), -torch.ones(batch, device=device)], -1),
        look=torch.stack([0.01 * torch.cos(i * 0.11), torch.zeros(batch, device=device)], -1),
    )
    return Actions(*(x.expand(ticks, *x.shape) for x in (one.move, one.look, one.buttons)))


def run(map_name="arena", total_ticks=1200, segment=300, batch=512, device="cuda", ckdir=None, log=print):
    """Run, checkpoint and prove the resume over make_mesh() (every card;
    `[device]` on the CPU); returns a summary dict. Raises if the replayed
    segment differs from the uninterrupted run."""
    if total_ticks < 2 * segment or total_ticks % segment:
        raise ValueError(f"total_ticks {total_ticks} must be a multiple of segment {segment}, at least two")
    device = torch.device(device)
    mesh = make_mesh() if device.type == "cuda" else make_mesh(devices=[device])
    log(f"mesh: {len(mesh)} device(s) ({', '.join(str(d) for d in mesh)})")
    cmap = load_named_map(map_name, mesh[0])
    cmaps, states, _ = shard_sim(cmap, batch, mesh)
    streams = split(walk_and_turn(segment, batch, mesh[0]), mesh, axis=1)
    ckdir = Path(ckdir or tempfile.mkdtemp(prefix="cge_longrun_"))
    t0 = time.perf_counter()
    for done in range(segment, total_ticks + 1, segment):
        states = rollout_shards(cmaps, states, streams)
        state = gather_states(states)
        save_checkpoint(ckdir / f"ck_{done:08d}.npz", state)
        rate = batch * done / (time.perf_counter() - t0)
        log(f"tick {done}/{total_ticks}  {rate:,.0f} env-steps/s  checkpoint -> ck_{done:08d}.npz")

    prev = ckdir / f"ck_{total_ticks - segment:08d}.npz"
    replay = gather_states(rollout_shards(cmaps, split(load_checkpoint(prev, state), mesh), streams))
    leaves = list(zip(tree_leaves(state), tree_leaves(replay)))
    differ = [name for (name, a), (_, b) in leaves if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"resume from {prev.name} differs from the uninterrupted run in {differ}")
    log(f"resume proof: restored {prev.name}, re-ran {segment} ticks -> BITWISE equal to the "
        f"uninterrupted run ({len(leaves)} leaves)")
    mean = state.player.pos.mean(0).tolist()
    log(f"final mean player pos: {[round(x, 3) for x in mean]}")
    return {"map": cmap.aux["name"], "batch": batch, "ticks": total_ticks, "segment": segment,
            "devices": len(mesh), "leaves": len(leaves),
            "env_steps_per_s": batch * total_ticks / (time.perf_counter() - t0),
            "final_state": state, "checkpoints": ckdir}


def main(argv) -> int:
    device = "cpu" if "--cpu" in argv else "cuda"
    args = [a for a in argv if a != "--cpu"]
    if device == "cuda" and not torch.cuda.is_available():
        print("long_run: no CUDA device (pass --cpu for the eager tick on the CPU)", file=sys.stderr)
        return 2
    run(args[0] if args else "arena", int(args[1]) if len(args) > 1 else 1200,
        int(args[2]) if len(args) > 2 else 300, int(os.environ.get("CGE_BATCH", "512")), device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
