"""Checkpointed long run on one GPU (counterpart of examples/long_run.py).

    python3 -m c_game_engine_tpu_torch.long_run [map] [total_ticks] [segment]

(defaults: arena, 1200 ticks, segments of 300; CGE_BATCH envs, default
512). Runs segments of the map's tick graph (models/sim.py::rollout) with
a per-env walk-and-turn stream (strafe sin(0.37 i), hold W, turn
0.01 cos(0.11 i) rad a tick, i the env index), checkpoints the whole state
after each segment (utils/checkpoint.py), and ends with the bitwise resume
proof: restore the second-to-last checkpoint, run one segment again, and
compare every leaf with the uninterrupted run's final state with
`torch.equal`. `--cpu` runs the eager tick on the CPU. The sharded mesh of
the JAX script waits for a port of parallel/mesh.py.
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
from c_game_engine_tpu_torch.models.sim import make_sim
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
    """Run, checkpoint and prove the resume; returns a summary dict. Raises
    if the replayed segment differs from the uninterrupted run."""
    if total_ticks < 2 * segment or total_ticks % segment:
        raise ValueError(f"total_ticks {total_ticks} must be a multiple of segment {segment}, at least two")
    sim = make_sim(map_name, batch, jit=torch.device(device).type == "cuda", device=device)
    ckdir = Path(ckdir or tempfile.mkdtemp(prefix="cge_longrun_"))
    acts = walk_and_turn(segment, batch, device)
    state = sim.reset()
    t0 = time.perf_counter()
    for done in range(segment, total_ticks + 1, segment):
        state = sim.rollout(state, acts)
        save_checkpoint(ckdir / f"ck_{done:08d}.npz", state)
        rate = batch * done / (time.perf_counter() - t0)
        log(f"tick {done}/{total_ticks}  {rate:,.0f} env-steps/s  checkpoint -> ck_{done:08d}.npz")

    prev = ckdir / f"ck_{total_ticks - segment:08d}.npz"
    replay = sim.rollout(load_checkpoint(prev, state), acts)
    leaves = list(zip(tree_leaves(state), tree_leaves(replay)))
    differ = [name for (name, a), (_, b) in leaves if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"resume from {prev.name} differs from the uninterrupted run in {differ}")
    log(f"resume proof: restored {prev.name}, re-ran {segment} ticks -> BITWISE equal to the "
        f"uninterrupted run ({len(leaves)} leaves)")
    mean = state.player.pos.mean(0).tolist()
    log(f"final mean player pos: {[round(x, 3) for x in mean]}")
    return {"map": sim.name, "batch": batch, "ticks": total_ticks, "segment": segment,
            "leaves": len(leaves), "env_steps_per_s": batch * total_ticks / (time.perf_counter() - t0),
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
