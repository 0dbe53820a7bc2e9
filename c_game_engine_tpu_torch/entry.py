"""Entry point (counterpart of __graft_entry__.py::entry): the graphed step
of the flagship configuration with example arguments.

    python3 -m c_game_engine_tpu_torch.entry

runs the step once and prints "entry(): ok".
"""

from __future__ import annotations

import sys

BATCH = 256


def entry():
    """Returns (fn, (state, actions)): fn(state, actions) is one tick of a
    256-env batch on the committed arena map (the JAX entry point's
    test.gmap needs the reference assets) through the CUDA tick graph."""
    from c_game_engine_tpu_torch.core.actions import Actions
    from c_game_engine_tpu_torch.models.sim import make_sim

    sim = make_sim("arena", BATCH, jit=True, device="cuda")
    return sim.step, (sim.reset(), Actions.zeros((BATCH,), device="cuda"))


if __name__ == "__main__":
    import torch

    if not torch.cuda.is_available():
        print("entry: no CUDA device", file=sys.stderr)
        sys.exit(2)
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    assert int(out.tick[0]) == 1 and bool(torch.isfinite(out.player.pos).all())
    print("entry(): ok")
