"""Diagnostic behind the two places where tests/test_torch_oracles*.py hold
the parity bars only up to a tick (ROADMAP faults o and p). Not a test;
run from the repo root on the CPU (about two minutes):

    JAX_PLATFORMS=cpu python tests/torch_oracle_divergence.py [wall|hull]

wall: tests/test_physics.py::test_wall_blocks_player's walk (W from the
  spawn of the freefall map into the z = -8 wall), stepped by the port and
  by the jitted JAX step_batch for 84 ticks; then ticks 84-91 again from
  the jitted JAX state, by the JAX step_batch run op by op (jax.disable_jit).
  Prints the player's position on each side: the jitted JAX step climbs
  (y rises from -0.55) where the op-by-op JAX step and the port slide
  along the wall (x leaves 0).
hull: the hull rollout of tests/test_torch_oracles_assets.py (the pushed
  pair and the 2-high stack, in two envs); prints each body's largest
  position and quaternion difference between the packages at ticks
  20-299 and the tick it first exceeds 5e-3.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def wall() -> None:
    import jax

    from c_game_engine_tpu.models.sim import step_batch as j_step
    from tests.torch_export_map import make_stub_map
    from tests.torch_oracles import Pair, actions, both
    from tests.torch_parity import jax_actions
    from tests.worldgen import actor

    jc, tc = both(make_stub_map([actor("prop_physbox", (0, 2.0, 4))]), Path(tempfile.mkdtemp()))
    move, look, btn = actions(92, 1)
    move[:, 0, 1] = -1.0
    pair = Pair(jc, tc, 1).run(move[:84], look[:84], btn[:84])
    js = pair.js
    pair.run(move[84:], look[84:], btn[84:])
    with jax.disable_jit():
        for t in range(84, 92):
            js = j_step(jc, js, jax_actions(move[t], look[t], btn[t]))
            print(f"tick {t}: port {pair.port('player.pos')[t, 0]}  jitted JAX {pair.jax('player.pos')[t, 0]}  "
                  f"op-by-op JAX {np.asarray(js.player.pos[0])}", flush=True)


def hull() -> None:
    import tests.test_torch_oracles_assets as T

    class Factory:
        def mktemp(self, name):
            return Path(tempfile.mkdtemp(prefix=name))

    pair, rows, _ = T.hulls.__wrapped__(Factory())
    for leaf in ("actors.pos", "actors.quat"):
        d = np.abs(pair.port(leaf) - pair.jax(leaf)).max(-1)  # [T, B, N]
        for name, env, row in (("pushed target", T.PUSH, rows["pair"][1]), ("stack bottom", T.STACK, rows["stack"][0]),
                               ("stack top", T.STACK, rows["stack"][1])):
            x = d[:, env, row]
            over = np.nonzero(x > 5e-3)[0]
            print(f"{leaf} {name}: " + ", ".join(f"t{t} {x[t]:.2e}" for t in (20, 60, 90, 95, 120, 180, 299))
                  + f"; first over 5e-3: {over[0] if len(over) else None}", flush=True)


if __name__ == "__main__":
    which = sys.argv[1:] or ["wall", "hull"]
    for w in which:
        {"wall": wall, "hull": hull}[w]()
