"""Diagnostic behind the stack contracts of tests/test_torch_bodies.py (d):
where the port and the JAX package part ways on a dropped 3-box stack, and
how far the JAX package moves a kicked stack's bottom box. Not a test;
run from the repo root on the CPU:

    JAX_PLATFORMS=cpu python tests/torch_stack_divergence.py [z] [ticks]

1. Drops tests/test_stacking.py's 3-box stack at (4, z) of box_room
   (default z = 4, on the shared diagonal edge of the two floor
   triangles) and steps it with the port's rigid-body step and with the
   JAX function (its Pallas path, K3 in interpret mode) side by side, each
   from its own previous state. Prints per tick the largest difference in
   position, velocity and angular velocity, and both sides' sleep counters.
2. Restarts the JAX side from the port's state at the last tick and steps
   both 12 ticks from that one state, to show whether the port's regime is
   also the JAX function's.
3. Runs the JAX package's full tick (XLA path) on the contract map of
   test (d) (the stack at (4, 3), a 4-box stack, an npc_john) for 120 ticks,
   kicks the 3-stack's bottom box at 2 m/s along +x and prints how far it
   travels in 6 ticks.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

DT = 1.0 / 60.0
NAMES = ("pos", "quat", "vel", "omega", "sleep", "warm_n", "warm_pair", "warm_pair_idx")


def side_by_side(z: float, ticks: int) -> None:
    import jax
    from jax.experimental.pallas import tpu as pltpu

    import c_game_engine_tpu.physics.batched as jb
    from c_game_engine_tpu.models.sim import reset_batch as j_reset
    from c_game_engine_tpu_torch.core.state import state_from_numpy, state_to_numpy
    from c_game_engine_tpu_torch.physics.bodies import step_bodies_batched
    from tests.torch_export_map import make_stub_map
    from tests.torch_parity import export_and_load
    from tests.worldgen import actor

    jc = make_stub_map([actor("prop_physbox", (4.0, -0.7 + 0.45 * i, z)) for i in range(3)],
                       spawn=(0.0, 0.0, -4.0))
    tc = export_and_load(jc, Path(tempfile.mkdtemp()))
    rows = [i for i, c in enumerate(jc.aux["actor_classes"]) if c == "PHYSBOX"]
    use_pallas = jb._use_pallas
    jb._use_pallas = lambda: True  # read when f is traced, on its first call
    f = jax.jit(lambda a, pp, pv: jb.step_bodies_batched(jc, a, pp, pv, DT))
    st = jax.tree.map(np.asarray, j_reset(jc, 1))
    ts = state_from_numpy(st, tc)

    def both(ja, ta):
        with pltpu.force_tpu_interpret_mode():
            J = [np.asarray(x) for x in f(ja, st.player.pos, st.player.vel)]
        jb._use_pallas = use_pallas
        P = step_bodies_batched(tc, ta, ts.player.pos, ts.player.vel, DT)
        err = [float(np.abs(P[k].numpy().astype(np.float64) - J[k]).max()) for k in (0, 2, 3)]
        return ja.replace(**dict(zip(NAMES, J))), ta.replace(**dict(zip(NAMES, P))), err, J, P

    ja, ta = st.actors, ts.actors
    print(f"3-box stack at (4, {z}): tick, max |diff| of pos / vel / omega, JAX sleep, port sleep")
    for t in range(ticks):
        ja, ta, err, J, P = both(ja, ta)
        print(t + 1, " ".join(f"{e:.1e}" for e in err), J[4][0, rows].tolist(), P[4].numpy()[0, rows].tolist())
    print("from the port's state at the last tick, both sides:")
    ja = st.actors.replace(**{k: state_to_numpy(getattr(ta, k)) for k in NAMES})
    for t in range(12):
        ja, ta, err, J, P = both(ja, ta)
        print(t + 1, " ".join(f"{e:.1e}" for e in err), J[4][0, rows].tolist(), P[4].numpy()[0, rows].tolist())


def kick() -> None:
    import jax
    import jax.numpy as jnp

    from c_game_engine_tpu.core.actions import Actions
    from c_game_engine_tpu.core.state import reset
    from c_game_engine_tpu.core.step import step
    from tests.torch_export_map import make_stub_map
    from tests.worldgen import actor

    cm = make_stub_map(
        [actor("prop_physbox", (4.0, -0.7 + 0.45 * i, 3.0)) for i in range(3)]
        + [actor("prop_physbox", (-4.0, -0.7 + 0.45 * i, 4.0)) for i in range(4)]
        + [actor("npc_john", (2.0, -0.4, 2.0))],
        spawn=(0.0, 0.0, -4.0),
    )
    sfn = jax.jit(lambda s, a: step(cm, s, a))
    st, a = reset(cm), Actions.zeros()
    for _ in range(120):
        st = sfn(st, a)
    rows = [i for i, c in enumerate(cm.aux["actor_classes"]) if c == "PHYSBOX"][:3]
    by = min(rows, key=lambda i: float(st.actors.pos[i, 1]))
    x0 = float(st.actors.pos[by, 0])
    st = st.replace(actors=st.actors.replace(vel=st.actors.vel.at[by].set(jnp.array([2.0, 0.0, 0.0])),
                                             sleep=st.actors.sleep.at[by].set(0)))
    for _ in range(6):
        st = sfn(st, a)
    print(f"JAX tick (XLA path), contract map: kicked box x {x0:.6f} -> {float(st.actors.pos[by, 0]):.6f}, "
          f"sleep {[int(st.actors.sleep[i]) for i in rows]}")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    z = float(sys.argv[1]) if len(sys.argv) > 1 else 4.0
    ticks = int(sys.argv[2]) if len(sys.argv) > 2 else 60
    side_by_side(z, ticks)
    kick()
