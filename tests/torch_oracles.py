"""Shared harness of the oracle tests (tests/test_torch_oracles*.py): the
JAX package's closed-form acceptance tests run through both packages.

A scenario's map is the JAX test's own `tests/worldgen.py` geometry,
compiled by the JAX compiler with `stub_resolver()` (every model a 0.2 m
box, so physboxes compile without the reference assets) and carried over
to the port with `export_and_load`. `Pair` steps a JAX batch (jitted
`step_batch`, the XLA path on the CPU) and a port batch (`step_batch`,
the kernels' plain versions on the CPU) from the same state with the same
actions, and records every tick of both, so a test asserts the JAX test's
own bar on the port's trajectory and the parity bars between the two:
player position 2e-3, `on_ground` equal, actor position and quaternion
5e-3 (tests/test_tpu_parity.py's bars).
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import torch

from tests.torch_export_map import make_stub_map
from tests.torch_parity import NUM_BUTTONS, export_and_load, jax_actions, torch_actions

MU = float(np.sqrt(0.2 * 4.25))  # tests/test_solver_oracle.py: body 0.2 x map 4.25
G = 9.81
TPS = 60.0
PLAYER_TOL = 2e-3
ACTOR_TOL = 5e-3
JUMP, SLOW, NOCLIP = 0, 2, 4  # core/actions.py Button


def cube_resolver(directory):
    """A JAX AssetResolver over tests/torch_map_sources.py's assets written
    under `directory`, answering a model that is not there with
    `model/cube.gmdl` (the 0.2 m box of `cube_model()`, the stub's box with
    a model behind it), for maps whose actors read their model's bounds (a
    laser emitter)."""
    from c_game_engine_tpu.compiler.models import AssetResolver
    from tests.torch_map_sources import CUBE_MODEL, write_assets

    write_assets(directory)

    class CubeResolver(AssetResolver):
        def model(self, rel):
            return super().model(rel if self.resolve(rel) is not None else CUBE_MODEL)

    return CubeResolver(search_paths=[directory])


def both(jax_cmap, tmp_dir):
    """(JAX map, the port's map) of one compiled JAX map."""
    return jax_cmap, export_and_load(jax_cmap, tmp_dir)


def row_of(jc, cls):
    return next(i for i, c in enumerate(jc.aux["actor_classes"]) if c == cls)


def actions(ticks, batch):
    """Zero (move, look, buttons) arrays [T, B, ...] to fill in."""
    return (np.zeros((ticks, batch, 2), np.float32), np.zeros((ticks, batch, 2), np.float32),
            np.zeros((ticks, batch, NUM_BUTTONS), bool))


class Pair:
    """A JAX batch and a port batch of `batch` envs on one map, stepped
    together. `trace[side][leaf]` is [ticks run, B, ...] of the player's
    pos, vel, on_ground and noclip and the actors' pos, quat, vel, omega
    and sleep, after each tick."""

    LEAVES = ("player.pos", "player.vel", "player.on_ground", "player.noclip", "actors.pos", "actors.quat",
              "actors.vel", "actors.omega", "actors.sleep")

    def __init__(self, jc, tc, batch, yaw=None):
        import jax

        from c_game_engine_tpu.models.sim import reset_batch as j_reset
        from c_game_engine_tpu.models.sim import step_batch as j_step
        from c_game_engine_tpu_torch.core.step import step_batch
        from c_game_engine_tpu_torch.models.sim import reset_batch

        self.jc, self.tc = jc, tc
        self._jstep = jax.jit(lambda s, a: j_step(jc, s, a))
        self._tstep = lambda s, a: step_batch(tc, s, a)
        self.js, self.ts = j_reset(jc, batch), reset_batch(tc, batch)
        if yaw is not None:
            self.js = self.js.replace(player=self.js.player.replace(yaw=jax.numpy.asarray(yaw, np.float32)))
            self.ts.player.yaw.copy_(torch.as_tensor(np.asarray(yaw, np.float32)))
        self.trace = {"jax": {k: [] for k in self.LEAVES}, "port": {k: [] for k in self.LEAVES}}

    def run(self, move, look, btn):
        for t in range(len(move)):
            self.js = self._jstep(self.js, jax_actions(move[t], look[t], btn[t]))
            self.ts = self._tstep(self.ts, torch_actions(move[t], look[t], btn[t]))
            for side, st in (("jax", self.js), ("port", self.ts)):
                for k in self.LEAVES:
                    group, leaf = k.split(".")
                    x = getattr(getattr(st, group), leaf)
                    self.trace[side][k].append(x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))
        return self

    def set_actor(self, env, row, pos=None, vel=None, sleep=None):
        """Give actor `row` of env `env` a position, a velocity and a sleep
        counter in both batches (the JAX tests' `.at[i].set(...)` edits)."""
        ja = self.js.actors
        if pos is not None:
            ja = ja.replace(pos=ja.pos.at[env, row].set(np.asarray(pos, np.float32)))
            self.ts.actors.pos[env, row] = torch.as_tensor(np.asarray(pos, np.float32))
        if vel is not None:
            ja = ja.replace(vel=ja.vel.at[env, row].set(np.asarray(vel, np.float32)))
            self.ts.actors.vel[env, row] = torch.as_tensor(np.asarray(vel, np.float32))
        if sleep is not None:
            ja = ja.replace(sleep=ja.sleep.at[env, row].set(sleep))
            self.ts.actors.sleep[env, row] = sleep
        self.js = self.js.replace(actors=ja)

    def port(self, leaf):
        return np.stack(self.trace["port"][leaf])

    def jax(self, leaf):
        return np.stack(self.trace["jax"][leaf])

    def split(self, envs=slice(None), rows=slice(None)):
        """{tick: worst bar broken} for each tick on which a parity bar
        breaks (player position 2e-3, on_ground, actor position and
        quaternion 5e-3); empty where the packages agree throughout."""
        bad = {}
        for leaf, tol in (("player.pos", PLAYER_TOL), ("actors.pos", ACTOR_TOL), ("actors.quat", ACTOR_TOL)):
            d = np.abs(self.port(leaf)[:, envs] - self.jax(leaf)[:, envs])
            if leaf.startswith("actors"):
                d = d[:, :, rows]
            worst = d.reshape(len(d), -1).max(-1) if d.size else np.zeros(len(d))
            for t in np.nonzero(worst > tol)[0]:
                bad.setdefault(int(t), (leaf, float(worst[t])))
        g = (self.port("player.on_ground")[:, envs] != self.jax("player.on_ground")[:, envs]).reshape(
            len(self.trace["port"]["player.pos"]), -1).any(-1)
        for t in np.nonzero(g)[0]:
            bad.setdefault(int(t), ("player.on_ground", 1.0))
        return dict(sorted(bad.items()))

    def assert_parity(self, envs=slice(None), rows=slice(None)):
        """The parity bars on every recorded tick."""
        bad = self.split(envs, rows)
        assert not bad, list(bad.items())[:5]


def ramp(theta, tmp, tess=0):
    """The JAX test's `_ramp_map(theta)` (npc_john dropped on the plane
    y = -tan(theta) x), compiled with the stub resolver."""
    import tests.test_solver_oracle as oracle

    with mock.patch.object(oracle, "make_map", make_stub_map):
        return both(oracle._ramp_map(theta, tess=tess), tmp)


def slide(jc, tc):
    """60 ticks to land and slide, then a 30-tick window: (pair, v1, v2)."""
    i = row_of(jc, "NPC_JOHN")
    pair = Pair(jc, tc, 1).run(*actions(90, 1))
    return pair, pair.port("actors.vel")[59, 0, i], pair.port("actors.vel")[89, 0, i]


def assert_slides(v1, v2, theta=55.0, window=30):
    """The slide bar: a = g (sin t - mu cos t) within [0.5, 1.5] of the
    prediction, downhill (+x, -y), no sideways drift."""
    tr = np.radians(theta)
    a_pred = G * (np.sin(tr) - MU * np.cos(tr))
    a_meas = np.linalg.norm(v2 - v1) * TPS / window
    assert 0.5 * a_pred < a_meas < 1.5 * a_pred, (a_meas, a_pred)
    d = (v2 - v1) / np.linalg.norm(v2 - v1)
    assert d[0] > 0.5 and d[1] < 0.0 and abs(d[2]) < 0.2, d
    return a_meas
