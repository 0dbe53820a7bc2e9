"""Slice-level parity: the port's reset / rollout / change_map against the
JAX package's on the arena map (tests/torch_export_map.py), on the CPU.

The rollout runs 30 ticks at B=256: envs 0-127 follow one scripted stream
and envs 128-255 another (tests/torch_parity.py::block_streams), so every
128-lane block of the port's kernels is a single point, as in bench.py.
(At B=8 the port pads lanes with zeros to 128 as physics/batched.py:238-247
does; the padded block's chunk box would then stretch to the origin, where
the per-block candidate set has no counterpart on the JAX XLA path.)

Bars: player position 2e-3, on_ground exact, actor position and quaternion
5e-3 (tests/test_tpu_parity.py), every other float leaf 5e-3, and every
integer and bool leaf exact (door state, signals, coins, audio handles).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from tests.torch_parity import (
    assert_leaves_match,
    export_and_load,
    jax_actions,
    jax_leaves,
    stream_batch,
    torch_actions,
    torch_leaves,
)

B, TICKS = 256, 30


@pytest.fixture(scope="module")
def arena(tmp_path_factory):
    from tests.torch_export_map import compile_arena

    jc = compile_arena()
    return jc, export_and_load(jc, tmp_path_factory.mktemp("arena"))


@pytest.fixture(scope="module")
def rollouts(arena):
    import jax

    from c_game_engine_tpu.models.sim import reset_batch as j_reset
    from c_game_engine_tpu.models.sim import rollout as j_rollout
    from c_game_engine_tpu_torch.models.sim import reset_batch, rollout

    jc, tc = arena
    streams = stream_batch(TICKS, B, seed=0)
    js = jax.jit(lambda s, a: j_rollout(jc, s, a))(j_reset(jc, B), jax_actions(*streams))
    ts = rollout(tc, reset_batch(tc, B), torch_actions(*streams))
    return js, ts


def test_reset_matches_leaf_for_leaf(arena):
    from c_game_engine_tpu.models.sim import reset_batch as j_reset
    from c_game_engine_tpu_torch.models.sim import reset_batch

    jc, tc = arena
    assert_leaves_match(jax_leaves(j_reset(jc, 4)), torch_leaves(reset_batch(tc, 4)), default=0)


def test_state_carries_over_both_ways(arena, rollouts):
    import jax

    from c_game_engine_tpu_torch.core.state import state_from_numpy, state_to_numpy

    _, tc = arena
    js, _ = rollouts
    ported = state_from_numpy(jax.tree.map(np.asarray, js), tc)
    J = jax_leaves(js)
    assert_leaves_match(J, torch_leaves(ported), default=0)
    back = state_to_numpy(ported)
    np.testing.assert_array_equal(back["actors"]["idata"], J["actors.idata"])
    np.testing.assert_array_equal(back["audio"]["snd"], J["audio.snd"])


def test_rollout_matches_jax(rollouts):
    js, ts = rollouts
    assert_leaves_match(jax_leaves(js), torch_leaves(ts), {"player.pos": 2e-3})


def test_rollout_runs_the_scripted_events(rollouts):
    """The streams reach what the parity above is meant to cover."""
    from c_game_engine_tpu_torch.actors.defs import DoorState

    _, ts = rollouts
    assert int(ts.save.coins[0]) >= 1  # block 0 walked through a coin
    assert int(ts.actors.idata[0, 4, 0]) == int(DoorState.OPENING)  # trigger -> door
    assert int(ts.sound_plays[0]) >= 2  # io_proxy and trigger -> sound_player
    assert float(ts.actors.fdata[0, 5, 0]) < 20.0  # the laser beam stops at the door
    assert float(ts.player.pos[128, 1]) > 0.8  # block 1 climbed the stairs
    assert int(ts.save.coins[128]) == 0


def test_rollout_is_deterministic(arena, rollouts):
    from c_game_engine_tpu_torch.models.sim import reset_batch, rollout

    _, tc = arena
    _, ts = rollouts
    again = rollout(tc, reset_batch(tc, B), torch_actions(*stream_batch(TICKS, B, seed=0)))
    A, Z = torch_leaves(ts), torch_leaves(again)
    for k in A:
        assert A[k].tobytes() == Z[k].tobytes(), k


def test_change_map_carries_save_and_frame(arena, rollouts):
    from c_game_engine_tpu.models.sim import change_map as j_change
    from c_game_engine_tpu_torch.models.sim import change_map

    jc, tc = arena
    js, ts = rollouts
    P = torch_leaves(change_map(tc, ts))
    assert_leaves_match(jax_leaves(j_change(jc, js)), P, default=0)
    assert int(P["frame"][0]) == TICKS and int(P["tick"][0]) == 0


def test_dynamic_bodies_match_jax(tmp_path):
    """A map with one dynamic body (an npc_john, whose hull cloud takes the
    vertex branch of the body-contact kernel K3) rolls out on the port as
    in the JAX package: 10 ticks at B=128 with no input."""
    import jax

    from c_game_engine_tpu.models.sim import reset_batch as j_reset
    from c_game_engine_tpu.models.sim import rollout as j_rollout
    from c_game_engine_tpu_torch.core.actions import Actions
    from c_game_engine_tpu_torch.models.sim import reset_batch, rollout
    from c_game_engine_tpu_torch.ops import body_contacts
    from tests.worldgen import actor, make_map

    jc = make_map([actor("npc_john", (2.0, -0.5, 0.0))])
    assert jc.aux["num_dynamic"] == 1 and not jc.aux["hulls_are_boxes"]
    tc = export_and_load(jc, tmp_path)
    acts = Actions.zeros((10, 128), device="cpu")
    js = jax.jit(lambda s, a: j_rollout(jc, s, a))(j_reset(jc, 128), jax_actions(
        acts.move.numpy(), acts.look.numpy(), acts.buttons.numpy()))
    before = body_contacts.launches
    ts = rollout(tc, reset_batch(tc, 128), acts)
    assert body_contacts.launches == before  # the plain version on the CPU
    J, P = jax_leaves(js), torch_leaves(ts)
    assert_leaves_match(J, P, {"player.pos": 2e-3})
    john = jc.aux["actor_classes"].index("NPC_JOHN")
    assert -0.52 < P["actors.pos"][0, john, 1] < -0.48  # stands on the floor (-1 + 0.5)


def test_port_never_imports_jax(tmp_path):
    """Importing every module of the port loads neither jax nor the JAX
    package, and leaves TF32 off; nor does running its map compiler: the
    sources of tests/torch_map_sources.py written, rooms.json through
    compile_map_source (its bake) and compile_map, arena_lit.gmap through
    compile_map and build_render_bundle, and load_compiled through the
    compile cache (whose JAX counterpart imports jax inside a function)."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import importlib, pkgutil, sys, torch\n"
        "import c_game_engine_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'c_game_engine_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from tests.torch_map_sources import write_sources\n"
        "from c_game_engine_tpu_torch.compiler.cache import load_compiled\n"
        "from c_game_engine_tpu_torch.compiler.compile import compile_map\n"
        "from c_game_engine_tpu_torch.compiler.sectors import compile_map_source\n"
        "from c_game_engine_tpu_torch.render.bundle import build_render_bundle\n"
        f"src = write_sources({str(tmp_path / 'src')!r})\n"
        "sp = [src['assets']]\n"
        "assert compile_map_source(str(src['rooms']), device='cpu').lightmap.max() > 0\n"
        "assert compile_map(str(src['rooms']), search_paths=sp, device='cpu').aux['num_dynamic'] == 1\n"
        "assert build_render_bundle(compile_map(str(src['arena_lit']), search_paths=sp, device='cpu')).live_tri_bound > 0\n"
        "assert load_compiled(src['arena'], sp, device='cpu')[1] is not None\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'c_game_engine_tpu'))\n"
        "assert not bad, bad\n"
        "assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32\n"
    )
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, CGE_TORCH_MAP_CACHE_DIR=str(tmp_path / "cache"))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, env=env)
    assert out.returncode == 0, out.stderr
    assert sorted(q.suffix for q in (tmp_path / "cache").iterdir()) == [".json", ".json", ".npz", ".npz"]
