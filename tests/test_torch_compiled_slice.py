"""The slice on a map the port compiled itself, on the CPU: the editor
JSON source of tests/torch_map_sources.py (`rooms.json`: a floor step, a
doorway with a door a trigger opens, a coin, a physbox and a baked
lightmap) compiled by each package's compiler, then 60 ticks of a
scripted stream at B=128, one 128-lane block of K1
(tests/torch_parity.py::stream_batch's stream 0: hold W with a seeded
look jitter, interact and fire presses; from the spawn it walks through
the coin and the trigger toward the door) through each package's rollout: within tests/test_tpu_parity.py's
bars (player position 2e-3, every other float 5e-3, integers and bools
exact). Then one 128 x 128 frame of env 0 (the port's tile route; the
JAX package's XLA route) within ROADMAP's frame bar: at most 0.2% of
pixels off by more than 1/255."""

from __future__ import annotations

import numpy as np
import pytest

from tests import torch_map_sources as S
from tests.torch_parity import assert_leaves_match, jax_actions, jax_leaves, stream_batch, torch_actions, torch_leaves

B, TICKS, SIZE, FRAME_BAR = 128, 60, 128, 0.002


@pytest.fixture(scope="module")
def rolled(tmp_path_factory):
    import jax

    from c_game_engine_tpu.compiler.compile import compile_map as j_compile
    from c_game_engine_tpu.models.sim import reset_batch as j_reset
    from c_game_engine_tpu.models.sim import rollout as j_rollout
    from c_game_engine_tpu_torch.compiler.compile import compile_map
    from c_game_engine_tpu_torch.models.sim import reset_batch, rollout

    src = S.write_sources(tmp_path_factory.mktemp("sources"))
    sp, path = [src["assets"]], str(src["rooms"])
    jc, tc = j_compile(path, search_paths=sp), compile_map(path, search_paths=sp, device="cpu")
    streams = stream_batch(TICKS, B, seed=1)
    js = jax.jit(lambda s, a: j_rollout(jc, s, a))(j_reset(jc, B), jax_actions(*streams))
    ts = rollout(tc, reset_batch(tc, B), torch_actions(*streams))
    return jc, tc, js, ts


def test_rollout_on_the_compiled_map_matches_jax(rolled):
    _, tc, js, ts = rolled
    assert_leaves_match(jax_leaves(js), torch_leaves(ts), {"player.pos": 2e-3})
    coin, door = (tc.aux["actor_classes"].index(c) for c in ("COIN", "DOOR"))
    assert int(ts.save.coins[0]) == 1 and not bool(ts.actors.active[0, coin])  # block 0 took the coin
    assert int(ts.actors.idata[0, door, 0]) != 0  # and the trigger opened the door
    assert float(ts.player.pos[0, 0]) > -2.0


def test_frame_on_the_compiled_map_matches_jax(rolled):
    import jax

    from c_game_engine_tpu.render.bundle import build_render_bundle as j_build
    from c_game_engine_tpu.render.raster import render_batch as j_render
    from c_game_engine_tpu_torch.core.state import tree_map
    from c_game_engine_tpu_torch.render.bundle import build_render_bundle
    from c_game_engine_tpu_torch.render.raster import render_batch

    jc, tc, js, ts = rolled
    jb, tb = j_build(jc), build_render_bundle(tc)
    want = np.asarray(jax.jit(lambda s: j_render(jb, jc, s, SIZE, SIZE, backend="xla"))(
        jax.tree.map(lambda x: x[:1], js)))
    got = render_batch(tb, tc, tree_map(lambda x: x[:1], ts), SIZE, SIZE).numpy()
    assert got.shape == want.shape == (1, SIZE, SIZE, 3)
    off = float((np.abs(got - want).max(-1) > 1 / 255).mean())
    print(f"rooms.json env 0 after {TICKS} ticks, {SIZE}x{SIZE}: {off:.4%} of pixels off by more than 1/255")
    assert off <= FRAME_BAR and float(got.std()) > 0.02
