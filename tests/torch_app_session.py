"""The scripted app session (c_game_engine_tpu_torch/models/game_check.py)
on the port's GameApp and on the JAX package's, on the CPU, for
tests/test_torch_game.py and tests/test_torch_game_batch2.py.

The JAX GameApp is built without any `.gmap`: its map_dir holds empty
arena_lit.gmap and arena_orb.gmap files, so both apps list the same two
levels (the port's map_dir holds the committed arena_lit and arena_orb
files); its map and bundle caches hold the JAX arena_lit map and bundle
(with render/synthetic_hud.py's HUD, UI and viewmodel arrays) under
arena_lit's path and under test.gmap's, the UI atlas its render_frame
reads before a level loads, so compile_map never runs (the session
never loads arena_orb, whose JAX compile takes about a minute); its UI
sound lengths and bank come from audio/synthetic_sounds.py's files, as
the port's do (`sound_dir`).

The JAX app's in-game frames go through a jitted render_with_hud (one
XLA program per bundle, map, size and options, kept for the process)
instead of the op-by-op call its render_frame makes, which takes about 30
s here for the first frame, and its ui_tick through a jitted ui_process
(as tests/test_ui.py runs it; the session drags no slider, where XLA
could fuse a multiply-add); the widget screens run op by op around the
jitted atlas sampler (tests/torch_ui_inputs.py).

Held after every step of the session: the screen, the selected level,
the splash tick, the Options, the UI audio channel table and every
widget screen's UiState (integers and booleans exact, slider values
within 1e-6); the fired events; the first frame of each screen the
session reaches (game_check.FIRST_FRAMES) within ROADMAP's frame bar;
at the end the players' positions within 2e-3 and the UI mix within
1e-6. The session's in-game ticks are TICKS each way (chip_smoke.py's
app phase runs 60 each way on the card): the port's eager CPU tick takes
about 0.15 s.
"""

from __future__ import annotations

import dataclasses
import functools
import shutil

import numpy as np

from tests.torch_ui_inputs import _jitted_sampler, assert_frame_bar, assert_ui_states_equal

SIZE = 128
TICKS = 10


@functools.cache
def jax_world():
    """(JAX arena_lit map, its bundle with the synthetic assets)."""
    import jax.numpy as jnp

    from c_game_engine_tpu.render.hud import HudAssets
    from c_game_engine_tpu.ui.stack import UiAssets
    from c_game_engine_tpu_torch.render.synthetic_hud import synthetic_arrays, synthetic_ui_arrays
    from tests.torch_frames import jax_arena_lit

    jc, jb = jax_arena_lit()
    arrays = {k: jnp.asarray(v) for k, v in synthetic_arrays(jb.tex_names).items()}
    ui = {k[3:]: jnp.asarray(v) for k, v in synthetic_ui_arrays(jb.tex_names, np.asarray(jb.atlas.table)).items()}
    jb = jb.replace(hud=HudAssets(**{k[4:]: v for k, v in arrays.items() if k.startswith("hud.")}),
                    ui=UiAssets(**ui), **{k: v for k, v in arrays.items() if k.startswith("vm_")})
    return jc, jb


@functools.cache
def _jitted_render_with_hud(orig):
    import jax

    cache = {}

    def fast(bundle, cmap, state, height=256, width=256, **kw):
        key = (id(bundle), id(cmap), height, width, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = jax.jit(lambda s: orig(bundle, cmap, s, height, width, **kw))
        return cache[key](state)

    return fast


def jax_app(tmp, batch, sounds):
    import jax.numpy as jnp

    from c_game_engine_tpu.audio.bank import BUILTIN_SOUNDS, build_sound_bank
    from c_game_engine_tpu.compiler.models import AssetResolver
    from c_game_engine_tpu.models.game import GameApp
    from c_game_engine_tpu_torch.audio.synthetic_sounds import synthetic_lengths

    d = tmp / "jax_maps"
    d.mkdir()
    for name in ("arena_lit", "arena_orb"):
        (d / f"{name}.gmap").touch()
    app = GameApp(map_dir=str(d), batch=batch)
    jc, jb = jax_world()
    for name in ("arena_lit", "test"):
        app._cmap_cache[str(d / f"{name}.gmap")] = jc
        app._bundle_cache[str(d / f"{name}.gmap")] = jb
    app._ui_lengths = jnp.asarray(synthetic_lengths())
    app._ui_bank = build_sound_bank(AssetResolver(search_paths=[sounds]), BUILTIN_SOUNDS)
    return app


def port_app(tmp, batch, sounds):
    from c_game_engine_tpu_torch.models.game import GameApp
    from c_game_engine_tpu_torch.models.sim import MAPS

    d = tmp / "port_maps"
    d.mkdir()
    for name in ("arena_lit", "arena_orb"):
        for suffix in (".npz", ".json", "_bundle.npz", "_bundle.json"):
            shutil.copy(MAPS / f"{name}{suffix}", d / f"{name}{suffix}")
    return GameApp(map_dir=d, batch=batch, device="cpu", synthetic_assets=True, sound_dir=sounds)


def _snapshot(app, port: bool):
    """The app's host and widget state after a step."""
    audio = {f.name: np.asarray(getattr(app.ui_audio, f.name)) for f in dataclasses.fields(app.ui_audio)}
    if port:
        audio = {k: v[0] for k, v in audio.items()}
    return {"screen": app.screen.value, "selected": app.selected_level, "splash": app.splash_tick,
            "options": dataclasses.asdict(app.options), "audio": audio,
            "ui": {s.value: ui[2] for s, ui in app._ui.items()}}


def run_session(tmp_path, batch, labels, ticks=TICKS):
    """Both apps through the session; returns (port record, JAX record,
    port snapshots, JAX snapshots, port app, JAX app)."""
    import jax
    import pytest

    import c_game_engine_tpu.render.raster as j_raster
    import c_game_engine_tpu.ui.stack as j_stack
    from c_game_engine_tpu.core.actions import Actions as JActions
    from c_game_engine_tpu.ui.stack import UiInput as JUiInput
    from c_game_engine_tpu_torch.audio.synthetic_sounds import write_synthetic_sounds
    from c_game_engine_tpu_torch.core.actions import Actions
    from c_game_engine_tpu_torch.models.game_check import app_script, run_script
    from c_game_engine_tpu_torch.ui.stack import UiInput

    sounds = write_synthetic_sounds(tmp_path / "sounds")
    papp, japp = port_app(tmp_path, batch, sounds), jax_app(tmp_path, batch, sounds)
    assert papp.list_levels() == japp.list_levels() == ["arena_lit", "arena_orb"]
    steps = app_script(papp.list_levels(), "arena_lit", ticks)

    def port_actions(t):
        a = Actions.zeros((batch,), device="cpu")
        a.move[:, 1] = -1.0
        a.look[:, 0] = 0.01
        return a

    def jax_actions(t):
        a = JActions.zeros((batch,))
        return a.replace(move=a.move.at[:, 1].set(-1.0), look=a.look.at[:, 0].set(0.01))

    p_snaps, j_snaps = [], []
    p_rec = run_script(papp, steps, lambda kw: UiInput.at_mouse(-1.0, -1.0, **kw), port_actions, SIZE,
                       on_step=lambda app: p_snaps.append(_snapshot(app, True)), labels=labels)
    mp = pytest.MonkeyPatch()
    mp.setattr(j_raster, "render_with_hud", _jitted_render_with_hud(j_raster.render_with_hud))
    mp.setattr(j_stack, "ui_process", jax.jit(j_stack.ui_process))
    try:
        with _jitted_sampler():
            j_rec = run_script(japp, steps, lambda kw: JUiInput.at_mouse(-1.0, -1.0, **kw), jax_actions, SIZE,
                               on_step=lambda app: j_snaps.append(_snapshot(app, False)), labels=labels)
    finally:
        mp.undo()
    return p_rec, j_rec, p_snaps, j_snaps, papp, japp


def check_session_matches_jax(tmp_path, batch, labels=None):
    """The session at `batch`, its frames of `labels` (default
    game_check.FIRST_FRAMES) held to the JAX app's."""
    from c_game_engine_tpu_torch.models.game_check import FIRST_FRAMES, check_session

    labels = FIRST_FRAMES if labels is None else labels
    p_rec, j_rec, p_snaps, j_snaps, papp, japp = run_session(tmp_path, batch, labels)
    check_session(p_rec)
    assert p_rec["screens"] == j_rec["screens"] and p_rec["events"] == j_rec["events"]
    assert len(p_snaps) == len(j_snaps)
    for k, (p, j) in enumerate(zip(p_snaps, j_snaps)):
        label = f"step {k} ({p['screen']})"
        assert (p["screen"], p["selected"], p["splash"], p["options"]) == \
            (j["screen"], j["selected"], j["splash"], j["options"]), label
        for f, v in p["audio"].items():
            np.testing.assert_array_equal(v, np.asarray(j["audio"][f]), err_msg=f"{label} audio {f}")
        assert sorted(p["ui"]) == sorted(j["ui"]), label
        for s, st in p["ui"].items():
            assert_ui_states_equal(st, j["ui"][s], f"{label} {s}")
    assert p_snaps[-1]["options"]["fov"] == 91.0 and (p_snaps[-1]["audio"]["snd"] >= 0).sum() >= 3
    assert sorted(p_rec["frames"]) == sorted(j_rec["frames"]) == sorted(labels)
    offs = {}
    for label, frame in p_rec["frames"].items():
        assert frame.shape == (SIZE, SIZE, 3)
        offs[label] = assert_frame_bar(frame.numpy(), np.asarray(j_rec["frames"][label]), label)
    # every widget screen drew something over what it covers
    for label in {"menu", "paused", "options", "video_options_fov"} & set(labels):
        assert float(frame_delta(p_rec["frames"], label)) > 0.01, label
    np.testing.assert_allclose(papp.state.player.pos.numpy(), np.asarray(japp.state.player.pos), atol=2e-3, rtol=0)
    assert int(papp.state.tick[0]) == int(japp.state.tick[0]) == 2 * TICKS + 1
    np.testing.assert_allclose(papp.mix_ui_audio(800).numpy(), np.asarray(japp.mix_ui_audio(800)), atol=1e-6,
                               rtol=0)
    print(f"app session at batch {batch}: frames off by more than 1/255 {offs}")


def frame_delta(frames, label):
    """Mean change of a widget screen's frame from the frame under it (the
    world frame for the pause screen, black for the menu and options)."""
    base = {"paused": frames["in_game"]}.get(label)
    f = frames[label]
    return (f - base).abs().mean() if base is not None else f.abs().mean()
