"""Shared inputs of the app-layer parity tests (tests/test_torch_ui.py,
tests/test_torch_screens.py, tests/test_torch_game.py): the widget assets
in both packages, scripted UI input sequences made from a seed with
numpy, and ROADMAP's frame bar.

The JAX package's widget and text draws run op by op (as its GameApp
calls them); `jax_sampler_jitted` runs the atlas sampler they call
(render/textures.py::sample) as one jitted XLA program per shape
instead, which makes the JAX side about four times faster here and
changes no frame beyond 1e-7.

The committed bundles are asset-free, so both packages draw with the
synthetic UI assets of c_game_engine_tpu_torch/render/synthetic_hud.py
(the 14 UITEX_* slots and a small font on arena_lit's procedural
textures). The JAX atlas is built from the committed arena_lit bundle's
leaves, which tests/test_torch_map_export.py holds equal to a fresh JAX
export, so no JAX map is compiled for the widget tests.
"""

from __future__ import annotations

import contextlib
import functools
import json

import numpy as np
import pytest

from tests import torch_parity  # noqa: F401  (one torch thread a process)

FRAME_BAR = 0.002  # ROADMAP: under 0.2% of pixels may differ by more than 1/255
MAX_INSERT = 8


@functools.cache
def assets():
    """(port bundle of arena_lit with the synthetic assets, JAX atlas, JAX
    UiAssets, JAX HudAssets), on the CPU."""
    import jax.numpy as jnp

    from c_game_engine_tpu.render.hud import HudAssets
    from c_game_engine_tpu.render.textures import TextureAtlas
    from c_game_engine_tpu.ui.stack import UiAssets
    from c_game_engine_tpu_torch.render.bundle import ATLAS_ARRAYS, MAP_DIR, load_render_map
    from c_game_engine_tpu_torch.render.synthetic_hud import synthetic_arrays, synthetic_ui_arrays, with_synthetic_hud

    _, rb = load_render_map("arena_lit", "cpu")
    with np.load(MAP_DIR / "arena_lit_bundle.npz") as z:
        leaves = {k: z[f"atlas.{k}"] for k in ATLAS_ARRAYS}
    names = json.loads((MAP_DIR / "arena_lit_bundle.json").read_text())["tex_names"]
    atlas = TextureAtlas(**{k: jnp.asarray(v) for k, v in leaves.items()})
    atlas = atlas.replace(blocked=atlas.blocked.astype(jnp.bfloat16))
    ui = UiAssets(**{k[3:]: jnp.asarray(v) for k, v in synthetic_ui_arrays(names, leaves["table"]).items()})
    hud = HudAssets(**{k[4:]: jnp.asarray(v) for k, v in synthetic_arrays(names).items() if k.startswith("hud.")})
    return with_synthetic_hud(rb), atlas, ui, hud


@contextlib.contextmanager
def _jitted_sampler():
    import jax

    import c_game_engine_tpu.render.hud as j_hud
    import c_game_engine_tpu.render.textures as j_tex

    mp = pytest.MonkeyPatch()
    fast = jax.jit(j_tex.sample)
    mp.setattr(j_hud, "sample", fast)
    mp.setattr(j_tex, "sample", fast)
    try:
        yield
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def jax_sampler_jitted():
    """For a test module: the JAX atlas sampler as a jitted function."""
    with _jitted_sampler():
        yield


def off_share(got, want) -> float:
    """Share of pixels whose largest channel difference exceeds 1/255."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((np.abs(got.astype(np.float64) - want).max(-1) > 1 / 255).mean())


def assert_frame_bar(got, want, label=""):
    off = off_share(got, want)
    assert off < FRAME_BAR and np.isfinite(np.asarray(got)).all(), f"{label}: {off:.4%} of pixels off"
    return off


def background(h, w, seed):
    """A seeded random frame [h, w, 3] in [0, 1] (float32 numpy)."""
    return np.random.default_rng(seed).uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)


def _text(s: str) -> np.ndarray:
    out = np.full(MAX_INSERT, -1, np.int32)
    out[:len(s[:MAX_INSERT])] = [ord(c) for c in s[:MAX_INSERT]]
    return out


def ui_script(kind, rect, seed: int, n_random: int = 12) -> list:
    """Scripted UiInput steps [(x, y, {key: value})] for a stack with
    control kinds `kind` [N] and rects `rect` [N, 4]: hover, press and
    release on each control (buttons, checkboxes and radios fire),
    tab / shift-tab / dpad focus cycling, textbox insert, home, end,
    arrows, backspace, delete and an insert past max_len, slider arrows and
    a drag with and without shift, controller mode with OK press and release,
    then `n_random` seeded random steps."""
    rng = np.random.default_rng(seed)
    n = len(kind)
    none = (-1.0, -1.0)
    steps = []
    centre = lambda i: (float(rect[i, 0] + rect[i, 2] / 2), float(rect[i, 1] + rect[i, 3] / 2))
    for i in range(n):
        x, y = centre(i)
        steps += [(x, y, {}), (x, y, {"mouse_down": True, "mouse_pressed": True}), (x, y, {"mouse_released": True})]
    steps += [(*none, {"tab": True})] * (n + 1)
    steps += [(*none, {"tab": True, "shift": True})] * 2 + [(*none, {"dpad_down": True}), (*none, {"dpad_up": True})]
    for i in np.nonzero(kind == 4)[0]:  # textboxes
        steps += [(*centre(i), {"mouse_down": True, "mouse_pressed": True}), (*centre(i), {"mouse_released": True})]
        for kw in ({"text": _text("hello")}, {"home": True}, {"text": _text("X")}, {"right": True},
                   {"backspace": True}, {"delete": True}, {"left": True}, {"end": True},
                   {"text": _text("abcdefgh")}, {"text": _text("ijklmnop")}, {"text": _text("qrstuvwx")},
                   {"text": _text("yz012345")}, {"text": _text("6789")}, {"backspace": True}, {"home": True},
                   {"delete": True}, {"delete": True}):
            steps.append((*none, kw))
    for i in np.nonzero(kind == 1)[0]:  # sliders: focus, arrows, drag
        steps += [(*centre(i), {"mouse_down": True, "mouse_pressed": True}), (*centre(i), {"mouse_released": True})]
        steps += [(*none, {"right": True}), (*none, {"right": True}), (*none, {"left": True}),
                  (*none, {"dpad_left": True}), (*none, {"dpad_right": True})]
        y = float(rect[i, 1] + 5)
        for t in (0.0, 0.137, 0.5, 0.731, 1.2, -0.1):
            x = float(rect[i, 0] + t * rect[i, 2])
            steps += [(x, y, {"mouse_down": True}), (x, y, {"mouse_down": True, "shift": True})]
    steps += [(*none, {"controller": True}), (*none, {"controller": True, "dpad_down": True}),
              (*none, {"controller": True, "ok_pressed": True}), (*none, {"controller": True, "ok_released": True}),
              (*none, {"controller": True, "dpad_right": True}), (*none, {"controller": True, "dpad_up": True}),
              (*none, {"controller": True, "ok_released": True})]
    keys = ("mouse_down", "mouse_pressed", "mouse_released", "tab", "shift", "space", "enter", "left", "right",
            "home", "end", "backspace", "delete", "dpad_up", "dpad_down", "dpad_left", "dpad_right")
    for _ in range(n_random):
        i = int(rng.integers(0, n))
        x = float(rect[i, 0] + rng.uniform(-0.1, 1.1) * rect[i, 2])
        y = float(rect[i, 1] + rng.uniform(-0.1, 1.1) * rect[i, 3])
        kw = {k: True for k in keys if rng.random() < 0.12}
        if rng.random() < 0.2:
            kw["text"] = _text("".join(chr(c) for c in rng.integers(32, 127, int(rng.integers(1, 4)))))
        steps.append((x, y, kw))
    return steps


def jax_input(x, y, kw):
    from c_game_engine_tpu.ui.stack import UiInput

    return UiInput.at_mouse(x, y, **kw)


def port_input(x, y, kw):
    from c_game_engine_tpu_torch.ui.stack import UiInput

    return UiInput.at_mouse(x, y, **kw)


UI_STATE_FIELDS = ("focused", "active", "active_state", "value", "checked", "text", "cursor")


def assert_ui_states_equal(port_st, jax_st, label=""):
    """Every integer and boolean field exactly, `value` within 1e-6."""
    for k in UI_STATE_FIELDS:
        p, j = getattr(port_st, k).cpu().numpy(), np.asarray(getattr(jax_st, k))
        assert p.shape == j.shape, (label, k, p.shape, j.shape)
        if k == "value":
            np.testing.assert_allclose(p, j, atol=1e-6, rtol=0, err_msg=f"{label} {k}")
        else:
            np.testing.assert_array_equal(p, j, err_msg=f"{label} {k}")
