"""The widget stack (ui/stack.py), the debug overlay (render/dprint.py)
and the port's imports against the JAX package on the CPU.

(a) ui_process on tests/test_ui.py's rig stack (every control kind) and
    on every screen stack of ui/screens.py, over the scripted sequences of
    tests/torch_ui_inputs.py::ui_script (mouse hover, press and release on
    every control, tab and shift-tab, dpad, slider arrows and drags with
    and without shift, textbox insert, home, end, arrows, backspace,
    delete and inserts past max_len, controller mode, seeded random
    steps), each side from its own state: focused, active, active_state,
    checked, text, cursor and the activation vector exactly equal, value
    within 1e-6. The JAX function runs eagerly, as the JAX GameApp calls
    it, so XLA fuses no multiply-add into the slider's drag.
(b) ui_draw, draw_ninepatch and draw_rect at 128 x 128 over seeded
    backgrounds with the synthetic UI assets, and dprint_overlay with the
    UI and HUD fonts: ROADMAP's frame bar (under 0.2% of pixels off by more
    than 1/255).
(c) DPrintConsole on tests/test_dprint.py's sequences, ansi_color on every
    code, and standard_debug_lines on the same state: equal.
(d) No module of the port and not chip_smoke.py imports jax or the JAX
    package (an AST scan).
"""

from __future__ import annotations

import ast
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_ui_inputs import (  # noqa: F401  (jax_sampler_jitted: a fixture)
    assert_frame_bar,
    assert_ui_states_equal,
    assets,
    background,
    jax_input,
    jax_sampler_jitted,
    port_input,
    ui_script,
)

SIZE = 128
pytestmark = pytest.mark.usefixtures("jax_sampler_jitted")


def _rig(pkg):
    """tests/test_ui.py's rig stack, built by `pkg`'s ui module."""
    ui = pkg
    return ui.build_stack([
        ui.button((0, 80), (480, 40), "Start", ui.Anchor.MIDDLE_CENTER),
        ui.button((0, 130), (480, 40), "Quit", ui.Anchor.MIDDLE_CENTER),
        ui.slider((0, 180), (480, 40), "Volume", ui.Anchor.MIDDLE_CENTER, 0.0, 1.0, 0.5, 0.01, 0.1, percent=True),
        ui.checkbox((0, 230), (480, 40), "VSync", ui.Anchor.MIDDLE_CENTER, True),
        ui.radio((0, 280), (230, 40), "A", ui.Anchor.MIDDLE_CENTER, True, 1, 0),
        ui.radio((240, 280), (230, 40), "B", ui.Anchor.MIDDLE_CENTER, False, 1, 1),
        ui.textbox((0, 330), (480, 40), "name...", ui.Anchor.MIDDLE_CENTER),
    ])


def _stacks(name):
    """(port stack, JAX stack) of a stack name."""
    import c_game_engine_tpu.ui as j_ui
    import c_game_engine_tpu_torch.ui as p_ui
    from c_game_engine_tpu.ui import screens as j_scr
    from c_game_engine_tpu.utils.config import Options as JOptions
    from c_game_engine_tpu_torch.ui import screens as p_scr
    from c_game_engine_tpu_torch.utils.config import Options

    if name == "rig":
        return _rig(p_ui), _rig(j_ui)
    builder = name + "_stack"
    if name in ("video_options", "sound_options", "input_options"):
        return getattr(p_scr, builder)(Options())[0], getattr(j_scr, builder)(JOptions())[0]
    return getattr(p_scr, builder)()[0], getattr(j_scr, builder)()[0]


STACKS = ("rig", "menu", "pause", "options", "video_options", "sound_options", "input_options")


@functools.cache
def _run(name, seed):
    """Roll the stack's script through both packages (the rig's also from a
    controller user's initial state); returns the port and JAX (state,
    activated) after every step."""
    from c_game_engine_tpu.ui.stack import init_ui_state as j_init
    from c_game_engine_tpu.ui.stack import ui_process as j_process
    from c_game_engine_tpu_torch.ui.stack import init_ui_state, ui_process

    sd, jsd = _stacks(name)
    for f in ("kind", "rect", "label", "vmin", "vmax", "step", "alt_step", "percent", "group", "max_len",
              "placeholder", "init_value", "init_checked"):
        np.testing.assert_array_equal(getattr(sd, f), np.asarray(getattr(jsd, f)), err_msg=f)
    out = []
    for controller in ((False, True) if name == "rig" else (False,)):
        st, js = init_ui_state(sd, controller, device="cpu"), j_init(jsd, controller)
        assert_ui_states_equal(st, js, f"{name} init")
        for x, y, kw in ui_script(sd.kind, sd.rect, seed + controller):
            st, act = ui_process(sd, st, port_input(x, y, kw))
            js, jact = j_process(jsd, js, jax_input(x, y, kw))
            out.append((st, act, js, jact, (x, y, kw)))
    return sd, out


@pytest.mark.parametrize("name", STACKS)
def test_ui_process_matches_jax(name):
    sd, steps = _run(name, seed=STACKS.index(name))
    fired = 0
    for k, (st, act, js, jact, inp) in enumerate(steps):
        assert_ui_states_equal(st, js, f"{name} step {k} {inp}")
        np.testing.assert_array_equal(act.numpy(), np.asarray(jact), err_msg=f"{name} step {k} activated")
        fired += int(act.sum())
    assert fired > 0
    if name == "rig":
        final = steps[-1][0]
        # every kind of control changed: a slider moved, the checkbox and
        # the radios toggled, the textbox holds text
        values = np.array([s.value[2] for s, *_ in steps])
        assert len(set(values.tolist())) > 5
        assert any(not s.checked[3] for s, *_ in steps) and any(bool(s.checked[5]) for s, *_ in steps)
        assert any(int((s.text[6] >= 0).sum()) == sd.max_len[6] for s, *_ in steps)
        assert final.text.dtype == torch.int32


def test_ui_draw_matches_jax():
    """The rig drawn from its script's state with the slider dragged under
    the mouse and focused (the focus ring), the checkbox cleared, B
    checked and text typed. (The menu screens' tests draw hovered and
    pressed buttons.)"""
    from c_game_engine_tpu.ui.stack import ui_draw as j_draw
    from c_game_engine_tpu_torch.ui.stack import ui_draw

    sd, steps = _run("rig", seed=0)
    picks = [s for s in steps if s[-1][2].get("mouse_down") and int(s[0].active) == 2 and int(s[0].focused) == 2
             and bool(s[0].checked[5]) and int((s[0].text[6] >= 0).sum()) > 3]
    _, jsd = _stacks("rig")
    rb, jatlas, jui, _ = assets()
    for k, (st, _, js, _, _) in enumerate(picks[2:3]):
        bg = background(SIZE, SIZE, k)
        got = ui_draw(sd, st, rb.atlas, rb.ui, torch.from_numpy(bg))
        want = j_draw(jsd, js, jatlas, jui, bg)
        assert_frame_bar(got.numpy(), want, f"ui_draw {k}")
        assert np.abs(got.numpy() - bg).max() > 0.1  # widgets were drawn


def test_draw_ninepatch_and_rect_match_jax():
    import jax.numpy as jnp

    from c_game_engine_tpu.ui.screens import draw_rect as j_rect
    from c_game_engine_tpu.ui.stack import draw_ninepatch as j_nine
    from c_game_engine_tpu_torch.ui.screens import draw_rect
    from c_game_engine_tpu_torch.ui.stack import draw_ninepatch

    rb, jatlas, jui, _ = assets()
    rng = np.random.default_rng(7)
    for k in range(6):
        bg = background(SIZE, SIZE, 10 + k)
        x0, y0 = rng.uniform(-20, 100, 2).astype(np.float32)
        w, h = rng.uniform(4, 120, 2).astype(np.float32)
        corner = float(rng.uniform(0, 20))
        slot = int(rng.integers(0, 14))
        got = draw_ninepatch(torch.from_numpy(bg), rb.atlas, rb.ui, slot, x0, y0, w, h, corner)
        want = j_nine(jnp.asarray(bg), jatlas, jui, slot, jnp.float32(x0), jnp.float32(y0), jnp.float32(w),
                      jnp.float32(h), corner)
        assert_frame_bar(got.numpy(), want, f"ninepatch {k}")
        rgba = tuple(float(c) for c in rng.uniform(0, 1, 4))
        rect = (float(x0), float(y0), float(w), float(h))
        assert_frame_bar(draw_rect(torch.from_numpy(bg), *rect, rgba).numpy(), j_rect(jnp.asarray(bg), *rect, rgba),
                         f"rect {k}")


def test_dprint_overlay_matches_jax():
    from c_game_engine_tpu.render.dprint import dprint_overlay as j_overlay
    from c_game_engine_tpu_torch.render.dprint import ansi_color, dprint_overlay

    rb, jatlas, jui, jhud = assets()
    lines = [("HELLO WORLD", (1.0, 1.0, 1.0, 1.0)), ("Position: (1.00, -0.55, 3.25)", ansi_color(92)),
             ("console line ~{}|", ansi_color(33))]
    for k, (font, jfont) in enumerate(((rb.ui, jui), (rb.hud, jhud))):
        bg = background(SIZE, SIZE, 20 + k)
        got = dprint_overlay(torch.from_numpy(bg), rb.atlas, font, lines)
        want = j_overlay(bg, jatlas, jfont, lines)
        assert_frame_bar(got.numpy(), want, f"dprint {k}")
        assert (got.numpy() < bg - 0.1).any()  # the backing rects darken
    assert torch.equal(dprint_overlay(torch.from_numpy(bg), rb.atlas, rb.ui, []), torch.from_numpy(bg))


def test_console_and_debug_lines_match_jax():
    from c_game_engine_tpu.render import dprint as J
    from c_game_engine_tpu_torch.core.state import reset, tree_map
    from c_game_engine_tpu_torch.models.sim import load_named_map
    from c_game_engine_tpu_torch.render import dprint as P

    for code in list(range(30, 40)) + list(range(90, 98)):
        assert P.ansi_color(code) == J.ansi_color(code), code
    np.testing.assert_array_equal(P.ANSI_COLORS, J.ANSI_COLORS)
    for enabled in (False, True):
        pc, jc = P.DPrintConsole(enabled), J.DPrintConsole(enabled)
        seq = [("add", "late", 37), ("process", 10_000.0), ("add", "a", 31), ("add", "b", 92),
               ("process", 10_000.0 + P.CONSOLE_MESSAGE_VISIBLE_FOR_MS - 1), ("process", 11_000.0),
               ("process", 10_000.0 + P.CONSOLE_MESSAGE_VISIBLE_FOR_MS + 1), ("add", "c", 97),
               ("process", 12_500.0), ("process", 12_500.0), ("process", 12_500.0), ("process", 20_000.0),
               ("process", 20_000.0), ("process", 20_000.0)]
        for op, *args in seq:
            if op == "add":
                pc.add(*args)
                jc.add(*args)
            else:
                assert pc.process(*args) == jc.process(*args), (enabled, args)

    cm = load_named_map("arena", "cpu")
    st = reset(cm)
    npst = tree_map(lambda x: x.numpy(), st)
    # the JAX function reads numpy leaves through np.asarray, so the same
    # numbers go in: no target, a targeted actor, a held one
    for held, targeted in ((-1, -1), (-1, 2), (4, 2)):
        p = st.player.replace(held_actor=torch.tensor(held, dtype=torch.int32),
                              targeted_actor=torch.tensor(targeted, dtype=torch.int32),
                              vel=torch.tensor([0.5, -1.25, 3.0]))
        s = st.replace(player=p)
        js = tree_map(lambda x: x.numpy(), s)
        jcm = tree_map(lambda x: x.numpy(), cm)
        assert P.standard_debug_lines(cm, s, 0.02, 1 / 60) == J.standard_debug_lines(jcm, js, 0.02, 1 / 60)
    assert npst.player.pos.shape == (3,)


def test_port_imports_no_jax():
    """No module of the port and not chip_smoke.py imports jax or the JAX
    package, at any level."""
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "c_game_engine_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 50
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "flax", "c_game_engine_tpu"):
                    bad.append(f"{f.relative_to(root)}:{node.lineno} {n}")
    assert not bad, bad
    for new in ("ui/stack.py", "ui/screens.py", "render/dprint.py", "models/game.py", "play.py"):
        assert (root / "c_game_engine_tpu_torch" / new).exists()
