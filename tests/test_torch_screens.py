"""The menu screens (ui/screens.py) against the JAX package on the CPU:
each render_*_screen at 128 x 128 with the synthetic UI assets, over a
seeded background and a widget state from a few scripted inputs (a
hovered and a pressed button, a focused control, a moved slider), within
ROADMAP's frame bar (under 0.2% of pixels off by more than 1/255). The
widget state itself is held to the JAX package in tests/test_torch_ui.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.torch_ui_inputs import (  # noqa: F401  (jax_sampler_jitted: a fixture)
    assert_frame_bar,
    assets,
    background,
    jax_input,
    jax_sampler_jitted,
    port_input,
)

SIZE = 128
pytestmark = pytest.mark.usefixtures("jax_sampler_jitted")
LEVELS = ["arena", "arena_bodies", "arena_lit", "arena_orb"]


def _state(pkg, builder, inputs):
    """A stack of `builder` and its state after `inputs` [(x, y, kw)] in
    one package (`pkg`: "port" or "jax")."""
    if pkg == "port":
        from c_game_engine_tpu_torch.ui.stack import init_ui_state, ui_process
        from c_game_engine_tpu_torch.utils.config import Options

        make = port_input
    else:
        from c_game_engine_tpu.ui.stack import init_ui_state, ui_process
        from c_game_engine_tpu.utils.config import Options

        make = jax_input
    sd = (builder() if builder.__name__ in ("menu_stack", "pause_stack", "options_stack") else builder(Options()))[0]
    st = init_ui_state(sd, device="cpu") if pkg == "port" else init_ui_state(sd)
    for x, y, kw in inputs:
        st, _ = ui_process(sd, st, make(x, y, kw))
    return sd, st


def _centre(sd, i):
    r = np.asarray(sd.rect)
    return float(r[i, 0] + r[i, 2] / 2), float(r[i, 1] + r[i, 3] / 2)


# (screen, stack builder name, inputs given the stack's rects)
CASES = {
    "menu": ("menu_stack", lambda sd: [(*_centre(sd, 1), {"mouse_down": True, "mouse_pressed": True})]),
    "pause": ("pause_stack", lambda sd: [(*_centre(sd, 1), {})]),
    "options": ("options_stack", lambda sd: [(-1.0, -1.0, {"tab": True})]),
    "video_options": ("video_options_stack", lambda sd: [(-1.0, -1.0, {"tab": True}), (-1.0, -1.0, {"right": True}),
                                                         (-1.0, -1.0, {"right": True}), (*_centre(sd, 4), {})]),
    "sound_options": ("sound_options_stack", lambda sd: [(float(sd.rect[1, 0] + 0.31 * sd.rect[1, 2]),
                                                          float(sd.rect[1, 1] + 5), {"mouse_down": True})]),
    "input_options": ("input_options_stack", lambda sd: [(*_centre(sd, 1), {"mouse_down": True, "mouse_pressed": True}),
                                                         (*_centre(sd, 1), {"mouse_released": True})]),
}


@pytest.mark.parametrize("screen", sorted(CASES))
def test_widget_screen_matches_jax(screen):
    from c_game_engine_tpu.ui import screens as J
    from c_game_engine_tpu_torch.ui import screens as P

    rb, jatlas, jui, _ = assets()
    builder, inputs = CASES[screen]
    steps = inputs(_state("port", getattr(P, builder), [])[0])
    sd, st = _state("port", getattr(P, builder), steps)
    jsd, js = _state("jax", getattr(J, builder), steps)
    bg = background(SIZE, SIZE, sorted(CASES).index(screen))
    if screen == "menu":
        got, want = P.render_menu_screen(torch.from_numpy(bg), rb.atlas, rb.ui, sd, st), \
            J.render_menu_screen(bg, jatlas, jui, jsd, js)
    elif screen == "pause":
        got, want = P.render_pause_screen(torch.from_numpy(bg), rb.atlas, rb.ui, sd, st), \
            J.render_pause_screen(bg, jatlas, jui, jsd, js)
    else:
        title = screen.replace("_", " ").title()
        got, want = P.render_options_screen(torch.from_numpy(bg), rb.atlas, rb.ui, sd, st, title), \
            J.render_options_screen(bg, jatlas, jui, jsd, js, title)
    assert_frame_bar(got.numpy(), want, screen)
    assert np.abs(got.numpy() - bg).max() > 0.1


def test_splash_loading_and_level_select_match_jax():
    import jax.numpy as jnp

    from c_game_engine_tpu.ui import screens as J
    from c_game_engine_tpu_torch.ui import screens as P

    rb, jatlas, jui, _ = assets()
    black = np.zeros((SIZE, SIZE, 3), np.float32)
    for tick in (10, 20, 30, 85, 101):
        got = P.render_splash_screen(torch.from_numpy(black), rb.atlas, rb.ui, tick)
        assert_frame_bar(got.numpy(), J.render_splash_screen(jnp.asarray(black), jatlas, jui, tick), f"splash {tick}")
        assert (got.numpy().max() > 0.1) == (20 < tick < 100), tick
    bg = background(SIZE, SIZE, 40)
    assert_frame_bar(P.render_loading_screen(torch.from_numpy(bg), rb.atlas, rb.ui).numpy(),
                     J.render_loading_screen(bg, jatlas, jui), "loading")
    for names, sel in ((LEVELS, 2), ([], 0)):
        got = P.render_level_select_screen(torch.from_numpy(bg), rb.atlas, rb.ui, names, sel)
        assert_frame_bar(got.numpy(), J.render_level_select_screen(bg, jatlas, jui, names, sel), f"levels {names}")
