"""The game's menu screens on top of the widget stack (counterpart of
c_game_engine_tpu/ui/screens.py).

Builders mirror the control lists in game/src/gameState/*.c (layouts,
labels, slider ranges as the JAX module cites them); render functions
reproduce each screen's RenderGame over a frame [H, W, 3]: background ->
logo / headers -> DrawUiStack. Activation events come back as names the
GameApp dispatches on, replacing the reference's C callbacks.
"""

from __future__ import annotations

import numpy as np
import torch

from c_game_engine_tpu_torch.render.hud import blit
from c_game_engine_tpu_torch.ui.stack import (
    UITEX_MENU_LOGO,
    UITEX_PAUSE_LOGO,
    UITEX_STUDIO,
    VIRTUAL_H,
    VIRTUAL_W,
    Anchor,
    build_stack,
    button,
    checkbox,
    draw_text1,
    slider,
    ui_draw,
)
from c_game_engine_tpu_torch.utils.mathx import const

WHITE = (1.0, 1.0, 1.0, 1.0)

# ---------------------------------------------------------------------------
# stacks (event-name list parallels the control list)
# ---------------------------------------------------------------------------


def menu_stack():
    """MenuState.c:139-150: Start / Options / Quit / hot reload assets."""
    controls, events = [], []
    y, spacing = 80, 50
    for label, ev in [("Start", "start"), ("Options", "options"), ("Quit", "quit"),
                      ("hot reload assets", "reload_assets")]:
        controls.append(button((0, y), (480, 40), label, Anchor.MIDDLE_CENTER))
        events.append(ev)
        y += spacing
    return build_stack(controls), events


def pause_stack():
    """PauseState.c:85-89: Resume / Options / Exit Level."""
    controls = [
        button((0, 20), (300, 40), "Resume", Anchor.MIDDLE_CENTER),
        button((0, 70), (300, 40), "Options", Anchor.MIDDLE_CENTER),
        button((0, 120), (300, 40), "Exit Level", Anchor.MIDDLE_CENTER),
    ]
    return build_stack(controls), ["resume", "options", "exit_level"]


def options_stack():
    """OptionsState.c:118-145 (Discord checkbox dropped, as in the JAX package)."""
    controls = [
        button((0, 80), (480, 40), "Video Options", Anchor.TOP_CENTER),
        button((0, 125), (480, 40), "Sound Options", Anchor.TOP_CENTER),
        button((0, 170), (480, 40), "Input Options", Anchor.TOP_CENTER),
        button((0, -40), (480, 40), "Done", Anchor.BOTTOM_CENTER),
    ]
    return build_stack(controls), ["video", "sound", "input", "back"]


def video_options_stack(opts):
    """VideoOptionsState.c:193-310 (sliders/checkboxes + ranges)."""
    y, sp = 80, 45
    controls = [
        slider((0, y), (480, 40), "FOV", Anchor.TOP_CENTER, 30.0, 120.0, opts.fov, 1, 1),
        checkbox((-120, y + sp * 1.5), (230, 40), "Fullscreen", Anchor.TOP_CENTER, opts.fullscreen),
        checkbox((120, y + sp * 1.5), (230, 40), "VSync", Anchor.TOP_CENTER, opts.vsync),
        checkbox((-120, y + sp * 2.5), (230, 40), "Limit BG FPS", Anchor.TOP_CENTER,
                 opts.limit_fps_when_unfocused),
        checkbox((120, y + sp * 2.5), (230, 40), "Mipmaps", Anchor.TOP_CENTER, opts.mipmaps),
        slider((0, y + sp * 4), (480, 40), "MSAA", Anchor.TOP_CENTER, 0.0, 3.0, opts.msaa, 1, 1),
        slider((0, y + sp * 5), (480, 40), "Anisotropic Filtering", Anchor.TOP_CENTER, 0.0, 4.0,
               opts.anisotropy, 1, 1),
        slider((0, y + sp * 6), (480, 40), "LOD Distance", Anchor.TOP_CENTER, 0.5, 2.0, opts.lod_multiplier,
               0.5, 1),
        slider((0, y + sp * 7), (480, 40), "Maximum FPS", Anchor.TOP_CENTER, 0, 500, opts.max_fps, 10, 10),
        checkbox((0, y + sp * 8.5), (480, 40), "Prefer Wayland over X11", Anchor.TOP_CENTER,
                 opts.prefer_wayland),
        button((0, -40), (480, 40), "Back", Anchor.BOTTOM_CENTER),
    ]
    events = ["fov", "fullscreen", "vsync", "limit_bg_fps", "mipmaps", "msaa", "anisotropy", "lod", "max_fps",
              "prefer_wayland", "back"]
    return build_stack(controls), events


def sound_options_stack(opts):
    """SoundOptionsState.c:95-156: four percent volume sliders."""
    y, sp = 80, 45
    names = [
        ("Master Volume", opts.master_volume, "master_volume"),
        ("Music Volume", opts.music_volume, "music_volume"),
        ("SFX Volume", opts.sfx_volume, "sfx_volume"),
        ("UI Volume", opts.ui_volume, "ui_volume"),
    ]
    controls = [slider((0, y + i * sp), (480, 40), label, Anchor.TOP_CENTER, 0.0, 1.0, v, 0.01, 0.1, percent=True)
                for i, (label, v, _) in enumerate(names)]
    controls.append(button((0, -40), (480, 40), "Back", Anchor.BOTTOM_CENTER))
    return build_stack(controls), [ev for _, _, ev in names] + ["back"]


def input_options_stack(opts):
    """InputOptionsState.c:126-189."""
    y, sp = 80, 45
    controls = [
        slider((0, y), (480, 40), "Camera Sensitivity", Anchor.TOP_CENTER, 0.01, 2.0, opts.camera_speed, 0.01, 0.1,
               percent=True),
        checkbox((0, y + sp), (480, 40), "Invert Horizontal Camera", Anchor.TOP_CENTER,
                 opts.invert_horizontal_camera),
        checkbox((0, y + sp * 2), (480, 40), "Invert Vertical Camera", Anchor.TOP_CENTER,
                 opts.invert_vertical_camera),
        slider((0, y + sp * 5), (480, 40), "Rumble Strength", Anchor.TOP_CENTER, 0.0, 1.0,
               1.0 if opts.rumble else 0.0, 0.25, 0.25, percent=True),
        checkbox((0, y + sp * 6), (480, 40), "Swap OK/Cancel buttons", Anchor.TOP_CENTER, opts.swap_ok_cancel),
        button((0, -40), (480, 40), "Back", Anchor.BOTTOM_CENTER),
    ]
    events = ["sensitivity", "invert_h", "invert_v", "rumble", "swap_ok_cancel", "back"]
    return build_stack(controls), events


# ---------------------------------------------------------------------------
# screen rendering
# ---------------------------------------------------------------------------


def _codes_arr(s: str, device, cap: int = 64) -> torch.Tensor:
    """i32 ASCII codes of `s` (at most `cap`; one -1 for an empty string)
    on `device`, made once per (string, device), so a frame copies no text
    from the host. The JAX function pads to `cap` with -1, which draws
    nothing and advances nothing."""
    return const(tuple(min(ord(ch), 127) for ch in s[:cap]) or (-1,), device, torch.int32)


def draw_rect(frame, x0, y0, w, h, rgba):
    """DrawRect: solid color quad with alpha over frame [..., H, W, 3]."""
    fh, fw = frame.shape[-3:-1]
    dev = frame.device
    ys = torch.arange(fh, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(fw, dtype=torch.float32, device=dev)[None, :]
    inside = (xs >= x0) & (xs < x0 + w) & (ys >= y0) & (ys < y0 + h)
    a = torch.where(inside, np.float32(rgba[3]), 0.0)[..., None]
    return frame * (1 - a) + const(tuple(float(c) for c in rgba[:3]), dev) * a


def _blit1(frame, atlas, tex_id, x0, y0, w, h, mod):
    """render/hud.py::blit on one frame [H, W, 3]."""
    return blit(frame[None], atlas, tex_id, x0, y0, w, h, mod)[0]


def _logo(frame, atlas, ui, slot, vw, vh):
    """Centered top logo (MenuState.c:82-88 480x320 / PauseState.c:45-51
    360x240)."""
    fh, fw = frame.shape[:2]
    sx, sy = fw / VIRTUAL_W, fh / VIRTUAL_H
    x0 = (VIRTUAL_W - vw) / 2 * sx
    return _blit1(frame, atlas, ui.tex[slot], x0, 32 * sy, vw * sx, vh * sy, const(WHITE, frame.device))


def render_splash_screen(frame, atlas, ui, tick):
    """LogoSplashStateRender (LogoSplashState.c:38-63): centered 300x300
    studio logo, fading in over ticks 20-40 and out over 80-100. `tick` is
    the host's splash counter."""
    fh, fw = frame.shape[:2]
    sx, sy = fw / VIRTUAL_W, fh / VIRTUAL_H
    t = np.float32(tick)
    alpha = np.clip((t - np.float32(20.0)) / np.float32(20.0), 0.0, 1.0) * np.clip(
        np.float32(1.0) - (t - np.float32(80.0)) / np.float32(20.0), 0.0, 1.0)
    alpha = np.float32(0.0) if (t < 20) | (t > 100) else np.float32(alpha)
    mod = const((1.0, 1.0, 1.0, float(alpha)), frame.device)
    return _blit1(frame, atlas, ui.tex[UITEX_STUDIO], (VIRTUAL_W / 2 - 150) * sx, (VIRTUAL_H / 2 - 150) * sy,
                  300 * sx, 300 * sy, mod)


def render_menu_screen(frame, atlas, ui, sd, st, version_line="c-game-engine_tpu"):
    """MenuStateRender (MenuState.c:72-131): background -> logo ->
    version/copyright -> widgets."""
    dev = frame.device
    fh, fw = frame.shape[:2]
    sx, sy = fw / VIRTUAL_W, fh / VIRTUAL_H
    out = _logo(frame, atlas, ui, UITEX_MENU_LOGO, 480, 320)
    size = 16.0 * min(sx, sy)
    codes = _codes_arr(version_line, dev)
    out = draw_text1(out, atlas, ui, codes, fw / 2 + 2 * sx, fh - 30 * sy + 2 * sy, size,
                     const((0.0, 0.0, 0.0, 1.0), dev), halign="center")
    out = draw_text1(out, atlas, ui, codes, fw / 2, fh - 30 * sy, size, const((0.63, 0.63, 0.63, 1.0), dev),
                     halign="center")
    return ui_draw(sd, st, atlas, ui, out)


def render_pause_screen(frame, atlas, ui, sd, st):
    """PauseStateRender (PauseState.c:41-61): dimmed world -> pause logo ->
    widgets. RenderInGameMenuBackground darkens the frozen game frame."""
    out = draw_rect(frame, 0, 0, frame.shape[1], frame.shape[0], (0.0, 0.0, 0.0, 0.5))
    out = _logo(out, atlas, ui, UITEX_PAUSE_LOGO, 360, 240)
    return ui_draw(sd, st, atlas, ui, out)


def render_options_screen(frame, atlas, ui, sd, st, title="Options"):
    """OptionsStateRender + the three submenus: centered title + widgets."""
    fh, fw = frame.shape[:2]
    sx, sy = fw / VIRTUAL_W, fh / VIRTUAL_H
    out = draw_text1(frame, atlas, ui, _codes_arr(title, frame.device), fw / 2, (100 - 32) / 2 * sy,
                     32.0 * min(sx, sy), const(WHITE, frame.device), halign="center")
    return ui_draw(sd, st, atlas, ui, out)


def render_loading_screen(frame, atlas, ui):
    """LoadingStateRender (LoadingState.c:77-85): "LOADING" at size 16,
    white, centered in the full window over black."""
    fh, fw = frame.shape[:2]
    sx, sy = fw / VIRTUAL_W, fh / VIRTUAL_H
    size = 16.0 * min(sx, sy)
    return draw_text1(frame * 0.0, atlas, ui, _codes_arr("LOADING", frame.device), fw / 2, (fh - size) / 2, size,
                      const(WHITE, frame.device), halign="center")


def render_level_select_screen(frame, atlas, ui, names, selected):
    """LevelSelectStateRender (LevelSelectState.c:67-121): header, 0x80000000
    band at y 315..435, neighbor rows at 50% alpha, progress + hint lines."""
    dev = frame.device
    fh, fw = frame.shape[:2]
    sx, sy = fw / VIRTUAL_W, fh / VIRTUAL_H
    s = min(sx, sy)
    white = const(WHITE, dev)
    text = lambda out, line, x, y, size, color: draw_text1(out, atlas, ui, _codes_arr(line, dev), x, y, size, color)
    out = text(frame, "Map Select", 52 * sx, 52 * sy, 64 * s, const((0.0, 0.0, 0.0, 1.0), dev))
    out = text(out, "Map Select", 50 * sx, 50 * sy, 64 * s, white)
    out = draw_rect(out, 0, 315 * sy, fw, 120 * sy, (0.0, 0.0, 0.0, 0.5))
    if not names:
        return text(out, "No Levels Found", 50 * sx, 359 * sy, 32 * s, white)
    for i, name in enumerate(names):
        ypos = (345 + (i - selected) * 60 + 14) * sy
        if i != selected and -60 < 345 + (i - selected) * 60 < 480:
            out = text(out, name, 50 * sx, ypos, 32 * s, const((1.0, 1.0, 1.0, 0.31), dev))
    out = text(out, names[selected], 50 * sx, (345 + 14) * sy, 32 * s, white)
    out = text(out, "Map %02d/%02d" % (selected + 1, len(names)), 50 * sx, 325 * sy, 16 * s, white)
    return text(out, "Up/Down to change, space to play", 50 * sx, 409 * sy, 16 * s, white)
