"""On-frame debug text + last-2s console overlay (counterpart of
c_game_engine_tpu/render/dprint.py: the reference's DPrint.c and
DPrintConsole.c).

  * DPrint: stacked top-left text lines; each line draws a 0x80000000
    backing rect at (5, y-5, w+10, h+10) and size-16 text at (10, y),
    advancing y by text height + 10 from a start of 10.
  * DPrintConsole: `add` queues a (message, ANSI color) pair; `process`
    returns every queued message each frame, stamps its first-seen time,
    and removes at most ONE message older than
    CONSOLE_MESSAGE_VISIBLE_FOR_MS (2000 ms) per frame. The clock is the
    caller's (`process(now_ms)`).
  * `standard_debug_lines`: MainStateRender's and DPrintPlayer's lines for
    one env's state.

Strings are formatted on the host; the pixels reuse the bitmap-font draw
(render/hud.py::draw_text), so the overlay composites onto any frame.
"""

from __future__ import annotations

import numpy as np
import torch

from c_game_engine_tpu_torch.utils.mathx import const

CONSOLE_MESSAGE_VISIBLE_FOR_MS = 2000

# ANSI SGR color table (DPrintConsole.c:36-58), copied from the JAX module.
# Index 0-9 = codes 30-39, 10-17 = bright codes 90-97; rgba in [0, 1].
_D0 = 0xD0 / 255.0
_E0 = 0xE0 / 255.0
ANSI_COLORS = np.array(
    [
        [0, 0, 0, 1],  # 30 black
        [_D0, 0, 0, 1],  # 31 red
        [0, _D0, 0, 1],  # 32 green
        [_D0, _D0, 0, 1],  # 33 yellow
        [0, 0, _D0, 1],  # 34 blue
        [_D0, 0, _D0, 1],  # 35 magenta
        [0, _D0, _D0, 1],  # 36 cyan
        [_E0, _E0, _E0, 1],  # 37 white
        [0, 0, 0, 0],  # 38 unused
        [_E0, _E0, _E0, 1],  # 39 default
        [0x40 / 255, 0x40 / 255, 0x40 / 255, 1],  # bright black (0xFF404040)
        [1, 0, 0, 1],  # 91 bright red
        [0, 1, 0, 1],  # 92 bright green
        [1, 1, 0, 1],  # 93 bright yellow
        [0, 0, 1, 1],  # 94 bright blue
        [1, 0, 1, 1],  # 95 bright magenta
        [0, 1, 1, 1],  # 96 bright cyan
        [1, 1, 1, 1],  # 97 bright white
    ],
    np.float32,
)

COLOR_WHITE = (1.0, 1.0, 1.0, 1.0)


def ansi_color(code: int) -> tuple:
    """ANSI SGR code (30-39 normal, 90-97 bright) -> rgba
    (AddConsoleMessage, DPrintConsole.c:95-101). The reference indexes
    bright codes with `(color % 10) + 9`, which shifts them by one (90 ->
    DEFAULT, 91 -> bright black, ..., 97 -> bright cyan; bright white is
    unreachable); reproduced as the JAX package does."""
    if code >= 90:
        return tuple(ANSI_COLORS[(code % 10) + 9])
    return tuple(ANSI_COLORS[code % 10])


class DPrintConsole:
    """Last-2s message console (DPrintConsole.c). Host-side state, like
    the reference's LockingList; `enabled` mirrors --show-console."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._messages: list[dict] = []

    def add(self, msg: str, color: int = 37):
        """AddConsoleMessage: queue with a deferred timestamp (stamped on
        first process so a long frame can't expire unseen messages)."""
        if not self.enabled:
            return
        self._messages.append({"message": msg, "color": ansi_color(color), "time": None})

    def process(self, now_ms: float) -> list[tuple[str, tuple]]:
        """ProcessDPrintConsole at the caller's clock `now_ms`: every queued
        (message, rgba) for this frame's DPrint pass; stamps first-seen
        times; drops at most ONE expired message (DPrintConsole.c:128-151)."""
        if not self.enabled:
            return []
        out = []
        index_to_remove = None
        for i, m in enumerate(self._messages):
            out.append((m["message"], m["color"]))
            if m["time"] is None:
                m["time"] = now_ms
            elif index_to_remove is None and now_ms > m["time"] + CONSOLE_MESSAGE_VISIBLE_FOR_MS:
                index_to_remove = i
        if index_to_remove is not None:
            self._messages.pop(index_to_remove)
        return out


def _measure(widths: np.ndarray, height: float, spacing: float, codes, size: float) -> float:
    """A line's width in pixels, from the font's host tables."""
    scale = size / max(height, 1.0)
    w = widths[np.clip(codes, 0, 127)] * scale
    sp = spacing * scale
    return float(np.sum(np.where(codes >= 0, w + sp, 0.0)))


def _codes(s: str, cap: int = 64) -> np.ndarray:
    arr = np.full(cap, -1, np.int32)
    b = s.encode("ascii", "replace")[:cap]
    arr[: len(b)] = np.frombuffer(b, np.uint8)
    return arr


def dprint_overlay(frame, atlas, font, lines, size: float = 16.0):
    """Draw the stacked debug lines onto frame [H, W, 3] (DPrint.c:22-30).
    `lines` is [(str, rgba)]; `font` any struct with the bitmap-font fields
    (HudAssets / UiAssets). Returns the composited frame. Measuring a line
    reads the font's widths on the host: a debug path."""
    from c_game_engine_tpu_torch.render.hud import draw_text
    from c_game_engine_tpu_torch.ui.screens import draw_rect

    if not lines:
        return frame
    dev = frame.device
    widths = font.font_widths.cpu().numpy()
    height, spacing = float(font.font_height), float(font.font_spacing)
    y = 10.0  # ResetDPrintYPos
    for text, color in lines:
        codes = _codes(text)
        tw = _measure(widths, height, spacing, codes, size)
        # DrawRect(5, y-5, w+10, h+10, 0x80000000)
        frame = draw_rect(frame, 5, int(y - 5), int(tw + 10), int(size + 10), (0.0, 0.0, 0.0, 0.5))
        shown = codes[:max(1, int((codes >= 0).sum()))]  # the -1 pads draw nothing
        frame = draw_text(frame[None], atlas, font, torch.from_numpy(shown).to(dev), 10.0, y, size,
                          const(tuple(float(c) for c in color), dev))[0]
        y += size + 10.0
    return frame


def standard_debug_lines(cmap, state, frame_delta: float = 1 / 60.0, tick_delta: float = 1 / 60.0,
                         engine_version: str = "c-game-engine_tpu") -> list:
    """The reference's per-frame debug lines for one env's state (no batch
    axis): MainStateRender (MainState.c:100-109) + DPrintPlayer
    (Player.c:28-57). Reads the state on the host, a device sync: debug
    only, like the reference's debug builds, and called on no other path."""
    from c_game_engine_tpu_torch.actors.defs import ActorClass

    p = state.player
    pos = p.pos.cpu().numpy()
    vel = p.vel.cpu().numpy()
    held = int(p.held_actor)
    targeted = int(p.targeted_actor)
    n_actors = int(state.actors.active.sum())
    idx = held if held >= 0 else targeted
    if idx >= 0:
        cls_name = ActorClass(int(cmap.cls[idx])).name.lower()
        actor_str = f"{'Held' if held >= 0 else 'Targeted'} Actor: {cls_name} #{idx}"
    else:
        actor_str = "Targeted Actor: None"
    w = COLOR_WHITE
    return [
        (f"Engine {engine_version}", w),
        (f"Position: ({pos[0]:.2f}, {pos[1]:.2f}, {pos[2]:.2f})", w),
        (f"Velocity: {float(np.linalg.norm(vel)):.2f} ({vel[0]:.2f}, {vel[1]:.2f}, {vel[2]:.2f})", w),
        (actor_str, w),
        (f"Actors: {n_actors}", w),
        (f"Frame Delta: {frame_delta:.3f}", w),
        (f"Tick Delta: {tick_delta:.3f}", w),
    ]
