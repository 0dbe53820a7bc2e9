"""Synthetic HUD, widget and viewmodel assets for maps without the
shipped ones.

The committed maps are asset-free: their bundles have HUD and UI ids of
-1 and an empty viewmodel, so render_with_hud draws neither and the menu
screens draw no widget. `synthetic_arrays` builds, from numpy only, HUD
assets whose coin, blue-coin, crosshair and font ids point at procedural
textures already in arena_lit's atlas (a 128-entry font table of start and
end U and widths over one texture), and a small viewmodel mesh (a box of
12 triangles, item 0) in front of the camera. `synthetic_ui_arrays` does
the same for the widget stack's UiAssets: the 14 UITEX_* slots on those
textures, their pixel sizes from the atlas table, and a small font table
like the HUD's on another texture. The same arrays go into the JAX bundle
(`bundle.replace(...)`) and the port's (`with_synthetic_hud`), so the
tests and chip_smoke.py draw the same HUD and menu frames on both sides.
`hud_states` sets per-env values the HUD shows (coins, blue coins,
crosshair state, the selected item).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the arena_lit textures the assets point at
YCOIN, BCOIN, CROSSHAIR, FONT, VIEWMODEL = ("texture/actor/coin.gtex", "texture/actor/bluecoin.gtex",
                                            "texture/actor/laser.gtex", "texture/actor/door.gtex",
                                            "texture/floor.gtex")


# the texture of each UITEX_* slot (ui/stack.py order), and the small font's
UI_SLOTS = ("texture/wall.gtex", "texture/actor/door.gtex", "texture/floor.gtex", "texture/wall.gtex",
            "texture/actor/door.gtex", "texture/floor.gtex", "texture/actor/coin.gtex",
            "texture/actor/bluecoin.gtex", "texture/actor/coin.gtex", "texture/floor.gtex",
            "texture/actor/laser.gtex", "texture/sky.gtex", "texture/actor/door.gtex", "texture/actor/coin.gtex")
SMALL_FONT = "texture/floor.gtex"
# every texture the assets point at
TEXTURES = frozenset((YCOIN, BCOIN, CROSSHAIR, FONT, VIEWMODEL, SMALL_FONT) + UI_SLOTS)


def _font_table(width_of):
    """(start U, end U, widths) [128] each: printable ASCII in 16 glyph
    cells a row of the texture, absent codes -1."""
    start = np.full(128, -1.0, np.float32)
    end = np.full(128, -1.0, np.float32)
    widths = np.zeros(128, np.float32)
    for code in range(32, 128):
        start[code] = ((code - 32) % 16) / 16.0
        end[code] = start[code] + 1.0 / 16.0
        widths[code] = width_of(code)
    return start, end, widths


def _box(center, half):
    """A box's 12 triangles [12, 3, 3] with each face's uv [12, 3, 2]."""
    c = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float64)
    faces = ((0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3))
    quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    pos, uv = [], []
    for f in faces:
        for tri in ((0, 1, 2), (0, 2, 3)):
            pos.append(c[[f[k] for k in tri]] * half + center)
            uv.append(quad_uv[list(tri)])
    return np.array(pos, np.float32), np.array(uv, np.float32)


def synthetic_arrays(tex_names) -> dict:
    """{"hud.<field>": ndarray, "vm_<field>": ndarray} for a bundle whose
    atlas holds the textures `tex_names` (arena_lit's)."""
    tid = lambda name: np.int32(list(tex_names).index(name))
    start, end, widths = _font_table(lambda code: 6.0 + code % 5)
    pos, uv = _box(np.array([-0.22, -0.12, 0.7]), 0.08)
    rng = np.random.default_rng(0)
    color = np.concatenate([rng.uniform(0.5, 1.0, (12, 3, 3)), np.ones((12, 3, 1))], -1).astype(np.float32)
    return {
        "hud.ycoin_tex": tid(YCOIN), "hud.bcoin_tex": tid(BCOIN), "hud.crosshair_tex": tid(CROSSHAIR),
        "hud.font_tex": tid(FONT), "hud.font_start_u": start, "hud.font_end_u": end, "hud.font_widths": widths,
        "hud.font_height": np.float32(16.0), "hud.font_spacing": np.float32(1.0),
        "vm_pos": pos, "vm_uv": uv, "vm_color": color, "vm_tex": np.full(12, tid(VIEWMODEL), np.int32),
        "vm_item": np.zeros(12, np.int32),
    }


def synthetic_ui_arrays(tex_names, tex_table) -> dict:
    """{"ui.<field>": ndarray} of UiAssets for a bundle whose atlas holds
    the textures `tex_names` (arena_lit's), with its table [T, 6] (x0, y0,
    w, h, repeat, filter): each slot's size is its texture's w and h."""
    ids = np.array([list(tex_names).index(name) for name in UI_SLOTS], np.int32)
    start, end, widths = _font_table(lambda code: 5.0 + code % 4)
    return {
        "ui.tex": ids, "ui.tex_size": np.asarray(tex_table, np.float32)[ids, 2:4].copy(),
        "ui.font_tex": np.int32(list(tex_names).index(SMALL_FONT)), "ui.font_start_u": start, "ui.font_end_u": end,
        "ui.font_widths": widths, "ui.font_height": np.float32(16.0), "ui.font_spacing": np.float32(1.0),
    }


def with_synthetic_hud(bundle):
    """The port's bundle with the synthetic HUD, UI and viewmodel assets."""
    from c_game_engine_tpu_torch.render.hud import HudAssets
    from c_game_engine_tpu_torch.ui.stack import UiAssets

    dev = bundle.atlas.table.device
    arrays = {k: torch.as_tensor(v, device=dev) for k, v in synthetic_arrays(bundle.tex_names).items()}
    hud = HudAssets(**{k[4:]: v for k, v in arrays.items() if k.startswith("hud.")})
    ui = {k[3:]: torch.as_tensor(v, device=dev)
          for k, v in synthetic_ui_arrays(bundle.tex_names, bundle.atlas.table.cpu().numpy()).items()}
    return dataclasses.replace(bundle, hud=hud, ui=UiAssets(**ui),
                               **{k: v for k, v in arrays.items() if k.startswith("vm_")})


def hud_values(batch) -> dict:
    """Per-env HUD values [B] as numpy: coins (0, 7, 1,234, ... and a
    negative count, shown as 0), blue coins 0-5, every crosshair state,
    the eraser (item 0) selected on all but every fifth env."""
    e = np.arange(batch)
    coins = (e * 1237) % 100000
    coins[3::7] = -5
    return {"coins": coins.astype(np.int32), "blue_coins": (e % 6).astype(np.int32),
            "crosshair": (e % 4).astype(np.int32), "current_item": np.where(e % 5 == 4, -1, 0).astype(np.int32)}


def hud_states(states):
    """The port's batched state with `hud_values` set."""
    v = {k: torch.as_tensor(a, device=states.tick.device) for k, a in hud_values(states.tick.shape[0]).items()}
    save = states.save.replace(coins=v["coins"], blue_coins=v["blue_coins"], current_item=v["current_item"])
    return states.replace(save=save, player=states.player.replace(crosshair=v["crosshair"]))
