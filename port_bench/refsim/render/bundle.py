"""RenderBundle: a map's render-side tensors (counterpart of
c_game_engine_tpu/render/bundle.py), holding what the render path reads:
map geometry, the actor model pool, the sky mesh, the texture atlas, the
lightmap, the HUD assets, the widget stack's assets (`ui`) and the
viewmodel mesh.

`build_render_bundle(cmap)` builds it from a map the port compiled
(compiler/compile.py, whose `aux["resolver"]` answers the models,
textures, fonts and HUD and interface textures), host side in numpy as
the JAX construction does, then on the map's device. A map without the shipped
HUD and interface textures, fonts and eraser model has HUD and UI ids of
-1 and an empty viewmodel, as the JAX bundle has. A model of more than
4096 triangles a (lod, slot) block is sorted by its centroids' Morton
codes (`_morton3`, numpy's sort in the JAX order), the row order the
streamed raster kernel K5 prunes by.

The committed bundles (`maps/<name>_bundle.npz` and `.json`, written by
tests/torch_export_map.py, and the compile cache's, compiler/cache.py)
hold the array leaves (the atlas's as `atlas.<field>`, `blocked` as the
float32 value of each bfloat16 texel, which it holds exactly; the HUD's as
`hud.<field>`, the UI's as `ui.<field>`) and the static fields;
`load_bundle` reads them.

A bundle belongs to its map: building or loading one takes the map and
fills the soup's row tables (`soup_rows`), which the JAX package derives
from the map's static arrays while it traces.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from refsim.core.state import load_map
from refsim.render.assets import HUD_FIELDS, NUM_UITEX, UI_FIELDS, HudAssets, UiAssets
from refsim.render.textures import TextureAtlas

MAX_SKINS = 8
MAX_SLOTS = 8
MAX_LODS = 4
# slot order of ui/stack.py's UITEX_* constants
UI_TEXTURES = (
    "texture/interface/button.gtex",
    "texture/interface/button_hover.gtex",
    "texture/interface/button_pressed.gtex",
    "texture/interface/slider.gtex",
    "texture/interface/slider_thumb.gtex",
    "texture/interface/checkbox_unchecked.gtex",
    "texture/interface/checkbox_checked.gtex",
    "texture/interface/radio_unchecked.gtex",
    "texture/interface/radio_checked.gtex",
    "texture/interface/textbox.gtex",
    "texture/interface/focus_rect.gtex",
    "texture/interface/menu_logo.gtex",
    "texture/interface/pause_logo.gtex",
    "texture/interface/studio.gtex",
)

# the array leaves, in the order of the JAX RenderBundle
ARRAYS = (
    "lightmap",
    "map_pos", "map_uv", "map_lmuv", "map_tex", "map_shaded",
    "mdl_pos", "mdl_uv", "mdl_color", "mdl_slot", "mdl_lod", "mdl_range",
    "mdl_lod_dist_sq", "mdl_skin_tex", "mdl_skin_color", "mdl_skin_shaded",
    "sky_pos", "sky_uv", "sky_tex",
    "vm_pos", "vm_uv", "vm_color", "vm_tex", "vm_item",
)
ATLAS_ARRAYS = ("blocked", "table", "mips", "n_mips", "mip_pairs", "flag_words")
STATIC = ("live_tri_bound", "has_alpha", "tex_names")
MAP_DIR = Path(__file__).resolve().parents[1] / "maps"


@dataclasses.dataclass(eq=False)
class RenderBundle:
    atlas: TextureAtlas
    lightmap: torch.Tensor  # [LH, LW, 4]
    map_pos: torch.Tensor  # [Tm, 3, 3]
    map_uv: torch.Tensor  # [Tm, 3, 2]
    map_lmuv: torch.Tensor  # [Tm, 3, 2]
    map_tex: torch.Tensor  # [Tm] i32
    map_shaded: torch.Tensor  # [Tm] bool
    mdl_pos: torch.Tensor  # [Tp, 3, 3] local space
    mdl_uv: torch.Tensor  # [Tp, 3, 2]
    mdl_color: torch.Tensor  # [Tp, 3, 4]
    mdl_slot: torch.Tensor  # [Tp] i32
    mdl_lod: torch.Tensor  # [Tp] i32
    mdl_range: torch.Tensor  # [M, 2] i32 (start, count) per model id
    mdl_lod_dist_sq: torch.Tensor  # [M, MAX_LODS]
    mdl_skin_tex: torch.Tensor  # [M, MAX_SKINS, MAX_SLOTS] i32
    mdl_skin_color: torch.Tensor  # [M, MAX_SKINS, MAX_SLOTS, 4]
    mdl_skin_shaded: torch.Tensor  # [M, MAX_SKINS, MAX_SLOTS] bool
    sky_pos: torch.Tensor  # [Ts, 3, 3]
    sky_uv: torch.Tensor  # [Ts, 3, 2]
    sky_tex: torch.Tensor  # [] i32 (-1 = no sky)
    hud: HudAssets
    ui: UiAssets  # the widget stack's textures and small font (ui/stack.py)
    # the viewmodel (the first-person item model; the eraser, item 0)
    vm_pos: torch.Tensor  # [Tv, 3, 3]
    vm_uv: torch.Tensor  # [Tv, 3, 2]
    vm_color: torch.Tensor  # [Tv, 3, 4]
    vm_tex: torch.Tensor  # [Tv] i32
    vm_item: torch.Tensor  # [Tv] i32: the item whose selection shows the row
    # the soup's row tables on the bundle's map (soup_rows), int64
    mdl_actor_rows: torch.Tensor  # [Tmo] actor of each model triangle
    mdl_pool_rows: torch.Tensor  # [Tmo] its row in the mdl_* pool
    wall_actor_rows: torch.Tensor  # [Wa] actors with a wall quad
    # static upper bound on simultaneously valid triangles in a frame
    live_tri_bound: int = 1 << 30
    # whether any texel or colour has alpha < 1: gates the reveal pass
    has_alpha: bool = True
    tex_names: tuple = ()

    @property
    def num_map_tris(self):
        return self.map_pos.shape[0]


def soup_rows(mdl_range, cmap) -> dict:
    """The row tables of the triangle soup for a model pool on a map, on
    the map's device: each model triangle's actor and pool row (the actors
    with a model, in actor order, each with its model's range of
    `mdl_range` [M, 2]), and the actors with a wall quad."""
    model_id = cmap.model_id.cpu().numpy()
    ranges = np.asarray(mdl_range)
    actor_rows, pool_rows = [], []
    for i in range(cmap.num_actors):
        m = model_id[i]
        if m >= 0:
            s, c = ranges[m]
            actor_rows.extend([i] * int(c))
            pool_rows.extend(range(int(s), int(s + c)))
    wall_rows = np.nonzero(cmap.wall_axis.cpu().numpy() >= 0)[0]
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=cmap.device)
    return dict(mdl_actor_rows=as_t(actor_rows), mdl_pool_rows=as_t(pool_rows), wall_actor_rows=as_t(wall_rows))


def bundle_from_numpy(leaves: dict, static: dict, cmap) -> RenderBundle:
    """RenderBundle of the map `cmap`, on its device, from {name: ndarray}
    (atlas leaves as `atlas.<field>`) plus the static fields."""
    t = lambda a: torch.from_numpy(np.array(a)).to(cmap.device)
    atlas = {k: t(leaves[f"atlas.{k}"]) for k in ATLAS_ARRAYS}
    atlas["blocked"] = atlas["blocked"].to(torch.bfloat16)
    return RenderBundle(
        atlas=TextureAtlas(**atlas),
        hud=HudAssets(**{k: t(leaves[f"hud.{k}"]) for k in HUD_FIELDS}),
        ui=UiAssets(**{k: t(leaves[f"ui.{k}"]) for k in UI_FIELDS}),
        **{k: t(leaves[k]) for k in ARRAYS},
        **soup_rows(leaves["mdl_range"], cmap),
        live_tri_bound=int(static["live_tri_bound"]),
        has_alpha=bool(static["has_alpha"]),
        tex_names=tuple(static["tex_names"]),
    )



def load_bundle(npz_path, json_path, cmap) -> RenderBundle:
    """Read the bundle of the map `cmap` written by `save_bundle` (or by
    tests/torch_export_map.py) onto the map's device."""
    with np.load(npz_path) as z:
        leaves = {k: z[k] for k in z.files}
    with open(json_path) as f:
        static = json.load(f)
    return bundle_from_numpy(leaves, static, cmap)


