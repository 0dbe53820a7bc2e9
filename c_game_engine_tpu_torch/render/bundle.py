"""RenderBundle: a map's render-side tensors (counterpart of
c_game_engine_tpu/render/bundle.py), holding what the render path reads:
map geometry, the actor model pool, the sky mesh, the texture atlas, the
lightmap, the HUD assets, the widget stack's assets (`ui`) and the
viewmodel mesh.

`build_render_bundle(cmap)` builds it from a map the port compiled
(compiler/compile.py, whose `aux["resolver"]` answers the models,
textures, fonts and HUD and interface textures), host side in numpy as
the JAX builder does, then on the map's device. A map without the shipped
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

On a CUDA device the bundle also keeps the render graphs captured for it
(`graphs`, render/graph.py).

A bundle belongs to its map: building or loading one takes the map and
fills the soup's row tables (`soup_rows`), which the JAX package derives
from the map's static arrays while it traces.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import torch

from c_game_engine_tpu_torch.core.state import load_map
from c_game_engine_tpu_torch.render.hud import HUD_FIELDS, HudAssets
from c_game_engine_tpu_torch.render.textures import TextureAtlas, build_atlas
from c_game_engine_tpu_torch.ui.stack import NUM_UITEX, UI_FIELDS, UiAssets

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

    @functools.cached_property
    def graphs(self) -> dict:
        """Render graphs captured for this bundle, by their key
        (render/graph.py::replay); a bundle made by dataclasses.replace
        starts with none."""
        return {}


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



def bundle_to_numpy(rb) -> tuple[dict, dict]:
    """(array leaves {name: ndarray}, static fields) of a bundle, as
    `bundle_from_numpy` reads them (`blocked` as float32, which holds each
    bfloat16 texel exactly)."""
    c = lambda x: x.detach().cpu().numpy()
    leaves = {k: c(getattr(rb, k)) for k in ARRAYS}
    for k in ATLAS_ARRAYS:
        leaves[f"atlas.{k}"] = c(getattr(rb.atlas, k).float() if k == "blocked" else getattr(rb.atlas, k))
    leaves.update({f"hud.{k}": c(getattr(rb.hud, k)) for k in HUD_FIELDS})
    leaves.update({f"ui.{k}": c(getattr(rb.ui, k)) for k in UI_FIELDS})
    static = {"live_tri_bound": int(rb.live_tri_bound), "has_alpha": bool(rb.has_alpha),
              "tex_names": list(rb.tex_names)}
    return leaves, static


def _morton3(c):
    """30-bit Morton codes of points [N, 3] over their own AABB (10
    bits/axis): the spatial sort key of a big model's triangles."""
    mn, mx = c.min(0), c.max(0)
    q = np.clip(((c - mn) / np.maximum(mx - mn, 1e-9) * 1023.0), 0, 1023).astype(np.uint32)

    def spread(x):
        x = (x | (x << np.uint32(16))) & np.uint32(0x030000FF)
        x = (x | (x << np.uint32(8))) & np.uint32(0x0300F00F)
        x = (x | (x << np.uint32(4))) & np.uint32(0x030C30C3)
        x = (x | (x << np.uint32(2))) & np.uint32(0x09249249)
        return x

    return (spread(q[:, 0]) << np.uint32(2)) | (spread(q[:, 1]) << np.uint32(1)) | spread(q[:, 2])


def _font_arrays(resolver, name, intern_or_missing):
    """(texture id, start u [128], end u [128], widths [128], height,
    spacing) of a bitmap font, or the absent font's defaults."""
    from c_game_engine_tpu_torch.assets.codecs import decode_gfon

    start = np.full(128, -1.0, np.float32)
    end = np.full(128, -1.0, np.float32)
    fw_ = np.zeros(128, np.float32)
    fh_, fsp, ftex = 16.0, 1.0, -1
    path = resolver.resolve(name)
    if path:
        f = decode_gfon(path)
        ftex = intern_or_missing(f.texture)
        fh_ = float(f.texture_height)
        fsp = float(f.char_spacing)
        for i, ch in enumerate(f.chars):
            ci = ord(ch)
            if ci < 128:
                start[ci] = f.start_uvs[i]
                end[ci] = f.end_uvs[i]
                fw_[ci] = f.widths[i]
        if f.uppercase_only:
            for lo in range(ord("a"), ord("z") + 1):
                start[lo], end[lo], fw_[lo] = start[lo - 32], end[lo - 32], fw_[lo - 32]
    return ftex, start, end, fw_, fh_, fsp


def build_render_bundle(cmap) -> RenderBundle:
    """The RenderBundle of a compiled map on the map's device (the JAX
    `build_render_bundle`, leaf for leaf)."""
    from c_game_engine_tpu_torch.assets.codecs import ModelShader, decode_gmdl

    aux = cmap.aux
    resolver = aux["resolver"]
    dev = cmap.device
    tex_names = list(aux["texture_names"])
    tex_index = {n: i for i, n in enumerate(tex_names)}

    def intern(name):
        if name not in tex_index:
            tex_index[name] = len(tex_names)
            tex_names.append(name)
        return tex_index[name]

    # ---------------- map geometry ----------------
    mv = cmap.map_verts.cpu().numpy()
    mi = cmap.map_indices.cpu().numpy().reshape(-1, 3)
    vt = cmap.map_vert_tex.cpu().numpy()
    vs = cmap.map_vert_shaded.cpu().numpy()
    map_pos = mv[mi][:, :, 0:3] if len(mi) else np.zeros((0, 3, 3), np.float32)
    map_uv = mv[mi][:, :, 3:5] if len(mi) else np.zeros((0, 3, 2), np.float32)
    map_lmuv = mv[mi][:, :, 5:7] if len(mi) else np.zeros((0, 3, 2), np.float32)
    map_tex = vt[mi[:, 0]] if len(mi) else np.zeros(0, np.int32)
    map_shaded = vs[mi[:, 0]] if len(mi) else np.zeros(0, bool)

    # ---------------- models ----------------
    model_names = aux["model_names"]
    pool_pos, pool_uv, pool_color, pool_slot, pool_lod = [], [], [], [], []
    m_count = max(len(model_names), 1)
    ranges = np.zeros((m_count, 2), np.int32)
    lod_dist_sq = np.full((m_count, MAX_LODS), np.inf, np.float32)
    skin_tex = np.full((m_count, MAX_SKINS, MAX_SLOTS), -1, np.int32)
    skin_color = np.ones((m_count, MAX_SKINS, MAX_SLOTS, 4), np.float32)
    skin_shaded = np.zeros((m_count, MAX_SKINS, MAX_SLOTS), bool)
    off = 0
    for m_id, name in enumerate(model_names):
        info = resolver.model(name)
        count = 0
        for lod_i, lod in enumerate(info.model.lods[:MAX_LODS]):
            lod_dist_sq[m_id, lod_i] = lod.distance_squared
            verts = lod.vertices  # [V, 12]
            for slot, idx in enumerate(lod.indices):
                if len(idx) == 0:
                    continue
                tri = idx.reshape(-1, 3).astype(np.int64)
                if len(tri) > 4096:
                    # big models route to the streamed rasterizer (K5),
                    # whose subchunk-bbox pruning wants spatially coherent
                    # rows: sort by centroid Morton code within the block
                    tri = tri[np.argsort(_morton3(verts[tri][:, :, 0:3].mean(1)))]
                pool_pos.append(verts[tri][:, :, 0:3])
                pool_uv.append(verts[tri][:, :, 3:5])
                pool_color.append(verts[tri][:, :, 5:9])
                pool_slot.append(np.full(len(tri), slot, np.int32))
                pool_lod.append(np.full(len(tri), lod_i, np.int32))
                count += len(tri)
        ranges[m_id] = (off, count)
        off += count
        skins = info.model.skins
        for s in range(min(len(skins), MAX_SKINS)):
            for slot in range(min(skins.shape[1], MAX_SLOTS)):
                mat = info.model.materials[int(skins[s, slot])]
                skin_tex[m_id, s, slot] = intern(mat["texture"])
                skin_color[m_id, s, slot] = mat["color"]
                skin_shaded[m_id, s, slot] = int(mat["shader"]) == int(ModelShader.SHADED)
        # out-of-range skins fall back to skin 0 (PhysicsModel.c bounds check)
        for s in range(len(skins), MAX_SKINS):
            skin_tex[m_id, s] = skin_tex[m_id, 0]
            skin_color[m_id, s] = skin_color[m_id, 0]
            skin_shaded[m_id, s] = skin_shaded[m_id, 0]

    if pool_pos:
        mdl_pos = np.concatenate(pool_pos, 0).astype(np.float32)
        mdl_uv = np.concatenate(pool_uv, 0).astype(np.float32)
        mdl_color = np.concatenate(pool_color, 0).astype(np.float32)
        mdl_slot = np.concatenate(pool_slot, 0)
        mdl_lod = np.concatenate(pool_lod, 0)
    else:
        mdl_pos = np.zeros((0, 3, 3), np.float32)
        mdl_uv = np.zeros((0, 3, 2), np.float32)
        mdl_color = np.zeros((0, 3, 4), np.float32)
        mdl_slot = np.zeros(0, np.int32)
        mdl_lod = np.zeros(0, np.int32)

    # ---------------- sky ----------------
    sky_tex_id = -1
    sky_pos = np.zeros((0, 3, 3), np.float32)
    sky_uv = np.zeros((0, 3, 2), np.float32)
    if aux.get("sky_texture"):
        sky_tex_id = intern(aux["sky_texture"])
        lod = resolver.model("model/sky.gmdl").model.lods[0]
        for idx in lod.indices:
            if len(idx):
                tri = idx.reshape(-1, 3).astype(np.int64)
                sky_pos = lod.vertices[tri][:, :, 0:3].astype(np.float32)
                sky_uv = lod.vertices[tri][:, :, 3:5].astype(np.float32)
                break

    # ---------------- HUD and UI assets ----------------
    def intern_or_missing(name):
        return intern(name) if resolver.resolve(name) else -1

    ycoin = intern_or_missing("texture/interface/hud_ycoin.gtex")
    bcoin = intern_or_missing("texture/interface/hud_bcoin.gtex")
    cross = intern_or_missing("texture/interface/crosshair.gtex")
    font_tex, font_start, font_end, font_w, font_h, font_sp = _font_arrays(
        resolver, "font/large_font.gfon", intern_or_missing)
    assert len(UI_TEXTURES) == NUM_UITEX
    ui_tex = np.full(NUM_UITEX, -1, np.int32)
    ui_size = np.ones((NUM_UITEX, 2), np.float32)
    for i, name in enumerate(UI_TEXTURES):
        if resolver.resolve(name):
            ui_tex[i] = intern(name)
            t = resolver.texture(name)
            ui_size[i] = (t.width, t.height)
    sf_tex, sf_start, sf_end, sf_w, sf_h, sf_sp = _font_arrays(resolver, "font/small_font.gfon", intern_or_missing)

    # ---------------- viewmodel (the eraser, item 0) ----------------
    vm_pos = np.zeros((0, 3, 3), np.float32)
    vm_uv = np.zeros((0, 3, 2), np.float32)
    vm_color = np.zeros((0, 3, 4), np.float32)
    vm_tex = np.zeros(0, np.int32)
    vm_item = np.zeros(0, np.int32)
    er_path = resolver.resolve("model/eraser.gmdl")
    if er_path:
        em = decode_gmdl(er_path)
        lod = em.lods[0]
        verts = lod.vertices
        parts_p, parts_u, parts_c, parts_t = [], [], [], []
        for slot, idx in enumerate(lod.indices):
            if not len(idx):
                continue
            tri = idx.reshape(-1, 3).astype(np.int64)
            mat = em.materials[int(em.skins[0, slot])] if len(em.skins) else em.materials[0]
            parts_p.append(verts[tri][:, :, 0:3])
            parts_u.append(verts[tri][:, :, 3:5])
            parts_c.append(verts[tri][:, :, 5:9] * mat["color"][None, None, :])
            parts_t.append(np.full(len(tri), intern(mat["texture"]), np.int32))
        vm_pos = np.concatenate(parts_p, 0).astype(np.float32)
        vm_uv = np.concatenate(parts_u, 0).astype(np.float32)
        vm_color = np.concatenate(parts_c, 0).astype(np.float32)
        vm_tex = np.concatenate(parts_t, 0)
        vm_item = np.zeros(len(vm_pos), np.int32)

    atlas = build_atlas([resolver.texture(n) for n in tex_names], device=dev)

    # static live-triangle bound: LOD selection keeps exactly one LOD per
    # actor, so the worst case is each actor at its largest LOD
    worst_lod = np.zeros(len(ranges), np.int64)
    for m in range(len(ranges)):
        s, c = ranges[m]
        if c > 0:
            lods_here = mdl_lod[s : s + c]
            worst_lod[m] = max((lods_here == l).sum() for l in np.unique(lods_here))
    model_id = cmap.model_id.cpu().numpy()
    wall_axis = cmap.wall_axis.cpu().numpy()
    live_bound = int(len(map_pos) + sum(int(worst_lod[m]) for m in model_id if m >= 0)
                     + 2 * int((wall_axis >= 0).sum()) + len(sky_pos))

    atlas_alpha = min((float(np.asarray(resolver.texture(n).pixels)[..., 3].min()) for n in tex_names), default=1.0)
    color_alpha = min(
        float(cmap.init_mod_color[..., 3].min()),
        float(skin_color[..., 3].min()),
        float(mdl_color[..., 3].min()) if len(mdl_color) else 1.0,
    )

    from c_game_engine_tpu_torch.compiler.compile import _tensor

    t = lambda a: _tensor(a, dev)
    return RenderBundle(
        atlas=atlas,
        lightmap=cmap.lightmap,
        map_pos=t(map_pos), map_uv=t(map_uv), map_lmuv=t(map_lmuv), map_tex=t(map_tex.astype(np.int32)),
        map_shaded=t(map_shaded),
        mdl_pos=t(mdl_pos), mdl_uv=t(mdl_uv), mdl_color=t(mdl_color), mdl_slot=t(mdl_slot), mdl_lod=t(mdl_lod),
        mdl_range=t(ranges), mdl_lod_dist_sq=t(lod_dist_sq), mdl_skin_tex=t(skin_tex),
        mdl_skin_color=t(skin_color), mdl_skin_shaded=t(skin_shaded),
        sky_pos=t(sky_pos), sky_uv=t(sky_uv), sky_tex=t(np.int32(sky_tex_id)),
        hud=HudAssets(
            ycoin_tex=t(np.int32(ycoin)), bcoin_tex=t(np.int32(bcoin)), crosshair_tex=t(np.int32(cross)),
            font_tex=t(np.int32(font_tex)), font_start_u=t(font_start), font_end_u=t(font_end),
            font_widths=t(font_w), font_height=t(np.float32(font_h)), font_spacing=t(np.float32(font_sp))),
        ui=UiAssets(
            tex=t(ui_tex), tex_size=t(ui_size), font_tex=t(np.int32(sf_tex)), font_start_u=t(sf_start),
            font_end_u=t(sf_end), font_widths=t(sf_w), font_height=t(np.float32(sf_h)),
            font_spacing=t(np.float32(sf_sp))),
        vm_pos=t(vm_pos), vm_uv=t(vm_uv), vm_color=t(vm_color), vm_tex=t(vm_tex), vm_item=t(vm_item),
        **soup_rows(ranges, cmap),
        live_tri_bound=live_bound,
        has_alpha=bool(min(atlas_alpha, color_alpha) < 0.999),
        tex_names=tuple(tex_names),
    )


def save_bundle(rb, npz_path, json_path) -> None:
    """Write a bundle as `load_bundle` reads it."""
    leaves, static = bundle_to_numpy(rb)
    np.savez_compressed(npz_path, **leaves)
    with open(json_path, "w") as f:
        json.dump(static, f, indent=1, sort_keys=True)
        f.write("\n")

def load_bundle(npz_path, json_path, cmap) -> RenderBundle:
    """Read the bundle of the map `cmap` written by `save_bundle` (or by
    tests/torch_export_map.py) onto the map's device."""
    with np.load(npz_path) as z:
        leaves = {k: z[k] for k in z.files}
    with open(json_path) as f:
        static = json.load(f)
    return bundle_from_numpy(leaves, static, cmap)


def load_render_map(name, device):
    """(map, bundle) of a committed map with render content, read from
    c_game_engine_tpu_torch/maps/ onto `device`."""
    cmap = load_map(MAP_DIR / f"{name}.npz", MAP_DIR / f"{name}.json", device)
    return cmap, load_bundle(MAP_DIR / f"{name}_bundle.npz", MAP_DIR / f"{name}_bundle.json", cmap)
