"""The committed maps (c_game_engine_tpu_torch/maps/arena.*,
arena_bodies.* and arena_lit.* with its render bundle arena_lit_bundle.*)
equal a fresh export from the JAX package, so the fixtures the port's
tests and chip_smoke.py load cannot go stale. Regenerate with
`python tests/torch_export_map.py`."""

from __future__ import annotations

import json

import numpy as np
import torch

from tests.torch_export_map import MAP_DIR, MAPS, map_to_numpy


def test_committed_arena_equals_fresh_export():
    _assert_committed_equals_fresh("arena")


def test_committed_arena_bodies_equals_fresh_export():
    _assert_committed_equals_fresh("arena_bodies")


def _assert_committed_equals_fresh(name, cmap=None):
    leaves, aux = map_to_numpy(MAPS[name]() if cmap is None else cmap)
    with np.load(MAP_DIR / f"{name}.npz") as z:
        assert sorted(z.files) == sorted(leaves)
        for k, v in leaves.items():
            assert z[k].dtype == v.dtype and z[k].shape == v.shape, k
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    with open(MAP_DIR / f"{name}.json") as f:
        assert json.load(f) == json.loads(json.dumps(aux))


def test_arena_meets_the_slice_requirements():
    """>= 4000 static triangles, >= 8 asset-free actors, no dynamic body,
    and the only tilted triangles are the ramp's."""
    from c_game_engine_tpu_torch.core.state import load_map

    cm = load_map(MAP_DIR / "arena.npz", MAP_DIR / "arena.json", "cpu")
    assert cm.aux["num_real_tris"] >= 4000 and cm.aux["num_real_actors"] >= 8
    assert cm.aux["num_dynamic"] == 0
    n = cm.tri_normal[cm.tri_valid].numpy()
    tris = cm.tris[cm.tri_valid].numpy()
    tilted = (np.abs(n[:, 1]) > 1e-6) & (np.abs(n[:, 1]) < 1 - 1e-6)
    z = tris[tilted][..., 2]
    assert tilted.sum() == 32 and z.min() >= 6.0 and z.max() <= 10.0  # 4 x 4 ramp cells


def test_arena_bodies_meets_the_slice_requirements():
    """The arena's static world and actors plus >= 10 dynamic bodies, with
    both box bodies and vertex-cloud hull bodies (both branches of K3)."""
    from c_game_engine_tpu_torch.core.state import load_map

    cm = load_map(MAP_DIR / "arena_bodies.npz", MAP_DIR / "arena_bodies.json", "cpu")
    base = load_map(MAP_DIR / "arena.npz", MAP_DIR / "arena.json", "cpu")
    assert torch.equal(cm.tri16, base.tri16)
    n_base = len(base.aux["actor_classes"])
    assert cm.aux["actor_classes"][:n_base] == base.aux["actor_classes"]
    n = cm.aux["num_dynamic"]
    assert n >= 10 and not cm.aux["hulls_are_boxes"]
    flags = cm.aux["dyn_is_box"][:n]
    assert any(flags) and not all(flags)
    assert sorted(set(cm.aux["actor_classes"][n_base:])) == ["NPC_JOHN", "PHYSBOX"]


def test_committed_arena_lit_equals_fresh_export():
    """The map and its render bundle (array leaves and static fields)."""
    from c_game_engine_tpu.render.bundle import build_render_bundle
    from tests.torch_export_map import bundle_to_numpy

    cmap = MAPS["arena_lit"]()
    _assert_committed_equals_fresh("arena_lit", cmap)
    leaves, static = bundle_to_numpy(build_render_bundle(cmap))
    with np.load(MAP_DIR / "arena_lit_bundle.npz") as z:
        assert sorted(z.files) == sorted(leaves)
        for k, v in leaves.items():
            assert z[k].dtype == v.dtype and z[k].shape == v.shape, k
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    with open(MAP_DIR / "arena_lit_bundle.json") as f:
        assert json.load(f) == static


def test_arena_lit_meets_the_slice_requirements():
    """The arena's collision and actors plus render content: a soup of at
    most 4,000 triangles (the T_CULL compaction never engages), alpha
    content (the reveal pass runs), a sky, a texture with repeat, filter
    and mipmaps, a nearest-filtered one, and the fallback checkerboard of
    an unresolved material; a lightmap larger than 1 x 1."""
    from c_game_engine_tpu_torch.core.state import load_map
    from c_game_engine_tpu_torch.render.bundle import load_render_map

    cm, rb = load_render_map("arena_lit", "cpu")
    base = load_map(MAP_DIR / "arena.npz", MAP_DIR / "arena.json", "cpu")
    assert torch.equal(cm.tri16, base.tri16)
    assert cm.aux["actor_classes"] == base.aux["actor_classes"]
    assert rb.live_tri_bound <= 4000 and rb.has_alpha
    assert int(rb.sky_tex) >= 0 and rb.sky_pos.shape[0] == 12
    table, n_mips = rb.atlas.table.numpy(), rb.atlas.n_mips.numpy()
    assert ((table[:, 4] > 0.5) & (table[:, 5] > 0.5) & (n_mips > 1)).any()
    assert ((table[:, 5] < 0.5) & (n_mips == 1)).any()
    assert "_generic_fallback" in rb.tex_names
    fallback = rb.tex_names.index("_generic_fallback")
    assert fallback in set(rb.map_tex.tolist())
    assert rb.lightmap.shape == (64, 64, 4) and float(rb.lightmap[..., 0].std()) > 0.05
