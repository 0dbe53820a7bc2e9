"""The committed maps (c_game_engine_tpu_torch/maps/arena.*,
arena_bodies.*, and arena_lit.* and arena_orb.* with their render bundles
<name>_bundle.*) equal a fresh export from the JAX package, so the
fixtures the port's tests and chip_smoke.py load cannot go stale.
Regenerate with `python tests/torch_export_map.py [names]`."""

from __future__ import annotations

import json

import numpy as np
import pytest
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
    _assert_bundle_equals_fresh("arena_lit", MAPS["arena_lit"]())


def _assert_bundle_equals_fresh(name, cmap):
    from c_game_engine_tpu.render.bundle import build_render_bundle
    from tests.torch_export_map import bundle_to_numpy

    _assert_committed_equals_fresh(name, cmap)
    leaves, static = bundle_to_numpy(build_render_bundle(cmap))
    with np.load(MAP_DIR / f"{name}_bundle.npz") as z:
        assert sorted(z.files) == sorted(leaves)
        for k, v in leaves.items():
            assert z[k].dtype == v.dtype and z[k].shape == v.shape, k
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    with open(MAP_DIR / f"{name}_bundle.json") as f:
        assert json.load(f) == static


# sha256 of the bundles' array leaves as committed before the HUD and
# viewmodel fields were exported (name, dtype, shape and bytes of each, in
# name order): adding fields must leave every earlier array as it was
BUNDLE_DIGESTS_BEFORE_HUD = {
    "arena_lit": "ae856d24d5f2f1a9bdf91575b2e15e8c9d37c6f0a01af1a5e8fef50c6e408ca1",
    "arena_orb": "1b5afc447252cfdf5c3322ec0d4fe3ef743471b4e800b53a6113e8c0d6541ffd",
}


@pytest.mark.parametrize("name", sorted(BUNDLE_DIGESTS_BEFORE_HUD))
def test_bundle_arrays_before_the_hud_fields_are_unchanged(name):
    """The committed bundle holds the HUD (`hud.<field>`), UI
    (`ui.<field>`) and viewmodel (`vm_*`) leaves, asset-free (ids -1, no
    rows), and every other array byte for byte as before they were added."""
    import hashlib

    from c_game_engine_tpu_torch.render.hud import HUD_FIELDS
    from c_game_engine_tpu_torch.ui.stack import NUM_UITEX, UI_FIELDS

    new = ({f"hud.{k}" for k in HUD_FIELDS} | {f"ui.{k}" for k in UI_FIELDS}
           | {"vm_pos", "vm_uv", "vm_color", "vm_tex", "vm_item"})
    h = hashlib.sha256()
    with np.load(MAP_DIR / f"{name}_bundle.npz") as z:
        assert new <= set(z.files)
        for k in sorted(set(z.files) - new):
            a = z[k]
            h.update(f"{k} {a.dtype.str} {a.shape}".encode())
            h.update(np.ascontiguousarray(a).tobytes())
        assert int(z["hud.ycoin_tex"]) == int(z["hud.font_tex"]) == -1 and z["vm_pos"].shape == (0, 3, 3)
        assert z["ui.tex"].shape == (NUM_UITEX,) and (z["ui.tex"] == -1).all() and int(z["ui.font_tex"]) == -1
    assert h.hexdigest() == BUNDLE_DIGESTS_BEFORE_HUD[name]


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


@pytest.fixture(scope="module")
def orb_jax():
    return MAPS["arena_orb"]()


def test_committed_arena_orb_equals_fresh_export(orb_jax):
    """The map and its render bundle (array leaves and static fields)."""
    _assert_bundle_equals_fresh("arena_orb", orb_jax)


def test_arena_orb_meets_the_slice_requirements():
    """arena_lit (collision, actors, render content) plus one
    STATIC_MODEL actor, which makes no physics body, carrying an
    81,920-triangle model: the live-triangle bound exceeds the tile
    route's 65,536 (so the big route and K5 run), alpha content and a sky
    stay, and the model's triangles are in the Morton order of their
    centroids that build_render_bundle gives a slot block of more than
    4096 triangles."""
    from c_game_engine_tpu.render.bundle import _morton3
    from c_game_engine_tpu_torch.actors.defs import ActorClass
    from c_game_engine_tpu_torch.render.bundle import load_render_map

    cm, rb = load_render_map("arena_orb", "cpu")
    lit, lit_rb = load_render_map("arena_lit", "cpu")
    assert torch.equal(cm.tri16, lit.tri16)
    assert cm.aux["actor_classes"] == lit.aux["actor_classes"] + [ActorClass.STATIC_MODEL.name]
    assert cm.aux["num_dynamic"] == 0
    assert rb.live_tri_bound > 65536 and rb.has_alpha
    assert int(rb.sky_tex) >= 0 and torch.equal(rb.sky_pos, lit_rb.sky_pos)
    assert torch.equal(rb.map_pos, lit_rb.map_pos)
    assert rb.mdl_pos.shape[0] == 81920 and rb.mdl_actor_rows.numel() == 81920
    keys = _morton3(rb.mdl_pos.numpy().mean(1))
    assert (np.diff(keys.astype(np.int64)) >= 0).all()


def test_arena_orb_rollout_matches_jax(orb_jax, tmp_path):
    """reset and a 30-tick rollout of two envs on arena_orb (the scripted
    stream of tests/torch_parity.py: coin, trigger, door, interact, fire)
    on the port against the JAX package, at the bars of
    tests/test_tpu_parity.py: player position 2e-3, other floats 5e-3,
    everything else exact. The STATIC_MODEL class is new to the port's
    tick."""
    import jax

    from c_game_engine_tpu.core.state import reset as j_reset_one
    from c_game_engine_tpu.models.sim import reset_batch as j_reset
    from c_game_engine_tpu.models.sim import rollout as j_rollout
    from c_game_engine_tpu_torch.core.state import reset
    from c_game_engine_tpu_torch.models.sim import reset_batch, rollout
    from tests.torch_parity import (
        assert_leaves_match,
        export_and_load,
        jax_actions,
        jax_leaves,
        stream_batch,
        torch_actions,
        torch_leaves,
    )

    jc = orb_jax
    tc = export_and_load(jc, tmp_path)
    assert_leaves_match(jax_leaves(j_reset_one(jc)), torch_leaves(reset(tc)), default=0)
    streams = stream_batch(30, 2)
    js = jax.jit(lambda s, a: j_rollout(jc, s, a))(j_reset(jc, 2), jax_actions(*streams))
    ts = rollout(tc, reset_batch(tc, 2), torch_actions(*streams))
    assert_leaves_match(jax_leaves(js), torch_leaves(ts), {"player.pos": 2e-3})
