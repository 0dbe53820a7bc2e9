"""The committed maps (c_game_engine_tpu_torch/maps/arena.* and
arena_bodies.*) equal a fresh export from the JAX compiler, so the
fixtures the port's tests and chip_smoke.py load cannot go stale.
Regenerate with `python tests/torch_export_map.py`."""

from __future__ import annotations

import json

import numpy as np
import torch

from tests.torch_export_map import MAP_DIR, MAPS, map_to_numpy


def test_committed_arena_equals_fresh_export():
    _assert_committed_equals_fresh("arena")


def test_committed_arena_bodies_equals_fresh_export():
    _assert_committed_equals_fresh("arena_bodies")


def _assert_committed_equals_fresh(name):
    leaves, aux = map_to_numpy(MAPS[name]())
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
