"""K4's binned entry point on the CPU: `raster_tiles_binned_plain` (the
binning, the tile gate and the walk of ops/raster_tiles.py, which the CUDA
kernel does in one launch) against the JAX package's `bin_triangles` and
`raster_tiles_pallas` in interpret mode, on the binning edge table of
tests/torch_inputs.py::k4_bin_edge_inputs; the CPU route against the
plain version; the wrapper's checks.

Tolerances: per-tile lists and counts, winner ids and enc words exactly;
the float planes within the 1e-6 of
tests/test_torch_render.py::test_raster_tiles_plain_matches_pallas (XLA's
CPU code fuses the edge functions' multiply-adds, the port does not).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.torch_inputs import EDGE_ROWS, k4_bin_edge_inputs

H, W = 16, 256


@pytest.mark.parametrize("kind", ["crowded", "small"])
def test_binned_plain_matches_pallas(kind):
    """The fused plain version against JAX bin_triangles + the Pallas
    kernel: rows with tri_ok false, NaN and infinite coordinates, boxes on
    and one float off the tile bounds, a tile of more than 512 rows
    ("crowded", T = 640) and T < 512 ("small", L = T), an exclude image
    and a gated-off tile."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from c_game_engine_tpu.ops.raster_tiles import bin_triangles as jbin
    from c_game_engine_tpu.ops.raster_tiles import raster_tiles_pallas
    from c_game_engine_tpu_torch.ops.raster_tiles import L_CAP, bin_triangles, raster_tiles_binned_plain

    tri48, ok, excl, on = k4_bin_edge_inputs(kind)
    t = tri48.shape[1]
    t48 = torch.tensor(tri48)
    got = raster_tiles_binned_plain(t48, torch.tensor(ok), H, W, exclude=torch.tensor(excl),
                                    tile_on=torch.tensor(on))
    idx, cnt = bin_triangles(t48[..., 0:6:2], t48[..., 1:6:2], torch.tensor(ok), H, W)
    for b in range(tri48.shape[0]):
        sx, sy = jnp.asarray(tri48[b, :, 0:6:2]), jnp.asarray(tri48[b, :, 1:6:2])
        jidx, jcnt = jbin(sx, sy, jnp.asarray(ok[b]), H, W)
        jidx, jcnt = np.asarray(jidx), np.asarray(jcnt)
        np.testing.assert_array_equal(cnt[b].numpy(), jcnt[..., 0, 0])
        for ty in range(H // 8):
            for tx in range(W // 128):
                k = jcnt[ty, tx, 0, 0]
                np.testing.assert_array_equal(idx[b, ty, tx, :k].numpy(), jidx[ty, tx, :k])
        gated = np.where(on[b].reshape(H // 8, W // 128)[..., None, None] != 0, jcnt, 0)
        with pltpu.force_tpu_interpret_mode():
            want = raster_tiles_pallas(jnp.asarray(tri48[b]), jnp.asarray(jidx), jnp.asarray(gated), H, W,
                                       exclude=jnp.asarray(excl[b]))
        for k, (g, j) in enumerate(zip(got, want)):
            if k in (1, 11):
                np.testing.assert_array_equal(g[b].numpy(), np.asarray(j), err_msg=f"env {b}, plane {k}")
            else:
                np.testing.assert_allclose(g[b].numpy(), np.asarray(j), atol=1e-6, rtol=0,
                                           err_msg=f"env {b}, plane {k}")

    # the table reaches what it is built for
    for name, rows in EDGE_ROWS.items():
        for r, tiles in rows:
            listed = {(ty, tx) for ty in range(H // 8) for tx in range(W // 128)
                      if r in idx[0, ty, tx, :cnt[0, ty, tx]].tolist()}
            assert listed == set(tiles), f"{name}: row {r} listed in {sorted(listed)}"
    win = got[1].numpy()
    assert not np.isin(win, np.arange(8)).any()  # not ok, NaN and infinite rows never win
    assert (win[-1, 8:, :128] == -1).all()  # the gated tile keeps the initial values
    assert not np.isin(win[0][excl[0] == -1], [21]).any()  # the twin loses to row 20
    if kind == "crowded":
        assert int(cnt[0, 0, 0]) == L_CAP
        dropped = idx[0, 0, 0, -1].item() + 1  # the first crowd row past the cap
        assert np.isin(win[0, :8, :128], np.arange(dropped - 40, dropped)).any()
        assert not np.isin(win[0, :8, :128], np.arange(dropped, 28 + 560)).any()
    else:
        assert t < L_CAP and idx.shape[-1] == t


@pytest.mark.parametrize("case", ["exclude_and_gate", "no_exclude"])
def test_binned_cpu_route_matches_plain(case):
    """raster_tiles_binned on CPU tensors runs the plain version; no
    exclude image equals an image of -1; a gated tile equals a zeroed count
    in the walk over bin_triangles' lists."""
    from c_game_engine_tpu_torch.ops import raster_tiles as K4

    tri48, ok, excl, on = (torch.tensor(a) for a in k4_bin_edge_inputs("small", seed=12))
    if case == "no_exclude":
        excl, on = None, None
    before = K4.launches
    got = K4.raster_tiles_binned(tri48, ok, H, W, exclude=excl, tile_on=on)
    assert K4.launches == before
    want = K4.raster_tiles_binned_plain(tri48, ok, H, W, exclude=excl, tile_on=on)
    idx, cnt = K4.bin_triangles(tri48[..., 0:6:2], tri48[..., 1:6:2], ok, H, W)
    if on is not None:
        cnt = cnt * on.reshape(cnt.shape)
    full = torch.full((tri48.shape[0], H, W), -1, dtype=torch.int32) if excl is None else excl
    by_lists = K4.raster_tiles_plain(tri48, idx, cnt, H, W, exclude=full)
    for a, b, c in zip(got, want, by_lists):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert float((got[1] >= 0).float().mean()) > 0.5


def test_binned_wrapper_raises():
    """The binned entry point raises on frames that are not whole tiles,
    wrong shapes and dtypes; raster_tiles takes CPU tensors only."""
    from c_game_engine_tpu_torch.ops import raster_tiles as K4

    tri48, ok, excl, on = (torch.tensor(a) for a in k4_bin_edge_inputs("small", seed=12))
    with pytest.raises(NotImplementedError, match="whole"):
        K4.raster_tiles_binned(tri48, ok, 12, W)
    with pytest.raises(TypeError, match="tri_ok"):
        K4.raster_tiles_binned(tri48, ok.int(), H, W)
    with pytest.raises(ValueError, match="tile_on"):
        K4.raster_tiles_binned(tri48, ok, H, W, tile_on=on.reshape(-1, 2, 2))
    with pytest.raises(TypeError, match="tri48"):
        K4.raster_tiles_binned(tri48.double(), ok, H, W)
    meta = tri48.to("meta")
    idx, cnt = K4.bin_triangles(tri48[..., 0:6:2], tri48[..., 1:6:2], ok, H, W)
    with pytest.raises(ValueError, match="CPU tensors"):
        K4.raster_tiles(meta, idx.to("meta"), cnt.to("meta"), H, W)
