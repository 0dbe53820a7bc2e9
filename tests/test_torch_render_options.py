"""The render path's options and its graph capture on the CPU: the xla
route's pass 1 against the JAX `_pass1_xla`, the debug wireframe segments
and quads and the rate graph against render/debug_draw.py, the reveal
overflow gate on both of its sides (against the JAX frame where it opens),
and the capture safety of a frame batch (what a CUDA graph capture of
render_batch and render_with_hud_batch would refuse). Whole frames of each
option are held to the JAX package in
tests/test_torch_render.py::test_every_option_renders_like_jax.

Inputs are made from numpy seeds; the JAX side is arena_lit compiled once
per process (tests/torch_frames.py::jax_arena_lit), states are a reset with
a placed camera (no ticks). Tolerances: segments, quads and the graph
overlay within 1e-6 of max(1, |x|); frames by
tests/torch_frames.py::check_frames.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from c_game_engine_tpu_torch.render.graph_check import CLOSE_COIN
from tests.torch_frames import (COIN_VIEW, JaxRecorder, PortRecorder, check_frames, edge_distance,
                                jax_arena_lit, jax_env, view_states)
from tests.torch_parity import HostTraffic

H, W = 128, 128


@pytest.fixture(scope="module")
def lit():
    from c_game_engine_tpu_torch.render.bundle import load_render_map

    return load_render_map("arena_lit", "cpu")


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert (np.abs(got - want) <= tol * np.maximum(1.0, np.abs(want))).all(), float(np.abs(got - want).max())


def test_pass1_xla_matches_jax():
    """The chunked z pass at a frame that is not whole tiles (40 x 72), two
    envs of 192 random triangles (three chunks) with dead rows, equal-z
    twins and an exclude image: winners equal except within 1e-3 px of an
    edge of either winner (XLA fuses the edge function), and an equal-z
    twin never beats its lower row (the strictly-closer tie rule)."""
    import jax
    import jax.numpy as jnp

    from c_game_engine_tpu.render.raster import _pass1_xla as j_pass1
    from c_game_engine_tpu_torch.render.raster import _pass1_xla, _pixel_grid

    h, w, t = 40, 72, 192
    rng = np.random.default_rng(11)
    c = rng.uniform([-10, -10], [w + 10, h + 10], (2, t, 1, 2))
    v = (c + rng.uniform(-14, 14, (2, t, 3, 2))).astype(np.float32)
    sz = rng.uniform(-0.2, 1.2, (2, t, 3)).astype(np.float32)
    v[:, 1::9], sz[:, 1::9] = v[:, 0::9], sz[:, 0::9]  # rows 9k + 1 repeat rows 9k: equal-z twins
    ok = rng.random((2, t)) > 0.1
    exclude = rng.integers(-1, t, (2, h, w)).astype(np.int32)
    exclude[:, : h // 2] = -1
    gx, gy = _pixel_grid(h, w, "cpu")
    got = _pass1_xla(torch.tensor(v[..., 0]), torch.tensor(v[..., 1]), torch.tensor(sz), torch.tensor(ok), gx, gy,
                     torch.tensor(exclude)).numpy()
    jgx, jgy = jnp.meshgrid(jnp.arange(w, dtype=jnp.float32) + 0.5, jnp.arange(h, dtype=jnp.float32) + 0.5)
    run = jax.jit(lambda sx, sy, z, o, ex: j_pass1(sx, sy, z, o, jgx, jgy, h, w, exclude=ex))
    gyy, gxx = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    for e in range(2):
        want = np.asarray(run(v[e, ..., 0], v[e, ..., 1], sz[e], ok[e], exclude[e]))
        near = np.zeros((h, w), bool)
        for win in (got[e], want):
            near |= (win >= 0) & (edge_distance(v[e].astype(np.float64)[np.maximum(win, 0)], gxx, gyy) <= 1e-3)
        assert not ((got[e] != want) & ~near).any()
        assert (got[e] != want).mean() < 0.01
    assert (got >= 0).mean() > 0.3 and (got[exclude >= 0] != exclude[exclude >= 0]).all()
    top = got[:, : h // 2]  # no exclude image there: a twin wins only where its lower row is not ok
    twin = (top % 9 == 1) & (top >= 0)
    for e in range(2):
        assert not ok[e][top[e][twin[e]] - 1].any()


def test_debug_segments_match_jax(lit):
    """collect_segments and segments_to_part on arena_lit with the door
    kinematic and two more actors made dynamic boxes, two envs with moved,
    turned and deactivated actors and different cameras: segments, colours,
    validity and every field of the soup part against the JAX functions
    per env."""
    import jax.numpy as jnp

    from c_game_engine_tpu.render import debug_draw as JD
    from c_game_engine_tpu_torch.render import debug_draw as D

    cm, _ = lit
    jc, _ = jax_arena_lit()
    motion = np.asarray(jc.motion).copy()
    shape = np.asarray(jc.shape).copy()
    motion[[0, 6]], shape[[0, 6]] = 3, 1  # a coin and the counter as dynamic boxes
    jc = jc.replace(motion=jnp.asarray(motion), shape=jnp.asarray(shape))
    pc = cm.replace(motion=torch.tensor(motion), shape=torch.tensor(shape))
    js, ps = view_states(jc, pc, [None, COIN_VIEW])
    rng = np.random.default_rng(12)
    n = ps.actors.pos.shape[1]
    pos = np.asarray(js.actors.pos) + rng.uniform(-2, 2, (2, n, 3)).astype(np.float32)
    quat = rng.normal(size=(2, n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    active = rng.random((2, n)) > 0.3
    ps = ps.replace(actors=ps.actors.replace(pos=torch.tensor(pos), quat=torch.tensor(quat),
                                             active=torch.tensor(active)))
    cam = torch.tensor(rng.uniform(-5, 5, (2, 3)), dtype=torch.float32) + ps.player.pos
    segs, cols, valid = D.collect_segments(pc, ps)
    part = D.segments_to_part(segs, cols, valid, cam)
    assert valid.any(-1).all() and not valid.all()
    for e in range(2):
        je = jax_env(js, e)
        je = je.replace(actors=je.actors.replace(pos=jnp.asarray(pos[e]), quat=jnp.asarray(quat[e]),
                                                 active=jnp.asarray(active[e])))
        jsegs, jcols, jvalid = JD.collect_segments(jc, je)
        _close(segs[e].numpy(), jsegs)
        _close(cols[e].numpy(), jcols)
        np.testing.assert_array_equal(valid[e].numpy(), np.asarray(jvalid))
        jpart = JD.segments_to_part(jsegs, jcols, jvalid, jnp.asarray(cam[e].numpy()))
        for k, want in jpart.items():
            got = part[k][e].numpy()
            if got.dtype.kind == "f":
                _close(got, np.asarray(want))
            else:
                np.testing.assert_array_equal(got, np.asarray(want), err_msg=k)


@pytest.mark.parametrize("hi", [None, 50.0])
def test_graph_overlay_matches_jax(hi):
    """The rate graph over two random frames of 72 x 160, 30 values with a
    spike past `hi`, against the JAX graph_overlay."""
    from c_game_engine_tpu.render.debug_draw import graph_overlay as j_overlay
    from c_game_engine_tpu_torch.render.debug_draw import graph_overlay

    rng = np.random.default_rng(13)
    frames = rng.random((2, 72, 160, 3)).astype(np.float32)
    values = rng.uniform(10, 60, 30).astype(np.float32)
    values[17] = 80.0
    got = graph_overlay(torch.tensor(frames), torch.tensor(values), lo=5.0, hi=hi, origin=(6, 10))
    for e in range(2):
        want = np.asarray(j_overlay(frames[e], values, lo=5.0, hi=hi, origin=(6, 10)))
        _close(got[e].numpy(), want)
        assert (np.abs(want - frames[e]).max(-1) > 0.1).sum() > 100  # the line and the panel show


def test_reveal_overflow_gate_both_sides(lit, monkeypatch):
    """128 x 128 has 16 tiles and a reveal budget of 8. An env 0.6 m from a
    coin keeps its screen-door pixels within the budget: the gate stays
    closed and the frame is the compacted reveal. An env 0.12 m from it has
    them on more tiles: the gate opens, every env of the batch is
    re-shaded over the full frame (the JAX package's cond outside the
    vmap), bit for bit equal to the compacted reveal on the env within the
    budget, and the overflowing env's frame is held to the JAX one (which
    takes its full-frame fallback) by check_frames."""
    import jax

    from c_game_engine_tpu.render import raster as JR
    from c_game_engine_tpu_torch.core import gates
    from c_game_engine_tpu_torch.render import raster as R

    cm, rb = lit
    jc, jb = jax_arena_lit()
    js, ps = view_states(jc, cm, [CLOSE_COIN, COIN_VIEW])
    one = R.tree_map(lambda x: x[1:], ps)
    rgb_cmp, overflow, ctx = R._render_envs(rb, cm, one, H, W, 90.0, True)
    assert not bool(overflow.any()) and bool(ctx["disc1"].any())
    reads = gates.host_reads
    assert torch.equal(R.render_batch(rb, cm, one, H, W), rgb_cmp)
    rgb_cmp2, overflow2, ctx2 = R._render_envs(rb, cm, ps, H, W, 90.0, True)
    assert overflow2.tolist() == [True, False]
    full = R._finish_reveal_full(rb, ctx2, ps, H, W, True)
    with gates.warm_up():  # both sides run, the open one's frame returns
        assert torch.equal(R.render_batch(rb, cm, ps, H, W), full)
    prec = PortRecorder(monkeypatch)
    got = R.render_batch(rb, cm, ps, H, W)
    assert gates.host_reads == reads + 3  # one gate read a frame batch
    assert torch.equal(got, full) and not torch.equal(got[0], rgb_cmp2[0])
    assert torch.equal(got[1], rgb_cmp[0])
    jrec = JaxRecorder(monkeypatch)
    j0 = jax.tree.map(lambda x: x[:1], js)
    want = np.asarray(jax.jit(lambda s: JR.render_batch(jb, jc, s, H, W, backend="xla"))(j0))[0]
    check_frames(got[0].numpy(), want, prec.env(0), jrec.env(), rb)


# the plain kernel versions read their list lengths on the host; the card
# path never calls them
PLAIN = {"_plain", "tile_lists"}


@pytest.mark.parametrize("case", ["tiles", "big", "options", "hud"])
def test_frame_batch_is_capture_safe(lit, case):
    """A frame batch builds no tensor from host values, runs no op with a
    data-dependent output size and reads the device only in the gate
    helper (core/gates.py), once: the reveal overflow. Run with both sides
    of the gate (gates.warm_up, as before a capture), so every op of
    either side is seen. Cases: arena_lit on the tile route and arena_orb
    on the big route (1 env, 128 x 128), the options (the xla route at 100
    x 128 with aniso 4 and the wireframes, and ssaa 2 on the tile route)
    and render_with_hud_batch with the synthetic HUD and viewmodel (128 x
    256)."""
    from c_game_engine_tpu_torch.core import gates
    from c_game_engine_tpu_torch.models.sim import reset_batch
    from c_game_engine_tpu_torch.render import raster as R
    from c_game_engine_tpu_torch.render.bundle import load_render_map
    from c_game_engine_tpu_torch.render.synthetic_hud import hud_states, with_synthetic_hud

    cm, rb = load_render_map("arena_orb", "cpu") if case == "big" else lit
    st = reset_batch(cm, 1)
    hb, hs = with_synthetic_hud(rb), hud_states(st)
    # (a frame batch, its gate reads): a frame that is not whole tiles
    # resolves its reveal without the gate
    calls = {
        "tiles": [(lambda: R.render_batch_eager(rb, cm, st, H, W), 1)],
        "big": [(lambda: R.render_batch_eager(rb, cm, st, H, W), 1)],
        "options": [(lambda: R.render_batch_eager(rb, cm, st, 100, W, aniso=4, debug_wireframe=True), 0),
                    (lambda: R.render_batch_eager(rb, cm, st, 64, W, ssaa=2), 1)],
        "hud": [(lambda: R.render_with_hud_batch(hb, cm, hs, H, 2 * W), 1)],
    }[case]
    for call, gate_reads in calls:
        call()  # the cached constants exist after a first call
        before = gates.host_reads
        with HostTraffic(PLAIN) as mode, gates.warm_up():  # both sides of the gate run
            call()
        seen = mode.seen
        assert seen["lift_fresh"] == [] and seen["data_dependent"] == [], seen
        assert gates.host_reads - before == len(seen["_local_scalar_dense"]) == gate_reads, seen
        assert all("core/gates.py" in site for site in seen["_local_scalar_dense"]), seen
