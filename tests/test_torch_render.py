"""The port's render path against the JAX package on the CPU: the camera
math, texture sampling, tile binning, the tile kernel K4's plain version
(against the Pallas kernel in interpret mode), the near-plane clip, a
whole `render_batch` of the arena_lit map, the compacted reveal pass, far
geometry (hazard a of ROADMAP.md §3), the actor-model rows of the
triangle soup, the JAX signature of render/render_batch, and the frames
and options the port raises on. Inputs are made from
numpy seeds; the port reads the committed arena_lit files
(tests/torch_export_map.py).

Tolerances: float results within 1e-6 where both sides evaluate the same
float32 expressions; kernel winner ids and enc words exactly. Frames
within the 2e-4 of tests/test_render.py:145 at every pixel where both
sides make the same discrete choices. XLA's CPU code fuses multiply-adds,
which the port's PyTorch ops do not (test_xla_cpu_fuses_the_edge_function),
so a pixel centre on a triangle edge may go to the other triangle and a
lightmap uv on a texel boundary to the other texel: test (f) excuses such
a pixel only after checking that it lies on that boundary.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from tests.torch_export_map import MAP_DIR
from tests.torch_inputs import k4_inputs
from tests.torch_parity import jax_actions

H = W = 128


@pytest.fixture(scope="module")
def lit():
    from c_game_engine_tpu_torch.render.bundle import load_render_map

    return load_render_map("arena_lit", "cpu")


def _bench_stream(ticks, batch):
    """The bench.py stream (hold W, turn 0.01 rad per tick); env 1 turns
    the other way."""
    move = np.zeros((ticks, batch, 2), np.float32)
    look = np.zeros((ticks, batch, 2), np.float32)
    move[..., 1] = -1.0
    look[..., 0] = 0.01
    look[:, 1::2, 0] = -0.02
    return move, look, np.zeros((ticks, batch, 10), bool)


def test_mathx_matches_jax():
    """(a) quat_mul, quat_from_yaw_pitch, perspective_lh_zo, quat_look."""
    import jax.numpy as jnp

    from c_game_engine_tpu.utils import mathx as J
    from c_game_engine_tpu_torch.utils import mathx as P

    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 64, 4)).astype(np.float32)
    np.testing.assert_allclose(P.quat_mul(torch.tensor(a), torch.tensor(b)).numpy(),
                               np.asarray(J.quat_mul(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)
    yaw = rng.uniform(-7, 7, 64).astype(np.float32)
    pitch = rng.uniform(-1.6, 1.6, 64).astype(np.float32)
    q = P.quat_from_yaw_pitch(torch.tensor(yaw), torch.tensor(pitch))
    np.testing.assert_allclose(q.numpy(), np.asarray(J.quat_from_yaw_pitch(jnp.asarray(yaw), jnp.asarray(pitch))),
                               atol=1e-6)
    for fov, aspect in ((90.0, 1.0), (70.0, 16 / 9), (45.0, 0.5)):
        got = P.perspective_lh_zo(torch.tensor(fov) * (np.pi / 180.0), aspect, 0.01, 2000.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(J.perspective_lh_zo(jnp.deg2rad(fov), aspect, 0.01, 2000.0)),
                                   atol=1e-6)
    pos = rng.uniform(-30, 30, (16, 3)).astype(np.float32)
    got = P.quat_look(torch.tensor(pos), torch.tensor(a[:16]))
    for i in range(16):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(J.quat_look(jnp.asarray(pos[i]), jnp.asarray(a[i]))),
                                   atol=1e-6 * 30)


@pytest.mark.parametrize("path", ["flags", "flagless"])
def test_sample_matches_jax(lit, path):
    """(b) the atlas sampler on the exported arena_lit atlas, random tex
    ids, uvs in [-1.5, 2.5] and lods, through both metadata paths."""
    import jax.numpy as jnp

    from c_game_engine_tpu.render.textures import TextureAtlas as JAtlas
    from c_game_engine_tpu.render.textures import sample as jsample
    from c_game_engine_tpu_torch.render.textures import sample

    _, rb = lit
    with np.load(MAP_DIR / "arena_lit_bundle.npz") as z:
        ja = JAtlas(**{k: jnp.asarray(z[f"atlas.{k}"]) for k in
                       ("blocked", "table", "mips", "n_mips", "mip_pairs", "flag_words")})
    ja = ja.replace(blocked=ja.blocked.astype(jnp.bfloat16))
    rng = np.random.default_rng(1)
    n, nt = 4096, rb.atlas.table.shape[0]
    tid = rng.integers(-1, nt + 1, n).astype(np.int32)  # out-of-range ids clamp
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    if path == "flags":
        # the rasterizer's lods: quarter levels clamped to the chain, whole
        # levels for nearest-filtered textures, flags from the enc bits
        t = np.clip(tid, 0, nt - 1)
        fw = rb.atlas.flag_words.numpy()[t]
        bil = (fw >> 22) & 1 == 1
        max_q = ((rb.atlas.n_mips.numpy()[t] - 1) * 4).astype(np.int32)
        q = np.minimum(rng.integers(0, 64, n), max_q)
        q = np.where(bil, q, np.round(q * 0.25) * 4).astype(np.int32)
        lod = (q * 0.25).astype(np.float32)
        flags = ((fw >> 21) & 1 == 1, bil)
        got = sample(rb.atlas, torch.tensor(tid), torch.tensor(uv), torch.tensor(lod),
                     tuple(torch.tensor(f) for f in flags))
        want = jsample(ja, jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(lod), tuple(jnp.asarray(f) for f in flags))
    else:
        lod = rng.uniform(-0.5, 7.0, n).astype(np.float32)
        got = sample(rb.atlas, torch.tensor(tid), torch.tensor(uv), torch.tensor(lod))
        want = jsample(ja, jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(lod))
        base = sample(rb.atlas, torch.tensor(tid), torch.tensor(uv))
        np.testing.assert_allclose(base.numpy(), np.asarray(jsample(ja, jnp.asarray(tid), jnp.asarray(uv))),
                                   atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_bin_triangles_matches_jax():
    """(c) per-tile lists and counts, with 600 triangles over one tile
    (more than L_CAP = 512: the highest indices drop)."""
    import jax.numpy as jnp

    from c_game_engine_tpu.ops.raster_tiles import bin_triangles as jbin
    from c_game_engine_tpu_torch.ops.raster_tiles import L_CAP, bin_triangles

    rng = np.random.default_rng(2)
    h, w, t = 16, 256, 700
    c = np.stack([rng.uniform(-30, w + 30, t), rng.uniform(-10, h + 10, t)], -1)
    c[:600] = rng.uniform([2, 1], [120, 7], (600, 2))  # inside tile (0, 0)
    v = c[:, None, :] + rng.uniform(-6, 6, (t, 3, 2))
    sx, sy = v[..., 0].astype(np.float32), v[..., 1].astype(np.float32)
    ok = rng.random(t) > 0.05
    idx, cnt = bin_triangles(torch.tensor(sx)[None], torch.tensor(sy)[None], torch.tensor(ok)[None], h, w)
    jidx, jcnt = jbin(jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(ok), h, w)
    jidx, jcnt = np.asarray(jidx), np.asarray(jcnt)[..., 0, 0]
    np.testing.assert_array_equal(cnt[0].numpy(), jcnt)
    assert jcnt[0, 0] == L_CAP
    for ty in range(h // 8):
        for tx in range(w // 128):
            k = jcnt[ty, tx]
            np.testing.assert_array_equal(idx[0, ty, tx, :k].numpy(), jidx[ty, tx, :k])


def test_raster_tiles_plain_matches_pallas():
    """(d) K4's plain version against raster_tiles_pallas in interpret
    mode: random triangles, equal-z twins, degenerate and off-frame rows,
    an exclude image and a tile whose count is zeroed (the reveal pass)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from c_game_engine_tpu.ops.raster_tiles import raster_tiles_pallas
    from c_game_engine_tpu_torch.ops.raster_tiles import bin_triangles, raster_tiles, raster_tiles_plain

    h, w = 32, 256
    tri48, sx, sy, ok, excl = k4_inputs(seed=4, height=h, width=w)
    idx, cnt = bin_triangles(torch.tensor(sx), torch.tensor(sy), torch.tensor(ok), h, w)
    cnt[0, 1, 0] = 0
    assert int(cnt.min()) == 0 and int(cnt.max()) > 20
    args = (torch.tensor(tri48), idx, cnt, h, w)
    got = raster_tiles_plain(*args, exclude=torch.tensor(excl))
    for a, b in zip(got, raster_tiles(*args, exclude=torch.tensor(excl))):  # the CPU route
        assert torch.equal(a, b)
    win = got[1].numpy()
    for b in range(tri48.shape[0]):
        with pltpu.force_tpu_interpret_mode():
            want = raster_tiles_pallas(jnp.asarray(tri48[b]), jnp.asarray(idx[b].numpy()),
                                       jnp.asarray(cnt[b].numpy())[..., None, None], h, w,
                                       exclude=jnp.asarray(excl[b]))
        want = [np.asarray(x) for x in want]
        for k, (g, j) in enumerate(zip(got, want)):
            if k in (1, 11):
                np.testing.assert_array_equal(g[b].numpy(), j, err_msg=f"plane {k}")
            else:
                np.testing.assert_allclose(g[b].numpy(), j, atol=1e-6, rtol=0, err_msg=f"plane {k}")
    # the inputs reach what they are built for
    assert (win[0, 8:16, :128] == -1).all()  # the zeroed tile keeps the initial values
    assert ((win >= 0) & (win < tri48.shape[1])).mean() > 0.3
    twins = np.arange(9, tri48.shape[1] - 1, 12)
    assert not np.isin(win[excl == -1], twins).any()  # an equal-z twin never beats its lower row


def test_clip_near_matches_jax():
    """(e) triangles with 0, 1, 2 and 3 vertices behind the near plane."""
    import jax.numpy as jnp

    from c_game_engine_tpu.render.raster import _clip_near as jclip
    from c_game_engine_tpu_torch.render.raster import _clip_near

    rng = np.random.default_rng(5)
    t = 256
    clip = rng.normal(0, 5, (t, 3, 4)).astype(np.float32)
    n_behind = np.arange(t) % 4
    w = rng.uniform(0.02, 30, (t, 3))
    for i in range(t):
        w[i, rng.permutation(3)[: n_behind[i]]] = rng.uniform(-5, 0.009, n_behind[i])
    clip[..., 3] = w
    tri = dict(
        uv=rng.uniform(-2, 2, (t, 3, 2)), lmuv=rng.uniform(0, 1, (t, 3, 2)), color=rng.uniform(0, 1, (t, 3, 4)),
        tex=rng.integers(-1, 9, t), kind=rng.integers(0, 4, t), shaded=rng.random(t) > 0.5,
        valid=rng.random(t) > 0.1, twosided=rng.random(t) > 0.5,
    )
    tri = {k: (v.astype(np.float32) if v.dtype == np.float64 else v.astype(np.int32) if v.dtype == np.int64 else v)
           for k, v in tri.items()}
    jc, jt = jclip(jnp.asarray(clip), {**{k: jnp.asarray(v) for k, v in tri.items()},
                                       "pos": jnp.zeros((t, 3, 3))})
    pc, pt = _clip_near(torch.tensor(clip)[None], {k: torch.tensor(v)[None] for k, v in tri.items()})
    np.testing.assert_allclose(pc[0].numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    for k in tri:
        g, j = pt[k][0].numpy(), np.asarray(jt[k])
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, j, atol=1e-6, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, j, err_msg=k)


def _edge_distance(tris, gx, gy):
    """Distance in pixels from each pixel centre to the nearest edge line of
    its triangle: tris [..., 3, 2] screen vertices per pixel, float64."""
    d = np.full(gx.shape, np.inf)
    for i, j in ((0, 1), (1, 2), (2, 0)):
        a, b = tris[..., i, :], tris[..., j, :]
        e = (b[..., 0] - a[..., 0]) * (gy - a[..., 1]) - (b[..., 1] - a[..., 1]) * (gx - a[..., 0])
        d = np.minimum(d, np.abs(e) / np.maximum(np.hypot(b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]), 1e-30))
    return d


def test_render_batch_matches_jax(lit, monkeypatch):
    """(f) two envs after 30 ticks of the bench stream, 128 x 128, against
    the JAX render_batch on its XLA route, env 1 through the free camera
    0.6 m in front of a coin. Both sides' z passes and pass-1 attributes
    are read (JAX's _pass1_xla and _attrs_from_winner through debug
    callbacks, the port's K4 calls). XLA's CPU code fuses multiply-adds
    (test_xla_cpu_fuses_the_edge_function), so a quantity that lies on a
    boundary may fall to its other side there. Held:
      1. a pixel's winner differs only within 1e-3 px of an edge of each
         side's winner, and on at most 0.2% of pixels;
      2. where the winners agree: the enc word (texture, lod, flags)
         exactly, the screen-door discards alike, uv, lightmap uv, colour
         and depth within 1e-4 of max(1, |x|) (perspective division near
         the camera scales the rounding of the edge functions);
      3. a lightmap texel differs only where the lightmap uv lies within
         1e-3 texel of a texel boundary;
      4. every other pixel of the frame within the 2e-4 of
         tests/test_render.py:145."""
    import jax
    import jax.numpy as jnp

    from c_game_engine_tpu.models.sim import reset_batch as j_reset
    from c_game_engine_tpu.models.sim import rollout as j_rollout
    from c_game_engine_tpu.render import raster as JR
    from c_game_engine_tpu.render.bundle import build_render_bundle
    from c_game_engine_tpu_torch.core.state import state_from_numpy
    from c_game_engine_tpu_torch.ops import raster_tiles as K4
    from c_game_engine_tpu_torch.render.raster import render_batch
    from tests.torch_export_map import compile_arena_lit

    cm, rb = lit
    jc = compile_arena_lit()
    js = jax.jit(lambda s, a: j_rollout(jc, s, a))(j_reset(jc, 2), jax_actions(*_bench_stream(30, 2)))
    # env 1 faces the third coin (the first is picked up on the way): its
    # sprite's alpha-0 texels give the screen-door discard and the reveal
    # pass a few hundred pixels of work
    p = js.player
    eye = np.asarray(js.actors.pos[1, 2]) + [0.0, 0.0, 0.6]
    js = js.replace(player=p.replace(freecam=p.freecam.at[1].set(True), freecam_pos=p.freecam_pos.at[1].set(eye),
                                     yaw=p.yaw.at[1].set(0.0), pitch=p.pitch.at[1].set(0.0)))
    jb = build_render_bundle(jc)

    jz, jattr, traced = [], [], []
    z_pass, attrs = JR._pass1_xla, JR._attrs_from_winner

    def jz_record(sx, sy, sz, tri_ok, gx, gy, height, width, exclude=None):
        win = z_pass(sx, sy, sz, tri_ok, gx, gy, height, width, exclude=exclude)
        ex = jnp.full((height, width), -1, jnp.int32) if exclude is None else exclude
        k = len(traced)  # 0: pass 1, 1: the reveal pass
        traced.append(k)
        jax.debug.callback(lambda *a: jz.append((k, *map(np.asarray, a))), sx, sy, ex, win)
        return win

    def jattr_record(vattr36, enc, winner, gxx, gyy):
        out = attrs(vattr36, enc, winner, gxx, gyy)
        if gxx.shape == (H, W):  # pass 1 (the reveal pass reads packed tiles)
            jax.debug.callback(lambda *a: jattr.append(tuple(map(np.asarray, a))), *out[1:])
        return out

    monkeypatch.setattr(JR, "_pass1_xla", jz_record)
    monkeypatch.setattr(JR, "_attrs_from_winner", jattr_record)
    want = np.asarray(jax.jit(lambda s: JR.render_batch(jb, jc, s, H, W, backend="xla"))(js))
    pk, kernel = [], K4.raster_tiles_binned
    monkeypatch.setattr(K4, "raster_tiles_binned", lambda *a, **k: pk.append((a, k, kernel(*a, **k))) or pk[-1][2])
    got = render_batch(rb, cm, state_from_numpy(jax.tree.map(np.asarray, js), cm), H, W).numpy()
    assert got.shape == want.shape == (2, H, W, 3)
    assert len(pk) == 2 and len(jz) == 4 and len(jattr) == 2

    # one row space on both sides (the soup is under both cull caps); a
    # vmapped callback runs once per env, matched here by its data
    tri48 = pk[0][0][0].numpy().astype(np.float64)
    pxy = tri48[..., :6].reshape(*tri48.shape[:2], 3, 2)
    jwin, jex = np.zeros((2, 2, H, W), np.int64), np.zeros((2, 2, H, W), np.int64)
    jxy = np.zeros((2, *pxy.shape))
    for k, sx, sy, ex, win in jz:
        xy = np.stack([sx, sy], -1).astype(np.float64)
        e = int(np.argmin([np.median(np.abs(xy - q)) for q in pxy]))
        jwin[k, e], jex[k, e], jxy[k, e] = win, ex, xy
    ja = [None, None]
    for a in jattr:
        ja[[np.array_equal(a[0], jwin[0, e]) for e in range(2)].index(True)] = a
    pwin = np.stack([pk[k][2][1].numpy() for k in range(2)])
    pex = pk[1][1]["exclude"].numpy()
    assert (jex[0] == -1).all()
    coin = (pk[0][2][11][1].numpy() & 0xFFF) - 1 == rb.tex_names.index("texture/actor/coin.gtex")
    assert coin.sum() > 100 and (pex[1] >= 0).sum() > 50

    # 1. winners
    gy, gx = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    shows2 = (pex >= 0) | (jex[1] >= 0)  # where the reveal layer is used
    differ = np.stack([pwin[0] != jwin[0], shows2 & (pwin[1] != jwin[1])])
    for k in range(2):
        for e in range(2):
            for win, xy in ((pwin[k, e], pxy[e]), (jwin[k, e], jxy[k, e])):
                d = _edge_distance(xy[np.maximum(win, 0)], gx, gy)
                off = differ[k, e] & (win >= 0) & (d > 1e-3)
                assert not off.any(), f"pass {k + 1}, env {e}: {int(off.sum())} pixels change winner off an edge"
    same = ~differ.any(0)
    assert (~same).mean() <= 0.002

    # 2. pass-1 attributes
    p1 = [x.numpy() for x in pk[0][2]]
    port = dict(uv=np.stack(p1[3:5], -1), lmuv=np.stack(p1[5:7], -1), color=np.stack(p1[7:11], -1), depth=p1[2])
    for e in range(2):
        _, uv, lmuv, color, depth, enc = ja[e]
        m = same[e] & (pwin[0, e] >= 0)
        np.testing.assert_array_equal(p1[11][e][m], enc[m])
        for name, j in (("uv", uv), ("lmuv", lmuv), ("color", color), ("depth", depth)):
            g, j = port[name][e][m], j[m]
            assert (np.abs(g - j) <= 1e-4 * np.maximum(1.0, np.abs(j))).all(), f"env {e} {name}"
    np.testing.assert_array_equal((pex >= 0)[same], (jex[1] >= 0)[same])

    # 3. lightmap texels of the map's shaded pixels
    lh, lw = rb.lightmap.shape[:2]
    scale = np.array([lw, lh])
    lit_px = ((p1[11] >> 12) & 3 == 0) & ((p1[11] >> 14) & 1 == 1) & same
    cells = [np.clip(port["lmuv"] * scale, 0, None), np.stack([np.clip(ja[e][2] * scale, 0, None) for e in range(2)])]
    lm_differ = lit_px & (cells[0].astype(np.int32) != cells[1].astype(np.int32)).any(-1)
    on_line = lambda c: (np.abs(c - np.round(c)) <= 1e-3).any(-1)
    assert (on_line(cells[0]) & on_line(cells[1]))[lm_differ].all()

    # 4. the frame
    err = np.abs(got - want).max(-1)
    held = same & ~lm_differ
    assert err[held].max() <= 2e-4, f"{int((err[held] > 2e-4).sum())} pixels off by more than 2e-4"


def test_xla_cpu_fuses_the_edge_function():
    """The witness for test (f)'s edge pixels: XLA's CPU code evaluates the
    edge function (b-a) x (p-a) of _pass1_xla as one fused multiply-add,
    round(u*v - round(w*x)), where the port's PyTorch ops (and its kernel,
    built with --fmad=false) round both products; the two differ in the
    last bit on a share of random inputs."""
    import jax

    rng = np.random.default_rng(7)
    n = 50_000
    ax, ay, bx, by = rng.uniform(-50, 200, (4, n)).astype(np.float32)
    gx, gy = (rng.integers(0, 128, (2, n)) + 0.5).astype(np.float32)
    edge = lambda ax, ay, bx, by, gx, gy: (bx - ax) * (gy - ay) - (by - ay) * (gx - ax)
    xla = np.asarray(jax.jit(edge)(ax, ay, bx, by, gx, gy))
    port = edge(*map(torch.tensor, (ax, ay, bx, by, gx, gy))).numpy()
    u, v, w, x = bx - ax, gy - ay, by - ay, gx - ax
    fused = (u.astype(np.float64) * v - (w * x).astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(port, u * v - w * x)
    np.testing.assert_array_equal(xla, fused)
    assert (xla != port).mean() > 0.01


def test_reveal_compaction_matches_full_fallback(lit):
    """(g) the tile-compacted reveal shade equals the full-frame fallback
    bit for bit on frames within the tile budget."""
    from c_game_engine_tpu_torch.models.sim import reset_batch
    from c_game_engine_tpu_torch.render import raster as R

    cm, rb = lit
    assert rb.has_alpha
    st = reset_batch(cm, 2)
    st = st.replace(player=st.player.replace(yaw=st.player.yaw + torch.tensor([0.0, 0.3])))
    rgb_cmp, overflow, ctx = R._render_envs(rb, cm, st, H, W, 90.0, True)
    assert ctx is not None and not bool(overflow.any())
    assert bool(ctx["disc1"].any())  # the coin sprites' alpha-0 texels: the reveal pass has work
    full = R._finish_reveal_full(rb, ctx, st, H, W, True)
    assert torch.equal(rgb_cmp, full)
    assert torch.equal(R.render_batch(rb, cm, st, H, W), rgb_cmp)


def test_far_geometry_renders_in_front_of_the_sky(lit, monkeypatch):
    """(h) hazard a: a map triangle 1,500 m ahead draws with z < 1 (below
    the sky's forced 0.999999), not as sky, through the full-f32 camera
    transform (one env, through `render`)."""
    from c_game_engine_tpu_torch.core.state import reset
    from c_game_engine_tpu_torch.ops import raster_tiles as K4
    from c_game_engine_tpu_torch.render.raster import KIND_MAP, render

    cm, rb = lit
    st = reset(cm)
    st = st.replace(player=st.player.replace(yaw=st.player.yaw + np.pi))  # face +z: no actor ahead
    x, y, z = 9.0, 0.7, -2.0 + 1500.0
    tri = np.array([[x - 600, y - 600, z], [x + 600, y - 600, z], [x, y + 600, z]], np.float32)
    pos = torch.tensor(np.stack([tri, tri[[0, 2, 1]]]))  # both windings: one survives the cull
    far = dataclasses.replace(
        rb, map_pos=pos, map_uv=torch.zeros(2, 3, 2), map_lmuv=torch.zeros(2, 3, 2),
        map_tex=rb.map_tex[:2].clone(), map_shaded=torch.ones(2, dtype=torch.bool), live_tri_bound=64)
    seen, kernel = [], K4.raster_tiles_binned
    monkeypatch.setattr(K4, "raster_tiles_binned", lambda *a, **k: seen.append(kernel(*a, **k)) or seen[-1])
    frame = render(far, cm, st, H, W)
    zb, win, enc = seen[0][0][0], seen[0][1][0], seen[0][11][0]
    c = (H // 2, W // 2)
    assert int(win[c]) >= 0 and int((enc[c] >> 12) & 3) == KIND_MAP
    assert 0.999 < float(zb[c]) < 0.999999
    sky_only = dataclasses.replace(far, map_pos=pos[:0], map_uv=far.map_uv[:0], map_lmuv=far.map_lmuv[:0],
                                   map_tex=far.map_tex[:0], map_shaded=far.map_shaded[:0])
    assert not torch.equal(frame[c], render(sky_only, cm, st, H, W)[c])


def test_gather_triangles_model_branch_matches_jax(lit):
    """(i) the actor-model rows of the soup: a 2-LOD, 2-skin, 2-slot model
    pool put on the first coin (arena_lit has no model actor), one env
    near the actor (LOD 0) and one far (LOD 1), against the JAX
    gather_triangles. Positions within 1e-5 (tens of metres in float32),
    everything else exact or within 1e-6."""
    import jax
    import jax.numpy as jnp

    from c_game_engine_tpu.core.state import reset as j_reset
    from c_game_engine_tpu.render import raster as JR
    from c_game_engine_tpu.render.bundle import build_render_bundle
    from c_game_engine_tpu_torch.core.state import state_from_numpy
    from c_game_engine_tpu_torch.render import raster as R
    from c_game_engine_tpu_torch.render.bundle import soup_rows
    from tests.torch_export_map import compile_arena_lit

    cm, rb = lit
    rng = np.random.default_rng(6)
    tp = 6  # LOD 0: rows 0-3, LOD 1: rows 4-5
    pool = dict(
        mdl_pos=rng.uniform(-0.5, 0.5, (tp, 3, 3)), mdl_uv=rng.uniform(0, 1, (tp, 3, 2)),
        mdl_color=rng.uniform(0.2, 1, (tp, 3, 4)), mdl_slot=np.array([0, 1, 0, 1, 0, 1]),
        mdl_lod=np.array([0, 0, 0, 0, 1, 1]), mdl_range=np.array([[0, tp]]),
        mdl_lod_dist_sq=np.array([[0.0, 4.0, np.inf, np.inf]]),
        mdl_skin_tex=rng.integers(-1, len(rb.tex_names), (1, 8, 8)),
        mdl_skin_color=rng.uniform(0.2, 1, (1, 8, 8, 4)), mdl_skin_shaded=rng.random((1, 8, 8)) > 0.5,
    )
    pool = {k: v.astype(np.float32) if v.dtype == np.float64 else v.astype(np.int32) if v.dtype == np.int64 else v
            for k, v in pool.items()}
    model_id = np.full(cm.num_actors, -1, np.int32)
    model_id[0] = 0
    jc = compile_arena_lit()
    jb = build_render_bundle(jc).replace(**{k: jnp.asarray(v) for k, v in pool.items()})
    jc = jc.replace(model_id=jnp.asarray(model_id))
    pc = cm.replace(model_id=torch.tensor(model_id))
    pb = dataclasses.replace(rb, **{k: torch.tensor(v) for k, v in pool.items()}, **soup_rows(pool["mdl_range"], pc))
    js = j_reset(jc)
    js = js.replace(actors=js.actors.replace(skin=js.actors.skin.at[0].set(1)))
    cams = np.stack([np.asarray(js.actors.pos[0]) + [0.5, 0.3, 0.0], np.asarray(js.actors.pos[0]) + [4.0, 0.3, 0.0]])
    ps = state_from_numpy(jax.tree.map(lambda x: np.stack([np.asarray(x)] * 2), js), pc)
    got = R._concat_parts(R.gather_triangles(pb, pc, ps, camera_pos_hint=torch.tensor(cams, dtype=torch.float32)))
    for e in range(2):
        want = JR._concat_parts(JR.gather_triangles(jb, jc, js, camera_pos_hint=jnp.asarray(cams[e], jnp.float32)))
        for k, w in want.items():
            g, w = got[k][e].numpy(), np.asarray(w)
            if g.dtype.kind == "f":
                np.testing.assert_allclose(g, w, atol=1e-5 if k == "pos" else 1e-6, rtol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)
    model_rows = got["kind"][0] == R.KIND_MODEL
    assert int(model_rows.sum()) == tp
    assert got["valid"][0][model_rows].tolist() == [True] * 4 + [False] * 2  # near: LOD 0
    assert got["valid"][1][model_rows].tolist() == [False] * 4 + [True] * 2  # far: LOD 1


@pytest.mark.parametrize("case", ["beyond_k4_table", "not_whole_tiles", "xla", "pallas_big_not_whole_tiles",
                                  "ssaa", "aniso", "debug_wireframe", "unknown_backend"])
def test_unported_routes_raise(lit, case):
    """What the port does not serve raises, naming what is missing: a frame
    that is not whole 8 x 128 tiles (the JAX package's XLA pass 1, not
    ported), on the tile route, on the big route that a bundle beyond
    65,536 live triangles takes (K5; tests/test_torch_render_big.py renders
    that route) and on the big route forced with backend "pallas_big";
    backend "xla"; ssaa > 1; aniso > 1 with mipmaps; debug_wireframe=True;
    an unknown backend is a ValueError."""
    from c_game_engine_tpu_torch.models.sim import reset_batch
    from c_game_engine_tpu_torch.render.raster import render, render_batch

    cm, rb = lit
    st = reset_batch(cm, 1)
    bundle = dataclasses.replace(rb, live_tri_bound=65537) if case == "beyond_k4_table" else rb
    calls = {
        "beyond_k4_table": (lambda: render_batch(bundle, cm, st, 100, 128), NotImplementedError, "_pass1_xla"),
        "not_whole_tiles": (lambda: render_batch(bundle, cm, st, 100, 128), NotImplementedError, "_pass1_xla"),
        "pallas_big_not_whole_tiles": (lambda: render_batch(rb, cm, st, 128, 100, 90.0, "pallas_big"),
                                       NotImplementedError, "_pass1_xla"),
        "xla": (lambda: render_batch(rb, cm, st, H, W, backend="xla"), NotImplementedError, "_pass1_xla"),
        "ssaa": (lambda: render(rb, cm, st, H, W, 90.0, None, True, 2), NotImplementedError, "supersampling"),
        "aniso": (lambda: render_batch(rb, cm, st, H, W, aniso=4), NotImplementedError, "aniso_uv"),
        "debug_wireframe": (lambda: render_batch(rb, cm, st, H, W, debug_wireframe=True), NotImplementedError,
                            "debug_draw"),
        "unknown_backend": (lambda: render_batch(rb, cm, st, H, W, backend="cuda"), ValueError, "backend"),
    }
    fn, exc, match = calls[case]
    with pytest.raises(exc, match=match):
        fn()


def test_render_takes_the_jax_signature(lit, monkeypatch):
    """render and render_batch take the JAX parameters in the JAX order
    (fov_deg, backend, mipmaps, ssaa, aniso, debug_wireframe): a call
    written for the JAX package renders the frame of the keyword call;
    backend "pallas_big" forces the big route (two K5 calls: pass 1 and
    the reveal) and "pallas" and "auto" keep arena_lit on the tile route;
    aniso 1, and aniso 4 without mipmaps, sample as aniso 0 does, as in
    the JAX package."""
    from c_game_engine_tpu_torch.core.state import tree_map
    from c_game_engine_tpu_torch.models.sim import reset_batch
    from c_game_engine_tpu_torch.ops import raster_tiles_big as K5
    from c_game_engine_tpu_torch.render.raster import render, render_batch

    cm, rb = lit
    st = reset_batch(cm, 1)
    st = st.replace(player=st.player.replace(yaw=st.player.yaw + 0.3))
    seen, kernel = [], K5.raster_tiles_big
    monkeypatch.setattr(K5, "raster_tiles_big", lambda *a, **k: seen.append(1) or kernel(*a, **k))
    want = render_batch(rb, cm, st, H, W, fov_deg=80.0, mipmaps=False)
    assert torch.equal(render_batch(rb, cm, st, H, W, 80.0, None, False), want)
    assert torch.equal(render_batch(rb, cm, st, H, W, 80.0, "pallas", False, 1, 4, False), want)
    one = tree_map(lambda x: x[0], st)
    assert torch.equal(render(rb, cm, one, H, W, 80.0, "auto", False), want[0])
    base = render_batch(rb, cm, st, H, W)
    assert torch.equal(render_batch(rb, cm, st, H, W, 90.0, None, True, 1, 1), base)
    assert not seen
    big = render_batch(rb, cm, st, H, W, 90.0, "pallas_big")
    assert len(seen) == 2
    assert float((big - base).abs().amax(-1).gt(1 / 255).float().mean()) <= 0.002
