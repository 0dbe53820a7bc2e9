"""The port's big-table render route against the JAX package on the CPU:
`level_bboxes`, kernel K5's plain version (against the Pallas kernel in
interpret mode, and against a numpy brute force), `_clip_near_compact`,
`_attrs_from_winner`, the route as a whole on arena_lit (forced onto it
with a live-triangle bound above 65,536) against the JAX XLA route and
against the port's own tile route, and the arena_orb map (82,568 live
triangles) against the JAX XLA route, from a far view and from a camera
whose near plane cuts the sphere. Inputs are made from numpy seeds; the
port reads the committed map files (tests/torch_export_map.py).

Tolerances: K5's winner ids exactly and its z within 1e-6 of the Pallas
kernel (XLA may fuse a multiply-add there), exactly against the float32
numpy brute force, which rounds as the plain version does; `_clip_near_compact` and
`_attrs_from_winner` within 1e-6 and 1e-5 (the latter's barycentrics
divide by the triangle's area). Frames are held as
tests/test_torch_render.py's test (f) holds them (see `_hold_to_jax`).
The big route puts a clipped triangle's pieces in rows of their own
(T + 2 CLIP_CAP rows, the JAX XLA route's `_clip_near` 2T), so winners are
matched by their screen vertices and enc word, not by row id.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_render import _bench_stream
from tests.torch_frames import edge_distance
from tests.torch_inputs import k5_inputs
from tests.torch_parity import jax_actions

H = W = 128


@pytest.fixture(scope="module")
def lit():
    from c_game_engine_tpu_torch.render.bundle import load_render_map

    return load_render_map("arena_lit", "cpu")


@pytest.fixture(scope="module")
def orb():
    from c_game_engine_tpu_torch.render.bundle import load_render_map

    return load_render_map("arena_orb", "cpu")


def _levels(trit):
    from c_game_engine_tpu_torch.ops.raster_tiles_big import SUB, T_CHK, level_bboxes

    bb = [trit[:, k] for k in (10, 11, 12, 13)]
    return level_bboxes(*bb, T_CHK), level_bboxes(*bb, SUB)


def test_level_bboxes_matches_jax():
    """(a) chunk and subchunk unions of random boxes with dead rows (and
    whole dead groups), exactly."""
    import jax.numpy as jnp

    from c_game_engine_tpu.ops.raster_tiles_big import level_bboxes as jlevel
    from c_game_engine_tpu_torch.ops.raster_tiles_big import SUB, T_CHK, level_bboxes

    rng = np.random.default_rng(0)
    b, t = 2, 2 * T_CHK
    lo = rng.uniform(-50, 300, (4, b, t)).astype(np.float32)
    box = np.stack([lo[0], lo[0] + rng.uniform(0, 40, (b, t)), lo[1], lo[1] + rng.uniform(0, 40, (b, t))])
    live = rng.random((b, t)) < 0.3
    live[:, 640:768] = False  # two whole dead subchunks
    box = np.where(live, box, np.array([1e30, -1e30, 1e30, -1e30], np.float32)[:, None, None]).astype(np.float32)
    for group in (T_CHK, SUB):
        got = level_bboxes(*torch.tensor(box), group).numpy()
        for e in range(b):
            want = np.asarray(jlevel(*(jnp.asarray(x[e]) for x in box), group))
            np.testing.assert_array_equal(got[e], want)
    scb = level_bboxes(*torch.tensor(box), SUB).numpy()
    assert (scb[:, 10:12, 0] > scb[:, 10:12, 1]).all()  # a dead group overlaps nothing


def test_raster_tiles_big_plain_matches_pallas():
    """(b) K5's plain version against raster_tiles_big in interpret mode:
    one call, one chunk of 4096 rows, an 8 x 128 frame, with sparse live
    rows (whole subchunks dead), an equal-z twin after every tenth live
    row, degenerate and off-frame rows and an exclude image."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from c_game_engine_tpu.ops.raster_tiles_big import raster_tiles_big as jk5
    from c_game_engine_tpu_torch.ops.raster_tiles_big import raster_tiles_big, raster_tiles_big_plain

    trit, excl = k5_inputs(seed=3)
    cbox, scb = _levels(torch.tensor(trit))
    args = (torch.tensor(trit), cbox, scb, 8, 128)
    z, win = raster_tiles_big_plain(*args, exclude=torch.tensor(excl))
    for a, b in zip((z, win), raster_tiles_big(*args, exclude=torch.tensor(excl))):  # the CPU route
        assert torch.equal(a, b)
    with pltpu.force_tpu_interpret_mode():
        jz, jwin = jk5(jnp.asarray(trit[0]), jnp.asarray(cbox[0].numpy()), jnp.asarray(scb[0].numpy()), 8, 128,
                       exclude=jnp.asarray(excl[0]))
    jz, jwin = np.asarray(jz), np.asarray(jwin)
    np.testing.assert_array_equal(win[0].numpy(), jwin)
    np.testing.assert_array_equal(np.isinf(z[0].numpy()), np.isinf(jz))
    fin = np.isfinite(jz)
    np.testing.assert_allclose(z[0].numpy()[fin], jz[fin], atol=1e-6, rtol=0)
    # the inputs reach what they are built for
    w = win[0].numpy()
    assert (w >= 0).mean() > 0.3
    hit = (scb[0, :, 0] <= 128) & (scb[0, :, 1] >= 0) & (scb[0, :, 2] <= 8) & (scb[0, :, 3] >= 0)
    assert 0 < int(hit.sum()) < scb.shape[1]  # some subchunks skip
    live = np.nonzero(trit[0, 10] <= trit[0, 11])[0]
    twins = [k + 1 for k in live[16:-1:10]]
    assert not np.isin(w[excl[0] == -1], twins).any()  # an equal-z twin never beats its lower row
    assert (w[excl[0] >= 0] != excl[0][excl[0] >= 0]).all()


def _brute_force(trit, exclude, tile_on, height, width):
    """numpy float32 z-buffer over every live row, in row order."""
    gx, gy = (g.astype(np.float32) for g in np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5))
    gate = np.repeat(np.repeat(tile_on.reshape(height // 8, width // 128), 8, 0), 128, 1) != 0
    zbuf = np.full((height, width), np.inf, np.float32)
    win = np.full((height, width), -1, np.int32)
    for i in np.nonzero(trit[10] <= trit[11])[0]:
        ax, ay, bx, by, cx, cy, z0, z1, z2 = trit[:9, i]
        e0 = (bx - ax) * (gy - ay) - (by - ay) * (gx - ax)
        e1 = (cx - bx) * (gy - by) - (cy - by) * (gx - bx)
        e2 = (ax - cx) * (gy - cy) - (ay - cy) * (gx - cx)
        inside = ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)) | ((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
        den = e0 + e1 + e2
        den = np.where(np.abs(den) > 1e-9, den, np.float32(1e-9))
        z = (e1 * z0 + e2 * z1 + e0 * z2) / den
        closer = gate & inside & (z > 0) & (z < 1) & (z < zbuf) & (i != exclude)
        zbuf = np.where(closer, z, zbuf)
        win = np.where(closer, i, win)
    return zbuf, win


@pytest.mark.parametrize("kind", ["random", "subpixel"])
def test_raster_tiles_big_plain_matches_brute_force(kind):
    """(c) two chunks and two envs, a gated tile (it keeps the initial
    values) and an exclude image: the plain version and the CPU route
    equal a numpy float32 brute force bit for bit. "random": 32 x 128, the
    random table of k5_inputs; "subpixel": 8 x 256, sub-pixel triangles
    clustered in each tile column, equal-z twins among them, and hit
    subchunks interleaved with dead ones and with the other column's in
    both chunks (k5_inputs(kind="subpixel"))."""
    from c_game_engine_tpu_torch.ops.raster_tiles_big import T_CHK, raster_tiles_big, raster_tiles_big_plain

    h, w, seed, gated = (32, 128, 4, (1, 2)) if kind == "random" else (8, 256, 5, (1, 1))
    trit, excl = k5_inputs(seed=seed, batch=2, height=h, width=w, t=2 * T_CHK, kind=kind)
    tile_on = np.ones((2, (h // 8) * (w // 128)), np.int32)
    tile_on[gated] = 0
    cbox, scb = _levels(torch.tensor(trit))
    args = (torch.tensor(trit), cbox, scb, h, w)
    kw = dict(exclude=torch.tensor(excl), tile_on=torch.tensor(tile_on))
    z, win = raster_tiles_big_plain(*args, **kw)
    for a, b in zip((z, win), raster_tiles_big(*args, **kw)):
        assert torch.equal(a, b)
    for e in range(2):
        zref, wref = _brute_force(trit[e], excl[e], tile_on[e], h, w)
        np.testing.assert_array_equal(win[e].numpy(), wref)
        np.testing.assert_array_equal(z[e].numpy(), zref)
    if kind == "random":
        assert (win[1, 16:24].numpy() == -1).all() and torch.isinf(z[1, 16:24]).all()
        assert (win[0, 16:24].numpy() >= T_CHK).any()  # the second chunk wins pixels
        assert (win.numpy() >= 0).mean() > 0.3
        return
    wn = win.numpy()
    assert (wn[1, :, 128:] == -1).all() and torch.isinf(z[1, :, 128:]).all()
    for col in (wn[:, :, 4:60], wn[0, :, 132:188]):  # the clusters: both chunks win pixels
        assert (col >= 0).mean() > 0.4 and (col >= T_CHK).any() and ((col >= 0) & (col < T_CHK)).any()
    sub = wn // 64 % 3
    assert ((sub[:, :, :128] == 0) | (wn[:, :, :128] < 0)).all()  # column 0 is won by its own rows only
    assert len(np.unique(wn[wn >= 0])) > 500  # hundreds of sub-pixel winners
    assert (wn[excl >= 0] >= 0).mean() > 0.3  # an excluded pixel can still be won


def test_clip_near_compact_matches_jax():
    """(d) more near-plane-crossing rows than `cap`: the crossing rows of
    lowest id take the slots in order and the rest drop, as in JAX; rows
    wholly in front keep their row; two envs with their own rows."""
    import jax.numpy as jnp

    from c_game_engine_tpu.render.raster import _clip_near_compact as jcompact
    from c_game_engine_tpu_torch.render.raster import _clip_near_compact

    rng = np.random.default_rng(5)
    b, t, cap = 2, 256, 40
    clip = rng.normal(0, 5, (b, t, 3, 4)).astype(np.float32)
    w = rng.uniform(0.02, 30, (b, t, 3))
    n_behind = rng.integers(0, 4, (b, t))
    for e in range(b):
        for i in range(t):
            w[e, i, rng.permutation(3)[: n_behind[e, i]]] = rng.uniform(-5, 0.009, n_behind[e, i])
    clip[..., 3] = w
    tri = dict(
        uv=rng.uniform(-2, 2, (b, t, 3, 2)), lmuv=rng.uniform(0, 1, (b, t, 3, 2)),
        color=rng.uniform(0, 1, (b, t, 3, 4)), tex=rng.integers(-1, 9, (b, t)), kind=rng.integers(0, 4, (b, t)),
        shaded=rng.random((b, t)) > 0.5, valid=rng.random((b, t)) > 0.1, twosided=rng.random((b, t)) > 0.5,
    )
    tri = {k: (v.astype(np.float32) if v.dtype == np.float64 else v.astype(np.int32) if v.dtype == np.int64 else v)
           for k, v in tri.items()}
    pc, pt = _clip_near_compact(torch.tensor(clip), {k: torch.tensor(v) for k, v in tri.items()}, cap)
    assert pc.shape == (b, t + 2 * cap, 3, 4)
    for e in range(b):
        crossing = tri["valid"][e] & (n_behind[e] > 0) & (n_behind[e] < 3)
        assert crossing.sum() > cap
        jc, jt = jcompact(jnp.asarray(clip[e]), {**{k: jnp.asarray(v[e]) for k, v in tri.items()},
                                                "pos": jnp.zeros((t, 3, 3))}, cap)
        np.testing.assert_allclose(pc[e].numpy(), np.asarray(jc), atol=1e-6, rtol=0)
        for k in tri:
            g, j = pt[k][e].numpy(), np.asarray(jt[k])
            if g.dtype.kind == "f":
                np.testing.assert_allclose(g, j, atol=1e-6, rtol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(g, j, err_msg=k)
        # the extension's first pieces are the lowest crossing rows, in order
        first = np.nonzero(crossing)[0][:cap]
        np.testing.assert_array_equal(pt["tex"][e, t:t + cap].numpy(), tri["tex"][e][first])
        assert pt["valid"][e, :t].numpy().sum() == (tri["valid"][e] & (n_behind[e] == 0)).sum()


def test_attrs_from_winner_matches_jax():
    """(e) the per-pixel gather and perspective-correct interpolation on a
    winner image with -1 pixels (each pixel's winner a random triangle that
    covers it), at full frame and on packed tiles (every other tile of a
    32 x 256 frame), two envs."""
    import jax.numpy as jnp

    from c_game_engine_tpu.render.raster import _attrs_from_winner as jattrs
    from c_game_engine_tpu_torch.render.raster import _attrs_from_winner, _pixel_grid, _tile_pack

    rng = np.random.default_rng(6)
    b, t, h, w = 2, 48, 32, 256
    gx, gy = (g.numpy() for g in _pixel_grid(h, w, "cpu"))
    vattr = np.zeros((b, t, 3, 12), np.float32)
    win = np.full((b, h, w), -1, np.int32)
    for e in range(b):
        c = np.stack([rng.uniform(0, w, t), rng.uniform(0, h, t)], -1)
        ang = rng.uniform(0, 2 * np.pi, (t, 1)) + np.arange(3) * (2 * np.pi / 3) + rng.uniform(-0.4, 0.4, (t, 3))
        v = c[:, None, :] + rng.uniform(10, 40, (t, 1, 1)) * np.stack([np.cos(ang), np.sin(ang)], -1)
        vattr[e, :, :, 0:2] = v
        vattr[e, :, :, 2] = rng.uniform(0.2, 2.0, (t, 3))
        vattr[e, :, :, 3:12] = rng.uniform(-1.5, 2.5, (t, 3, 9))
        for i in rng.permutation(t):  # a covering triangle per pixel, -1 where none
            e_ = [(v[i, j, 0] - v[i, k, 0]) * (gy - v[i, k, 1]) - (v[i, j, 1] - v[i, k, 1]) * (gx - v[i, k, 0])
                  for k, j in ((0, 1), (1, 2), (2, 0))]
            inside = np.all([x <= 0 for x in e_], 0) | np.all([x >= 0 for x in e_], 0)
            win[e][inside & (rng.random((h, w)) < 0.5)] = i
    vattr36 = vattr.reshape(b, t, 36)
    enc = rng.integers(0, 1 << 23, (b, t)).astype(np.int32)
    assert 0.2 < (win >= 0).mean() < 0.95
    nty, ntx = h // 8, w // 128
    order = torch.arange(0, nty * ntx, 2).expand(b, -1)
    pk = lambda a: _tile_pack(a, order, nty, ntx)
    full = (torch.tensor(win), torch.tensor(gx).expand(b, h, w), torch.tensor(gy).expand(b, h, w))
    for wimg, gxx, gyy in (full, tuple(pk(a) for a in full)):
        got = _attrs_from_winner(torch.tensor(vattr36), torch.tensor(enc), wimg, gxx, gyy)
        for e in range(b):
            want = jattrs(jnp.asarray(vattr36[e]), jnp.asarray(enc[e]), jnp.asarray(wimg[e].numpy()),
                          jnp.asarray(gxx[e].numpy()), jnp.asarray(gyy[e].numpy()))
            for k, (g, j) in enumerate(zip(got, want)):
                g, j = g[e].numpy(), np.asarray(j)
                if g.dtype.kind == "f":
                    np.testing.assert_allclose(g, j, atol=1e-5, rtol=1e-5, err_msg=f"output {k}")
                else:
                    np.testing.assert_array_equal(g, j, err_msg=f"output {k}")


def _port_frame(rb, cm, st):
    """The port's render_batch with its K5 calls, its pass-1 attribute
    gather and the soup's row count (the near-plane clip's input) recorded:
    (frame, [(args, kwargs, (z, winner))], (args, out), rows)."""
    from c_game_engine_tpu_torch.ops import raster_tiles_big as K5
    from c_game_engine_tpu_torch.render import raster as R

    calls, attrs, rows = [], [], []
    kernel, gather, clipper = K5.raster_tiles_big, R._attrs_from_winner, R._clip_near_compact
    with pytest.MonkeyPatch.context() as m:
        m.setattr(K5, "raster_tiles_big", lambda *a, **k: calls.append((a, k, kernel(*a, **k))) or calls[-1][2])
        m.setattr(R, "_attrs_from_winner", lambda *a: attrs.append((a, gather(*a))) or attrs[-1][1])
        m.setattr(R, "_clip_near_compact", lambda clip, *a: rows.append(clip.shape[1]) or clipper(clip, *a))
        frame = R.render_batch(rb, cm, st, H, W).numpy()
    full = [x for x in attrs if x[0][2].shape == x[0][3].shape and x[0][2].shape[1:] == (H, W)]
    return frame, calls, full[0], rows[0]


def _jax_frame(jb, jc, js):
    """The JAX render_batch on its XLA route, with both z passes
    (_pass1_xla) and the pass-1 attributes (_attrs_from_winner) of every
    env recorded through debug callbacks: (frame, [(pass, sx, sy,
    exclude, winner)], [(enc table, *attribute outputs)]). A vmapped
    callback runs once per env, in no set order."""
    import jax
    import jax.numpy as jnp

    from c_game_engine_tpu.render import raster as JR

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
            jax.debug.callback(lambda *a: jattr.append(tuple(map(np.asarray, a))), enc, *out[1:])
        return out

    with pytest.MonkeyPatch.context() as m:
        m.setattr(JR, "_pass1_xla", jz_record)
        m.setattr(JR, "_attrs_from_winner", jattr_record)
        frame = np.asarray(jax.jit(lambda s: JR.render_batch(jb, jc, s, H, W, backend="xla"))(js))
    return frame, jz, jattr


def _scale(v):
    """A triangle's coordinate scale max(1, |x|) over its vertices: [..., 3, 2] -> [...]."""
    return np.maximum(1.0, np.abs(v).max((-1, -2)))


def _same_tri(win_a, xy_a, enc_a, win_b, xy_b, enc_b):
    """Per pixel: both sides have no winner, or winners with the same enc
    word and screen vertices within 1e-4 of the triangle's scale."""
    va, vb = xy_a[np.maximum(win_a, 0)], xy_b[np.maximum(win_b, 0)]
    close = np.abs(va - vb).max((-1, -2)) <= 1e-4 * _scale(vb)
    hit = (win_a >= 0) & (win_b >= 0) & close & (enc_a[np.maximum(win_a, 0)] == enc_b[np.maximum(win_b, 0)])
    return ((win_a < 0) & (win_b < 0)) | hit


def _explained(px, wins, xys):
    """Whether a pixel whose winner differs lies on a boundary both sides
    draw alike: within tol px of an edge of one side's winner X as each
    side places X (X's counterpart on the other side: the row whose
    vertices are nearest, within 1e-3 of X's scale), with tol the larger
    of 1e-3 px and twice X's largest vertex discrepancy between the sides
    (the clipped pieces' vertices differ by rounding, see
    test_xla_cpu_fuses_the_near_plane_intersection). This covers a winner
    that flips to a neighbour across a shared edge and one that covers the
    pixel on one side only."""
    gx, gy = px[1] + 0.5, px[0] + 0.5
    for side in range(2):
        w = wins[side]
        if w < 0:
            continue
        tri, other = xys[side][w], xys[1 - side]
        dev = np.abs(other - tri).max((-1, -2))
        r = int(np.argmin(dev))
        if dev[r] > 1e-3 * _scale(tri):
            continue
        tol = max(1e-3, 2.0 * float(dev[r]))
        if all(edge_distance(t, np.float64(gx), np.float64(gy)) <= tol for t in (tri, other[r])):
            return True
    return False


def _hold_to_jax(rb, port, jax_out, label):
    """Test (f)'s four criteria (tests/test_torch_render.py), with winners
    matched by screen vertices and enc word:
      1. a pixel's winner differs only on a boundary both sides draw alike
         (`_explained`), and on at most 0.2% of pixels;
      2. where the winners agree: the screen-door discards alike, uv,
         lightmap uv, colour and depth within 1e-4 of max(1, |x|);
      3. a lightmap texel differs only where the lightmap uv lies within
         1e-3 texel of a texel boundary;
      4. every other pixel of the frame within 2e-4.
    A pixel whose winner is a near-plane clipped piece (a row of the
    port's extension) is held in 2 and 4 to 2e-3 of max(1, |x|) and to
    1/255: the piece's new vertices sit at w = 0.01, where the
    intersection a + (b - a) t cancels all but about 4 digits of w, and
    XLA's CPU code fuses it into one multiply-add where the port rounds the
    product (test_xla_cpu_fuses_the_near_plane_intersection), so 1/w and
    the perspective-correct attributes differ by about 1e-4 relative and
    their enc word's lod quarter can flip.
    The JAX frame may hold more envs than the port's (`want` is then cut
    to the port's envs); their callbacks are matched by data. Returns the
    port's pass-1 winner image and the soup's row count (the extension
    rows follow)."""
    got, calls, (pargs, pout), t_soup = port
    want, jz, jattr = jax_out
    b = got.shape[0]
    assert got.shape == want.shape == (b, H, W, 3)
    assert len(calls) == 2, label
    trit = calls[0][0][0].numpy().astype(np.float64)
    pxy = trit[:, :6].transpose(0, 2, 1).reshape(b, -1, 3, 2)  # [B, T, 3, 2]
    penc = pargs[1].numpy()
    pwin = np.stack([calls[k][2][1].numpy() for k in range(2)])
    pex = calls[1][1]["exclude"].numpy()

    # match the callbacks to the port's envs by data (the rows wholly in
    # front of the near plane keep their row on both routes); a JAX env
    # the port did not render matches none
    jwin, jex = np.zeros((2, b, H, W), np.int64), np.zeros((2, b, H, W), np.int64)
    jxy = [[None] * b for _ in range(2)]
    for k, sx, sy, ex, win in jz:
        xy = np.stack([sx, sy], -1).astype(np.float64)
        n = min(len(xy), pxy.shape[1])
        d = [np.median(np.abs(xy[:n] - q[:n])) for q in pxy]
        e = int(np.argmin(d))
        if d[e] < 0.5:
            assert jxy[k][e] is None
            jwin[k, e], jex[k, e], jxy[k][e] = win, ex, xy
    assert all(x is not None for row in jxy for x in row), label
    ja = [None] * b
    for a in jattr:
        hit = [np.array_equal(a[1], jwin[0, e]) for e in range(b)]
        if any(hit):
            ja[hit.index(True)] = a
    assert all(a is not None for a in ja) and (jex[0] == -1).all(), label

    # 1. winners
    shows2 = (pex >= 0) | (jex[1] >= 0)  # where the reveal layer is used
    differ = np.zeros((2, b, H, W), bool)
    for k in range(2):
        for e in range(b):
            same = _same_tri(pwin[k, e], pxy[e], penc[e], jwin[k, e], jxy[k][e], ja[e][0])
            differ[k, e] = ~same if k == 0 else shows2[e] & ~same
            for y, x in zip(*np.nonzero(differ[k, e])):
                assert _explained((y, x), (pwin[k, e, y, x], jwin[k, e, y, x]), (pxy[e], jxy[k][e])), \
                    f"{label} pass {k + 1}, env {e}: pixel {(y, x)} changes winner off a boundary"
    same = ~differ.any(0)
    assert (~same).mean() <= 0.002, f"{label}: {(~same).mean():.4%} of pixels change winner"
    piece = pwin[0] >= t_soup  # the pass-1 winner is a clipped piece

    # 2. pass-1 attributes
    _, uv, lmuv, color, depth, _ = (x.numpy() for x in pout[1:])
    port = dict(uv=uv, lmuv=lmuv, color=color, depth=depth)
    for e in range(b):
        _, _, juv, jlmuv, jcolor, jdepth, _ = ja[e]
        for name, j in (("uv", juv), ("lmuv", jlmuv), ("color", jcolor), ("depth", jdepth)):
            for rel, where in ((1e-4, ~piece[e]), (2e-3, piece[e])):
                m = same[e] & (pwin[0, e] >= 0) & where
                g, jj = port[name][e][m], j[m]
                assert (np.abs(g - jj) <= rel * np.maximum(1.0, np.abs(jj))).all(), f"{label} env {e} {name}"
    np.testing.assert_array_equal((pex >= 0)[same], (jex[1] >= 0)[same])

    # 3. lightmap texels of the map's shaded pixels
    lh, lw = rb.lightmap.shape[:2]
    scale = np.array([lw, lh])
    penc_pix = pout[6].numpy()
    lit_px = ((penc_pix >> 12) & 3 == 0) & ((penc_pix >> 14) & 1 == 1) & same
    cells = [np.clip(lmuv * scale, 0, None), np.stack([np.clip(ja[e][3] * scale, 0, None) for e in range(b)])]
    lm_differ = lit_px & (cells[0].astype(np.int32) != cells[1].astype(np.int32)).any(-1)
    on_line = lambda c: (np.abs(c - np.round(c)) <= 1e-3).any(-1)
    assert (on_line(cells[0]) & on_line(cells[1]))[lm_differ].all(), label

    # 4. the frame
    err = np.abs(got - want).max(-1)
    held = same & ~lm_differ
    for bar, where in ((2e-4, ~piece), (1 / 255, piece)):
        m = held & where
        assert not m.any() or err[m].max() <= bar, f"{label}: {int((err[m] > bar).sum())} pixels off by more than {bar}"
    return pwin[0], t_soup


def test_xla_cpu_fuses_the_near_plane_intersection():
    """The witness for `_hold_to_jax`'s clipped pieces: XLA's CPU code
    evaluates _clip_near's intersection wa + (wb - wa) t as one fused
    multiply-add where the port rounds the product first; at the near
    plane (w = 0.01, with |wa|, |wb| up to tens of metres) the two w
    differ by up to about 1e-4 of w."""
    import jax

    rng = np.random.default_rng(8)
    n = 50_000
    wa = -rng.uniform(0.5, 20.0, n).astype(np.float32)
    wb = rng.uniform(0.5, 20.0, n).astype(np.float32)
    tt = ((np.float32(0.01) - wa) / (wb - wa)).astype(np.float32)
    isect = lambda a, b, t: a + (b - a) * t
    xla = np.asarray(jax.jit(isect)(wa, wb, tt))
    port = isect(*map(torch.tensor, (wa, wb, tt))).numpy()
    fused = (wa.astype(np.float64) + (wb - wa).astype(np.float64) * tt).astype(np.float32)
    np.testing.assert_array_equal(port, wa + (wb - wa) * tt)
    np.testing.assert_array_equal(xla, fused)
    rel = np.abs(xla - port) / 0.01
    assert (xla != port).mean() > 0.1 and 1e-5 < rel.max() < 3e-4


def test_big_route_on_arena_lit_matches_jax(lit):
    """(f) the route as a whole: arena_lit with its live-triangle bound
    raised past 65,536 on the port side, two envs after 30 ticks of the
    bench stream, 128 x 128, env 1 through the free camera 0.6 m from a
    coin (sprite alpha, so the reveal pass has work), against the JAX
    render_batch on its XLA route."""
    import jax

    from c_game_engine_tpu.models.sim import reset_batch as j_reset
    from c_game_engine_tpu.models.sim import rollout as j_rollout
    from c_game_engine_tpu.render.bundle import build_render_bundle
    from c_game_engine_tpu_torch.core.state import state_from_numpy
    from tests.torch_export_map import compile_arena_lit

    cm, rb = lit
    jc = compile_arena_lit()
    js = jax.jit(lambda s, a: j_rollout(jc, s, a))(j_reset(jc, 2), jax_actions(*_bench_stream(30, 2)))
    p = js.player
    eye = np.asarray(js.actors.pos[1, 2]) + [0.0, 0.0, 0.6]
    js = js.replace(player=p.replace(freecam=p.freecam.at[1].set(True), freecam_pos=p.freecam_pos.at[1].set(eye),
                                     yaw=p.yaw.at[1].set(0.0), pitch=p.pitch.at[1].set(0.0)))
    big = dataclasses.replace(rb, live_tri_bound=65537)
    port = _port_frame(big, cm, state_from_numpy(jax.tree.map(np.asarray, js), cm))
    _hold_to_jax(rb, port, _jax_frame(build_render_bundle(jc), jc, js), "arena_lit")
    coin = (port[2][1][6].numpy() & 0xFFF) - 1 == rb.tex_names.index("texture/actor/coin.gtex")
    assert coin.sum() > 100 and (port[1][1][1]["exclude"].numpy()[1] >= 0).sum() > 50


def test_big_route_matches_tile_route(lit):
    """(g) the big route against the port's own tile route on arena_lit,
    the four sweep headings at the spawn, 128 x 128. Both routes evaluate
    the same float32 expressions, so where both pick the same screen
    triangle the frames agree (held to 2e-4); a pixel whose winner
    differs must lie within 1e-3 px of an edge of both winners: an equal-z
    tie between a clipped piece, which the big route puts in a row past
    the soup's, and its neighbour."""
    from c_game_engine_tpu_torch.models.sim import reset_batch
    from c_game_engine_tpu_torch.ops import raster_tiles as K4
    from c_game_engine_tpu_torch.render import raster as R

    cm, rb = lit
    st = reset_batch(cm, 4)
    st = st.replace(player=st.player.replace(yaw=st.player.yaw + torch.arange(4) * (np.pi / 2)))
    k4, kernel = [], K4.raster_tiles_binned
    with pytest.MonkeyPatch.context() as m:
        m.setattr(K4, "raster_tiles_binned", lambda *a, **k: k4.append((a, k, kernel(*a, **k))) or k4[-1][2])
        tiles = R.render_batch(rb, cm, st, H, W).numpy()
    big, calls, _, t_soup = _port_frame(dataclasses.replace(rb, live_tri_bound=65537), cm, st)
    txy = k4[0][0][0][..., :6].numpy().reshape(4, -1, 3, 2)
    bxy = calls[0][0][0][:, :6].numpy().transpose(0, 2, 1).reshape(4, -1, 3, 2)
    gy, gx = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    shows2 = k4[1][1]["exclude"].numpy() >= 0
    np.testing.assert_array_equal(shows2, calls[1][1]["exclude"].numpy() >= 0)
    differ = np.zeros((4, H, W), bool)
    for k in range(2):
        twin, bwin = k4[k][2][1].numpy(), calls[k][2][1].numpy()
        for e in range(4):
            tv, bv = txy[e][np.maximum(twin[e], 0)], bxy[e][np.maximum(bwin[e], 0)]
            d = ~(((twin[e] < 0) & (bwin[e] < 0)) | ((twin[e] >= 0) & (bwin[e] >= 0) & (tv == bv).all((-1, -2))))
            if k == 1:
                d &= shows2[e]
            for win, xy in ((twin[e], txy[e]), (bwin[e], bxy[e])):
                dist = edge_distance(xy[np.maximum(win, 0)].astype(np.float64), gx, gy)
                assert not (d & (win >= 0) & (dist > 1e-3)).any(), f"pass {k + 1}, heading {e}"
            differ[e] |= d
    err = np.abs(tiles - big).max(-1)
    assert err[~differ].max() <= 2e-4
    assert (calls[0][2][1].numpy() >= t_soup).sum() > 100  # clipped pieces win pixels
    assert differ.mean() <= 0.002


@pytest.fixture(scope="module")
def orb_frames(orb):
    """arena_orb after 30 ticks of the bench stream in two envs: env 0
    turned to face the sphere, env 1 through a free camera 4 mm outside
    the sphere looking along it, so the near plane cuts the sphere; the
    JAX XLA route's frame of both, and each env's state for the port."""
    import jax

    from c_game_engine_tpu.models.sim import reset_batch as j_reset
    from c_game_engine_tpu.models.sim import rollout as j_rollout
    from c_game_engine_tpu.render.bundle import build_render_bundle
    from tests.torch_export_map import ORB_POS, ORB_RADIUS, compile_arena_orb

    jc = compile_arena_orb()
    js = jax.jit(lambda s, a: j_rollout(jc, s, a))(j_reset(jc, 2), jax_actions(*_bench_stream(30, 2)))
    p = js.player
    centre = np.asarray(ORB_POS)
    to_orb = centre - np.asarray(p.pos[0])
    yaw0 = float(np.arctan2(-to_orb[0], -to_orb[2]))  # forward (-sin yaw, 0, -cos yaw)
    out = np.array([0.8, 0.25, 0.55])
    out /= np.linalg.norm(out)
    eye = centre + (ORB_RADIUS + 0.004) * out
    tangent = np.cross(out, [0.0, 1.0, 0.0])
    yaw1 = float(np.arctan2(-tangent[0], -tangent[2]))
    js = js.replace(player=p.replace(
        yaw=p.yaw.at[0].set(yaw0).at[1].set(yaw1), pitch=p.pitch.at[1].set(-0.2),
        freecam=p.freecam.at[1].set(True), freecam_pos=p.freecam_pos.at[1].set(eye)))
    return js, _jax_frame(build_render_bundle(jc), jc, js)


def test_arena_orb_matches_jax(orb, orb_frames):
    """(h) arena_orb (82,568 live triangles: the big route) in one env
    after 30 ticks, facing the sphere, 128 x 128, against the JAX XLA
    route (env 0 of the two-env JAX frame); the sphere's rows win at least
    10% of the pixels."""
    import jax

    from c_game_engine_tpu_torch.core.state import state_from_numpy
    from c_game_engine_tpu_torch.render import raster as R

    cm, rb = orb
    js, (frame, jz, jattr) = orb_frames
    assert rb.live_tri_bound > R.PALLAS_MAX_BOUND
    one = state_from_numpy(jax.tree.map(lambda x: np.asarray(x)[:1], js), cm)
    port = _port_frame(rb, cm, one)
    _hold_to_jax(rb, port, (frame[:1], jz, jattr), "arena_orb far")
    kind = (port[2][1][6].numpy() >> 12) & 3
    assert (port[2][1][0].numpy() & (kind == R.KIND_MODEL)).mean() >= 0.10


def test_arena_orb_near_plane_matches_jax(orb, orb_frames):
    """(i) the two-env arena_orb frame of (h), env 1 through a camera 4 mm
    outside the sphere, so hundreds of rows cross the near plane: their
    clipped pieces (the extension rows past the soup's) win pixels, and
    the frame holds to the JAX XLA route, whose `_clip_near` puts the
    pieces elsewhere."""
    import jax

    from c_game_engine_tpu_torch.core.state import state_from_numpy
    from c_game_engine_tpu_torch.render.raster import KIND_MODEL

    cm, rb = orb
    js, jax_out = orb_frames
    port = _port_frame(rb, cm, state_from_numpy(jax.tree.map(np.asarray, js), cm))
    win, t_soup = _hold_to_jax(rb, port, jax_out, "arena_orb near")
    kind = (port[2][1][6].numpy()[1] >> 12) & 3
    assert ((win[1] >= t_soup) & (kind == KIND_MODEL)).mean() > 0.05  # the sphere's clipped pieces win pixels
