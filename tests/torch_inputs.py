"""Inputs of the port's kernel tests, made on the host with numpy from a
seed: shared by the CPU parity tests (tests/test_torch_kernels.py,
tests/test_torch_bodies.py, tests/test_torch_render.py,
tests/test_torch_raster_tiles.py) and the card tests
(tests/test_torch_cuda.py),
so this module imports numpy only: a GPU host need not have JAX."""

from __future__ import annotations

import numpy as np


def capsule_inputs(tc, layout, seed, batch=256):
    """pos/vel [B, 3] and random solid boxes [8/4, N, B] near the lanes;
    layout "tie" builds its own table instead (_capsule_tie_inputs)."""
    rng = np.random.default_rng(seed)
    if layout == "tie":
        return _capsule_tie_inputs(rng, batch)
    if layout == "clustered":
        # every 128-lane block is a small cluster on the stairs/terrace
        centres = np.array([[10.9, 0.45, -2.0], [16.0, 1.25, 3.0]], np.float32)
        pos = np.repeat(centres, 128, 0) + rng.normal(0, 0.05, (batch, 3)).astype(np.float32)
    else:
        pos = np.stack(
            [rng.uniform(-23, 23, batch), rng.uniform(0.2, 1.6, batch), rng.uniform(-23, 23, batch)], 1
        ).astype(np.float32)
    vel = rng.normal(0, 2.0, (batch, 3)).astype(np.float32)
    n = 4
    q = rng.normal(size=(n, batch, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    # box centres 0.3-0.9 m off the capsule axis and at most 0.26 m from
    # centre to corner, so the axis never runs inside a box (a degenerate
    # zero-distance contact whose tie-break turns on the last bit)
    ang = rng.uniform(0, 2 * np.pi, (n, batch))
    rad = rng.uniform(0.3, 0.9, (n, batch))
    off = np.stack([rad * np.cos(ang), rng.uniform(-0.5, 0.5, (n, batch)), rad * np.sin(ang)])
    box8 = np.concatenate(
        [
            (pos.T[:, None, :] + off).astype(np.float32),
            q.transpose(2, 0, 1),
            (rng.random((1, n, batch)) < 0.7).astype(np.float32),
        ]
    )
    boxh = np.concatenate([rng.uniform(0.05, 0.15, (3, n, batch)), np.zeros((1, n, batch))]).astype(np.float32)
    tri16 = tc.tri16.numpy()
    return tri16, tc.chunk_bounds.numpy(), box8, boxh, pos, vel


# the K1 tie layout: four groups of capsules (radius 0.2, half height 0.25)
# over a 3-chunk table, each at an exact tie; x of each group's axis
K1_TIE_X = {"in_chunk": 50.0, "across_chunks": 70.0, "box_flush": 60.0, "two_boxes": 80.0}


def _capsule_tie_inputs(rng, batch):
    """A [96, 16] table, its chunk bounds, 4 boxes per lane and 256 lanes in
    four groups, 32 lanes of each group per 128-lane block (one chunk list
    for every lane). Every distance below is a power of two, so each tie is
    exact in float32 whatever the evaluation order:

    - in_chunk: walls 0.125 m either side of the capsule axis, at rows 3
      and 17 of chunk 0, normals -x and +x; row 3 must win, so the first
      push is toward -x;
    - across_chunks: the same pair at chunk 0 row 20 (-x) and chunk 1 row 2
      (+x); row 20 must win, though its thread (20) is the later one;
    - box_flush: a floor triangle's vertex 0.125 m under the capsule's
      bottom (chunk 2 row 9), and box 1, axis-aligned, its top flush with
      the floor and its side 2**-15 m off the axis: the same depth
      (0.125**2 + 2**-30 rounds to 0.125**2), normals (0, 1, 0) and
      (2**-12, 1, 0); the triangle must win, as a box wins only when
      strictly deeper; velocity 0, so the near-ties of the later
      iterations (depth ~0) cannot move anything;
    - two_boxes: boxes 1 and 2 0.125 m either side of the axis (normals -x
      and +x), far from every triangle; box 1 must win.
    Box 0 is masked in every lane (still the serial walk's first box), and
    every box a group does not use is masked."""
    rows = np.zeros((96, 16), np.float32)

    def tri(r, a, b, c, n):
        rows[r, 0:9] = np.array([a, b, c], np.float32).reshape(9)
        rows[r, 9:16] = (*n, 1.0, 1.0, 1.0, 1.0)

    def wall(r, x, nx):  # the plane x, around (x, 1, 0), facing nx
        tri(r, (x, -1.0, -1.5), (x, 3.0, 0.0), (x, -1.0, 1.5), (nx, 0.0, 0.0))

    x1, x2, x3, x4 = K1_TIE_X.values()
    wall(3, x1 + 0.125, -1.0)
    wall(17, x1 - 0.125, 1.0)
    wall(20, x2 + 0.125, -1.0)
    wall(32 + 2, x2 - 0.125, 1.0)
    tri(64 + 9, (x3, 0.0, 0.0), (x3 + 2.0, 0.0, -1.0), (x3 + 2.0, 0.0, 1.0), (0.0, 1.0, 0.0))
    bounds = np.zeros((3, 4), np.float32)
    for c in range(3):
        v = rows[32 * c:32 * (c + 1)][rows[32 * c:32 * (c + 1), 12] > 0, 0:9].reshape(-1, 3)
        bounds[c] = v[:, 0].min(), v[:, 2].min(), v[:, 0].max(), v[:, 2].max()

    group = np.tile(np.repeat(np.arange(4), 32), batch // 128)
    xs, heights = np.array([x1, x2, x3, x4]), np.array([1.0, 1.0, 0.375, 1.0])
    pos = np.stack([xs[group], heights[group], np.zeros(batch)], 1).astype(np.float32)
    vel = rng.normal(0, 2.0, (batch, 3)).astype(np.float32)
    vel[group == 2] = 0.0
    n = 4
    box8 = np.zeros((8, n, batch), np.float32)
    box8[0:3] = np.float32(-40.0)  # far away and masked
    box8[6] = 1.0  # identity quaternions
    boxh = np.zeros((4, n, batch), np.float32)
    boxh[0:3] = 0.25

    def box(k, lanes, centre, half):
        box8[0:3, k, lanes] = np.float32(centre)[:, None]
        box8[7, k, lanes] = 1.0
        boxh[0:3, k, lanes] = np.float32(half)[:, None]

    flush = group == 2
    box(1, flush, (x3 - 0.25 - 2.0 ** -15, -0.25, 0.0), (0.25, 0.25, 0.25))
    two = group == 3
    box(1, two, (x4 + 0.375, 1.0, 0.0), (0.25, 0.5, 0.25))
    box(2, two, (x4 - 0.375, 1.0, 0.0), (0.25, 0.5, 0.25))
    return rows, bounds, box8, boxh, pos, vel


def cylinder(radius, half_height, n_sides=12):
    """A Y-axis cylinder's support cloud: two inscribed n-gon rings (the
    cloud the compiler gives npc_john), made here so the card tests need no
    JAX."""
    a = np.arange(n_sides) * (2 * np.pi / n_sides)
    ring = np.stack([radius * np.cos(a), np.zeros(n_sides), radius * np.sin(a)], -1)
    return np.concatenate([ring + [0.0, half_height, 0.0], ring - [0.0, half_height, 0.0]]).astype(np.float32)


# three 32-triangle chunks far from the arena (x = 100) for body 0's second
# block: chunk 0 holds E1, chunk 1 holds E2 (its mirror image: the same
# depth at another point), chunk 2 three floors C1-C3 deeper than both
TIE_X = 100.0


def _tie_chunks():
    """([96, 16] rows, [3, 4] chunk bounds): E1, E2 and C1-C3 for a 0.2 m
    box centred at (TIE_X, 0.15, 0). The TPU kernel's chunk-then-bubble
    insertion keeps [C1, C2, C3, E2]; a stable merge would keep E1."""
    x = TIE_X
    rows = np.zeros((96, 16), np.float32)

    def tri(r, a, b, c):
        rows[r, 0:9] = np.array([a, b, c], np.float32).reshape(9)
        rows[r, 9:16] = (0.0, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0)  # up normal, valid, active edges

    tri(0, (x + 0.3, 0.0, -1.0), (x + 0.3, 0.0, 1.0), (x + 2.0, 0.0, 0.0))  # E1
    tri(32, (x - 0.3, 0.0, 1.0), (x - 0.3, 0.0, -1.0), (x - 2.0, 0.0, 0.0))  # E2
    for r, y in enumerate((0.03, 0.02, 0.01)):  # C1-C3 under the box
        tri(64 + r, (x - 2.0, y, -3.0), (x - 2.0, y, 3.0), (x + 4.0, y, 0.0))
    bounds = np.array([[x + 0.3, -1.0, x + 2.0, 1.0], [x - 2.0, -1.0, x - 0.3, 1.0],
                       [x - 2.0, -3.0, x + 4.0, 3.0]], np.float32)
    return rows, bounds


def k3_inputs(tc):
    """body11 [16, 4, 256] for two box bodies and two hull bodies over two
    128-lane blocks; the last 56 lanes are zero padding.

    Every body sits near the floor, the stairs or the ramp, and a third of
    its lanes are off. Lanes 0-15 of body 0 are centred over a floor cell
    at (x + 0.5, z + 0.5), unrotated and at rest, where four neighbouring
    triangles give the same depth at four different points: a tie the
    top-4 must break in visiting order. Body 0's second block sits over the
    tie chunks appended to the arena's table (_tie_chunks), where the order
    of the two insertion levels decides which of two equal contacts
    survives. Body 1 is off in every lane of block 1 (an empty chunk
    list)."""
    rng = np.random.default_rng(11)
    d, b, live = 4, 256, 200
    centres = np.array([[-3.0, 0.0, 2.0], [11.3, 0.4, -2.2], [16.0, 0.75, 7.5], [-5.0, 0.0, -5.0]])
    halfext = np.array([[0.2, 0.2, 0.2], [0.3, 0.15, 0.25], [0.25, 0.5, 0.25], [0.25, 0.5, 0.25]])
    body = np.zeros((16, d, b), np.float32)
    for k in range(d):
        pos = centres[k] + rng.normal(0, [0.4, 0.05, 0.4], (b, 3))
        pos[:, 1] += halfext[k, 1] - 0.05
        q = rng.normal(size=(b, 4)) * [0.3, 1.0, 0.3, 1.0]
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        vel = rng.normal(0, 0.5, (b, 3))
        on = rng.random(b) > 0.33
        if k == 0:  # the tie lanes
            pos[:16] = [np.floor(centres[k][0]) + 0.5, 0.15, np.floor(centres[k][2]) + 0.5]
            pos[128:] = [TIE_X, 0.15, 0.0]
            q[:16] = q[128:] = [0.0, 0.0, 0.0, 1.0]
            vel[:16] = vel[128:] = 0.0
            on[:16] = on[128:] = True
        if k == 1:
            on[128:] = False
        body[0:3, k] = pos.T
        body[3:7, k] = q.T
        body[7:10, k] = halfext[k][:, None]
        body[10, k] = on
        body[11:14, k] = vel.T
    body[:, :, live:] = 0.0
    verts = np.zeros((d, 24, 3), np.float32)
    verts[:2] = cylinder(0.2, 0.2)  # ignored: box bodies
    verts[2] = cylinder(0.25, 0.5)
    verts[3] = cylinder(0.25, 0.5) * [1.2, 1.0, 0.8]
    margin = (np.linalg.norm(halfext, axis=1) + 0.35).astype(np.float32)
    rows, bounds = _tie_chunks()
    tri16 = np.concatenate([tc.tri16.numpy()[: 32 * tc.chunk_bounds.shape[0]], rows])
    cb = np.concatenate([tc.chunk_bounds.numpy(), bounds])
    return tri16, cb, body, margin, verts, (True, True, False, False)


# the K3 tie case: two groups of one 0.2 m box body over a 4-chunk table
K3_TIE_X = (200.0, 210.0)
K3_TIE_ROWS = (2, 6, 9, 13, 17, 21, 25, 30)  # chunk 0; row 13 is invalid


def _vertex_tri(rows, r, q, away):
    """Row r: a horizontal triangle with vertex q, its other two vertices 2 m
    further along `away` (a step from the body's centre toward q; +x where
    the step is vertical), so q is its closest point to the centre; the
    face normal points toward the centre."""
    q = np.asarray(q, np.float64)
    ax, _, az = away if away[0] or away[2] else (1.0, 0.0, 0.0)
    side = np.array([-az, 0.0, ax])  # across the step, in the plane
    far = q + 2.0 * np.array([ax, 0.0, az])
    rows[r, 0:9] = np.array([q, far - side, far + side], np.float32).reshape(9)
    rows[r, 9:16] = (0.0, -np.sign(away[1]), 0.0, 1.0, 1.0, 1.0, 1.0)


def k3_tie_inputs():
    """(tri16 [128, 16], chunk bounds [4, 4], body11 [16, 1, 256], margin
    [1], verts [1, 1, 3], is_box) for one unrotated 0.2 m box body at rest
    (no edge fix), over a table of its own. Every contact below is a
    triangle vertex at (+-0.125, +-0.125, 0) or (0, +-0.125, +-0.125) from
    the body's centre, so their depths are equal to the last bit at eight
    different points.

    Block 0 (centre (K3_TIE_X[0], 0.125, 0)): eight such rows in chunk 0,
    at rows K3_TIE_ROWS, spread over a warp's threads, row 13 invalid
    (t[12] = 0); only rows 2, 6, 9 and 17, in that order, may be kept.
    Block 1 (centre (K3_TIE_X[1], 0.125, 0)): X at chunk 1 row 28 and Y,
    X's mirror image, at chunk 2 row 1, with a shallower contact D (a
    vertex 0.125 m straight below) at chunk 2 row 5; the buffer must read
    [X, Y, D]. Chunk 3 holds only invalid rows, and block 0 lists it.
    Every fifth lane is off, and lanes 232-255 are padding."""
    rows = np.zeros((128, 16), np.float32)
    xa, xb = K3_TIE_X
    h = 0.125
    offs = [(h, -h, 0.0), (-h, -h, 0.0), (0.0, -h, h), (0.0, -h, -h),
            (h, h, 0.0), (-h, h, 0.0), (0.0, h, h), (0.0, h, -h)]
    for r, (dx, dy, dz) in zip(K3_TIE_ROWS, offs):
        _vertex_tri(rows, r, (xa + dx, h + dy, dz), np.sign((dx, dy, dz)))
    rows[13, 12] = 0.0
    _vertex_tri(rows, 32 + 28, (xb + h, 0.0, 0.0), (1.0, -1.0, 0.0))  # X
    _vertex_tri(rows, 64 + 1, (xb - h, 0.0, 0.0), (-1.0, -1.0, 0.0))  # Y
    _vertex_tri(rows, 64 + 5, (xb, 0.0, 0.0), (0.0, -1.0, 0.0))  # D, straight below
    rows[96:, 0:9] = np.tile([xa, -5.0, 0.0], 3)  # invalid rows of chunk 3
    bounds = np.zeros((4, 4), np.float32)
    for c in range(4):
        v = rows[32 * c:32 * (c + 1), 0:9].reshape(-1, 3)[np.repeat(rows[32 * c:32 * (c + 1), 0] != 0, 3)]
        bounds[c] = v[:, 0].min(), v[:, 2].min(), v[:, 0].max(), v[:, 2].max()

    b = 256
    body = np.zeros((16, 1, b), np.float32)
    body[0, 0] = np.where(np.arange(b) < 128, xa, xb)
    body[1, 0] = h
    body[6, 0] = 1.0  # identity quaternion
    body[7:10, 0] = 0.2
    body[10, 0] = np.arange(b) % 5 != 4
    body[:, :, 232:] = 0.0
    margin = np.array([np.sqrt(3 * 0.2 ** 2) + 0.35], np.float32)
    return rows, bounds, body, margin, np.zeros((1, 1, 3), np.float32), (True,)


def k4_inputs(seed, batch=2, height=32, width=256, t=120):
    """A random screen-space table for the tile kernel K4, per env:
    tri48 [B, T, 48] (ops/raster_tiles.py column layout), sx/sy [B, T, 3]
    and tri_ok [B, T] for the binning, exclude [B, H, W] i32.

    Besides random well-shaped triangles of 5-90 px, some partly off the
    frame, at z from -0.1 to 1.1 (the z test rejects some pixels) and
    tilted by up to 0.1 in z across the triangle, as perspective geometry
    is, every env
    has: degenerate triangles (two coincident vertices; binned, zero
    area), a triangle wholly off the frame, and pairs of rows with the same
    screen geometry and z, so that the lower index must win every pixel of
    the pair. A third of the pixels exclude a random id."""
    rng = np.random.default_rng(seed)
    tri48 = np.zeros((batch, t, 48), np.float32)
    for b in range(batch):
        c = np.stack([rng.uniform(-20, width + 20, t), rng.uniform(-8, height + 8, t)], -1)
        # well-shaped triangles: vertices 120 +- 30 degrees apart around the
        # centre (a sliver's z and attributes are ill-conditioned, and an
        # FMA in one evaluation and not the other moves them past 1e-6)
        ang = rng.uniform(0, 2 * np.pi, (t, 1)) + np.arange(3) * (2 * np.pi / 3) + rng.uniform(-0.5, 0.5, (t, 3))
        rad = rng.uniform(5, 45, (t, 1)) * rng.uniform(0.7, 1.0, (t, 3))
        v = c[:, None, :] + rad[..., None] * np.stack([np.cos(ang), np.sin(ang)], -1)
        v[:6, 2] = v[:6, 0]  # degenerate: two coincident vertices
        v[6] += [width + 40, 0]  # wholly off the frame
        z = rng.uniform(-0.1, 1.1, (t, 1)) + rng.uniform(-0.05, 0.05, (t, 3))
        for k in range(8, t - 1, 12):  # equal-z twins: row k + 1 copies row k's geometry
            v[k + 1], z[k + 1] = v[k], z[k]
        tri48[b, :, 0:6] = v.reshape(t, 6)
        tri48[b, :, 6:9] = z
        tri48[b, :, 9] = np.arange(t)
        tri48[b, :, 10:13] = rng.uniform(0.2, 2.0, (t, 3))
        tri48[b, :, 13:37] = rng.uniform(-1.5, 2.5, (t, 24))
        tri48[b, :, 37] = rng.integers(0, 1 << 23, t)
    sx, sy = tri48[..., 0:6:2], tri48[..., 1:6:2]
    tri_ok = np.ones((batch, t), bool)
    exclude = rng.integers(0, t, (batch, height, width)).astype(np.int32)
    exclude[rng.random((batch, height, width)) > 0.33] = -1
    return tri48, sx.copy(), sy.copy(), tri_ok, exclude


def k4_bin_edge_inputs(kind, seed=11, batch=None):
    """The binning edge table of K4, at 16 x 256 (2 x 2 tiles of 8 x 128):
    (tri48 [B, T, 48] f32, tri_ok [B, T] bool, exclude [B, 16, 256] i32,
    tile_on [B, 4] i32). kind "crowded" has T = 640 and puts 560 small
    triangles inside tile (0, 0), so that its list overflows L = 512 and
    drops the highest ids (row 22 covers that tile at z 0.5, the crowd lies
    behind it but for its last 80 rows, which lie in front of every other
    row, so the frame shows where the list stops); kind "small" has T = 64 < 512, so L = T.

    Rows 0-27 of every env are the edge rows, big triangles at z near 0.1
    (each would win its pixels if listed; `EDGE_ROWS` names them):
    tri_ok false (0, 1); a NaN x (2) and a NaN y (3), which amin/amax make
    NaN bboxes that overlap nothing; NaN z (4, listed, never closer); x =
    -inf (5) and y = +inf (6) at one vertex (listed, z NaN: never
    closer); x = +inf at all three vertices (7, overlaps nothing); boxes
    that touch a tile bound exactly: xmin = 128 (8) and xmax = 128 (9),
    ymin = 8 (10) and ymax = 8 (11), xmin = 256 (12), xmax = 0 (13),
    ymin = 16 (14), ymax = 0 (15), each listed in the tiles on both sides
    of the bound it touches; boxes one float short of a bound: xmin just
    above 128 (16) and xmax just below 128 (17), ymin just above 8 (18)
    and ymax just below 8 (19), listed on one side only. Rows 20-27 are
    well-shaped triangles of the frame at z 0.3-0.6, with an equal-z twin
    (row 21 copies row 20; row 22 covers tile (0, 0) at z 0.5). The other rows are random well-shaped
    triangles of 3-20 px at z from -0.1 to 1.1, some partly off the
    frame, with degenerate rows (two coincident vertices) and equal-z
    twins. A third of the pixels exclude a random id; the last env gates
    tile (1, 0) off, and "crowded" tiles (0, 1) and (1, 1) too. One env
    for "crowded", two for "small", unless `batch` says otherwise."""
    rng = np.random.default_rng(seed)
    h, w = 16, 256
    t, n_crowd = {"crowded": (640, 560), "small": (64, 0)}[kind]
    batch = batch or (1 if kind == "crowded" else 2)
    tri48 = np.zeros((batch, t, 48), np.float32)
    tri_ok = np.ones((batch, t), bool)
    below, above = np.nextafter(np.float32(128), np.float32(0)), np.nextafter(np.float32(128), np.float32(256))
    below8, above8 = np.nextafter(np.float32(8), np.float32(0)), np.nextafter(np.float32(8), np.float32(16))
    nan, inf = np.nan, np.inf
    edge = [  # (x0, y0, x1, y1, x2, y2) of rows 0-19
        (-20, -10, 280, -10, 130, 40), (10, 2, 250, 3, 120, 15),
        (-20, -10, nan, -10, 130, 40), (-20, -10, 280, -10, 130, nan),
        (-20, -10, 280, -10, 130, 40), (-inf, 1, 200, 2, 100, 14), (5, 1, 200, 3, 100, inf),
        (inf, 1, inf, 5, inf, 9),
        (128, 2, 140, 6, 135, 12), (110, 2, 128, 6, 120, 12), (100, 8, 118, 12, 110, 14),
        (20, 1, 40, 8, 30, 5), (256, 3, 270, 6, 262, 12), (-12, 3, 0, 6, -6, 12),
        (30, 16, 50, 20, 40, 22), (60, -6, 80, 0, 70, -3),
        (above, 2, 140, 6, 135, 12), (110, 2, below, 6, 120, 12), (100, above8, 118, 12, 110, 14),
        (20, 1, 40, below8, 30, 5),
    ]
    for b in range(batch):
        n_rand = t - 28 - n_crowd
        c = np.stack([rng.uniform(-20, w + 20, n_rand), rng.uniform(-8, h + 8, n_rand)], -1)
        ang = rng.uniform(0, 2 * np.pi, (n_rand, 1)) + np.arange(3) * (2 * np.pi / 3) + rng.uniform(-0.5, 0.5, (n_rand, 3))
        rad = rng.uniform(3, 20, (n_rand, 1)) * rng.uniform(0.7, 1.0, (n_rand, 3))
        v_rand = c[:, None, :] + rad[..., None] * np.stack([np.cos(ang), np.sin(ang)], -1)
        v_rand[:4, 2] = v_rand[:4, 0]  # degenerate: two coincident vertices
        # the crowd: circumradius 1.5-2.5 px, wholly inside tile (0, 0)
        c = np.stack([rng.uniform(4, 124, n_crowd), rng.uniform(3, 5, n_crowd)], -1)
        ang = rng.uniform(0, 2 * np.pi, (n_crowd, 1)) + np.arange(3) * (2 * np.pi / 3) + rng.uniform(-0.4, 0.4, (n_crowd, 3))
        v_crowd = c[:, None, :] + rng.uniform(1.5, 2.5, (n_crowd, 1, 1)) * np.stack([np.cos(ang), np.sin(ang)], -1)
        # rows 20-27: well-shaped triangles of the frame, row 21 row 20's twin
        c = np.stack([rng.uniform(20, w - 20, 8), rng.uniform(2, h - 2, 8)], -1)
        ang = rng.uniform(0, 2 * np.pi, (8, 1)) + np.arange(3) * (2 * np.pi / 3) + rng.uniform(-0.5, 0.5, (8, 3))
        v_mid = c[:, None, :] + rng.uniform(6, 30, (8, 1, 1)) * np.stack([np.cos(ang), np.sin(ang)], -1)
        v_mid[1] = v_mid[0]
        v_mid[2] = [(-10, -20), (300, -4), (-10, 20)]  # row 22 covers tile (0, 0)
        v = np.concatenate([np.array(edge, np.float64).reshape(20, 3, 2), v_mid, v_crowd, v_rand])
        z = np.concatenate([
            0.1 + rng.uniform(-0.02, 0.02, (20, 3)),
            rng.uniform(0.3, 0.6, (8, 1)) + rng.uniform(-0.05, 0.05, (8, 3)),
            rng.uniform(0.05, 0.95, (n_crowd, 1)) + rng.uniform(-0.02, 0.02, (n_crowd, 3)),
            rng.uniform(-0.1, 1.1, (n_rand, 1)) + rng.uniform(-0.05, 0.05, (n_rand, 3)),
        ])
        z[21], z[4, 1], z[22] = z[20], np.nan, 0.5
        # the crowd behind row 22 but for its last 80 rows, which lie in
        # front of every other row, so that the frame shows where the list
        # stops
        z[28:28 + n_crowd] = rng.uniform(0.6, 0.95, (n_crowd, 1)) + rng.uniform(-0.02, 0.02, (n_crowd, 3))
        z[28 + n_crowd - 80:28 + n_crowd] *= 0.05
        for k in range(28 + n_crowd + 10, t - 1, 12):  # equal-z twins among the random rows
            v[k + 1], z[k + 1] = v[k], z[k]
        tri48[b, :, 0:6] = v.reshape(t, 6)
        tri48[b, :, 6:9] = z
        tri48[b, :, 9] = np.arange(t)
        tri48[b, :, 10:13] = rng.uniform(0.2, 2.0, (t, 3))
        tri48[b, :, 13:37] = rng.uniform(-1.5, 2.5, (t, 24))
        tri48[b, :, 37] = rng.integers(0, 1 << 23, t)
        tri_ok[b, :2] = False
    exclude = rng.integers(0, t, (batch, h, w)).astype(np.int32)
    exclude[rng.random((batch, h, w)) > 0.33] = -1
    tile_on = np.ones((batch, 4), np.int32)
    tile_on[-1, 2] = 0
    if kind == "crowded":  # the other tiles' walks are the small table's (the interpret mode is slow)
        tile_on[:, 1::2] = 0
    return tri48, tri_ok, exclude, tile_on


# rows of k4_bin_edge_inputs and the tiles (ty, tx) each is listed in
EDGE_ROWS = {
    "not ok": ((0, ()), (1, ())),
    "NaN coordinate": ((2, ()), (3, ())),
    "NaN z": ((4, ((0, 0), (0, 1), (1, 0), (1, 1))),),
    "infinite coordinate": ((5, ((0, 0), (0, 1), (1, 0), (1, 1))), (6, ((0, 0), (0, 1), (1, 0), (1, 1))),
                            (7, ())),
    "touching a bound": ((8, ((0, 0), (0, 1), (1, 0), (1, 1))), (9, ((0, 0), (0, 1), (1, 0), (1, 1))),
                         (10, ((0, 0), (1, 0))), (11, ((0, 0), (1, 0))), (12, ((0, 1), (1, 1))),
                         (13, ((0, 0), (1, 0))), (14, ((1, 0),)), (15, ((0, 0),))),
    "one float short": ((16, ((0, 1), (1, 1))), (17, ((0, 0), (1, 0))), (18, ((1, 0),)), (19, ((0, 0),))),
}


def k5_inputs(seed, batch=1, height=8, width=128, t=4096, kind="random"):
    """A random fields-major table for the streamed kernel K5, per env:
    trit [B, 16, T] (ops/raster_tiles_big.py layout) and exclude [B, H, W]
    i32; kind "subpixel" gives the table of `_k5_subpixel` instead.

    About one row in eight is live, and four runs of 64 rows (whole
    subchunks) are dead throughout, so subchunk tests skip; dead rows carry
    the +-1e30 bbox and garbage coordinates. Live rows are well-shaped
    triangles of 5-60 px (see k4_inputs) at z from -0.1 to 1.1, with
    degenerate rows (two coincident vertices), rows wholly off the frame,
    and equal-z twins: rows with the geometry and z of the live row before
    them, which must lose every pixel to it. A third of the pixels exclude
    a random live id."""
    rng = np.random.default_rng(seed)
    if kind == "subpixel":
        return _k5_subpixel(rng, batch, height, width, t)
    trit = np.zeros((batch, 16, t), np.float32)
    exclude = np.full((batch, height, width), -1, np.int32)
    for b in range(batch):
        live = rng.random(t) < 0.125
        for s in rng.choice(t // 64, 4, replace=False):
            live[s * 64:(s + 1) * 64] = False
        c = np.stack([rng.uniform(-20, width + 20, t), rng.uniform(-10, height + 10, t)], -1)
        ang = rng.uniform(0, 2 * np.pi, (t, 1)) + np.arange(3) * (2 * np.pi / 3) + rng.uniform(-0.5, 0.5, (t, 3))
        rad = rng.uniform(5, 60, (t, 1)) * rng.uniform(0.7, 1.0, (t, 3))
        v = c[:, None, :] + rad[..., None] * np.stack([np.cos(ang), np.sin(ang)], -1)
        z = rng.uniform(-0.1, 1.1, (t, 1)) + rng.uniform(-0.05, 0.05, (t, 3))
        ids = np.nonzero(live)[0]
        v[ids[:8], 2] = v[ids[:8], 0]  # degenerate
        v[ids[8:12]] += [width + 70, 0]  # wholly off the frame
        for k in ids[16:-1:10]:  # equal-z twins
            v[k + 1], z[k + 1] = v[k], z[k]
            live[k + 1] = True
        v[~live] = rng.uniform(-1e3, 1e3, (int((~live).sum()), 3, 2))  # never read
        trit[b, 0:6] = v.reshape(t, 6).T
        trit[b, 6:9] = z.T
        trit[b, 10] = np.where(live, v[..., 0].min(1), 1e30)
        trit[b, 11] = np.where(live, v[..., 0].max(1), -1e30)
        trit[b, 12] = np.where(live, v[..., 1].min(1), 1e30)
        trit[b, 13] = np.where(live, v[..., 1].max(1), -1e30)
        pick = rng.random((height, width)) < 0.33
        exclude[b][pick] = rng.choice(np.nonzero(live)[0], int(pick.sum()))
    return trit, exclude


def k2_edge_inputs():
    """(tri16 [192, 16], chunk bounds [6, 4], origin [704, 3], direction
    [704, 3], max_dist [704], expect [704], all float32) for the ray kernel K2: rays
    that sit exactly on the edges the kernel's chunk lists and hit tests
    decide, in five 128-ray blocks and a last block of 64 rays (R is not a
    multiple of 128). `expect` is each built ray's t (1e30 a miss), NaN for
    the random rays. Every coordinate is a multiple of 1/4 and every
    triangle a unit right triangle, so each t below is exact in float32
    whatever the evaluation order.

    Table: chunks 0-3 are floors of unit squares (two triangles each) over
    x in [0, 8] and z in [2c, 2c + 2], at y = -0.25, 0, 0, -0.25; chunk 4
    holds 8 floor triangles over x in [10, 12], z in [0, 2] at y = 0 and 24
    invalid rows at y = 0.5 above them; chunk 5 holds one triangle at
    y = 0.5 over x in [7.5, 11.5] whose declared bound starts one float
    above x = 10, so no block below reaches it.

    Blocks (vertical rays from y = 1 unless said otherwise):
    0. x in [0, 8], z in [0, 2], on vertices, edges and diagonals; the
       block's box touches chunk 1 only at z = 2, where chunk 1 (t 1) is
       above chunk 0 (t 1.25): a list one chunk short changes t;
    1. z in [6, 8]: chunk 2 (t 1) reached only at z = 6;
    2. x in [8, 10], z in [0, 2]: chunk 0 at x = 8 (t 1.25) and chunk 4 at
       x = 10 (t 1) reached only at the box's edges; between them nothing
       (chunk 5, listed one chunk long, would give t 0.5);
    3. z = 4: the shared edge of chunks 1 and 2, both at y = 0;
    4. one ray with a NaN origin among rays over chunk 1: the block's box
       is NaN, so it lists no chunk and every ray misses (as
       compact_chunk_lists lists none on NaN extents);
    5. rays parallel to the floors (in and above their planes), hits at
       exactly max_dist and one float short of it, oblique rays with exact
       hits, and random rays, mostly downward."""
    rows = np.zeros((192, 16), np.float32)
    r = 0

    def tri(a, b, c, valid=1.0):
        nonlocal r
        rows[r, 0:9] = np.array([a, b, c], np.float32).reshape(9)
        rows[r, 9:13] = (0.0, 1.0, 0.0, valid)
        r += 1

    def square(x, y, z, valid=1.0):
        tri((x, y, z), (x + 1, y, z), (x + 1, y, z + 1), valid)
        tri((x, y, z), (x + 1, y, z + 1), (x, y, z + 1), valid)

    heights = (-0.25, 0.0, 0.0, -0.25)
    for c, y in enumerate(heights):
        for j in range(2):
            for i in range(8):
                square(i, y, 2 * c + j)
    for j in range(2):
        for i in range(2):
            square(10 + i, 0.0, j)
    while r < 160:
        tri((9.5, 0.5, -1.0), (13.0, 0.5, -1.0), (9.5, 0.5, 3.0), valid=0.0)
    tri((7.5, 0.5, -1.0), (13.0, 0.5, -1.0), (7.5, 0.5, 10.0))
    above_ten = np.nextafter(np.float32(10.0), np.float32(np.inf))
    bounds = np.array([[0, 0, 8, 2], [0, 2, 8, 4], [0, 4, 8, 6], [0, 6, 8, 8], [10, 0, 12, 2],
                       [above_ten, -1, 13, 10]], np.float32)

    rng = np.random.default_rng(12)
    down = (0.0, -1.0, 0.0)
    origin, direction, max_dist, expect = [], [], [], []

    def ray(o, d=down, m=2.0, t=np.nan):
        origin.append(o)
        direction.append(d)
        max_dist.append(m)
        expect.append(t)

    def floor_t(x, z):
        """t of a vertical ray from y = 1 at (x, z) over chunks 0-4."""
        if 10 <= x <= 12 and 0 <= z <= 2:
            return 1.0
        ts = [1.0 - y for c, y in enumerate(heights) if 0 <= x <= 8 and 2 * c <= z <= 2 * c + 2]
        return min(ts, default=1e30)

    def block(points, filler):
        points = (points + filler)[:128]
        assert len(points) == 128
        for x, z in points:
            ray((x, 1.0, z), t=floor_t(x, z))

    grid = lambda xs, zs: [(float(x), float(z)) for z in zs for x in xs]
    line = lambda x0, z: [(float(x), z) for x in np.arange(x0, 8, 0.25)]
    # 0: the box touches chunk 1 at z = 2
    block(grid(range(9), (0.0, 1.0, 2.0)) + grid(np.arange(8) + 0.5, (0.0, 1.0, 2.0))
          + grid(np.arange(8) + 0.25, (0.25, 1.25)) + grid(np.arange(8) + 0.75, (0.75, 1.5)),
          line(0.0, 2.0) + line(0.125, 2.0))
    # 1: the box touches chunk 2 at z = 6
    block(grid(range(9), (6.0, 7.0, 8.0)) + grid(np.arange(8) + 0.5, (6.0, 7.5))
          + grid(np.arange(8) + 0.25, (6.25, 7.25)), line(0.0, 6.0) + line(0.125, 6.0) + line(0.0625, 6.0))
    # 2: the box touches chunk 0 at x = 8 and chunk 4 at x = 10; nothing between
    zs = np.arange(0, 2.25, 0.25)
    block(grid((8.0, 10.0), zs) + grid(np.arange(8.25, 10, 0.25), zs),
          grid((10.0, 8.0), np.arange(0.0625, 2, 0.125)) + grid((10.0, 8.0), np.arange(0.03125, 2, 0.125)))
    # 3: the shared edge of chunks 1 and 2 at z = 4
    block(line(0.0, 4.0) + line(0.125, 4.0) + grid(np.arange(0.25, 8, 0.5), (3.75, 4.25))
          + grid(np.arange(0.5, 8, 1.0), (3.5, 4.5)), line(0.0625, 4.0))
    # 4: a NaN origin empties the block's list
    for k in range(128):
        ray((0.5 + (k % 8), 1.0, 2.25 + 0.125 * (k // 8)), t=1e30)
    origin[-1] = (np.nan, 1.0, 3.0)
    # 5: 64 rays, then the 64 padded lanes
    for k in range(4):  # parallel to the floors: in the y = 0 and y = -0.25 planes, and above
        ray((-1.0, 0.0, 2.5 + k), (1.0, 0.0, 0.0), 20.0, 1e30)
        ray((-1.0, -0.25, 0.5 + 0.5 * k), (1.0, 0.0, 0.0), 20.0, 1e30)
        ray((-1.0, 0.125, 2.0 + k), (1.0, 0.0, 1.0), 20.0, 1e30)
    for k in range(8):  # hits at exactly max_dist, and one float short of it
        ray((0.5 + 0.5 * k, 1.0, 2.5), m=1.0, t=1.0)
        ray((0.25 + k, 1.0, 3.5), m=float(np.nextafter(np.float32(1.0), np.float32(0.0))), t=1e30)
    for k in range(8):  # oblique, exact: (1, -1, 0) and (0.5, -1, 0.25) from y = 1 onto y = 0
        ray((0.25 + 0.5 * k, 1.0, 2.5), (1.0, -1.0, 0.0), 2.0, 1.0)
        ray((0.5 + 0.5 * k, 1.0, 4.0), (0.5, -1.0, 0.25), 2.0, 1.0)
    n = 64 - (len(origin) - 640)
    o = np.stack([rng.uniform(0, 8, n), rng.uniform(0.1, 2.0, n), rng.uniform(0, 8, n)], 1)
    d = rng.normal(size=(n, 3))
    d[:, 1] = -np.abs(d[:, 1]) - 0.5  # mostly down, onto the table
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for k in range(n):
        ray(tuple(o[k]), tuple(d[k]), float(rng.uniform(2.0, 8.0)))
    f32 = lambda a: np.asarray(a, np.float32)
    return rows, bounds, f32(origin), f32(direction), f32(max_dist), f32(expect)


def _k5_subpixel(rng, batch, height, width, t):
    """A table of sub-pixel triangles, as a far, finely tessellated model
    gives (the arena_orb sphere's triangles cover about a pixel each), for
    a frame of two tile columns (width 256, height 8 or more).

    Subchunks of 64 rows take turns across the whole table, both chunks
    alike: s % 3 == 0 holds rows clustered in the left half of tile column
    0, s % 3 == 1 only dead rows, s % 3 == 2 rows clustered in tile column
    1, which tile column 0's lists must leave out (and column 1's keep).
    Half of the rows of a live subchunk are live, at random places. Live
    rows are well-shaped triangles with a circumradius of 0.2-0.9 px (most
    cover no pixel centre or one; about 1,400 per tile over 512 pixels
    overlap one another) at z from 0.1 to 0.9; after every tenth live row
    comes its equal-z twin, which must lose every pixel to it. A third of
    the pixels exclude a live row whose bbox holds the pixel's centre."""
    assert width == 256 and height % 8 == 0
    trit = np.zeros((batch, 16, t), np.float32)
    exclude = np.full((batch, height, width), -1, np.int32)
    sub = np.arange(t) // 64 % 3
    for b in range(batch):
        live = (sub != 1) & (rng.random(t) < 0.5)
        cx = rng.uniform(4, 60, t) + np.where(sub == 2, 128.0, 0.0)
        cy = rng.uniform(0.5, height - 0.5, t)
        ang = rng.uniform(0, 2 * np.pi, (t, 1)) + np.arange(3) * (2 * np.pi / 3) + rng.uniform(-0.5, 0.5, (t, 3))
        rad = rng.uniform(0.2, 0.9, (t, 1)) * rng.uniform(0.7, 1.0, (t, 3))
        v = np.stack([cx, cy], -1)[:, None, :] + rad[..., None] * np.stack([np.cos(ang), np.sin(ang)], -1)
        z = rng.uniform(0.1, 0.9, (t, 1)) + rng.uniform(-0.01, 0.01, (t, 3))
        for k in np.nonzero(live)[0][5:-1:10]:  # equal-z twins
            v[k + 1], z[k + 1] = v[k], z[k]
            live[k + 1] = True
        v[~live] = rng.uniform(-1e3, 1e3, (int((~live).sum()), 3, 2))  # never read
        trit[b, 0:6] = v.reshape(t, 6).T
        trit[b, 6:9] = z.T
        box = np.stack([v[..., 0].min(1), v[..., 0].max(1), v[..., 1].min(1), v[..., 1].max(1)])
        trit[b, 10:14] = np.where(live, box, np.array([1e30, -1e30, 1e30, -1e30])[:, None])
        # exclude ids: for a third of the pixels, a live row whose bbox holds the centre
        gy, gx = np.nonzero(rng.random((height, width)) < 0.33)
        px, py = gx + 0.5, gy + 0.5
        holds = ((box[0] <= px[:, None]) & (box[1] >= px[:, None]) & (box[2] <= py[:, None])
                 & (box[3] >= py[:, None]) & live)
        for k in np.nonzero(holds.any(1))[0]:
            exclude[b, gy[k], gx[k]] = rng.choice(np.nonzero(holds[k])[0])
    return trit, exclude
