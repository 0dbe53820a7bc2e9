"""Virtual character controller of one env: capsule collide-and-slide
against the static world and the actor colliders (counterpart of
c_game_engine_tpu/physics/character.py).

Reproduces Jolt's CharacterVirtual as the reference configures it
(engine/src/physics/PlayerPhysics.c:173-194): capsule r = 0.2, cylinder
half height 0.25, mass 10, max slope 50 deg; ExtendedUpdate with
stick-to-floor 0.25 and stair step-up 0.25 (PlayerPhysics.c:439-453).
Instead of Jolt's swept shape casts it runs an iterative penetration
resolution (4 rounds) at 60 Hz, which converges to the same resting and
sliding behaviour at the game's speeds (6 m/s, 0.1 m a tick, well under
the capsule radius).

This is the readable single-env reference, plain PyTorch as the JAX
module is plain XLA: triangle candidates per call from the uniform grid
(physics/grid.py). The batched tick runs
physics/batched.py::update_character_batched through kernel K1, whose
candidate set is per 128-lane block.
"""

from __future__ import annotations

import torch

from refsim.actors.defs import Layer, Motion, Shape
from refsim.physics.geometry import (
    capsule_triangle_closest,
    closest_point_on_obb,
    closest_point_on_segment,
)
from refsim.physics.grid import query_cell
from refsim.utils.mathx import const, norm, quat_rotate, safe_normalize

CAPSULE_RADIUS = 0.2  # PlayerPhysics.c:176 (JPH_CapsuleShape_Create(0.2, 0.25))
CAPSULE_HALF_HEIGHT = 0.25
MAX_SLOPE_COS = 0.6427876097  # cos(50 deg), PlayerPhysics.c:42 MAX_WALKABLE_SLOPE
STEP_UP = 0.25  # walkStairsStepUp (PlayerPhysics.c:442)
STICK_DOWN = 0.25  # stickToFloorStepDown (PlayerPhysics.c:441)
CHARACTER_MASS = 10.0  # PlayerPhysics.c:184


def _capsule_segment(pos):
    off = const((0.0, CAPSULE_HALF_HEIGHT, 0.0), pos.device)
    return pos - off, pos + off


def _collect_contacts(cmap, actors, pos, exclude_actor):
    """Deepest-contact query of the player capsule at pos [3] against the
    grid cell's static triangles and the solid actor OBBs (`actors` leaves
    [N, ...]). Returns (depth [L+N], normal [L+N, 3]): one lane per
    candidate triangle, then one per actor."""
    s0, s1 = _capsule_segment(pos)

    # ---- static triangles (the grid cell's candidates)
    cand = query_cell(cmap, pos)  # [L]
    candc = torch.clamp_min(cand, 0).long()
    tri3 = cmap.tris[candc]
    a, b, c = tri3[:, 0], tri3[:, 1], tri3[:, 2]
    cand_ok = (cand >= 0) & cmap.tri_valid[candc]
    p_seg, q_tri = capsule_triangle_closest(s0.expand(a.shape), s1.expand(a.shape), a, b, c)
    delta = p_seg - q_tri
    dist = norm(delta)
    raw_n = safe_normalize(delta)
    # Orient the normal toward the capsule centre's side of the face: in
    # deep penetration the closest segment point crosses the plane and the
    # raw delta points into the triangle.
    face_n = cmap.tri_normal[candc]
    side = torch.sign(torch.sum((pos - a) * face_n, -1))
    side = torch.where(side == 0, 1.0, side)
    flip = torch.sign(torch.sum(raw_n * face_n, -1)) * side
    flip = torch.where(flip == 0, 1.0, flip)
    tri_normal = raw_n * flip[..., None]
    tri_normal = torch.where(dist[..., None] > 1e-6, tri_normal, face_n * side[..., None])
    # penetration along the oriented normal (signed: covers the
    # crossed-plane case, where dist alone underestimates)
    signed = torch.sum(delta * tri_normal, -1)
    tri_depth = torch.where(cand_ok, CAPSULE_RADIUS - signed, -torch.inf)

    # ---- solid actor boxes (doors, props, dynamic bodies)
    solid = (
        actors.active
        & (cmap.shape != int(Shape.EMPTY))
        & (cmap.motion != int(Motion.NONE))
        & (cmap.layer != int(Layer.SENSOR))
        & (torch.arange(cmap.num_actors, device=pos.device) != exclude_actor)
    )
    # closest points of the capsule segment and each OBB (alternating projection)
    box_ctr = actors.pos + quat_rotate(actors.quat, cmap.shape_center)
    q = closest_point_on_obb(pos, box_ctr, actors.quat, cmap.halfext)
    for _ in range(2):
        p = closest_point_on_segment(q, s0.expand(q.shape), s1.expand(q.shape))
        q = closest_point_on_obb(p, box_ctr, actors.quat, cmap.halfext)
    bdelta = p - q
    bdist = norm(bdelta)
    box_depth = torch.where(solid, CAPSULE_RADIUS - bdist, -torch.inf)
    box_normal = safe_normalize(bdelta)

    return torch.cat([tri_depth, box_depth], 0), torch.cat([tri_normal, box_normal], 0)


def resolve_capsule(cmap, actors, pos, vel, exclude_actor=-1, iters: int = 4):
    """Iterative penetration resolution and velocity clipping of one
    capsule, pos/vel [3]. Returns (pos, vel, on_ground, ground_normal)."""
    on_ground = torch.zeros((), dtype=torch.bool, device=pos.device)
    ground_n = const((0.0, 1.0, 0.0), pos.device)
    for _ in range(iters):
        depth, normal = _collect_contacts(cmap, actors, pos, exclude_actor)
        worst = torch.argmax(depth)  # the first deepest contact
        d = depth[worst]
        n = normal[worst]
        # contact tolerance: a contact within 1 cm of separation counts for
        # grounding and velocity clipping (Jolt's collision tolerance), but
        # only penetration moves the capsule
        hit = d > -0.01
        pos = torch.where(hit, pos + n * torch.clamp_min(d, 0.0), pos)
        # clip the velocity against the contact plane (slide)
        vn = torch.sum(vel * n)
        vel = torch.where(hit & (vn < 0), vel - n * vn, vel)
        walkable = hit & (n[1] >= MAX_SLOPE_COS)
        on_ground = on_ground | walkable
        ground_n = torch.where(walkable, n, ground_n)
    return pos, vel, on_ground, ground_n


def update_character(cmap, actors, pos, vel, dt, was_on_ground, jumping, noclip):
    """One CharacterVirtual_ExtendedUpdate-equivalent step of one env.

    Integrates the velocity, resolves collisions, then applies stair
    step-up and stick-to-floor. `noclip` skips all collision
    (OnContactValidate returns false under noclip, PlayerPhysics.c:98-101).
    Both results are computed and the noclip flag selects one, as in the
    JAX function. Returns (pos, vel, on_ground, ground_normal)."""
    dev = pos.device
    was_on_ground, jumping, noclip = (torch.as_tensor(x, device=dev) for x in (was_on_ground, jumping, noclip))
    new_pos = pos + vel * dt
    horiz = const((1.0, 0.0, 1.0), dev)

    p, v, grounded, gn = resolve_capsule(cmap, actors, new_pos, vel)

    # stair step-up: if the horizontal motion was blocked (its velocity got
    # clipped), resolve again from a lifted position
    h_in = norm(vel * horiz)
    h_out = norm(v * horiz)
    blocked = (h_in > 1e-4) & (h_out < 0.9 * h_in)
    p2, v2, grounded2, gn2 = resolve_capsule(cmap, actors, new_pos + const((0.0, STEP_UP, 0.0), dev), vel)
    h2 = norm(v2 * horiz)
    # take the step only where it kept the horizontal motion
    use_step = blocked & (h2 > h_out + 1e-4)
    p = torch.where(use_step, p2, p)
    v = torch.where(use_step, v2, v)
    grounded = torch.where(use_step, grounded2, grounded)
    gn = torch.where(use_step, gn2, gn)

    # stick-to-floor: grounded last tick and not moving up, snap down by up
    # to STICK_DOWN so walking down slopes and stairs keeps contact
    want_stick = was_on_ground & ~jumping & (v[1] <= 1e-4) & ~grounded
    p3, v3, grounded3, gn3 = resolve_capsule(cmap, actors, p + const((0.0, -STICK_DOWN, 0.0), dev), v)
    stick_ok = want_stick & grounded3
    p = torch.where(stick_ok, p3, p)
    v = torch.where(stick_ok, v3, v)
    grounded = grounded | stick_ok
    gn = torch.where(stick_ok, gn3, gn)

    return (
        torch.where(noclip, new_pos, p),
        torch.where(noclip, vel, v),
        torch.where(noclip, False, grounded),
        torch.where(noclip, const((0.0, 1.0, 0.0), dev), gn),
    )
