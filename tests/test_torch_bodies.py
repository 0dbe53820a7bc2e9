"""The port's rigid-body step and its contact kernel K3 against the JAX
package, on the CPU.

(a) K3's plain version (ops/body_contacts.py) against the Pallas kernel
    body_contacts_pallas in TPU interpret mode on the arena's triangles,
    with box and hull bodies, awake, off and padded lanes, and lanes built
    to tie within a chunk and across chunks: 1e-5, tie order exact; and on
    a small table of exact ties (tests/torch_inputs.py::k3_tie_inputs:
    eight equal rows over one chunk's rows, an invalid one among them,
    and an equal pair across two chunks), bit for bit.
(b) physics/bodies.py::step_bodies_batched against the JAX function with
    _use_pallas() forced on and K3 in interpret mode, so both take the same
    per-block candidate sets: one call from each of a few states (a mixed
    batch of falling, resting, sliding, pushed and held bodies; everything
    asleep; a lone awake body with no pair): 1e-4 on poses and velocities,
    sleep counters and warm keys exact. The one departure (ROADMAP.md §3 i):
    the mixed batch's frozen lanes 6-7 keep their pair warm cache, where
    the JAX package's batch-global gate re-keys it because lanes 0-5 are
    active; those two leaves of lanes 6-7 are held at the same bars to the
    JAX package stepping the frozen lanes as a batch of their own, and a
    second tick, with lanes 6-7 woken onto a warm cache with an entry the
    JAX re-key drops, holds every leaf of every lane to the JAX package's
    second tick.
(c) a rollout of `arena_bodies` at B=128 on one stream (bench.py's, with
    a pick-up, carry and drop of a physbox) against the JAX XLA rollout,
    checked at the drop and at the end: the bars of
    tests/test_tpu_parity.py (player position 2e-3, on_ground exact, actor
    position and quaternion 5e-3), every other float leaf 5e-3 and every
    integer leaf (sleep counters, warm keys, ...) exact.
(d) the behaviour contracts of tests/test_stacking.py and
    tests/test_hulls.py::test_npc_john_cylinder_rest on the port alone,
    from one shared rollout of a box room holding a 3-box stack, a 4-box
    stack and an npc_john (physboxes through the stub resolver). The
    3-box stack stands at (4, 3), not at test_stacking.py's (4, 4): that
    spot is on the shared diagonal edge of the room's two floor triangles,
    where the drop's contact jolts grow any last-bit difference about 100x
    a tick, and whether the top box ends asleep or in a chatter limit cycle
    turns on those bits; from one state the port and the JAX kernel path
    agree to 1e-7 tick by tick in either regime
    (tests/torch_stack_divergence.py shows both).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.torch_inputs import K3_TIE_ROWS, K3_TIE_X, TIE_X, k3_tie_inputs
from tests.torch_inputs import k3_inputs as _k3_inputs
from tests.torch_parity import (
    assert_leaves_match,
    export_and_load,
    jax_actions,
    jax_leaves,
    torch_actions,
    torch_leaves,
)

DT = 1.0 / 60.0


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


# ----------------------------------------------------------------- (a) K3


@pytest.fixture(scope="module")
def arena(tmp_path_factory):
    from tests.torch_export_map import compile_arena

    return export_and_load(compile_arena(), tmp_path_factory.mktemp("arena"))


def test_body_contacts_matches_pallas_kernel(arena):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from c_game_engine_tpu.ops.body_contacts import body_contacts_pallas
    from c_game_engine_tpu_torch.ops import body_contacts as k3

    tri16, cb, body, margin, verts, is_box = _k3_inputs(arena)
    with pltpu.force_tpu_interpret_mode():
        oj = np.asarray(body_contacts_pallas(jnp.asarray(tri16), jnp.asarray(cb), jnp.asarray(body), 4,
                                             jnp.asarray(margin), verts=jnp.asarray(verts), is_box=is_box))
    before = k3.launches
    ot = k3.body_contacts(*(torch.as_tensor(a) for a in (tri16, cb, body, margin, verts)),
                          torch.tensor(is_box)).numpy()
    assert k3.launches == before  # CPU tensors take the plain version
    assert ot.shape == oj.shape == (8, 16, 256)
    np.testing.assert_allclose(ot, oj, atol=1e-5, rtol=0)

    comp = lambda c: oj[c].reshape(4, 4, 256).transpose(0, 2, 1)  # [D, B, K]
    depth, on = comp(0), body[10] > 0.5
    assert (depth[on][:, 0] > -1e29).all()
    # off and padded lanes keep the initial buffer
    assert (depth[~on] == -1e30).all() and (comp(2)[~on] == 1.0).all()
    # the tie lanes: slots 2 and 3 hold two of four equal-depth contacts at
    # different points, in the kernel's visiting order
    px, pz = comp(4)[0, :16], comp(6)[0, :16]
    assert (depth[0, :16, 2] == depth[0, :16, 3]).all()
    assert ((px[:, 2] != px[:, 3]) | (pz[:, 2] != pz[:, 3])).all()
    # the two-level tie: the three floors, then E2 (x - 0.3), not E1
    tie = comp(5)[0, 128:200], comp(4)[0, 128:200]
    assert (tie[0][:, :3] == np.float32([0.03, 0.02, 0.01])).all()
    assert (tie[1][:, 3] < TIE_X).all() and (depth[0, 128:200, 3] > -0.1).all()
    # box and hull bodies all touch something
    assert all((depth[k][on[k]][:, 0] > -0.3).any() for k in range(4))


def test_body_contacts_tie_rows_match_pallas_kernel():
    """Equal depths spread over one chunk's rows keep the first four by row
    (an invalid row among them stays out); an equal pair across chunks
    keeps list order: the same as the Pallas kernel, bit for bit."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from c_game_engine_tpu.ops.body_contacts import body_contacts_pallas
    from c_game_engine_tpu_torch.ops import body_contacts as k3

    tri16, cb, body, margin, verts, is_box = k3_tie_inputs()
    with pltpu.force_tpu_interpret_mode():
        oj = np.asarray(body_contacts_pallas(jnp.asarray(tri16), jnp.asarray(cb), jnp.asarray(body), 1,
                                             jnp.asarray(margin), verts=jnp.asarray(verts), is_box=is_box))
    ot = k3.body_contacts(*(torch.as_tensor(a) for a in (tri16, cb, body, margin, verts)),
                          torch.tensor(is_box)).numpy()
    np.testing.assert_array_equal(ot, oj)

    on = body[10, 0] > 0.5
    a, b = on & (np.arange(256) < 128), on & (np.arange(256) >= 128)
    depth, px, py, pz = ot[0], ot[4], ot[5], ot[6]  # [K, B]
    assert (depth[:, a] == depth[0, a]).all() and (depth[0, a] > 0.1).all()
    # block 0: rows 2, 6, 9 and 17 of chunk 0, in that order
    vertex = lambda r: tri16[r, 0:3]
    for s_, r in enumerate(K3_TIE_ROWS[:3] + K3_TIE_ROWS[4:5]):
        assert (np.stack([px[s_, a], py[s_, a], pz[s_, a]], 1) == vertex(r)).all()
    # block 1: X (chunk 1 row 28), then its equal Y (chunk 2 row 1), then D
    for s_, r in enumerate((32 + 28, 64 + 1, 64 + 5)):
        assert (np.stack([px[s_, b], py[s_, b], pz[s_, b]], 1) == vertex(r)).all()
    assert (depth[0, b] == depth[1, b]).all() and (depth[2, b] < depth[1, b]).all()
    assert (depth[3, b] == -1e30).all() and (depth[:, ~on] == -1e30).all()
    assert (px[0, b] > K3_TIE_X[1]).all() and (px[1, b] < K3_TIE_X[1]).all()


def test_body_contacts_checks_inputs(arena):
    from c_game_engine_tpu_torch.ops import body_contacts as k3

    tri16, cb, body, margin, verts = (torch.as_tensor(a) for a in _k3_inputs(arena)[:5])
    is_box = torch.tensor([True, True, False, False])
    with pytest.raises(ValueError, match="multiple of 128"):
        k3.body_contacts(tri16, cb, body[:, :, :100], margin, verts, is_box)
    with pytest.raises(ValueError, match="bool"):
        k3.body_contacts(tri16, cb, body, margin, verts, is_box.int())
    with pytest.raises(ValueError, match="no body-contact kernel"):
        k3.body_contacts(*(a.to("meta") for a in (tri16, cb, body, margin, verts, is_box)))


# ------------------------------------------------ (b) step_bodies_batched


def _ramp_tris():
    """A 1-in-4 ramp rising toward +x over x in [2, 6], z in [-6, -2] of
    the box room, face normal up-and-toward -x."""
    from tests.worldgen import box_room

    a, b, c, d = (2.0, -1.0, -6.0), (2.0, -1.0, -2.0), (6.0, 0.0, -2.0), (6.0, 0.0, -6.0)
    return np.concatenate([box_room(), np.array([[a, b, c], [a, c, d]], np.float32)])


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A box room with a ramp: a 2-box stack, a box on the ramp and an
    npc_john (4 dynamic slots). Returns (jax map, port map, body rows)."""
    from tests.torch_export_map import make_stub_map
    from tests.worldgen import actor

    jc = make_stub_map(
        [actor("prop_physbox", (1.0, -0.7, 1.0)), actor("prop_physbox", (1.0, -0.25, 1.0)),
         actor("prop_physbox", (4.0, -0.1, -4.0)), actor("npc_john", (-3.0, -0.3, -3.0))],
        tris=_ramp_tris(), spawn=(0.0, 0.0, -4.0),
    )
    rows = [i for i, c in enumerate(jc.aux["actor_classes"]) if c in ("PHYSBOX", "NPC_JOHN")]
    return jc, export_and_load(jc, tmp_path_factory.mktemp("small")), rows


def _scenarios(jc, rows):
    """Three numpy states of 8 envs each (see the module docstring (b))."""
    import math

    from c_game_engine_tpu.models.sim import reset_batch as j_reset

    st = _np(j_reset(jc, 8))
    a, p = st.actors, st.player
    pos, quat, vel, omega = (np.array(x) for x in (a.pos, a.quat, a.vel, a.omega))
    sleep, warm_n = np.array(a.sleep), np.array(a.warm_n)
    ppos, pvel = np.array(p.pos), np.array(p.vel)
    s0, s1, rb, jn = rows
    th = math.atan(0.25)  # the ramp's slope
    n_ramp = np.array([-math.sin(th), math.cos(th), 0.0])
    # lanes 1-7: the stack at rest with warm impulses, the john standing;
    # lane 0 keeps the drop from the compiled poses
    rest = dict(pos={s0: (1.0, -0.802, 1.0), s1: (1.0, -0.407, 1.0), jn: (-3.0, -0.502, -3.0),
                     rb: tuple(np.array([4.0, -0.5, -4.0]) + 0.198 * n_ramp)})
    for lane in range(1, 8):
        for r, xyz in rest["pos"].items():
            pos[lane, r] = xyz
        quat[lane, rb] = (0.0, 0.0, math.sin(th / 2), math.cos(th / 2))
        sleep[lane, rows] = 12
        warm_n[lane, s0] = 1.5
    vel[2, rb] = -1.5 * np.array([math.cos(th), math.sin(th), 0.0])  # sliding down the ramp
    ppos[3], pvel[3] = (0.7, -0.78, 1.0), (6.0, 0.0, 0.0)  # the player walks into the stack
    pos[4, rb], vel[4, rb] = (0.0, 0.2, 0.0), (3.0, 1.0, -2.0)  # held: the spring's velocity
    quat[4, rb] = (0.0, math.sin(0.3), 0.0, math.cos(0.3))
    vel[5, jn], omega[5, jn] = (2.0, 0.0, 0.5), (0.0, 1.0, 0.0)  # the john shoved
    sleep[6:, rows] = 30  # frozen lanes inside an active batch
    mixed = st.replace(actors=a.replace(pos=pos, quat=quat, vel=vel, omega=omega, sleep=sleep,
                                        warm_n=warm_n),
                       player=p.replace(pos=ppos, vel=pvel))
    # every body asleep at rest: the idle branch
    rest_pos, rest_quat = np.repeat(pos[1:2], 8, 0), np.repeat(quat[1:2], 8, 0)
    asleep = st.replace(actors=a.replace(pos=rest_pos, quat=rest_quat, sleep=np.full_like(sleep, 30),
                                         warm_n=np.repeat(warm_n[1:2], 8, 0)))
    # only the john awake and touching no body: the pair gate stays shut
    lone_sleep = np.full_like(sleep, 30)
    lone_sleep[:, jn] = 0
    lone_vel = np.zeros_like(vel)
    lone_vel[:, jn] = (0.5, 0.0, 0.0)
    lone = asleep.replace(actors=asleep.actors.replace(sleep=lone_sleep, vel=lone_vel))
    return {"mixed": mixed, "asleep": asleep, "lone": lone}


NAMES = ("pos", "quat", "vel", "omega", "sleep", "warm_n", "warm_pair", "warm_pair_idx")
FROZEN = [6, 7]  # the mixed batch's frozen lanes


@pytest.fixture(scope="module")
def steps(small):
    """(jax_step, port_step): one rigid-body step of a numpy state on each
    side, as numpy leaves in NAMES order. The JAX one runs with K3 in
    interpret mode; the calling test forces _use_pallas on, so both sides
    take the same per-block candidate sets."""
    import jax
    from jax.experimental.pallas import tpu as pltpu

    import c_game_engine_tpu.physics.batched as jb
    from c_game_engine_tpu_torch.core.state import state_from_numpy
    from c_game_engine_tpu_torch.physics import bodies

    jc, tc, _ = small
    f = jax.jit(lambda a, pp, pv: jb.step_bodies_batched(jc, a, pp, pv, DT))

    def jax_step(st):
        with pltpu.force_tpu_interpret_mode():
            return [np.asarray(x) for x in f(st.actors, st.player.pos, st.player.vel)]

    def port_step(st):
        ts = state_from_numpy(st, tc)
        return [x.numpy() for x in bodies.step_bodies_batched(tc, ts.actors, ts.player.pos, ts.player.vel, DT)]

    return jax_step, port_step


def _hold(name, P, J, lanes=slice(None), keys=NAMES):
    """The port's leaves P against the JAX package's J on `lanes`: sleep
    counters and warm keys exact, every other leaf 1e-4."""
    for k, j, p in zip(NAMES, J, P):
        if k not in keys:
            continue
        assert p.dtype == j.dtype and p.shape == j.shape, (name, k)
        p, j = p[lanes], j[lanes]
        if k in ("sleep", "warm_pair_idx"):
            np.testing.assert_array_equal(p, j, err_msg=f"{name} {k}")
        else:
            np.testing.assert_allclose(p, j, atol=1e-4, rtol=0, err_msg=f"{name} {k}")


def _lanes(st, idx):
    import jax

    return jax.tree.map(lambda x: x[idx], st)


def test_step_bodies_matches_pallas_path(small, steps, monkeypatch):
    import c_game_engine_tpu.physics.batched as jb
    from c_game_engine_tpu_torch.physics import bodies

    jc, _, rows = small
    jax_step, port_step = steps
    monkeypatch.setattr(jb, "_use_pallas", lambda: True)
    opened = []
    for name, st in _scenarios(jc, rows).items():
        J = jax_step(st)
        before = bodies.active_ticks
        P = port_step(st)
        opened.append(bodies.active_ticks - before)
        if name != "mixed":
            _hold(name, P, J)
            continue
        active = [k for k in range(8) if k not in FROZEN]
        _hold(name, P, J, lanes=active)
        _hold(name, P, J, keys=NAMES[:6])
        # the frozen lanes have no live pair: the port keeps their pair
        # cache, as the JAX package does for them in a batch of their own
        # (a shard of frozen lanes), where its batch-global gate re-keys it
        # because lanes 0-5 are active
        alone = jax_step(_lanes(st, FROZEN * 4))
        _hold(f"{name} frozen lanes alone", [p[FROZEN] for p in P], [a[:2] for a in alone])
        assert (J[7][FROZEN] != st.actors.warm_pair_idx[FROZEN]).any()
        if name == "mixed":
            moved = np.abs(J[0] - st.actors.pos)[:, rows].max(-1)
            # the falling, sliding, pushed, held and shoved lanes moved; the
            # resting lane barely; the frozen lanes not at all
            assert (moved[[0, 2, 3, 4, 5]] > 1e-3).any(-1).all() and (moved[1] < 1e-3).all()
            assert (moved[6:] == 0).all()
            assert (J[7] >= 0).any()  # pair slots were matched and written
    assert opened == [1, 0, 1]  # the body gate: open, shut (idle branch), open


def test_frozen_lanes_wake_like_jax(small, steps, monkeypatch):
    """The tick on which the port and the JAX package part in the frozen
    lanes' pair cache (the port keeps it; the JAX package re-keys it onto
    the lanes' pair candidates because other lanes are active), then a
    tick with lanes 6-7 woken, each side from its own state: every leaf of
    every lane meets the parity test's bars, the pair caches included.
    The frozen lanes start on a warm cache: lane 1's (the same stack at
    rest) after one JAX tick, plus one entry whose key is no candidate of
    theirs, which the JAX re-key drops and the port keeps."""
    import c_game_engine_tpu.physics.batched as jb

    jc, _, rows = small
    jax_step, port_step = steps
    monkeypatch.setattr(jb, "_use_pallas", lambda: True)
    st = _scenarios(jc, rows)["mixed"]
    warm, keys = (x[1] for x in jax_step(st)[6:])
    live = int((keys >= 0).sum())
    assert 0 < live < keys.shape[0] and (warm[:live] != 0).any()
    stale = next(k for k in range(jc.dyn_slots.shape[0] * jc.num_actors) if k not in keys)
    wp, wpi = np.array(st.actors.warm_pair), np.array(st.actors.warm_pair_idx)
    wp[FROZEN], wpi[FROZEN] = warm, keys
    wp[FROZEN, live], wpi[FROZEN, live] = 0.75, stale
    st = st.replace(actors=st.actors.replace(warm_pair=wp, warm_pair_idx=wpi))

    J1, P1 = jax_step(st), port_step(st)
    _hold("divergent tick", P1, J1, keys=NAMES[:6])
    np.testing.assert_array_equal(P1[7][FROZEN], wpi[FROZEN])
    np.testing.assert_array_equal(J1[7][FROZEN, :live], wpi[FROZEN, :live])
    assert (J1[7][FROZEN, live] == -1).all()  # the JAX re-key dropped the stale entry

    def woken(L):
        sleep = L[4].copy()
        sleep[np.ix_(FROZEN, rows)] = 0
        return st.replace(actors=st.actors.replace(**dict(zip(NAMES, [*L[:4], sleep, *L[5:]]))))

    J2, P2 = jax_step(woken(J1)), port_step(woken(P1))
    _hold("woken tick", P2, J2)
    # the woken lanes solved their pairs from the warm cache
    assert (J2[6][FROZEN, :live] != J1[6][FROZEN, :live]).any()


# ------------------------------------------------ (c) arena_bodies rollout

ROLL_B, ROLL_T = 128, 30
# the bench.py stream (hold W, yaw += 0.01 rad per tick), plus: look down
# at tick 0, pick up the physbox ahead of the spawn at tick 8 (it is then
# under 1 m away), look up at tick 12 and carry it, drop it at tick 22
PICK_UP, LOOK_UP, DROP = 8, 12, 22


def pickup_stream(ticks, batch):
    from tests.torch_parity import INTERACT

    move = np.zeros((ticks, batch, 2), np.float32)
    look = np.zeros((ticks, batch, 2), np.float32)
    btn = np.zeros((ticks, batch, 10), bool)
    move[..., 1] = -1.0
    look[..., 0] = 0.01
    look[0, :, 1], look[LOOK_UP, :, 1] = -0.6, 0.6
    btn[[PICK_UP, DROP], :, INTERACT] = True
    return move, look, btn


def test_arena_bodies_rollout_matches_jax(tmp_path):
    """(c), with a pick-up: the held-body spring, the character ignoring the
    held body (exclude_idx) and the drop (can_drop_held) on a dynamic
    physbox, against the JAX package's tick."""
    import jax

    from c_game_engine_tpu.core.step import step_batch as j_step
    from c_game_engine_tpu.models.sim import reset_batch as j_reset
    from c_game_engine_tpu_torch.models.sim import reset_batch, rollout
    from c_game_engine_tpu_torch.physics import bodies
    from tests.torch_export_map import compile_arena_bodies

    jc = compile_arena_bodies()
    tc = export_and_load(jc, tmp_path)
    rows = [i for i, c in enumerate(jc.aux["actor_classes"]) if c in ("PHYSBOX", "NPC_JOHN")]
    assert len(rows) == 13
    box = rows[-1]  # the physbox ahead of the spawn
    stream = pickup_stream(ROLL_T, ROLL_B)
    j_tick = jax.jit(lambda s, a: j_step(jc, s, a))

    def j_roll(s, acts):
        for t in range(acts.move.shape[0]):
            s = j_tick(s, jax.tree.map(lambda x: x[t], acts))
        return s

    js = j_roll(j_reset(jc, ROLL_B), jax_actions(*(a[:DROP] for a in stream)))
    before = bodies.active_ticks
    ts = rollout(tc, reset_batch(tc, ROLL_B), torch_actions(*(a[:DROP] for a in stream)))
    assert int(ts.player.held_actor[0]) == box  # carried into the drop tick
    assert_leaves_match(jax_leaves(js), torch_leaves(ts), {"player.pos": 2e-3})
    js = j_roll(js, jax_actions(*(a[DROP:] for a in stream)))
    ts = rollout(tc, ts, torch_actions(*(a[DROP:] for a in stream)))
    assert bodies.active_ticks - before == ROLL_T  # bodies fall and move: the gate opens every tick
    J, P = jax_leaves(js), torch_leaves(ts)
    assert_leaves_match(J, P, {"player.pos": 2e-3})
    assert int(ts.player.held_actor[0]) == -1  # dropped
    lifted = J["actors.pos"][0, box, 1] - np.asarray(jc.init_pos)[box, 1]
    assert lifted > 0.1  # carried up to the view height, still falling
    fell = J["actors.pos"][0, rows, 1] - np.asarray(jc.init_pos)[rows, 1]
    assert (fell < -0.05).sum() >= 9  # the stacks, the ramp drops and the johns came down


# --------------------------------------------- (d) behaviour contracts


@pytest.fixture(scope="module")
def contracts(tmp_path_factory):
    """One rollout of the port's rigid-body step on a box room (floor at
    y = -1) holding the 3-box stack of tests/test_stacking.py at (4, 3), its
    4-box stack at (-4, 4) and the npc_john of tests/test_hulls.py. The
    bodies are driven through physics/bodies.py::step_bodies_batched with
    the player standing still at the spawn, 5+ m away: the rest of the tick
    never touches these bodies (no behaviour of PHYSBOX or NPC_JOHN, no held
    body, no wake from a still player), so their motion is the tick's.
    Snapshots at ticks 120, 240, 300 and 540, and a branch off tick 120
    where the 3-stack's bottom box is kicked at 2 m/s along +x for 6 ticks
    (as the reference test does)."""
    from c_game_engine_tpu_torch.models.sim import reset_batch
    from c_game_engine_tpu_torch.physics.bodies import step_bodies_batched
    from tests.torch_export_map import make_stub_map
    from tests.worldgen import actor

    jc = make_stub_map(
        [actor("prop_physbox", (4.0, -0.7 + 0.45 * i, 3.0)) for i in range(3)]
        + [actor("prop_physbox", (-4.0, -0.7 + 0.45 * i, 4.0)) for i in range(4)]
        + [actor("npc_john", (2.0, -0.4, 2.0))],
        spawn=(0.0, 0.0, -4.0),
    )
    tc = export_and_load(jc, tmp_path_factory.mktemp("contracts"))
    classes = jc.aux["actor_classes"]
    boxes = [i for i, c in enumerate(classes) if c == "PHYSBOX"]
    rows = {"stack3": boxes[:3], "stack4": boxes[3:], "john": [classes.index("NPC_JOHN")]}
    st = reset_batch(tc, 1)
    pp, pv = st.player.pos, st.player.vel

    def run(a, ticks):
        for _ in range(ticks):
            pos, quat, vel, omega, sleep, wn, wp, wpi = step_bodies_batched(tc, a, pp, pv, DT)
            a = a.replace(pos=pos, quat=quat, vel=vel, omega=omega, sleep=sleep, warm_n=wn,
                          warm_pair=wp, warm_pair_idx=wpi)
        return a

    snaps, a = {}, st.actors
    for t, ticks in ((120, 120), (240, 120), (300, 60), (540, 240)):
        a = run(a, ticks)
        snaps[t] = a
    a = snaps[120]
    bottom = min(rows["stack3"], key=lambda i: float(a.pos[0, i, 1]))
    kicked = a.replace(vel=a.vel.clone(), sleep=a.sleep.clone())
    kicked.vel[0, bottom] = torch.tensor([2.0, 0.0, 0.0])
    kicked.sleep[0, bottom] = 0
    snaps["kick"] = run(kicked, 6)
    return snaps, rows, bottom


def _ys(a, rows):
    return sorted(float(a.pos[0, i, 1]) for i in rows)


def test_port_stack_settles_and_rests(contracts):
    """tests/test_stacking.py::test_stack_settles_and_rests."""
    snaps, rows, _ = contracts
    a = snaps[240]
    ys = _ys(a, rows["stack3"])
    assert abs(ys[0] - (-0.8)) < 0.05, ys
    assert 0.3 < ys[1] - ys[0] < 0.5 and 0.3 < ys[2] - ys[1] < 0.5, ys
    for i in rows["stack3"]:
        p = a.pos[0, i].numpy()
        assert abs(p[0] - 4.0) < 0.5 and abs(p[2] - 3.0) < 0.5, p
        assert float(torch.linalg.norm(a.vel[0, i])) < 0.2


def test_port_stack_sleeps_and_wakes(contracts):
    """tests/test_stacking.py::test_stack_reaches_whole_stack_sleep_and_wakes
    (and :test_stack_survives_long_run): whole-stack sleep within 120
    ticks, no drift over the next 300, and a kick to the bottom box wakes
    the whole stack within 6 ticks and moves it. The reference asks for
    0.05 m of travel with the real cube model; with the stub cube the JAX
    tick itself moves it 0.0475 m on this map (tests/torch_stack_divergence.py),
    so the bar here is 0.04 m."""
    from c_game_engine_tpu_torch.physics.bodies import SLEEP_AFTER

    snaps, rows, bottom = contracts
    assert all(int(snaps[120].sleep[0, i]) >= SLEEP_AFTER for i in rows["stack3"])
    for y0, y1 in zip(_ys(snaps[240], rows["stack3"]), _ys(snaps[540], rows["stack3"])):
        assert abs(y1 - y0) < 0.08
    k = snaps["kick"]
    assert all(int(k.sleep[0, i]) < SLEEP_AFTER for i in rows["stack3"]), k.sleep[0]
    assert float(k.pos[0, bottom, 0]) > 4.04


def test_port_four_box_stack_holds_with_warm_start(contracts):
    """tests/test_stacking.py::test_four_box_stack_holds_with_warm_start."""
    from c_game_engine_tpu_torch.physics.bodies import SLEEP_AFTER

    snaps, rows, _ = contracts
    a = snaps[240]
    ys = _ys(a, rows["stack4"])
    assert abs(ys[0] - (-0.8)) < 0.05, ys
    for lo, hi in zip(ys, ys[1:]):
        assert 0.37 < hi - lo < 0.43, ys
    for i in rows["stack4"]:
        p = a.pos[0, i].numpy()
        assert abs(p[0] + 4.0) < 0.3 and abs(p[2] - 4.0) < 0.3, p
        assert float(torch.linalg.norm(a.vel[0, i])) < 0.05
        assert int(a.sleep[0, i]) >= SLEEP_AFTER
    later = snaps[540]
    for i in rows["stack4"]:
        assert abs(float(later.pos[0, i, 1]) - float(a.pos[0, i, 1])) < 0.01
        assert int(later.sleep[0, i]) >= SLEEP_AFTER


def test_port_npc_john_rests(contracts):
    """tests/test_hulls.py::test_npc_john_cylinder_rest: the cylinder rests
    on its bottom ring (y -0.5), not on a box corner."""
    snaps, rows, _ = contracts
    assert abs(float(snaps[300].pos[0, rows["john"][0], 1]) - (-0.5)) < 0.04
