"""The fixed-timestep tick: `step_batch(cmap, state, actions)` over [B] envs
(counterpart of c_game_engine_tpu/core/step.py; stage order and reference
citations there).

The JAX tick vmaps the per-env gameplay logic; here every stage is written
with the batch axis explicit. Its `lax.cond` gates (sound-op drain,
channel advance, and in physics/ stick to floor, body and pair activity)
go through core/gates.py. Every constant the tick needs is built once per
(map, device) (`CompiledMap.laser_idx`, `mathx.const`), so a tick copies
nothing from the host and can be captured as a CUDA graph
(models/graph.py).

delta is fixed at 1.0 tick (60 TPS); dt = 1/60 s.
"""

from __future__ import annotations

import math

import torch

from refsim.actors import behaviors, signals
from refsim.actors.defs import ActorClass, ActorFlags, Input, LaserHeight, Output, ParamType
from refsim.actors.handlers import remove_actors as _remove_actors_b
from refsim.actors.handlers import set_col
from refsim.core.actions import Actions, Button
from refsim.core import gates
from refsim.core.state import EVENT_CAPACITY, Crosshair, EnvState, tree_leaves, tree_map
from refsim.physics import batched, bodies
from refsim.physics import geometry_soa as gsoa
from refsim.physics.character import CAPSULE_HALF_HEIGHT, CAPSULE_RADIUS
from refsim.utils.mathx import (
    const,
    norm,
    quat_from_axis_angle,
    quat_lerp,
    quat_normalize,
    quat_rotate,
    remap,
)

TPS = 60.0
DT = 1.0 / TPS
MOVE_SPEED = 6.0  # PlayerPhysics.c:40
SLOW_MOVE_SPEED = 0.6  # PlayerPhysics.c:41
JUMP_SPEED = 4.25  # PlayerPhysics.c:43
GRAVITY = -9.81  # Physics.h:34
ACTOR_RAYCAST_MAX_DISTANCE = 10.0  # PlayerPhysics.c:44
HELD_OFFSET = 1.0  # PlayerPhysics.c:45
HELD_SMOOTH = 17.5  # PlayerPhysics.c:47
HELD_MAX_DIST_SQ = 6.0  # PlayerPhysics.c:48
NUM_ITEMS = 2  # eraser, laser stopper


def _push_event(events, do_push, target, input_id, ptype=int(ParamType.NONE)):
    """Append one event per env ([B, Q] queue) under the flag do_push [B]."""
    dev = events.count.device
    slot = torch.clamp(events.count, 0, EVENT_CAPACITY - 1)
    ok = do_push & (events.count < EVENT_CAPACITY)
    hot = ok[:, None] & (torch.arange(EVENT_CAPACITY, device=dev) == slot[:, None])  # [B, Q]
    put = lambda buf, new: torch.where(hot, new[..., None] if isinstance(new, torch.Tensor) else new, buf)
    return events.replace(
        target=put(events.target, target).int(),
        input=put(events.input, input_id).int(),
        ptype=put(events.ptype, ptype).int(),
        count=events.count + ok.int(),
        dropped=events.dropped + (do_push & ~ok).int(),
    )


def _forward_xyz(yaw, pitch):
    """Player/camera forward (-Z at yaw 0), batched [B]."""
    cp = torch.cos(pitch)
    return torch.stack([-torch.sin(yaw) * cp, torch.sin(pitch), -torch.cos(yaw) * cp], -1)


def _row_pick(onehot, table):
    """Per-env row of a per-actor table via a dense one-hot [B, N]."""
    return torch.where(onehot, table[None, :], 0).sum(1)


def step_batch(cmap, state: EnvState, actions: Actions) -> EnvState:
    n = cmap.num_actors
    dev = cmap.device
    B = state.tick.shape[0]
    delta = 1.0
    p = state.player
    btn = actions.buttons  # [B, K]
    rows = torch.arange(n, device=dev)
    fired, fired_pi = signals.empty_fired(B, n, dev)
    up = const((0.0, 0.25, 0.0), dev)  # camera y offset

    # ------------------------------------------------- toggles (UpdatePlayer)
    freecam = p.freecam ^ (btn[:, Button.FREECAM] & ~p.noclip)
    noclip = p.noclip ^ (btn[:, Button.NOCLIP] & ~freecam)
    allow = state.camera_actor < 0

    # ---------------------------------------- camera look (UpdatePlayerCamera)
    yaw = p.yaw + torch.where(allow, actions.look[:, 0], 0.0)
    pitch = torch.clamp(p.pitch + torch.where(allow, actions.look[:, 1], 0.0), -math.pi / 2, math.pi / 2)

    # ------------------------------------------------- MovePlayer velocity
    move = actions.move * torch.where(allow, 1.0, 0.0)[:, None]
    mlen = norm(move)
    mdir = torch.where((mlen > 1e-6)[:, None], move / torch.clamp_min(mlen, 1e-6)[:, None], 0.0)
    speed = torch.where(
        btn[:, Button.SLOW] & allow,
        SLOW_MOVE_SPEED,
        torch.where((freecam | noclip) & btn[:, Button.SPRINT], MOVE_SPEED * 2, MOVE_SPEED),
    )
    has_move = mlen > 1e-6
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    zeros = torch.zeros(B, device=dev)
    flat = torch.stack(
        [mdir[:, 0] * cy + mdir[:, 1] * sy, zeros, -mdir[:, 0] * sy + mdir[:, 1] * cy], -1
    )
    look_fwd = _forward_xyz(yaw, pitch)
    look_right = torch.stack([cy, zeros, -sy], -1)
    full = look_right * mdir[:, 0:1] + (-look_fwd) * mdir[:, 1:2]
    move_vec = torch.where((freecam | noclip)[:, None], full, flat) * (speed * has_move)[:, None]

    airborne = ~(noclip | p.on_ground)
    vel_y = torch.where(
        airborne,
        move_vec[:, 1] + p.vel[:, 1] + GRAVITY * (delta / TPS),
        torch.where(btn[:, Button.JUMP] & allow & ~freecam, JUMP_SPEED, move_vec[:, 1]),
    )
    vel = torch.stack([move_vec[:, 0], vel_y, move_vec[:, 2]], -1)

    freecam_pos = torch.where(freecam[:, None], p.freecam_pos + move_vec * (delta / TPS), p.pos + up)

    # ------------------- interaction raycast + laser beams, one K2 launch
    cam_pos = p.pos + up
    ray_dir = _forward_xyz(yaw, pitch)
    l_of = cmap.laser_idx
    L = len(l_of)
    if L:
        lorig = state.actors.pos[:, l_of]  # [B, L, 3]
        lquat = state.actors.quat[:, l_of].reshape(B * L, 4)
        ldirs = quat_rotate(lquat, const((0.0, 0.0, -1.0), dev).expand(B * L, 3)).reshape(B, L, 3)
        # kind-major layout: all interact rays, then each laser's rays, so
        # each 128-ray block stays spatially tight
        origins = torch.cat([cam_pos, lorig.transpose(0, 1).reshape(L * B, 3)], 0)
        dirs = torch.cat([ray_dir, ldirs.transpose(0, 1).reshape(L * B, 3)], 0)
        by_kind = lambda head, rest: torch.cat([head.expand(B), rest.repeat_interleave(B)])
        maxd = by_kind(const((ACTOR_RAYCAST_MAX_DISTANCE,), dev), torch.full((L,), 50.0, device=dev))
        excl = by_kind(const((-1,), dev, torch.int32), cmap.siparams[l_of, 1].int())
        rfl = by_kind(
            const((0,), dev, torch.int32),
            torch.full((L,), int(ActorFlags.CAN_BLOCK_LASERS), dtype=torch.int32, device=dev),
        )
        # triple lasers hit only the static world (Laser.c:64-72)
        trip = cmap.siparams[l_of, 0] == int(LaserHeight.TRIPLE)
        stat = by_kind(const((False,), dev, torch.bool), trip)
        mhit, mfrac, mact = batched.cast_rays_batched(
            cmap, state.actors, origins, dirs, maxd, exclude=excl, require_flags=rfl,
            B_env=B, static_only=stat, layout="kind_major",
        )
        mhit, mfrac, mact = (x.reshape(L + 1, B).T for x in (mhit, mfrac, mact))
        hit, frac, hit_actor = mhit[:, 0], mfrac[:, 0], mact[:, 0]
        laser_hit_rays, laser_frac_rays = mhit[:, 1:], mfrac[:, 1:]
    else:
        hit, frac, hit_actor = batched.cast_rays_batched(
            cmap, state.actors, cam_pos, ray_dir, ACTOR_RAYCAST_MAX_DISTANCE, B_env=B
        )
    targeted = torch.where(hit & (hit_actor >= 0) & ~freecam, hit_actor, -1)
    close_enough = frac * ACTOR_RAYCAST_MAX_DISTANCE < 1.0

    interact_pressed = btn[:, Button.INTERACT] & allow & ~freecam
    has_held = p.held_actor >= 0
    tgt_c = torch.clamp(targeted, 0, n - 1)
    tgt_oh = rows[None, :] == tgt_c[:, None]  # [B, N]
    tgt_flags = torch.where(targeted >= 0, _row_pick(tgt_oh, cmap.flags), 0)
    tgt_cls = torch.where(targeted >= 0, _row_pick(tgt_oh, cmap.cls), -1)
    can_hold = (tgt_flags & int(ActorFlags.CAN_BE_HELD)) != 0
    can_interact = (tgt_flags & int(ActorFlags.INTERACTABLE)) != 0
    is_enemy = (tgt_flags & int(ActorFlags.ENEMY)) != 0

    # ---- item scroll switching (MapPhysics.c:92-99)
    owned = state.save.item_mask
    cur0 = state.save.current_item

    def cycle(cur, direction):
        c = cur
        for off in range(1, NUM_ITEMS + 1):
            cand = torch.remainder(cur + direction * off, NUM_ITEMS)
            has = (owned >> cand) & 1
            c = torch.where((c == cur) & (has == 1), cand, c)
        return c

    want_next = btn[:, Button.ITEM_NEXT] & allow
    want_prev = btn[:, Button.ITEM_PREV] & allow
    cur_item = torch.where(
        want_next & (cur0 >= 0), cycle(cur0, 1),
        torch.where(want_prev & (cur0 >= 0), cycle(cur0, -1), cur0),
    ).int()
    state = state.replace(save=state.save.replace(current_item=cur_item))

    # ---- items (EraserItem.c / LaserStopperItem.c FixedUpdate)
    fire_pressed = btn[:, Button.FIRE] & allow & ~freecam & ~has_held
    altfire_pressed = btn[:, Button.ALT_FIRE] & allow & ~freecam & ~has_held
    eraser_use = (cur_item == 0) & is_enemy & (targeted >= 0)
    erase_now = eraser_use & fire_pressed
    stopper_target = (cur_item == 1) & (tgt_cls == int(ActorClass.LASER_EMITTER))
    events = state.events
    events = _push_event(events, stopper_target & fire_pressed, targeted, int(Input.TURN_OFF))
    events = _push_event(events, stopper_target & altfire_pressed, targeted, int(Input.TURN_ON))
    state = state.replace(events=events)
    item_target = eraser_use | stopper_target

    onehot_t = rows[None, :] == targeted[:, None]  # [B, N]
    erase_mask = onehot_t & erase_now[:, None] & state.actors.active
    state, fired, fired_pi = _remove_actors_b(state, fired, fired_pi, erase_mask)

    # ---- pick up / interact (PlayerPhysics.c:396-431)
    pickup = interact_pressed & ~has_held & ~item_target & can_hold & close_enough & (targeted >= 0)
    do_interact = (
        interact_pressed & ~has_held & ~item_target & ~can_hold & can_interact & close_enough & (targeted >= 0)
    )

    # button Interact (Button.c:ButtonInteract)
    actors = state.actors
    bmask = onehot_t & do_interact[:, None] & (cmap.cls == int(ActorClass.BUTTON))[None, :] & actors.active
    b_pressed = actors.idata[..., 0] != 0
    toggle = (cmap.siparams[:, 2] != 0)[None, :]
    effective = bmask & (~b_pressed | toggle)
    new_pressed = torch.where(effective, ~b_pressed, b_pressed)
    actors = actors.replace(
        idata=set_col(actors.idata, 0, torch.where(effective, new_pressed.int(), actors.idata[..., 0])),
        skin=torch.where(
            effective,
            torch.where(new_pressed, cmap.siparams[None, :, 1], cmap.siparams[None, :, 0]),
            actors.skin,
        ),
        fdata=set_col(actors.fdata, 0, torch.where(effective, state.tick.float()[:, None], actors.fdata[..., 0])),
    )
    signals.fire(fired, fired_pi, effective & new_pressed, Output.PRESSED)
    signals.fire(fired, fired_pi, effective & ~new_pressed, Output.UNPRESSED)

    # item_eraser Interact = pickup (ItemEraser.c:ItemEraserInteracted)
    emask = onehot_t & do_interact[:, None] & (cmap.cls == int(ActorClass.ITEM_ERASER))[None, :] & actors.active
    state = state.replace(actors=actors)
    any_e = emask.any(1)
    state = state.replace(
        save=state.save.replace(
            item_mask=torch.where(any_e, state.save.item_mask | 1, state.save.item_mask),
            current_item=torch.where(any_e, 0, state.save.current_item),
        )
    )
    state, fired, fired_pi = _remove_actors_b(state, fired, fired_pi, emask)
    actors = state.actors

    # ---- held actor spring (PlayerPhysics.c:344-386)
    held_idx = torch.clamp(p.held_actor, 0, n - 1)
    held_oh = rows[None, :] == held_idx[:, None]  # [B, N]
    held_alive = has_held & (held_oh & actors.active).any(1)
    held_pos = torch.where(held_oh[..., None], actors.pos, 0.0).sum(1)
    held_off = held_pos - p.pos
    too_far = (held_off * held_off).sum(-1) > HELD_MAX_DIST_SQ
    # E only drops when the character wasn't contacting the held body last
    # tick (canDropHeldActor veto)
    drop = has_held & ((interact_pressed & p.can_drop_held) | too_far | ~held_alive)
    keep_held = held_alive & ~drop
    yaw_fwd = torch.stack([-sy, zeros, -cy], -1)
    target_pt = yaw_fwd * HELD_OFFSET
    spring_vel = (target_pt - held_off) * HELD_SMOOTH
    target_quat = quat_from_axis_angle([0.0, 1.0, 0.0], yaw)
    held_quat = torch.where(held_oh[..., None], actors.quat, 0.0).sum(1)
    new_quat = quat_normalize(quat_lerp(held_quat, target_quat, 0.2))
    held_onehot = (held_oh & keep_held[:, None])[..., None]
    actors = actors.replace(
        vel=torch.where(held_onehot, spring_vel[:, None, :], actors.vel),
        omega=torch.where(held_onehot, 0.0, actors.omega),
        quat=torch.where(held_onehot, new_quat[:, None, :], actors.quat),
    )
    held_actor = torch.where(drop | ~held_alive, -1, p.held_actor)
    held_actor = torch.where(pickup & (held_actor < 0), targeted, held_actor)
    state = state.replace(actors=actors)

    crosshair = torch.where(
        (targeted >= 0) & (item_target | ((can_hold | can_interact) & close_enough)),
        Crosshair.INTERACTABLE,
        Crosshair.NORMAL,
    )
    crosshair = torch.where(held_actor >= 0, Crosshair.INVISIBLE, crosshair)

    # ------------------------------------ character update (ExtendedUpdate)
    old_xz = p.pos[:, 0::2]
    held_i32 = held_actor.int()
    new_pos, new_vel, on_ground = batched.update_character_batched(
        cmap,
        state.actors,
        p.pos,
        vel,
        delta / TPS,
        p.on_ground,
        btn[:, Button.JUMP] & allow,
        noclip,
        exclude_idx=held_i32,
    )
    new_pos = torch.where(freecam[:, None], p.pos, new_pos)
    new_vel = torch.where(freecam[:, None], p.vel, new_vel)

    # canDropHeldActor for next tick: capsule vs held-box overlap at the
    # post-update pose (Jolt's 0.02 character padding)
    held_next_oh = (rows[None, :] == torch.clamp(held_i32, 0, n - 1)[:, None]) & (held_i32 >= 0)[:, None]
    hb_pos = torch.where(held_next_oh[..., None], state.actors.pos, 0.0).sum(1)
    hb_quat = torch.where(held_next_oh[..., None], state.actors.quat, 0.0).sum(1)
    pick_row = lambda a: torch.where(held_next_oh, a[None, :], 0.0).sum(1)
    hqx, hqy, hqz, hqw = (hb_quat[:, k] for k in range(4))
    scx, scy, scz = (pick_row(cmap.shape_center[:, k]) for k in range(3))
    rx_, ry_, rz_ = gsoa.quat_rotate_soa(hqx, hqy, hqz, hqw, scx, scy, scz)
    hox, hoy, hoz = hb_pos[:, 0] + rx_, hb_pos[:, 1] + ry_, hb_pos[:, 2] + rz_
    hhx, hhy, hhz = (pick_row(cmap.halfext[:, k]) for k in range(3))
    cpx, cpy, cpz = new_pos[:, 0], new_pos[:, 1], new_pos[:, 2]
    sy0c, sy1c = cpy - CAPSULE_HALF_HEIGHT, cpy + CAPSULE_HALF_HEIGHT
    wx, wy, wz = gsoa.closest_point_on_obb_soa(cpx, cpy, cpz, hox, hoy, hoz, hqx, hqy, hqz, hqw, hhx, hhy, hhz)
    for _ in range(2):
        spx, spy, spz = gsoa.closest_point_on_vseg_soa(wx, wy, wz, cpx, sy0c, sy1c, cpz)
        wx, wy, wz = gsoa.closest_point_on_obb_soa(spx, spy, spz, hox, hoy, hoz, hqx, hqy, hqz, hqw, hhx, hhy, hhz)
    spx, spy, spz = gsoa.closest_point_on_vseg_soa(wx, wy, wz, cpx, sy0c, sy1c, cpz)
    hdist = torch.sqrt((spx - wx) ** 2 + (spy - wy) ** 2 + (spz - wz) ** 2)
    touching = (held_i32 >= 0) & (hdist - CAPSULE_RADIUS < 0.02)
    can_drop_next = allow & ~touching

    # -------------------------------------------- view bob (MapPhysics.c:76-84)
    dist = norm(new_pos[:, 0::2] - old_xz)
    bob_h = remap(dist, 0.0, MOVE_SPEED / TPS, 0.0, 0.1)
    view_bob = 0.1 + torch.sin(torch.remainder(state.frame.float() / 7.0, 2.0 * math.pi)) * bob_h

    state = state.replace(
        player=p.replace(
            pos=new_pos,
            vel=new_vel,
            yaw=yaw,
            pitch=pitch,
            on_ground=on_ground,
            noclip=noclip,
            freecam=freecam,
            freecam_pos=freecam_pos,
            held_actor=held_i32,
            targeted_actor=targeted.int(),
            targeted_fraction=frac,
            can_drop_held=can_drop_next,
            view_bob=view_bob,
            crosshair=crosshair.int(),
        )
    )

    # ---------------------------------------- sensor contact callbacks
    state, fired, fired_pi = behaviors.contact_phase(cmap, state, fired, fired_pi)

    # -------- laser beam lengths (rays already cast in the merged launch)
    laser_hit = torch.zeros((B, n), dtype=torch.bool, device=dev)
    laser_len = torch.zeros((B, n), device=dev)
    if L:
        laser_hit[:, l_of] = laser_hit_rays
        laser_len[:, l_of] = 50.0 * laser_frac_rays

    # ------------------------------------------------- actor updates
    camera_pos = torch.where(freecam[:, None], freecam_pos, new_pos + up)
    state, fired, fired_pi = behaviors.update_actors(
        cmap, state, fired, fired_pi, delta, camera_pos, laser_hit, laser_len
    )

    # ---------------------------------------------- signal propagation
    rounds = cmap.aux.get("signal_rounds", 4) if cmap.aux else 4
    state = signals.process_signals(cmap, state, fired, fired_pi, rounds=rounds)

    # --------------------------------------------- physics (2 substeps)
    (bpos, bquat, bvel, bomega, bsleep,
     bwarm_n, bwarm_pair, bwarm_pair_idx) = bodies.step_bodies_batched(
        cmap, state.actors, state.player.pos, state.player.vel, delta / TPS, n_substeps=2
    )
    state = state.replace(
        actors=state.actors.replace(
            pos=bpos, quat=bquat, vel=bvel, omega=bomega, sleep=bsleep,
            warm_n=bwarm_n, warm_pair=bwarm_pair, warm_pair_idx=bwarm_pair_idx,
        )
    )

    # --------------------------------- audio channel bookkeeping (one tick)
    # two batch-global gates (the JAX tick's lax.cond)
    state = _audio_gate((state.sound_ops != 0).any(), lambda: _apply_sound_ops(cmap, state), state)
    state = _audio_gate((state.audio.snd >= 0).any(), lambda: _advance_audio_tick(cmap, state), state)

    # ------------------------------------------- save clamps (MapUpdate)
    save = state.save.replace(
        coins=torch.clamp_max(state.save.coins, 9999),
        blue_coins=torch.clamp_max(state.save.blue_coins, 5),
    )
    return state.replace(save=save, tick=state.tick + 1, frame=state.frame + 1)


def step(cmap, state: EnvState, actions: Actions) -> EnvState:
    """Single-env tick: a batch-of-1 wrapper around step_batch (the
    kernels pad the one lane to a 128-lane block)."""
    out = step_batch(cmap, tree_map(lambda x: x[None], state), tree_map(lambda x: x[None], actions))
    return tree_map(lambda x: x[0], out)


def _audio_gate(pred, stage, state: EnvState) -> EnvState:
    """stage() where pred ([] bool) holds, else `state`, through a gate of
    core/gates.py; the gate carries the leaves the audio stages write (the
    channel table, the actors' handles, the sound-op bits)."""
    written = lambda st: [t for _, t in tree_leaves(st.audio)] + [st.actors.idata, st.sound_ops]
    out = iter(gates.gate(gates.read(pred), lambda: written(stage()), lambda: written(state)))
    audio = tree_map(lambda _: next(out), state.audio)
    return state.replace(audio=audio, actors=state.actors.replace(idata=next(out)), sound_ops=next(out))


def _apply_sound_ops(cmap, state: EnvState) -> EnvState:
    """Drain the per-actor sound-op bits into channel-table operations
    (SoundPlayer Play/Pause/Resume/Stop + Coin.c:83 coincling). Stop,
    pause and resume act on the pre-play handles, then plays allocate."""
    from refsim.audio.mixer import CATEGORY_SFX, alloc_channels, set_paused, stop_channels

    dev = cmap.device
    names = (cmap.aux or {}).get("sound_names", ())
    cling = names.index("sound/sfx/coincling.gsnd") if "sound/sfx/coincling.gsnd" in names else -1
    ops = state.sound_ops
    actors = state.actors
    play = (ops & 1) != 0
    pause = (ops & 2) != 0
    stop = (ops & 4) != 0
    resume = (ops & 8) != 0
    cling_m = (ops & 16) != 0
    audio = state.audio
    n_ch = audio.snd.shape[-1]
    ch_ids = torch.arange(n_ch, dtype=torch.int32, device=dev)
    handles = actors.idata[..., 1]

    def ch_mask_of(actor_mask):
        return (actor_mask[..., None] & (handles[..., None] == ch_ids)).any(dim=-2)

    audio = set_paused(audio, ch_mask_of(pause), True)
    audio = set_paused(audio, ch_mask_of(resume), False)
    audio = stop_channels(audio, ch_mask_of(stop))
    # plays allocate fresh channels; the new handle replaces the actor's
    audio, handle = alloc_channels(
        audio,
        play,
        cmap.siparams[:, 0],  # sound id
        cmap.sfparams[:, 0],  # volume
        cmap.siparams[:, 1],  # category
        cmap.siparams[:, 2],  # loops
        cmap.siparams[:, 3] != 0,  # positional
        actors.pos,
    )
    n = play.shape[-1]
    audio, _ = alloc_channels(
        audio,
        cling_m,
        torch.full((n,), cling, dtype=torch.int32, device=dev),
        torch.ones(n, device=dev),
        torch.full((n,), CATEGORY_SFX, dtype=torch.int32, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev),
        torch.zeros(n, dtype=torch.bool, device=dev),
        actors.pos,
    )
    handles = torch.where(play, handle, torch.where(stop, -1, handles))
    actors = actors.replace(idata=set_col(actors.idata, 1, handles))
    return state.replace(actors=actors, audio=audio, sound_ops=torch.zeros_like(ops))


def _advance_audio_tick(cmap, state: EnvState) -> EnvState:
    """One tick of channel clock; finished channels null the owning actor's
    handle (SoundPlayerSoundDone)."""
    from refsim.audio.mixer import tick_advance

    audio, fin = tick_advance(state.audio, cmap.sound_len)
    handles = state.actors.idata[..., 1]
    nch = audio.snd.shape[-1]
    ch = torch.arange(nch, dtype=torch.int32, device=cmap.device)
    hit = (handles[..., None] == ch) & fin[:, None, :]
    handles = torch.where(hit.any(-1), -1, handles)
    return state.replace(
        audio=audio,
        actors=state.actors.replace(idata=set_col(state.actors.idata, 1, handles)),
    )
