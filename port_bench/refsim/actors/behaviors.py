"""Per-tick actor behavior, batched over [B, N]: the sensor contact phase
and the per-class Update() phase (counterpart of
c_game_engine_tpu/actors/behaviors.py; per-class citations there).

Both are dense, class-masked code over every actor class, as in the JAX
package. step_batch casts the laser rays in its merged ray launch and
passes laser_hit / laser_len in; a caller outside the tick may leave them
out, and `compute_laser_rays` casts them.
"""

from __future__ import annotations

import math

import torch

from refsim.actors.defs import ActorClass, ActorFlags, DoorState, Output
from refsim.actors.handlers import first_set, door_set_state, remove_actors, set_col
from refsim.actors.signals import fire
from refsim.physics.batched import cast_rays_batched
from refsim.physics.sensors import sensor_overlap
from refsim.utils.mathx import const, lerp, quat_from_axis_angle, quat_rotate

TPS = 60.0
LASER_RANGE = 50.0  # Laser.c:127-158


def compute_laser_rays(cmap, actors):
    """Laser hitscan of every env outside the tick (the JAX function's
    fallback for update_actors called outside step_batch, vmapped over the
    env axis): `actors` leaves [B, N, ...]. Returns (hit [B, N], len [B, N]).

    One cast_rays_batched call of B * N rays, env-major
    (layout="interleaved", B_env=B): one K2 launch on the card. It copies
    the JAX function's choices, which differ from the tick's merged launch
    (core/step.py): each actor's ray starts at its position (no laser
    height offset), no triple-laser static-only filter, and every actor
    casts one, masked to lasers afterwards."""
    b, n = actors.active.shape
    dev = actors.pos.device
    is_laser = cmap.cls == int(ActorClass.LASER)
    fwd = quat_rotate(actors.quat, const((0.0, 0.0, -1.0), dev).expand(b, n, 3))
    hit, frac, _ = cast_rays_batched(
        cmap,
        actors,
        actors.pos.reshape(b * n, 3),
        fwd.reshape(b * n, 3),
        LASER_RANGE,
        exclude=cmap.siparams[:, 1].repeat(b),
        require_flags=int(ActorFlags.CAN_BLOCK_LASERS),
        B_env=b,
        layout="interleaved",
    )
    return hit.reshape(b, n) & is_laser, LASER_RANGE * frac.reshape(b, n)


def contact_phase(cmap, state, fired, fired_pi):
    """Sensor overlap edges and the contact handlers of the owning actors
    (coin / goal / trigger / door / item_eraser)."""
    actors = state.actors
    n = cmap.num_actors
    dev = cmap.device
    overlap = sensor_overlap(cmap, actors, state.player.pos)  # [B, S]
    prev = state.sensor_inside
    added_s = overlap & ~prev
    persisted_s = overlap & prev
    removed_s = ~overlap & prev

    owner_mat = cmap.sensor_owner[:, None] == torch.arange(n, device=dev)[None, :]  # [S, N]

    def to_actor(mask_s):
        return (owner_mat & mask_s[..., None]).any(dim=-2)

    added = to_actor(added_s) & actors.active
    persisted = to_actor(persisted_s) & actors.active
    removed = to_actor(removed_s) & actors.active
    cls = cmap.cls

    # ---- coin
    coin_hit = added & (cls == int(ActorClass.COIN))
    is_blue = cmap.siparams[:, 0] != 0
    got_blue = (coin_hit & is_blue).sum(-1, dtype=torch.int32)
    got_norm = (coin_hit & ~is_blue).sum(-1, dtype=torch.int32)
    save = state.save.replace(
        coins=state.save.coins + got_norm + 5 * got_blue,
        blue_coins=state.save.blue_coins + got_blue,
    )
    # one-shot coincling bit, drained once per tick in core/step.py
    state = state.replace(
        save=save,
        sound_ops=state.sound_ops | (coin_hit.int() << 4),
        sound_plays=state.sound_plays + got_blue + got_norm,
    )
    fire(fired, fired_pi, coin_hit, Output.COLLECTED)
    state, fired, fired_pi = remove_actors(state, fired, fired_pi, coin_hit)

    # ---- goal
    goal_hit = added & (cls == int(ActorClass.GOAL)) & (state.actors.idata[..., 0] != 0)
    save = state.save.replace(coins=state.save.coins + 10 * goal_hit.sum(-1, dtype=torch.int32))
    state = state.replace(save=save)
    fire(fired, fired_pi, goal_hit, Output.COLLECTED)
    state, fired, fired_pi = remove_actors(state, fired, fired_pi, goal_hit)

    # ---- trigger
    actors = state.actors
    enabled = actors.idata[..., 0] != 0
    one_shot = cmap.siparams[:, 0] != 0
    trig = cls == int(ActorClass.TRIGGER)
    t_added = added & trig & enabled
    t_pers = persisted & trig & enabled & ~one_shot
    t_removed = removed & trig & enabled
    fire(fired, fired_pi, t_added, Output.ENTERED)
    fire(fired, fired_pi, t_added | t_pers, Output.TRIGGERED)
    fire(fired, fired_pi, t_removed, Output.EXITED)
    state, fired, fired_pi = remove_actors(state, fired, fired_pi, t_removed & one_shot)

    # ---- door
    actors = state.actors
    door = cls == int(ActorClass.DOOR)
    dstate = actors.idata[..., 0]
    anim = actors.fdata[..., 0]
    width = cmap.sfparams[:, 0]
    stay_open = cmap.siparams[:, 0] != 0
    d_added = added & door
    go_open0 = d_added & (dstate == int(DoorState.CLOSED))
    go_open_rev = d_added & (dstate == int(DoorState.CLOSING))
    d_pers = persisted & door
    pers_done = d_pers & (dstate == int(DoorState.OPENING)) & (anim >= width)
    d_rem = removed & door
    rem_close_now = d_rem & (dstate == int(DoorState.OPEN)) & ~stay_open & (anim >= width)
    rem_should_close = (
        d_rem
        & (
            ((dstate == int(DoorState.OPEN)) & ~(~stay_open & (anim >= width)))
            | (dstate == int(DoorState.OPENING))
        )
        & ~stay_open
    )
    should_close = actors.idata[..., 1]
    should_close = torch.where(d_added, 0, should_close)
    should_close = torch.where(rem_should_close, 1, should_close)
    actors = actors.replace(idata=set_col(actors.idata, 1, should_close))

    mask = go_open0 | go_open_rev | pers_done | rem_close_now
    new_state = torch.where(
        go_open0 | go_open_rev,
        int(DoorState.OPENING),
        torch.where(pers_done, int(DoorState.OPEN), int(DoorState.CLOSING)),
    ).int()
    new_anim = torch.where(go_open_rev, width - anim, 0.0)
    actors, fired, fired_pi = door_set_state(cmap, actors, fired, fired_pi, mask, new_state, new_anim)
    state = state.replace(actors=actors)

    # ---- item_eraser pickup on touch
    eraser_hit = added & (cls == int(ActorClass.ITEM_ERASER))
    has_eraser = ((state.save.item_mask & 1) != 0)[:, None]
    give = eraser_hit & ~has_eraser  # the per-actor always-give param is unused
    switch_only = eraser_hit & has_eraser
    any_give = give.any(-1)
    save = state.save.replace(
        item_mask=torch.where(any_give, state.save.item_mask | 1, state.save.item_mask),
        current_item=torch.where(any_give | switch_only.any(-1), 0, state.save.current_item),
    )
    state = state.replace(save=save)
    state, fired, fired_pi = remove_actors(state, fired, fired_pi, give)

    state = state.replace(sensor_inside=overlap)
    return state, fired, fired_pi


def update_actors(cmap, state, fired, fired_pi, delta, camera_pos, laser_hit=None, laser_len=None):
    """Per-class Update() for every env. camera_pos [B, 3]; laser_hit /
    laser_len [B, N] from the merged ray launch, or None to cast them
    with `compute_laser_rays`."""
    if laser_hit is None:
        laser_hit, laser_len = compute_laser_rays(cmap, state.actors)
    actors = state.actors
    n = cmap.num_actors
    dev = cmap.device
    rows = torch.arange(n, device=dev)
    cls = cmap.cls
    active = actors.active
    tick = state.tick[:, None]  # [B, 1]

    # ---- io_proxy first tick
    first = active & (cls == int(ActorClass.IO_PROXY)) & (tick == 0)
    fire(fired, fired_pi, first, Output.FIRST_TICK)

    # ---- coin animation: every 8th engine-uptime frame
    coin = active & (cls == int(ActorClass.COIN))
    advance = coin & (state.frame[:, None] % 8 == 0)
    frame = torch.where(advance, (actors.idata[..., 0] + 1) % 4, actors.idata[..., 0])
    actors = actors.replace(idata=set_col(actors.idata, 0, torch.where(coin, frame, actors.idata[..., 0])))

    # ---- Y-billboarding
    bb = active & cmap.billboard
    yaw = torch.atan2(camera_pos[:, None, 0] - actors.pos[..., 0], camera_pos[:, None, 2] - actors.pos[..., 2])
    yaw = yaw + torch.where(cmap.wall_axis == 1, math.pi / 2, 0.0)
    bb_quat = quat_from_axis_angle([0.0, 1.0, 0.0], yaw)
    actors = actors.replace(quat=torch.where(bb[..., None], bb_quat, actors.quat))

    # ---- door FSM timeouts
    door = active & (cls == int(ActorClass.DOOR))
    dstate = actors.idata[..., 0]
    anim = actors.fdata[..., 0]
    width = cmap.sfparams[:, 0]
    stay_time = cmap.sfparams[:, 1]
    should_close = actors.idata[..., 1] != 0
    opening_done = door & (dstate == int(DoorState.OPENING)) & (anim >= width)
    open_close = door & (dstate == int(DoorState.OPEN)) & (anim >= stay_time) & should_close
    closing_done = door & (dstate == int(DoorState.CLOSING)) & (anim >= width)
    mask = opening_done | open_close | closing_done
    new_state = torch.where(
        opening_done,
        int(DoorState.OPEN),
        torch.where(open_close, int(DoorState.CLOSING), int(DoorState.CLOSED)),
    ).int()
    actors, fired, fired_pi = door_set_state(
        cmap, actors, fired, fired_pi, mask, new_state, torch.zeros(n, device=dev)
    )
    sc = torch.where(open_close | closing_done, 0, actors.idata[..., 1])
    actors = actors.replace(idata=set_col(actors.idata, 1, sc))
    # animationTime += delta / TPS (seconds)
    actors = actors.replace(
        fdata=set_col(actors.fdata, 0, torch.where(door, actors.fdata[..., 0] + delta / TPS, actors.fdata[..., 0]))
    )

    # ---- button auto-reset
    button = active & (cls == int(ActorClass.BUTTON))
    pressed = actors.idata[..., 0] != 0
    reset_ticks = cmap.siparams[:, 3]
    expired = (
        button
        & pressed
        & (reset_ticks >= 0)
        & ((tick.float() - actors.fdata[..., 0]) >= reset_ticks)
    )
    actors = actors.replace(
        idata=set_col(actors.idata, 0, torch.where(expired, 0, actors.idata[..., 0])),
        skin=torch.where(expired, cmap.siparams[:, 0], actors.skin),
    )
    fire(fired, fired_pi, expired, Output.UNPRESSED)

    # ---- laser beam + uv scroll; a miss extends the beam to its max
    laser_on = active & (cls == int(ActorClass.LASER)) & (actors.idata[..., 0] != 0)
    beam_len = torch.where(laser_hit, laser_len, 50.0)
    new_uv = torch.remainder(actors.fdata[..., 1] + delta / 8.0, 1.0)
    fdata = set_col(actors.fdata, 0, torch.where(laser_on, beam_len, actors.fdata[..., 0]))
    fdata = set_col(fdata, 1, torch.where(laser_on, new_uv, fdata[..., 1]))
    actors = actors.replace(fdata=fdata)

    # ---- env interpolators: start_on applies the configured value
    env = state.env
    for klass in (ActorClass.GLOBAL_LIGHT, ActorClass.GLOBAL_FOG, ActorClass.TONEMAP_CONTROLLER):
        pending = active & (cls == int(klass)) & (actors.idata[..., 0] != 0)
        anyp = pending.any(-1)
        sel = first_set(pending)
        pick_vec = lambda a, b: torch.where(sel[..., None], cmap.sfparams[:, a:b], 0.0).sum(-2)
        pick_s = lambda c: torch.where(sel, cmap.sfparams[:, c], 0.0).sum(-1)
        if klass == ActorClass.GLOBAL_LIGHT:
            env = env.replace(light_color=torch.where(anyp[:, None], pick_vec(0, 4), env.light_color))
        elif klass == ActorClass.GLOBAL_FOG:
            env = env.replace(
                fog_color=torch.where(anyp[:, None], pick_vec(0, 4), env.fog_color),
                fog_start=torch.where(anyp, pick_s(4), env.fog_start),
                fog_end=torch.where(anyp, pick_s(5), env.fog_end),
            )
        else:
            env = env.replace(exposure=torch.where(anyp, pick_s(0), env.exposure))
        actors = actors.replace(idata=set_col(actors.idata, 0, torch.where(pending, 0, actors.idata[..., 0])))

    # active interpolation channels (one-hot row picks)
    def interp_chan(chan_actor, chan_start):
        oh = rows[None, :] == chan_actor[:, None]  # [B, N], all-false for -1
        total = torch.clamp_min(torch.where(oh, cmap.siparams[:, 0].float(), 0.0).sum(-1), 1.0)
        ticks_into = (state.tick - chan_start).float()
        on = chan_actor >= 0
        f = torch.clamp(ticks_into / total, 0.0, 1.0)
        done = on & (ticks_into >= total)
        pick_vec = lambda a, b: torch.where(oh[..., None], cmap.sfparams[:, a:b], 0.0).sum(-2)
        pick_s = lambda c: torch.where(oh, cmap.sfparams[:, c], 0.0).sum(-1)
        return on, f, done, pick_vec, pick_s

    on, f, done, pick_vec, pick_s = interp_chan(env.light_interp_actor, env.light_interp_start)
    env = env.replace(
        light_color=torch.where(on[:, None], lerp(env.light_interp_prev, pick_vec(0, 4), f[:, None]), env.light_color),
        light_interp_actor=torch.where(done, -1, env.light_interp_actor),
    )
    on, f, done, pick_vec, pick_s = interp_chan(env.fog_interp_actor, env.fog_interp_start)
    env = env.replace(
        fog_color=torch.where(on[:, None], lerp(env.fog_interp_prev[:, 0:4], pick_vec(0, 4), f[:, None]), env.fog_color),
        fog_start=torch.where(on, lerp(env.fog_interp_prev[:, 4], pick_s(4), f), env.fog_start),
        fog_end=torch.where(on, lerp(env.fog_interp_prev[:, 5], pick_s(5), f), env.fog_end),
        fog_interp_actor=torch.where(done, -1, env.fog_interp_actor),
    )
    on, f, done, pick_vec, pick_s = interp_chan(env.tonemap_interp_actor, env.tonemap_interp_start)
    env = env.replace(
        exposure=torch.where(on, lerp(env.tonemap_interp_prev, pick_s(0), f), env.exposure),
        tonemap_interp_actor=torch.where(done, -1, env.tonemap_interp_actor),
    )

    state = state.replace(actors=actors, env=env)
    return state, fired, fired_pi
