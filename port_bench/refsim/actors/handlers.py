"""Signal input handlers as masked updates, batched over envs (counterpart
of c_game_engine_tpu/actors/handlers.py; reference citations there).

apply_round() consumes the whole event queue in one pass: events map to
per-actor (input, param) lanes through a dense [B, Q, N] one-hot, then
every handler applies behind its mask. Two events hitting the same actor
with the same input in the same round collapse (counter add/subtract
accumulate), exactly as in the JAX package.
"""

from __future__ import annotations

import torch

from refsim.actors.defs import (
    ActorClass,
    DecimalOp,
    DoorState,
    Input,
    LogicOp,
    Output,
    ParamType,
)
from refsim.actors.signals import fire
from refsim.utils.mathx import const, quat_rotate


def set_col(a, k, v):
    """Copy of a with a[..., k] = v (the JAX `.at[..., k].set(v)`)."""
    out = a.clone()
    out[..., k] = v
    return out


def door_forward(actors_quat):
    """Door travel direction: +Z rotated by the door's quat."""
    z = const((0.0, 0.0, 1.0), actors_quat.device).expand(actors_quat.shape[:-1] + (3,))
    return quat_rotate(actors_quat, z)


def door_set_state(cmap, actors, fired, fired_pi, mask, new_state, anim):
    """DoorSetState (Door.c:73-105). mask [B, N]; new_state / anim [B, N]
    or [N] per-actor targets. Fires the transition outputs."""
    is_door = mask & (cmap.cls == int(ActorClass.DOOR))
    fwd = door_forward(actors.quat)
    closed_pos = cmap.init_pos
    open_pos = cmap.sfparams[:, 2:5]

    to_closed = is_door & (new_state == int(DoorState.CLOSED))
    to_opening = is_door & (new_state == int(DoorState.OPENING))
    to_open = is_door & (new_state == int(DoorState.OPEN))
    to_closing = is_door & (new_state == int(DoorState.CLOSING))

    vel = actors.vel
    pos = actors.pos
    vel = torch.where((to_closed | to_open)[..., None], 0.0, vel)
    vel = torch.where(to_opening[..., None], fwd, vel)
    vel = torch.where(to_closing[..., None], -fwd, vel)
    pos = torch.where(to_closed[..., None], closed_pos, pos)
    pos = torch.where(to_open[..., None], open_pos, pos)

    idata = set_col(actors.idata, 0, torch.where(is_door, new_state, actors.idata[..., 0]))
    fdata = set_col(actors.fdata, 0, torch.where(is_door, anim, actors.fdata[..., 0]))

    fire(fired, fired_pi, to_closed, Output.FULLY_CLOSED)
    fire(fired, fired_pi, to_opening, Output.OPENING)
    fire(fired, fired_pi, to_open, Output.FULLY_OPENED)
    fire(fired, fired_pi, to_closing, Output.CLOSING)

    actors = actors.replace(vel=vel, pos=pos, idata=idata, fdata=fdata)
    return actors, fired, fired_pi


def remove_actors(state, fired, fired_pi, mask):
    """RemoveActor (Map.c:130-160) for mask [B, N]: fire `killed`,
    deactivate, clear the player's targeted/held references. Also the
    counterpart of core/step.py::_remove_actors_b."""
    fire(fired, fired_pi, mask, Output.KILLED)
    actors = state.actors.replace(
        active=state.actors.active & ~mask,
        visible=state.actors.visible & ~mask,
    )
    rows = torch.arange(mask.shape[-1], device=mask.device)[None, :]
    p = state.player
    tgt_killed = (p.targeted_actor >= 0) & (mask & (rows == p.targeted_actor[:, None])).any(-1)
    held_killed = (p.held_actor >= 0) & (mask & (rows == p.held_actor[:, None])).any(-1)
    p = p.replace(
        targeted_actor=torch.where(tgt_killed, -1, p.targeted_actor),
        held_actor=torch.where(held_killed, -1, p.held_actor),
    )
    return state.replace(actors=actors, player=p), fired, fired_pi


def first_set(mask):
    """First set lane along N (cumsum == 1) as a mask."""
    return mask & (torch.cumsum(mask.int(), dim=-1) == 1)


def apply_round(cmap, state, fired, fired_pi, queue):
    """Apply every queued event in one vectorized pass."""
    n = cmap.num_actors
    dev = cmap.device
    actors = state.actors
    cls = cmap.cls
    q = queue
    rows = torch.arange(n, device=dev)

    live = torch.arange(q.target.shape[-1], device=dev)[None, :] < q.count[:, None]  # [B, Q]
    tgt = torch.where(live, q.target, -1)
    onehot = (tgt[..., None] == rows) & live[..., None]  # [B, Q, N]

    def recv(input_id):
        ev = q.input == int(input_id)
        return (onehot & ev[..., None]).any(dim=1) & actors.active

    def recv_param(input_id, want_types=()):
        ev = q.input == int(input_id)
        if want_types:
            tok = torch.zeros_like(ev)
            for wt in want_types:
                tok = tok | (q.ptype == int(wt))
            ev = ev & tok
        sel = onehot & ev[..., None]  # [B, Q, N]
        m = sel.any(dim=1)
        # one-hot contraction: exact in f32 (TF32 is off, see __init__.py)
        pf = torch.einsum("bqn,bqk->bnk", sel.float(), q.pf)
        pi = (sel.int() * q.pi[..., None]).sum(dim=1).int()
        return m & actors.active, pf, pi

    def m_cls(mask, *classes):
        ok = torch.zeros_like(cls, dtype=torch.bool)
        for c in classes:
            ok = ok | (cls == int(c))
        return mask & ok

    # ---- kill (unregistered on io_proxy)
    kill_m = recv(Input.KILL) & (cls != int(ActorClass.IO_PROXY))
    state, fired, fired_pi = remove_actors(state, fired, fired_pi, kill_m)
    actors = state.actors

    # ---- door open/close
    dstate = actors.idata[..., 0]
    anim = actors.fdata[..., 0]
    width = cmap.sfparams[:, 0]
    open_m = m_cls(recv(Input.OPEN), ActorClass.DOOR)
    close_m = m_cls(recv(Input.CLOSE), ActorClass.DOOR)
    go_opening = open_m & (dstate == int(DoorState.CLOSED))
    go_opening_rev = open_m & (dstate == int(DoorState.CLOSING))
    go_closing = close_m & (dstate == int(DoorState.OPEN))
    go_closing_rev = close_m & (dstate == int(DoorState.OPENING))
    door_mask = go_opening | go_opening_rev | go_closing | go_closing_rev
    new_state = torch.where(go_opening | go_opening_rev, int(DoorState.OPENING), int(DoorState.CLOSING))
    new_anim = torch.where(go_opening | go_closing, 0.0, width - anim)
    actors, fired, fired_pi = door_set_state(cmap, actors, fired, fired_pi, door_mask, new_state.int(), new_anim)

    # ---- laser / emitter turn_on & turn_off
    on_m = recv(Input.TURN_ON)
    off_m = recv(Input.TURN_OFF)
    laser_on = m_cls(on_m, ActorClass.LASER)
    laser_off = m_cls(off_m, ActorClass.LASER)
    em_on = m_cls(on_m, ActorClass.LASER_EMITTER)
    em_off = m_cls(off_m, ActorClass.LASER_EMITTER)
    child_mat = cmap.siparams[:, 2][:, None] == rows[None, :]  # emitter -> laser slot
    child_on = (child_mat & em_on[..., None]).any(dim=-2)
    child_off = (child_mat & em_off[..., None]).any(dim=-2)
    is_laser = cls == int(ActorClass.LASER)
    turn_on = laser_on | (child_on & is_laser)
    turn_off = laser_off | (child_off & is_laser)
    actors = actors.replace(
        idata=set_col(actors.idata, 0, torch.where(turn_on, 1, torch.where(turn_off, 0, actors.idata[..., 0]))),
        visible=torch.where(turn_on, True, torch.where(turn_off, False, actors.visible)),
        skin=torch.where(em_on, cmap.siparams[:, 0] + 1, torch.where(em_off, 0, actors.skin)),
    )

    # ---- env set / set_instant (GlobalLight/Fog/TonemapController)
    env = state.env
    tick = state.tick
    interp_ticks = cmap.siparams[:, 0]
    set_all = recv(Input.SET)
    seti_all = recv(Input.SET_INSTANT)
    for klass in (ActorClass.GLOBAL_LIGHT, ActorClass.GLOBAL_FOG, ActorClass.TONEMAP_CONTROLLER):
        set_m = m_cls(set_all, klass)
        set_i = m_cls(seti_all, klass)
        any_set = set_m.any(-1)
        any_set_i = set_i.any(-1)
        sel = first_set(set_m | set_i)  # first row (argmax-first semantics)
        t_row = torch.where(sel, rows, 0).sum(-1).int()
        row_ticks = torch.where(sel, interp_ticks, 0).sum(-1)
        pick_vec = lambda a, b: torch.where(sel[..., None], cmap.sfparams[:, a:b], 0.0).sum(-2)
        pick_s = lambda c: torch.where(sel, cmap.sfparams[:, c], 0.0).sum(-1)
        instant = any_set_i | (any_set & (row_ticks == 0))
        start_interp = any_set & (row_ticks != 0)
        if klass == ActorClass.GLOBAL_LIGHT:
            env = env.replace(
                light_color=torch.where(instant[:, None], pick_vec(0, 4), env.light_color),
                light_interp_actor=torch.where(
                    start_interp, t_row, torch.where(instant, -1, env.light_interp_actor)).int(),
                light_interp_start=torch.where(start_interp, tick, env.light_interp_start),
                light_interp_prev=torch.where(start_interp[:, None], env.light_color, env.light_interp_prev),
            )
        elif klass == ActorClass.GLOBAL_FOG:
            target_c = pick_vec(0, 4)
            target_se = pick_vec(4, 6)
            cur = torch.cat([env.fog_color, torch.stack([env.fog_start, env.fog_end], -1)], -1)
            env = env.replace(
                fog_color=torch.where(instant[:, None], target_c, env.fog_color),
                fog_start=torch.where(instant, target_se[:, 0], env.fog_start),
                fog_end=torch.where(instant, target_se[:, 1], env.fog_end),
                fog_interp_actor=torch.where(
                    start_interp, t_row, torch.where(instant, -1, env.fog_interp_actor)).int(),
                fog_interp_start=torch.where(start_interp, tick, env.fog_interp_start),
                fog_interp_prev=torch.where(start_interp[:, None], cur, env.fog_interp_prev),
            )
        else:
            env = env.replace(
                exposure=torch.where(instant, pick_s(0), env.exposure),
                tonemap_interp_actor=torch.where(
                    start_interp, t_row, torch.where(instant, -1, env.tonemap_interp_actor)).int(),
                tonemap_interp_start=torch.where(start_interp, tick, env.tonemap_interp_start),
                tonemap_interp_prev=torch.where(start_interp, env.exposure, env.tonemap_interp_prev),
            )

    # ---- trigger/goal enable/disable + force
    en = m_cls(recv(Input.ENABLE), ActorClass.TRIGGER, ActorClass.GOAL)
    dis = m_cls(recv(Input.DISABLE), ActorClass.TRIGGER, ActorClass.GOAL)
    actors = actors.replace(
        idata=set_col(actors.idata, 0, torch.where(en, 1, torch.where(dis, 0, actors.idata[..., 0])))
    )
    force = m_cls(recv(Input.FORCE_TRIGGER), ActorClass.TRIGGER)
    fire(fired, fired_pi, force, Output.TRIGGERED)

    # ---- camera enable/disable
    cam_en = m_cls(recv(Input.ENABLE), ActorClass.CAMERA)
    cam_dis = m_cls(recv(Input.DISABLE), ActorClass.CAMERA)
    cam = state.camera_actor
    first_en = first_set(cam_en)
    cam = torch.where(cam_en.any(-1), torch.where(first_en, rows, 0).sum(-1).int(), cam)
    cam_hit = (cam_dis & (rows == cam[:, None])).any(-1)
    cam = torch.where(cam_hit & (cam >= 0), -1, cam)
    state = state.replace(camera_actor=cam.int())

    # ---- logic binary / decimal operands + execute
    opa_m, opa_pf, opa_pi = recv_param(Input.OPERAND_A, (ParamType.BOOL, ParamType.FLOAT))
    opb_m, opb_pf, opb_pi = recv_param(Input.OPERAND_B, (ParamType.BOOL, ParamType.FLOAT))
    is_lb = cls == int(ActorClass.LOGIC_BINARY)
    is_ld = cls == int(ActorClass.LOGIC_DECIMAL)
    idata = set_col(actors.idata, 0, torch.where(opa_m & is_lb, opa_pi, actors.idata[..., 0]))
    idata = set_col(idata, 1, torch.where(opb_m & is_lb, opb_pi, idata[..., 1]))
    fdata = set_col(actors.fdata, 0, torch.where(opa_m & is_ld, opa_pf[..., 0], actors.fdata[..., 0]))
    fdata = set_col(fdata, 1, torch.where(opb_m & is_ld, opb_pf[..., 0], fdata[..., 1]))
    actors = actors.replace(idata=idata, fdata=fdata)

    exe_all = recv(Input.EXECUTE)
    exe_b = exe_all & is_lb
    exe_d = exe_all & is_ld
    a_v = actors.idata[..., 0] != 0
    b_v = actors.idata[..., 1] != 0
    op = cmap.siparams[:, 0]
    res_b = torch.where(
        op == int(LogicOp.AND), a_v & b_v, torch.where(op == int(LogicOp.OR), a_v | b_v, ~a_v)
    )
    fa, fb = actors.fdata[..., 0], actors.fdata[..., 1]
    res_d = torch.zeros_like(fa, dtype=torch.bool)
    for code, val in reversed((
        (DecimalOp.EQUAL, fa == fb),
        (DecimalOp.GREATER_THAN, fa > fb),
        (DecimalOp.GREATER_THAN_OR_EQUAL, fa >= fb),
        (DecimalOp.LESS_THAN, fa < fb),
        (DecimalOp.LESS_THAN_OR_EQUAL, fa <= fb),
    )):  # jnp.select: the first matching condition wins
        res_d = torch.where(op == int(code), val, res_d)
    exe = exe_b | exe_d
    res = torch.where(exe_b, res_b, res_d)
    fire(fired, fired_pi, exe & res, Output.ON_TRUE)
    fire(fired, fired_pi, exe & ~res, Output.ON_FALSE)
    fire(fired, fired_pi, exe, Output.EXECUTION_RESULT, pi=res.int())

    # ---- logic counter (add/subtract accumulate)
    is_cnt = cls == int(ActorClass.LOGIC_COUNTER)
    ev_add = live & (q.input == int(Input.ADD)) & (q.ptype == int(ParamType.INTEGER))
    ev_sub = live & (q.input == int(Input.SUBTRACT)) & (q.ptype == int(ParamType.INTEGER))
    ev_inc = live & (q.input == int(Input.INCREMENT))
    ev_dec = live & (q.input == int(Input.DECREMENT))
    # the reference's decrement handler adds +1 (an upstream bug in
    # LogicCounter.c); the JAX package implements the documented -1
    delta_ev = (
        torch.where(ev_add, q.pi, 0)
        - torch.where(ev_sub, q.pi, 0)
        + torch.where(ev_inc, 1, 0)
        - torch.where(ev_dec, 1, 0)
    )
    ev_any = ev_add | ev_sub | ev_inc | ev_dec
    change = (onehot.int() * torch.where(ev_any, delta_ev, 0)[..., None]).sum(dim=1).int()
    touched = (onehot & ev_any[..., None]).any(dim=1)
    counter_m = touched & is_cnt & actors.active
    prev = actors.idata[..., 0]
    cmin, cmax = cmap.siparams[:, 0], cmap.siparams[:, 1]
    clamp_min, clamp_max = cmap.siparams[:, 2] != 0, cmap.siparams[:, 3] != 0
    newv = prev + change
    newv = torch.where(clamp_max, torch.minimum(newv, cmax), newv)
    newv = torch.where(clamp_min, torch.maximum(newv, cmin), newv)
    actors = actors.replace(idata=set_col(actors.idata, 0, torch.where(counter_m, newv, prev)))
    hit_max = counter_m & clamp_max & (prev < cmax) & (newv == cmax)
    left_max = counter_m & clamp_max & (prev == cmax) & (newv < cmax)
    hit_min = counter_m & clamp_min & (prev > cmin) & (newv == cmin)
    left_min = counter_m & clamp_min & (prev == cmin) & (newv > cmin)
    changed = counter_m & (prev != newv)
    fire(fired, fired_pi, hit_max, Output.HIT_MAX)
    fire(fired, fired_pi, left_max, Output.LEFT_MAX)
    fire(fired, fired_pi, hit_min, Output.HIT_MIN)
    fire(fired, fired_pi, left_min, Output.LEFT_MIN)
    fire(fired, fired_pi, changed, Output.COUNTER_CHANGED, pi=newv)

    # ---- physics model set_color / set_skin
    setc_m, setc_pf, _ = recv_param(Input.SET_COLOR, (ParamType.COLOR,))
    setc = setc_m & (cls == int(ActorClass.PHYSICS_MODEL))
    actors = actors.replace(mod_color=torch.where(setc[..., None], setc_pf, actors.mod_color))
    sets_m, _, sets_pi = recv_param(Input.SET_SKIN, (ParamType.BYTE, ParamType.INTEGER, ParamType.UINT_64))
    sets = sets_m & (cls == int(ActorClass.PHYSICS_MODEL))
    actors = actors.replace(skin=torch.where(sets, sets_pi, actors.skin))

    # ---- sound player: op bits accumulate here and drain once per tick
    # (core/step.py::_apply_sound_ops)
    play = m_cls(recv(Input.PLAY), ActorClass.SOUND_PLAYER) & actors.active
    pause = m_cls(recv(Input.PAUSE), ActorClass.SOUND_PLAYER)
    stop = m_cls(recv(Input.STOP), ActorClass.SOUND_PLAYER)
    resume = m_cls(recv(Input.RESUME), ActorClass.SOUND_PLAYER)
    actors = actors.replace(
        idata=set_col(actors.idata, 0, torch.where(play | resume, 1, torch.where(stop | pause, 0, actors.idata[..., 0])))
    )
    ops = play.int() | (pause.int() << 1) | (stop.int() << 2) | (resume.int() << 3)
    state = state.replace(
        sound_ops=state.sound_ops | ops,
        sound_plays=state.sound_plays + play.sum(-1, dtype=torch.int32),
    )

    state = state.replace(actors=actors, env=env)
    return state, fired, fired_pi
