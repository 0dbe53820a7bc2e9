"""Per-class actor compilation (counterpart of
c_game_engine_tpu/compiler/actor_rows.py): turns one map-actor record
(class string + transform + KvList params) into a dense table row,
reproducing each class's Init() from the reference (citations inline).

The euler->quat at load time follows MapLoader.c:82-88
(JPH_Quat_FromEulerAngles).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from c_game_engine_tpu_torch.actors.defs import (
    ActorClass,
    ActorFlags,
    DoorState,
    LaserHeight,
    Layer,
    Motion,
    NUM_FDATA,
    NUM_IDATA,
    NUM_SFPARAMS,
    NUM_SIPARAMS,
    Shape,
)
from c_game_engine_tpu_torch.assets import kvlist as kv

TPS = 60.0


def _quat_from_euler_np(e):
    ex, ey, ez = e[0] * 0.5, e[1] * 0.5, e[2] * 0.5
    cx, sx = math.cos(ex), math.sin(ex)
    cy, sy = math.cos(ey), math.sin(ey)
    cz, sz = math.cos(ez), math.sin(ez)
    return np.array(
        [
            sx * cy * cz - cx * sy * sz,
            cx * sy * cz + sx * cy * sz,
            cx * cy * sz - sx * sy * cz,
            cx * cy * cz + sx * sy * sz,
        ],
        dtype=np.float32,
    )


def _forward_z(q):
    """+Z axis rotated by q (JPH_Quat_RotateAxisZ)."""
    x, y, z, w = q
    return np.array(
        [2 * (x * z + w * y), 2 * (y * z - w * x), 1 - 2 * (x * x + y * y)],
        dtype=np.float32,
    )


@dataclass
class Row:
    cls: int = 0
    name: str = ""
    active: bool = True
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    quat: np.ndarray = field(default_factory=lambda: np.array([0, 0, 0, 1], np.float32))
    visible: bool = True
    flags: int = 0
    skin: int = 0
    mod_color: np.ndarray = field(default_factory=lambda: np.ones(4, np.float32))
    sf: np.ndarray = field(default_factory=lambda: np.zeros(NUM_SFPARAMS, np.float32))
    si: np.ndarray = field(default_factory=lambda: np.zeros(NUM_SIPARAMS, np.int32))
    fdata: np.ndarray = field(default_factory=lambda: np.zeros(NUM_FDATA, np.float32))
    idata: np.ndarray = field(default_factory=lambda: np.zeros(NUM_IDATA, np.int32))
    # physics
    motion: int = int(Motion.NONE)
    shape: int = int(Shape.EMPTY)
    halfext: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    shape_center: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    layer: int = int(Layer.STATIC)
    mass: float = 0.0
    # support vert cloud relative to shape_center (None -> box corners of
    # halfext); see compiler/models.py support_cloud
    hull_verts: np.ndarray | None = None
    # unit-mass inertia diagonal of the exact collision shape (Jolt's
    # CalculateInertia result / mass; models.py hull_mass_properties).
    # None -> solid-box tensor from halfext.
    inertia_per_mass: np.ndarray | None = None
    rot_lock_y: bool = False  # allow only Y rotation (TestActor.c:42-46)
    friction: float = 0.2  # Jolt body default
    restitution: float = 0.0
    # render
    model: str | None = None
    wall_axis: int = -1  # -1 none, 0 X, 1 Z (ActorWall.h:22-24)
    wall_size: np.ndarray = field(default_factory=lambda: np.zeros(2, np.float32))
    wall_center: np.ndarray = field(default_factory=lambda: np.zeros(2, np.float32))
    wall_uv_scale: np.ndarray = field(default_factory=lambda: np.ones(2, np.float32))
    wall_uv_offset: np.ndarray = field(default_factory=lambda: np.zeros(2, np.float32))
    wall_texture: str | None = None
    wall_unshaded: bool = False
    # sensor attachment (one optional box sensor owned by this actor)
    sensor_halfext: np.ndarray | None = None
    sensor_pos: np.ndarray | None = None  # world
    # follow-sensor: tracks the owner's dynamic body pose at runtime
    # (item_eraser touch pickup rides the body, ItemEraser.c:74-76)
    sensor_follow: bool = False
    # billboarding (ActorYBillboard callers: coin, goal, npc_john)
    billboard: bool = False
    # children spawned at compile time (emitter -> laser)
    children: list = field(default_factory=list)


def _base(ir, cls) -> Row:
    r = Row()
    r.cls = int(cls)
    r.name = kv.get_string(ir.params, "name", "")
    r.pos = np.asarray(ir.position, np.float32).copy()
    r.quat = _quat_from_euler_np(np.asarray(ir.rotation_euler, np.float32))
    return r


def _wall(r: Row, axis, length, height, texture, uv_scale=(1, 1), uv_offset=(0, 0),
          center=(0, 0), unshaded=False):
    r.wall_axis = axis
    r.wall_size = np.array([length, height], np.float32)
    r.wall_center = np.array(center, np.float32)
    r.wall_uv_scale = np.array(uv_scale, np.float32)
    r.wall_uv_offset = np.array(uv_offset, np.float32)
    r.wall_texture = texture
    r.wall_unshaded = unshaded


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


def build_io_proxy(ir, ctx):
    return _base(ir, ActorClass.IO_PROXY)


def build_logic_binary(ir, ctx):
    # LogicBinary.c:63-70
    r = _base(ir, ActorClass.LOGIC_BINARY)
    r.si[0] = kv.get_byte(ir.params, "operation", 0)
    return r


def build_logic_counter(ir, ctx):
    # LogicCounter.c:LogicCounterInit
    r = _base(ir, ActorClass.LOGIC_COUNTER)
    mn = kv.get_int(ir.params, "min", 0)
    mx = kv.get_int(ir.params, "max", 100)
    r.si[0] = mn
    r.si[1] = mx
    r.si[2] = 1 if kv.get_bool(ir.params, "clampToMin", True) else 0
    r.si[3] = 1 if kv.get_bool(ir.params, "clampToMax", True) else 0
    r.idata[0] = int(np.clip(kv.get_int(ir.params, "counter", 0), mn, mx))
    return r


def build_logic_decimal(ir, ctx):
    # LogicDecimal.c:LogicDecimalInit
    r = _base(ir, ActorClass.LOGIC_DECIMAL)
    r.si[0] = kv.get_byte(ir.params, "operation", 0)
    r.fdata[0] = kv.get_float(ir.params, "operandA", 0.0)
    r.fdata[1] = kv.get_float(ir.params, "operandB", 0.0)
    return r


def build_sound_player(ir, ctx):
    # SoundPlayer.c:86-103 SoundPlayerInit: sound (SOUND("%s") prefix),
    # loops, volume, preload (a host streaming concern — N/A here),
    # category byte (default SFX=1 in our id space; the reference enum is
    # MUSIC/SFX/UI = 0/1/2, SoundSystem.h), positional.
    r = _base(ir, ActorClass.SOUND_PLAYER)
    r.idata[0] = 1 if kv.get_bool(ir.params, "autoplay", False) else 0
    r.idata[1] = -1  # live channel handle (SoundChannel* equivalent)
    sound = kv.get_string(ir.params, "sound", "sfx/click")
    r.si[0] = ctx.sound_id(f"sound/{sound}.gsnd")
    r.si[1] = kv.get_byte(ir.params, "category", 1)
    r.si[2] = kv.get_int(ir.params, "loops", 0)
    r.si[3] = 1 if kv.get_bool(ir.params, "positional", False) else 0
    r.sf[0] = kv.get_float(ir.params, "volume", 1.0)
    return r


def build_sprite(ir, ctx):
    # Sprite.c:SpriteInit
    r = _base(ir, ActorClass.SPRITE)
    size = kv.get_vec2(ir.params, "size", (1.0, 1.0))
    _wall(
        r, 0, size[0], size[1],
        kv.get_string(ir.params, "texture", "level/uvtest"),
        kv.get_vec2(ir.params, "uv_scale", (1.0, 1.0)),
        kv.get_vec2(ir.params, "uv_offset", (0.0, 0.0)),
        unshaded=kv.get_bool(ir.params, "unshaded", False),
    )
    r.mod_color = np.array(kv.get_color(ir.params, "color", (1, 1, 1, 1)), np.float32)
    if kv.get_bool(ir.params, "solid", False):
        r.motion = int(Motion.KINEMATIC)
        r.shape = int(Shape.WALL)
        r.halfext = np.array([size[0] / 2, size[1] / 2, 0.02], np.float32)
        r.layer = int(Layer.DYNAMIC)
        r.mass = 1.0
    return r


def build_static_model(ir, ctx):
    # StaticModel.c:StaticModelInit
    r = _base(ir, ActorClass.STATIC_MODEL)
    r.model = kv.get_string(ir.params, "model", "model/quad.gmdl")
    r.skin = kv.get_int(ir.params, "skin", 0)
    r.mod_color = np.array(kv.get_color(ir.params, "color", (1, 1, 1, 1)), np.float32)
    info = ctx.resolver.model(r.model)
    collision = kv.get_byte(ir.params, "collision", 2)
    if collision == 2 and info.model.collision_type == 0:
        collision = 0
    if collision != 0:
        r.motion = int(Motion.STATIC)
        r.shape = int(Shape.BOX)
        r.halfext = info.box_halfext.copy()
        r.layer = int(Layer.STATIC)
        if collision == 1:
            r.flags |= int(ActorFlags.USING_BOUNDING_BOX_COLLISION)
    return r


def build_physics_model(ir, ctx):
    # PhysicsModel.c:PhysicsModelInit
    r = _base(ir, ActorClass.PHYSICS_MODEL)
    r.model = kv.get_string(ir.params, "model", "leafy")
    r.skin = kv.get_int(ir.params, "skin", 0)
    r.mod_color = np.array(kv.get_color(ir.params, "color", (1, 1, 1, 1)), np.float32)
    info = ctx.resolver.model(r.model)
    r.motion = int(Motion.DYNAMIC)
    r.shape = int(Shape.BOX)
    r.halfext = info.box_halfext.copy()
    r.shape_center = info.box_center.copy()
    r.hull_verts = info.hull_verts
    r.inertia_per_mass = info.inertia_per_mass
    r.layer = int(Layer.DYNAMIC)
    mass_override = kv.get_float(ir.params, "mass_override", 0.0)
    r.mass = mass_override if mass_override > 0 else info.mass_default
    if kv.get_bool(ir.params, "allow_pickup", True):
        r.flags |= int(ActorFlags.CAN_BE_HELD)
    return r


def build_trigger(ir, ctx):
    # Trigger.c:TriggerInit
    r = _base(ir, ActorClass.TRIGGER)
    w = kv.get_float(ir.params, "width", 1.0)
    h = kv.get_float(ir.params, "height", 1.0)
    d = kv.get_float(ir.params, "depth", 1.0)
    r.si[0] = 1 if kv.get_bool(ir.params, "oneShot", True) else 0
    r.idata[0] = 1 if kv.get_bool(ir.params, "startEnabled", True) else 0
    r.sensor_halfext = np.array([w / 2, h / 2, d / 2], np.float32)
    r.sensor_pos = r.pos.copy()
    return r


def _build_env_interp(ir, cls):
    r = _base(ir, cls)
    r.si[0] = kv.get_int(ir.params, "interpolation_ticks", 60)
    r.idata[0] = 1 if kv.get_bool(ir.params, "start_on", True) else 0
    return r


def build_global_light(ir, ctx):
    # GlobalLight.c:GlobalLightInit
    r = _build_env_interp(ir, ActorClass.GLOBAL_LIGHT)
    r.sf[0:4] = kv.get_color(ir.params, "light_color", (1, 1, 1, 1))
    return r


def build_global_fog(ir, ctx):
    # GlobalFog.c:GlobalFogInit (defaults: start 10, end 20, color white)
    r = _build_env_interp(ir, ActorClass.GLOBAL_FOG)
    r.sf[0:4] = kv.get_color(ir.params, "fog_color", (1, 1, 1, 1))
    r.sf[4] = kv.get_float(ir.params, "fog_start", 10.0)
    r.sf[5] = kv.get_float(ir.params, "fog_end", 20.0)
    return r


def build_tonemap_controller(ir, ctx):
    # TonemapController.c:TonemapControllerInit
    r = _build_env_interp(ir, ActorClass.TONEMAP_CONTROLLER)
    r.sf[0] = kv.get_float(ir.params, "exposure", 1.0)
    return r


def build_camera(ir, ctx):
    # Camera.c — alternative camera actor; enable/disable swaps state camera
    r = _base(ir, ActorClass.CAMERA)
    r.idata[0] = 1 if kv.get_bool(ir.params, "startEnabled", False) else 0
    return r


def build_button(ir, ctx):
    # Button.c:ButtonInit
    r = _base(ir, ActorClass.BUTTON)
    r.flags |= int(ActorFlags.INTERACTABLE)
    r.model = kv.get_string(ir.params, "model", "model/wall_button.gmdl")
    info = ctx.resolver.model(r.model)
    r.motion = int(Motion.STATIC)
    r.shape = int(Shape.BOX)
    r.halfext = info.box_halfext.copy()
    r.layer = int(Layer.STATIC)
    off_skin = kv.get_int(ir.params, "off_skin", 0)
    on_skin = kv.get_int(ir.params, "on_skin", 1)
    pressed = kv.get_bool(ir.params, "start_pressed", False)
    reset_ms = kv.get_int(ir.params, "reset_delay_ms", -1)
    r.si[0] = off_skin
    r.si[1] = on_skin
    r.si[2] = 1 if kv.get_bool(ir.params, "toggle_mode", False) else 0
    # ms -> ticks; -1 stays -1 (never auto-resets)
    r.si[3] = -1 if reset_ms < 0 else int(round(reset_ms * TPS / 1000.0))
    r.idata[0] = 1 if pressed else 0
    r.fdata[0] = 0.0  # tick pressed
    r.skin = on_skin if pressed else off_skin
    return r


def build_coin(ir, ctx):
    # Coin.c:CoinInit (SIZE=0.25; sensor box with identity rotation)
    r = _base(ir, ActorClass.COIN)
    is_blue = kv.get_bool(ir.params, "isBlue", False)
    r.si[0] = 1 if is_blue else 0
    tex = "texture/actor/bluecoin.gtex" if is_blue else "texture/actor/coin.gtex"
    _wall(r, 0, 0.25, 0.25, tex, uv_scale=(1.0, 4.0))
    r.sensor_halfext = np.array([0.25, 0.25, 0.25], np.float32)
    r.sensor_pos = r.pos.copy()
    r.billboard = True
    return r


def build_door(ir, ctx):
    # Door.c:DoorInit/CreateDoorBodies
    r = _base(ir, ActorClass.DOOR)
    r.flags |= int(ActorFlags.CAN_PUSH_PLAYER | ActorFlags.CAN_BLOCK_LASERS)
    size = kv.get_vec2(ir.params, "size", (1.0, 1.0))
    width, height = float(size[0]), float(size[1])
    _wall(
        r, 1, width, height,
        kv.get_string(ir.params, "texture", "texture/actor/door.gtex"),
        kv.get_vec2(ir.params, "uv_scale", (1.0, 1.0)),
        kv.get_vec2(ir.params, "uv_offset", (0.0, 0.0)),
        unshaded=kv.get_bool(ir.params, "unshaded", False),
    )
    r.mod_color = np.array(kv.get_color(ir.params, "color", (1, 1, 1, 1)), np.float32)
    forward = _forward_z(r.quat)
    closed = r.pos - forward * (width / 2.0)
    opened = r.pos + forward * (width / 2.0)
    r.sf[0] = width
    r.sf[1] = kv.get_float(ir.params, "delay_until_close", 1.0)
    r.sf[2:5] = opened
    # door starts at closed position
    r.pos = closed.astype(np.float32)
    r.si[0] = 1 if kv.get_bool(ir.params, "stayOpen", False) else 0
    r.idata[0] = int(DoorState.CLOSED)
    # collider: kinematic wall quad (Z axis, zero thickness -> box approx)
    r.motion = int(Motion.KINEMATIC)
    r.shape = int(Shape.WALL)
    r.halfext = np.array([0.05, height / 2, width / 2], np.float32)
    r.layer = int(Layer.STATIC)
    r.mass = 1.0
    if not kv.get_bool(ir.params, "preventPlayerOpen", False):
        # sensor box at closed transform (CreateDoorSensor)
        r.sensor_halfext = np.array([0.5, height / 2, width / 2], np.float32)
        r.sensor_pos = closed.copy()
    return r


def build_goal(ir, ctx):
    # Goal.c:GoalInit
    r = _base(ir, ActorClass.GOAL)
    enabled = kv.get_bool(ir.params, "startEnabled", True)
    r.idata[0] = 1 if enabled else 0
    tex = "texture/actor/goal0.gtex" if enabled else "texture/actor/goal1.gtex"
    _wall(r, 0, 1.0, 1.0, tex)
    r.sensor_halfext = np.array([0.5, 0.5, 0.5], np.float32)
    r.sensor_pos = r.pos.copy()
    r.billboard = True
    return r


def _laser_row(pos, quat, height, on, name=""):
    r = Row()
    r.cls = int(ActorClass.LASER)
    r.name = name
    r.pos = pos.astype(np.float32).copy()
    # height offset (Laser.c:196-209)
    if height == int(LaserHeight.FLOOR):
        r.pos[1] += -0.3
    elif height == int(LaserHeight.CEILING):
        r.pos[1] += 0.3
    r.quat = quat.astype(np.float32).copy()
    r.si[0] = int(height)
    r.idata[0] = 1 if on else 0
    tex = (
        "texture/actor/triplelaser.gtex"
        if height == int(LaserHeight.TRIPLE)
        else "texture/actor/laser.gtex"
    )
    _wall(r, 1, 0.0, 1.0, tex, unshaded=True)
    r.visible = bool(on)
    r.fdata[0] = 0.0  # beam length
    r.fdata[1] = 0.0  # uv offset x
    return r


def build_laser(ir, ctx):
    # Laser.c:LaserInit (when placed directly in a map)
    r0 = _base(ir, ActorClass.LASER)
    height = kv.get_byte(ir.params, "height", int(LaserHeight.MIDDLE))
    on = kv.get_bool(ir.params, "startOn", True)
    r = _laser_row(r0.pos, r0.quat, height, on, r0.name)
    return r


def build_laser_emitter(ir, ctx):
    # LaserEmitter.c:LaserEmitterInit — spawns its laser child on the first
    # tick; we pre-spawn it at compile time into a fixed child slot (same
    # observable behavior, static shapes).
    r = _base(ir, ActorClass.LASER_EMITTER)
    r.flags |= int(ActorFlags.CAN_BLOCK_LASERS)
    height = kv.get_byte(ir.params, "height", int(LaserHeight.MIDDLE))
    start_on = kv.get_bool(ir.params, "startOn", True)
    r.si[0] = int(height)
    r.si[1] = 1 if start_on else 0
    r.model = "model/laseremitter.gmdl"
    info = ctx.resolver.model(r.model)
    r.skin = int(height) + 1  # EMITTER_SKIN_* = height + 1
    r.motion = int(Motion.STATIC)
    r.shape = int(Shape.BOX)
    r.halfext = info.box_halfext.copy()
    r.layer = int(Layer.STATIC)
    forward = _forward_z(r.quat)
    laser_pos = r.pos - forward * float(info.model.aabb_extents[2])
    child = _laser_row(laser_pos, r.quat, height, start_on)
    # the child's beam originates on the emitter's (box-approximated)
    # surface; exclude the parent from its raycast (the reference's emitter
    # trimesh collider does not cover the beam origin)
    child.si[1] = -2  # sentinel: compiler rewrites to the parent's index
    r.children.append(child)
    return r


def build_physbox(ir, ctx):
    # Physbox.c:PhysboxInit (cube model, mass 10)
    r = _base(ir, ActorClass.PHYSBOX)
    r.flags |= int(ActorFlags.CAN_BLOCK_LASERS | ActorFlags.CAN_BE_HELD)
    r.model = "model/cube.gmdl"
    info = ctx.resolver.model(r.model)
    r.motion = int(Motion.DYNAMIC)
    r.shape = int(Shape.BOX)
    r.halfext = info.box_halfext.copy()
    r.shape_center = info.box_center.copy()
    r.hull_verts = info.hull_verts
    r.inertia_per_mass = info.inertia_per_mass
    r.layer = int(Layer.DYNAMIC)
    r.mass = 10.0
    return r


def build_test_actor(ir, ctx):
    # TestActor.c:TestActorInit (leafy model, mass 15, Y-only rotation)
    r = _base(ir, ActorClass.TEST_ACTOR)
    r.flags |= int(ActorFlags.CAN_PUSH_PLAYER | ActorFlags.ENEMY)
    r.model = "model/leafy.gmdl"
    info = ctx.resolver.model(r.model)
    r.motion = int(Motion.DYNAMIC)
    r.shape = int(Shape.BOX)
    r.halfext = info.box_halfext.copy()
    r.shape_center = info.box_center.copy()
    r.hull_verts = info.hull_verts
    r.inertia_per_mass = info.inertia_per_mass
    r.layer = int(Layer.DYNAMIC)
    r.mass = 15.0
    r.rot_lock_y = True
    return r


def build_npc_john(ir, ctx):
    # NpcJohn.c:JohnInit (cylinder r=0.25 halfH=0.5 per JPH_CylinderShape_Create
    # (halfHeight=0.5, radius=0.25), mass 15, Y-only rotation, billboard wall)
    r = _base(ir, ActorClass.NPC_JOHN)
    _wall(r, 0, 1.0, 1.0, "texture/actor/john.gtex")
    r.motion = int(Motion.DYNAMIC)
    r.shape = int(Shape.CYLINDER)
    r.halfext = np.array([0.25, 0.5, 0.25], np.float32)
    from c_game_engine_tpu_torch.compiler.models import cylinder_cloud
    r.hull_verts = cylinder_cloud(0.25, 0.5)
    # analytic solid-cylinder tensor (what Jolt's CylinderShape
    # GetMassProperties yields): Iy = m r^2/2, Ix = Iz = m (3r^2 + h^2)/12
    _r2, _h = 0.25 * 0.25, 1.0
    r.inertia_per_mass = np.array(
        [(3 * _r2 + _h * _h) / 12, _r2 / 2, (3 * _r2 + _h * _h) / 12], np.float32
    )
    r.layer = int(Layer.DYNAMIC)
    r.mass = 15.0
    r.rot_lock_y = True
    r.billboard = True
    return r


def build_item_eraser(ir, ctx):
    # ItemEraser.c:ItemEraserInit (eraser_w model, dynamic, default mass)
    r = _base(ir, ActorClass.ITEM_ERASER)
    r.flags |= int(ActorFlags.INTERACTABLE)
    r.model = "model/eraser_w.gmdl"
    info = ctx.resolver.model(r.model)
    r.motion = int(Motion.DYNAMIC)
    r.shape = int(Shape.BOX)
    r.halfext = info.box_halfext.copy()
    r.shape_center = info.box_center.copy()
    r.hull_verts = info.hull_verts
    r.inertia_per_mass = info.inertia_per_mass
    r.layer = int(Layer.DYNAMIC)
    r.mass = info.mass_default
    # touch pickup fires on player-body contact (ItemEraserOnPlayerContactAdded)
    # — modeled as a sensor that follows the dynamic body (PARITY.md #9).
    # +0.05 = Jolt's convex-radius/contact tolerance, so a capsule the
    # contact solver holds flush against the box still registers a touch
    r.sensor_halfext = r.halfext + 0.05
    r.sensor_pos = r.pos + r.shape_center
    r.sensor_follow = True
    return r


BUILDERS = {
    ActorClass.IO_PROXY: build_io_proxy,
    ActorClass.LOGIC_BINARY: build_logic_binary,
    ActorClass.LOGIC_COUNTER: build_logic_counter,
    ActorClass.LOGIC_DECIMAL: build_logic_decimal,
    ActorClass.SOUND_PLAYER: build_sound_player,
    ActorClass.SPRITE: build_sprite,
    ActorClass.STATIC_MODEL: build_static_model,
    ActorClass.PHYSICS_MODEL: build_physics_model,
    ActorClass.TRIGGER: build_trigger,
    ActorClass.GLOBAL_LIGHT: build_global_light,
    ActorClass.GLOBAL_FOG: build_global_fog,
    ActorClass.TONEMAP_CONTROLLER: build_tonemap_controller,
    ActorClass.CAMERA: build_camera,
    ActorClass.BUTTON: build_button,
    ActorClass.COIN: build_coin,
    ActorClass.DOOR: build_door,
    ActorClass.GOAL: build_goal,
    ActorClass.LASER: build_laser,
    ActorClass.LASER_EMITTER: build_laser_emitter,
    ActorClass.PHYSBOX: build_physbox,
    ActorClass.TEST_ACTOR: build_test_actor,
    ActorClass.NPC_JOHN: build_npc_john,
    ActorClass.ITEM_ERASER: build_item_eraser,
}
