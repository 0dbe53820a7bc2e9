"""CompiledMap (static per-map tensors) and EnvState (per-env mutable state)
as dataclasses of tensors (counterpart of c_game_engine_tpu/core/state.py).

Field names, shapes and dtypes match the JAX pytrees leaf for leaf, so a
state carries over between the two packages by name (`state_from_numpy`,
`state_to_numpy`). A batched state has a leading [B] axis on every leaf.

Maps come from the port's compiler (compiler/compile.py) or from plain
files: `load_map` reads the numpy leaves and the JSON `aux` dict that
`save_map` (the compile cache, compiler/cache.py) and
tests/torch_export_map.py (the committed maps) write.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import Any

import numpy as np
import torch

# copied from c_game_engine_tpu/core/state.py:21-27
PAIR_WARM_CAP = 16
EVENT_CAPACITY = 16
SIGNAL_ROUNDS = 4

# aux entries the JSON export turns from tuples into lists
_AUX_TUPLES = ("grid_shape", "dyn_is_box")


class Crosshair:
    # engine/src/physics/PlayerPhysics.c crosshairColor states
    NORMAL = 0
    INTERACTABLE = 1
    INVISIBLE = 2


class Struct:
    """Dataclass mixin: functional `replace`, like flax's struct.dataclass."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def tree_map(fn, obj, *rest):
    """Apply fn to every tensor leaf of a (nested) Struct, and to the
    matching leaves of `rest` (Structs of the same type); other fields
    (CompiledMap.aux) pass through."""
    if isinstance(obj, torch.Tensor):
        return fn(obj, *rest)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(
            obj,
            **{
                f.name: tree_map(fn, getattr(obj, f.name), *(getattr(r, f.name) for r in rest))
                for f in dataclasses.fields(obj)
            },
        )
    return obj


def tree_leaves(obj, prefix=""):
    """[(dotted name, tensor)] in field order."""
    if isinstance(obj, torch.Tensor):
        return [(prefix, obj)]
    out = []
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out += tree_leaves(getattr(obj, f.name), f"{prefix}.{f.name}" if prefix else f.name)
    return out


@dataclasses.dataclass
class CompiledMap(Struct):
    # field order and meaning: c_game_engine_tpu/core/state.py:38-140
    tris: torch.Tensor
    tri_normal: torch.Tensor
    tri_valid: torch.Tensor
    tri_soa: torch.Tensor
    tri_edge_active: torch.Tensor
    chunk_bounds: torch.Tensor
    grid_lo: torch.Tensor
    grid_inv_cell: torch.Tensor
    grid_cells: torch.Tensor
    dyn_slots: torch.Tensor
    actor_to_dyn: torch.Tensor
    cls: torch.Tensor
    init_active: torch.Tensor
    init_pos: torch.Tensor
    init_quat: torch.Tensor
    init_visible: torch.Tensor
    init_skin: torch.Tensor
    init_mod_color: torch.Tensor
    init_fdata: torch.Tensor
    init_idata: torch.Tensor
    flags: torch.Tensor
    sfparams: torch.Tensor
    siparams: torch.Tensor
    motion: torch.Tensor
    shape: torch.Tensor
    halfext: torch.Tensor
    hull_verts: torch.Tensor
    shape_center: torch.Tensor
    layer: torch.Tensor
    mass: torch.Tensor
    inv_mass: torch.Tensor
    inv_inertia: torch.Tensor
    friction: torch.Tensor
    restitution: torch.Tensor
    sensor_owner: torch.Tensor
    sensor_pos: torch.Tensor
    sensor_quat: torch.Tensor
    sensor_halfext: torch.Tensor
    sensor_follow: torch.Tensor
    edge_src: torch.Tensor
    edge_out: torch.Tensor
    edge_dst: torch.Tensor
    edge_in: torch.Tensor
    edge_ptype: torch.Tensor
    edge_pf: torch.Tensor
    edge_pi: torch.Tensor
    init_ev_target: torch.Tensor
    init_ev_input: torch.Tensor
    init_ev_ptype: torch.Tensor
    init_ev_pf: torch.Tensor
    init_ev_pi: torch.Tensor
    init_ev_count: torch.Tensor
    wall_axis: torch.Tensor
    wall_size: torch.Tensor
    wall_center: torch.Tensor
    wall_uv_scale: torch.Tensor
    wall_uv_offset: torch.Tensor
    wall_tex: torch.Tensor
    wall_unshaded: torch.Tensor
    model_id: torch.Tensor
    billboard: torch.Tensor
    spawn_pos: torch.Tensor
    spawn_yaw: torch.Tensor
    spawn_pitch: torch.Tensor
    default_light: torch.Tensor
    default_fog_color: torch.Tensor
    default_fog_start: torch.Tensor
    default_fog_end: torch.Tensor
    default_exposure: torch.Tensor
    sound_len: torch.Tensor
    map_verts: torch.Tensor
    map_indices: torch.Tensor
    map_vert_tex: torch.Tensor
    map_vert_shaded: torch.Tensor
    lightmap: torch.Tensor
    point_lights: torch.Tensor
    # static host-side metadata (the JAX compiler's aux dict, minus the
    # asset resolver)
    aux: Any = None

    @property
    def num_actors(self) -> int:
        return self.cls.shape[0]

    @property
    def num_sensors(self) -> int:
        return self.sensor_owner.shape[0]

    @property
    def device(self) -> torch.device:
        return self.cls.device

    @functools.cached_property
    def laser_idx(self) -> torch.Tensor:
        """[L] long actor rows of class LASER, on the map's device (found
        once per map: the JAX tick reads np.asarray(cmap.cls) at trace
        time)."""
        from refsim.actors.defs import ActorClass

        return torch.nonzero(self.cls == int(ActorClass.LASER))[:, 0]

    @functools.cached_property
    def dyn_is_box(self) -> torch.Tensor:
        """[D] bool per dynamic slot: True where the body's support is the
        closed-form box (aux['dyn_is_box'], a static tuple in JAX)."""
        return torch.tensor(self.aux["dyn_is_box"], dtype=torch.bool, device=self.device)

    @functools.cached_property
    def tri16(self) -> torch.Tensor:
        """[T', 16] kernel triangle table (ax..cz, normal, valid, the three
        active-edge flags AB BC CA) with T' padded to a T_CHUNK multiple —
        what the JAX package rebuilds per call at physics/batched.py:531-541
        for the body-contact kernel. The capsule and ray kernels read only
        columns 0-12 (the JAX package zero-fills 13-15 for them,
        physics/batched.py:259-269 and :391-398), so one table serves all
        three."""
        from refsim.ops.capsule_resolve import T_CHUNK

        t = self.tri_soa.shape[1]
        tri16 = torch.cat(
            [self.tri_soa.T, self.tri_valid[:, None].float(), self.tri_edge_active.float()],
            dim=1,
        )
        t_pad = (-t) % T_CHUNK
        if t_pad:
            tri16 = torch.cat(
                [tri16, torch.zeros((t_pad, 16), dtype=torch.float32, device=self.device)], 0
            )
        return tri16.contiguous()


def map_from_numpy(leaves: dict, aux: dict, device) -> CompiledMap:
    """CompiledMap from {field: ndarray} plus the aux dict."""
    aux = dict(aux)
    for k in _AUX_TUPLES:
        if k in aux and isinstance(aux[k], list):
            aux[k] = tuple(aux[k])
    kw = {}
    for f in dataclasses.fields(CompiledMap):
        if f.name == "aux":
            continue
        kw[f.name] = torch.from_numpy(np.array(leaves[f.name])).to(device)
    return CompiledMap(**kw, aux=aux)


def load_map(npz_path, json_path, device) -> CompiledMap:
    """Read a map exported by tests/torch_export_map.py onto `device`."""
    with np.load(npz_path) as z:
        leaves = {k: z[k] for k in z.files}
    with open(json_path) as f:
        aux = json.load(f)
    return map_from_numpy(leaves, aux, device)


@dataclasses.dataclass
class PlayerState(Struct):
    pos: torch.Tensor  # [3] capsule center position (character origin)
    vel: torch.Tensor  # [3]
    yaw: torch.Tensor  # [] radians; player faces -Z at yaw 0
    pitch: torch.Tensor  # [] radians in [-pi/2, pi/2]; 0 = level
    on_ground: torch.Tensor  # [] bool
    noclip: torch.Tensor  # [] bool
    freecam: torch.Tensor  # [] bool
    freecam_pos: torch.Tensor  # [3]
    held_actor: torch.Tensor  # [] i32 (-1 none)
    targeted_actor: torch.Tensor  # [] i32 (-1 none)
    targeted_fraction: torch.Tensor  # [] f32 (hit fraction of the 10u ray)
    can_drop_held: torch.Tensor  # [] bool
    view_bob: torch.Tensor  # [] f32
    crosshair: torch.Tensor  # [] i32


@dataclasses.dataclass
class ActorsState(Struct):
    active: torch.Tensor  # [N] bool
    pos: torch.Tensor  # [N, 3]
    quat: torch.Tensor  # [N, 4]
    vel: torch.Tensor  # [N, 3]
    omega: torch.Tensor  # [N, 3]
    visible: torch.Tensor  # [N] bool
    skin: torch.Tensor  # [N] i32
    mod_color: torch.Tensor  # [N, 4]
    fdata: torch.Tensor  # [N, FD]
    idata: torch.Tensor  # [N, ID]
    sleep: torch.Tensor  # [N] i32 ticks below the sleep threshold
    warm_n: torch.Tensor  # [N] f32 body-vs-world warm-start impulse
    warm_pair: torch.Tensor  # [PAIR_WARM_CAP] f32 pair warm-start impulse
    warm_pair_idx: torch.Tensor  # [PAIR_WARM_CAP] i32 flat pair key, -1 empty


@dataclasses.dataclass
class EnvGlobals(Struct):
    light_color: torch.Tensor  # [4]
    fog_color: torch.Tensor  # [4]
    fog_start: torch.Tensor  # []
    fog_end: torch.Tensor  # []
    exposure: torch.Tensor  # []
    light_interp_actor: torch.Tensor  # [] i32 (-1 inactive)
    light_interp_start: torch.Tensor  # [] i32 start tick
    light_interp_prev: torch.Tensor  # [4]
    fog_interp_actor: torch.Tensor  # [] i32
    fog_interp_start: torch.Tensor  # [] i32
    fog_interp_prev: torch.Tensor  # [6] color(4), start, end
    tonemap_interp_actor: torch.Tensor  # [] i32
    tonemap_interp_start: torch.Tensor  # [] i32
    tonemap_interp_prev: torch.Tensor  # []


@dataclasses.dataclass
class SaveData(Struct):
    coins: torch.Tensor  # [] i32 (clamped to 9999)
    blue_coins: torch.Tensor  # [] i32 (clamped to 5)
    hp: torch.Tensor  # [] i32
    item_mask: torch.Tensor  # [] i32 bitmask of held item ids
    current_item: torch.Tensor  # [] i32 (-1 none)


@dataclasses.dataclass
class EventQueue(Struct):
    target: torch.Tensor  # [Q] i32
    input: torch.Tensor  # [Q] i32
    ptype: torch.Tensor  # [Q] i32
    pf: torch.Tensor  # [Q, 4]
    pi: torch.Tensor  # [Q] i32
    count: torch.Tensor  # [] i32
    dropped: torch.Tensor  # [] i32 (overflow diagnostics)


@dataclasses.dataclass
class EnvState(Struct):
    player: PlayerState
    actors: ActorsState
    env: EnvGlobals
    save: SaveData
    events: EventQueue
    sensor_inside: torch.Tensor  # [S] bool — player overlap last tick
    camera_actor: torch.Tensor  # [] i32 (-1 = player camera)
    sound_plays: torch.Tensor  # [] i32 cumulative play events
    audio: Any  # AudioState — 32-channel table (audio/mixer.py)
    sound_ops: torch.Tensor  # [N] i32 per-actor sound-op bits of this tick
    tick: torch.Tensor  # [] i32 per-map tick
    frame: torch.Tensor  # [] i32 engine-uptime frame (carried across maps)


def _i32(v, device):
    return torch.tensor(v, dtype=torch.int32, device=device)


def _f32(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def empty_events(device, batch_shape=()) -> EventQueue:
    q = EVENT_CAPACITY
    z = lambda *s, dt=torch.int32: torch.zeros((*batch_shape, *s), dtype=dt, device=device)
    return EventQueue(
        target=torch.full((*batch_shape, q), -1, dtype=torch.int32, device=device),
        input=z(q),
        ptype=torch.full((*batch_shape, q), 5, dtype=torch.int32, device=device),  # NONE
        pf=z(q, 4, dt=torch.float32),
        pi=z(q),
        count=z(),
        dropped=z(),
    )


def reset(cmap: CompiledMap) -> EnvState:
    """Fresh single-env state from the compiled map (reset_batch broadcasts
    it over a batch)."""
    from refsim.audio.mixer import empty_audio

    dev = cmap.device
    n = cmap.num_actors
    player = PlayerState(
        pos=cmap.spawn_pos.clone(),
        vel=torch.zeros(3, dtype=torch.float32, device=dev),
        yaw=cmap.spawn_yaw.clone(),
        pitch=cmap.spawn_pitch.clone(),
        on_ground=torch.tensor(False, device=dev),
        noclip=torch.tensor(False, device=dev),
        freecam=torch.tensor(False, device=dev),
        freecam_pos=cmap.spawn_pos.clone(),
        held_actor=_i32(-1, dev),
        targeted_actor=_i32(-1, dev),
        targeted_fraction=_f32(1.0, dev),
        can_drop_held=torch.tensor(True, device=dev),
        view_bob=_f32(0.0, dev),
        crosshair=_i32(Crosshair.NORMAL, dev),
    )
    actors = ActorsState(
        active=cmap.init_active.clone(),
        pos=cmap.init_pos.clone(),
        quat=cmap.init_quat.clone(),
        vel=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        omega=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        visible=cmap.init_visible.clone(),
        skin=cmap.init_skin.clone(),
        mod_color=cmap.init_mod_color.clone(),
        fdata=cmap.init_fdata.clone(),
        idata=cmap.init_idata.clone(),
        sleep=torch.zeros(n, dtype=torch.int32, device=dev),
        warm_n=torch.zeros(n, dtype=torch.float32, device=dev),
        warm_pair=torch.zeros(PAIR_WARM_CAP, dtype=torch.float32, device=dev),
        warm_pair_idx=torch.full((PAIR_WARM_CAP,), -1, dtype=torch.int32, device=dev),
    )
    env = EnvGlobals(
        light_color=cmap.default_light.clone(),
        fog_color=cmap.default_fog_color.clone(),
        fog_start=cmap.default_fog_start.clone(),
        fog_end=cmap.default_fog_end.clone(),
        exposure=cmap.default_exposure.clone(),
        light_interp_actor=_i32(-1, dev),
        light_interp_start=_i32(0, dev),
        light_interp_prev=torch.zeros(4, dtype=torch.float32, device=dev),
        fog_interp_actor=_i32(-1, dev),
        fog_interp_start=_i32(0, dev),
        fog_interp_prev=torch.zeros(6, dtype=torch.float32, device=dev),
        tonemap_interp_actor=_i32(-1, dev),
        tonemap_interp_start=_i32(0, dev),
        tonemap_interp_prev=_f32(0.0, dev),
    )
    save = SaveData(
        coins=_i32(0, dev),
        blue_coins=_i32(0, dev),
        hp=_i32(100, dev),
        item_mask=_i32(0, dev),
        current_item=_i32(-1, dev),
    )
    events = EventQueue(
        target=cmap.init_ev_target.clone(),
        input=cmap.init_ev_input.clone(),
        ptype=cmap.init_ev_ptype.clone(),
        pf=cmap.init_ev_pf.clone(),
        pi=cmap.init_ev_pi.clone(),
        count=cmap.init_ev_count.clone(),
        dropped=_i32(0, dev),
    )
    return EnvState(
        player=player,
        actors=actors,
        env=env,
        save=save,
        events=events,
        sensor_inside=torch.zeros(cmap.num_sensors, dtype=torch.bool, device=dev),
        camera_actor=_i32(-1, dev),
        sound_plays=_i32(0, dev),
        audio=empty_audio(dev),
        sound_ops=torch.zeros(n, dtype=torch.int32, device=dev),
        tick=_i32(0, dev),
        frame=_i32(0, dev),
    )


