"""KvList / Param tagged union (counterpart of
c_game_engine_tpu/assets/kvlist.py): the JSON codec of mapSources and the
binary codec of `.gkvl`/`.kvl` files and `.gmap` actor params.

The reference's Param/KvList (KVList.h:41-79, KVList.c:19-265). Binary:
KvList = u64 count + (string key, Param); Param = u8 type tag + value.
"""

from __future__ import annotations

import enum
from typing import Any

from c_game_engine_tpu_torch.assets.reader import Reader, Writer


class ParamType(enum.IntEnum):
    # reference: engine/include/engine/structs/KVList.h:41-53
    BYTE = 0
    INTEGER = 1
    FLOAT = 2
    BOOL = 3
    STRING = 4
    NONE = 5
    COLOR = 6
    KV_LIST = 7
    ARRAY = 8
    UINT_64 = 9
    VEC2 = 10
    VEC3 = 11


# JSON "type" strings used in mapSources/*.json
_JSON_NAMES = {
    "byte": ParamType.BYTE,
    "int": ParamType.INTEGER,
    "integer": ParamType.INTEGER,
    "float": ParamType.FLOAT,
    "bool": ParamType.BOOL,
    "string": ParamType.STRING,
    "none": ParamType.NONE,
    "color": ParamType.COLOR,
    "kvlist": ParamType.KV_LIST,
    "array": ParamType.ARRAY,
    "uint64": ParamType.UINT_64,
    "u64": ParamType.UINT_64,
    "vec2": ParamType.VEC2,
    "vec3": ParamType.VEC3,
}


class Param:
    __slots__ = ("type", "value")

    def __init__(self, type: ParamType, value: Any):
        self.type = ParamType(type)
        self.value = value

    def __repr__(self):
        return f"Param({self.type.name}, {self.value!r})"

    def __eq__(self, other):
        return isinstance(other, Param) and other.type == self.type and other.value == self.value

    @staticmethod
    def none() -> "Param":
        return Param(ParamType.NONE, None)

    @staticmethod
    def from_json(obj: dict) -> "Param":
        t = _JSON_NAMES[obj["type"].lower()]
        v = obj.get("value")
        if t == ParamType.COLOR:
            v = (float(v["r"]), float(v["g"]), float(v["b"]), float(v["a"]))
        elif t == ParamType.VEC2:
            v = (float(v["x"]), float(v["y"]))
        elif t == ParamType.VEC3:
            v = (float(v["x"]), float(v["y"]), float(v["z"]))
        elif t == ParamType.KV_LIST:
            v = kvlist_from_json(v)
        elif t == ParamType.ARRAY:
            v = [Param.from_json(e) for e in v]
        elif t == ParamType.BOOL:
            v = bool(v)
        elif t in (ParamType.BYTE, ParamType.INTEGER, ParamType.UINT_64):
            v = int(v)
        elif t == ParamType.FLOAT:
            v = float(v)
        return Param(t, v)


def kvlist_from_json(obj: dict) -> dict[str, Param]:
    return {k: Param.from_json(v) for k, v in obj.items()}


# ---------------------------------------------------------------------------
# typed getters with defaults (KvGet* semantics: wrong type -> default)
# ---------------------------------------------------------------------------


def _get(params: dict[str, Param], key: str, t: ParamType, default):
    p = params.get(key)
    if p is None or p.type != t:
        return default
    return p.value


def get_byte(params, key, default=0):
    return _get(params, key, ParamType.BYTE, default)


def get_int(params, key, default=0):
    return _get(params, key, ParamType.INTEGER, default)


def get_float(params, key, default=0.0):
    return _get(params, key, ParamType.FLOAT, default)


def get_bool(params, key, default=False):
    return _get(params, key, ParamType.BOOL, default)


def get_string(params, key, default=""):
    return _get(params, key, ParamType.STRING, default)


def get_color(params, key, default=(1.0, 1.0, 1.0, 1.0)):
    return _get(params, key, ParamType.COLOR, default)


def get_vec2(params, key, default=(0.0, 0.0)):
    return _get(params, key, ParamType.VEC2, default)


def get_vec3(params, key, default=(0.0, 0.0, 0.0)):
    return _get(params, key, ParamType.VEC3, default)


# ---------------------------------------------------------------------------
# binary codec
# ---------------------------------------------------------------------------


def read_param(r: Reader) -> Param:
    t = ParamType(r.u8())
    if t == ParamType.BYTE:
        return Param(t, r.u8())
    if t == ParamType.INTEGER:
        return Param(t, r.i32())
    if t == ParamType.FLOAT:
        return Param(t, r.f32())
    if t == ParamType.BOOL:
        return Param(t, r.u8() != 0)
    if t == ParamType.STRING:
        return Param(t, r.string())
    if t == ParamType.COLOR:
        return Param(t, tuple(r.f32() for _ in range(4)))
    if t == ParamType.ARRAY:
        n = r.u64()
        return Param(t, [read_param(r) for _ in range(n)])
    if t == ParamType.KV_LIST:
        return Param(t, read_kvlist(r))
    if t == ParamType.UINT_64:
        return Param(t, r.u64())
    if t == ParamType.VEC2:
        return Param(t, (r.f32(), r.f32()))
    if t == ParamType.VEC3:
        return Param(t, (r.f32(), r.f32(), r.f32()))
    return Param(ParamType.NONE, None)


def read_kvlist(r: Reader) -> dict[str, Param]:
    n = r.u64()
    out = {}
    for _ in range(n):
        key = r.string()
        out[key] = read_param(r)
    return out


def write_param(w: Writer, p: Param) -> None:
    w.u8(int(p.type))
    t = p.type
    if t == ParamType.BYTE:
        w.u8(p.value)
    elif t == ParamType.INTEGER:
        w.i32(p.value)
    elif t == ParamType.FLOAT:
        w.f32(p.value)
    elif t == ParamType.BOOL:
        w.u8(1 if p.value else 0)
    elif t == ParamType.STRING:
        w.string(p.value)
    elif t == ParamType.COLOR:
        for c in p.value:
            w.f32(c)
    elif t == ParamType.ARRAY:
        w.u64(len(p.value))
        for e in p.value:
            write_param(w, e)
    elif t == ParamType.KV_LIST:
        write_kvlist(w, p.value)
    elif t == ParamType.UINT_64:
        w.u64(p.value)
    elif t == ParamType.VEC2:
        w.f32(p.value[0]).f32(p.value[1])
    elif t == ParamType.VEC3:
        w.f32(p.value[0]).f32(p.value[1]).f32(p.value[2])


def write_kvlist(w: Writer, kv: dict[str, Param]) -> None:
    w.u64(len(kv))
    for k, p in kv.items():
        w.string(k)
        write_param(w, p)
