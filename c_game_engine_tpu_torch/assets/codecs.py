"""Typed decoders for the shipped `.g*` asset payloads (counterpart of
c_game_engine_tpu/assets/codecs.py), host side, numpy:

  .gtex  engine/src/assets/TextureLoader.c:70-140 (w, h u64; filter,
         repeat, mipmaps, pixelFormat u8; RGBA8 or RGBA16F pixels)
  .gmdl  engine/src/assets/ModelLoader.c:34-217 (materials, skins, LODs of
         packed ModelVertex {pos 3f, uv 2f, color 4f, normal 3f}, AABB,
         collision hulls or a static trimesh)
  .gmtl  engine/src/assets/MapMaterialLoader.c:17-80 (texture path, 2
         editor floats skipped, shader u8, soundClass u8)
  .gfon  engine/src/assets/FontLoader.c:79-110
  .gsnd  a whole WAV file"""

from __future__ import annotations

import enum
import io
import wave
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from c_game_engine_tpu_torch.assets.container import AssetType, read_asset
from c_game_engine_tpu_torch.assets.reader import PayloadError, Reader


class ModelShader(enum.IntEnum):
    # engine/include/engine/assets/ModelLoader.h:34-43
    SKY = 0
    SHADED = 1
    UNSHADED = 2


class CollisionModelType(enum.IntEnum):
    # engine/include/engine/assets/ModelLoader.h (COLLISION_MODEL_TYPE_*)
    NONE = 0
    STATIC = 1
    DYNAMIC = 2


@dataclass
class Texture:
    width: int
    height: int
    filter: bool
    repeat: bool
    mipmaps: bool
    pixels: np.ndarray  # [H, W, 4] float32 in [0,1] (RGBA8 normalized or RGBA16F)


def decode_gtex(path: str | Path) -> Texture:
    asset = read_asset(path)
    if asset.type != AssetType.TEXTURE:
        raise PayloadError(f"{path}: not a texture asset")
    r = Reader(asset.data)
    w, h = r.u64(), r.u64()
    filt, repeat, mipmaps = r.u8() != 0, r.u8() != 0, r.u8() != 0
    pixel_format = r.u8()
    if pixel_format == 0:  # RGBA8
        px = np.frombuffer(r.raw(w * h * 4), dtype=np.uint8).reshape(h, w, 4).astype(np.float32) / 255.0
    else:  # RGBA16F
        px = np.frombuffer(r.raw(w * h * 8), dtype=np.float16).reshape(h, w, 4).astype(np.float32)
    return Texture(w, h, filt, repeat, mipmaps, px)


def checkerboard_fallback(size: int = 64) -> Texture:
    """Magenta/black checkerboard, the reference's missing-texture image
    (TextureLoader.c:49-70)."""
    yy, xx = np.mgrid[0:size, 0:size]
    cell = ((xx // (size // 2)) + (yy // (size // 2))) % 2
    px = np.zeros((size, size, 4), dtype=np.float32)
    px[..., 0] = cell
    px[..., 2] = cell
    px[..., 3] = 1.0
    return Texture(size, size, False, True, False, px)


@dataclass
class ModelLod:
    distance_squared: float
    vertices: np.ndarray  # [V, 12] f32: pos(3) uv(2) color(4) normal(3)
    indices: list[np.ndarray]  # per material slot, u32


@dataclass
class Model:
    materials: list[dict]  # {texture, color[4], shader}
    skins: np.ndarray  # [numSkins, numSlots] u32 -> material index
    lods: list[ModelLod]
    aabb_origin: np.ndarray  # [3]
    aabb_extents: np.ndarray  # [3] half extents
    collision_type: CollisionModelType
    hulls: list[dict] = field(default_factory=list)  # {offset[3], points [P,3]}
    static_tris: np.ndarray | None = None  # [T, 3, 3]


def decode_gmdl(path: str | Path) -> Model:
    asset = read_asset(path)
    if asset.type != AssetType.MODEL:
        raise PayloadError(f"{path}: not a model asset")
    r = Reader(asset.data)
    n_materials, n_slots, n_skins, n_lods = r.u32(), r.u32(), r.u32(), r.u32()
    collision_type = CollisionModelType(r.u8())

    materials = []
    for _ in range(n_materials):
        tex = r.string()
        color = np.array([r.f32() for _ in range(4)], dtype=np.float32)
        materials.append({"texture": tex, "color": color, "shader": ModelShader(r.u32())})

    skins = np.zeros((n_skins, n_slots), dtype=np.uint32)
    for i in range(n_skins):
        for j in range(n_slots):
            skins[i, j] = r.u32()

    lods = []
    for _ in range(n_lods):
        r.skip(4)  # the non-squared lod distance (the reference skips it too)
        dist_sq = r.f32()
        n_verts = r.u64()
        verts = np.frombuffer(r.raw(n_verts * 12 * 4), dtype=np.float32).reshape(n_verts, 12)
        r.u32()  # total index count
        counts = [r.u32() for _ in range(n_slots)]
        indices = [np.frombuffer(r.raw(c * 4), dtype=np.uint32).copy() for c in counts]
        lods.append(ModelLod(dist_sq, verts.copy(), indices))

    aabb_origin = np.array([r.f32() for _ in range(3)], dtype=np.float32)
    aabb_extents = np.array([r.f32() for _ in range(3)], dtype=np.float32)

    hulls: list[dict] = []
    static_tris = None
    if collision_type == CollisionModelType.DYNAMIC:
        for _ in range(r.u64()):
            n_points = r.u64()
            offset = np.array([r.f32() for _ in range(3)], dtype=np.float32)
            pts = np.frombuffer(r.raw(n_points * 12), dtype=np.float32).reshape(n_points, 3)
            hulls.append({"offset": offset, "points": pts.copy()})
    elif collision_type == CollisionModelType.STATIC:
        n_tris = r.u64()
        static_tris = np.frombuffer(r.raw(n_tris * 36), dtype=np.float32).reshape(n_tris, 3, 3).copy()

    return Model(materials, skins, lods, aabb_origin, aabb_extents, collision_type, hulls, static_tris)


@dataclass
class MapMaterial:
    texture: str
    shader: ModelShader
    sound_class: int


def decode_gmtl(path: str | Path) -> MapMaterial:
    asset = read_asset(path)
    if asset.type != AssetType.MAP_MATERIAL:
        raise PayloadError(f"{path}: not a map material asset")
    r = Reader(asset.data)
    texture = r.string()
    r.skip(8)  # default uv scale, editor-only (MapMaterialLoader.c:62-63)
    shader = ModelShader(r.u8())
    sound_class = r.u8()
    return MapMaterial(texture, shader, sound_class)


@dataclass
class Font:
    texture: str
    width: int
    texture_height: int
    baseline: int
    char_spacing: int
    line_spacing: int
    space_width: int
    default_size: int
    uppercase_only: bool
    chars: str
    widths: np.ndarray  # [nchars] u8
    start_uvs: np.ndarray  # [nchars] f32
    end_uvs: np.ndarray  # [nchars] f32


def decode_gfon(path: str | Path, texture_width: int | None = None) -> Font:
    """Decode a bitmap font. UV tables follow FontLoader.c:108-119 (per-char
    start/end U from the glyph index and the texture width; pass
    `texture_width` to reproduce the end-UV inset exactly)."""
    asset = read_asset(path)
    if asset.type != AssetType.FONT:
        raise PayloadError(f"{path}: not a font asset")
    r = Reader(asset.data)
    # FontLoader.c:79-107
    width, texture_height, baseline, char_spacing = r.u8(), r.u8(), r.u8(), r.u8()
    line_spacing, space_width, default_size = r.u8(), r.u8(), r.u8()
    uppercase_only = r.u8() != 0
    texture = "texture/" + r.string() + ".gtex"
    n = r.u8()
    chars = []
    widths = np.zeros(n, dtype=np.uint8)
    for i in range(n):
        chars.append(chr(r.u8()))
        widths[i] = r.u8()
    idx = np.arange(n, dtype=np.float64)
    start_uvs = (idx / n).astype(np.float32)
    inset = 1.0 / texture_width if texture_width else 0.0
    end_uvs = ((idx + 1) / n - inset).astype(np.float32)
    return Font(texture, width, texture_height, baseline, char_spacing, line_spacing, space_width, default_size,
                uppercase_only, "".join(chars), widths, start_uvs, end_uvs)


@dataclass
class Sound:
    """Decoded PCM audio from a .gsnd asset.

    The payload is a whole WAV file (ASSET_TYPE_WAV; the reference hands
    the bytes to SDL3_mixer, SoundSystem.c:293-318). PCM16 and PCM8 decode
    to float32 stereo: mono is doubled, channels past 2 are dropped."""

    pcm: np.ndarray  # [frames, 2] f32 in [-1, 1]
    rate: int


def decode_gsnd(path: str | Path) -> Sound:
    asset = read_asset(path)
    if asset.type != AssetType.WAV:
        raise PayloadError(f"{path}: not a sound asset")
    w = wave.open(io.BytesIO(asset.data))
    n = w.getnframes()
    raw = w.readframes(n)
    width = w.getsampwidth()
    ch = w.getnchannels()
    if width == 2:
        pcm = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 1:
        pcm = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise PayloadError(f"{path}: unsupported WAV sample width {width}")
    pcm = pcm.reshape(n, ch)
    if ch == 1:
        pcm = np.repeat(pcm, 2, axis=1)
    elif ch > 2:
        pcm = pcm[:, :2]
    return Sound(pcm=np.ascontiguousarray(pcm), rate=w.getframerate())
