"""Typed decoders for the shipped `.g*` asset payloads (counterpart of
c_game_engine_tpu/assets/codecs.py), host side, numpy:

  .gtex  engine/src/assets/TextureLoader.c:70-140 (w, h u64; filter,
         repeat, mipmaps, pixelFormat u8; RGBA8 or RGBA16F pixels)
  .gfon  engine/src/assets/FontLoader.c:79-110
  .gsnd  a whole WAV file

`decode_gmdl` and `decode_gmtl` come with the compiler (ROADMAP §1 item 7)."""

from __future__ import annotations

import io
import wave
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from c_game_engine_tpu_torch.assets.container import AssetType, read_asset
from c_game_engine_tpu_torch.assets.reader import PayloadError, Reader


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
