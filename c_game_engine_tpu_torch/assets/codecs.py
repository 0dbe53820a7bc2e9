"""Typed decoders for the shipped `.g*` asset payloads (counterpart of
c_game_engine_tpu/assets/codecs.py). Only the sound decoder is ported:
`decode_gtex`, `decode_gmdl`, `decode_gmtl` and `decode_gfon` come with
the compiler and the app layer."""

from __future__ import annotations

import io
import wave
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from c_game_engine_tpu_torch.assets.container import AssetType, read_asset
from c_game_engine_tpu_torch.assets.reader import PayloadError


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
