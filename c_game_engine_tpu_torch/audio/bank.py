"""SoundBank: every sound a map can play, packed into one tensor
(counterpart of c_game_engine_tpu/audio/bank.py).

All referenced .gsnd PCM is decoded on the host, resampled linearly to one
rate in numpy exactly as the JAX package does (so the PCM is bit-equal to
its bank's), and concatenated into one [S, 2] f32 tensor with an (offset,
length) table: the mixer samples any channel with one gather.
"""

from __future__ import annotations

import dataclasses
import wave

import numpy as np
import torch

from c_game_engine_tpu_torch.assets.codecs import decode_gsnd
from c_game_engine_tpu_torch.core.state import Struct

MIX_RATE = 48000
# 60 Hz fixed tick (engine/include/engine/physics/Physics.h:12-14)
SAMPLES_PER_TICK = MIX_RATE // 60

# sounds the engine/game layer can play regardless of map content
# (uiStack clicks, MainState popup, PauseState popdown, Coin.c:83 cling)
BUILTIN_SOUNDS = (
    "sound/sfx/click.gsnd",
    "sound/sfx/popup.gsnd",
    "sound/sfx/popdown.gsnd",
    "sound/sfx/coincling.gsnd",
)


@dataclasses.dataclass
class SoundBank(Struct):
    pcm: torch.Tensor  # [S, 2] f32 all sounds concatenated at MIX_RATE
    table: torch.Tensor  # [NS, 2] i32 (offset, frames)
    names: tuple = ()

    @property
    def num_sounds(self) -> int:
        return self.table.shape[0]


def _resample(pcm: np.ndarray, rate: int, target: int = MIX_RATE) -> np.ndarray:
    if rate == target or pcm.shape[0] == 0:
        return pcm
    n_out = max(int(round(pcm.shape[0] * target / rate)), 1)
    t = np.arange(n_out, dtype=np.float64) * (rate / target)
    i0 = np.minimum(t.astype(np.int64), pcm.shape[0] - 1)
    i1 = np.minimum(i0 + 1, pcm.shape[0] - 1)
    frac = (t - i0)[:, None].astype(np.float32)
    return pcm[i0] * (1.0 - frac) + pcm[i1] * frac


def build_sound_bank(resolver, names, device="cuda") -> SoundBank:
    """Decode and pack the named sounds (in id order) onto `device`.
    Missing assets become 1-frame silence."""
    chunks, table, kept = [], [], []
    offset = 0
    for name in names:
        path = resolver.resolve(name)
        if path is None:
            pcm = np.zeros((1, 2), np.float32)
        else:
            snd = decode_gsnd(path)
            pcm = _resample(snd.pcm, snd.rate)
        chunks.append(pcm.astype(np.float32))
        table.append((offset, pcm.shape[0]))
        kept.append(name)
        offset += pcm.shape[0]
    if not chunks:
        chunks = [np.zeros((1, 2), np.float32)]
        table = [(0, 1)]
    return SoundBank(
        pcm=torch.from_numpy(np.concatenate(chunks, axis=0)).to(device),
        table=torch.from_numpy(np.array(table, np.int32)).to(device),
        names=tuple(kept),
    )


def write_wav(path, pcm, rate: int = MIX_RATE) -> None:
    """Write a mixed [n, 2] f32 buffer (an array or a tensor on any device)
    as a PCM16 stereo WAV."""
    if isinstance(pcm, torch.Tensor):
        pcm = pcm.detach().cpu().numpy()
    data = np.clip(np.asarray(pcm, np.float32), -1.0, 1.0)
    w = wave.open(str(path), "wb")
    try:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((data * 32767.0).astype("<i2").tobytes())
    finally:
        w.close()


def build_map_sound_bank(cmap, device="cuda") -> SoundBank:
    """Bank for a map: its aux['sound_names'] (the builtins and every
    sound_player asset, ids assigned at compile time), resolved through the
    default search paths (compiler/models.py)."""
    from c_game_engine_tpu_torch.compiler.models import AssetResolver

    names = (cmap.aux or {}).get("sound_names", list(BUILTIN_SOUNDS))
    return build_sound_bank(AssetResolver(), names, device)
