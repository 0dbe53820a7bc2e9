"""Batched 32-channel audio mixer (counterpart of
c_game_engine_tpu/audio/mixer.py): the channel table (allocation, pause,
stop and the per-tick loop/finish bookkeeping, run inside the tick) and
the PCM mix of a window of samples (`mix_frame`, called at whatever
cadence the caller wants, as the reference's mixer renders asynchronously
from the game thread).

Every function here works on a batched table: AudioState leaves are
[B, C], per-actor arguments [B, N] or [N]. `mix_frame` is written with the
batch axis where the JAX package vmaps its single-env function over envs.

Spatialization (as the JAX package, PARITY.md): inverse-distance
attenuation 1/(1+d) and constant-power stereo panning from the
listener-space azimuth.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from refsim.audio.bank import SAMPLES_PER_TICK
from refsim.core.state import Struct
from refsim.utils.mathx import const, quat_conj, quat_from_yaw_pitch, quat_rotate

NUM_CHANNELS = 32  # SOUND_SYSTEM_CHANNEL_COUNT (SoundSystem.h:10)

# sound categories (SoundSystem.h enum SoundCategory)
CATEGORY_MUSIC = 0
CATEGORY_SFX = 1
CATEGORY_UI = 2


@dataclasses.dataclass
class AudioState(Struct):
    """Per-env channel table. A channel is free iff snd < 0."""

    snd: torch.Tensor  # [C] i32 sound id (-1 free)
    elapsed: torch.Tensor  # [C] i32 samples played within the current loop
    loops: torch.Tensor  # [C] i32 remaining EXTRA loops (-1 = infinite)
    volume: torch.Tensor  # [C] f32 original volume (pre category/master)
    category: torch.Tensor  # [C] i32
    positional: torch.Tensor  # [C] bool
    pos: torch.Tensor  # [C, 3] f32 world position
    paused: torch.Tensor  # [C] bool


def empty_audio(device) -> AudioState:
    c = NUM_CHANNELS
    return AudioState(
        snd=torch.full((c,), -1, dtype=torch.int32, device=device),
        elapsed=torch.zeros(c, dtype=torch.int32, device=device),
        loops=torch.zeros(c, dtype=torch.int32, device=device),
        volume=torch.ones(c, dtype=torch.float32, device=device),
        category=torch.zeros(c, dtype=torch.int32, device=device),
        positional=torch.zeros(c, dtype=torch.bool, device=device),
        pos=torch.zeros((c, 3), dtype=torch.float32, device=device),
        paused=torch.zeros(c, dtype=torch.bool, device=device),
    )


def alloc_channels(audio: AudioState, mask, sound, volume, category, loops, positional, pos):
    """Start one sound per set lane of `mask` [B, N]; the other per-actor
    arguments are [N] or [B, N] (pos [B, N, 3]). Events claim free channels
    in actor-index order; events beyond the free supply are dropped.

    Returns (audio, handle [B, N] i32: the claimed channel, -1 if none)."""
    c = audio.snd.shape[-1]
    dev = audio.snd.device
    mask = mask & (sound >= 0)
    free = audio.snd < 0
    evt_rank = torch.cumsum(mask.int(), dim=-1) - 1  # [B, N]
    free_rank = torch.cumsum(free.int(), dim=-1) - 1  # [B, C]
    match = (
        mask[..., :, None] & free[..., None, :] & (evt_rank[..., :, None] == free_rank[..., None, :])
    )  # [B, N, C] one-hot (<=1 per row and per column)
    ch = torch.arange(c, dtype=torch.int32, device=dev)
    placed = match.any(dim=-1)
    handle = torch.where(placed, (match.int() * ch).sum(dim=-1).int(), -1)
    taken = match.any(dim=-2)  # [B, C]
    mt = match.float()

    def pick_i(vals):
        return (match.int() * vals[..., :, None].int()).sum(dim=-2).int()

    def pick_f(vals):
        return (mt * vals[..., :, None].float()).sum(dim=-2)

    audio = audio.replace(
        snd=torch.where(taken, pick_i(sound), audio.snd),
        elapsed=torch.where(taken, 0, audio.elapsed),
        loops=torch.where(taken, pick_i(loops), audio.loops),
        volume=torch.where(taken, pick_f(volume), audio.volume),
        category=torch.where(taken, pick_i(category), audio.category),
        positional=torch.where(taken, pick_i(positional) > 0, audio.positional),
        # one-hot contraction: exact in f32 (TF32 is off, see __init__.py)
        pos=torch.where(taken[..., None], torch.einsum("bnc,bnk->bck", mt, pos.float()), audio.pos),
        paused=torch.where(taken, False, audio.paused),
    )
    return audio, handle


def stop_channels(audio: AudioState, ch_mask):
    """Free the channels in ch_mask [B, C] (StopSound / MIX_StopTrack)."""
    return audio.replace(snd=torch.where(ch_mask, -1, audio.snd))


def set_paused(audio: AudioState, ch_mask, value: bool):
    live = ch_mask & (audio.snd >= 0)
    return audio.replace(paused=torch.where(live, value, audio.paused))


def tick_advance(audio: AudioState, sound_len, samples: int = SAMPLES_PER_TICK):
    """Advance playing channels by `samples` (one tick's by default); loop
    or free the finished ones. sound_len is the [NS] per-sound frame table.
    Returns (audio, finished [B, C] bool)."""
    playing = (audio.snd >= 0) & ~audio.paused
    sidx = torch.clamp(audio.snd, 0, sound_len.shape[0] - 1).long()
    length = torch.clamp_min(sound_len[sidx], 1)
    elapsed = torch.where(playing, audio.elapsed + samples, audio.elapsed)
    wraps = torch.where(playing, torch.div(elapsed, length, rounding_mode="floor"), 0)
    elapsed = elapsed - wraps * length
    inf = audio.loops < 0
    new_loops = torch.where(inf, audio.loops, torch.clamp_min(audio.loops - wraps, -1))
    finished = playing & ~inf & (audio.loops - wraps < 0)
    audio = audio.replace(
        snd=torch.where(finished, -1, audio.snd),
        elapsed=torch.where(finished, 0, elapsed).int(),
        loops=torch.where(finished, 0, new_loops).int(),
    )
    return audio, finished


