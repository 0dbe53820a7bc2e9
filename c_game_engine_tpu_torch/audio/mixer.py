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

from c_game_engine_tpu_torch.audio.bank import SAMPLES_PER_TICK, SoundBank
from c_game_engine_tpu_torch.core.state import Struct
from c_game_engine_tpu_torch.utils.mathx import const, quat_conj, quat_from_yaw_pitch, quat_rotate

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


def mix_frame(bank: SoundBank, audio: AudioState, listener_pos, listener_quat, volumes,
              n_samples: int = SAMPLES_PER_TICK):
    """Render every env's stereo mix of the next `n_samples` samples.

    audio leaves [B, C]; listener_pos [B, 3], listener_quat [B, 4]; volumes
    [4] or [B, 4] f32 (master, music, sfx, ui: the Options volume fields).
    Returns [B, n_samples, 2] f32, unclipped. Per env the arithmetic is the
    JAX mix_frame's: the sample index in int32 (an infinite loop allows
    int32's largest count), a floor modulo into the sound, gain = volume x
    category volume x master."""
    live = audio.snd >= 0
    audible = live & ~audio.paused
    sidx = torch.clamp(audio.snd, 0, bank.num_sounds - 1).long()
    off = bank.table[sidx, 0]  # [B, C] i32
    length = torch.clamp_min(bank.table[sidx, 1], 1)

    t = torch.arange(n_samples, dtype=torch.int32, device=off.device)
    cur = audio.elapsed[..., None] + t  # [B, C, n] i32
    total_allowed = torch.where(audio.loops < 0, torch.iinfo(torch.int32).max,
                                length * (1 + torch.clamp_min(audio.loops, 0)))[..., None]
    valid = audible[..., None] & (cur < total_allowed)
    idx = off[..., None] + torch.remainder(cur, length[..., None])
    pcm = bank.pcm[torch.clamp(idx, 0, bank.pcm.shape[0] - 1).long()]  # [B, C, n, 2]

    # gain = original volume x category volume x master (GetCategoryVolume)
    vols = volumes.expand(audio.snd.shape[0], 4) if volumes.dim() == 1 else volumes
    cat_vol = torch.gather(vols, 1, 1 + torch.clamp(audio.category, 0, 2).long())
    gain = audio.volume * cat_vol * vols[:, :1]  # [B, C]

    # positional: listener-space direction (UpdateSoundSystem listener math)
    rel = quat_rotate(quat_conj(listener_quat)[:, None, :], audio.pos - listener_pos[:, None, :])
    d = torch.linalg.vector_norm(rel, dim=-1)
    att = 1.0 / (1.0 + d)
    # constant-power pan from azimuth; forward is -Z in listener space
    az = torch.atan2(rel[..., 0], torch.clamp_min(rel[..., 2].abs(), 1e-6) * torch.sign(-rel[..., 2]))
    pan = torch.clamp(torch.sin(az), -1.0, 1.0)
    theta = (pan + 1.0) * (math.pi / 4.0)
    sqrt2 = math.sqrt(2.0)
    l_gain = torch.where(audio.positional, att * torch.cos(theta) * sqrt2, 1.0)
    r_gain = torch.where(audio.positional, att * torch.sin(theta) * sqrt2, 1.0)
    lr = torch.stack([l_gain, r_gain], -1) * gain[..., None]  # [B, C, 2]

    contrib = pcm * valid[..., None].float() * lr[:, :, None, :]
    return contrib.sum(dim=1)  # [B, n, 2]


def listener_from_state(state):
    """Listener transform of every env of a batched state: the active
    camera (UpdateSoundSystem uses GetState()->camera), the player's eye or
    free camera, or the camera actor where camera_actor >= 0. Returns
    (pos [B, 3], quat [B, 4])."""
    p = state.player
    up = const((0.0, 0.25, 0.0), p.pos.device)
    pos = torch.where(p.freecam[:, None], p.freecam_pos, p.pos + up)
    quat = quat_from_yaw_pitch(p.yaw, p.pitch)
    use_actor = (state.camera_actor >= 0)[:, None]
    n = state.actors.pos.shape[1]
    ci = torch.clamp(state.camera_actor, 0, n - 1).long()[:, None, None]
    pos = torch.where(use_actor, state.actors.pos.gather(1, ci.expand(-1, 1, 3))[:, 0], pos)
    quat = torch.where(use_actor, state.actors.quat.gather(1, ci.expand(-1, 1, 4))[:, 0], quat)
    return pos, quat
