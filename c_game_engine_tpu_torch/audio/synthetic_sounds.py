"""Synthetic sounds for maps without the shipped ones.

The shipped `.gsnd` files are not in the repository, so every committed
map's four `sound_names` (the BUILTIN_SOUNDS) resolve to a 1-frame
silence and its `sound_len` is 1: a channel the tick opens ends on the
same tick. `write_synthetic_sounds` writes, from numpy only and seeded,
the four builtins as `.gsnd` files (a WAV payload in the asset container)
under a directory, at different rates and sample formats, so the bank's
`_resample` and every branch of `decode_gsnd` run:

    click      22,050 Hz PCM16 mono      a decaying noise burst
    popup      44,100 Hz PCM16 stereo    a rising sweep
    popdown    48,000 Hz PCM8 mono       a falling sweep (no resampling)
    coincling  32,000 Hz PCM16 3-channel a two-tone bell (the third
                                         channel is dropped on decode)

`with_synthetic_sounds(cmap, dir)` writes them, builds the bank from that
directory and returns the map with `sound_len` set to the bank's frame
counts, so the tick keeps channels alive (arena's sound_player plays the
click on `first_tick`, coins play the cling). A JAX map gets the same with
`cmap.replace(sound_len=...)` and the JAX bank built from the same files.
`audio_states(state, seed)` fills every env's 32 channels with a seeded
mix of the channel states the mixer distinguishes.
"""

from __future__ import annotations

import io
import wave
from pathlib import Path

import numpy as np
import torch

from c_game_engine_tpu_torch.assets.container import Asset, AssetType, write_asset
from c_game_engine_tpu_torch.audio.bank import BUILTIN_SOUNDS, MIX_RATE, build_sound_bank
from c_game_engine_tpu_torch.compiler.models import AssetResolver

# (rate, sample width in bytes, channels, seconds) of each builtin, in order
SPECS = ((22050, 2, 1, 0.1), (44100, 2, 2, 0.25), (48000, 1, 1, 0.2), (32000, 2, 3, 0.5))


def _signal(i, rate, channels, seconds, rng) -> np.ndarray:
    """[frames, channels] float64 in [-0.9, 0.9] of builtin i."""
    n = int(rate * seconds)
    t = np.arange(n) / rate
    env = np.exp(-t / (seconds * 0.3))
    if i == 0:
        sig = rng.uniform(-1.0, 1.0, (n, 1)) * env[:, None]
    elif i in (1, 2):
        f0, f1 = (400.0, 900.0) if i == 1 else (900.0, 300.0)
        phase = 2 * np.pi * (f0 * t + (f1 - f0) * t * t / (2 * seconds))
        sig = np.stack([np.sin(phase + k * 0.3) for k in range(channels)], -1) * env[:, None]
    else:
        bell = (np.sin(2 * np.pi * 1318.5 * t) + 0.6 * np.sin(2 * np.pi * 1975.5 * t)) / 1.6 * env
        sig = np.stack([bell, 0.8 * bell, rng.uniform(-1.0, 1.0, n)], -1)
    return 0.9 * np.broadcast_to(sig, (n, channels))


def _wav_bytes(sig: np.ndarray, rate: int, width: int) -> bytes:
    if width == 2:
        frames = np.round(sig * 32767.0).astype("<i2").tobytes()
    else:
        frames = np.round(sig * 127.0 + 128.0).astype(np.uint8).tobytes()
    buf = io.BytesIO()
    w = wave.open(buf, "wb")
    try:
        w.setnchannels(sig.shape[1])
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(frames)
    finally:
        w.close()
    return buf.getvalue()


def write_synthetic_sounds(directory, seed: int = 0) -> Path:
    """Write the four BUILTIN_SOUNDS under `directory` (at their asset
    paths, `sound/sfx/<name>.gsnd`); returns the directory."""
    root = Path(directory)
    rng = np.random.default_rng(seed)
    for i, (name, (rate, width, channels, seconds)) in enumerate(zip(BUILTIN_SOUNDS, SPECS)):
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        write_asset(path, Asset(AssetType.WAV, 1, _wav_bytes(_signal(i, rate, channels, seconds, rng), rate, width)))
    return root


def synthetic_lengths() -> np.ndarray:
    """[4] i32 frame counts of the builtins at MIX_RATE (the bank's table)."""
    return np.array([max(int(round(int(r * s) * MIX_RATE / r)), 1) for r, _, _, s in SPECS], np.int32)


def with_synthetic_sounds(cmap, directory, seed: int = 0):
    """Write the synthetic sounds under `directory` and return (the map with
    sound_len set to the bank's frame counts, the bank on the map's
    device). The map's sound_names must be the four builtins."""
    names = tuple((cmap.aux or {}).get("sound_names", ()))
    if names != BUILTIN_SOUNDS:
        raise ValueError(f"synthetic sounds stand in for {BUILTIN_SOUNDS}, the map plays {names}")
    write_synthetic_sounds(directory, seed)
    bank = build_sound_bank(AssetResolver([directory]), names, cmap.device)
    return cmap.replace(sound_len=bank.table[:, 1].clone()), bank


def audio_arrays(listener_pos: np.ndarray, seed: int) -> dict:
    """{AudioState field: ndarray [B, 32, ...]} for listeners at
    listener_pos [B, 3]: in every env, channels free (snd -1) and live,
    paused, playing once, looped 1 and 3 times and forever (-1), positional
    and not, elapsed anywhere in three lengths of the sound (so past a
    loop's end and past the last allowed sample), all three categories;
    channel 3 loops 2**28 times (its allowed sample count wraps in int32),
    channel 4 sits exactly on the listener (rel = 0, so z is 0), channel 6
    level with it on the world x axis."""
    b, c = listener_pos.shape[0], 32
    rng = np.random.default_rng(seed)
    ch = np.arange(c)
    lengths = synthetic_lengths()
    snd = rng.integers(0, 4, (b, c)).astype(np.int32)
    snd[:, ch % 8 == 7] = -1
    loops = rng.choice(np.array([0, 1, 3, -1], np.int32), (b, c))
    loops[:, 3] = 1 << 28
    elapsed = (rng.uniform(0.0, 3.0, (b, c)) * lengths[np.maximum(snd, 0)]).astype(np.int32)
    pos = (listener_pos[:, None, :] + rng.uniform(-15.0, 15.0, (b, c, 3))).astype(np.float32)
    pos[:, 4] = listener_pos
    pos[:, 6] = listener_pos + np.array([3.0, 0.0, 0.0], np.float32)
    return {
        "snd": snd,
        "elapsed": elapsed,
        "loops": loops,
        "volume": rng.uniform(0.2, 1.0, (b, c)).astype(np.float32),
        "category": np.broadcast_to((ch % 3).astype(np.int32), (b, c)).copy(),
        "positional": np.broadcast_to(ch % 2 == 0, (b, c)).copy(),
        "pos": pos,
        "paused": np.broadcast_to(ch % 8 == 5, (b, c)).copy(),
    }


def audio_states(state, seed: int = 0):
    """The batched port state with every env's channel table replaced by
    `audio_arrays` around its listener (audio/mixer.py::listener_from_state)."""
    from c_game_engine_tpu_torch.audio.mixer import listener_from_state

    dev = state.tick.device
    lp = listener_from_state(state)[0].cpu().numpy()
    arrays = {k: torch.from_numpy(v).to(dev) for k, v in audio_arrays(lp, seed).items()}
    return state.replace(audio=state.audio.replace(**arrays))
