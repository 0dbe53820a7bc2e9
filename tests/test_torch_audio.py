"""The port's sound bank and PCM mixer against the JAX package on the
CPU: the bank built from the synthetic `.gsnd` files (bit-equal PCM and
table), `mix_frame` on every channel state of `audio_states` against
`jax.vmap(mix_frame)` (abs and rel 1e-5: the channel sum and the norm
reduce in another order than XLA's), `listener_from_state` (1e-6),
`write_wav` (byte-equal), the mixer contracts of tests/test_audio.py on
the port, and a short arena rollout with the synthetic sounds in both
packages (the tick's channel table, then the mix of the result)."""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_game_engine_tpu.audio import bank as j_bank
from c_game_engine_tpu.audio import mixer as j_mixer
from c_game_engine_tpu.compiler.models import AssetResolver as JAssetResolver
from c_game_engine_tpu_torch.audio import bank, mixer
from c_game_engine_tpu_torch.audio.synthetic_sounds import (
    audio_arrays,
    audio_states,
    synthetic_lengths,
    with_synthetic_sounds,
    write_synthetic_sounds,
)
from c_game_engine_tpu_torch.compiler.models import AssetResolver
from c_game_engine_tpu_torch.core.state import tree_map
from c_game_engine_tpu_torch.models.sim import load_named_map, reset_batch
from tests.torch_parity import export_and_load, jax_actions, jax_leaves, stream_batch, torch_actions

B = 8
TOL = 1e-5


@pytest.fixture(scope="module")
def sounds(tmp_path_factory):
    return write_synthetic_sounds(tmp_path_factory.mktemp("sounds"))


@pytest.fixture(scope="module")
def banks(sounds):
    return (bank.build_sound_bank(AssetResolver([sounds]), bank.BUILTIN_SOUNDS, "cpu"),
            j_bank.build_sound_bank(JAssetResolver(search_paths=[sounds]), j_bank.BUILTIN_SOUNDS))


def test_bank_matches_jax(banks):
    mine, theirs = banks
    assert mine.names == theirs.names == bank.BUILTIN_SOUNDS and mine.num_sounds == 4
    assert mine.pcm.dtype == torch.float32 and mine.table.dtype == torch.int32
    np.testing.assert_array_equal(mine.pcm.numpy(), np.asarray(theirs.pcm))
    np.testing.assert_array_equal(mine.table.numpy(), np.asarray(theirs.table))
    np.testing.assert_array_equal(mine.table[:, 1].numpy(), synthetic_lengths())
    assert (bank.MIX_RATE, bank.SAMPLES_PER_TICK) == (j_bank.MIX_RATE, j_bank.SAMPLES_PER_TICK)


def test_missing_sounds_are_one_frame_of_silence(tmp_path):
    names = list(bank.BUILTIN_SOUNDS) + ["sound/none.gsnd"]
    mine = bank.build_sound_bank(AssetResolver([tmp_path]), names, "cpu")
    theirs = j_bank.build_sound_bank(JAssetResolver(search_paths=[tmp_path]), names)
    np.testing.assert_array_equal(mine.table.numpy(), np.asarray(theirs.table))
    assert mine.table.tolist() == [[i, 1] for i in range(5)] and not mine.pcm.any()
    empty = bank.build_sound_bank(AssetResolver([tmp_path]), [], "cpu")
    assert empty.table.tolist() == [[0, 1]] and empty.names == ()
    assert AssetResolver([tmp_path]).resolve("") is None


def _listener_states(seed):
    """8 envs of arena with seeded eyes: yaw, pitch and position per env,
    the free camera on envs 1 and 5 (at another position), a camera actor
    with a seeded orientation on envs 2 and 5."""
    rng = np.random.default_rng(seed)
    cmap = load_named_map("arena", "cpu")
    st = reset_batch(cmap, B)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    n = cmap.num_actors
    quat = rng.normal(size=(B, n, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    player = st.player.replace(
        pos=f(rng.uniform(-8, 8, (B, 3))), yaw=f(rng.uniform(-3, 3, B)), pitch=f(rng.uniform(-1.2, 1.2, B)),
        freecam=torch.tensor([False, True, False, False, False, True, False, False]),
        freecam_pos=f(rng.uniform(-8, 8, (B, 3))))
    actors = st.actors.replace(pos=f(rng.uniform(-10, 10, (B, n, 3))), quat=f(quat))
    cam = torch.tensor([-1, -1, 3, -1, -1, 7, -1, -1], dtype=torch.int32)
    return cmap, st.replace(player=player, actors=actors, camera_actor=cam)


def test_listener_from_state_matches_jax():
    _, st = _listener_states(0)
    pos, quat = mixer.listener_from_state(st)
    assert pos.shape == (B, 3) and quat.shape == (B, 4)
    for e in range(B):
        one = tree_map(lambda x: jnp.asarray(x[e].numpy()), st)
        ns = types.SimpleNamespace(player=one.player, actors=one.actors, camera_actor=one.camera_actor)
        jp, jq = j_mixer.listener_from_state(ns)
        np.testing.assert_allclose(pos[e].numpy(), np.asarray(jp), atol=1e-6, rtol=0)
        np.testing.assert_allclose(quat[e].numpy(), np.asarray(jq), atol=1e-6, rtol=0)
    # the actor camera and the free camera both took effect
    assert torch.equal(pos[2], st.actors.pos[2, 3]) and torch.equal(quat[5], st.actors.quat[5, 7])
    assert not torch.equal(pos[1], st.player.pos[1] + torch.tensor([0.0, 0.25, 0.0]))


def _jax_audio(audio):
    return j_mixer.AudioState(**{k: jnp.asarray(getattr(audio, k).numpy()) for k in (
        "snd", "elapsed", "loops", "volume", "category", "positional", "pos", "paused")})


@pytest.mark.parametrize("per_env_volumes", [False, True])
def test_mix_frame_matches_jax_vmap(banks, per_env_volumes):
    mine_bank, their_bank = banks
    cmap, st = _listener_states(1)
    st = audio_states(st, seed=2)
    pos, quat = mixer.listener_from_state(st)
    rng = np.random.default_rng(3)
    vols = rng.uniform(0.2, 1.0, (B, 4) if per_env_volumes else (4,)).astype(np.float32)
    n = bank.SAMPLES_PER_TICK
    out = mixer.mix_frame(mine_bank, st.audio, pos, quat, torch.from_numpy(vols), n)
    assert out.shape == (B, n, 2) and out.dtype == torch.float32
    f = jax.jit(jax.vmap(j_mixer.mix_frame, in_axes=(None, 0, 0, 0, 0 if per_env_volumes else None, None)),
                static_argnums=5)
    want = np.asarray(f(their_bank, _jax_audio(st.audio), jnp.asarray(pos.numpy()), jnp.asarray(quat.numpy()),
                        jnp.asarray(vols), n))
    np.testing.assert_allclose(out.numpy(), want, atol=TOL, rtol=TOL)
    # every channel state took part: live and free, paused, looped, positional
    a = st.audio
    live = a.snd >= 0
    assert (~live).any() and (live & a.paused).any() and (live & (a.loops < 0)).any() and a.positional.any()
    assert (live & (a.elapsed >= torch.from_numpy(synthetic_lengths())[a.snd.clamp(0).long()])).any()
    assert np.abs(want).max() > 0.1


def test_audio_arrays_cover_the_channel_states():
    a = audio_arrays(np.zeros((B, 3), np.float32), seed=0)
    assert set(np.unique(a["category"])) == {0, 1, 2} and set(np.unique(a["loops"])) >= {0, 1, 3, -1, 1 << 28}
    assert (a["snd"] == -1).any() and a["paused"].any() and (a["pos"][:, 4] == 0).all()


def test_write_wav_matches_jax(tmp_path):
    pcm = np.random.default_rng(4).uniform(-1.3, 1.3, (997, 2)).astype(np.float32)
    bank.write_wav(tmp_path / "p.wav", torch.from_numpy(pcm))
    j_bank.write_wav(tmp_path / "j.wav", pcm)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    bank.write_wav(tmp_path / "n.wav", pcm, rate=22050)
    j_bank.write_wav(tmp_path / "jn.wav", pcm, rate=22050)
    assert (tmp_path / "n.wav").read_bytes() == (tmp_path / "jn.wav").read_bytes()


def _tone_bank(n=100):
    pcm = np.zeros((n, 2), np.float32)
    pcm[:, 0] = np.linspace(1.0, 0.5, n)
    pcm[:, 1] = np.linspace(-1.0, -0.5, n)
    return bank.SoundBank(pcm=torch.from_numpy(pcm), table=torch.tensor([[0, n]], dtype=torch.int32), names=("tone",))


def _one_event(volume=1.0, positional=False, pos=(0.0, 0.0, 0.0)):
    audio = tree_map(lambda x: x[None], mixer.empty_audio("cpu"))
    t = lambda v, dt: torch.tensor([v], dtype=dt)
    return mixer.alloc_channels(audio, torch.tensor([[True]]), t(0, torch.int32), t(volume, torch.float32),
                                t(mixer.CATEGORY_SFX, torch.int32), t(0, torch.int32), t(positional, torch.bool),
                                torch.tensor([[pos]], dtype=torch.float32))[0]


def test_mix_gain_and_window():
    """tests/test_audio.py::test_mix_gain_and_window on the port."""
    tone = _tone_bank(100)
    vols = torch.tensor([0.8, 1.0, 0.25, 1.0])  # master, music, sfx, ui
    out = mixer.mix_frame(tone, _one_event(volume=0.5), torch.zeros(1, 3), torch.tensor([[0, 0, 0, 1.0]]), vols,
                          n_samples=150)[0].numpy()
    gain = 0.5 * 0.25 * 0.8  # volume x sfx x master (GetCategoryVolume)
    np.testing.assert_allclose(out[:100], tone.pcm.numpy() * gain, atol=1e-6)
    assert (out[100:] == 0).all()  # past the end: silence (no loops)


def test_mix_positional_pan_and_distance():
    """tests/test_audio.py::test_mix_positional_pan_and_distance on the port."""
    tone = _tone_bank(100)

    def level(pos):
        out = mixer.mix_frame(tone, _one_event(positional=True, pos=pos), torch.zeros(1, 3),
                              torch.tensor([[0, 0, 0, 1.0]]), torch.ones(4), 50)[0].numpy()
        return np.abs(out).mean(0)  # [2] l, r levels

    l_right, r_right = level((3.0, 0.0, 0.0))  # +X = right of -Z forward
    assert r_right > l_right * 3
    l_left, r_left = level((-3.0, 0.0, 0.0))
    assert l_left > r_left * 3
    assert level((1.0, 0.0, 0.0)).sum() > level((9.0, 0.0, 0.0)).sum() * 2  # 1/(1+d) attenuation


def test_arena_with_synthetic_sounds_matches_jax(sounds, banks, tmp_path):
    """12 ticks of 128 envs on arena with the synthetic sounds in both
    packages: the first_tick click and the coin's cling open channels that
    now outlive their tick; the channel tables match exactly (positions
    within 5e-3), then both mix the port's final state."""
    from c_game_engine_tpu.models.sim import reset_batch as j_reset
    from c_game_engine_tpu.models.sim import step_batch as j_step
    from c_game_engine_tpu_torch.models.sim import rollout
    from tests.torch_export_map import compile_arena

    mine_bank, their_bank = banks
    jc = compile_arena()
    tc, tbank = with_synthetic_sounds(export_and_load(jc, tmp_path), sounds)
    jc = jc.replace(sound_len=jnp.asarray(tc.sound_len.numpy()))
    np.testing.assert_array_equal(tbank.pcm.numpy(), mine_bank.pcm.numpy())
    np.testing.assert_array_equal(tc.sound_len.numpy(), synthetic_lengths())
    acts = [a[:12] for a in stream_batch(30, 128, seed=0)]
    ts = rollout(tc, reset_batch(tc, 128), torch_actions(*acts))
    step = jax.jit(lambda s, a: j_step(jc, s, a))
    js = j_reset(jc, 128)
    for t in range(12):
        js = step(js, jax_actions(*(a[t] for a in acts)))
    J = jax_leaves(js)
    for k, v in tree_map(lambda x: x.numpy(), ts.audio).__dict__.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(v, J[f"audio.{k}"], atol=5e-3, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(v, J[f"audio.{k}"], err_msg=k)
    assert int(ts.sound_plays.min()) >= 2 and bool((ts.audio.snd >= 0).any())
    pos, quat = mixer.listener_from_state(ts)
    out = mixer.mix_frame(tbank, ts.audio, pos, quat, torch.ones(4))
    want = jax.vmap(j_mixer.mix_frame, in_axes=(None, 0, 0, 0, None, None))(
        their_bank, _jax_audio(ts.audio), jnp.asarray(pos.numpy()), jnp.asarray(quat.numpy()), jnp.ones(4),
        bank.SAMPLES_PER_TICK)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    assert out.abs().max() > 0
