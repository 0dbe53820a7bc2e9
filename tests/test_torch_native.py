"""The port's native host library (c_game_engine_tpu_torch/native.py over
its own csrc/cge_native.cpp, built with g++ and zlib into build/torch_native/),
held to the JAX package's: the double-precision character oracle against
the port's physics/character.py::update_character (0.06 over 90 ticks, as
tests/test_native.py holds the JAX controller), CGAS action streams equal
byte for byte across both codecs of both packages, and read_asset_native
against the port's container reader on files the port's writer made.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests import torch_parity  # noqa: F401  (one torch thread a process)


@pytest.fixture(scope="module")
def native():
    from c_game_engine_tpu_torch import native as nat

    if not nat.have_toolchain():
        pytest.skip("no g++ with zlib's header on this machine")
    nat.lib()
    return nat


def test_library_builds_from_the_ports_source(native):
    from pathlib import Path

    root = Path(native.__file__).resolve().parents[1]
    path = native.library_path()
    assert path.is_file() and path.parent == root / "build" / "torch_native"
    assert native.SOURCE == root / "c_game_engine_tpu_torch" / "csrc" / "cge_native.cpp"
    assert path.name.startswith("libcge_native-")  # keyed on the flags and the source, never native/


def test_character_oracle_agrees_with_the_port(native, tmp_path):
    """Walk the capsule around tests/worldgen.py's box room for 90 ticks:
    the C++ double-precision oracle and the port's float32 controller stay
    within 0.06 of each other and both settle on the floor."""
    from c_game_engine_tpu_torch.core.state import reset
    from c_game_engine_tpu_torch.physics.character import update_character
    from tests.torch_parity import export_and_load
    from tests.worldgen import make_map

    tc = export_and_load(make_map([]), tmp_path)
    actors = reset(tc).actors
    tris = tc.tris.numpy()[tc.tri_valid.numpy()]
    vel = np.array([2.0, -1.0, -3.0])
    pos_t, g_t = torch.tensor([0.0, -0.4, 0.0]), False
    pos_c, g_c = np.array([0.0, -0.4, 0.0]), False
    for i in range(90):
        pos_t, _, g_t, _ = update_character(tc, actors, pos_t, torch.as_tensor(vel, dtype=torch.float32), 1.0 / 60,
                                            g_t, False, False)
        g_t = bool(g_t)
        pos_c, _, g_c = native.character_step_oracle(tris, pos_c, vel, 1 / 60, g_c)
        assert np.allclose(pos_t.numpy(), pos_c, atol=0.06), (i, pos_t, pos_c)
    assert g_t and g_c
    assert abs(float(pos_t[1]) - (-0.55)) < 0.02


def test_action_streams_equal_across_codecs_and_packages(native, tmp_path):
    import jax.numpy as jnp

    from c_game_engine_tpu.core.actions import Actions as JActions
    from c_game_engine_tpu.core import actions_io as j_io
    from c_game_engine_tpu_torch.core import actions_io
    from c_game_engine_tpu_torch.core.actions import NUM_BUTTONS, Actions

    rng = np.random.default_rng(7)
    t, b = 5, 3
    move, look = (rng.standard_normal((t, b, 2)).astype(np.float32) for _ in range(2))
    btn = rng.random((t, b, NUM_BUTTONS)) > 0.5
    mine = Actions(torch.as_tensor(move), torch.as_tensor(look), torch.as_tensor(btn))
    theirs = JActions(move=jnp.asarray(move), look=jnp.asarray(look), buttons=jnp.asarray(btn))
    paths = {}
    for codec in (True, False):
        paths[f"port_{codec}"] = tmp_path / f"port_{codec}.cgas"
        actions_io.save_actions(paths[f"port_{codec}"], mine, native=codec)
        paths[f"jax_{codec}"] = tmp_path / f"jax_{codec}.cgas"
        j_io.save_actions(paths[f"jax_{codec}"], theirs, native=codec)
    data = {k: p.read_bytes() for k, p in paths.items()}
    assert len(set(data.values())) == 1, {k: len(v) for k, v in data.items()}
    actions_io.save_actions(tmp_path / "default.cgas", mine)  # native=None: the C codec here
    assert (tmp_path / "default.cgas").read_bytes() == data["port_True"]

    for path in paths.values():
        for codec in (True, False, None):
            out = actions_io.load_actions(path, native=codec, device="cpu")
            for got, want in ((out.move, move), (out.look, look), (out.buttons, btn)):
                np.testing.assert_array_equal(got.numpy(), want)
            assert out.buttons.dtype == torch.bool
    move2, look2, btn2 = native.actions_read_native(str(paths["jax_False"]))
    np.testing.assert_array_equal(move2, move)
    np.testing.assert_array_equal(btn2 > 0, btn)


def test_native_false_and_true(native, tmp_path, monkeypatch):
    """native=False never touches the library; native=True raises where it
    cannot be built; native=None falls back to the Python codec then."""
    from c_game_engine_tpu_torch.core import actions_io
    from c_game_engine_tpu_torch.core.actions import NUM_BUTTONS, Actions

    acts = Actions(torch.zeros(2, 2, 2), torch.ones(2, 2, 2), torch.zeros(2, 2, NUM_BUTTONS, dtype=torch.bool))

    def no_library():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(native, "lib", no_library)
    actions_io.save_actions(tmp_path / "py.cgas", acts, native=False)
    actions_io.save_actions(tmp_path / "fallback.cgas", acts)
    assert (tmp_path / "py.cgas").read_bytes() == (tmp_path / "fallback.cgas").read_bytes()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        actions_io.save_actions(tmp_path / "c.cgas", acts, native=True)
    with pytest.raises(RuntimeError):
        actions_io.load_actions(tmp_path / "py.cgas", native=True, device="cpu")
    assert torch.equal(actions_io.load_actions(tmp_path / "py.cgas", device="cpu").look, acts.look)


def test_read_asset_native_matches_the_container_reader(native, tmp_path):
    from c_game_engine_tpu_torch.assets.container import Asset, AssetType, read_asset, write_asset

    rng = np.random.default_rng(3)
    for i, (atype, version, size) in enumerate([(AssetType.MAP, 4, 70_000), (AssetType.TEXTURE, 1, 1),
                                               (AssetType.KV_LIST, 2, 0), (AssetType.WAV, 3, 4097)]):
        path = tmp_path / f"a{i}.gbin"
        write_asset(path, Asset(atype, version, rng.integers(0, 255, size, dtype=np.uint8).tobytes()))
        t, tv, data = native.read_asset_native(str(path))
        ref = read_asset(path)
        assert (t, tv, data) == (int(ref.type), ref.type_version, ref.data)
    path.write_bytes(path.read_bytes()[:-2])  # truncated: both refuse it
    with pytest.raises(IOError):
        native.read_asset_native(str(path))
