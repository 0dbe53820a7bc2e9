"""The port's platform modules against the JAX package on the CPU: the
options file, game config and CLI config (utils/config.py), the metrics
instruments (utils/metrics.py), the log (utils/log.py) and the CGAS
action streams (core/actions_io.py). Files are byte-equal to the JAX
package's (its pure-Python codecs) and each side reads the other's."""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import pytest
import torch

from c_game_engine_tpu.assets import container as j_container
from c_game_engine_tpu.assets import kvlist as j_kv
from c_game_engine_tpu.assets.reader import Writer as JWriter
from c_game_engine_tpu.core import actions_io as j_io
from c_game_engine_tpu.utils import config as j_config
from c_game_engine_tpu_torch.core import actions_io
from c_game_engine_tpu_torch.core.actions import NUM_BUTTONS, Actions
from c_game_engine_tpu_torch.utils import config
from tests.torch_parity import jax_actions, torch_actions


def _options_kwargs(seed):
    """Seeded field values for Options, some out of bounds."""
    rng = np.random.default_rng(seed)
    out = {}
    for f in dataclasses.fields(config.Options):
        if f.type in ("bool", bool):
            out[f.name] = bool(rng.integers(0, 2))
        elif f.type in ("int", int):
            out[f.name] = int(rng.integers(-4, 20))
        else:
            out[f.name] = float(np.float32(rng.uniform(0.0, 200.0)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_options_file_matches_jax(tmp_path, seed):
    kw = _options_kwargs(seed)
    mine, theirs = config.Options(**kw), j_config.Options(**kw)
    assert dataclasses.asdict(mine.validate()) == dataclasses.asdict(theirs.validate())
    assert 30.0 <= mine.fov <= 120.0 and 0 <= mine.msaa <= 8 and 0.25 <= mine.lod_multiplier <= 4.0
    mine.save(tmp_path / "p.kvl")
    theirs.save(str(tmp_path / "j.kvl"))
    assert (tmp_path / "p.kvl").read_bytes() == (tmp_path / "j.kvl").read_bytes()
    assert dataclasses.asdict(config.Options.load(tmp_path / "j.kvl")) == dataclasses.asdict(
        j_config.Options.load(str(tmp_path / "p.kvl")))
    assert config.Options.load(tmp_path / "p.kvl") == mine


def test_options_defaults_and_wrong_types(tmp_path):
    assert config.Options.load(tmp_path / "nope.kvl") == config.Options()
    assert dataclasses.asdict(config.Options()) == dataclasses.asdict(j_config.Options())
    # a key of another type, and a missing key, take the default (KvGet*)
    m = j_config.Options(fov=70.0, msaa=4).to_kvlist()
    m["fov"] = j_kv.Param(j_kv.ParamType.INTEGER, 70)
    del m["msaa"]
    w = JWriter()
    j_kv.write_kvlist(w, m)
    j_container.write_asset(tmp_path / "odd.kvl", j_container.Asset(j_container.AssetType.KV_LIST, 1, w.getvalue()))
    got = config.Options.load(tmp_path / "odd.kvl")
    assert got.fov == 90.0 and got.msaa == 0
    assert dataclasses.asdict(got) == dataclasses.asdict(j_config.Options.load(str(tmp_path / "odd.kvl")))


def test_game_config_reads_a_jax_written_gkvl(tmp_path):
    P, T = j_kv.Param, j_kv.ParamType
    sub = lambda path, code, kind: P(T.KV_LIST, {"search_path": P(T.STRING, path),
                                                 "allow_code_execution": P(T.BOOL, code),
                                                 "path_type": P(T.STRING, kind)})
    m = {"game_title": P(T.STRING, "Arena"), "game_copyright": P(T.STRING, "(c) test"),
         "discord_app_id": P(T.UINT_64, 2**60 + 5), "background_map": P(T.STRING, "map/arena.gmap"),
         "search_paths": P(T.ARRAY, [sub("game", True, "relative"), sub("assets/engine", False, "absolute")])}
    w = JWriter()
    j_kv.write_kvlist(w, m)
    j_container.write_asset(tmp_path / "game.gkvl", j_container.Asset(j_container.AssetType.KV_LIST, 1, w.getvalue()))
    mine = config.GameConfig.load(tmp_path / "game.gkvl")
    assert dataclasses.asdict(mine) == dataclasses.asdict(j_config.GameConfig.load(str(tmp_path / "game.gkvl")))
    assert mine.discord_app_id == 2**60 + 5 and mine.search_paths[1] == ("assets/engine", False, "absolute")


@pytest.mark.parametrize("argv", [[], ["--batch", "64", "--ticks", "7", "--render"],
                                  ["--map", "arena_bodies", "--devices", "2", "--seed", "9", "--width", "128"]])
def test_run_config_from_cli(argv):
    mine, theirs = dataclasses.asdict(config.RunConfig.from_cli(argv)), dataclasses.asdict(
        j_config.RunConfig.from_cli(argv))
    if "--map" not in argv:
        # the port's default is the committed map; the JAX one the reference's test.gmap
        assert mine.pop("map") == "arena" and theirs.pop("map").endswith("test.gmap")
    assert mine == theirs


def test_metrics_instruments(tmp_path):
    """tests/test_utils.py::test_metrics_instruments on the port, and the
    torch.profiler trace."""
    from c_game_engine_tpu_torch.utils.metrics import RateGraph, TickBenchmark, profile_trace

    tb = TickBenchmark()
    assert tb.report() == "no samples"
    for _ in range(3):
        with tb.tick():
            pass
    assert tb.count == 3 and tb.best <= tb.worst
    assert "ticks=3" in tb.report(batch=128)

    rg = RateGraph(max_samples=4, interval=0.0)
    for _ in range(10):
        rg.add_event(5)
    assert len(rg.samples) <= 4
    assert rg.sparkline()
    assert RateGraph().sparkline() == ""

    with profile_trace(tmp_path / "trace") as prof:
        torch.ones(64).cumsum(0)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("cumsum" in e.key for e in prof.key_averages())


def test_log_lines(tmp_path, capsys, monkeypatch):
    from c_game_engine_tpu_torch.utils import log

    log.set_log_file(str(tmp_path / "run.log"))
    try:
        log.log_info("tick %d of %s", 3, "arena")
        log.log_warning("plain")
        monkeypatch.setattr(log, "DEBUG_ENABLED", True)
        log.log_debug("dbg")
        log.log_error("bad %s", "x")
    finally:
        log.set_log_file(None)
    lines = (tmp_path / "run.log").read_text().splitlines()
    assert [ln.split("] ", 1)[1] for ln in lines] == ["[INFO] tick 3 of arena", "[WARNING] plain", "[DEBUG] dbg",
                                                      "[ERROR] bad x"]
    assert "\x1b[33m" in capsys.readouterr().err


def _stream(ticks, batch, seed, nb=NUM_BUTTONS):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(ticks, batch, 2)).astype(np.float32), rng.normal(size=(ticks, batch, 2)).astype(np.float32),
            rng.random((ticks, batch, nb)) < 0.3)


def test_action_stream_matches_jax(tmp_path):
    move, look, btn = _stream(7, 33, seed=4)
    actions_io.save_actions(tmp_path / "p.cgas", torch_actions(move, look, btn))
    j_io.save_actions(tmp_path / "j.cgas", jax_actions(move, look, btn), native=False)
    assert (tmp_path / "p.cgas").read_bytes() == (tmp_path / "j.cgas").read_bytes()
    mine = actions_io.load_actions(tmp_path / "j.cgas", device="cpu")
    theirs = j_io.load_actions(tmp_path / "p.cgas", native=False)
    for got, want in ((mine.move, move), (mine.look, look), (mine.buttons, btn)):
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in ((theirs.move, move), (theirs.look, look), (theirs.buttons, btn)):
        np.testing.assert_array_equal(np.asarray(got), want)
    assert mine.buttons.dtype == torch.bool and mine.move.dtype == torch.float32


@pytest.mark.parametrize("nb", [6, 13])
def test_action_stream_with_another_button_count(tmp_path, nb):
    """A stream written with fewer or more buttons keeps the shared ones
    (core/actions_io.py:96-99 of the JAX package)."""
    import gzip

    move, look, btn = _stream(3, 5, seed=nb, nb=nb)
    mask = np.zeros(15, np.uint16)
    for i in range(nb):
        mask |= btn.reshape(15, nb)[:, i].astype(np.uint16) << i
    raw = move.tobytes() + look.tobytes() + mask.tobytes()
    comp = gzip.compress(raw, 6, mtime=0)
    path = tmp_path / "odd.cgas"
    path.write_bytes(struct.pack("<IBBHIIQQ", actions_io.MAGIC, 1, nb, 0, 5, 3, len(raw), len(comp)) + comp)
    mine = actions_io.load_actions(path, device="cpu")
    theirs = j_io.load_actions(path, native=False)
    np.testing.assert_array_equal(mine.buttons.numpy(), np.asarray(theirs.buttons))
    k = min(nb, NUM_BUTTONS)
    np.testing.assert_array_equal(mine.buttons[..., :k].numpy(), btn[..., :k])
    assert not mine.buttons[..., k:].any() and mine.buttons.shape == (3, 5, NUM_BUTTONS)


@pytest.mark.parametrize("damage", ["truncated", "magic", "size"])
def test_damaged_action_stream_raises(tmp_path, damage):
    move, look, btn = _stream(2, 4, seed=5)
    path = tmp_path / "s.cgas"
    actions_io.save_actions(path, torch_actions(move, look, btn))
    raw = bytearray(path.read_bytes())
    if damage == "truncated":
        raw = raw[:-3]
    elif damage == "magic":
        raw[0] ^= 1
    else:
        struct.pack_into("<Q", raw, 16, 2 * 4 * 18 + 1)
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError):
        actions_io.load_actions(path, device="cpu")
    with pytest.raises(ValueError):
        j_io.load_actions(path, native=False)
    path.write_bytes(bytes(raw[:20]))
    with pytest.raises(ValueError, match="truncated"):
        actions_io.load_actions(path, device="cpu")


def test_action_recorder(tmp_path):
    move, look, btn = _stream(4, 6, seed=6)
    rec = actions_io.ActionRecorder()
    with pytest.raises(ValueError):
        rec.stream()
    for t in range(4):
        rec.record(torch_actions(move[t], look[t], btn[t]))
    assert len(rec) == 4
    s = rec.stream()
    assert isinstance(s, Actions) and s.move.shape == (4, 6, 2) and s.buttons.shape == (4, 6, NUM_BUTTONS)
    rec.save(tmp_path / "rec.cgas")
    j_rec = j_io.ActionRecorder()
    for t in range(4):
        j_rec.record(jax_actions(move[t], look[t], btn[t]))
    j_rec.save(tmp_path / "jrec.cgas", native=False)
    assert (tmp_path / "rec.cgas").read_bytes() == (tmp_path / "jrec.cgas").read_bytes()
    back = actions_io.load_actions(tmp_path / "rec.cgas", device="cpu")
    for a, b in ((back.move, s.move), (back.look, s.look), (back.buttons, s.buttons)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="T, B"):
        actions_io.save_actions(tmp_path / "x.cgas", torch_actions(move[0], look[0], btn[0]))
