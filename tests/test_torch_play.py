"""The terminal viewer (c_game_engine_tpu_torch/play.py) on the CPU: its
loop on scripted keys and its command line without a tty; and the port's
GameApp on a committed map without a render bundle."""

from __future__ import annotations

import io
import json

import pytest

from tests import torch_parity  # noqa: F401  (one torch thread a process)


def test_viewer_loop_on_scripted_keys():
    """play.py's loop for a few ticks of keys (walk, turn with an arrow,
    jump and interact), the display written to a buffer: one ANSI frame a
    tick of view / 2 lines, the player moved and still on the map."""
    from c_game_engine_tpu_torch import play

    buf = io.StringIO()
    keys = [b"w", b"w\x1b[C", b"w \x1be", b"d"]
    s = play.run("arena_lit", 128, 32, device="cpu", out=buf, keys=keys, max_ticks=len(keys), pace=False)
    assert s["frames"] == len(keys) and s["tick"] == len(keys) + 1
    text = buf.getvalue()
    assert text.count("\x1b[H") == len(keys) and text.count("▀") == len(keys) * 32 * 16
    assert -0.7 < s["pos"][1] < 1.0 and s["pos"] != [9.0, 0.45, -2.0]
    a = play.actions_from_keys(b"\x1b[A\x1b[D \t", {}, "cpu")
    assert a.look.tolist() == pytest.approx([-play.LOOK_RATE, play.LOOK_RATE])
    assert a.buttons.nonzero().flatten().tolist() == [0, 6]
    assert json.loads(json.dumps(s)) == s


def test_viewer_main_runs_headless(tmp_path, capsys):
    """`python -m c_game_engine_tpu_torch.play --script --cpu` without a tty
    (stdin is not one under pytest): the summary line is JSON."""
    from c_game_engine_tpu_torch import play

    assert play.main(["--script", "--cpu", "--seconds", "0.01", "--size", "128", "--view", "64",
                      "--out", str(tmp_path / "frames.txt")]) == 0
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert s["frames"] >= 1 and (tmp_path / "frames.txt").stat().st_size > 0


def test_app_level_without_a_bundle_ticks_but_does_not_draw():
    """arena has no committed bundle: it loads and ticks, and drawing it
    builds its bundle with the port's builder
    (render/bundle.py::build_render_bundle; before the builder was ported
    the in-game frame raised NotImplementedError): the actors' wall quads
    and the sky colour, no map mesh. The menu still draws with arena_lit's
    UI atlas, and a map that does not exist falls back to the menu."""
    from c_game_engine_tpu_torch.models.game import GameApp, Screen

    app = GameApp(device="cpu", initial_map="arena", synthetic_assets=True)
    assert app.screen == Screen.IN_GAME and app.list_levels() == ["arena", "arena_bodies", "arena_lit", "arena_orb"]
    app.tick()
    assert int(app.state.tick[0]) == 2
    assert not app.has_bundle("arena")
    frame = app.render_frame(128, 128)
    _, bundle = app._bundle_for("arena")
    assert frame.shape == (128, 128, 3) and bool(frame.isfinite().all())
    assert bundle.map_pos.shape[0] == 0 and bundle.tex_names[:len(app.cmap.aux["texture_names"])] == tuple(
        app.cmap.aux["texture_names"])
    app.quit_to_menu()
    assert app.render_frame(128, 128).abs().sum() > 0
    app.load_level("no_such_map")
    assert app.screen == Screen.MENU and app._current == "arena"
