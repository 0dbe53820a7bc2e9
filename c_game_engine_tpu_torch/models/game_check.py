"""The scripted app session that chip_smoke.py's app phase and
tests/test_torch_game.py drive through a GameApp (models/game.py):

    splash -> menu -> level select -> the level (arena_lit by default)
    -> `ticks` in-game ticks of the bench stream -> pause -> options
    -> video options (one FOV slider step) -> back (shift-tab wraps the
    focus to the Back button) -> pause -> resume
    -> `ticks` more ticks

through `ui_tick` with scripted keys (space, tab, enter, down, escape,
right, shift-tab), a frame of every screen it reaches. `run_script` works
on any object with the GameApp interface, so the same script drives the
port's app on the card and on the CPU, and the JAX package's app.
"""

from __future__ import annotations


def app_script(levels, level="arena_lit", ticks=60) -> list:
    """Steps [(op, arg)]: ("ui", {key: True}) one ui_tick, ("ticks", n) n
    in-game ticks, ("frame", label) one frame of the current screen.
    `levels` is the app's level list (the level is reached with `down`)."""
    key = lambda **kw: ("ui", kw)
    steps = [("frame", "splash"), key(space=True), ("frame", "menu"), key(tab=True), key(enter=True),
             ("frame", "level_select")]
    steps += [key(down=True)] * levels.index(level)
    steps += [key(space=True), ("ticks", ticks), ("frame", "in_game"),
              key(escape=True), ("frame", "paused"),
              key(tab=True), key(tab=True), key(enter=True), ("frame", "options"),
              key(tab=True), key(enter=True), ("frame", "video_options"),
              key(tab=True), key(right=True), ("frame", "video_options_fov"),
              key(tab=True, shift=True), key(enter=True), ("frame", "options_back"),
              key(escape=True), ("frame", "paused_again"),
              key(tab=True), key(enter=True), ("ticks", ticks), ("frame", "in_game_again")]
    return steps


def run_script(app, steps, make_input, actions_for, size, on_step=None, labels=None) -> dict:
    """Drive `app` through `steps`. make_input(kw) builds the package's
    UiInput at the mouse (-1, -1); actions_for(t) the [batch] actions of
    in-game tick t (counted over the session). on_step(app) runs after
    every step; with `labels`, only the frames of those labels are drawn.
    Returns {"screens": screen after each step, "events": fired event lists
    of the ui steps, "frames": {label: frame}, "ticks": in-game ticks
    run}."""
    out = {"screens": [], "events": [], "frames": {}, "ticks": 0}
    for op, arg in steps:
        if op == "ui":
            out["events"].append(app.ui_tick(make_input(arg)))
        elif op == "ticks":
            for _ in range(arg):
                app.tick(actions_for(out["ticks"]))
                out["ticks"] += 1
        elif labels is None or arg in labels:
            out["frames"][arg] = app.render_frame(size, size)
        out["screens"].append(app.screen.value)
        if on_step is not None:
            on_step(app)
    return out


# one frame of each screen the session reaches (the steps repeat some)
FIRST_FRAMES = ("splash", "menu", "level_select", "in_game", "paused", "options", "video_options_fov",
                "in_game_again")
EXPECTED_EVENTS = [["start"], ["options"], ["video"], ["back"], ["resume"]]
EXPECTED_FINAL_SCREEN = "in_game"


def check_session(out):
    """Raise unless the session went where the script leads: the events
    fired in order and the final screen in game."""
    fired = [e for e in out["events"] if e]
    if fired != EXPECTED_EVENTS or out["screens"][-1] != EXPECTED_FINAL_SCREEN:
        raise AssertionError(f"app session: fired {fired}, screens {out['screens']}")
    for screen in ("menu", "level_select", "in_game", "paused", "options", "video_options"):
        if screen not in out["screens"]:
            raise AssertionError(f"app session never reached {screen}: {out['screens']}")


def main(argv=None) -> int:
    """The session on the port's CPU GameApp, for a comparison with a run on
    the card (chip_smoke.py's app phase):

        python -m c_game_engine_tpu_torch.models.game_check OUT [--ticks N]
            [--size S] [--sounds DIR]

    writes OUT.json (screens, events, ticks) and OUT.npz (every frame of
    the session), on one torch thread (a batch of one: more threads only
    add overhead)."""
    import argparse
    import json

    import numpy as np
    import torch

    from c_game_engine_tpu_torch.core.actions import Actions
    from c_game_engine_tpu_torch.models.game import GameApp
    from c_game_engine_tpu_torch.ui.stack import UiInput

    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--ticks", type=int, default=60)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--sounds", default=None)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    app = GameApp(device="cpu", synthetic_assets=True, sound_dir=args.sounds)

    def actions_for(t):
        a = Actions.zeros((app.batch,), device="cpu")
        a.move[:, 1] = -1.0  # the bench stream (models/sim.py::bench_actions)
        a.look[:, 0] = 0.01
        return a

    rec = run_script(app, app_script(app.list_levels(), "arena_lit", args.ticks),
                     lambda kw: UiInput.at_mouse(-1.0, -1.0, **kw), actions_for, args.size)
    np.savez(args.out + ".npz", **{k: v.numpy() for k, v in rec["frames"].items()})
    with open(args.out + ".json", "w") as f:
        json.dump({k: rec[k] for k in ("screens", "events", "ticks")}, f)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
