"""Interactive first-person viewer (counterpart of examples/play.py):
keyboard -> Actions -> one tick -> render_with_hud -> terminal display.

The host loop the reference runs in Engine.c:289-390 (event pump ->
update -> render -> present): the host shuttles one env's keystrokes in
and one frame out per tick. The env is a batch of one, stepped as GameApp
steps its batch (models/sim.py::step_one: the map's tick graph on a CUDA
device, step_batch on the CPU) and drawn by render_with_hud_batch (a
replay of its render graph on a card, the eager render on the CPU). The
frame is box-downsampled to the viewport on the device and shown as ANSI
truecolor half-blocks (2 pixels per character cell), so it runs over any
terminal or SSH session.

    python -m c_game_engine_tpu_torch.play [map] [--size 256] [--view 112]
        [--seconds N] [--script] [--synthetic] [--cpu] [--out PATH]

  map          a committed map with a render bundle (default arena_lit)
  --size       render resolution
  --view       viewport width in pixels (the frame is box-downsampled to
               view x view; 112 fits a 120-column terminal)
  --seconds    exit after N wall seconds (0 = until q/Ctrl-C)
  --script     ignore the keyboard and replay the built-in action script
               (no tty needed)
  --synthetic  draw render/synthetic_hud.py's HUD and viewmodel (the
               committed bundles have none)
  --out        where the frames go (default: standard output)

Keys: WASD move, arrows look, SPACE jump, E interact, TAB cycle item, F
fire, Q quit. The last line printed is a JSON summary: frames, the median
tick+render+display time and its frames/s (uncapped; the loop sleeps to
the reference's 60 Hz tick when faster).
"""

from __future__ import annotations

import argparse
import json
import os
import select
import sys
import time

import torch

from c_game_engine_tpu_torch.core.actions import Actions, Button

LOOK_RATE = 0.05  # rad per tick while an arrow key is held


class RawKeys:
    """Non-blocking single-byte reads from a cbreak-mode tty. Terminal
    state restores on exit; no input when stdin is not a tty."""

    def __init__(self):
        self.is_tty = sys.stdin.isatty()
        self.fd = sys.stdin.fileno() if self.is_tty else -1
        self.saved = None

    def __enter__(self):
        if self.is_tty:
            import termios
            import tty

            self.saved = termios.tcgetattr(self.fd)
            tty.setcbreak(self.fd)
        return self

    def __exit__(self, *exc):
        if self.saved is not None:
            import termios

            termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)

    def drain(self) -> bytes:
        if not self.is_tty:
            return b""
        out = b""
        while select.select([sys.stdin], [], [], 0)[0]:
            out += os.read(self.fd, 64)
        return out


def _actions(move=(0.0, 0.0), look=(0.0, 0.0), buttons=(), device="cpu") -> Actions:
    """One env's Actions (no batch axis) from host values."""
    pressed = [False] * len(Button)
    for b in buttons:
        pressed[int(b)] = True
    return Actions(move=torch.tensor(move, dtype=torch.float32, device=device),
                   look=torch.tensor(look, dtype=torch.float32, device=device),
                   buttons=torch.tensor(pressed, dtype=torch.bool, device=device))


def actions_from_keys(buf: bytes, held: dict, device="cpu") -> Actions:
    """Map the tick's keystrokes to an Actions row. cbreak mode has no
    key-up events, so 'held' movement decays after a few ticks without a
    repeat (terminal autorepeat refreshes it)."""
    for k in ("w", "a", "s", "d", "shift"):
        if held.get(k, 0) > 0:
            held[k] -= 1
    look = [0.0, 0.0]
    buttons = []
    i = 0
    while i < len(buf):
        ch = buf[i:i + 1]
        if ch == b"\x1b" and buf[i + 1:i + 2] == b"[":  # arrow CSI
            code = buf[i + 2:i + 3]
            if code == b"A":
                look[1] += LOOK_RATE
            elif code == b"B":
                look[1] -= LOOK_RATE
            elif code == b"C":
                look[0] += LOOK_RATE
            elif code == b"D":
                look[0] -= LOOK_RATE
            i += 3
            continue
        c = ch.decode(errors="ignore").lower()
        if c in ("w", "a", "s", "d"):
            held[c] = 6  # ~100 ms of travel per autorepeat event
        elif c == " ":
            buttons.append(Button.JUMP)
        elif c == "e":
            buttons.append(Button.INTERACT)
        elif c == "f":
            buttons.append(Button.FIRE)
        elif c == "\t":
            buttons.append(Button.ITEM_NEXT)
        elif c == "q":
            raise KeyboardInterrupt
        i += 1
    mx = (1.0 if held.get("d", 0) else 0.0) - (1.0 if held.get("a", 0) else 0.0)
    mz = (1.0 if held.get("s", 0) else 0.0) - (1.0 if held.get("w", 0) else 0.0)
    return _actions((mx, mz), tuple(look), buttons, device)


def scripted_action(t: int, device="cpu") -> Actions:
    """Deterministic survey script for --script runs: walk, turn, walk
    with a jump every 45 ticks, 90 ticks each."""
    phase = (t // 90) % 3
    if phase == 0:
        return _actions(move=(0.0, -1.0), device=device)
    if phase == 1:
        return _actions(look=(0.03, 0.0), device=device)
    return _actions(move=(0.0, -1.0), buttons=(Button.JUMP,) if t % 45 == 0 else (), device=device)


def frame_to_ansi(u8) -> str:
    """[H, W, 3] uint8 (numpy) -> truecolor half-block string (H/2 lines)."""
    top, bot = u8[0::2], u8[1::2]
    lines = []
    for tr, br in zip(top, bot):
        lines.append("".join(f"\x1b[38;2;{t[0]};{t[1]};{t[2]};48;2;{b[0]};{b[1]};{b[2]}m▀"
                             for t, b in zip(tr.tolist(), br.tolist())))
    return "\x1b[0m\n".join(lines) + "\x1b[0m"


class Viewer:
    """One env of a committed map, kept as a batch of one (`state`):
    `step(actions)` ticks it on one env's Actions and returns the viewport
    frame [view, view, 3] uint8 on the device."""

    def __init__(self, map_name="arena_lit", size=256, view=112, device="cuda", synthetic=False):
        from c_game_engine_tpu_torch.models.sim import reset_batch
        from c_game_engine_tpu_torch.render.bundle import load_render_map

        if view > size:
            raise ValueError(f"--view {view} is larger than --size {size}")
        self.device = torch.device(device)
        self.cmap, self.bundle = load_render_map(map_name, self.device)
        if synthetic:
            from c_game_engine_tpu_torch.render.synthetic_hud import with_synthetic_hud

            self.bundle = with_synthetic_hud(self.bundle)
        self.state = reset_batch(self.cmap, 1)
        self.size, self.view = size, view

    def step(self, actions: Actions):
        from c_game_engine_tpu_torch.core.state import tree_map
        from c_game_engine_tpu_torch.models.sim import step_one
        from c_game_engine_tpu_torch.render.raster import render_with_hud_batch

        self.state = step_one(self.cmap, self.state, tree_map(lambda x: x[None], actions))
        img = render_with_hud_batch(self.bundle, self.cmap, self.state, self.size, self.size)[0]
        # box-downsample to the terminal viewport on the device
        f, v = self.size // self.view, self.view
        small = img[:f * v, :f * v].reshape(v, f, v, f, 3).mean((1, 3))
        return (small.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def run(map_name="arena_lit", size=256, view=112, seconds=0.0, script=False, device="cuda", synthetic=False,
        out=None, keys=None, max_ticks=None, pace=True) -> dict:
    """The viewer loop. `keys` (an iterable of bytes per tick) replaces the
    keyboard; `max_ticks` stops the loop after that many ticks. Returns a
    summary: map, frames, median ms, frames/s uncapped, tick, position."""
    out = out or sys.stdout
    print(f"loading {map_name} tick+render at {size}^2 ...", file=sys.stderr, flush=True)
    t0 = time.time()
    v = Viewer(map_name, size, view, device, synthetic)
    v.step(_actions(device=v.device))
    print(f"ready in {time.time() - t0:.1f}s — WASD/arrows/SPACE, q quits", file=sys.stderr, flush=True)
    held: dict = {}
    times = []
    key_iter = iter(keys) if keys is not None else None
    t_start = time.time()
    n = 0
    try:
        with RawKeys() as raw:
            out.write("\x1b[2J")  # clear once
            while max_ticks is None or n < max_ticks:
                t1 = time.time()
                if script:
                    a = scripted_action(n, v.device)
                else:
                    a = actions_from_keys(next(key_iter, b"") if key_iter is not None else raw.drain(), held,
                                          v.device)
                u8 = v.step(a).cpu().numpy()
                p = v.state.player.pos[0].tolist()
                out.write("\x1b[H" + frame_to_ansi(u8) + "\n")
                dt = time.time() - t1
                times.append(dt)
                out.write(f"\x1b[0K{map_name} tick {int(v.state.tick[0])} pos [{p[0]:+.2f} {p[1]:+.2f} {p[2]:+.2f}] "
                          f"{1.0 / max(dt, 1e-6):5.1f} FPS\n")
                out.flush()
                n += 1
                # pace to the reference's 60 Hz fixed tick when faster
                rest = 1.0 / 60.0 - (time.time() - t1)
                if pace and rest > 0:
                    time.sleep(rest)
                if seconds and time.time() - t_start > seconds:
                    break
    except KeyboardInterrupt:
        pass
    med = sorted(times)[len(times) // 2] if times else float("nan")
    return {"map": map_name, "size": size, "view": view, "frames": len(times), "median_ms": med * 1e3,
            "fps_uncapped": 1.0 / med if times else 0.0, "tick": int(v.state.tick[0]),
            "pos": v.state.player.pos[0].tolist(), "device": str(v.device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="terminal first-person viewer")
    ap.add_argument("map", nargs="?", default="arena_lit")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--view", type=int, default=112)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--script", action="store_true")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="-")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("play: no CUDA device (pass --cpu)", file=sys.stderr)
        return 2
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        summary = run(args.map, args.size, args.view, args.seconds, args.script, device, args.synthetic, out)
    finally:
        if out is not sys.stdout:
            out.close()
    print(f"\n{summary['frames']} frames; median tick+render+display {summary['median_ms']:.1f} ms "
          f"({summary['fps_uncapped']:.1f} FPS uncapped)", file=sys.stderr)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
