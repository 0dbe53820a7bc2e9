"""Scripted end-to-end demo (counterpart of examples/demo.py): step a map
tick by tick with a keyboard-style action script, mix each tick's audio
and render a film strip of first-person frames with the HUD and the
viewmodel.

    python3 -m c_game_engine_tpu_torch.demo OUT_DIR [map] [frames] [ticks] [--cpu]

(defaults: arena_lit, 6 frames, 150 ticks). The committed maps ship no
HUD assets and no sounds, so the demo uses the synthetic HUD
(render/synthetic_hud.py) and the synthetic sounds
(audio/synthetic_sounds.py, written under OUT_DIR/sounds). Each tick runs
the single-env `core/step.py::step` and `mix_frame` of SAMPLES_PER_TICK
samples at the listener; every `ticks // frames` ticks one 160 x 160
`render_with_hud` frame is kept. Writes OUT_DIR/demo_<map>.png (a .npy
where PIL is absent) and OUT_DIR/demo_<map>.wav (the mixed session).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

SIZE = 160


def script_actions(t: int, device) -> "Actions":
    """examples/demo.py's choreography: pan right, walk forward while
    panning back, jump, then turn in place surveying the room."""
    from c_game_engine_tpu_torch.core.actions import Actions, Button

    a = Actions.zeros(device="cpu")
    if t < 30:  # pan right
        a.look[0] = 0.02
    elif t < 60:  # walk forward while panning back
        a.move[1] = -1.0
        a.look[0] = -0.02
    elif t < 66:  # jump
        a.buttons[Button.JUMP] = True
    else:  # turn in place, surveying the room
        a.look[0] = 0.025
    return Actions(a.move.to(device), a.look.to(device), a.buttons.to(device))


def run(out_dir, map_name="arena_lit", n_frames=6, total_ticks=150, device="cuda", log=print) -> dict:
    """Run the demo; returns a summary with the frames ([H, W, 3] CPU
    tensors), the WAV's peak and the written paths."""
    from c_game_engine_tpu_torch.audio.bank import SAMPLES_PER_TICK, write_wav
    from c_game_engine_tpu_torch.audio.mixer import listener_from_state, mix_frame
    from c_game_engine_tpu_torch.audio.synthetic_sounds import with_synthetic_sounds
    from c_game_engine_tpu_torch.core.state import reset, tree_map
    from c_game_engine_tpu_torch.core.step import step
    from c_game_engine_tpu_torch.render.bundle import load_render_map
    from c_game_engine_tpu_torch.render.raster import render_with_hud
    from c_game_engine_tpu_torch.render.synthetic_hud import with_synthetic_hud

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    cmap, bundle = load_render_map(map_name, device)
    bundle = with_synthetic_hud(bundle)
    cmap, bank = with_synthetic_sounds(cmap, out / "sounds")
    st = reset(cmap)
    vols = torch.ones(4, device=cmap.device)  # master/music/sfx/ui defaults
    snap_every = max(total_ticks // n_frames, 1)
    frames, pcm = [], []
    for t in range(total_ticks):
        st = step(cmap, st, script_actions(t, cmap.device))
        one = tree_map(lambda x: x[None], st)
        pos, quat = listener_from_state(one)
        pcm.append(mix_frame(bank, one.audio, pos, quat, vols, SAMPLES_PER_TICK)[0])
        if (t + 1) % snap_every == 0 and len(frames) < n_frames:
            frames.append(render_with_hud(bundle, cmap, st, SIZE, SIZE).cpu())
            log(f"tick {t + 1}: frame {len(frames)}/{n_frames}")

    strip = torch.cat(frames, dim=1).numpy()
    u8 = (np.clip(strip, 0.0, 1.0) * 255).astype(np.uint8)
    image = out / f"demo_{map_name}.png"
    try:
        from PIL import Image

        Image.fromarray(u8).save(image)
        log(f"wrote {image} ({u8.shape[1]}x{u8.shape[0]})")
    except ImportError:
        image = image.with_suffix(".npy")
        np.save(image, u8)
        log(f"PIL unavailable; wrote {image}")
    track = torch.cat(pcm).cpu().numpy()
    wav = out / f"demo_{map_name}.wav"
    write_wav(wav, track)
    peak = float(np.abs(track).max())
    log(f"wrote {wav} ({track.shape[0]} samples, peak {peak:.3f}, {int(st.sound_plays)} play events)")
    final = st.player.pos.tolist()
    log(f"final player position: {[round(x, 3) for x in final]}, tick={int(st.tick)}")
    return {"map": map_name, "ticks": int(st.tick), "frames": frames, "samples": track.shape[0], "peak": peak,
            "play_events": int(st.sound_plays), "final_pos": final, "image": image, "wav": wav,
            "seconds": time.perf_counter() - t0}


def main(argv) -> int:
    device = "cpu" if "--cpu" in argv else "cuda"
    args = [a for a in argv if a != "--cpu"]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    if device == "cuda" and not torch.cuda.is_available():
        print("demo: no CUDA device (pass --cpu for the plain path on the CPU)", file=sys.stderr)
        return 2
    run(args[0], args[1] if len(args) > 1 else "arena_lit", int(args[2]) if len(args) > 2 else 6,
        int(args[3]) if len(args) > 3 else 150, device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
