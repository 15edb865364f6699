"""CLI entry point of the port (counterpart of ``sph_tpu/app/main.py``) —
the headless counterpart of the reference's ``main()`` + SceneManager loop
(``Main.cpp:10-22``, ``SceneManager.cpp``).

Subcommands:

- ``run``        — simulate a scene for N frames, optionally rendering
  PNG frames (the live-loop analogue, fixed-dt accumulator)
- ``bench``      — run a BASELINE config through the port's bench
  (``python -m sph_tpu_torch.app.bench``) and print its JSON metric line
- ``reel``       — music-synced offline export (audio -> frames -> mux)
- ``screenshot`` — one high-res still (DoCapture analogue)
- ``art``        — list/apply the 14 art presets; ``surprise`` randomizer
- ``presets``    — list saved KV presets

Usage: ``python -m sph_tpu_torch.app.main <subcommand> [options]``

The scene runs on the CUDA card; :func:`main` takes the device as an
argument (the tests name the CPU), the command line has no flag for it.
``--impl`` keeps the JAX package's choices and maps each to an engine of
the port (``engine.step.ENGINES``): the port's cell engine has no per-cell
capacity, so ``cell``, ``binned`` and ``pallas`` (and ``auto``) all run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from sph_tpu_torch.engine.step import ENGINES, engine

# --impl's choices: the JAX package's (sph_tpu/app/main.py:27-28), every
# name of the table but the port's own all-pairs kernels
IMPL_CHOICES = [name for name in ENGINES if name != "brute_kernel"]


def _add_scene_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--particles", type=int, default=50000)
    p.add_argument("--impl", default="auto", choices=IMPL_CHOICES,
                   help="auto, cell, binned and pallas run the cell "
                        "engine's kernels; brute the all-pairs oracle; "
                        "brute_pallas the all-pairs kernels")
    p.add_argument("--shape", type=int, default=0, help="shape type 0-9")
    p.add_argument("--art", type=int, default=-1,
                   help="start from art preset 0-13")
    p.add_argument("--preset", default="", help="load a saved KV preset")
    p.add_argument("--preset-dir", default="presets")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--river", action="store_true",
                   help="river mode: procedural canyon + stream recycling")
    p.add_argument("--quickset", default="",
                   choices=["", "stable", "splashy"],
                   help="physics quick-set bundle (Scene0p.cpp:824-850)")


def _build_scene(args):
    from sph_tpu_torch.scene.scene import Scene
    from sph_tpu_torch.scene.settings import SceneSettings

    s = SceneSettings()
    s.particle_count = args.particles
    s.shape_type = args.shape
    scene = Scene(settings=s, neighbor_impl=engine(args.impl), seed=args.seed,
                  preset_dir=args.preset_dir, device=args.device)
    if args.art >= 0:
        scene.apply_art_preset(args.art)
    if args.preset:
        if not scene.load_preset(args.preset):
            sys.exit(f"preset not found: {args.preset}")
    if getattr(args, "river", False):
        scene.enable_river(args.seed)
    if getattr(args, "quickset", ""):
        from sph_tpu_torch.scene.quicksets import apply_quickset
        scene.settings = apply_quickset(scene.settings, args.quickset)
        scene.respawn()   # the reference queues pendingReset
    return scene


def cmd_run(args) -> None:
    scene = _build_scene(args)
    frame_dt = 1.0 / args.fps
    reactor = None
    if getattr(args, "track", ""):
        # live reactor streaming the track as if it were system audio
        # (the WASAPI-loopback analogue, AudioReactive.cpp:62-164)
        from sph_tpu_torch.audio.reactive import AudioReactive, FileSource
        scene.settings.audio_enabled = True
        reactor = AudioReactive(FileSource(args.track))
        reactor.start()
    # interactive live controls (the ImGui-panel stand-in,
    # Scene0p.cpp:595-1265) — raw-key polling while pacing realtime;
    # inert on a non-TTY stdin
    from sph_tpu_torch.app.keys import KeyController
    keys = KeyController(scene) if args.realtime else None

    t0 = time.time()
    ctx = keys if keys is not None else _NullCtx()
    with ctx:
        for f in range(args.frames):
            if keys is not None:
                if not keys.poll():
                    print("quit", file=sys.stderr)
                    break
                if keys.paused:
                    time.sleep(frame_dt)
                    continue
            bands = (0.0, 0.0, 0.0)
            if reactor is not None:
                bands = (reactor.get_bass(), reactor.get_mid(),
                         reactor.get_treble())
            elif args.audio:
                import math
                bands = (0.5 + 0.5 * math.sin(f * 0.3), 0.2, 0.1)
            n_sub = scene.update(frame_dt, bands=bands)
            if args.out and args.every > 0 and f % args.every == 0:
                from sph_tpu_torch.viz.splat import save_png
                import os
                os.makedirs(args.out, exist_ok=True)
                save_png(scene.render(args.width, args.height),
                         f"{args.out}/frame_{f:05d}.png")
            if args.realtime:
                # FPS cap: sleep off the frame budget
                # (SceneManager.cpp:86-92)
                budget = (f + 1) * frame_dt - (time.time() - t0)
                if budget > 0:
                    time.sleep(budget)
            if f % 30 == 0:
                print(f"frame {f}/{args.frames} substeps={n_sub} "
                      f"t={scene.sim_time:.2f}s "
                      f"wall={time.time() - t0:.1f}s",
                      file=sys.stderr)
    if reactor is not None:
        reactor.stop()
    print(f"done: {args.frames} frames in {time.time() - t0:.1f}s")


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def cmd_bench(args) -> None:
    import subprocess
    sys.exit(subprocess.call(
        [sys.executable, "-m", "sph_tpu_torch.app.bench", args.config,
         str(args.substeps)]))


def cmd_reel(args) -> None:
    from sph_tpu_torch.scene.reel import ReelConfig, export_reel
    scene = _build_scene(args)
    cfg = ReelConfig(
        track_path=args.track, out_dir=args.out, fps=args.fps,
        max_seconds=args.max_seconds, width=args.width,
        height=args.height, substep_cap=args.substep_cap,
        auto_sequence_presets=(args.drop_presets.split(",")
                               if args.drop_presets else None))
    t0 = time.time()

    def progress(i, n):
        if i % 30 == 0 or i == n:
            el = time.time() - t0
            eta = el / i * (n - i)
            print(f"reel {i}/{n}  {el:.0f}s elapsed, ~{eta:.0f}s left",
                  file=sys.stderr)

    if getattr(args, "preview", False):
        from sph_tpu_torch.scene.reel import preview_reel
        ww, wh = (int(v) for v in args.window.lower().split("x"))
        res = preview_reel(scene, cfg, window_w=ww, window_h=wh,
                           progress=progress)
    else:
        res = export_reel(scene, cfg, progress=progress)
    if not res.ok:
        sys.exit(f"reel export failed: {res.error}")
    print(json.dumps({"frames": res.frames_written,
                      "drops": res.drops, "mux": res.mux_script}))


def cmd_screenshot(args) -> None:
    scene = _build_scene(args)
    frame_dt = 1.0 / 60.0
    for _ in range(args.warmup_frames):
        scene.update(frame_dt)
    w, h = scene.capture(args.out, size="window",
                         width=args.width, height=args.height,
                         supersample=args.supersample)
    print(f"wrote {args.out} ({w}x{h})")


def cmd_art(args) -> None:
    from sph_tpu_torch.scene.art_presets import ART_PRESET_NAMES
    for i, name in enumerate(ART_PRESET_NAMES):
        print(f"{i:2d}  {name}")


def cmd_presets(args) -> None:
    from sph_tpu_torch.io.presets import list_presets
    for name in list_presets(args.preset_dir):
        print(name)


def main(argv=None, device=None) -> None:
    """Parse ``argv`` and run its subcommand, the scene on ``device``: the
    CUDA card unless the caller names another (``core.device.resolve``)."""
    ap = argparse.ArgumentParser(prog="sph_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="simulate + optional frame export")
    _add_scene_args(p)
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--fps", type=int, default=60)
    p.add_argument("--audio", action="store_true",
                   help="drive with a synthetic beat")
    p.add_argument("--track", default="",
                   help="stream this WAV through the live reactor")
    p.add_argument("--realtime", action="store_true",
                   help="pace frames to --fps wall-clock (the FPS cap)")
    p.add_argument("--out", default="")
    p.add_argument("--every", type=int, default=0,
                   help="render every Nth frame")
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("bench", help="run a BASELINE config (the port's "
                                     "bench)")
    p.add_argument("config", nargs="?", default="ghost_1m")
    p.add_argument("substeps", nargs="?", type=int, default=20)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("reel", help="music-synced offline export")
    _add_scene_args(p)
    p.add_argument("--track", required=True)
    p.add_argument("--out", default="reel_frames")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--max-seconds", type=float, default=0.0)
    p.add_argument("--width", type=int, default=1080)
    p.add_argument("--height", type=int, default=1920)
    p.add_argument("--substep-cap", type=int, default=0)
    p.add_argument("--drop-presets", default="",
                   help="comma-separated preset names cued on bass drops")
    p.add_argument("--preview", action="store_true",
                   help="reduced-res preview fitted to --window before "
                        "committing to a full export (Scene0p.cpp:3227)")
    p.add_argument("--window", default="960x540",
                   help="preview window size WxH")
    p.set_defaults(fn=cmd_reel)

    p = sub.add_parser("screenshot", help="one high-res still")
    _add_scene_args(p)
    p.add_argument("--out", default="screenshot.png")
    p.add_argument("--width", type=int, default=3000)
    p.add_argument("--height", type=int, default=3000)
    p.add_argument("--warmup-frames", type=int, default=40)
    p.add_argument("--supersample", type=int, default=None,
                   help="default: 2x unless UV-warping post-FX are on")
    p.set_defaults(fn=cmd_screenshot)

    p = sub.add_parser("art", help="list art presets")
    p.set_defaults(fn=cmd_art)

    p = sub.add_parser("presets", help="list saved KV presets")
    p.add_argument("--preset-dir", default="presets")
    p.set_defaults(fn=cmd_presets)

    args = ap.parse_args(argv)
    args.device = device
    args.fn(args)


if __name__ == "__main__":
    main()
