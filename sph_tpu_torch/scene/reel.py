"""Reel export — offline, frame-accurate, music-synced renders
(counterpart of ``sph_tpu/scene/reel.py``, a copy of it over the port's
``Scene``: the physics and the water's smoothing and composite run on the
scene's device, the splat, the outline and the PNG on the host).

Rebuild of the reference's reel pipeline (``Scene0p.cpp:3227-3523``):

1. ``AnalyzeTrack`` decodes the track and produces per-frame band
   envelopes with the SAME DSP as the live reactor,
2. all phase accumulators zero + the sim respawns (determinism contract:
   no wall clock anywhere; phases advance by frame_dt,
   ``Scene0p.cpp:3297-3308``),
3. per frame: sequencer tick -> audio reaction from the precomputed
   bands -> ``ceil(frame_dt/dt)`` substeps (optionally capped) ->
   headless render -> PNG,
4. finish: write ``mux_reel.sh`` (ffmpeg mux of frames + audio — the
   reference writes ``mux_reel.bat``, ``Scene0p.cpp:3454-3502``).

Deterministic: same track + same settings + same seed => identical
frames.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Optional

import numpy as np

from sph_tpu_torch.audio.analyze import (ReelAnalysis, analyze_track,
                                         detect_drops)
from sph_tpu_torch.scene.scene import Scene
from sph_tpu_torch.viz.splat import save_png

RESOLUTIONS = {0: (1080, 1920), 1: (1080, 1350), 2: (1920, 1080)}


@dataclasses.dataclass
class ReelConfig:
    track_path: str
    out_dir: str = "reel_frames"
    fps: int = 30
    max_seconds: float = 0.0          # 0 = whole track
    width: int = 1080
    height: int = 1920
    substep_cap: int = 0              # 0 = uncapped (exact physics time)
    supersample: int = 1              # 2 = render 2x and box-downsample
    auto_sequence_presets: Optional[list] = None   # preset names for drops


@dataclasses.dataclass
class ReelResult:
    frames_written: int = 0
    drops: list = dataclasses.field(default_factory=list)
    mux_script: str = ""
    error: str = ""

    @property
    def ok(self) -> bool:
        return self.frames_written > 0 and not self.error


def export_reel(scene: Scene, cfg: ReelConfig,
                progress: Optional[Callable[[int, int], None]] = None,
                analysis: Optional[ReelAnalysis] = None) -> ReelResult:
    """Run the full offline export. ``analysis`` may be pre-computed
    (e.g. synthetic bands for tests)."""
    out = ReelResult()
    if analysis is None:
        analysis = analyze_track(cfg.track_path, cfg.fps, cfg.max_seconds)
    if not analysis.ok:
        out.error = analysis.error or "analysis failed"
        return out

    out.drops = detect_drops(analysis.bass, cfg.fps)

    # auto-build the drop sequencer when preset names are supplied
    if cfg.auto_sequence_presets:
        scene.sequencer.build_from_drops(out.drops,
                                         cfg.auto_sequence_presets)
        scene.sequencer.enabled = True

    # determinism: zero phases, rewind cues, respawn (Scene0p.cpp:3297)
    scene.phases.reset()
    scene.sequencer.rewind()
    scene.sim_time = 0.0
    scene.respawn()

    os.makedirs(cfg.out_dir, exist_ok=True)
    frame_dt = 1.0 / cfg.fps
    ss = max(1, cfg.supersample)

    for f in range(analysis.frame_count):
        bands = (float(analysis.bass[f]), float(analysis.mid[f]),
                 float(analysis.treble[f]))
        # exact frame time: ceil(frameDt/dt) substeps (Scene0p.cpp:3402)
        n_sub = math.ceil(frame_dt / scene.settings.time_step)
        if cfg.substep_cap > 0:
            n_sub = min(n_sub, cfg.substep_cap)
        scene.update(frame_dt, bands=bands, max_substeps=n_sub)

        img = scene.render(cfg.width * ss, cfg.height * ss)
        if ss > 1:
            img = img.reshape(cfg.height, ss, cfg.width, ss, 3) \
                     .mean(axis=(1, 3)).astype(np.uint8)
        save_png(img, os.path.join(cfg.out_dir, f"frame_{f:05d}.png"))
        out.frames_written += 1
        if progress is not None:
            progress(f + 1, analysis.frame_count)

    out.mux_script = _write_mux_script(cfg)
    return out


def preview_size(reel_w: int, reel_h: int,
                 window_w: int, window_h: int) -> tuple:
    """Fit the reel aspect into the window — the reference's
    ``EnsurePreviewTarget`` sizing math (``Scene0p.cpp:3240-3247``):
    fill window height at aspect reelW:reelH, shrink to window width if
    that overflows, floor at 2 px."""
    aspect = float(reel_w) / float(reel_h)
    ph = window_h
    pw = int(round(ph * aspect))
    if pw > window_w:
        pw = window_w
        ph = int(round(pw / aspect))
    return max(2, pw), max(2, ph)


def preview_reel(scene: Scene, cfg: ReelConfig,
                 window_w: int = 960, window_h: int = 540,
                 progress: Optional[Callable[[int, int], None]] = None,
                 analysis: Optional[ReelAnalysis] = None) -> ReelResult:
    """Reduced-res reel preview before committing to the full export
    (the reference previews into a window-fitted FBO,
    ``Scene0p.cpp:3227-3280``).  Same deterministic pipeline, smaller
    frames, no supersample, frames under ``<out_dir>_preview``."""
    pw, ph = preview_size(cfg.width, cfg.height, window_w, window_h)
    pcfg = dataclasses.replace(
        cfg, width=pw, height=ph, supersample=1,
        out_dir=cfg.out_dir.rstrip("/") + "_preview")
    return export_reel(scene, pcfg, progress=progress, analysis=analysis)


def _write_mux_script(cfg: ReelConfig) -> str:
    """ffmpeg mux of frames + audio (the reference's mux_reel.bat,
    ``Scene0p.cpp:3454-3502``, as a POSIX shell script)."""
    path = os.path.join(cfg.out_dir, "mux_reel.sh")
    track = os.path.abspath(cfg.track_path) if cfg.track_path else ""
    audio_in = f' -i "{track}"' if track else ""
    audio_map = " -map 0:v -map 1:a -shortest" if track else ""
    with open(path, "w") as f:
        f.write(
            "#!/bin/sh\n"
            "# Mux the exported reel frames with the source track.\n"
            f"cd \"$(dirname \"$0\")\"\n"
            f"ffmpeg -y -framerate {cfg.fps} -i frame_%05d.png"
            f"{audio_in} -c:v libx264 -pix_fmt yuv420p -crf 18"
            f"{audio_map} reel.mp4\n")
    os.chmod(path, 0o755)
    return path
