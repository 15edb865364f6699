"""Benchmark entry point of the port: prints ONE JSON line on stdout
(counterpart of ``bench.py`` at the repo root, which drives the JAX
package).

    python -m sph_tpu_torch.app.bench [config_name] [n_substeps] [engine]

Defaults ``ghost_1m`` and 20, as ``bench.py:23-25``; ``engine`` overrides
the configuration's neighbor engine (``brute`` benches the all-pairs
oracle, by the JAX package's names, ``configs.build``).  It builds the
configuration on the CUDA card (with no card it raises), runs one warm-up
frame, the configuration's frame prologue and ``n_substeps`` substeps,
then times ``FRAMES`` more such frames with the host clock around work
that ends in ``torch.cuda.synchronize()``, and reports the median frame as
particle-steps per second: fluid rows x substeps / seconds.  The host
clock spreads from frame to frame, so the card's name and power limit, every
frame's ms per substep and their min and max go to stderr, with the
runner (on the card, ``run_substeps``'s captured program, captured in the
warm-up frame, ``engine/graph.py``) and its count of captures.  A configuration
with ``viz_export`` (``export_4m``) then exports the final state's frames,
as ``bench.py:147-169`` does: four 960x540 PNGs, palette 1 driven by height,
speed, pressure and density, written to ``bench_frames/<config>_<drive>.png``
(:func:`export_frames`), with the export's seconds on stderr.  The JSON line
has exactly ``metric``, ``value``, ``unit`` and ``vs_baseline``
(``bench.py:171-176``); the baseline is the reference's design point,
about 4.8e7 particle-steps/s (50k particles x 16 substeps x 60 fps,
``BASELINE.md``).
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time
from typing import List, Optional, Union

import numpy as np
import torch

from sph_tpu_torch.app import configs
from sph_tpu_torch.core.device import card_line, resolve
from sph_tpu_torch.core.state import ParticleState
from sph_tpu_torch.engine import graph
from sph_tpu_torch.engine.step import SceneBuffers, run_substeps
from sph_tpu_torch.viz import palettes as PAL
from sph_tpu_torch.viz.camera import fit_camera
from sph_tpu_torch.viz.splat import render_frame, save_png

REFERENCE_BASELINE_PSTEPS = 4.8e7
FRAMES = 5                   # timed frames, after one of warm-up
EXPORT_DIR = "bench_frames"
# the exported frames' color drives and their names (bench.py:158-161)
EXPORT_DRIVES = ((PAL.DRIVE_HEIGHT, "height"), (PAL.DRIVE_SPEED, "speed"),
                 (PAL.DRIVE_PRESSURE, "pressure"),
                 (PAL.DRIVE_DENSITY, "density"))


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def export_params(cfg: configs.BenchConfig, drive: int) -> PAL.VizParams:
    """The exported frames' palette uniforms (``bench.py:162-164``):
    palette 1 (turbo) over ``drive``, heights across the box."""
    return PAL.VizParams(palette_id=1, color_drive=drive,
                         height_min=-cfg.box_half[1],
                         height_max=cfg.box_half[1])


def export_frames(state: ParticleState, cfg: configs.BenchConfig,
                  out_dir: str) -> List[str]:
    """The headless export of BASELINE config 5 (``bench.py:147-169``):
    the container framed by ``fit_camera``, one 960x540 frame of palette 1
    for each drive of ``EXPORT_DRIVES``, each saved as
    ``<out_dir>/<config>_<drive>.png``.  Returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    cam = fit_camera(np.asarray(cfg.box_half, np.float32))
    paths = []
    for mode, drive in EXPORT_DRIVES:
        img = render_frame(state, export_params(cfg, mode), cam,
                           width=960, height=540,
                           particle_radius=0.5 * cfg.h)
        paths.append(os.path.join(out_dir, f"{cfg.name}_{drive}.png"))
        save_png(img, paths[-1])
    return paths


def run(cfg: Union[str, configs.BenchConfig], n_substeps: int = 20,
        device=None, frames: int = FRAMES,
        neighbor_impl: Optional[str] = None) -> dict:
    """Time ``frames`` frames of ``cfg`` after one warm-up frame; returns
    the record that ``main`` prints.  ``device`` is the CUDA card unless
    the caller names another (the tests pass ``"cpu"``);
    ``neighbor_impl`` overrides the configuration's engine, by the JAX
    package's name or the port's (``configs.build``)."""
    if frames < 1:
        raise ValueError("the bench times at least one frame")
    dev = resolve(device)
    cuda = dev.type == "cuda"
    if isinstance(cfg, str):
        cfg = configs.CONFIGS[cfg]
    name = cfg.name
    state, params, sim = configs.build(cfg, neighbor_impl=neighbor_impl,
                                       device=dev)
    prologue = configs.frame_prologue(cfg, params, n_substeps)
    buffers = SceneBuffers.create(sim, device=dev)
    n_fluid = int(state.fluid_mask().sum())
    _log(f"device: {card_line() if cuda else dev}")
    _log(f"config={name} fluid={n_fluid} padded={state.n} "
         f"grid={sim.grid_dims} impl={sim.neighbor_impl}")

    def frame(st):
        t0 = time.perf_counter()
        st, _ = run_substeps(prologue(st), params, buffers, params.dt,
                             n_substeps, sim)
        if cuda:
            torch.cuda.synchronize(dev)
        return st, time.perf_counter() - t0

    state, warm = frame(state)
    _log(f"warm-up frame: {warm:.3f}s")
    seconds = []
    for _ in range(frames):
        state, s = frame(state)
        seconds.append(s)
    ms = [1e3 * s / n_substeps for s in seconds]
    _log(graph.describe() if cuda else "runner: the eager loop "
         "(run_substeps_eager) on the CPU")
    _log(f"{frames} frames of {n_substeps} substeps, ms/substep: "
         f"{[round(m, 4) for m in ms]} (median "
         f"{statistics.median(ms):.4f}, min {min(ms):.4f}, max {max(ms):.4f})")

    # sanity: the simulation must stay finite
    if bool(torch.isnan(state.pos).any()):
        raise AssertionError("NaN in positions after the bench run")

    if cfg.viz_export:
        t0 = time.perf_counter()
        export_frames(state, cfg, EXPORT_DIR)
        _log(f"viz export ({len(EXPORT_DRIVES)} drives, {n_fluid} "
             f"particles): {time.perf_counter() - t0:.3f}s -> {EXPORT_DIR}/")

    psteps = n_fluid * n_substeps / statistics.median(seconds)
    return {
        "metric": f"particle-steps/sec @ {name}",
        "value": round(psteps, 1),
        "unit": "particle-steps/sec",
        "vs_baseline": round(psteps / REFERENCE_BASELINE_PSTEPS, 3),
    }


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    name = argv[0] if len(argv) > 0 else "ghost_1m"
    n_substeps = int(argv[1]) if len(argv) > 1 else 20
    # bench.py's third argument: the engine, e.g. "brute" for the oracle
    override = {"neighbor_impl": argv[2]} if len(argv) > 2 else {}
    if name not in configs.CONFIGS:
        sys.exit(f"unknown config '{name}'; "
                 f"available: {', '.join(sorted(configs.CONFIGS))}")
    print(json.dumps(run(name, n_substeps, **override)), flush=True)


if __name__ == "__main__":
    main()
