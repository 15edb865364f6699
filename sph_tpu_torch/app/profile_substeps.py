"""Where a substep's time goes on the card, for one bench configuration
or one scene path.

    python -m sph_tpu_torch.app.profile_substeps dam_break_8k
    python -m sph_tpu_torch.app.profile_substeps rotated_512k --emit-rows
    python -m sph_tpu_torch.app.profile_substeps fountain_50k

Each window is one frame: for a bench configuration its frame prologue
(``configs.frame_prologue``: the wave at ``rotated_512k``, nothing
elsewhere), then 16 substeps; for a scene path (``app/scene_paths.py``)
the frame of ``scene_paths.frame`` (``Scene.update``): the audio reaction,
then its 16 substeps.  After 2 warm-up frames, times 3 windows
with the host clock around synchronised work (no profiler), then profiles
one more window with ``torch.profiler`` (CPU and CUDA activity).
``--emit-rows`` runs the cell engine with ``SimConfig.emit_rows``.
It prints the ms per substep of each window, the device operations
(kernels, copies, fills) per substep, the device busy time per substep
(the union of the device intervals), the device's idle share of the median
unprofiled substep and of the profiled one, and the device time per
substep by name, largest first.  The last line is the same as one JSON
object.  It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from collections import defaultdict

import torch

from sph_tpu_torch.app import configs, scene_paths
from sph_tpu_torch.engine.step import SceneBuffers, run_substeps

WARMUP_FRAMES, SUBSTEPS, WINDOWS, TOP = 2, 16, 3, 12


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals, in µs."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _bench_frames(name: str, emit_rows: bool, substeps: int):
    """(start state, frame: state -> state) of a bench configuration."""
    state, params, cfg = configs.build(name)
    cfg = dataclasses.replace(cfg, emit_rows=emit_rows)
    prologue = configs.frame_prologue(name, params, substeps)
    buffers = SceneBuffers.create(cfg)

    def frame(st):
        return run_substeps(prologue(st), params, buffers, params.dt,
                            substeps, cfg)[0]
    return state, frame


def _scene_frames(name: str, emit_rows: bool, substeps: int):
    """(start state, frame: state -> state) of a scene path; the scene
    carries its own state, params, buffers, phases and accumulator, so the
    frame ignores the state it is given."""
    scene = scene_paths.build(name)
    scene.config = dataclasses.replace(scene.config, emit_rows=emit_rows)
    index = [0]

    def frame(_):
        n = scene_paths.frame(index[0], scene)
        if n != substeps:
            raise RuntimeError(f"{name}: frame {index[0]} ran {n} "
                               f"substeps, not {substeps}")
        index[0] += 1
        return scene.state
    return scene.state, frame


def profile(name: str, emit_rows: bool = False,
            warmup_frames: int = WARMUP_FRAMES, substeps: int = SUBSTEPS,
            windows: int = WINDOWS, top: int = TOP):
    if not torch.cuda.is_available():
        raise RuntimeError("profile_substeps needs a CUDA card")
    frames = (_scene_frames if name in scene_paths.PATHS else _bench_frames)
    state, frame = frames(name, emit_rows, substeps)

    for _ in range(warmup_frames):
        state = frame(state)
    torch.cuda.synchronize()

    ms = []
    for _ in range(windows):
        t0 = time.perf_counter()
        state = frame(state)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / substeps * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state = frame(state)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / substeps * 1e3

    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy_ms = _busy_us((e.time_range.start, e.time_range.end)
                       for e in dev) / substeps / 1e3
    med = statistics.median(ms)
    out = {
        "config": name, "emit_rows": emit_rows,
        "card": torch.cuda.get_device_name(0),
        "fluid_rows": int(state.fluid_mask().sum()),
        "ms_per_substep": ms, "median_ms_per_substep": med,
        "profiled_ms_per_substep": prof_ms,
        "device_ops_per_substep": len(dev) / substeps,
        "device_busy_ms_per_substep": busy_ms,
        "idle_share": 1.0 - busy_ms / med,
        "idle_share_profiled": 1.0 - busy_ms / prof_ms,
        "top": [{"name": k, "us_per_substep": v[0] / substeps,
                 "per_substep": v[1] / substeps}
                for k, v in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:top]],
    }
    print(f"{name} on {out['card']}: ms/substep {ms!r} (median {med!r}); "
          f"profiled {prof_ms!r}", flush=True)
    print(f"  {out['device_ops_per_substep']!r} device ops per substep, "
          f"device busy {busy_ms!r} ms per substep, idle share "
          f"{out['idle_share']!r} (profiled {out['idle_share_profiled']!r})",
          flush=True)
    for row in out["top"]:
        print(f"  {row['us_per_substep']:10.3f} us/substep "
              f"{row['per_substep']:7.2f}x  {row['name'][:100]}", flush=True)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config", choices=sorted(
        (*configs.CONFIGS, *scene_paths.PATHS)))
    ap.add_argument("--emit-rows", action="store_true",
                    help="the cell engine's emitted-row transport")
    args = ap.parse_args(argv)
    profile(args.config, emit_rows=args.emit_rows)


if __name__ == "__main__":
    main()
