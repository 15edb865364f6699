"""Where a substep's time goes on the card, for one bench configuration
or one scene path.

    python -m sph_tpu_torch.app.profile_substeps dam_break_8k
    python -m sph_tpu_torch.app.profile_substeps rotated_512k --emit-rows
    python -m sph_tpu_torch.app.profile_substeps fountain_50k
    python -m sph_tpu_torch.app.profile_substeps ghost_1m --slab

Each window is one frame: for a bench configuration its frame prologue
(``configs.frame_prologue``: the wave at ``rotated_512k``, nothing
elsewhere), then 16 substeps; for a scene path (``app/scene_paths.py``)
the frame of ``scene_paths.frame`` (``Scene.update``): the audio reaction,
then its 16 substeps.  The port's spans (``utils/trace.py``) are on
throughout.  After 2 warm-up frames, times 3 windows with the host clock
around synchronised work (no profiler), then profiles one more window with
``torch.profiler`` (CPU and CUDA activity).
``--emit-rows`` runs the cell engine with ``SimConfig.emit_rows``;
``--slab`` runs a bench configuration's frames on the slab engine
(``parallel/slabs.py``) as one NCCL rank, the slab path's own cost with no
halo and no migration.
The frames of the cell engine and of the all-pairs kernels go through
``run_substeps``'s captured program (``engine/graph.py``), captured in the
first warm-up frame, so the profiled frame is a replay and shows the graph
path's kernels and gaps; the slab engine runs its eager loop.  Which
runner ran and how many graphs it captured go to stderr.
It prints the ms per substep of each window, the device operations
(kernels, copies, fills) per substep, the device busy time per substep
(the union of the device intervals), the device's idle share of the
profiled frame (busy time over the frame's wall time, both from its
trace), the frame's idle ms by the innermost of the port's spans that the
host was in ("outside spans": the sync, the scene's reaction, the tool),
the device time per substep by name, largest first, and the port's span
totals (host ms a frame) and counters over the timed and profiled frames.
The last line is the same as one JSON object.  It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import tempfile
import time
from collections import defaultdict

import torch

from sph_tpu_torch.app import configs, scene_paths
from sph_tpu_torch.engine import graph
from sph_tpu_torch.engine.step import SceneBuffers, run_substeps
from sph_tpu_torch.parallel import group as G, slabs
from sph_tpu_torch.utils import trace

WARMUP_FRAMES, SUBSTEPS, WINDOWS, TOP = 2, 16, 3, 12
# the profiler label of the profiled frame and its sync
FRAME = "profile_substeps.frame"


def _merged(intervals):
    """The union of (start, end) intervals as disjoint sorted ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _idle_by_span(busy, start, end, spans) -> dict:
    """The device's idle time between ``start`` and ``end``, outside the
    disjoint sorted ``busy`` intervals, summed by the innermost (shortest)
    of ``spans`` ((name, start, end)) that covers it, "outside spans" where
    none does.  A gap is cut where a span starts or ends."""
    cuts = sorted({t for _, s, e in spans for t in (s, e)})
    out = defaultdict(float)
    prev = start
    for s, e in [*busy, (end, end)]:
        a, b = max(prev, start), min(s, end)
        points = [a, *(t for t in cuts if a < t < b), b]
        for p, q in zip(points, points[1:]):
            if q <= p:
                continue
            mid = 0.5 * (p + q)
            cover = [(se - ss, n) for n, ss, se in spans if ss <= mid <= se]
            out[min(cover)[1] if cover else "outside spans"] += q - p
        prev = max(prev, e)
    return dict(out)


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


def _slab_frames(name: str, substeps: int, group: G.Group):
    """(start state, frame) of a bench configuration on the slab engine, as
    the group's one rank."""
    state, params, cfg = configs.build(name)
    prologue = configs.frame_prologue(name, params, substeps)
    scfg = slabs.make_slab_config(cfg, group.world)
    buffers = SceneBuffers.create(cfg)

    def frame(st):
        return slabs.run_substeps(prologue(st), params, buffers, params.dt,
                                  substeps, cfg, scfg, group)[0]
    return slabs.shard_by_slab(state, params, scfg, group.rank), frame


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


def profile(name: str, emit_rows: bool = False, slab: bool = False,
            warmup_frames: int = WARMUP_FRAMES, substeps: int = SUBSTEPS,
            windows: int = WINDOWS, top: int = TOP):
    if not torch.cuda.is_available():
        raise RuntimeError("profile_substeps needs a CUDA card")
    trace.enable(True)
    try:
        return _profile(name, emit_rows, slab, warmup_frames, substeps,
                        windows, top)
    finally:
        trace.enable(False)


def _profile(name, emit_rows, slab, warmup_frames, substeps, windows, top):
    if not slab:
        frames = (_scene_frames if name in scene_paths.PATHS
                  else _bench_frames)
        return _measure(name, *frames(name, emit_rows, substeps),
                        {"emit_rows": emit_rows}, None, warmup_frames,
                        substeps, windows, top)
    if emit_rows or name in scene_paths.PATHS:
        raise ValueError("--slab runs a bench configuration's default "
                         "transport")
    with tempfile.TemporaryDirectory() as tmp:
        group = G.init(0, 1, "nccl", f"file://{tmp}/rendezvous")
        try:
            return _measure(name, *_slab_frames(name, substeps, group),
                            {"slab": True}, group, warmup_frames, substeps,
                            windows, top)
        finally:
            G.close()


def _measure(name, state, frame, tags, group, warmup_frames, substeps,
             windows, top):
    """Warm up, time and profile ``frame``; ``group``, for the slab
    engine, counts its host waits (with each frame's ghost halo)."""
    for _ in range(warmup_frames):
        state = frame(state)
    torch.cuda.synchronize()
    counts0, totals0 = trace.counters(), trace.totals()

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
        with torch.profiler.record_function(FRAME):
            state = frame(state)
            torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / substeps * 1e3
    frames = windows + 1
    counts = {k: v - counts0.get(k, 0) for k, v in trace.counters().items()
              if v != counts0.get(k, 0)}
    span_ms = {k: (sec - totals0.get(k, (0.0, 0))[0]) * 1e3 / frames
               for k, (sec, n) in trace.totals().items()
               if n > totals0.get(k, (0.0, 0))[1]}

    # device operations, and the labels on the host (a label's device-side
    # annotation, which has its name, is no operation)
    dev, spans = [], []
    for e in prof.events():
        if e.name != FRAME and not e.name.startswith("sph."):
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append(e)
        elif e.device_type == torch.autograd.DeviceType.CPU:
            spans.append((e.name, e.time_range.start, e.time_range.end))
    (window,) = [s[1:] for s in spans if s[0] == FRAME]
    spans = [s for s in spans if s[0] != FRAME]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy = _merged((max(e.time_range.start, window[0]),
                    min(e.time_range.end, window[1])) for e in dev
                   if e.time_range.end > window[0]
                   and e.time_range.start < window[1])
    busy_us = sum(e - s for s, e in busy)
    idle_ms = {k: v / 1e3 for k, v in
               _idle_by_span(busy, *window, spans).items()}
    med = statistics.median(ms)
    if group is not None:       # the slab path's count exchanges
        tags["group_waits_per_substep"] = group.waits / (
            (warmup_frames + windows + 1) * substeps)
        runner = "runner: the slab engine's eager loop"
    else:
        runner = graph.describe()
        tags.update(runner="graph",
                    graphs_captured=trace.counter("graph.captures"))
    print(f"{name}: {runner}", file=sys.stderr, flush=True)
    out = {
        "config": name, **tags,
        "card": torch.cuda.get_device_name(0),
        "fluid_rows": int(state.fluid_mask().sum()),
        "ms_per_substep": ms, "median_ms_per_substep": med,
        "profiled_ms_per_substep": prof_ms,
        "device_ops_per_substep": len(dev) / substeps,
        "device_busy_ms_per_substep": busy_us / substeps / 1e3,
        "idle_share": 1.0 - busy_us / (window[1] - window[0]),
        "idle_ms_by_span": idle_ms,
        "span_ms_per_frame": span_ms,
        "counters": counts,
        "top": [{"name": k, "us_per_substep": v[0] / substeps,
                 "per_substep": v[1] / substeps}
                for k, v in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:top]],
    }
    print(f"{name} on {out['card']}: ms/substep {ms!r} (median {med!r}); "
          f"profiled {prof_ms!r}", flush=True)
    print(f"  {out['device_ops_per_substep']!r} device ops per substep, "
          f"device busy {out['device_busy_ms_per_substep']!r} ms per "
          f"substep, idle share {out['idle_share']!r} of the profiled frame",
          flush=True)
    print("  the profiled frame's idle ms by the host's innermost span: "
          + ", ".join(f"{k} {v!r}" for k, v in sorted(
              idle_ms.items(), key=lambda kv: -kv[1])), flush=True)
    for row in out["top"]:
        print(f"  {row['us_per_substep']:10.3f} us/substep "
              f"{row['per_substep']:7.2f}x  {row['name'][:100]}", flush=True)
    print(f"  the port's spans over the last {frames} frames, host ms a "
          f"frame: " + ", ".join(f"{k} {v!r}" for k, v in sorted(
              span_ms.items(), key=lambda kv: -kv[1])), flush=True)
    print(f"  the port's counters over the last {frames} frames: "
          + ", ".join(f"{k} {v}" for k, v in sorted(counts.items())),
          flush=True)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config", choices=sorted(
        (*configs.CONFIGS, *scene_paths.PATHS)))
    ap.add_argument("--emit-rows", action="store_true",
                    help="the cell engine's emitted-row transport")
    ap.add_argument("--slab", action="store_true",
                    help="the slab engine as one NCCL rank")
    args = ap.parse_args(argv)
    profile(args.config, emit_rows=args.emit_rows, slab=args.slab)


if __name__ == "__main__":
    main()
