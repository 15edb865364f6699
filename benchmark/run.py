"""One run of one cell of ``BENCHMARK.json`` on the port ``sph_tpu_torch``.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  The run makes the cell's rows from the
seed (``spawn.py``), builds the port for its configuration
(``system.py``), warms up the cell's one frame shape (the first frame
captures the frame program, the next replay it), then measures a closed
loop of frames, one client, back to back, for ``--seconds``: each frame
runs the configuration's prologue where it names one, the traffic's
substeps, and waits for the card, then exports the state as a PNG where
the traffic says so.

With ``--trace 0`` it reports the cell's end-to-end metrics:
``particle_steps_per_s`` (fluid rows times the substeps of every frame
completed in the window, over the seconds from the window's start to the
end of its last frame), ``frame_ms_p95`` (the 95th percentile of every
frame's wall time) and ``setup_s`` (process start to the end of the
warm-up, the last work before the window: the card's clocks are read
between the two).  With ``--trace 1`` the first ``trace_frames`` frames
of the window run under ``torch.profiler`` and it reports the cell's
per-layer metrics, each read by ``metrics/<name>.py`` from that slice:
the run switches the port's own spans on (from before the warm-up, so
the window runs what the warm-up ran) and hands the slice the port's
counters as they moved over its frames and over the whole window.

After the window, a sample of its frames drawn from the seed is held to
the plain reference (``check.py``), and the numbers compared are printed
beside their limits, last on stderr and last in the result.  The last
line of stdout is the result, one JSON object.  Without enough CUDA cards
the run exits 2 and prints no result; it exits 3, with no result, if JAX,
jaxlib, flax or the JAX package ``sph_tpu`` is loaded once the window has
closed.  The card's name, clocks and power around the window, the frames
completed, set-up by its parts (the build's seconds among them) and where
the trace went are on stderr.  Numpy's BLAS and torch's CPU operations run
on one host thread.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

START = time.perf_counter()

# one host thread for numpy's BLAS and torch's CPU operations, so that a
# run's host work does not depend on how many of the host's shared cores
# are free
for _threads in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                 "MKL_NUM_THREADS"):
    os.environ[_threads] = "1"

import torch  # noqa: E402

from benchmark import cells, check, spawn, trace, window  # noqa: E402
from benchmark.reference import pairs, sph  # noqa: E402

FOREIGN = ("jax", "jaxlib", "flax", "sph_tpu")


def log(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def process_age() -> float:
    """Seconds since this process started (the kernel's clock, to 10 ms),
    or since the harness was imported where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - START


def card() -> str:
    """The card's name, clocks, power draw and limit and temperature, as
    ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def foreign(modules) -> list:
    """The top-level names of ``modules`` that are JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in modules} & set(FOREIGN))


class Run:
    """One cell's system and its frames on one device."""

    def __init__(self, cell: cells.Cell, seed: int, device,
                 traced: bool = False):
        from benchmark.system import System
        self.cell, self.seed = cell, seed
        self.cfg, self.traffic = cell.config, cell.traffic
        self.device = torch.device(device)
        if self.cfg["precision"] != "float32":
            raise ValueError(f"{self.cfg['name']}: the harness runs float32, "
                             f"not {self.cfg['precision']}")
        # float32 as the configuration states it: no TF32 in matrix products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.rows = spawn.spawn(self.cfg, seed)
        self.fluid = int((self.rows["ghost"] == 0).sum())
        self.system = System(self.cfg, self.traffic, self.rows, self.device)
        self.build_s = self.system.build()
        self.system.trace(traced)
        self.png = os.path.join(tempfile.gettempdir(),
                                f"benchmark-{cell.name}.png")
        self.spans = trace.Spans()

    def frame(self, state):
        """One frame of the traffic; (new state, image or None)."""
        sp, sysm = self.spans, self.system
        if sysm.wave is not None:
            with sp("frame.prologue"):
                state = sysm.prologue(state)
        with sp("frame.substeps"):
            out = sysm.frame(state)
        with sp("frame.sync"):
            sysm.sync()
        img = None
        if sysm.export:
            with sp("export.render"):
                img = sysm.render(out)
            with sp("export.png"):
                sysm.save(img, self.png)
        return out, img

    def warm_up(self):
        """The traffic's warm-up frames; their seconds are in
        ``warm_s`` (the first captures the frame program)."""
        state, self.warm_s = self.system.state0, []
        for _ in range(int(self.traffic["warmup_frames"])):
            t0 = time.perf_counter()
            state, _ = self.frame(state)
            self.system.sync()
            self.warm_s.append(time.perf_counter() - t0)
        return state

    def window(self, state, seconds: float, check_frames: int,
               trace_frames: int = 0) -> dict:
        """Frames back to back until ``seconds`` have passed (one at
        least); the frames' wall times, the frames to check (a sample of
        ``check_frames`` drawn from the seed, and the last), and the
        profiler with its frames, and the port's counters' moves over
        them, when ``trace_frames``; the counters' moves over the whole
        window."""
        sample = window.Reservoir(check_frames, self.seed)
        durations = []
        prof, traced, traced_state, before, counted = None, 0, None, {}, None

        def moved(since):
            return {k: v - since.get(k, 0)
                    for k, v in self.system.counters().items()}

        def stop():
            out = moved(before)
            prof.__exit__(None, None, None)
            self.spans.record = False
            return out

        if trace_frames:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.system.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            self.spans.record = True
            before = self.system.counters()
        at_start = self.system.counters()
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            out, img = self.frame(state)
            t_end = time.perf_counter()
            durations.append(t_end - t0)
            last = (state, out, img)
            sample.offer(last)
            state = out
            if prof is not None and len(durations) == trace_frames:
                counted = stop()
                traced, traced_state = trace_frames, out
            if t_end - t_start >= seconds:
                break
        if prof is not None and traced == 0:
            counted = stop()
            traced, traced_state = len(durations), state
        in_window = moved(at_start)
        # the sample, and the last frame, whose PNG is the file's
        picked = [item for _, item in sample.sample()]
        if picked[-1][1] is not state:
            picked.append(last)
        return {"durations": durations, "seconds": t_end - t_start,
                "sample": picked, "state": state, "prof": prof,
                "traced": traced, "traced_state": traced_state,
                "counters": counted, "window_counters": in_window}

    def check(self, sample, control: bool = False, diagnose: bool = False):
        """(worst numbers, frames out of limits) of the sampled frames;
        with ``control`` the reference in the next lower precision stands
        in for the port."""
        fields = self.system.fields
        samples = [(fields(i), fields(o), img) for i, o, img in sample]
        png = None
        if self.system.export and not control:
            from benchmark.reference import splat
            png = splat.read_png(self.png)
        rows = check.frame_numbers(self.cfg, self.traffic,
                                   self.cell.limits["row_tolerance"],
                                   samples, self.device, png=png,
                                   control=control, diagnose=diagnose)
        limits = self.cell.limits["limits"]
        failed = sum(any(not v <= limits[k] for k, v in r.items()
                         if k in limits) for r in rows)
        return check.worst(rows), failed

    def start_rows_apart(self) -> float:
        made = sph.initial_state(self.rows, self.device)
        return check.start_rows_apart(self.system.fields(self.system.state0),
                                      made)


def execute(cell: cells.Cell, seed: int, seconds: float, traced: bool,
            device) -> dict:
    """The whole run but the look for a card and the look for JAX: the
    result that ``main`` prints."""
    t_imported = process_age()
    t0 = time.perf_counter()
    torch.empty(0, device=device)
    t_context = time.perf_counter() - t0
    run = Run(cell, seed, device, traced)
    t_run = time.perf_counter() - t0 - t_context
    log(f"cell {cell.name}: {run.fluid} fluid rows, {len(run.rows['pos'])} "
        f"rows in all, seed {seed}, device {run.device}")
    log(f"build (the first run in a checkout compiles): {run.build_s:.3f} s")
    if run.system.cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    state = run.warm_up()
    setup_s = process_age()
    log(f"set-up {setup_s:.2f} s: process start and imports "
        f"{t_imported:.2f}, device context {t_context:.3f}, rows and the "
        f"port {t_run - run.build_s:.3f}, build {run.build_s:.3f}, warm-up "
        f"frames {', '.join(f'{x:.3f}' for x in run.warm_s)}")
    if run.system.cuda:
        log(f"card before the window: {card()}")
    w = run.window(state, seconds, int(cell.limits["check_frames"]),
                   int(cell.traffic["trace_frames"]) if traced else 0)
    del state
    frames = len(w["durations"])
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.system.cuda else 0)
    if run.system.cuda:
        log(f"card after the window: {card()}")
    log(f"window: {frames} frames in {w['seconds']:.4f} s")

    device_info = {"platform": "gpu" if run.system.cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(run.device)
                            if run.system.cuda else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"metrics": {}, "breakdown": None}
    if traced:
        result.update(per_layer(run, w, device_info))
    else:
        n = int(cell.traffic["substeps"])
        result["metrics"] = {
            "particle_steps_per_s": window.rate(run.fluid * n, frames,
                                                w["seconds"]),
            "frame_ms_p95": 1e3 * window.p95(w["durations"]),
            "setup_s": setup_s}
    w.pop("state")
    w.pop("prof")
    gc.collect()

    numbers, failed = run.check(w["sample"])
    numbers["start_rows_apart"] = run.start_rows_apart()
    checks = check.verdict(numbers, cell.limits["limits"])
    correct = all(ok for *_, ok in checks)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    out = {"correct": correct, "attempted": frames,
           "failed": failed if correct else max(failed, 1),
           "metrics": {k: {"value": v, "unit": units[k]}
                       for k, v in result["metrics"].items()},
           "device": device_info}
    if result["breakdown"] is not None:
        out["breakdown"] = result["breakdown"]
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim, _ in checks}
    for k, v, lim, ok in checks:
        log(f"check {k}: {v!r} (limit {lim!r}){'' if ok else ' OUT'}")
    return out


def per_layer(run: Run, w: dict, device_info: dict) -> dict:
    """The per-layer metrics of the traced slice, the slice's busy and
    wall seconds, and its breakdown."""
    cell = run.cell
    frame = sph.Frame(run.cfg, run.device)
    traced_state = run.system.fields(w["traced_state"])
    counts = {"fluid": run.fluid,
              "ghosts": int((run.rows["ghost"] > 0).sum()),
              "num_cells": frame.p.num_cells}
    sl = trace.from_profiler(w["prof"], w["traced"],
                             int(cell.traffic["substeps"]), counts,
                             lambda: pairs.count(frame, traced_state),
                             counters=w["counters"],
                             window_counters=w["window_counters"])
    path = os.path.join(tempfile.gettempdir(),
                        f"benchmark-{cell.name}-trace.json")
    w["prof"].export_chrome_trace(path)
    log(f"trace of the first {w['traced']} frames: {path}")
    metrics = {}
    for m in cell.per_layer:
        v = cells.reader(m["name"]).read(sl)
        if v is not None:
            metrics[m["name"]] = float(v)
    device_info["busy_s"] = sl.busy_s
    device_info["window_s"] = sl.window_s
    return {"metrics": metrics, "breakdown": sl.breakdown()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} found")
        return 2
    out = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = foreign(sys.modules)
    if bad:
        log(f"loaded in this process once the window closed: "
            f"{', '.join(bad)}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
