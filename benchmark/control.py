"""The readings that the output check's limits are set from: for each
seed, a run's warm-up and window at the cell's own size and load, then
the numbers of its sampled frames twice, once for the port (the lower
readings) and once for the control, the reference computed in the next
lower precision in the port's place (the upper readings).

    python3 -m benchmark.control --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--fault face|foam]

With ``--fault`` the port runs with a fault planted underneath (``FAULTS``)
and only its numbers are read: each fault has to read out of limits.

One JSON line per seed on stdout: the frames of the window and its rate
and tail, the largest reading of each number for the port and for the
control, and the seconds the reference took.  The benchmark's own runs do
not run this.  It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from benchmark import cells, window
from benchmark.run import Run, log

FAULTS = {
    "face": "the ghosts of the box's +x face switched off in the port",
    "foam": "each frame's foam left as it came in",
    "prologue": "the configuration's frame prologue skipped in the port",
}


def _foam_unchanged(real):
    def frame(state):
        out = real(state)
        where = torch.empty_like(state.orig_id, dtype=torch.long)
        where[state.orig_id.long()] = torch.arange(
            len(where), device=where.device)
        return out.replace(foam=state.foam[where[out.orig_id.long()]])
    return frame


def plant(system, fault: str) -> None:
    """Break ``system`` (a ``benchmark.system.System``, before its first
    frame) by ``fault``, one of ``FAULTS``; the reference is untouched."""
    if fault == "face":
        system.params.ghost_face_active[1] = 0
    elif fault == "foam":
        system.frame = _foam_unchanged(system.frame)
    elif fault == "prologue":
        if system.wave is None:
            raise ValueError("the configuration has no frame prologue")
        system.prologue = lambda state: state
    else:
        raise ValueError(f"unknown fault {fault!r}; the faults: "
                         f"{', '.join(FAULTS)}")


def readings(cell: cells.Cell, seed: int, seconds: float, device,
             fault: str = None) -> dict:
    run = Run(cell, seed, device)
    if fault:
        plant(run.system, fault)
    state = run.warm_up()
    w = run.window(state, seconds, int(cell.limits["check_frames"]))
    del state
    t0 = time.perf_counter()
    sound, failed = run.check(w["sample"], diagnose=True)
    t1 = time.perf_counter()
    n = int(cell.traffic["substeps"])
    out = {"seed": seed, "frames": len(w["durations"]),
           "particle_steps_per_s": window.rate(
               run.fluid * n, len(w["durations"]), w["seconds"]),
           "frame_ms_p95": 1e3 * window.p95(w["durations"]),
           "checked": len(w["sample"]), "check_s": t1 - t0}
    if fault:
        return dict(out, fault=fault, port=sound, port_failed=failed)
    control, _ = run.check(w["sample"], control=True)
    return dict(out, sound=sound, sound_failed=failed, control=control,
                control_s=time.perf_counter() - t1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("the control readings need a CUDA card")
        return 2
    cell = cells.load(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds, "cuda",
                                  args.fault)), flush=True)
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
