#!/usr/bin/env python3
"""Drive the PyTorch port (``sph_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (any failure exits non-zero and
prints no result line):

1. device  — requires CUDA, prints the card's name and power limit;
2. build   — builds the sweep kernels from ``sph_tpu_torch/csrc`` with nvcc;
3. kernels — on the full ``default_131k`` state (after one plain substep),
             each kernel against its plain torch version on the same inputs;
4. small   — the cell engine (kernels) against the all-pairs oracle over 20
             substeps of a 2k dam break, realigned by ``orig_id``;
5. main    — ``configs.build("default_131k")`` then ``run_substeps``: 16
             warm-up and 48 timed substeps, with both kernels' launch
             counts and the physical invariants checked.

The last lines are the kernels' JSON record, the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

CONFIG = "default_131k"
WARMUP_SUBSTEPS = 16
TIMED_SUBSTEPS = 48          # 3 frames of the reference's 16-substep cap

# The JAX reference on the same spawn (sph_tpu, neighbor_impl "binned", on
# the CPU, seed 0) after 64 substeps: fluid density max and mean.  The
# column compresses under its own weight (k = 2000, 7.6 units deep), so the
# bottom rows pass 6000 by then.
REF_RHO_MAX = 6426.8286
REF_RHO_MEAN = 1848.3309

# kernel vs plain tolerances
RHO_RTOL, RHO_ATOL = 1e-5, 1e-2     # tests/test_solver_equivalence.py:49
POS_ATOL = 1e-5
VEL_ATOL = 1e-3
ACC_RTOL, ACC_ATOL = 1e-4, 1e-1     # |acc| is about |g| = 980

KERNELS = {
    "density": "sph_tpu/neighbors/pallas_sweeps.py:325",
    "force_xsph": "sph_tpu/neighbors/pallas_sweeps.py:474",
}
SOURCE = "sph_tpu_torch/csrc/sweeps.cu"


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def check_close(name, got, want, rtol, atol) -> float:
    import torch
    bad = (got - want).abs() > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: kernel disagrees with plain version "
            f"(max abs err {max_err(got, want)}, rtol {rtol}, atol {atol}, "
            f"{int(bad.sum())} elements out)")
    return max_err(got, want)


def time_ms(fn, reps: int) -> float:
    """Device time per call from CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    # keep the card busy while the host enqueues the calls, so the events
    # time the calls back to back and not the host's launch overhead
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernels(dev):
    """Each kernel against its plain version at full default_131k."""
    import torch
    from sph_tpu_torch.app import configs
    from sph_tpu_torch.neighbors import cells, sweeps
    from sph_tpu_torch.physics import constraints

    state, params, cfg = configs.build(CONFIG, device=dev)
    pv = sweeps.prepare(state, params, params.dt, cfg)
    dims = cfg.grid_dims

    # one plain substep, so densities and velocities are non-trivial
    r = cells.build(state, params, dims)
    rho, pres = sweeps.density_plain(r.key, r.state.pos, r.cell_start,
                                     r.cell_end, pv)
    out = sweeps.force_xsph_plain(r.key, r.state.pos, r.state.vel, rho,
                                  r.cell_start, r.cell_end, pv)
    state = constraints.apply_container(
        sweeps.reassemble(r.state, rho, pres, *out, params), params)

    r = cells.build(state, params, dims)
    key, pos, vel, cs, ce = (r.key, r.state.pos, r.state.vel, r.cell_start,
                             r.cell_end)
    rho_p, pres_p = sweeps.density_plain(key, pos, cs, ce, pv)
    rho_k, pres_k = sweeps.density(key, pos, cs, ce, pv)
    torch.cuda.synchronize()
    err_rho = check_close("density rho", rho_k, rho_p, RHO_RTOL, RHO_ATOL)
    err_pres = max_err(pres_k, pres_p)
    log(f"density: max|rho err| {err_rho!r}  max|pres err| {err_pres!r}  "
        f"rho range [{float(rho_p[rho_p > 0].min())!r}, "
        f"{float(rho_p.max())!r}]")

    fp = sweeps.force_xsph_plain(key, pos, vel, rho_p, cs, ce, pv)
    fk = sweeps.force_xsph(key, pos, vel, rho_p, cs, ce, pv)
    torch.cuda.synchronize()
    err_pos = check_close("force_xsph npos", fk[0], fp[0], 0.0, POS_ATOL)
    err_vel = check_close("force_xsph nvel", fk[1], fp[1], 0.0, VEL_ATOL)
    err_acc = check_close("force_xsph acc", fk[2], fp[2], ACC_RTOL, ACC_ATOL)
    log(f"force_xsph: max abs err pos {err_pos!r} vel {err_vel!r} "
        f"acc {err_acc!r}")

    times = {
        "density": (time_ms(lambda: sweeps.density(key, pos, cs, ce, pv), 50),
                    time_ms(lambda: sweeps.density_plain(key, pos, cs, ce,
                                                         pv), 5)),
        "force_xsph": (
            time_ms(lambda: sweeps.force_xsph(key, pos, vel, rho_p, cs, ce,
                                              pv), 50),
            time_ms(lambda: sweeps.force_xsph_plain(key, pos, vel, rho_p, cs,
                                                    ce, pv), 5)),
    }
    for name, (k_ms, p_ms) in times.items():
        log(f"{name}: kernel {k_ms!r} ms, plain {p_ms!r} ms "
            f"({int(key.shape[0])} rows)")
    errs = {"density": err_rho, "force_xsph": max(err_pos, err_vel, err_acc)}
    return errs, times


def phase_small(dev):
    """Cell engine (kernels) vs the all-pairs oracle on a 2k dam break."""
    import numpy as np
    import torch
    from sph_tpu_torch.core import state as S
    from sph_tpu_torch.core.params import (FluidParams, SimConfig,
                                           compute_grid_dims)
    from sph_tpu_torch.engine.step import run_substeps

    state = S.state_from_spawn(S.spawn_standard(2048, seed=7), device=dev)
    params = FluidParams.default(device=dev).derive_mass()
    dims = compute_grid_dims(0, np.array([7.0, 7.0, 7.0]), np.zeros(3), 0.28)
    outs = {impl: run_substeps(state, params, params.dt, 20,
                               SimConfig(n=state.n, grid_dims=dims,
                                         neighbor_impl=impl))
            for impl in ("brute", "cell")}
    ref, got = outs["brute"], outs["cell"]
    order = torch.argsort(got.orig_id)
    v = ref.valid > 0
    errs = {f: max_err(getattr(got, f)[order][v], getattr(ref, f)[v])
            for f in ("pos", "vel", "density")}
    log(f"2k dam break, cell kernels vs oracle over 20 substeps: {errs}")
    for f, lim in (("pos", 1e-4), ("vel", 1e-3), ("density", 1.0)):
        if not errs[f] < lim:
            raise AssertionError(f"2k dam break {f} err {errs[f]} >= {lim}")


def phase_main(dev):
    """The port's main path: configs.build + run_substeps at default_131k."""
    import torch
    from sph_tpu_torch.app import configs
    from sph_tpu_torch.core.params import rotation_matrix
    from sph_tpu_torch.engine.step import run_substeps
    from sph_tpu_torch.neighbors import sweeps

    state, params, cfg = configs.build(CONFIG, device=dev)
    n_fluid = int(state.fluid_mask().sum())
    dt = params.dt
    torch.cuda.synchronize()

    sweeps.reset_launches()
    state = run_substeps(state, params, dt, WARMUP_SUBSTEPS, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run_substeps(state, params, dt, TIMED_SUBSTEPS, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sweeps.LAUNCHES)

    total = WARMUP_SUBSTEPS + TIMED_SUBSTEPS
    for name, count in launches.items():
        if count != total:
            raise AssertionError(f"{name} launched {count} times in "
                                 f"{total} substeps")
    fl = state.fluid_mask()
    pos, vel, rho = state.pos[fl], state.vel[fl], state.density[fl]
    if pos.shape[0] != n_fluid:
        raise AssertionError(f"{pos.shape[0]} fluid rows, expected {n_fluid}")
    for name, t in (("pos", pos), ("vel", vel), ("density", rho)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite {name}")
    rho0 = float(params.rest_density)
    h, dtf = float(params.h), float(dt)
    rho_min, rho_max = float(rho.min()), float(rho.max())
    if not rho_min >= 0.5 * rho0 - 1e-3:
        raise AssertionError(f"density {rho_min} below the floor")
    rho_mean = float(rho.double().mean())
    for name, got, want, rtol in (("max", rho_max, REF_RHO_MAX, 0.02),
                                  ("mean", rho_mean, REF_RHO_MEAN, 0.005)):
        if not abs(got - want) <= rtol * want:
            raise AssertionError(f"fluid density {name} {got} is not within "
                                 f"{rtol} of the reference's {want}")
    vmax = float(torch.linalg.vector_norm(vel, dim=-1).max())
    if not vmax <= 0.4 * h / dtf * (1 + 1e-4):
        raise AssertionError(f"speed {vmax} above the CFL cap")
    local = (pos - params.box_center) @ rotation_matrix(params.box_euler_deg)
    if not bool((local.abs() <= params.box_half + 1e-4).all()):
        raise AssertionError("a fluid particle left the box")

    ms = wall / TIMED_SUBSTEPS * 1e3
    rate = n_fluid * TIMED_SUBSTEPS / wall
    log(f"main path {CONFIG}: {n_fluid} particles, {total} substeps; "
        f"density range [{rho_min!r}, {rho_max!r}], mean {rho_mean!r}, "
        f"max |v| {vmax!r}")
    log(f"main path {CONFIG}: {ms!r} ms/substep, {rate!r} particle-steps/s "
        f"(host clock over {TIMED_SUBSTEPS} substeps after {WARMUP_SUBSTEPS} "
        f"warm-up) on {card_line()}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from sph_tpu_torch.native import build

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0!r} s")

    errs, times = phase_kernels(dev)
    phase_small(dev)
    launches = phase_main(dev)

    record = {"kernels": [
        {"name": f"{name}_kernel", "route": "cuda", "source": SOURCE,
         "replaces": KERNELS[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name in KERNELS]}
    print(json.dumps(record), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
