#!/usr/bin/env python3
"""Drive the PyTorch port (``sph_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (any failure exits non-zero and
prints no result line):

1. device  — requires CUDA, prints the card's name and power limit;
2. build   — builds the kernels from ``sph_tpu_torch/csrc`` with nvcc;
3. kernels — on the full ``default_131k`` and ``ghost_1m`` states (after
             one plain substep), each kernel against its plain torch
             version on the same inputs: the cell table bit-equal (fluid,
             and ghosts at ``ghost_1m``), the sweeps with ghost sources at
             ``ghost_1m``; each timed with CUDA events beside its plain
             version;
4. small   — the cell engine (kernels) against the all-pairs oracle over 20
             substeps of a 2k dam break and of a 512-particle box inside
             a ghost shell, realigned by ``orig_id``;
5. main    — ``configs.build`` then ``run_substeps`` for ``default_131k``
             and then ``ghost_1m``: 16 warm-up and 48 timed substeps each,
             with every kernel's launch count, the physical invariants, the
             ghosts' invariants and the fluid density against the JAX
             reference checked.

The last lines are the kernels' JSON record (numbers of ``ghost_1m``, the
path this script drives last), the ``nvidia-smi`` name and power limit,
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

WARMUP_SUBSTEPS = 16
TIMED_SUBSTEPS = 48          # 3 frames of the reference's 16-substep cap

# The JAX reference on the same spawn (sph_tpu, neighbor_impl "binned", on
# the CPU, seed 0) after 64 substeps: fluid density (max, mean).  Both
# columns compress under their own weight (k = 2000; 7.6 and 14.8 units
# deep), so their bottom rows pass 6000 by then.  At ghost_1m the
# reference ran with cell_capacity 16: its bottom cells hold up to 15 fluid
# rows by substep 64, and binned's configured capacity of 8 would drop the
# rows past it to a gravity-only update (ROADMAP R8).
REF_RHO = {
    "default_131k": (6426.8286, 1848.3309),
    "ghost_1m": (6451.4487, 1522.0352),
}
CONFIGS = tuple(REF_RHO)     # the main paths, in the order they are driven

# kernel vs plain tolerances
RHO_RTOL, RHO_ATOL = 1e-5, 1e-2     # tests/test_solver_equivalence.py:49
POS_ATOL = 1e-5
VEL_ATOL = 1e-3
ACC_RTOL, ACC_ATOL = 1e-4, 1e-1     # |acc| is about |g| = 980

# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "cell_table": ("sph_tpu_torch/csrc/cells.cu",
                   "sph_tpu/neighbors/mxu_permute.py:145"),
    "density": ("sph_tpu_torch/csrc/sweeps.cu",
                "sph_tpu/neighbors/pallas_sweeps.py:325"),
    "force_xsph": ("sph_tpu_torch/csrc/sweeps.cu",
                   "sph_tpu/neighbors/pallas_sweeps.py:474"),
}


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


def reset_launches() -> None:
    from sph_tpu_torch.neighbors import cells, sweeps
    cells.reset_launches()
    sweeps.reset_launches()


def launches() -> dict:
    from sph_tpu_torch.neighbors import cells, sweeps
    return {**cells.LAUNCHES, **sweeps.LAUNCHES}


def check_table(name, got, want) -> None:
    import torch
    for f, a, b in zip(got._fields, got, want):
        if (a is None) != (b is None) or (a is not None
                                          and not torch.equal(a, b)):
            raise AssertionError(f"cell_table {name} {f}: kernel is not "
                                 f"bit-equal to the plain version")


def phase_kernels(dev, config):
    """Each kernel against its plain version at full ``config``."""
    import torch
    from sph_tpu_torch.app import configs
    from sph_tpu_torch.neighbors import cells, sweeps
    from sph_tpu_torch.physics import constraints

    state, params, cfg = configs.build(config, device=dev)
    pv, ghosts = sweeps.prepare(state, params, params.dt, cfg)
    dims, nc = cfg.grid_dims, cfg.num_cells

    # one plain substep, so densities and velocities are non-trivial
    r = cells.build(state, params, dims)
    rho, pres = sweeps.density_plain(r.key, r.state.pos, r.cell_start,
                                     r.cell_end, pv, ghosts)
    out = sweeps.force_xsph_plain(r.key, r.state.pos, r.state.vel, rho,
                                  r.cell_start, r.cell_end, pv, ghosts)
    state = constraints.apply_container(
        sweeps.reassemble(r.state, rho, pres, *out, params,
                          ghosts=ghosts is not None), params)

    # the cell table, bit-equal: the fluid's, and the ghosts' (pos only)
    fluid = cells.fluid_sort(state, params, dims)
    tables = {"fluid": (fluid, state.vel)}
    if ghosts is not None:
        tables["ghosts"] = (cells.ghost_sort(state, params, dims), None)
    for which, ((skey, order), vel) in tables.items():
        got = cells.cell_table(skey, order, state.pos, vel, nc)
        want = cells.cell_table_plain(skey, order, state.pos, vel, nc)
        torch.cuda.synchronize()
        check_table(which, got, want)
        log(f"{config} cell_table {which}: bit-equal ({int(skey.shape[0])} "
            f"rows, {nc} cells, {int((want.cell_end > want.cell_start).sum())}"
            f" occupied)")

    r = cells.build(state, params, dims)
    key, pos, vel, cs, ce = (r.key, r.state.pos, r.state.vel, r.cell_start,
                             r.cell_end)
    rho_p, pres_p = sweeps.density_plain(key, pos, cs, ce, pv, ghosts)
    rho_k, pres_k = sweeps.density(key, pos, cs, ce, pv, ghosts)
    torch.cuda.synchronize()
    err_rho = check_close("density rho", rho_k, rho_p, RHO_RTOL, RHO_ATOL)
    err_pres = max_err(pres_k, pres_p)
    log(f"{config} density: max|rho err| {err_rho!r}  max|pres err| "
        f"{err_pres!r}  rho range [{float(rho_p[rho_p > 0].min())!r}, "
        f"{float(rho_p.max())!r}]")

    fp = sweeps.force_xsph_plain(key, pos, vel, rho_p, cs, ce, pv, ghosts)
    fk = sweeps.force_xsph(key, pos, vel, rho_p, cs, ce, pv, ghosts)
    torch.cuda.synchronize()
    err_pos = check_close("force_xsph npos", fk[0], fp[0], 0.0, POS_ATOL)
    err_vel = check_close("force_xsph nvel", fk[1], fp[1], 0.0, VEL_ATOL)
    err_acc = check_close("force_xsph acc", fk[2], fp[2], ACC_RTOL, ACC_ATOL)
    log(f"{config} force_xsph: max abs err pos {err_pos!r} vel {err_vel!r} "
        f"acc {err_acc!r}")

    skey, order = fluid
    times = {
        "cell_table": (
            time_ms(lambda: cells.cell_table(skey, order, state.pos,
                                             state.vel, nc), 50),
            time_ms(lambda: cells.cell_table_plain(skey, order, state.pos,
                                                   state.vel, nc), 50)),
        "density": (
            time_ms(lambda: sweeps.density(key, pos, cs, ce, pv, ghosts), 50),
            time_ms(lambda: sweeps.density_plain(key, pos, cs, ce, pv,
                                                 ghosts), 5)),
        "force_xsph": (
            time_ms(lambda: sweeps.force_xsph(key, pos, vel, rho_p, cs, ce,
                                              pv, ghosts), 50),
            time_ms(lambda: sweeps.force_xsph_plain(key, pos, vel, rho_p, cs,
                                                    ce, pv, ghosts), 5)),
    }
    for name, (k_ms, p_ms) in times.items():
        log(f"{config} {name}: kernel {k_ms!r} ms, plain {p_ms!r} ms "
            f"({int(key.shape[0])} rows)")
    errs = {"cell_table": 0.0, "density": err_rho,
            "force_xsph": max(err_pos, err_vel, err_acc)}
    return errs, times


def ghost_shell_fixture(dev):
    """512 fluid particles in a box of half 3 inside the ghost shell (as
    tests/test_pallas_engine.py:46-69), moved into the -X, -Y, -Z corner so
    that the walls' ghosts are within h of the fluid from the start."""
    import numpy as np
    from sph_tpu_torch.core import state as S
    from sph_tpu_torch.core.params import FluidParams, compute_grid_dims

    half = (3.0, 3.0, 3.0)
    fluid = S.spawn_standard(512, h=0.28, box_half=half, seed=1)
    fluid.pos += np.asarray([-0.35, -0.2, -0.35], np.float32)
    state = S.state_from_spawn(S.concat_spawns(
        fluid, S.spawn_ghost_box_shell(h=0.28, box_half=half)), device=dev)
    params = FluidParams.default(
        device=dev, box_half=np.asarray(half, np.float32)).derive_mass()
    return state, params, compute_grid_dims(0, half, (0, 0, 0), 0.28)


def check_ghosts(name, start, end, rho0) -> None:
    """Ghosts of ``start`` are unmoved in ``end`` (realigned by orig_id),
    with v = 0 and rho0 (every face is active)."""
    import torch
    g = (start.ghost > 0) & (start.valid > 0)
    inv = torch.argsort(end.orig_id)
    if not torch.equal(end.pos[inv][g], start.pos[g]):
        raise AssertionError(f"{name}: a ghost moved")
    if not bool((end.vel[inv][g] == 0).all()):
        raise AssertionError(f"{name}: a ghost has a velocity")
    if not bool((end.density[inv][g] == rho0).all()):
        raise AssertionError(f"{name}: a ghost's density is not rho0")


def phase_small(dev):
    """Cell engine (kernels) vs the all-pairs oracle over 20 substeps: a
    2k dam break, and a box inside a ghost shell."""
    import numpy as np
    import torch
    from sph_tpu_torch.core import state as S
    from sph_tpu_torch.core.params import (FluidParams, SimConfig,
                                           compute_grid_dims)
    from sph_tpu_torch.engine.step import run_substeps

    dam = (S.state_from_spawn(S.spawn_standard(2048, seed=7), device=dev),
           FluidParams.default(device=dev).derive_mass(),
           compute_grid_dims(0, np.array([7.0, 7.0, 7.0]), np.zeros(3), 0.28))
    for name, (state, params, dims) in (("2k dam break", dam),
                                        ("ghost shell",
                                         ghost_shell_fixture(dev))):
        outs = {impl: run_substeps(state, params, params.dt, 20,
                                   SimConfig(n=state.n, grid_dims=dims,
                                             neighbor_impl=impl))
                for impl in ("brute", "cell")}
        ref, got = outs["brute"], outs["cell"]
        order = torch.argsort(got.orig_id)
        v = ref.fluid_mask()
        errs = {f: max_err(getattr(got, f)[order][v], getattr(ref, f)[v])
                for f in ("pos", "vel", "density")}
        log(f"{name}, cell kernels vs oracle over 20 substeps: {errs}")
        for f, lim in (("pos", 1e-4), ("vel", 1e-3), ("density", 1.0)):
            if not errs[f] < lim:
                raise AssertionError(f"{name} {f} err {errs[f]} >= {lim}")
        check_ghosts(name, state, got, float(params.rest_density))


def phase_main(dev, config):
    """The port's main path: configs.build + run_substeps at ``config``."""
    import torch
    from sph_tpu_torch.app import configs
    from sph_tpu_torch.core.params import rotation_matrix
    from sph_tpu_torch.engine.step import run_substeps

    start, params, cfg = configs.build(config, device=dev)
    state = start
    n_fluid = int(state.fluid_mask().sum())
    n_ghost = int((state.ghost > 0).sum())
    dt = params.dt
    torch.cuda.synchronize()

    reset_launches()
    state = run_substeps(state, params, dt, WARMUP_SUBSTEPS, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run_substeps(state, params, dt, TIMED_SUBSTEPS, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()

    total = WARMUP_SUBSTEPS + TIMED_SUBSTEPS
    # the ghost structure is one more cell table per run_substeps call
    expect = {"density": total, "force_xsph": total,
              "cell_table": total + (2 if n_ghost else 0)}
    if counts != expect:
        raise AssertionError(f"{config}: launches {counts} in {total} "
                             f"substeps, expected {expect}")
    fl = state.fluid_mask()
    pos, vel, rho = state.pos[fl], state.vel[fl], state.density[fl]
    if pos.shape[0] != n_fluid:
        raise AssertionError(f"{pos.shape[0]} fluid rows, expected {n_fluid}")
    for name, t in (("pos", state.pos), ("vel", state.vel),
                    ("density", state.density)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{config}: non-finite {name}")
    rho0 = float(params.rest_density)
    h, dtf = float(params.h), float(dt)
    rho_min, rho_max = float(rho.min()), float(rho.max())
    rho_mean = float(rho.double().mean())
    vmax = float(torch.linalg.vector_norm(vel, dim=-1).max())
    log(f"main path {config}: {n_fluid} fluid + {n_ghost} ghost rows, "
        f"{total} substeps, launches {counts}; density range "
        f"[{rho_min!r}, {rho_max!r}], mean {rho_mean!r}, max |v| {vmax!r}")
    if not rho_min >= 0.5 * rho0 - 1e-3:
        raise AssertionError(f"{config}: density {rho_min} below the floor")
    for name, got, want, rtol in (
            ("max", rho_max, REF_RHO[config][0], 0.02),
            ("mean", rho_mean, REF_RHO[config][1], 0.005)):
        if not abs(got - want) <= rtol * want:
            raise AssertionError(f"{config}: fluid density {name} {got} is "
                                 f"not within {rtol} of the reference's "
                                 f"{want}")
    if not vmax <= 0.4 * h / dtf * (1 + 1e-4):
        raise AssertionError(f"{config}: speed {vmax} above the CFL cap")
    local = (pos - params.box_center) @ rotation_matrix(params.box_euler_deg)
    if not bool((local.abs() <= params.box_half + 1e-4).all()):
        raise AssertionError(f"{config}: a fluid particle left the box")
    if n_ghost:
        check_ghosts(config, start, state, rho0)

    ms = wall / TIMED_SUBSTEPS * 1e3
    rate = n_fluid * TIMED_SUBSTEPS / wall
    log(f"main path {config}: {ms!r} ms/substep, {rate!r} particle-steps/s "
        f"(host clock over {TIMED_SUBSTEPS} substeps after {WARMUP_SUBSTEPS} "
        f"warm-up) on {card_line()}")
    return counts


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

    errs = {}
    for config in CONFIGS:
        e, times = phase_kernels(dev, config)
        errs = {k: max(v, errs.get(k, 0.0)) for k, v in e.items()}
    phase_small(dev)
    for config in CONFIGS:
        counts = phase_main(dev, config)

    # errors: the larger of the two configurations'; launches and times:
    # the last configuration's (ghost_1m)
    record = {"kernels": [
        {"name": f"{name}_kernel", "route": "cuda", "source": source,
         "replaces": replaces, "launches": counts[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name, (source, replaces) in KERNELS.items()]}
    print(json.dumps(record), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
