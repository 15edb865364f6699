#!/usr/bin/env python3
"""Drive the PyTorch port (``sph_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (any failure exits non-zero and
prints no result line):

1. device  — requires CUDA, prints the card's name and power limit;
2. build   — builds the kernels from ``sph_tpu_torch/csrc`` with nvcc;
3. kernels — on the full ``default_131k`` and ``ghost_1m`` states (after
             one plain substep), each cell-engine kernel against its plain
             torch version on the same inputs: the cell table bit-equal
             (fluid, and ghosts at ``ghost_1m``), the sweeps with ghost
             sources at ``ghost_1m``; on the full ``dam_break_8k`` state
             (after one plain all-pairs substep), the two all-pairs
             kernels; each timed with CUDA events beside its plain
             version, with its bound (the least time the card could take
             for the same work) and the share of it that it reaches;
4. emit    — on the full ``rotated_512k`` state (after the wave and one
             plain substep), the emitted-row force kernel against its plain
             version, timed likewise, then 16 substeps with
             ``emit_rows`` and 16 without from one state, bit-identical;
5. small   — the cell engine (kernels) and the all-pairs engine (kernels)
             against the all-pairs oracle over 20 substeps of a 2k dam
             break and of a 512-particle box inside a ghost shell (the
             cell engine realigned by ``orig_id``, the all-pairs engine in
             place);
6. main    — ``configs.build`` with no device (the card is the default)
             then 4 frames of ``run_substeps(frame_prologue(state), ...,
             16)`` for ``default_131k``, ``ghost_1m``, ``dam_break_8k`` and
             ``rotated_512k`` (the wave before every frame, the emitted-row
             transport): the first frame warms up, the other 48 substeps
             are timed, with every kernel's launch count, the physical
             invariants, the ghosts' invariants and the fluid density
             against the JAX reference checked;
7. micro   — ``app.microbench.main`` and ``app.proto_expand.main`` (the
             entry points of the micro-kernels) with their launch counts,
             then each micro-kernel bit-equal to its plain version at the
             scripts' default sizes, timed likewise.

The last lines are the kernels' JSON record (each kernel with the
configuration or path whose launches and times it reports), the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

FRAMES = 4                   # the first warms up, the other 3 are timed
FRAME_SUBSTEPS = 16          # the reference's per-frame cap

# The JAX reference on the same spawn (sph_tpu, neighbor_impl "binned", on
# the CPU, seed 0) after 64 substeps: fluid density (max, mean).  Both
# columns compress under their own weight (k = 2000; 7.6 and 14.8 units
# deep), so their bottom rows pass 6000 by then.  At ghost_1m the
# reference ran with cell_capacity 16: its bottom cells hold up to 15 fluid
# rows by substep 64, and binned's configured capacity of 8 would drop the
# rows past it to a gravity-only update (ROADMAP R8).
# dam_break_8k: sph_tpu "brute" (the all-pairs oracle), seed 0, printed by
# ``PYTHONPATH=. python tests/test_torch_brute.py dam_break_8k 64``.
# rotated_512k: sph_tpu "binned" with cell_capacity 16, 4 frames of the
# wave and 16 substeps, printed by ``PYTHONPATH=. python
# tests/test_torch_impulses.py rotated_512k 4 16 16``; its fullest cell
# held 12 rows, so none overflowed (ROADMAP R9).
REF_RHO = {
    "default_131k": (6426.8286, 1848.3309),
    "ghost_1m": (6451.4487, 1522.0352),
    "dam_break_8k": (4864.46240234375, 1669.9207237884402),
    "rotated_512k": (5185.92529296875, 1413.0148309509968),
}
CONFIGS = tuple(REF_RHO)     # the main paths, in the order they are driven
# main paths that take the emitted-row transport (SimConfig.emit_rows),
# as ``SPH_EMIT_ROWS=1 python bench.py rotated_512k`` does in the JAX package
EMIT_ROWS = ("rotated_512k",)

# kernel vs plain tolerances
RHO_RTOL, RHO_ATOL = 1e-5, 1e-2     # tests/test_solver_equivalence.py:49
POS_ATOL = 1e-5
VEL_ATOL = 1e-3
ACC_RTOL, ACC_ATOL = 1e-4, 1e-1     # |acc| is about |g| = 980

# kernel -> (source, the TPU kernel it replaces, the configuration whose
# launches and times the JSON record reports; "micro" is the path of the
# micro-kernels' entry points)
KERNELS = {
    "cell_table": ("sph_tpu_torch/csrc/cells.cu",
                   "sph_tpu/neighbors/mxu_permute.py:145", "ghost_1m"),
    "density": ("sph_tpu_torch/csrc/sweeps.cu",
                "sph_tpu/neighbors/pallas_sweeps.py:325", "ghost_1m"),
    "force_xsph": ("sph_tpu_torch/csrc/sweeps.cu",
                   "sph_tpu/neighbors/pallas_sweeps.py:474", "ghost_1m"),
    "brute_density": ("sph_tpu_torch/csrc/brute.cu",
                      "sph_tpu/physics/brute_pallas.py:63", "dam_break_8k"),
    "brute_force": ("sph_tpu_torch/csrc/brute.cu",
                    "sph_tpu/physics/brute_pallas.py:82", "dam_break_8k"),
    "force_xsph_emit": ("sph_tpu_torch/csrc/sweeps.cu",
                        "sph_tpu/neighbors/pallas_sweeps.py:763",
                        "rotated_512k"),
    "smoke": ("sph_tpu_torch/csrc/micro.cu", "scripts/microbench.py:44",
              "micro"),
    "expand": ("sph_tpu_torch/csrc/micro.cu",
               "scripts/proto_bfly_kernel.py:42", "micro"),
}

# The card's peaks for the bounds (NVIDIA H100 SXM data sheet, at 700 W):
# float32 outside the tensor cores, and HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float32 operations per pair, counted from the kernels' source
# (csrc/sweeps.cu, csrc/brute.cu): the distance test that every tested
# pair pays (3 sub, 3 mul, 2 add, 1 compare), and the pair math of a pair
# within h (density: h2 - r2, d*d*d, the contrib weight, the add;
# force: rsqrt, r, the r < h test, m/rho, the spiky and viscosity terms
# and the three accumulators; XSPH: poly6, m/rho, the sum and the norm).
OPS_TEST = 9
OPS_DENSITY_NEAR = 5
OPS_FORCE_NEAR = 41
OPS_XSPH_NEAR = 17


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


def counted_modules():
    """The modules whose wrappers count their kernels' launches."""
    from sph_tpu_torch.app import microbench, proto_expand
    from sph_tpu_torch.neighbors import cells, sweeps
    from sph_tpu_torch.physics import brute_kernels
    return (cells, sweeps, brute_kernels, microbench, proto_expand)


def reset_launches() -> None:
    for mod in counted_modules():
        mod.reset_launches()


def launches() -> dict:
    return {k: v for mod in counted_modules() for k, v in mod.LAUNCHES.items()}


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def cell_pairs(key, pos, npos, cs, ce, pv, ghosts):
    """Pair counts of the cell sweeps on these inputs: the candidates that
    the fluid rows test (the 9 ranges, fluid and ghost), those within h of
    the row (density, self included), those within h and not the row
    (force), and those within h of the row's fresh position and not the
    row (XSPH)."""
    import torch
    from sph_tpu_torch.neighbors import sweeps
    out = [0, 0, 0, 0]
    srcs = [(pos, cs, ce, True)]
    if ghosts is not None:
        srcs.append((ghosts.pos, ghosts.ghost_start, ghosts.ghost_end, False))
    for r in sweeps._fluid_chunks(key, pv):
        for spos, starts, ends, fluid in srcs:
            idx, m = sweeps._candidates(key[r], starts, ends, pv)
            r2 = torch.sum((pos[r][:, None, :] - spos[idx]) ** 2, dim=-1)
            rr2 = torch.sum((npos[r][:, None, :] - spos[idx]) ** 2, dim=-1)
            other = m & (idx != r[:, None]) if fluid else m
            out[0] += int(m.sum())
            out[1] += int((m & (r2 < pv.h2)).sum())
            out[2] += int((other & (r2 < pv.h2)).sum())
            out[3] += int((other & (rr2 < pv.h2)).sum())
    return out


def brute_pairs(pos, npos, rho, contrib, pv):
    """Pair counts of the all-pairs kernels on these inputs: the pairs
    tested per pass (n^2), those within h with a contributing source
    (density, self included), those within h with a live source other than
    the row (force), and the same from the row's fresh position (XSPH)."""
    import torch
    n = pos.shape[0]
    live = (rho > 0) & (contrib > 0)
    rows = torch.arange(n, device=pos.device)
    out = [n * n, 0, 0, 0]
    for i0 in range(0, n, 1024):
        sl = slice(i0, min(n, i0 + 1024))
        r2 = torch.sum((pos[sl, None, :] - pos[None]) ** 2, dim=-1)
        rr2 = torch.sum((npos[sl, None, :] - pos[None]) ** 2, dim=-1)
        src = live[None, :] & (rows[sl, None] != rows[None, :])
        out[1] += int(((r2 < pv.h2) & (contrib[None, :] > 0)).sum())
        out[2] += int((src & (r2 < pv.h2)).sum())
        out[3] += int((src & (rr2 < pv.h2)).sum())
    return out


def report(config, name, k_ms, p_ms, nbytes, ops, rows, lib_ms=None):
    """Log a kernel's times and bound; return its record fields."""
    b_ms, by = bound(nbytes, ops)
    log(f"{config} {name}: kernel {k_ms!r} ms, plain {p_ms!r} ms, library "
        f"call {lib_ms!r} ms ({rows} rows); bound {b_ms!r} ms by {by} "
        f"({nbytes} bytes, {ops} operations), share of bound reached "
        f"{b_ms / k_ms!r}")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms}


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
    from sph_tpu_torch.app.microbench import time_ms
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
    n, nc8 = int(key.shape[0]), 8 * nc
    gbytes = 0 if ghosts is None else 12 * ghosts.count + nc8
    cand, near_d, near_f, near_x = cell_pairs(key, pos, fp[0], cs, ce, pv,
                                              ghosts)
    log(f"{config} cell sweeps: {cand} candidates tested by the fluid rows, "
        f"{near_d} within h (density), {near_f} (force), {near_x} (XSPH)")
    # bytes: each input read once, each output written once
    work = {
        # skey, order, pos, vel in; spos, svel, cell_start, cell_end out
        "cell_table": ((4 + 8 + 12 + 12) * n + 24 * n + nc8, 0),
        # key, pos, cell_start, cell_end (+ ghosts) in; rho, pres out;
        # no contrib weight in the pair math
        "density": (16 * n + nc8 + gbytes + 8 * n,
                    OPS_TEST * cand + (OPS_DENSITY_NEAR - 1) * near_d),
        # key, pos, vel, rho, ranges (+ ghosts) in; npos, nvel, acc out
        "force_xsph": (32 * n + nc8 + gbytes + 36 * n,
                       2 * OPS_TEST * cand + OPS_FORCE_NEAR * near_f
                       + OPS_XSPH_NEAR * near_x),
    }
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
    errs = {"cell_table": 0.0, "density": err_rho,
            "force_xsph": max(err_pos, err_vel, err_acc)}
    return {name: {"max_abs_err": errs[name],
                   **report(config, name, *times[name], *work[name], n)}
            for name in times}


def phase_kernels_brute(dev, config):
    """The two all-pairs kernels against their plain versions at full
    ``config``, after one plain all-pairs substep."""
    import torch
    from sph_tpu_torch.app.microbench import time_ms
    from sph_tpu_torch.app import configs
    from sph_tpu_torch.neighbors.sweeps import make_pvec
    from sph_tpu_torch.physics import brute_force, constraints
    from sph_tpu_torch.physics import brute_kernels as BK
    from sph_tpu_torch.physics import common as C

    state, params, _ = configs.build(config, device=dev)
    state = constraints.apply_container(
        brute_force.substep(state, params, params.dt), params)
    pv = make_pvec(params, params.dt, (0, 0, 0))
    contrib = state.contrib_mask(params.ghost_face_active)
    cf = contrib.to(torch.float32)
    pos, vel, n = state.pos, state.vel, state.n

    raw_p = BK.density_raw_plain(pos, cf, pv)
    raw_k = BK.density_raw(pos, cf, pv)
    torch.cuda.synchronize()
    err_rho = check_close("brute_density rho_raw", raw_k, raw_p, RHO_RTOL,
                          RHO_ATOL)
    log(f"{config} brute_density: max|rho_raw err| {err_rho!r}, rho_raw "
        f"range [{float(raw_p.min())!r}, {float(raw_p.max())!r}]")

    rho, pres = C.finish_density(raw_p, state.ghost, contrib, state.density,
                                 state.pressure, params)
    fp = BK.force_plain(pos, vel, rho, pres, cf, pv)
    fk = BK.force(pos, vel, rho, pres, cf, pv)
    torch.cuda.synchronize()
    err_pos = check_close("brute_force npos", fk[0], fp[0], 0.0, POS_ATOL)
    err_vel = check_close("brute_force nvel", fk[1], fp[1], 0.0, VEL_ATOL)
    err_acc = check_close("brute_force acc", fk[2], fp[2], ACC_RTOL, ACC_ATOL)
    log(f"{config} brute_force: max abs err pos {err_pos!r} vel {err_vel!r} "
        f"acc {err_acc!r}")

    tested, near_d, near_f, near_x = brute_pairs(pos, fp[0], rho, cf, pv)
    log(f"{config} all pairs: {tested} pairs tested per pass, {near_d} "
        f"within h (density), {near_f} (force), {near_x} (XSPH)")
    work = {
        # pos, contrib in; rho_raw out
        "brute_density": (20 * n, OPS_TEST * tested
                          + OPS_DENSITY_NEAR * near_d),
        # pos, vel, rho, pres, contrib in; npos, nvel, acc out
        "brute_force": (36 * n + 36 * n, 2 * OPS_TEST * tested
                        + OPS_FORCE_NEAR * near_f + OPS_XSPH_NEAR * near_x),
    }
    times = {
        "brute_density": (
            time_ms(lambda: BK.density_raw(pos, cf, pv), 50),
            time_ms(lambda: BK.density_raw_plain(pos, cf, pv), 5)),
        "brute_force": (
            time_ms(lambda: BK.force(pos, vel, rho, pres, cf, pv), 50),
            time_ms(lambda: BK.force_plain(pos, vel, rho, pres, cf, pv), 5)),
    }
    errs = {"brute_density": err_rho,
            "brute_force": max(err_pos, err_vel, err_acc)}
    return {name: {"max_abs_err": errs[name],
                   **report(config, name, *times[name], *work[name], n)}
            for name in times}


def phase_emit(dev, config):
    """The emitted-row force kernel against its plain version at full
    ``config`` after the wave and one plain substep, timed beside
    ``force_xsph_kernel`` and ``torch.cat`` of its four outputs; then 16
    substeps with ``emit_rows`` and 16 without from one state, which must
    agree bit for bit."""
    import dataclasses

    import torch
    from sph_tpu_torch.app.microbench import time_ms
    from sph_tpu_torch.app import configs
    from sph_tpu_torch.engine.step import run_substeps
    from sph_tpu_torch.neighbors import cells, sweeps
    from sph_tpu_torch.physics import constraints

    state, params, cfg = configs.build(config, device=dev)
    state = configs.frame_prologue(config, params, FRAME_SUBSTEPS)(state)
    pv, ghosts = sweeps.prepare(state, params, params.dt, cfg)
    r = cells.build(state, params, cfg.grid_dims)
    rho, pres = sweeps.density_plain(r.key, r.state.pos, r.cell_start,
                                     r.cell_end, pv, ghosts)
    out = sweeps.force_xsph_plain(r.key, r.state.pos, r.state.vel, rho,
                                  r.cell_start, r.cell_end, pv, ghosts)
    state = constraints.apply_container(
        sweeps.reassemble(r.state, rho, pres, *out, params,
                          ghosts=ghosts is not None), params)

    r = cells.build(state, params, cfg.grid_dims)
    key, pos, vel, cs, ce = (r.key, r.state.pos, r.state.vel, r.cell_start,
                             r.cell_end)
    rho, _ = sweeps.density_plain(key, pos, cs, ce, pv, ghosts)
    args = (key, pos, vel, rho, cs, ce, pv, ghosts)
    want = sweeps.force_xsph_emit_plain(*args)
    got = sweeps.force_xsph_emit(*args)
    torch.cuda.synchronize()
    errs = [check_close("force_xsph_emit npos", got[:, 0:3], want[:, 0:3],
                        0.0, POS_ATOL),
            check_close("force_xsph_emit nvel", got[:, 3:6], want[:, 3:6],
                        0.0, VEL_ATOL),
            check_close("force_xsph_emit acc", got[:, 6:9], want[:, 6:9],
                        ACC_RTOL, ACC_ATOL)]
    if not torch.equal(got[:, 9:], want[:, 9:]):
        raise AssertionError("force_xsph_emit: rho or the zero columns "
                             "differ from the plain version")
    parts = sweeps.force_xsph(*args)
    if not torch.equal(got[:, :9], torch.cat(parts, 1)):
        raise AssertionError("force_xsph_emit: not bit-equal to "
                             "force_xsph_kernel")
    log(f"{config} force_xsph_emit: max abs err pos {errs[0]!r} vel "
        f"{errs[1]!r} acc {errs[2]!r}; bit-equal to force_xsph_kernel")

    n, nc8 = int(key.shape[0]), 8 * cfg.num_cells
    gbytes = 0 if ghosts is None else 12 * ghosts.count + nc8
    cand, _, near_f, near_x = cell_pairs(key, pos, want[:, 0:3], cs, ce, pv,
                                         ghosts)
    log(f"{config} cell sweeps: {cand} candidates tested by the fluid rows, "
        f"{near_f} within h (force), {near_x} (XSPH)")
    col = rho[:, None]
    times = (time_ms(lambda: sweeps.force_xsph_emit(*args), 50),
             time_ms(lambda: sweeps.force_xsph_emit_plain(*args), 5))
    lib_ms = time_ms(lambda: torch.cat([*parts, col], 1), 50)
    log(f"{config} force_xsph (gather transport) kernel: "
        f"{time_ms(lambda: sweeps.force_xsph(*args), 50)!r} ms")
    # key, pos, vel, rho, ranges (+ ghosts) in; per [n, 16] out
    rec = {"max_abs_err": max(errs), **report(
        config, "force_xsph_emit", *times, 32 * n + nc8 + gbytes + 64 * n,
        2 * OPS_TEST * cand + OPS_FORCE_NEAR * near_f
        + OPS_XSPH_NEAR * near_x, n, lib_ms)}

    runs = {}
    for emit in (True, False):
        reset_launches()
        runs[emit] = run_substeps(state, params, params.dt, FRAME_SUBSTEPS,
                                  dataclasses.replace(cfg, emit_rows=emit))
        torch.cuda.synchronize()
        got_n = launches()
        want_n = {"force_xsph_emit": FRAME_SUBSTEPS if emit else 0,
                  "force_xsph": 0 if emit else FRAME_SUBSTEPS}
        if {k: got_n[k] for k in want_n} != want_n:
            raise AssertionError(f"{config} emit_rows={emit}: launches "
                                 f"{got_n}, expected {want_n}")
    for f in ("pos", "vel", "acc", "density", "pressure", "foam", "orig_id"):
        if not torch.equal(getattr(runs[True], f), getattr(runs[False], f)):
            raise AssertionError(f"{config}: {f} after {FRAME_SUBSTEPS} "
                                 f"substeps differs between emit_rows and "
                                 f"the gather transport")
    log(f"{config}: {FRAME_SUBSTEPS} substeps with emit_rows bit-identical "
        f"to {FRAME_SUBSTEPS} without (pos, vel, acc, density, pressure, "
        f"foam, orig_id)")
    return {"force_xsph_emit": rec}


def phase_micro(dev):
    """The micro-kernels' entry points, with their launch counts, then
    each micro-kernel against its plain version at the scripts' default
    sizes, timed beside one library call that computes the same."""
    import numpy as np
    import torch
    from sph_tpu_torch.app.microbench import time_ms
    from sph_tpu_torch.app import microbench, proto_expand

    reset_launches()
    microbench.main([])
    res = proto_expand.main()
    counts = launches()
    # the smoke check's one launch; the expand's check and its timing
    # (one warm-up, microbench.REPS timed)
    expect = dict.fromkeys(counts, 0)
    expect.update(smoke=1, expand=2 + microbench.REPS)
    if counts != expect:
        raise AssertionError(f"micro: launches {counts}, expected {expect}")
    log(f"micro entry points: launches {counts}; expand {res}")

    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (256, 512)).astype(np.float32), device=dev)   # the script's shape
    nrow, s, maxr = proto_expand.sizes()
    starts, rows, _ = proto_expand.synth(nrow, s, maxr)
    st = torch.as_tensor(starts, device=dev)
    rw = torch.as_tensor(rows, device=dev)
    if not torch.equal(microbench.smoke(x), microbench.smoke_plain(x)):
        raise AssertionError("smoke: kernel is not bit-equal to the plain "
                             "version")
    want = proto_expand.expand_plain(st, rw, s)
    if not torch.equal(proto_expand.expand(st, rw, s), want):
        raise AssertionError("expand: kernel is not bit-equal to the plain "
                             "version")
    log(f"micro: smoke {tuple(x.shape)} and expand ({nrow} rows, S={s}) "
        f"bit-equal to their plain versions")

    # the library call for the expand: one index_put_ of the elements'
    # payload into a filled output, its indices made beforehand
    n, f = int(starts[-1]), proto_expand.F
    yy = torch.repeat_interleave(torch.arange(nrow, device=dev),
                                 (st[1:] - st[:-1]).long())[:, None]
    ff = torch.arange(f, device=dev)[None, :]
    tt = rw[:n, f].long()[:, None]
    vals = rw[:n, :f]
    filled = torch.full_like(want, -1.0)
    work = {
        # x in, o out; 4 multiplies and 4 adds per value
        "smoke": (8 * x.numel(), 8 * x.numel(), x.numel(), (
            time_ms(lambda: microbench.smoke(x), 50),
            time_ms(lambda: microbench.smoke_plain(x), 50),
            time_ms(lambda: x * 8.0, 50))),
        # starts and each element's payload and target in, out written;
        # the binary searches' compares as operations
        "expand": (4 * (nrow + 1) + 4 * (f + 1) * n + 4 * want.numel(),
                   nrow * s * (int(np.ceil(np.log2(maxr))) + 1), n, (
                       time_ms(lambda: proto_expand.expand(st, rw, s), 50),
                       time_ms(lambda: proto_expand.expand_plain(st, rw, s),
                               50),
                       time_ms(lambda: filled.index_put_((yy, ff, tt), vals),
                               50))),
    }
    measured = {}
    for name, (nbytes, ops, rows_, (k_ms, p_ms, lib_ms)) in work.items():
        measured[name] = {"max_abs_err": 0.0, **report(
            "micro", name, k_ms, p_ms, nbytes, ops, rows_, lib_ms)}
    return measured, counts


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
    """The cell engine and the all-pairs engine (kernels) vs the all-pairs
    oracle over 20 substeps: a 2k dam break, and a box inside a ghost
    shell.  The cell engine sorts, so its rows are realigned by orig_id;
    the all-pairs engine keeps rows in place."""
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
                for impl in ("brute", "cell", "brute_kernel")}
        ref = outs["brute"]
        v = ref.fluid_mask()
        for impl in ("cell", "brute_kernel"):
            got = outs[impl]
            order = (torch.argsort(got.orig_id) if impl == "cell"
                     else torch.arange(got.n, device=dev))
            errs = {f: max_err(getattr(got, f)[order][v], getattr(ref, f)[v])
                    for f in ("pos", "vel", "density")}
            log(f"{name}, {impl} kernels vs oracle over 20 substeps: {errs}")
            for f, lim in (("pos", 1e-4), ("vel", 1e-3), ("density", 1.0)):
                if not errs[f] < lim:
                    raise AssertionError(f"{name} {impl} {f} err {errs[f]} "
                                         f">= {lim}")
            check_ghosts(f"{name} {impl}", state, got,
                         float(params.rest_density))


def phase_main(dev, config):
    """The port's main path: configs.build with no device (the card is
    the default), then frames of frame_prologue + run_substeps at
    ``config``."""
    import dataclasses

    import torch
    from sph_tpu_torch.app import configs
    from sph_tpu_torch.core.params import rotation_matrix
    from sph_tpu_torch.engine.step import run_substeps

    start, params, cfg = configs.build(config)
    if start.pos.device != dev or params.h.device != dev:
        raise AssertionError(f"{config}: configs.build put the state on "
                             f"{start.pos.device}, not on {dev}")
    if config in EMIT_ROWS:
        cfg = dataclasses.replace(cfg, emit_rows=True)
    prologue = configs.frame_prologue(config, params, FRAME_SUBSTEPS)
    state = start
    n_fluid = int(state.fluid_mask().sum())
    n_ghost = int((state.ghost > 0).sum())
    dt = params.dt
    torch.cuda.synchronize()

    reset_launches()
    for frame in range(FRAMES):
        if frame == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state = run_substeps(prologue(state), params, dt, FRAME_SUBSTEPS,
                             cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()

    total = FRAMES * FRAME_SUBSTEPS
    timed = total - FRAME_SUBSTEPS
    expect = dict.fromkeys(counts, 0)
    if cfg.neighbor_impl == "cell":
        # the ghost structure is one more cell table per run_substeps call
        expect.update({"density": total, "cell_table": total + (
            FRAMES if n_ghost else 0),
            "force_xsph_emit" if cfg.emit_rows else "force_xsph": total})
    else:
        expect.update(brute_density=total, brute_force=total)
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
        f"{FRAMES} frames of {FRAME_SUBSTEPS} substeps (emit_rows "
        f"{cfg.emit_rows}), launches {counts}; density range "
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

    ms = wall / timed * 1e3
    rate = n_fluid * timed / wall
    log(f"main path {config}: {ms!r} ms/substep, {rate!r} particle-steps/s "
        f"(host clock over {timed} substeps and their frames' prologues, "
        f"after a frame of warm-up) on {card_line()}")
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

    t_start = t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0!r} s")

    measured = {"default_131k": phase_kernels(dev, "default_131k"),
                "ghost_1m": phase_kernels(dev, "ghost_1m"),
                "dam_break_8k": phase_kernels_brute(dev, "dam_break_8k"),
                "rotated_512k": phase_emit(dev, "rotated_512k")}
    phase_small(dev)
    counts = {config: phase_main(dev, config) for config in CONFIGS}
    measured["micro"], counts["micro"] = phase_micro(dev)

    # each kernel's errors, times and bound at the configuration named in
    # KERNELS, and its launches in that configuration's main path (or, for
    # the micro-kernels, in their entry points' run)
    record = {"kernels": [
        {"name": f"{name}_kernel", "route": "cuda", "source": source,
         "replaces": replaces, "config": config,
         "launches": counts[config][name], **measured[config][name]}
        for name, (source, replaces, config) in KERNELS.items()]}
    log(f"all phases passed in {time.perf_counter() - t_start!r} s, the "
        f"build included")
    print(json.dumps(record), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
