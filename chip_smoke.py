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
             (fluid, with and without the state's ten other columns, and
             ghosts at ``ghost_1m``), timed alone, with those columns as the
             substep launches it, and beside the table alone plus ten torch
             gathers; the sweeps with ghost sources at ``ghost_1m``; on the
             full ``dam_break_8k`` state (after one plain all-pairs
             substep), the two all-pairs kernels; each timed with CUDA events beside its plain
             version, with its bound (the least time the card could take
             for the same work) and the share of it that it reaches; a
             second launch of each force kernel and of the all-pairs
             density kernel must be bit-equal to the first; the density
             kernel's source records bit-equal to the plain packing; then
             the density kernel and both cell-engine force kernels on a
             state with 2,400 rows in one cell, against the plain versions;
3a. dense — the force kernel on later states of the benchmark's three
             configurations (``DENSE_FRAMES`` frames of each main path:
             ``rotated_512k`` after 20, 60 and 100, its piled-up corner):
             ``nvcc -Xptxas -v``'s registers and spills of both force
             kernels; the kernel's tile-path counter equal to
             ``sweeps.tile_warp_count``, and the other warps by
             ``sweeps.queue_warp_reasons``; its outputs with the counter, a
             second launch and the emit variant bit-equal; timed with CUDA
             events beside its bound.  ``python3 chip_smoke.py dense
             --against <root>`` runs this phase alone, with the force kernel
             of another checkout at ``<root>`` (built by its own
             ``native/build.py``) on the same inputs: its outputs bit-equal
             or the largest differences within the tolerances, its tile
             share where it counts one, and both kernels timed in turns;
             ``--states <dir>`` saves the states there, or reads them where
             saved;
3b. container — on the full ``default_131k`` and ``ghost_1m`` states
             (sorted rows and the sweep kernels' outputs after one plain
             substep), the container pass (``csrc/container.cu``) in each
             of its three modes, reassembly and container in one launch
             (the cell engine's substep), reassembly alone (the slab
             engine's) and the container alone (the other engines'),
             bit-identical to the plain torch ops on the card (a box at
             zero angles), each timed with CUDA events over 50 launches
             beside the plain ops and its bound;
4. emit    — on the full ``rotated_512k`` state (after the wave and one
             plain substep), the cell table bit-equal as above, then the
             emitted-row force kernel against its plain version, timed
             likewise, then 16 substeps with ``emit_rows`` and 16 without
             from one state, bit-identical;
4b. 4M     — the three cell-engine kernels as in phase 3 on the full
             ``export_4m`` state (4,000,000 rows, 208^3 cells), their plain
             versions timed over one run;
5. small   — the cell engine (kernels) and the all-pairs engine (kernels)
             against the all-pairs oracle over 20 substeps of a 2k dam
             break and of a 512-particle box inside a ghost shell (the
             cell engine realigned by ``orig_id``, the all-pairs engine in
             place); then the cell engine against the oracle over 20
             substeps of a 2k spawn in each of the ten container shapes,
             after which no fluid row is outside its container;
6. main    — ``configs.build`` with no device (the card is the default)
             then 4 frames of ``run_substeps(frame_prologue(state), ...,
             16)`` for ``default_131k``, ``ghost_1m``, ``dam_break_8k``,
             ``rotated_512k`` (the wave before every frame, the emitted-row
             transport) and ``export_4m``: the first frame warms up, the
             other 48 substeps are timed, with every kernel's launch count,
             the physical invariants, the ghosts' invariants and the fluid
             density against the JAX reference checked (``export_4m`` has
             no JAX reference: ROADMAP R10), and the peak device memory;
             on ``dam_break_8k``'s final state the all-pairs density kernel
             is held to its plain version, a second launch bit-equal, and
             timed again beside its count of pairs within h and its bound;
             the substep of the configuration's engine (cell or all-pairs
             kernels) after ``neighbor_aux`` twice under torch's
             synchronisation check (no device-to-host wait).  The frames
             run through ``run_substeps``, so the main path is the captured
             program (``engine/graph.py``) and its launch counts those
             that the replays add;
6a. graph  — on each main path's final state: 2 frames through
             ``run_substeps_eager`` and 2 through the graph from that state,
             every field bit-identical by orig_id; a replayed frame
             (the prologue and ``run_captured``, after ``neighbor_aux``)
             under the synchronisation check in its error mode; then eager
             and graph frames in turns, ms/substep by CUDA events and on
             the host clock.  The same after each scene path (6c), by
             ``Scene.update`` on copies of the scene, with gravity spin off
             and on (the reaction tips gravity every frame), and one graph
             frame's synchronising calls by source line (none may come once
             a substep);
6b. export — the frame export of ``app.bench.export_frames`` on the final
             ``export_4m`` state: four PNGs read back and drawn on, the
             frames composed on the card equal to the host path's, two
             ``launches.splat`` a render, the splat kernels' device time
             against their bound (the kernels' record), the colors on the
             card equal to the port's colors of the same state on the CPU,
             and the host rasterizer against its plain version on a
             subsample;
6c. scene  — the scene's main paths (``app/scene_paths.py``: the river
             at 65,536 asked rows, art preset 10's torus vortex and the
             fountain at 50,000): the port's Scene built with no device
             argument, then 4 frames of its Scene.update (continuous wave,
             the audio reaction to
             ``cmd_run --audio``'s bands, the jet speed, 16 substeps), with
             the cell engine's launch counts, the invariants (the container
             or, for the river, the box and the sink), the rows the
             emitters respawned, the density against the JAX reference, the
             peak device memory, and the stages after the solve run twice
             under torch's synchronisation check (no device-to-host wait);
6d. impulses — on the fountain's final state, the vortex, attractor, curl
             flow and stencil impulses on the card against the CPU, each
             timed;
6e. reel   — ``app.main.main(["reel", "--track", <wav>, "--out", <dir>])``
             with no device argument, on the default scene (50,000 asked
             rows, SSFR water and the outline, 1080x1920, 30 fps, the
             substeps uncapped: 33 or 34 a frame) over a track written
             here with numpy (8 frames at 48 kHz, a bass tone with one hit
             and a treble tone): 8 PNGs read back at 1080x1920 and not
             uniform, the mux script, the cell engine's launch counts, the
             final state inside its container, the three cell kernels
             against their plain versions on it, the last frame rendered
             again on the CPU from the same state (at most 1e-4 of its
             pixels more than 1/255 apart, those pixels traced to the
             water's pass where card and CPU part), the peak device
             memory, and each frame's seconds split four ways (update by
             CUDA events; the host splat; the device smoothing,
             background and composite; the PNG);
6f. looks  — on the reel's final state at 1080x1920: render mode 1 with
             the outline and every post effect (bloom, streaks, trails,
             kaleidoscope, chromatic aberration, vignette, grain, DOF from
             its depth), render mode 2 (the instanced icosphere meshes
             through the host triangle rasterizer) and a river scene's
             terrain pass, each card frame held to the CPU frame of the same
             state as the reel's is, and timed; then the synchronising CUDA
             calls of one more reel frame (update, render, PNG), counted by
             source line (none of the update's may come once a substep);
6g. gallery — ``app.gallery.main([<dir>])`` with no device argument: the
             doc gallery's five looks at their own size (3,000 asked rows,
             2,000 for the river; 30, 30, 30, 40 and 45 frames of 1/60 s;
             engine ``binned``, which is the cell engine), five 480x270
             PNGs read back and not uniform, #1-#3 launched once for each
             substep of each look's settle, at most one capture for each
             substep count, every fluid row finite and inside its container
             (the torus; the river's box and sink), each still against the
             CPU frame of its look's final state as the reel's last frame
             is (the water look traced by pass where they part), and each
             look's seconds (settle by CUDA events, render and PNG on the
             host clock);
7. micro   — ``app.microbench.main`` and ``app.proto_expand.main`` (the
             entry points of the micro-kernels) with their launch counts,
             the launch floor (a one-element torch op timed likewise),
             then each micro-kernel bit-equal to its plain version (and
             the expand to the script's oracle) at the scripts' default
             sizes and at a second size where bytes bind (the smoke at
             [65,536, 512], the expand at 1,024 rows, past L2), each
             timed likewise beside one library call;
8. parallel — the multi-rank engines (``sph_tpu_torch/parallel``) at full
             width: (a) after a warm-up frame of ``ghost_1m``, a frame of
             16 substeps of the slab engine on one NCCL rank in this
             process against the cell engine's frame from the same state
             (bit-identical expected, the ROADMAP tolerances held), its
             launches of #1-#3, ms/substep of both by CUDA events and the
             host waits a substep; then one launch of four gloo rank
             processes sharing the card (``parallel.group.launch`` of
             ``parallel/run.py``): (b) ``ghost_1m`` over four slabs, within
             pos 1e-4, vel 1e-3, density 1.0 of one device after 5
             substeps, rows kept, ghosts unmoved and the fluid density's max
             and mean within 2% after 16; (c) ``fountain_50k`` through the
             router, within those tolerances after 2 substeps, rows kept
             and the respawns counted as on one device after 2 and 16;
             (d) the gather engine at ``dam_break_8k`` (8,192 rows), 5
             substeps, within pos 1e-5, density 0.1 of the oracle.  Each
             rank logs its rows, launches, ms/substep and host waits.

Each phase logs its seconds.

The last lines are the kernels' JSON record (each kernel with the
configuration or path whose launches and times it reports, and its
launches in the reel under ``reel_launches`` and in the gallery under
``gallery_launches``, and #1-#3 their launches
in phase ``parallel`` under ``parallel_launches``: on the one rank of (a)
and on each rank of (b);
``cell_table_kernel`` with the times and the bound of the launch the substep
makes, the state's ten other columns carried, and the table alone and the
ghosts' table, launched once per ``run_substeps``, under keys of their own;
the micro-kernels with their second size under ``second``;
``splat_kernel``, the three kernels of ``csrc/splat.cu`` together, with
its launches in phase ``export`` and ``launches_per_render``; a kernel
faster than its bound, at either size, fails the run), the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
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
# The scene paths (app/scene_paths.py): sph_tpu with the frames of its
# Scene.update, printed by ``PYTHONPATH=. python tests/test_torch_modes.py
# <path> 4 <capacity> [engine]`` (ROADMAP R12): torus_vortex_50k binned at
# capacity 16 (fullest cell 8), fountain_50k binned at capacity 32 (fullest
# cell 17), river_65k brute (its start piles up to 693 rows in a cell).  The
# river's fluid density max after 64 substeps is set by rounding: the
# terrain lifts the spawn's lower layers into one sheet, and three exact
# engines on one card end 13,251 to 15,069 apart.  So its max is held after
# the first frame (REF_RHO_FIRST_FRAME, where those engines agree to 0.02%
# and JAX to 0.3%) and only its mean after 64 substeps (they agree to
# 0.3%).
REF_RHO = {
    "default_131k": (6426.8286, 1848.3309),
    "ghost_1m": (6451.4487, 1522.0352),
    "dam_break_8k": (4864.46240234375, 1669.9207237884402),
    "rotated_512k": (5185.92529296875, 1413.0148309509968),
    "river_65k": (None, 3299.1475426587976),
    "torus_vortex_50k": (2640.1220703125, 1427.916746054529),
    "fountain_50k": (11545.8779296875, 2194.841480440674),
}
# (max, mean) after the first frame (16 substeps)
REF_RHO_FIRST_FRAME = {"river_65k": (60291.6796875, 12595.702343231997)}
# the bench configurations' main paths, in the order they are driven; a
# JAX density reference at export_4m is out of reach (ROADMAP R10), so it
# has no REF_RHO entry
CONFIGS = ("default_131k", "ghost_1m", "dam_break_8k", "rotated_512k",
           "export_4m")
# main paths that take the emitted-row transport (SimConfig.emit_rows),
# as ``SPH_EMIT_ROWS=1 python bench.py rotated_512k`` does in the JAX package
EMIT_ROWS = ("rotated_512k",)

# the ten container shapes of phase "shapes": each with the half extents
# of its art preset, (7, 7, 7) for the shapes that no preset uses
SHAPE_HALVES = {0: (7.0, 7.0, 7.0), 1: (7.0, 7.0, 7.0), 2: (6.0, 5.0, 6.0),
                3: (7.0, 2.2, 0.0), 4: (4.0, 5.0, 0.0), 5: (6.0, 7.0, 1.4),
                6: (5.5, 7.5, 0.0), 7: (7.0, 7.0, 7.0), 8: (7.0, 7.0, 7.0),
                9: (7.0, 7.0, 7.0)}
STENCIL_TARGETS = 4096       # Scene.STENCIL_CAPACITY
IMPULSE_ATOL = 1e-5          # card against CPU, as the export's colors

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
    "container": ("sph_tpu_torch/csrc/container.cu",
                  "none: the torch ops of sweeps.reassemble_plain and "
                  "constraints.apply_container_plain", "ghost_1m"),
    "smoke": ("sph_tpu_torch/csrc/micro.cu", "scripts/microbench.py:44",
              "micro"),
    "expand": ("sph_tpu_torch/csrc/micro.cu",
               "scripts/proto_bfly_kernel.py:42", "micro"),
    "splat": ("sph_tpu_torch/csrc/splat.cu",
              "none: the JAX package composes its frames on the host "
              "(sph_tpu/viz/splat.py, native/splat_raster.cpp)", "export_4m"),
}

# The card's peaks for the bounds (NVIDIA H100 SXM data sheet, at 700 W):
# float32 outside the tensor cores, and HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float32 operations per pair, counted from the kernels' source
# (csrc/sweeps.cu, csrc/brute.cu; an FFMA is two): the distance test that
# every tested pair pays, from the differences in the cell kernels and the
# all-pairs force kernel (3 sub, 3 mul, 2 add, 1 compare), and in the
# expanded form, |p_j|^2 - 2 p_i.p_j against the row's limit, in the
# all-pairs density kernel (3 FFMA, 1 add); and the pair math of a pair
# within h (density: h2 - r2, d*d*d, the contrib weight, the add;
# force: rsqrt, r, the r < h test, m/rho, the spiky and viscosity terms
# and the three accumulators; XSPH: poly6, m/rho, the sum and the norm).
OPS_TEST = 9
OPS_TEST_EXPANDED = 7
OPS_DENSITY_NEAR = 5
OPS_FORCE_NEAR = 41
OPS_XSPH_NEAR = 17
# expand_kernel (csrc/micro.cu) moves floats and does no float32
# arithmetic: each block of kExpandChunk = 2048 slots of a row tests every
# element of that row, 2 operations a test (the conversion of its target,
# one range compare), so each element is tested once a chunk of its row
EXPAND_CHUNK = 2048


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


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
    if k_ms < b_ms:
        # possible only where the inputs stay in L2 between the timed
        # launches (the byte bound is HBM's), or the count is wrong: main()
        # refuses it in the kernels' record
        log(f"{config} {name}: FASTER THAN ITS BOUND ({k_ms!r} < {b_ms!r} ms)")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms}


def check_repeat(name, first, fn) -> None:
    """A second launch on the same inputs must be bit-equal to ``first``
    (fixed summation order, no atomics)."""
    import torch
    again = fn()
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: two launches on the same inputs "
                                 f"differ")


def check_table(name, got, want) -> None:
    import torch
    for f, a, b in zip(got._fields, got, want):
        if f == "carried":
            same = len(a) == len(b) and all(
                x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
        else:
            same = (a is None) == (b is None) and (a is None
                                                   or torch.equal(a, b))
        if not same:
            raise AssertionError(f"cell_table {name} {f}: kernel is not "
                                 f"bit-equal to the plain version")


def carried_columns(state):
    """The state's columns other than pos and vel, which ``cells.build``
    has the cell table move: their names and tensors."""
    import dataclasses
    names = [f.name for f in dataclasses.fields(state)
             if f.name not in ("pos", "vel")]
    return names, [getattr(state, f) for f in names]


def check_cell_tables(config, state, params, cfg, ghosts):
    """The cell table at full ``config``, bit-equal to its plain version:
    the fluid's alone and with the state's other columns, as
    ``cells.build`` launches it, and the ghosts' (pos only); then
    ``cells.build`` itself, which must make one launch.  Returns the
    fluid's (skey, order), the carried columns and the built rows."""
    import torch
    from sph_tpu_torch.neighbors import cells
    from sph_tpu_torch.utils import trace

    dims, nc = cfg.grid_dims, cfg.num_cells
    fluid = cells.fluid_sort(state, params, dims)
    names, carry = carried_columns(state)
    tables = {"fluid": (fluid, state.vel, ()),
              "fluid with the carried columns": (fluid, state.vel, carry)}
    if ghosts is not None:
        tables["ghosts"] = (cells.ghost_sort(state, params, dims), None, ())
    for which, ((skey, order), vel, cols) in tables.items():
        got = cells.cell_table(skey, order, state.pos, vel, nc, cols)
        want = cells.cell_table_plain(skey, order, state.pos, vel, nc, cols)
        torch.cuda.synchronize()
        check_table(which, got, want)
        log(f"{config} cell_table {which}: bit-equal ({int(skey.shape[0])} "
            f"rows, {nc} cells, {int((want.cell_end > want.cell_start).sum())}"
            f" occupied, {len(cols)} carried columns)")
    since = trace.launches()
    r = cells.build(state, params, dims)
    if trace.launches(since).get("cell_table", 0) != 1:
        raise AssertionError(f"{config}: cells.build made launches "
                             f"{trace.launches(since)}")
    for f, col in zip(names, carry):
        if not torch.equal(getattr(r.state, f), col[fluid[1]]):
            raise AssertionError(f"{config}: cells.build's {f} is not the "
                                 f"gathered column")
    return fluid, carry, r


def check_cell_kernels(config, state, params, cfg, pv, ghosts):
    """The three cell kernels against their plain versions on ``state``,
    as a substep with sweep params ``pv`` launches them: the cell table
    bit-equal (``check_cell_tables``), the density within RHO_RTOL /
    RHO_ATOL with its source records bit-equal to the plain packing, the
    force sweep within POS_ATOL, VEL_ATOL and ACC_RTOL / ACC_ATOL and a
    relaunch bit-equal.  Returns (fluid (skey, order), carried columns,
    built rows, plain rho, plain source records, plain force outputs,
    max abs errors by kernel)."""
    import torch
    from sph_tpu_torch.neighbors import cells, sweeps

    nc = cfg.num_cells
    fluid, carry, r = check_cell_tables(config, state, params, cfg, ghosts)

    key, pos, vel, cs, ce = (r.key, r.state.pos, r.state.vel, r.cell_start,
                             r.cell_end)
    rho_p, pres_p = sweeps.density_plain(key, pos, cs, ce, pv, ghosts)
    # as the substep launches it: with the force sweep's source records
    rho_k, pres_k, src_k = sweeps.density_sources(key, pos, vel, cs, ce, pv,
                                                  ghosts)
    torch.cuda.synchronize()
    err_rho = check_close("density rho", rho_k, rho_p, RHO_RTOL, RHO_ATOL)
    err_pres = max_err(pres_k, pres_p)
    if not torch.equal(src_k, sweeps.pack_sources(pos, vel, rho_k, pv,
                                                  ghosts)):
        raise AssertionError(f"{config} density: the source records are not "
                             f"bit-equal to the plain packing")
    for a, b in zip(sweeps.density(key, pos, cs, ce, pv, ghosts),
                    (rho_k, pres_k)):
        if not torch.equal(a, b):
            raise AssertionError(f"{config} density: rho or pres differs "
                                 f"with and without the source records")
    log(f"{config} density: max|rho err| {err_rho!r}  max|pres err| "
        f"{err_pres!r}  rho range [{float(rho_p[rho_p > 0].min())!r}, "
        f"{float(rho_p.max())!r}]; source records bit-equal to the plain "
        f"packing")

    # the force kernel is timed on finished source records, as the substep
    # hands them over; its launches below all read src_p
    src_p = sweeps.pack_sources(pos, vel, rho_p, pv, ghosts)
    fp = sweeps.force_xsph_plain(key, pos, vel, rho_p, cs, ce, pv, ghosts)
    fk = sweeps.force_xsph(key, pos, vel, rho_p, cs, ce, pv, ghosts, src_p)
    torch.cuda.synchronize()
    err_pos = check_close("force_xsph npos", fk[0], fp[0], 0.0, POS_ATOL)
    err_vel = check_close("force_xsph nvel", fk[1], fp[1], 0.0, VEL_ATOL)
    err_acc = check_close("force_xsph acc", fk[2], fp[2], ACC_RTOL, ACC_ATOL)
    check_repeat(f"{config} force_xsph", fk, lambda: sweeps.force_xsph(
        key, pos, vel, rho_p, cs, ce, pv, ghosts, src_p))
    # rows that the forces moved further from pos + v dt damping than the
    # kernel's queue margin allows (0.9 of it): their warps walk twice
    off = torch.linalg.norm(
        fp[0] - (pos + vel * (pv.dt * 0.995)), dim=1)[key < nc]
    far = int((off > 0.9 * sweeps.FORCE_MARGIN * pv.h).sum())
    log(f"{config} force_xsph: max abs err pos {err_pos!r} vel {err_vel!r} "
        f"acc {err_acc!r}; a second launch is bit-equal; {far} of "
        f"{int(off.shape[0])} fluid rows beyond the queue's margin")
    errs = {"cell_table": 0.0, "density": err_rho,
            "force_xsph": max(err_pos, err_vel, err_acc)}
    return fluid, carry, r, rho_p, src_p, fp, errs


def phase_kernels(dev, config, plain_reps=5):
    """Each kernel against its plain version at full ``config``; the plain
    sweeps (row chunks, seconds a run at 4M) timed over ``plain_reps``
    runs."""
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

    fluid, carry, r, rho_p, src_p, fp, errs = check_cell_kernels(
        config, state, params, cfg, pv, ghosts)
    key, pos, vel, cs, ce = (r.key, r.state.pos, r.state.vel, r.cell_start,
                             r.cell_end)
    skey, order = fluid
    n, nc8 = int(key.shape[0]), 8 * nc
    # the table writes its ranges once: cell_end[c] is cell_start[c + 1]
    ranges = 4 * (nc + 1)
    gbytes = 0 if ghosts is None else 12 * ghosts.count + nc8
    cand, near_d, near_f, near_x = cell_pairs(key, pos, fp[0], cs, ce, pv,
                                              ghosts)
    log(f"{config} cell sweeps: {cand} candidates tested by the fluid rows, "
        f"{near_d} within h (density), {near_f} (force), {near_x} (XSPH)")
    # bytes: each input read once, each output written once
    work = {
        # as the substep launches it, with the state's ten other columns:
        # skey, order and every column in (4 + 8 + 12 * 3 + 4 * 9 bytes a
        # row), the sorted columns (72 a row) and the ranges out
        "cell_table": ((4 + 8 + 72) * n + 72 * n + ranges, 0),
        # key, pos, cell_start, cell_end (+ ghosts) in; rho, pres out;
        # no contrib weight in the pair math.  The source records that the
        # kernel also writes (vel in, 32 bytes a row out) are the port's own
        # layout between its two sweeps and count for nothing here.
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
                                             state.vel, nc, carry), 50),
            time_ms(lambda: cells.cell_table_plain(skey, order, state.pos,
                                                   state.vel, nc, carry), 50)),
        "density": (
            time_ms(lambda: sweeps.density_sources(key, pos, vel, cs, ce, pv,
                                                   ghosts), 50),
            time_ms(lambda: sweeps.density_plain(key, pos, cs, ce, pv,
                                                 ghosts), plain_reps)),
        "force_xsph": (
            time_ms(lambda: sweeps.force_xsph(key, pos, vel, rho_p, cs, ce,
                                              pv, ghosts, src_p), 50),
            time_ms(lambda: sweeps.force_xsph_plain(key, pos, vel, rho_p, cs,
                                                    ce, pv, ghosts),
                    plain_reps)),
    }
    log(f"{config} density without the source records: "
        f"{time_ms(lambda: sweeps.density(key, pos, cs, ce, pv, ghosts), 50)!r}"
        f" ms")
    # the table alone (skey, order, pos, vel in; spos, svel and the ranges
    # out), the kernel's work before it carried the other columns, beside
    # its plain version and beside that shape with the columns moved by ten
    # torch gathers; and the ghosts' table (pos only), which the main path
    # launches once per run_substeps
    t_ms = time_ms(lambda: cells.cell_table(skey, order, state.pos, state.vel,
                                            nc), 50)
    t_plain = time_ms(lambda: cells.cell_table_plain(
        skey, order, state.pos, state.vel, nc), 50)
    t_gathers = time_ms(lambda: (cells.cell_table(
        skey, order, state.pos, state.vel, nc), [c[order] for c in carry]), 50)
    t_bound, _ = bound((4 + 8 + 24) * n + 24 * n + ranges, 0)
    log(f"{config} cell_table alone (pos, vel and the ranges): kernel "
        f"{t_ms!r} ms, plain {t_plain!r} ms, with {len(carry)} torch gathers "
        f"for the other columns {t_gathers!r} ms; bound {t_bound!r} ms by "
        f"bytes, share of bound reached {t_bound / t_ms!r}")
    alone = {"table_ms": t_ms, "table_plain_ms": t_plain,
             "table_bound_ms": t_bound, "table_and_gathers_ms": t_gathers}
    if ghosts is not None:
        gkey, gorder = cells.ghost_sort(state, params, dims)
        alone["ghost_table_ms"] = time_ms(lambda: cells.cell_table(
            gkey, gorder, state.pos, None, nc), 50)
        log(f"{config} cell_table of the {int(gkey.shape[0])} ghosts (pos "
            f"only): kernel {alone['ghost_table_ms']!r} ms")
    out = {name: {"max_abs_err": errs[name],
                  **report(config, name, *times[name], *work[name], n)}
           for name in times}
    out["cell_table"].update(alone)
    return out


CONTAINER_REPS = 50


def same_fields(label, got, want) -> None:
    """Every field of two states bit-identical, or raise."""
    import dataclasses

    import torch
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if not torch.equal(a, b):
            raise AssertionError(
                f"{label}: {f.name} is not bit-identical to the plain torch "
                f"ops ({int((a != b).sum())} elements differ, max abs "
                f"{max_err(a.float(), b.float())!r})")


def phase_container(dev, config):
    """The container pass at full ``config`` in its three modes, on the
    sorted rows and the sweep kernels' outputs after one plain substep:
    each bit-identical to the plain torch ops on the same tensors (the
    configurations' box has zero Euler angles, so its rotation is exactly
    the identity), and the cell engine's mode on those positions pushed out
    of the box too; each mode timed over CONTAINER_REPS launches beside the
    plain ops.  Returns the record of the mode the cell engine's substep
    launches (reassembly and container), the other two under ``modes``."""
    import torch
    from sph_tpu_torch.app import configs
    from sph_tpu_torch.app.microbench import time_ms
    from sph_tpu_torch.neighbors import cells, sweeps
    from sph_tpu_torch.physics import constraints
    from sph_tpu_torch.utils import trace

    state, params, cfg = configs.build(config, device=dev)
    if bool(params.box_euler_deg.any()) or params.shape_type != 0:
        raise AssertionError(f"{config}: not a box at zero Euler angles")
    pv, ghosts = sweeps.prepare(state, params, params.dt, cfg)
    r = cells.build(state, params, cfg.grid_dims)
    rho, pres, _ = sweeps.density_sources(r.key, r.state.pos, r.state.vel,
                                          r.cell_start, r.cell_end, pv,
                                          ghosts)
    npos, nvel, acc = sweeps.force_xsph(r.key, r.state.pos, r.state.vel, rho,
                                        r.cell_start, r.cell_end, pv, ghosts)
    s, g = r.state, ghosts is not None
    # one substep moves no row out of the box, so the walls' branch is held
    # bit for bit on the sweeps' positions pushed 5% out from the center too
    pushed = params.box_center + (npos - params.box_center) * 1.05
    sweep = (rho, pres, pushed, nvel, acc)
    got = sweeps.reassemble(s, *sweep, params, ghosts=g, contain=True)
    want = constraints.apply_container_plain(
        sweeps.reassemble_plain(s, *sweep, params, g), params)
    torch.cuda.synchronize()
    same_fields(f"{config} container, positions pushed out", got, want)
    log(f"{config} container on the positions pushed 5% out: bit-identical "
        f"to the plain torch ops, {int((want.pos != pushed).any(-1).sum())} "
        f"rows moved by the container")
    sweep = (rho, pres, npos, nvel, acc)
    solved = sweeps.reassemble_plain(s, *sweep, params, g)
    torch.cuda.synchronize()
    n = s.n
    n_ghost = int((s.ghost > 0).sum())
    off = int(((s.ghost > 0) & ~s.contrib_mask(params.ghost_face_active))
              .sum())
    # bytes a launch: each column read once and each written once; ghost,
    # valid (4 + 4), and in reassembly nvel, rho, foam (20) for every row,
    # face for each ghost row and the old vel, acc, density, pressure (32)
    # for each ghost on an inactive face
    ghost_in = (16 * n + 4 * n_ghost + 32 * off) if g else 0
    modes = {
        "both": (lambda: sweeps.reassemble(s, *sweep, params, ghosts=g,
                                           contain=True),
                 lambda: constraints.apply_container_plain(
                     sweeps.reassemble_plain(s, *sweep, params, g), params),
                 # + npos in; pos, vel, foam out (+ acc, density, pressure)
                 (8 + 20 + 12) * n + ghost_in + 28 * n + (20 * n if g else 0)),
        "reassemble": (lambda: sweeps.reassemble(s, *sweep, params, ghosts=g),
                       lambda: sweeps.reassemble_plain(s, *sweep, params, g),
                       # foam out (+ vel, acc, density, pressure)
                       (8 + 20) * n + ghost_in + 4 * n
                       + (32 * n if g else 0)),
        "contain": (lambda: constraints.apply_container(solved, params),
                    lambda: constraints.apply_container_plain(solved,
                                                              params),
                    # pos, vel in and out
                    (8 + 24) * n + 24 * n),
    }
    out = {}
    for mode, (kernel, plain, nbytes) in modes.items():
        since = trace.launches()
        got = kernel()
        torch.cuda.synchronize()
        if trace.launches(since).get("container", 0) != 1:
            raise AssertionError(f"{config} container {mode}: launches "
                                 f"{trace.launches(since)}")
        same_fields(f"{config} container {mode}", got, plain())
        moved = 0 if mode == "reassemble" else int(
            (got.pos != solved.pos).any(-1).sum())
        log(f"{config} container {mode}: bit-identical to the plain torch "
            f"ops ({n} rows, {n_ghost} ghosts, {off} on inactive faces; "
            f"{moved} rows moved by the container)")
        out[mode] = report(config, f"container ({mode})",
                           time_ms(kernel, CONTAINER_REPS),
                           time_ms(plain, CONTAINER_REPS), nbytes, 0, n)
    return {"max_abs_err": 0.0, **out.pop("both"), "modes": out}


CROWD_ROWS = 2400            # rows in the one crowded cell


def phase_crowded(dev):
    """The density kernel and both cell-engine force kernels on a state
    with ``CROWD_ROWS`` rows in one cell of an 8 x 8 x 8 grid (2 rows in
    every cell of its lower three layers, the x edges included): far more
    than the force kernel's 32-entry queue holds, so its warps empty their
    queues many times on the way and walk twice; the port has no cell
    capacity to fall back on.  Each is held against its plain version; the
    force kernels' input density is made from a seed, within 1% of rest, so
    that the forces stay of the size the tolerances were set for."""
    import numpy as np
    import torch
    from sph_tpu_torch.core import state as S
    from sph_tpu_torch.core.params import (FluidParams, SimConfig,
                                           compute_grid_dims)
    from sph_tpu_torch.neighbors import cells, sweeps

    h, half = 0.4, (1.2, 1.2, 1.2)
    rng = np.random.default_rng(13)
    idx = np.asarray([(x, y, z) for y in range(3) for z in range(8)
                      for x in range(8)], np.float32).repeat(2, axis=0)
    idx = np.concatenate([idx, np.tile(np.asarray([[4, 1, 4]], np.float32),
                                       (CROWD_ROWS, 1))])
    gmin = -(np.asarray(half, np.float32) + np.float32(h))
    pos = (gmin + (idx + 0.05 + 0.9 * rng.random(idx.shape)) * h).astype(
        np.float32)
    n = pos.shape[0]
    spawn = S.SpawnResult(
        pos=pos, vel=(0.1 * rng.standard_normal((n, 3))).astype(np.float32),
        ghost=np.zeros((n,), np.int32), face=np.full((n,), -1, np.int32),
        color_group=np.zeros((n,), np.int32), count=n)
    state = S.state_from_spawn(spawn, device=dev)
    params = FluidParams.default(
        device=dev, h=h, box_half=np.asarray(half, np.float32)).derive_mass()
    dims = compute_grid_dims(0, half, (0, 0, 0), h)
    r = cells.build(state, params, dims)
    pv, ghosts = sweeps.prepare(state, params, params.dt,
                                SimConfig(n=state.n, grid_dims=dims))
    fullest = int((r.cell_end - r.cell_start).max())
    if dims != (8, 8, 8) or fullest != CROWD_ROWS + 2:
        raise AssertionError(f"crowded cell: grid {dims}, fullest cell "
                             f"{fullest} rows")
    rho_p, _ = sweeps.density_plain(r.key, r.state.pos, r.cell_start,
                                    r.cell_end, pv, ghosts)
    dens = lambda: sweeps.density_sources(r.key, r.state.pos, r.state.vel,
                                          r.cell_start, r.cell_end, pv, ghosts)
    rho_k, pres_k, src_k = dens()
    torch.cuda.synchronize()
    err_rho = check_close("crowded density rho", rho_k, rho_p, RHO_RTOL,
                          RHO_ATOL)
    check_repeat("crowded density", (rho_k, pres_k, src_k), dens)
    if not torch.equal(src_k, sweeps.pack_sources(r.state.pos, r.state.vel,
                                                  rho_k, pv, ghosts)):
        raise AssertionError("crowded cell: the density kernel's source "
                             "records are not bit-equal to the plain packing")
    log(f"crowded cell ({n} fluid rows, {fullest} in one cell): density max "
        f"abs err {err_rho!r} (rho up to {float(rho_p.max())!r}); a second "
        f"launch is bit-equal; source records bit-equal to the plain packing")
    rows = int(r.key.shape[0])            # the state pads past the spawn
    rho = torch.where(
        r.key < pv.num_cells,
        torch.as_tensor((1000.0 * (1.0 + 0.01 * rng.random(rows))).astype(
            np.float32), device=dev), torch.zeros((), device=dev))
    args = (r.key, r.state.pos, r.state.vel, rho, r.cell_start, r.cell_end,
            pv, ghosts)
    want = sweeps.force_xsph_plain(*args)
    got = sweeps.force_xsph(*args)
    per = sweeps.force_xsph_emit(*args)
    torch.cuda.synchronize()
    errs = [check_close("crowded force_xsph npos", got[0], want[0], 0.0,
                        POS_ATOL),
            check_close("crowded force_xsph nvel", got[1], want[1], 0.0,
                        VEL_ATOL),
            check_close("crowded force_xsph acc", got[2], want[2], ACC_RTOL,
                        ACC_ATOL)]
    if not torch.equal(per[:, :9], torch.cat(got, 1)):
        raise AssertionError("crowded cell: force_xsph_emit is not bit-equal "
                             "to force_xsph_kernel")
    log(f"crowded cell ({n} fluid rows, {fullest} in one cell): force_xsph "
        f"max abs err pos {errs[0]!r} vel {errs[1]!r} acc {errs[2]!r}; "
        f"force_xsph_emit bit-equal to it")


# Phase "dense": the force kernel on states of the three benchmark
# configurations after these frames of their main path (the prologue and 16
# substeps a frame): rotated_512k's piled-up corner (40 to 170 rows a cell
# from frame 20 on), and the others where neighbor_counts reads them.
DENSE_FRAMES = {"default_131k": (5,), "ghost_1m": (5,),
                "rotated_512k": (20, 60, 100)}
DENSE_REPS = 20
DENSE_TURNS = 3


def dense_inputs(dev, config, frames, states_dir=None):
    """The force kernel's inputs after each of ``frames`` (ascending) frames
    of one run of ``config``: a list of (the sorted rows, the density
    kernel's rho and source records; the sweep params; the ghost
    structure).  With ``states_dir`` they are read from
    ``<config>_<frames>.pt`` there when all exist, else saved there."""
    import os

    import torch
    from sph_tpu_torch.app import configs
    from sph_tpu_torch.engine.step import SceneBuffers, run_substeps
    from sph_tpu_torch.neighbors import cells, sweeps
    from sph_tpu_torch.neighbors.cells import GhostRows

    paths = [None if states_dir is None
             else os.path.join(states_dir, f"{config}_{f}.pt") for f in frames]
    if states_dir is not None and all(map(os.path.exists, paths)):
        out = []
        for path in paths:
            d = torch.load(path, map_location=dev)
            ghosts = None if d["ghosts"] is None else GhostRows(*d["ghosts"])
            out.append((d["args"], sweeps.SweepParams(d["consts"], *d["dims"]),
                        ghosts))
        return out
    state, params, cfg = configs.build(config, device=dev)
    prologue = configs.frame_prologue(config, params, FRAME_SUBSTEPS)
    buffers = SceneBuffers.create(cfg, device=dev)
    out, done = [], 0
    for at, path in zip(frames, paths):
        for _ in range(at - done):
            state, buffers = run_substeps(prologue(state), params, buffers,
                                          params.dt, FRAME_SUBSTEPS, cfg)
        done = at
        pv, ghosts = sweeps.prepare(state, params, params.dt, cfg)
        r = cells.build(state, params, cfg.grid_dims)
        rho, _, src = sweeps.density_sources(r.key, r.state.pos, r.state.vel,
                                             r.cell_start, r.cell_end, pv,
                                             ghosts)
        args = (r.key, r.state.pos, r.state.vel, rho, r.cell_start,
                r.cell_end, src)
        if path is not None:
            os.makedirs(states_dir, exist_ok=True)
            torch.save({"args": args, "consts": pv.consts,
                        "dims": (pv.nx, pv.ny, pv.nz),
                        "ghosts": None if ghosts is None else tuple(ghosts)},
                       path)
        out.append((args, pv, ghosts))
    return out


def other_force_library(root):
    """The force kernel of another checkout at ``root`` (its own build,
    made by its own ``native/build.py``), loaded beside this one: (lib,
    whether its entry point takes the tile counter)."""
    import ctypes
    import os
    import subprocess

    from sph_tpu_torch.native import build
    out = subprocess.run(
        [sys.executable, "-c", "from sph_tpu_torch.native import build; "
         "print(build.library_path())"],
        cwd=root, capture_output=True, text=True, check=True)
    lib = ctypes.CDLL(out.stdout.strip().splitlines()[-1])
    with open(os.path.join(root, "sph_tpu_torch", "csrc", "sweeps.h")) as f:
        counted = "tile_warps" in f.read()
    types = build.library().sph_force_xsph.argtypes
    lib.sph_force_xsph.argtypes = types if counted else types[:-1]
    lib.sph_force_xsph.restype = ctypes.c_int
    return lib, counted


def launch_force(lib, args, pv, ghosts, counted=True, counter=None):
    """One launch of ``lib``'s ``sph_force_xsph`` on the inputs of
    ``dense_inputs``, as ``sweeps.force_xsph`` launches it (outputs
    allocated first): (npos, nvel, acc)."""
    import torch
    from sph_tpu_torch.neighbors import sweeps
    key, pos, vel, rho, cs, ce, src = args
    npos, nvel, acc = (torch.empty_like(pos) for _ in range(3))
    tail = (None if counter is None else counter.data_ptr(),) if counted \
        else ()
    err = lib.sph_force_xsph(
        key.data_ptr(), src.data_ptr(), src.shape[1], cs.data_ptr(),
        ce.data_ptr(), key.shape[0], *sweeps._ghost_args(ghosts),
        *sweeps.c_params(pv), npos.data_ptr(), nvel.data_ptr(),
        acc.data_ptr(), torch.cuda.current_stream(key.device).cuda_stream,
        *tail)
    if err != 0:
        raise RuntimeError(f"force_xsph launch failed: CUDA error {err}")
    return npos, nvel, acc


def force_registers() -> dict:
    """``nvcc -Xptxas -v`` on csrc/sweeps.cu: each force kernel's
    registers, stack and spill bytes."""
    import os
    import re
    import subprocess
    import tempfile

    from sph_tpu_torch.native import build
    src = os.path.join(build.CSRC_DIR, "sweeps.cu")
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             os.path.join(tmp, "sweeps.o"), src],
            capture_output=True, text=True, check=True)
    out, name = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)'?", line)
        if m:
            name = m.group(1) if "force_xsph_kernel" in m.group(1) else None
            continue
        if name is None:
            continue
        rec = out.setdefault("emit" if "ILb1E" in name else "plain", {})
        for field, pat in (("stack", r"(\d+) bytes stack frame"),
                           ("spill_stores", r"(\d+) bytes spill stores"),
                           ("spill_loads", r"(\d+) bytes spill loads"),
                           ("registers", r"Used (\d+) registers")):
            m = re.search(pat, line)
            if m:
                rec[field] = int(m.group(1))
    log(f"force_xsph_kernel (-Xptxas -v): {json.dumps(out)}")
    if set(out) != {"plain", "emit"}:
        raise AssertionError(f"force_xsph_kernel: -Xptxas -v gave {out}")
    return out


def phase_dense(dev, against=None, states_dir=None):
    """The force kernel on the states of ``DENSE_FRAMES``: its tile-path
    counter against ``sweeps.tile_warp_count``, outputs with the counter
    bit-equal to those without, a second launch and the emit variant
    bit-equal, timed with its bound (the phase-3 count on these rows).
    With ``against`` (another checkout's root), that checkout's force kernel
    on the same inputs: outputs bit-equal or the largest differences within
    the tolerances, and both timed in turns, this tree's first."""
    from sph_tpu_torch.native import build

    regs = force_registers()
    lib = build.library()
    other = None if against is None else other_force_library(against)
    out = {"registers": regs}
    for config, at in DENSE_FRAMES.items():
        for frames, inputs in zip(at, dense_inputs(dev, config, at,
                                                   states_dir)):
            out[f"{config}_{frames}"] = dense_state(
                lib, other, against, config, frames, *inputs)
    return out


def dense_state(lib, other, against, config, frames, args, pv, ghosts):
    """Phase dense on one state of ``config`` after ``frames`` frames
    (``phase_dense``): its record."""
    import statistics

    import torch
    from sph_tpu_torch.app.microbench import time_ms
    from sph_tpu_torch.neighbors import sweeps

    key, pos, vel, rho, cs, ce, src = args
    name = f"{config} after {frames} frames"
    counter = torch.zeros(1, dtype=torch.int32, device=key.device)
    got = launch_force(lib, args, pv, ghosts, counter=counter)
    plain = launch_force(lib, args, pv, ghosts)
    per = sweeps.force_xsph_emit(key, pos, vel, rho, cs, ce, pv, ghosts, src)
    torch.cuda.synchronize()
    tiles = sweeps.tile_warp_count(key, pv.num_cells, pv.nx)
    reasons = sweeps.queue_warp_reasons(key, pv.num_cells, pv.nx)
    fluid_rows = int((key < pv.num_cells).sum())
    warps = -(-fluid_rows // 32)
    if int(counter) != tiles:
        raise AssertionError(f"{name} dense: the kernel counted "
                             f"{int(counter)} tile warps, the rule {tiles}")
    for a, b in zip(got, plain):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} dense: outputs with the counter "
                                 f"differ from those without")
    if not torch.equal(per[:, :9], torch.cat(got, 1)):
        raise AssertionError(f"{name} dense: force_xsph_emit is not "
                             f"bit-equal to force_xsph_kernel")
    check_repeat(f"{name} dense force_xsph", got,
                 lambda: launch_force(lib, args, pv, ghosts))
    cand, _, near_f, near_x = cell_pairs(key, pos, got[0], cs, ce, pv, ghosts)
    n, nc8 = int(key.shape[0]), 8 * pv.num_cells
    gbytes = 0 if ghosts is None else 12 * ghosts.count + nc8
    nbytes = 32 * n + nc8 + gbytes + 36 * n
    ops = (2 * OPS_TEST * cand + OPS_FORCE_NEAR * near_f
           + OPS_XSPH_NEAR * near_x)
    rec = {"frames": frames, "rows": fluid_rows, "tile_warps": tiles,
           "tile_share": tiles / max(warps, 1), "queue_reasons": reasons,
           "candidates": cand, "pairs_force": near_f, "pairs_xsph": near_x}
    log(f"{name}: {fluid_rows} fluid rows, {cand} candidates, {near_f} pairs "
        f"within h (force), {near_x} (XSPH); tile path {tiles} of {warps} "
        f"warps ({rec['tile_share']!r}), the others queue by {reasons}; "
        f"counter, relaunch and emit checks passed")
    mine = lambda: launch_force(lib, args, pv, ghosts)
    if other is None:
        ms = time_ms(mine, DENSE_REPS)
        rec.update(report(name, "force_xsph dense", ms, None, nbytes, ops, n))
        return rec
    olib, counted = other
    theirs = lambda: launch_force(olib, args, pv, ghosts, counted)
    ref = theirs()
    if counted:
        counter.zero_()
        launch_force(olib, args, pv, ghosts, counted, counter)
        rec["against_tile_warps"] = int(counter)
        rec["against_tile_share"] = int(counter) / max(warps, 1)
    torch.cuda.synchronize()
    if all(torch.equal(a, b) for a, b in zip(got, ref)):
        rec["against"] = "bit-equal"
    else:
        rec["against"] = {
            "npos": check_close(f"{name} npos against", got[0], ref[0], 0.0,
                                POS_ATOL),
            "nvel": check_close(f"{name} nvel against", got[1], ref[1], 0.0,
                                VEL_ATOL),
            "acc": check_close(f"{name} acc against", got[2], ref[2],
                               ACC_RTOL, ACC_ATOL),
            "rows_apart": int((torch.cat(got, 1) != torch.cat(ref, 1))
                              .any(1).sum())}
    turns = {"this": [], "against": []}
    for _ in range(DENSE_TURNS):
        for side in ("this", "against", "against", "this"):
            turns[side].append(time_ms(mine if side == "this" else theirs,
                                       DENSE_REPS))
    ms = statistics.median(turns["this"])
    ms_other = statistics.median(turns["against"])
    rec.update(report(name, "force_xsph dense", ms, None, nbytes, ops, n))
    rec.update(against_ms=ms_other, turns=turns, speedup=ms_other / ms)
    log(f"{name} dense force_xsph: this tree {ms!r} ms, {against} "
        f"{ms_other!r} ms (medians of {2 * DENSE_TURNS}, in turns), "
        f"{ms_other / ms!r}x; tile share {rec['tile_share']!r}, "
        f"{against}'s {rec.get('against_tile_share')!r}; outputs against "
        f"it: {rec['against']}")
    return rec


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
    check_repeat(f"{config} brute_density", (raw_k,),
                 lambda: (BK.density_raw(pos, cf, pv),))
    log(f"{config} brute_density: max|rho_raw err| {err_rho!r}, rho_raw "
        f"range [{float(raw_p.min())!r}, {float(raw_p.max())!r}]; a second "
        f"launch is bit-equal")

    rho, pres = C.finish_density(raw_p, state.ghost, contrib, state.density,
                                 state.pressure, params)
    fp = BK.force_plain(pos, vel, rho, pres, cf, pv)
    fk = BK.force(pos, vel, rho, pres, cf, pv)
    torch.cuda.synchronize()
    err_pos = check_close("brute_force npos", fk[0], fp[0], 0.0, POS_ATOL)
    err_vel = check_close("brute_force nvel", fk[1], fp[1], 0.0, VEL_ATOL)
    err_acc = check_close("brute_force acc", fk[2], fp[2], ACC_RTOL, ACC_ATOL)
    check_repeat(f"{config} brute_force", fk,
                 lambda: BK.force(pos, vel, rho, pres, cf, pv))
    log(f"{config} brute_force: max abs err pos {err_pos!r} vel {err_vel!r} "
        f"acc {err_acc!r}; a second launch is bit-equal")

    tested, near_d, near_f, near_x = brute_pairs(pos, fp[0], rho, cf, pv)
    log(f"{config} all pairs: {tested} pairs tested per pass, {near_d} "
        f"within h (density), {near_f} (force), {near_x} (XSPH)")
    work = {
        # pos, contrib in; rho_raw out
        "brute_density": (20 * n, OPS_TEST_EXPANDED * tested
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


def phase_brute_final(dev, state, config):
    """The all-pairs density kernel on ``state``, the final state of
    ``config``'s main path, where the fluid has fallen and pairs within h
    are denser: held to its plain version, a second launch bit-equal, and
    timed beside its bound on these inputs. Returns its ms."""
    import torch
    from sph_tpu_torch.app import configs
    from sph_tpu_torch.app.microbench import time_ms
    from sph_tpu_torch.physics import brute_kernels as BK

    _, params, _ = configs.build(config, device=dev)
    pv = BK.prepare(params, params.dt)
    cf = state.contrib_mask(params.ghost_face_active).to(torch.float32)
    pos, n = state.pos, state.n
    want = BK.density_raw_plain(pos, cf, pv)
    got = BK.density_raw(pos, cf, pv)
    torch.cuda.synchronize()
    err = check_close(f"{config} final brute_density rho_raw", got, want,
                      RHO_RTOL, RHO_ATOL)
    check_repeat(f"{config} final brute_density", (got,),
                 lambda: (BK.density_raw(pos, cf, pv),))
    tested, near, _, _ = brute_pairs(pos, pos, torch.ones_like(cf), cf, pv)
    ms = time_ms(lambda: BK.density_raw(pos, cf, pv), 50)
    b_ms, by = bound(20 * n, OPS_TEST_EXPANDED * tested
                     + OPS_DENSITY_NEAR * near)
    log(f"{config} final state brute_density: max|rho_raw err| {err!r}, a "
        f"second launch bit-equal; {near} pairs within h (self included) of "
        f"{tested} tested; kernel {ms!r} ms, bound {b_ms!r} ms by {by}, share "
        f"of bound reached {b_ms / ms!r}")
    return ms


def phase_emit(dev, config):
    """The emitted-row force kernel against its plain version at full
    ``config`` after the wave and one plain substep, timed beside
    ``force_xsph_kernel`` (and ``torch.cat`` of its four outputs, the
    packing alone); then 16
    substeps with ``emit_rows`` and 16 without from one state, which must
    agree bit for bit."""
    import dataclasses

    import torch
    from sph_tpu_torch.app.microbench import time_ms
    from sph_tpu_torch.app import configs
    from sph_tpu_torch.engine.step import SceneBuffers, run_substeps
    from sph_tpu_torch.neighbors import cells, sweeps
    from sph_tpu_torch.physics import constraints
    from sph_tpu_torch.utils import trace

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

    _, _, r = check_cell_tables(config, state, params, cfg, ghosts)
    key, pos, vel, cs, ce = (r.key, r.state.pos, r.state.vel, r.cell_start,
                             r.cell_end)
    rho, _ = sweeps.density_plain(key, pos, cs, ce, pv, ghosts)
    args = (key, pos, vel, rho, cs, ce, pv, ghosts)
    # the kernels are timed on finished source records, as the substep
    # hands them over
    kargs = (*args, sweeps.pack_sources(pos, vel, rho, pv, ghosts))
    want = sweeps.force_xsph_emit_plain(*args)
    got = sweeps.force_xsph_emit(*kargs)
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
    parts = sweeps.force_xsph(*kargs)
    if not torch.equal(got[:, :9], torch.cat(parts, 1)):
        raise AssertionError("force_xsph_emit: not bit-equal to "
                             "force_xsph_kernel")
    check_repeat(f"{config} force_xsph_emit", (got,),
                 lambda: (sweeps.force_xsph_emit(*kargs),))
    log(f"{config} force_xsph_emit: max abs err pos {errs[0]!r} vel "
        f"{errs[1]!r} acc {errs[2]!r}; bit-equal to force_xsph_kernel; a "
        f"second launch is bit-equal")

    n, nc8 = int(key.shape[0]), 8 * cfg.num_cells
    gbytes = 0 if ghosts is None else 12 * ghosts.count + nc8
    cand, _, near_f, near_x = cell_pairs(key, pos, want[:, 0:3], cs, ce, pv,
                                         ghosts)
    log(f"{config} cell sweeps: {cand} candidates tested by the fluid rows, "
        f"{near_f} within h (force), {near_x} (XSPH)")
    col = rho[:, None]
    times = (time_ms(lambda: sweeps.force_xsph_emit(*kargs), 50),
             time_ms(lambda: sweeps.force_xsph_emit_plain(*args), 5))
    # no single PyTorch call computes the sweep; torch.cat of its four
    # finished outputs is the packing alone, logged for scale
    log(f"{config} packing alone (torch.cat of npos, nvel, acc, rho): "
        f"{time_ms(lambda: torch.cat([*parts, col], 1), 50)!r} ms")
    log(f"{config} force_xsph (gather transport) kernel: "
        f"{time_ms(lambda: sweeps.force_xsph(*kargs), 50)!r} ms")
    # key, pos, vel, rho, ranges (+ ghosts) in; per [n, 16] out
    rec = {"max_abs_err": max(errs), **report(
        config, "force_xsph_emit", *times, 32 * n + nc8 + gbytes + 64 * n,
        2 * OPS_TEST * cand + OPS_FORCE_NEAR * near_f
        + OPS_XSPH_NEAR * near_x, n)}

    runs = {}
    for emit in (True, False):
        since = trace.launches()
        runs[emit], _ = run_substeps(
            state, params, SceneBuffers.create(cfg), params.dt,
            FRAME_SUBSTEPS, dataclasses.replace(cfg, emit_rows=emit))
        torch.cuda.synchronize()
        got_n = trace.launches(since)
        want_n = {"force_xsph_emit": FRAME_SUBSTEPS if emit else 0,
                  "force_xsph": 0 if emit else FRAME_SUBSTEPS}
        if {k: got_n.get(k, 0) for k in want_n} != want_n:
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
    """The micro-kernels' entry points, with their launch counts; then
    each micro-kernel bit-equal to its plain version at the scripts'
    default sizes and at a second size where bytes bind (the smoke at
    [65,536, 512], the expand at 1,024 rows), timed beside its plain
    version and one library call that computes the same; and the launch
    floor, one one-element torch op timed the same way."""
    import torch
    from sph_tpu_torch.app.microbench import time_ms
    from sph_tpu_torch.app import microbench, proto_expand
    from sph_tpu_torch.utils import trace

    since = trace.launches()
    microbench.main([])
    res = proto_expand.main()
    counts = trace.launches(since)
    # the smoke check's one launch; the expand's check and its timing
    # (one warm-up, microbench.REPS timed)
    expect = dict.fromkeys(counts, 0)
    expect.update(smoke=1, expand=2 + microbench.REPS)
    if counts != expect:
        raise AssertionError(f"micro: launches {counts}, expected {expect}")
    log(f"micro entry points: launches {counts}; expand {res}")

    one = torch.zeros(1, device=dev)
    log(f"micro: launch floor (one-element add_, CUDA events over 50 "
        f"launches) {time_ms(lambda: one.add_(1.0), 50)!r} ms")
    nrow, s, maxr = proto_expand.sizes()
    measured = {
        "smoke": {"max_abs_err": 0.0, **micro_smoke(dev, (256, 512)),
                  "second": micro_smoke(dev, (65536, 512))},
        "expand": {"max_abs_err": 0.0, **micro_expand(dev, nrow, s, maxr),
                   "second": micro_expand(dev, 1024, s, maxr)}}
    return measured, counts


def micro_smoke(dev, shape) -> dict:
    """``smoke_kernel`` on x of ``shape`` from seed 0, bit-equal to its
    plain version, timed beside it and ``x * 8``; its record fields."""
    import numpy as np
    import torch
    from sph_tpu_torch.app import microbench
    from sph_tpu_torch.app.microbench import time_ms
    from sph_tpu_torch.utils import trace

    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        shape).astype(np.float32), device=dev)
    since = trace.launches()
    if not torch.equal(microbench.smoke(x), microbench.smoke_plain(x)):
        raise AssertionError(f"smoke {shape}: kernel is not bit-equal to "
                             f"the plain version")
    if trace.launches(since).get("smoke", 0) != 1:
        raise AssertionError(f"smoke {shape}: launches "
                             f"{trace.launches(since)} in one call")
    times = (time_ms(lambda: microbench.smoke(x), 50),
             time_ms(lambda: microbench.smoke_plain(x), 50))
    lib_ms = time_ms(lambda: x * 8.0, 50)
    # x in, o out; 4 multiplies and 4 adds per value
    return {"shape": list(shape), **report(
        f"micro {shape}", "smoke", *times, 8 * x.numel(), 8 * x.numel(),
        x.numel(), lib_ms)}


def micro_expand(dev, nrow, s, maxr) -> dict:
    """``expand_kernel`` on the script's inputs at ``nrow`` rows, bit-equal
    to its plain version (and the script's oracle at its default rows),
    timed beside it and one ``index_put_`` into a filled output, its
    indices made beforehand; its record fields."""
    import numpy as np
    import torch
    from sph_tpu_torch.app import proto_expand
    from sph_tpu_torch.app.microbench import time_ms
    from sph_tpu_torch.utils import trace

    starts, rows, targets = proto_expand.synth(nrow, s, maxr)
    st = torch.as_tensor(starts, device=dev)
    rw = torch.as_tensor(rows, device=dev)
    want = proto_expand.expand_plain(st, rw, s)
    since = trace.launches()
    if not torch.equal(proto_expand.expand(st, rw, s), want):
        raise AssertionError(f"expand ({nrow} rows, S={s}): kernel is not "
                             f"bit-equal to the plain version")
    if trace.launches(since).get("expand", 0) != 1:
        raise AssertionError(f"expand ({nrow} rows): launches "
                             f"{trace.launches(since)} in one call")
    if nrow == proto_expand.sizes()[0] and not np.array_equal(
            want.cpu().numpy(), proto_expand.oracle(starts, rows, targets, s)):
        raise AssertionError("expand: plain version differs from the "
                             "script's oracle")
    n, f = int(starts[-1]), proto_expand.F
    yy = torch.repeat_interleave(torch.arange(nrow, device=dev),
                                 (st[1:] - st[:-1]).long())[:, None]
    ff = torch.arange(f, device=dev)[None, :]
    tt = rw[:n, f].long()[:, None]
    vals = rw[:n, :f]
    filled = torch.full_like(want, -1.0)
    times = (time_ms(lambda: proto_expand.expand(st, rw, s), 50),
             time_ms(lambda: proto_expand.expand_plain(st, rw, s), 50))
    lib_ms = time_ms(lambda: filled.index_put_((yy, ff, tt), vals), 50)
    # starts and each element's payload and target in, out written
    nbytes = 4 * (nrow + 1) + 4 * (f + 1) * n + 4 * want.numel()
    return {"shape": [nrow, f, s], **report(
        f"micro ({nrow} rows, S={s})", "expand", *times, nbytes,
        2 * n * -(-s // EXPAND_CHUNK), n, lib_ms)}


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
    from sph_tpu_torch.engine.step import SceneBuffers, run_substeps

    dam = (S.state_from_spawn(S.spawn_standard(2048, seed=7), device=dev),
           FluidParams.default(device=dev).derive_mass(),
           compute_grid_dims(0, np.array([7.0, 7.0, 7.0]), np.zeros(3), 0.28))
    for name, (state, params, dims) in (("2k dam break", dam),
                                        ("ghost shell",
                                         ghost_shell_fixture(dev))):
        outs = {}
        for impl in ("brute", "cell", "brute_kernel"):
            cfg = SimConfig(n=state.n, grid_dims=dims, neighbor_impl=impl)
            outs[impl], _ = run_substeps(state, params,
                                         SceneBuffers.create(cfg), params.dt,
                                         20, cfg)
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
    phase_shapes(dev)


def check_no_host_wait(label, step, state, buffers) -> None:
    """Two calls of ``step(state, buffers) -> (state, buffers)`` under
    torch's synchronisation check: any device-to-host wait raises."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state, buffers = step(state, buffers)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"{label}: 2 substeps made no device-to-host wait")


GRAPH_FRAMES = 2             # frames held bit-identical, eager against graph
GRAPH_TURNS = 3              # eager and graph frames timed in turns


def same_states(label, eager, graph) -> None:
    """Every field of two (state, buffers) results bit-identical, the rows
    aligned by orig_id; else name the first field that differs and its
    largest difference."""
    import dataclasses

    import torch
    (se, be), (sg, bg) = eager, graph
    ie, ig = torch.argsort(se.orig_id), torch.argsort(sg.orig_id)
    pairs = [(f.name, getattr(se, f.name)[ie], getattr(sg, f.name)[ig])
             for f in dataclasses.fields(se)]
    pairs += [(f"buffers.{f.name}", getattr(be, f.name), getattr(bg, f.name))
              for f in dataclasses.fields(be)]
    for name, a, b in pairs:
        if not torch.equal(a, b):
            raise AssertionError(
                f"{label}: {name} differs between run_substeps_eager and the "
                f"graph (max abs {max_err(a.double(), b.double())!r})")


def frame_ms(fn):
    """(fn()'s result, its ms by CUDA events, its ms on the host clock)."""
    import torch
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1), (time.perf_counter() - h0) * 1e3


def graph_turns(label, make_turn, n_sub) -> dict:
    """GRAPH_TURNS turns of an eager frame and a graph frame from the same
    state: ``make_turn()`` gives the turn's two frames as calls, the graph's
    carrying the state on to the next turn.  Logs and returns the median
    ms/substep of each by CUDA events and on the host clock."""
    import statistics
    times = {"eager": ([], []), "graph": ([], [])}
    for _ in range(GRAPH_TURNS):
        for name, fn in zip(("eager", "graph"), make_turn()):
            _, ev, host = frame_ms(fn)
            times[name][0].append(ev / n_sub)
            times[name][1].append(host / n_sub)
    out = {f"{name}_{clock}": statistics.median(v[i])
           for name, v in times.items()
           for i, clock in enumerate(("events_ms", "host_ms"))}
    log(f"graph {label}: ms/substep in {GRAPH_TURNS} turns (eager, then "
        f"graph, from one state), eager by CUDA events {times['eager'][0]!r},"
        f" host clock {times['eager'][1]!r}; graph by CUDA events "
        f"{times['graph'][0]!r}, host clock {times['graph'][1]!r}; medians "
        f"{out}")
    return out


def check_syncs(label, syncs, n_sub) -> None:
    """Log a frame's synchronising calls by source line; fail if a line
    made one a substep or more (a wait inside the substep loop)."""
    log(f"{label}: {sum(syncs.values())} synchronising calls in a frame of "
        f"{n_sub} substeps, by source line {dict(syncs.most_common())}")
    inner = {k: v for k, v in syncs.items() if v >= n_sub}
    if inner:
        raise AssertionError(f"{label}: a synchronising call every substep "
                             f"{inner}")


def phase_graph_bench(config, state, params, cfg):
    """Phase ``graph`` at a bench configuration, from ``state`` (its main
    path's final state): GRAPH_FRAMES frames of prologue + 16 substeps
    through ``run_substeps_eager`` and through the graph, bit-identical by
    orig_id; a replayed frame (the prologue and ``run_captured``, after
    ``neighbor_aux``) under torch's synchronisation check in its error
    mode; eager and graph ms/substep in turns."""
    import torch
    from sph_tpu_torch.app import configs
    from sph_tpu_torch.engine import graph
    from sph_tpu_torch.engine.step import (SceneBuffers, neighbor_aux,
                                           run_captured, run_substeps,
                                           run_substeps_eager)

    prologue = configs.frame_prologue(config, params, FRAME_SUBSTEPS)
    dt = params.dt

    def frames(run):
        st, b = state, SceneBuffers.create(cfg)
        for _ in range(GRAPH_FRAMES):
            st, b = run(prologue(st), params, b, dt, FRAME_SUBSTEPS, cfg)
        return st, b

    eager, graphed = frames(run_substeps_eager), frames(run_substeps)
    torch.cuda.synchronize()
    same_states(f"{config}: {GRAPH_FRAMES} frames", eager, graphed)
    log(f"graph {config}: {GRAPH_FRAMES} frames bit-identical to "
        f"run_substeps_eager by orig_id, every field")

    st, b = graphed
    aux = neighbor_aux(st, params, dt, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, b = run_captured(prologue(st), params, b, dt, FRAME_SUBSTEPS, cfg,
                             aux)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"graph {config}: a replayed frame (prologue and run_captured) made "
        f"no device-to-host wait; {graph.describe()}")

    cur = [st]

    def make_turn():
        start, buf = cur[0], SceneBuffers.create(cfg)

        def eager():
            run_substeps_eager(prologue(start), params, buf, dt,
                               FRAME_SUBSTEPS, cfg)

        def graphed():
            cur[0] = run_substeps(prologue(start), params, buf, dt,
                                  FRAME_SUBSTEPS, cfg)[0]
        return eager, graphed
    return graph_turns(config, make_turn, FRAME_SUBSTEPS)


def phase_graph_scene(dev, name, scene):
    """Phase ``graph`` on a scene path, from ``scene`` (its final frame):
    GRAPH_FRAMES frames of ``Scene.update`` on two copies, one with
    ``run_substeps_eager`` in place of ``run_substeps``, bit-identical by
    orig_id; the same with gravity spin on (the reaction tips gravity every
    frame, so the graph must read the new value); one graph frame's
    synchronising calls by source line; eager and graph ms/substep in
    turns."""
    import dataclasses
    from unittest import mock

    import torch
    from sph_tpu_torch.app import scene_paths
    from sph_tpu_torch.engine import step as E

    def eager_update(sc, i):
        with mock.patch.object(E, "run_substeps", E.run_substeps_eager):
            return scene_paths.frame(i, sc)

    def graph_update(sc, i):
        return scene_paths.frame(i, sc)

    for spin in (False, True):
        runs = {}
        for kind, update in (("eager", eager_update), ("graph", graph_update)):
            sc = scene_copy(scene, dev)
            sc.settings = dataclasses.replace(sc.settings, spin_on=spin)
            gravity = []
            for i in range(GRAPH_FRAMES):
                update(sc, FRAMES + i)
                gravity.append(sc.params.gravity.tolist())
            runs[kind] = (sc.state, sc.buffers)
        torch.cuda.synchronize()
        same_states(f"{name} (gravity spin {spin}): {GRAPH_FRAMES} frames",
                    runs["eager"], runs["graph"])
        if spin and gravity[0] == gravity[1]:
            raise AssertionError(f"{name}: gravity spin did not move gravity")
        log(f"graph {name}: {GRAPH_FRAMES} frames of Scene.update with "
            f"gravity spin {spin} (gravity {gravity}) bit-identical to "
            f"run_substeps_eager by orig_id, every field")

    sc = scene_copy(scene, dev)
    n_sub, syncs = count_syncs(lambda: graph_update(sc, FRAMES))
    check_syncs(f"graph {name}: Scene.update", syncs, n_sub)

    def make_turn():
        ecopy = scene_copy(sc, dev)
        return (lambda: eager_update(ecopy, FRAMES + 1),
                lambda: graph_update(sc, FRAMES + 1))
    return graph_turns(name, make_turn, FRAME_SUBSTEPS)


def phase_main(dev, config):
    """The port's main path: configs.build with no device (the card is
    the default), then frames of frame_prologue + run_substeps at
    ``config``."""
    import dataclasses

    import torch
    from sph_tpu_torch.app import configs
    from sph_tpu_torch.core.device import card_line
    from sph_tpu_torch.core.params import rotation_matrix
    from sph_tpu_torch.engine.step import (SceneBuffers, neighbor_aux,
                                           run_substeps, substep)
    from sph_tpu_torch.utils import trace

    torch.cuda.reset_peak_memory_stats(dev)
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
    buffers = SceneBuffers.create(cfg)
    torch.cuda.synchronize()

    since = trace.launches()
    for frame in range(FRAMES):
        if frame == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, buffers = run_substeps(prologue(state), params, buffers, dt,
                                      FRAME_SUBSTEPS, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = trace.launches(since)

    total = FRAMES * FRAME_SUBSTEPS
    timed = total - FRAME_SUBSTEPS
    # one container pass a substep on every engine: the cell engine's
    # reassembly, the others' scene stages
    expect = dict.fromkeys(counts, 0)
    expect["container"] = total
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
    ref = REF_RHO.get(config)
    if ref is None:
        log(f"main path {config}: the density is not held to a JAX reference "
            f"(none is within reach at this size, ROADMAP R10); the other "
            f"checks stand")
    else:
        for name, got, want, rtol in (("max", rho_max, ref[0], 0.02),
                                      ("mean", rho_mean, ref[1], 0.005)):
            if not abs(got - want) <= rtol * want:
                raise AssertionError(f"{config}: fluid density {name} {got} "
                                     f"is not within {rtol} of the "
                                     f"reference's {want}")
    if not vmax <= 0.4 * h / dtf * (1 + 1e-4):
        raise AssertionError(f"{config}: speed {vmax} above the CFL cap")
    local = (pos - params.box_center) @ rotation_matrix(params.box_euler_deg)
    if not bool((local.abs() <= params.box_half + 1e-4).all()):
        raise AssertionError(f"{config}: a fluid particle left the box")
    if n_ghost:
        check_ghosts(config, start, state, rho0)

    # the substep with the per-run constants built beforehand, as
    # run_substeps runs it: the cell engine or the all-pairs kernels
    aux = neighbor_aux(state, params, dt, cfg)
    check_no_host_wait(
        f"{config}: {cfg.neighbor_impl} substep after neighbor_aux",
        lambda st, b: substep(st, params, b, dt, cfg, aux=aux), state,
        SceneBuffers.create(cfg))

    ms = wall / timed * 1e3
    rate = n_fluid * timed / wall
    log(f"main path {config}: {ms!r} ms/substep, {rate!r} particle-steps/s "
        f"(host clock over {timed} substeps and their frames' prologues, "
        f"after a frame of warm-up); peak device memory "
        f"{torch.cuda.max_memory_allocated(dev)} bytes (build and run) on "
        f"{card_line()}")
    return counts, state, params, cfg


EXPORT_SUBSAMPLE = 2000      # every 2000th row for the rasterizer check
SPLAT_REPS = 20              # renders over which the splat kernels are timed


def phase_export(dev, state, config):
    """The frame export of ``app.bench.export_frames`` on ``state``, the
    final state of ``config``'s main path, into a temporary directory: each
    PNG read back (``viz.splat.read_png``), 960x540 and not all background;
    the frame composed on the card (``csrc/splat.cu``) equal, pixel for
    pixel, to the host path's frame of the same state
    (``splat.render_frame_host``) for the height and speed drives; the
    colors of each exported drive computed on the card equal to the
    port's colors of the same state on the CPU within 1e-5 (palette 1 has
    no hash); the host rasterizer against its plain version on a subsample
    at 240x135 with the export's point size, under 2% of pixels off by more
    than 2/255 (tests/test_viz.py).  (Discs of a few pixels overlap nearly
    everywhere in this dense block, where the plain version, which writes
    offset by offset, keeps other colors than the rasterizer: the tests
    hold that case on a sparse 2k state.)

    Returns the ``splat`` record of the kernels' record: two
    ``launches.splat`` a render (asserted for every render of the phase),
    the three kernels' device time a frame of the speed drive
    (``torch.profiler``, over ``SPLAT_REPS`` renders) and the whole
    render's on the host's clock (``render_ms``), the host path's
    whole render as the plain time, and the bound of
    ``benchmark/metrics/splat_roofline.py``'s count of bytes and
    operations."""
    import dataclasses
    import os
    import tempfile

    import numpy as np
    import torch
    from benchmark.metrics import splat_roofline as roof
    from sph_tpu_torch.app import bench, configs
    from sph_tpu_torch.utils import trace
    from sph_tpu_torch.viz import palettes, splat
    from sph_tpu_torch.viz.camera import fit_camera

    def card_render(*args, **kw):
        since = trace.launches()
        img = splat.render_frame(*args, **kw)
        moved = trace.launches(since)
        if moved != {"splat": 2}:
            raise AssertionError(f"export {config}: a render launched "
                                 f"{moved}, expected two splat launches")
        return img

    cfg = configs.CONFIGS[config]
    n_fluid = int(state.fluid_mask().sum())
    n_ghost = int((state.ghost > 0).sum())
    with tempfile.TemporaryDirectory() as out:
        since = trace.launches()
        t0 = time.perf_counter()
        paths = bench.export_frames(state, cfg, out)
        seconds = time.perf_counter() - t0
        launches = trace.launches(since).get("splat", 0)
        if launches != 2 * len(paths):
            raise AssertionError(f"export {config}: {launches} splat "
                                 f"launches for {len(paths)} frames")
        background = np.asarray([7, 10, 15], np.uint8)   # splat's default
        for path in paths:
            img = splat.read_png(path)
            if img.shape != (540, 960, 3):
                raise AssertionError(f"{path}: shape {img.shape}")
            drawn = float((img != background).any(axis=-1).mean())
            if not drawn >= 1e-3:
                raise AssertionError(f"{path}: {drawn} of the pixels drawn")
            log(f"export {config}: {os.path.basename(path)} read back, "
                f"{os.path.getsize(path)} bytes, {drawn!r} of the pixels "
                f"drawn")
    log(f"export {config}: {len(paths)} frames of {n_fluid} particles in "
        f"{seconds!r} s (composed on the card, PNG on the host)")

    cam = fit_camera(np.asarray(cfg.box_half, np.float32))
    size = dict(width=960, height=540, particle_radius=0.5 * cfg.h)
    for mode in (palettes.DRIVE_HEIGHT, palettes.DRIVE_SPEED):
        vp = bench.export_params(cfg, mode)
        card = card_render(state, vp, cam, **size)
        t0 = time.perf_counter()
        host_frame = splat.render_frame_host(state, vp, cam, **size)
        plain_ms = (time.perf_counter() - t0) * 1e3
        apart = int((card != host_frame).any(axis=-1).sum())
        if apart:
            raise AssertionError(f"export {config} drive {mode}: the card's "
                                 f"frame and the host's differ on {apart} "
                                 f"pixels")
    log(f"export {config}: the card's frames equal the host path's (height, "
        f"speed)")
    # the whole render's wall time, and the kernels' device time a frame,
    # at the speed drive (the last vp)
    t0 = time.perf_counter()
    for _ in range(SPLAT_REPS):
        card_render(state, vp, cam, **size)
    render_ms = (time.perf_counter() - t0) * 1e3 / SPLAT_REPS
    names = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(roof.KERNELS)
                       + r")(?![A-Za-z0-9_])")
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(SPLAT_REPS):
            card_render(state, vp, cam, **size)
        torch.cuda.synchronize()
    hits = [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and names.search(e.name)]
    if len(hits) != len(roof.KERNELS) * SPLAT_REPS:
        raise AssertionError(f"export {config}: the profiler saw "
                             f"{len(hits)} splat kernels in {SPLAT_REPS} "
                             f"renders")
    k_ms = sum(hits) * 1e-3 / SPLAT_REPS
    pixels = size["width"] * size["height"]
    rec = report(config, "splat", k_ms, plain_ms,
                 n_fluid * roof.BYTES_PER_FLUID_ROW
                 + n_ghost * roof.BYTES_PER_GHOST_ROW
                 + pixels * roof.BYTES_PER_PIXEL,
                 roof.OPS_PER_FLUID_ROW * n_fluid
                 + roof.OPS_PER_PIXEL * pixels, n_fluid)
    rec.update(launches=launches, launches_per_render=2, render_ms=render_ms)
    log(f"export {config}: the card's render {render_ms!r} ms a frame on the "
        f"host's clock, its three kernels {k_ms!r} ms")
    view = cam.view_matrix()
    host = {f: getattr(state, f).cpu() for f in (
        "pos", "vel", "pressure", "density", "color_group")}
    vpos = host["pos"].numpy() @ view[:3, :3].T + view[:3, 3]
    errs = []
    for mode, drive in bench.EXPORT_DRIVES:
        vp = bench.export_params(cfg, mode)
        card = palettes.particle_colors(
            vp, state.pos, torch.as_tensor(vpos, device=dev), state.vel,
            state.pressure, state.density, state.color_group)
        cpu = palettes.particle_colors(
            vp, host["pos"], torch.as_tensor(vpos), host["vel"],
            host["pressure"], host["density"], host["color_group"])
        if card.device != dev:
            raise AssertionError(f"{drive} colors computed on {card.device}")
        errs.append(max_err(card.cpu(), cpu))
        if not errs[-1] <= 1e-5:
            raise AssertionError(f"export {config} {drive}: colors on the "
                                 f"card differ from the CPU's by {errs[-1]}")
    log(f"export {config}: colors on the card against the CPU, max abs err "
        f"{dict(zip((d for _, d in bench.EXPORT_DRIVES), errs))}")

    sub = state.replace(**{f.name: getattr(state, f.name)[::EXPORT_SUBSAMPLE]
                           for f in dataclasses.fields(state)})
    vp = bench.export_params(cfg, palettes.DRIVE_SPEED)
    a, b = (render(sub, vp, cam, width=240, height=135,
                   particle_radius=0.5 * cfg.h)
            for render in (splat.render_frame_host, splat.render_frame_plain))
    off = float((np.abs(a.astype(int) - b.astype(int)) > 2).any(
        axis=-1).mean())
    if not off < 0.02:
        raise AssertionError(f"export {config}: the rasterizer and its plain "
                             f"version differ on {off} of the pixels")
    log(f"export {config}: rasterizer against its plain version on "
        f"{int(sub.pos.shape[0])} rows at 240x135: {off!r} of the pixels off "
        f"by more than 2/255, {float((a != background).any(axis=-1).mean())!r}"
        f" drawn")
    return rec


def to_device(obj, dev):
    """A copy of a dataclass of tensors (state, params, buffers) on
    ``dev``; fields that are no tensors stay as they are."""
    import dataclasses

    import torch
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(dev)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def container_offset(state, params) -> float:
    """The farthest that ``project_shape`` would move a fluid row that it
    reports as a hit, in the container frame (0 when every row is
    inside)."""
    import torch
    from sph_tpu_torch.core.params import rotation_matrix
    from sph_tpu_torch.physics.constraints import project_shape

    fl = state.fluid_mask()
    local = ((state.pos[fl] - params.box_center)
             @ rotation_matrix(params.box_euler_deg))
    q, _, hit = project_shape(local, params.shape_type, params.box_half,
                              params.shape_aux)
    off = torch.linalg.vector_norm(q - local, dim=-1)
    return float(torch.where(hit, off, 0.0).max()) if local.shape[0] else 0.0


def phase_shapes(dev):
    """The cell engine (kernels) against the all-pairs oracle over 20
    substeps of a 2k spawn in each of the ten container shapes (at the
    half extents of ``SHAPE_HALVES``), realigned by orig_id; then no fluid
    row outside its container."""
    import numpy as np
    import torch
    from sph_tpu_torch.core import state as S
    from sph_tpu_torch.core.params import (SHAPE_NAMES, FluidParams,
                                           SimConfig, compute_grid_dims)
    from sph_tpu_torch.engine.step import SceneBuffers, run_substeps

    for shape, half in SHAPE_HALVES.items():
        name = SHAPE_NAMES[shape]
        spawn = S.spawn_standard(2048, box_half=half, shape_type=shape,
                                 seed=7)
        state = S.state_from_spawn(spawn, device=dev)
        params = FluidParams.default(
            device=dev, shape_type=shape,
            box_half=np.asarray(half, np.float32)).derive_mass()
        dims = compute_grid_dims(shape, half, (0.0, 0.0, 0.0), 0.28)
        outs = {}
        for impl in ("brute", "cell"):
            cfg = SimConfig(n=state.n, grid_dims=dims, neighbor_impl=impl)
            outs[impl], _ = run_substeps(state, params,
                                         SceneBuffers.create(cfg), params.dt,
                                         20, cfg)
        ref, got = outs["brute"], outs["cell"]
        v = ref.fluid_mask()
        order = torch.argsort(got.orig_id)
        errs = {f: max_err(getattr(got, f)[order][v], getattr(ref, f)[v])
                for f in ("pos", "vel", "density")}
        off = container_offset(got, params)
        log(f"shape {shape} ({name}, half {half}, grid {dims}): "
            f"{spawn.count} rows, cell kernels vs oracle over 20 substeps: "
            f"{errs}; farthest fluid row outside the container {off!r}")
        for f, lim in (("pos", 1e-4), ("vel", 1e-3), ("density", 1.0)):
            if not errs[f] < lim:
                raise AssertionError(f"shape {name}: {f} err {errs[f]} >= "
                                     f"{lim}")
        if not off <= 1e-4:
            raise AssertionError(f"shape {name}: a fluid row is {off} "
                                 f"outside the container")


def check_density(name, rho, ref) -> None:
    """The fluid density's max and mean within 2% and 0.5% of the JAX
    reference's ``ref`` = (max, mean); a max of None is not held."""
    got = (float(rho.max()), float(rho.double().mean()))
    log(f"{name}: fluid density max {got[0]!r}, mean {got[1]!r}; the JAX "
        f"reference's {ref}")
    for what, g, want, rtol in (("max", got[0], ref[0], 0.02),
                                ("mean", got[1], ref[1], 0.005)):
        if want is not None and not abs(g - want) <= rtol * want:
            raise AssertionError(f"{name}: fluid density {what} {g} is not "
                                 f"within {rtol} of the reference's {want}")


def phase_scene(dev, name):
    """A scene path of ``app/scene_paths.py``: ``build`` with no device
    (the card is the default), then FRAMES frames of ``frame``,
    with the cell engine's launches, the invariants, the rows the emitters
    respawned and the density against the JAX reference; then the
    stages' host-wait check; the cell kernels against their plain versions
    on the path's rows after the first frame and at the end.  Returns
    (launches, final state, params)."""
    import torch
    from sph_tpu_torch.app import scene_paths
    from sph_tpu_torch.core.device import card_line
    from sph_tpu_torch.engine.step import scene_stages
    from sph_tpu_torch.utils import trace

    torch.cuda.reset_peak_memory_stats(dev)
    scene = scene_paths.build(name)
    s, state, params, cfg, buffers = (scene.settings, scene.state,
                                      scene.params, scene.config,
                                      scene.buffers)
    if state.pos.device != dev or buffers.terrain.device != dev:
        raise AssertionError(f"{name}: built on {state.pos.device}, not on "
                             f"{dev}")
    n_fluid = int(state.fluid_mask().sum())
    log(f"scene {name}: shape {params.shape_type}, half "
        f"{list(s.box_half)}, {s.particle_count} asked, {n_fluid} spawned, "
        f"grid {cfg.grid_dims}, river {cfg.river_mode}, fountain "
        f"{cfg.fountain_mode}")
    dt = torch.tensor(s.time_step, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()

    since = trace.launches()
    for frame in range(FRAMES):
        if frame == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        n_sub = scene_paths.frame(frame, scene)
        state, params, buffers = scene.state, scene.params, scene.buffers
        if n_sub != FRAME_SUBSTEPS:
            raise AssertionError(f"{name}: frame {frame} ran {n_sub} "
                                 f"substeps, not {FRAME_SUBSTEPS}")
        if frame == 0:
            if name in REF_RHO_FIRST_FRAME:
                check_density(f"{name} after the first frame",
                              state.density[state.fluid_mask()],
                              REF_RHO_FIRST_FRAME[name])
            # the first frame's launches are the path's; those of the
            # comparison that follows are not
            first = trace.launches(since)
            check_scene_kernels(f"{name} after the first frame", state,
                                params, cfg, dt)
            since = trace.launches()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    later = trace.launches(since)
    counts = {k: first.get(k, 0) + later.get(k, 0) for k in {*first, *later}}

    total = FRAMES * FRAME_SUBSTEPS
    expect = dict.fromkeys(counts, 0)
    expect.update(cell_table=total, density=total, force_xsph=total,
                  container=total)
    if counts != expect:
        raise AssertionError(f"{name}: launches {counts} in {total} "
                             f"substeps, expected {expect}")
    fl = state.fluid_mask()
    pos, vel, rho = state.pos[fl], state.vel[fl], state.density[fl]
    if pos.shape[0] != n_fluid:
        raise AssertionError(f"{pos.shape[0]} fluid rows, expected {n_fluid}")
    for f, t in (("pos", state.pos), ("vel", state.vel),
                 ("density", state.density)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: non-finite {f}")
    rho0 = float(params.rest_density)
    rho_min, rho_max = float(rho.min()), float(rho.max())
    rho_mean = float(rho.double().mean())
    vmax = float(torch.linalg.vector_norm(vel, dim=-1).max())
    recycled = int(buffers.recycled)
    log(f"scene {name}: {FRAMES} frames of {FRAME_SUBSTEPS} substeps, "
        f"launches {counts}; density range [{rho_min!r}, {rho_max!r}], mean "
        f"{rho_mean!r}, max |v| {vmax!r}; {recycled} rows respawned by the "
        f"emitters")
    if not rho_min >= 0.5 * rho0 - 1e-3:
        raise AssertionError(f"{name}: density {rho_min} below the floor")
    # the solve caps the speed at 0.4 h / dt; in river mode the channel's
    # flow gravity adds river_flow_gravity * dt after it
    cap = 0.4 * float(params.h) / s.time_step * (1 + 1e-4)
    if cfg.river_mode:
        cap += float(params.river_flow_gravity) * s.time_step
    if not vmax <= cap:
        raise AssertionError(f"{name}: speed {vmax} above the CFL cap {cap}")
    if cfg.river_mode or cfg.fountain_mode:
        if not recycled > 0:
            raise AssertionError(f"{name}: the emitters respawned no row")
    elif recycled:
        raise AssertionError(f"{name}: {recycled} rows respawned without "
                             f"an emitter")
    check_contained(name, state, params, cfg.river_mode)
    timed_sub = total - FRAME_SUBSTEPS
    log(f"scene {name}: {wall / timed_sub * 1e3!r} ms/substep (host clock "
        f"over {timed_sub} substeps and their frames' reactions, after a "
        f"frame of warm-up); peak device memory "
        f"{torch.cuda.max_memory_allocated(dev)} bytes (build and run) on "
        f"{card_line()}")
    if cfg.river_mode or cfg.fountain_mode:
        # the stages after the solve, with the scene's buffers on the card
        check_no_host_wait(
            f"{name}: {'river' if cfg.river_mode else 'fountain'} stages",
            lambda st, b: scene_stages(st, params, b, params.dt, cfg), state,
            buffers)
    check_density(name, rho, REF_RHO[name])
    check_scene_kernels(f"{name} final", state, params, cfg, dt)
    return counts, scene


def check_contained(name, state, params, river) -> None:
    """Every fluid row inside its container; in river mode, where
    stream_emit is the last stage, inside the box and no row left below
    the sink or past it."""
    from sph_tpu_torch.core.params import rotation_matrix

    if river:
        pos = state.pos[state.fluid_mask()]
        local = ((pos - params.box_center)
                 @ rotation_matrix(params.box_euler_deg))
        if not bool((local.abs() <= params.box_half + 1e-4).all()):
            raise AssertionError(f"{name}: a fluid particle left the box")
        if not (bool((pos[:, 1] >= params.river_sink_y).all())
                and bool((pos[:, 2] <= params.river_sink_z_max).all())):
            raise AssertionError(f"{name}: a fluid row below the sink or "
                                 f"past it")
    else:
        off = container_offset(state, params)
        if not off <= 1e-4:
            raise AssertionError(f"{name}: a fluid row is {off} outside the "
                                 f"container")


def check_scene_kernels(label, state, params, cfg, dt) -> None:
    """The three cell kernels against their plain versions on a scene
    path's own rows (``check_cell_kernels``), with the sweep params that
    the frame's ``run_substeps`` builds from ``params`` and ``dt``."""
    from sph_tpu_torch.neighbors import cells, sweeps

    skey, _ = cells.fluid_sort(state, params, cfg.grid_dims)
    skey = skey[skey < cfg.num_cells]
    log(f"{label}: {int(skey.shape[0])} fluid rows, the fullest cell holds "
        f"{int(skey.bincount().max())} rows")
    check_cell_kernels(label, state, params, cfg,
                       *sweeps.prepare(state, params, dt, cfg))


def phase_impulses(dev, state, params):
    """The four impulses that no bench configuration drives, on ``state``
    (a scene path's final state) on the card and on the CPU, within
    IMPULSE_ATOL, each timed on the card."""
    import numpy as np
    import torch
    from sph_tpu_torch.app.microbench import time_ms
    from sph_tpu_torch.physics import impulses as I

    host_state, host_params = to_device(state, "cpu"), to_device(params,
                                                                   "cpu")
    targets = np.random.default_rng(0).uniform(
        -6.0, 6.0, (STENCIL_TARGETS, 3)).astype(np.float32)
    point = params.box_center.cpu().numpy() + np.float32([0.0, 2.0, 0.0])
    # the kicks of a frame, dt-premultiplied as drive_audio_reaction does
    calls = {
        "vortex": lambda st, p, t: I.vortex_impulse(st, p, 6.8 / 60,
                                                    1.0 / 60),
        "attractor": lambda st, p, t: I.attractor_impulse(st, point,
                                                          8.0 / 60, 6.0),
        "curl_flow": lambda st, p, t: I.curl_flow(st, 3.0 / 60, 0.15, 0.3),
        "stencil": lambda st, p, t: I.stencil_attract(
            st, t, STENCIL_TARGETS, 6.0 / 60, 2.0 / 60),
    }
    for name, fn in calls.items():
        card_t = torch.as_tensor(targets, device=dev)
        card = fn(state, params, card_t).vel
        host = fn(host_state, host_params, torch.as_tensor(targets)).vel
        if card.device != dev:
            raise AssertionError(f"{name} ran on {card.device}")
        err = max_err(card.cpu(), host)
        moved = int((card != state.vel).any(-1).sum())
        ms = time_ms(lambda: fn(state, params, card_t))
        log(f"impulse {name}: card against CPU max abs err {err!r} on "
            f"{state.n} rows ({moved} moved), {ms!r} ms on the card")
        if not (err <= IMPULSE_ATOL and moved > 0):
            raise AssertionError(f"impulse {name}: err {err}, {moved} rows "
                                 f"moved")


# phase "reel": the music-synced reel of app.main at the default scene
REEL_FRAMES = 8
REEL_FPS = 30
REEL_RATE = 48000            # Hz, the track's sample rate
REEL_W, REEL_H = 1080, 1920  # scene/reel.py's default frame
# the reel caps a frame at ceil((1/30 s) / 1 ms) = 34 substeps; the scene's
# fixed-dt accumulator runs 33 or 34 of them (33.3 a frame on average)
REEL_SUBSTEP_CAP = 34
REEL_ROWS = 50000            # the default scene's asked rows
# frames of one state on the card and on the CPU: at most REEL_CPU_SHARE of
# the pixels with a channel more than 1/255 apart.  The card's exp and pow
# can round otherwise than the CPU's by an ulp, which can flip a threshold
# of the water's passes at a pixel and move that pixel far
# (``trace_water`` finds the pass); the reel's last frame has shown 22 such
# pixels of 2,073,600 (share 1.1e-5) on an H100, so the limit is about ten
# times that
REEL_CPU_SHARE = 1e-4
# every post effect of phase "looks", with DOF from render mode 1's depth
LOOK_POST = dict(bloom_strength=0.8, streak_strength=0.6,
                 trail_half_life=0.4, kaleido_segments=6, chromatic=2.0,
                 vignette=0.5, grain=0.1, lens_aperture=3.0,
                 lens_focus_dist=22.0, show_outline=True)


def write_track(path) -> str:
    """REEL_FRAMES frames of 16-bit mono at REEL_RATE: a 55 Hz bass tone
    that hits four times louder from the third frame on, and a 5 kHz
    treble tone."""
    import numpy as np
    from scipy.io import wavfile

    n = REEL_FRAMES * REEL_RATE // REEL_FPS
    t = np.arange(n) / REEL_RATE
    bass = 0.2 * np.sin(2 * np.pi * 55.0 * t)
    bass[2 * REEL_RATE // REEL_FPS:] *= 4.0
    sig = bass + 0.1 * np.sin(2 * np.pi * 5000.0 * t)
    wavfile.write(path, REEL_RATE,
                  (np.clip(sig, -1, 1) * 32767).astype(np.int16))
    return path


class Split:
    """Seconds a frame of the reel, by part: ``update`` (CUDA events around
    Scene.update), ``splat`` (host clock around the water's column copy and
    its host splat), ``smooth`` and ``composite`` (host clock, synchronised,
    around the smoothing, and around the background and the composite),
    ``outline`` (the wireframe drawn on the host) and ``png``."""

    def __init__(self):
        self.parts = {k: [] for k in ("update", "splat", "smooth",
                                      "composite", "outline", "png")}
        self.events = []
        self.starts = []
        self.substeps = []

    def host(self, part, fn, sync=False):
        import torch

        def wrapped(*args, **kw):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if sync:
                torch.cuda.synchronize()
            self.parts[part].append(time.perf_counter() - t0)
            return out
        return wrapped

    def update(self, fn):
        import torch

        def wrapped(scene, *args, **kw):
            self.starts.append(time.perf_counter())
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            n = fn(scene, *args, **kw)
            stop.record()
            self.events.append((start, stop))
            self.substeps.append(n)
            return n
        return wrapped

    def per_frame(self, end: float) -> dict:
        """Each part's seconds summed over a frame, one list a part, and
        each frame's wall seconds (from its update to the next frame's, the
        last to ``end``) under ``frame``."""
        import torch
        torch.cuda.synchronize()
        out = {"update": [a.elapsed_time(b) / 1e3 for a, b in self.events]}
        # render_water calls state_columns and splat_depth_thickness, and
        # render_background and composite, once each a frame
        for part, calls in (("splat", 2), ("smooth", 1), ("composite", 2),
                            ("outline", 1), ("png", 1)):
            xs = self.parts[part]
            if len(xs) != REEL_FRAMES * calls:
                raise AssertionError(
                    f"reel split: {len(xs)} timed calls of {part}, expected "
                    f"{calls} in each of {REEL_FRAMES} frames")
            out[part] = [sum(xs[i:i + calls]) for i in range(0, len(xs),
                                                              calls)]
        if len(out["update"]) != REEL_FRAMES:
            raise AssertionError(f"reel split: {len(out['update'])} updates")
        out["frame"] = [b - a for a, b in zip(self.starts,
                                              self.starts[1:] + [end])]
        return out


def count_syncs(fn):
    """(result, synchronising CUDA calls by the source line that made them)
    of ``fn()`` under torch's synchronisation check in its warning mode."""
    import collections
    import os
    import warnings

    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))


def scene_copy(scene, dev):
    """A copy of ``scene`` on ``dev``: its state, params and buffers moved
    there (or shared, on their own device), its settings, phases, live
    values and camera copied, its post chain's history dropped."""
    import copy
    import dataclasses

    import torch
    out = copy.copy(scene)
    out.device = torch.device(dev)
    out.state = to_device(scene.state, dev)
    out.params = to_device(scene.params, dev)
    out.buffers = to_device(scene.buffers, dev)
    out.settings = copy.deepcopy(scene.settings)
    out.phases = dataclasses.replace(scene.phases)
    out.live = dataclasses.replace(scene.live)
    out.camera = copy.deepcopy(scene.camera)
    out.post_state = None
    return out


def frames_close(label, card, host, trace=None) -> dict:
    """Hold a card frame to the CPU frame of the same state: at most
    REEL_CPU_SHARE of the pixels with a channel more than 1/255 apart;
    return the differences.  ``trace``, if given, is called with the
    pixels apart ([H, W] bool) before the check."""
    import numpy as np
    if card.shape != host.shape or card.dtype != np.uint8:
        raise AssertionError(f"{label}: card frame {card.shape} "
                             f"{card.dtype}, CPU frame {host.shape}")
    diff = np.abs(card.astype(int) - host.astype(int))
    far = (diff > 1).any(-1)
    off = float(far.mean())
    out = {"max_abs_diff": int(diff.max()), "share_off": off}
    log(f"{label}: card frame against the CPU frame of the same state: max "
        f"channel difference {out['max_abs_diff']}/255, {int(far.sum())} "
        f"pixels (share {off!r}) more than 1/255 apart")
    if trace is not None:
        trace(far)
    if off > REEL_CPU_SHARE:
        raise AssertionError(f"{label}: card and CPU frames differ ({out})")
    if not (card != card[0, 0]).any():
        raise AssertionError(f"{label}: the frame is uniform")
    return out


def trace_water(scene, dev, off, w=REEL_W, h=REEL_H,
                label="reel last frame") -> dict:
    """Trace the pixels ``off`` ([h, w] bool) where the card's water frame
    of ``scene`` and the CPU's differ to the pass where they part: pass 1,
    the splat, runs once on the host; the smoothing runs on the card and
    on the CPU from that splat; the composite runs on the card and on the
    CPU from the card's smoothed depth.  Logs and returns the counts."""
    import numpy as np
    import torch
    from sph_tpu_torch.scene.settings import to_viz_params, to_water_params
    from sph_tpu_torch.viz import ssfr

    s = scene.settings
    wp = to_water_params(s)
    vp = to_viz_params(s, anim_time=scene.phases.anim_time,
                       hue_shift_live=scene.live.hue_shift_deg,
                       bright_mul_live=scene.live.bright_mul)
    cam = scene._camera_now()
    view, proj = cam.view_matrix(), cam.proj_matrix(w / h)
    r = 0.5 * s.h * scene.live.radius_scale * wp.radius_scale
    cols = ssfr.state_columns(scene.state)
    draw = (cols[:, 4] > 0) & (cols[:, 5] == 0)
    splat = ssfr.splat_depth_thickness(cols[:, :3], cols[:, 3], view, proj,
                                       w, h, r, mask=draw)
    scale = float(proj[1, 1]) * h * 0.5
    smooth = {d: ssfr.smooth_depth(torch.as_tensor(splat[0], device=d),
                                   wp.smooth_iterations, r, scale, wp)
              for d in (dev, "cpu")}
    dz = np.abs(smooth[dev].cpu().numpy() - smooth["cpu"].numpy())
    frames = {}
    for d in (dev, "cpu"):
        depth, thick, foam = (torch.as_tensor(a, device=d) for a in (
            smooth[dev].cpu().numpy(), splat[1], splat[2]))
        bg = ssfr.render_background(w, h, view, proj, wp, device=d)
        img = ssfr.composite(depth, thick, foam, bg, view, (h, w),
                             float(proj[0, 0]), float(proj[1, 1]), wp, vp)
        frames[d] = (torch.clamp(img, 0.0, 1.0) * 255.0).to(
            torch.uint8).cpu().numpy().astype(int)
    shade = (np.abs(frames[dev] - frames["cpu"]) > 1).any(-1)
    # a pixel's normal reads its four neighbours' depths
    moved = dz > 1e-4
    near = moved.copy()
    for axis in (0, 1):
        for step in (-1, 1):
            near |= np.roll(moved, step, axis=axis)
    out = {"depth_differs": int((dz > 0).sum()),
           "depth_differs_1e-4": int(moved.sum()),
           "depth_max_diff": float(dz.max()),
           "composite_off": int(shade.sum()),
           "off": int(off.sum()),
           "off_by_depth": int((off & near).sum()),
           "off_by_composite": int((off & shade).sum())}
    log(f"{label}, traced by pass: the smoothed depth differs "
        f"between card and CPU at {out['depth_differs']} pixels, by more "
        f"than 1e-4 at {out['depth_differs_1e-4']} (max "
        f"{out['depth_max_diff']!r}); the composite from one smoothed depth puts {out['composite_off']} "
        f"pixels more than 1/255 apart; of the frame's {out['off']} pixels "
        f"apart, {out['off_by_depth']} lie on or beside a depth that moved "
        f"more than 1e-4 and {out['off_by_composite']} are apart in the "
        f"composite alone")
    return out


def phase_reel(dev):
    """``app.main.main(["reel", ...])`` with no device argument on the
    default scene: the frames and the mux script written, the cell
    engine's launches, the final state inside its container, the cell
    kernels against their plain versions on it, the last frame rendered
    again on the CPU from the same state, and the seconds of a frame split
    four ways.  Returns (launches, scene)."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_reel_") as tmp:
        return reel_in(dev, tmp)


def reel_in(dev, tmp):
    """:func:`phase_reel` with its files in the directory ``tmp``."""
    import contextlib
    import io
    import os

    import torch
    from sph_tpu_torch.app import main as app_main
    from sph_tpu_torch.core.device import card_line
    from sph_tpu_torch.engine.step import substeps_for_frame
    from sph_tpu_torch.scene import reel
    from sph_tpu_torch.scene import scene as scene_mod
    from sph_tpu_torch.utils import trace
    from sph_tpu_torch.viz import ssfr, splat

    wav = write_track(os.path.join(tmp, "track.wav"))
    out_dir = os.path.join(tmp, "frames")
    split, grabbed = Split(), {}
    patched = [(ssfr, "state_columns"), (ssfr, "splat_depth_thickness"),
               (ssfr, "smooth_depth"), (ssfr, "render_background"),
               (ssfr, "composite"), (reel, "save_png"),
               (reel, "export_reel"), (scene_mod.Scene, "update"),
               (scene_mod.Scene, "_overlay_lines")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in patched]
    export = reel.export_reel

    def grab(scene, cfg, **kw):
        grabbed["scene"] = scene
        return export(scene, cfg, **kw)

    ssfr.state_columns = split.host("splat", ssfr.state_columns)
    ssfr.splat_depth_thickness = split.host("splat",
                                            ssfr.splat_depth_thickness)
    for part, name in (("smooth", "smooth_depth"),
                       ("composite", "render_background"),
                       ("composite", "composite")):
        setattr(ssfr, name, split.host(part, getattr(ssfr, name), sync=True))
    scene_mod.Scene._overlay_lines = split.host(
        "outline", scene_mod.Scene._overlay_lines)
    reel.save_png = split.host("png", reel.save_png)
    reel.export_reel = grab
    scene_mod.Scene.update = split.update(scene_mod.Scene.update)
    torch.cuda.reset_peak_memory_stats(dev)
    since = trace.launches()
    t0 = time.perf_counter()
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            app_main.main(["reel", "--track", wav, "--out", out_dir])
        torch.cuda.synchronize()
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    end = time.perf_counter()
    wall = end - t0
    counts = trace.launches(since)
    log(f"reel: the entry point printed {printed.getvalue().strip()}")
    scene = grabbed["scene"]
    s = scene.settings
    if scene.state.pos.device != dev:
        raise AssertionError(f"reel: the scene is on {scene.state.pos.device}")
    if (s.particle_count, s.render_mode, scene.config.neighbor_impl) != (
            REEL_ROWS, 0, "cell"):
        raise AssertionError(f"reel: not the default scene ({s.particle_count}"
                             f" rows, render mode {s.render_mode}, "
                             f"{scene.config.neighbor_impl})")
    expect_sub, acc = [], 0.0
    for _ in range(REEL_FRAMES):
        n, acc = substeps_for_frame(1.0 / REEL_FPS, s.time_step,
                                    REEL_SUBSTEP_CAP, acc)
        expect_sub.append(n)
    if split.substeps != expect_sub:
        raise AssertionError(f"reel: substeps a frame {split.substeps}, "
                             f"expected {expect_sub}")
    names = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    if names != [f"frame_{f:05d}.png" for f in range(REEL_FRAMES)]:
        raise AssertionError(f"reel: frames written {names}")
    if not os.access(os.path.join(out_dir, "mux_reel.sh"), os.X_OK):
        raise AssertionError("reel: no mux script")
    for name in names:
        img = splat.read_png(os.path.join(out_dir, name))
        if img.shape != (REEL_H, REEL_W, 3) or not (img != img[0, 0]).any():
            raise AssertionError(f"reel: {name} is {img.shape}, or uniform")
    total = sum(expect_sub)
    expect = dict.fromkeys(counts, 0)
    expect.update(cell_table=total, density=total, force_xsph=total,
                  container=total)
    if counts != expect:
        raise AssertionError(f"reel: launches {counts}, expected {expect}")
    state, params = scene.state, scene.params
    fl = state.fluid_mask()
    for f in ("pos", "vel", "density"):
        if not bool(torch.isfinite(getattr(state, f)[fl]).all()):
            raise AssertionError(f"reel: non-finite {f}")
    off = container_offset(state, params)
    if not off <= 1e-4:
        raise AssertionError(f"reel: a fluid row is {off} outside the "
                             f"container")
    dt = torch.tensor(s.time_step, dtype=torch.float32, device=dev)
    check_scene_kernels("reel final", state, params, scene.config, dt)

    per = split.per_frame(end)
    frame_s = wall / REEL_FRAMES
    log(f"reel: {REEL_FRAMES} frames at {REEL_W}x{REEL_H} of "
        f"{int(fl.sum())} fluid rows, substeps by frame {expect_sub}, "
        f"launches {counts}; {wall!r} s in all ({frame_s!r} s a frame, the "
        f"first frame's warm-up included); peak device memory "
        f"{torch.cuda.max_memory_allocated(dev)} bytes, on {card_line()}")
    per["device"] = [a + b for a, b in zip(per["smooth"], per["composite"])]
    per["other"] = [frame - sum(parts) for frame, *parts in zip(
        per["frame"], per["update"], per["splat"], per["device"],
        per["outline"], per["png"])]
    for part, xs in per.items():
        log(f"reel: {part} seconds by frame {xs!r}; mean of frames 2-"
            f"{REEL_FRAMES} {sum(xs[1:]) / len(xs[1:])!r}")
    log("reel: the four parts are update, splat, device (smooth + "
        "composite) and png; other = the frame's seconds less them and the "
        "outline (the frame's copy to the host, the reaction's and the "
        "reel's host work)")

    # the last frame again, rendered on the CPU from the same state
    cpu = scene_copy(scene, "cpu")
    t0 = time.perf_counter()
    host = cpu.render(REEL_W, REEL_H)
    log(f"reel: the last frame on the CPU took {time.perf_counter() - t0!r}"
        f" s")
    frames_close("reel last frame", splat.read_png(os.path.join(
        out_dir, names[-1])), host,
        trace=lambda far: trace_water(scene, dev, far))
    return counts, scene


def reel_syncs(scene) -> None:
    """The synchronising CUDA calls of one more frame of ``scene``
    (update, render, PNG), logged."""
    import os
    import tempfile

    from sph_tpu_torch.viz import splat
    n_sub, syncs_update = count_syncs(lambda: scene.update(
        1.0 / REEL_FPS, bands=(0.5, 0.2, 0.1), max_substeps=REEL_SUBSTEP_CAP))
    img, syncs_render = count_syncs(lambda: scene.render(REEL_W, REEL_H))
    with tempfile.TemporaryDirectory() as tmp:
        _, syncs_png = count_syncs(lambda: splat.save_png(
            img, os.path.join(tmp, "frame.png")))
    log(f"reel: synchronising CUDA calls of a frame (torch's "
        f"synchronisation check in its warning mode): update "
        f"{sum(syncs_update.values())} ({n_sub} substeps), render "
        f"{sum(syncs_render.values())}, PNG {sum(syncs_png.values())}")
    for part, where in (("update", syncs_update), ("render", syncs_render)):
        log(f"reel: the {part}'s synchronising calls by source line "
            f"{dict(where.most_common())}")
    check_syncs("reel: update", syncs_update, n_sub)


def phase_looks(dev, scene):
    """On the reel's final state at REEL_WxREEL_H: render mode 1 with the
    outline and every post effect (DOF from its depth), render mode 2 (the
    instanced icosphere meshes through the host triangle rasterizer), and a
    river scene's terrain pass under render mode 1; each card frame held to
    the CPU frame of the same state, each timed."""
    import dataclasses

    import torch
    for name, look, river in (
            ("impostors + post", dict(render_mode=1, **LOOK_POST), False),
            ("meshes", dict(render_mode=2, show_outline=True), False),
            ("river terrain", dict(render_mode=1, show_outline=True), True)):
        card = scene_copy(scene, dev)
        card.settings = dataclasses.replace(card.settings, **look)
        if river:
            card.enable_river(0)
        host = scene_copy(card, "cpu")
        times = []
        for _ in range(2):
            card.post_state = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = card.render(REEL_W, REEL_H)
            times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ref = host.render(REEL_W, REEL_H)
        host_s = time.perf_counter() - t0
        log(f"look {name}: {REEL_W}x{REEL_H} on the card {times!r} s (first"
            f" call, second call), on the CPU {host_s!r} s")
        frames_close(f"look {name}", img, ref)


def phase_gallery(dev):
    """``app.gallery.main([<dir>])`` with no device argument: the five
    stills written at the gallery's own size and read back, the cell
    engine's launches against the substeps of each look's settle, each
    look's captures, its fluid rows finite and inside their container,
    the three cell kernels held to their plain versions on its final rows
    (``check_scene_kernels``), and its still held to the CPU frame of its
    final state.  Returns the launches."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gallery_") as tmp:
        return gallery_in(dev, tmp)


def gallery_in(dev, tmp):
    """:func:`phase_gallery` with its files in the directory ``tmp``."""
    import contextlib
    import io

    import torch
    from sph_tpu_torch.app import gallery
    from sph_tpu_torch.core.device import card_line
    from sph_tpu_torch.utils import trace
    from sph_tpu_torch.viz import splat

    # main calls settle, then shot (frame, then save_png), look by look in
    # LOOKS' order: each wrapper appends one record a look
    settles, renders, pngs = [], [], []
    settle, frame, save_png = gallery.settle, gallery.frame, gallery.save_png

    def timed_settle(scene, frames=30):
        before, captures = trace.launches(), trace.counter("graph.captures")
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        subs = settle(scene, frames)
        stop.record()
        settles.append(dict(substeps=subs, events=(start, stop),
                            captures=trace.counter("graph.captures")
                            - captures,
                            launches=trace.launches(before)))
        return subs

    def timed_frame(scene, zoom=1.0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = frame(scene, zoom)
        renders.append(time.perf_counter() - t0)
        return img

    def timed_save(img, path):
        t0 = time.perf_counter()
        save_png(img, path)
        pngs.append(time.perf_counter() - t0)

    gallery.settle, gallery.frame, gallery.save_png = (
        timed_settle, timed_frame, timed_save)
    since = trace.launches()
    t0 = time.perf_counter()
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            shots = gallery.main([tmp])
        torch.cuda.synchronize()
    finally:
        gallery.settle, gallery.frame, gallery.save_png = (
            settle, frame, save_png)
    wall = time.perf_counter() - t0
    counts = trace.launches(since)
    log(f"gallery: the entry point printed {printed.getvalue().split()}")
    if [name for name, _, _ in shots] != list(gallery.LOOKS) or not (
            len(settles) == len(renders) == len(pngs) == len(shots)):
        raise AssertionError(f"gallery: looks {[n for n, _, _ in shots]}, "
                             f"{len(settles)} settles, {len(renders)} "
                             f"renders, {len(pngs)} PNGs")
    total = 0
    for (name, scene, path), rec, render_s, png_s in zip(
            shots, settles, renders, pngs):
        look, s = gallery.LOOKS[name], scene.settings
        state, params = scene.state, scene.params
        if state.pos.device != dev or scene.config.neighbor_impl != "cell":
            raise AssertionError(f"gallery {name}: on {state.pos.device}, "
                                 f"engine {scene.config.neighbor_impl}")
        subs = rec["substeps"]
        n_sub = sum(subs)
        total += n_sub
        expect = dict.fromkeys(rec["launches"], 0)
        expect.update(cell_table=n_sub, density=n_sub, force_xsph=n_sub,
                      container=n_sub)
        if len(subs) != look.frames or rec["launches"] != expect:
            raise AssertionError(f"gallery {name}: {len(subs)} frames, "
                                 f"launches {rec['launches']}, expected "
                                 f"{expect}")
        # at most one program a substep count (a look whose rows and
        # SimConfig are an earlier look's replays that look's program): no
        # look may capture every frame
        if not rec["captures"] <= len(set(subs)) < look.frames:
            raise AssertionError(f"gallery {name}: {rec['captures']} "
                                 f"captures over substeps {subs}")
        img = splat.read_png(path)
        if img.shape != (gallery.H, gallery.W, 3) or not (
                img != img[0, 0]).any():
            raise AssertionError(f"gallery {name}: {img.shape}, or uniform")
        fl = state.fluid_mask()
        for f in ("pos", "vel", "density"):
            if not bool(torch.isfinite(getattr(state, f)[fl]).all()):
                raise AssertionError(f"gallery {name}: non-finite {f}")
        check_contained(f"gallery {name}", state, params,
                        scene.config.river_mode)
        settle_s = rec["events"][0].elapsed_time(rec["events"][1]) / 1e3
        # the final state on the CPU, shot at the look's zoom
        cpu = scene_copy(scene, "cpu")
        t1 = time.perf_counter()
        host = gallery.frame(cpu, look.zoom)
        host_s = time.perf_counter() - t1

        def trace_far(far, scene=scene, look=look, name=name):
            if far.any() and scene.settings.render_mode == 0:
                zoomed = scene_copy(scene, dev)
                zoomed.camera.distance *= look.zoom
                trace_water(zoomed, dev, far, w=gallery.W, h=gallery.H,
                            label=f"gallery {name}")
        close = frames_close(f"gallery {name}", img, host,
                             trace=trace_far)
        # the three kernels on the look's final rows (after ``counts``, so
        # these launches are not the gallery's)
        dt = torch.tensor(s.time_step, dtype=torch.float32, device=dev)
        check_scene_kernels(f"gallery {name} final", state, params,
                            scene.config, dt)
        log(f"gallery {name}: {int(fl.sum())} fluid rows ({s.particle_count}"
            f" asked), shape {s.shape_type}, river "
            f"{scene.config.river_mode}; settle {look.frames} frames, "
            f"{n_sub} substeps, {settle_s!r} s (CUDA events), "
            f"{rec['captures']} captured; render {render_s!r} s, PNG "
            f"{png_s!r} s (host clock); the CPU's frame {host_s!r} s; "
            f"card against CPU {close}; launches {rec['launches']}, on "
            f"{card_line()}")
    expect = dict.fromkeys(counts, 0)
    expect.update(cell_table=total, density=total, force_xsph=total,
                  container=total)
    # each impostor still is composed on the card: two splat launches
    impostors = sum(scene.settings.render_mode == 1 for _, scene, _ in shots)
    if impostors:
        expect["splat"] = 2 * impostors
    if counts != expect:
        raise AssertionError(f"gallery: launches {counts}, expected {expect}")
    log(f"gallery: {len(shots)} stills at {gallery.W}x{gallery.H}, {total} "
        f"substeps, {sum(r['captures'] for r in settles)} captures, launches "
        f"{counts}; {wall!r} s from main's call to its return, on "
        f"{card_line()}")
    return counts


# phase "parallel": the multi-rank engines of sph_tpu_torch/parallel
PARALLEL_RANKS = 4
# the slab engine against one device (sph_tpu/parallel/dryrun.py:82 and
# ROADMAP's tolerances), and the gather engine (tests/test_parallel.py:33-36)
SLAB_TOL = {"pos": 1e-4, "vel": 1e-3, "density": 1.0}
GATHER_TOL = {"pos": 1e-5, "density": 0.1}
SLAB_SUBSTEPS = 5            # the slab engine held to the tolerances here
ROUTER_SUBSTEPS = 2          # the router held to the tolerances here
GATHER_SUBSTEPS = 5
PARALLEL_RHO_RTOL = 0.02     # the density's max and mean after a frame


def by_orig_id(state, fields=("pos", "vel", "acc", "density", "pressure",
                              "foam", "ghost", "orig_id")):
    """The valid rows of a port state or of a numpy dict (``parallel.run``'s
    checkpoints), ordered by orig_id, as numpy by field."""
    import numpy as np
    d = state if isinstance(state, dict) else {
        f: getattr(state, f).cpu().numpy() for f in (*fields, "valid")}
    v = np.asarray(d["valid"]) > 0
    o = np.argsort(np.asarray(d["orig_id"])[v], kind="stable")
    return {f: np.asarray(d[f])[v][o] for f in fields}


def held(label, got, want, tol) -> dict:
    """``got`` against ``want`` (``by_orig_id``): the same rows, no NaN,
    each field of ``tol`` within it.  Returns the errors."""
    import numpy as np
    if not np.array_equal(got["orig_id"], want["orig_id"]):
        raise AssertionError(f"{label}: rows lost or duplicated "
                             f"({len(got['orig_id'])} against "
                             f"{len(want['orig_id'])})")
    errs = {}
    for f, lim in tol.items():
        if not np.isfinite(got[f]).all():
            raise AssertionError(f"{label}: non-finite {f}")
        errs[f] = float(np.abs(got[f] - want[f]).max())
        if not errs[f] < lim:
            raise AssertionError(f"{label}: {f} err {errs[f]} >= {lim}")
    log(f"{label}: {len(got['orig_id'])} rows, errors {errs}")
    return errs


def cuda_ms(fn) -> tuple:
    """(fn()'s result, its ms by CUDA events)."""
    import torch
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1)


def parallel_one_rank(dev, tmp, warm, params, cfg, ref):
    """(a): the slab engine on one NCCL rank in this process, a frame of
    FRAME_SUBSTEPS from ``warm`` (after one untimed frame of its own from
    the same state), against ``ref`` (the cell engine's frame from the same
    state, after the warm-up frame that made ``warm``).  Returns its
    launches in the timed frame."""
    import numpy as np
    from sph_tpu_torch.engine.step import substep
    from sph_tpu_torch.parallel import group as G, slabs
    from sph_tpu_torch.utils import trace

    group = G.init(0, 1, "nccl", f"file://{tmp}/rendezvous_one", device=dev)
    try:
        scfg = slabs.make_slab_config(cfg, 1)
        st = slabs.shard_by_slab(warm, params, scfg, 0)
        dt = params.dt
        aux = slabs.prepare(st, params, dt, scfg, group)

        def frame():
            out, b = st, ref[1]
            for _ in range(FRAME_SUBSTEPS):
                out, b = slabs.substep(out, params, b, dt, cfg, scfg, group,
                                       aux)
            return out

        frame()     # the path's warm-up frame (NCCL's first calls)
        since = trace.launches()
        waits = group.waits
        out, ms = cuda_ms(frame)
        counts = trace.launches(since)
        frame_waits = (group.waits - waits) / FRAME_SUBSTEPS
        _, syncs = count_syncs(lambda: slabs.substep(
            st, params, ref[1], dt, cfg, scfg, group, aux))
        whole = slabs.gather_global(out, group)
    finally:
        G.close()
    got, want = by_orig_id(whole), by_orig_id(ref[0])
    same = all(np.array_equal(got[f], want[f]) for f in got)
    errs = held("parallel (a) one NCCL rank, ghost_1m, a frame against the "
                "cell engine", got, want, SLAB_TOL)
    expect = dict.fromkeys(("cell_table", "density", "force_xsph"),
                           FRAME_SUBSTEPS)
    if {k: counts.get(k, 0) for k in expect} != expect:
        raise AssertionError(f"parallel (a): launches {counts}, expected "
                             f"{expect}")
    _, ref_syncs = count_syncs(lambda: substep(
        warm, params, ref[1], params.dt, cfg, aux=ref[2]))
    log(f"parallel (a): bit-identical to the cell engine: {same} (errors "
        f"{errs}); {ms / FRAME_SUBSTEPS!r} ms/substep (CUDA events) against "
        f"the cell engine's {ref[3] / FRAME_SUBSTEPS!r}; the group's host "
        f"waits a substep {frame_waits!r}; synchronising calls of one "
        f"substep {sum(syncs.values())} ({dict(syncs)}) against the cell "
        f"engine's {sum(ref_syncs.values())} ({dict(ref_syncs)}); "
        f"launches {counts}")
    return {k: counts.get(k, 0) for k in expect}


def parallel_jobs(dev, tmp, warm, params, cfg):
    """The inputs and jobs of the four-rank launch: (b) ``ghost_1m`` from
    ``warm``, (c) the fountain path through the router, (d) the gather
    engine at ``dam_break_8k``.  Returns (jobs, the single-device runs each
    is held to)."""
    import dataclasses

    from sph_tpu_torch.app import configs, scene_paths
    from sph_tpu_torch.core import convert
    from sph_tpu_torch.engine.step import SceneBuffers, run_substeps
    from sph_tpu_torch.parallel import run as R

    fountain = scene_paths.build("fountain_50k")
    dam, dam_params, dam_cfg = configs.build("dam_break_8k")
    dam_cfg = dataclasses.replace(dam_cfg, neighbor_impl="brute")
    cases = {
        "ghost_1m": ("slab", warm, params, cfg, SceneBuffers.create(cfg, dev),
                     [SLAB_SUBSTEPS, FRAME_SUBSTEPS]),
        "fountain_50k": ("slab", fountain.state, fountain.params,
                         fountain.config, fountain.buffers,
                         [ROUTER_SUBSTEPS, FRAME_SUBSTEPS]),
        "dam_break_8k": ("gather", dam, dam_params, dam_cfg,
                         SceneBuffers.create(dam_cfg, dev), [GATHER_SUBSTEPS]),
    }
    jobs, refs = [], {}
    for name, (engine, st, prm, c, buf, ckpts) in cases.items():
        path = R.save_input(f"{tmp}/{name}.npz", convert.to_numpy(st),
                            convert.to_numpy(prm), convert.to_numpy(buf))
        jobs.append({"name": name, "engine": engine, "input": path,
                     "config": dataclasses.asdict(c), "checkpoints": ckpts})
        refs[name], done, b = {}, st, buf
        last = 0
        for k in ckpts:
            done, b = run_substeps(done, prm, b, prm.dt, k - last, c)
            refs[name][k] = (by_orig_id(done), int(b.recycled))
            last = k
    return jobs, refs


def phase_parallel(dev):
    """The multi-rank engines (``sph_tpu_torch/parallel``) on the card:
    (a) one NCCL rank in this process; (b)-(d) one launch of
    PARALLEL_RANKS gloo rank processes sharing the card (four processes
    time-sharing one card: their times are no multi-GPU speed).  Returns
    the launches of #1-#3 on (a) and on each rank of (b)."""
    import json
    import tempfile

    import numpy as np
    from sph_tpu_torch.app import configs
    from sph_tpu_torch.engine.step import (SceneBuffers, neighbor_aux,
                                           run_substeps)
    from sph_tpu_torch.parallel import group as G, run as R

    start, params, cfg = configs.build("ghost_1m")
    buffers = SceneBuffers.create(cfg, dev)
    warm, _ = run_substeps(start, params, buffers, params.dt, FRAME_SUBSTEPS,
                           cfg)
    (ref, ref_buf), ref_ms = cuda_ms(lambda: run_substeps(
        warm, params, buffers, params.dt, FRAME_SUBSTEPS, cfg))
    aux = neighbor_aux(warm, params, params.dt, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        one = parallel_one_rank(dev, tmp, warm, params, cfg,
                                (ref, buffers, aux, ref_ms))
        jobs, refs = parallel_jobs(dev, tmp, warm, params, cfg)
        with open(f"{tmp}/jobs.json", "w") as f:
            json.dump(jobs, f)
        t0 = time.perf_counter()
        G.check(G.launch("sph_tpu_torch.parallel.run", PARALLEL_RANKS,
                         [f"{tmp}/jobs.json"], tmp, backend="gloo",
                         device="cuda", timeout=600))
        log(f"parallel (b)-(d): {PARALLEL_RANKS} gloo ranks on one card, "
            f"{time.perf_counter() - t0!r} s from launch to exit")
        out = {name: {k: R.read_state(f"{tmp}/{name}_{k}.npz")
                      for k in job["checkpoints"]}
               for name, job in zip(refs, jobs)}
        stats = {}
        for name in refs:
            stats[name] = []
            for r in range(PARALLEL_RANKS):
                with open(f"{tmp}/{name}_rank{r}.json") as f:
                    stats[name].append(json.load(f))

    for name, ranks in stats.items():
        for r, st in enumerate(ranks):
            log(f"parallel {name} rank {r}: rows {st['rows']}, launches "
                f"{st['launches']}, ms/substep {st['ms_per_substep']} (CUDA "
                f"events, four processes time-sharing the card), host waits "
                f"a substep {st['waits_per_substep']}")
    # (b) ghost_1m over four slabs
    got5, (want5, _) = by_orig_id(out["ghost_1m"][SLAB_SUBSTEPS]), refs[
        "ghost_1m"][SLAB_SUBSTEPS]
    held(f"parallel (b) ghost_1m, {PARALLEL_RANKS} slabs, "
         f"{SLAB_SUBSTEPS} substeps", got5, want5, SLAB_TOL)
    got, (want, _) = by_orig_id(out["ghost_1m"][FRAME_SUBSTEPS]), refs[
        "ghost_1m"][FRAME_SUBSTEPS]
    held(f"parallel (b) ghost_1m, {FRAME_SUBSTEPS} substeps", got, want, {})
    ghost = want["ghost"] > 0
    start_rows = by_orig_id(warm)
    if not np.array_equal(got["pos"][ghost], start_rows["pos"][ghost]):
        raise AssertionError("parallel (b): a ghost moved")
    for f in ("pos", "vel", "density"):
        if not np.isfinite(got[f]).all():
            raise AssertionError(f"parallel (b): non-finite {f}")
    for stat in ("max", "mean"):
        g = float(getattr(got["density"][~ghost].astype(np.float64), stat)())
        w = float(getattr(want["density"][~ghost].astype(np.float64),
                          stat)())
        log(f"parallel (b) after {FRAME_SUBSTEPS} substeps: fluid density "
            f"{stat} {g!r} against one device's {w!r}")
        if not abs(g - w) <= PARALLEL_RHO_RTOL * w:
            raise AssertionError(f"parallel (b): density {stat} {g} not "
                                 f"within {PARALLEL_RHO_RTOL} of {w}")
    # (c) the fountain through the router
    for k, tol in ((ROUTER_SUBSTEPS, SLAB_TOL), (FRAME_SUBSTEPS, {})):
        want, recycled = refs["fountain_50k"][k]
        mine = out["fountain_50k"][k]
        held(f"parallel (c) fountain_50k, {PARALLEL_RANKS} slabs through "
             f"the router, {k} substeps", by_orig_id(mine), want, tol)
        log(f"parallel (c): {mine['recycled']} rows respawned against "
            f"{recycled} on one device after {k} substeps")
        if mine["recycled"] != recycled:
            raise AssertionError(f"parallel (c): {mine['recycled']} rows "
                                 f"respawned, one device {recycled}")
    if not recycled > 0:
        raise AssertionError("parallel (c): the fountain respawned no row")
    # (d) the gather engine
    want, _ = refs["dam_break_8k"][GATHER_SUBSTEPS]
    held(f"parallel (d) dam_break_8k, gather engine on {PARALLEL_RANKS} "
         f"ranks against the oracle", by_orig_id(
             out["dam_break_8k"][GATHER_SUBSTEPS]), want, GATHER_TOL)
    four = [st["launches"] for st in stats["ghost_1m"]]
    for r, c in enumerate(four):
        if not (c.get("density") == c.get("force_xsph") == FRAME_SUBSTEPS
                and c.get("cell_table") in (FRAME_SUBSTEPS,
                                            FRAME_SUBSTEPS + 1)):
            raise AssertionError(f"parallel (b) rank {r}: launches {c}")
    return {k: {"one_rank": one[k],
                "four_ranks": [c.get(k, 0) for c in four]}
            for k in one}


def timed(name, fn, *args, **kw):
    """``fn(*args, **kw)``, with its seconds logged."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"phase {name}: {time.perf_counter() - t0!r} s")
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("phase", nargs="?", default="all", choices=["all",
                                                                "dense"],
                    help="every phase, or phase dense alone")
    ap.add_argument("--against", help="phase dense: another checkout's root, "
                    "whose force kernel runs beside this one's")
    ap.add_argument("--states", help="phase dense: a folder to save the "
                    "states in, or to read them from where they are saved")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from sph_tpu_torch.app import configs, scene_paths
    from sph_tpu_torch.core.device import card_line
    from sph_tpu_torch.native import build

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t_start = t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0!r} s")
    if a.phase == "dense":
        rec = timed("dense", phase_dense, dev, a.against, a.states)
        print(json.dumps({"dense": rec}), flush=True)
        print(card_line(), flush=True)
        return 0

    measured = {
        "default_131k": timed("kernels default_131k", phase_kernels, dev,
                              "default_131k"),
        "ghost_1m": timed("kernels ghost_1m", phase_kernels, dev, "ghost_1m"),
        "dam_break_8k": timed("kernels dam_break_8k", phase_kernels_brute,
                              dev, "dam_break_8k"),
        "rotated_512k": timed("emit rotated_512k", phase_emit, dev,
                              "rotated_512k"),
        # logged only: the kernels' record keeps its configurations
        "export_4m": timed("kernels export_4m", phase_kernels, dev,
                           "export_4m", plain_reps=1)}
    for config in ("default_131k", "ghost_1m"):
        measured[config]["container"] = timed(
            f"container {config}", phase_container, dev, config)
    timed("crowded", phase_crowded, dev)
    dense = timed("dense", phase_dense, dev)
    timed("small", phase_small, dev)
    counts, graph_ms = {}, {}
    for config in CONFIGS:
        counts[config], final, params, cfg = timed(f"main {config}",
                                                   phase_main, dev, config)
        graph_ms[config] = timed(f"graph {config}", phase_graph_bench,
                                 config, final, params, cfg)
        if configs.CONFIGS[config].viz_export:
            measured[config]["splat"] = timed(f"export {config}",
                                              phase_export, dev, final, config)
        if config == KERNELS["brute_density"][2]:
            measured[config]["brute_density"]["final_ms"] = timed(
                f"final {config}", phase_brute_final, dev, final, config)
        del final, params
    for name in scene_paths.PATHS:
        counts[name], scene = timed(f"scene {name}", phase_scene, dev, name)
        graph_ms[name] = timed(f"graph {name}", phase_graph_scene, dev, name,
                               scene)
        if name == "fountain_50k":
            timed("impulses", phase_impulses, dev, scene.state, scene.params)
        del scene
    counts["reel"], reel_scene = timed("reel", phase_reel, dev)
    timed("looks", phase_looks, dev, reel_scene)
    reel_syncs(reel_scene)
    del reel_scene
    counts["gallery"] = timed("gallery", phase_gallery, dev)
    measured["micro"], counts["micro"] = timed("micro", phase_micro, dev)
    par = timed("parallel", phase_parallel, dev)

    # each kernel's errors, times and bound at the configuration named in
    # KERNELS, and its launches in that configuration's main path (or, for
    # the micro-kernels, in their entry points' run)
    record = {"kernels": [
        {"name": f"{name}_kernel", "route": "cuda", "source": source,
         "replaces": replaces, "config": config,
         "launches": counts[config].get(name, 0),
         "reel_launches": counts["reel"].get(name, 0),
         "gallery_launches": counts["gallery"].get(name, 0),
         **({"parallel_launches": par[name]} if name in par else {}),
         **measured[config][name]}
        for name, (source, replaces, config) in KERNELS.items()]}
    for k in record["kernels"]:
        for at in (k, k.get("second", k)):
            if at["ms"] < at["bound_ms"]:
                raise AssertionError(
                    f"{k['name']}: {at['ms']} ms is less than its bound of "
                    f"{at['bound_ms']} ms: the bound's count is wrong")
    log(f"graph: ms/substep medians, eager and graph in turns, by path "
        f"{json.dumps(graph_ms)}")
    log(f"dense: the force kernel on later states {json.dumps(dense)}")
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
