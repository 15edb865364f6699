"""Multi-rank dry run (counterpart of ``sph_tpu/parallel/dryrun.py``):

    python -m sph_tpu_torch.parallel.dryrun N [--device cpu|cuda]
        [--backend gloo|nccl] [--out DIR]

runs the JAX dry run's four stages (``dryrun.py:51-220``) on N ranks
(``group.launch`` of ``parallel/run.py``), checks each against the port's
single-device engines in this process, and prints one line:

1. the slab engine, 1,024 rows in the box of half 7, 5 substeps, against
   the cell engine (``engine.step.run_substeps``): every row kept, pos
   within 1e-4;
2. the slab engine in fountain mode through the router, 384 rows in the box
   of half 3.2, 2 substeps, against the cell engine within 1e-4;
3. the slab engine in river mode, 256 rows, the sink forced toward the
   emitter's slab so that respawns cross slabs, 2 substeps, against the
   cell engine within 1e-4;
4. the gather engine, 64 N rows, fountain on, one substep, against the
   all-pairs oracle within 1e-5.

The device is the card unless ``--device`` names another; the backend is
NCCL on the card (a card a rank) and gloo on the CPU unless ``--backend``
names it.  Exits non-zero, with the ranks' output, when a rank or a check
fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from sph_tpu_torch.core import convert
from sph_tpu_torch.core import params as P
from sph_tpu_torch.core import state as S
from sph_tpu_torch.core.device import resolve
from sph_tpu_torch.engine import step
from sph_tpu_torch.parallel import group as G, run as R
from sph_tpu_torch.scene import river as RV

TOL = 1e-4          # sph_tpu/parallel/dryrun.py:82, :131
GATHER_TOL = 1e-5   # tests/test_parallel.py:34


def _case(n, half, seed, device, **cfg):
    spawn = S.spawn_standard(n, box_half=half, seed=seed)
    state = S.state_from_spawn(spawn, pad_to=cfg.pop("pad_to", None),
                               device=device)
    params = P.FluidParams.default(device=device,
                                   box_half=half).derive_mass()
    dims = P.compute_grid_dims(0, half, (0.0, 0.0, 0.0), 0.28)
    config = P.SimConfig(n=state.n, grid_dims=dims, **cfg)
    return state, params, config, step.SceneBuffers.create(config, device)


def stages(n_ranks: int, device):
    """(name, engine, substeps, state, params, config, buffers) of each
    stage."""
    half7, half3 = (7.0, 7.0, 7.0), (3.2, 3.2, 3.2)
    out = [("slab", "slab", 5, *_case(1024, half7, 0, device,
                                       neighbor_impl="cell")),
           ("fountain", "slab", 2, *_case(384, half3, 2, device,
                                          neighbor_impl="cell",
                                          fountain_mode=True))]
    st, prm, cfg, buf = _case(256, half3, 3, device, neighbor_impl="cell",
                              river_mode=True)
    spec = RV.RiverSpec.random(3)
    terrain = RV.generate_river_terrain(spec, (0.0, 0.0, 0.0), half3,
                                        res=cfg.terrain_res)
    prm = RV.river_params(prm, spec, (0.0, 0.0, 0.0), half3)
    # the sink forced toward the emitter's slab (dryrun.py:696-700)
    f32 = dict(dtype=torch.float32, device=prm.h.device)
    prm = prm.replace(river_sink_z_max=torch.tensor(0.0, **f32),
                      river_emitter_pos=torch.tensor([0.0, 1.0, -2.8], **f32),
                      river_sink_y=torch.tensor(-20.0, **f32))
    buf = buf.replace(terrain=torch.as_tensor(terrain, device=prm.h.device))
    out.append(("river", "slab", 2, st, prm, cfg, buf))
    pad = 64 * n_ranks
    out.append(("gather", "gather", 1, *_case(pad, half7, 0, device,
                                              pad_to=pad,
                                              neighbor_impl="brute",
                                              fountain_mode=True)))
    return out


def _valid_by_id(d):
    """(pos, orig_id) of a state's valid rows, ordered by orig_id."""
    v = np.asarray(d["valid"]) > 0
    o = np.argsort(np.asarray(d["orig_id"])[v], kind="stable")
    return np.asarray(d["pos"])[v][o], np.asarray(d["orig_id"])[v][o]


def run(n_ranks: int, device, backend: str, out: str) -> str:
    t0 = time.perf_counter()
    jobs, runs = [], {}
    for name, engine, n_sub, state, params, config, buffers in stages(
            n_ranks, device):
        path = R.save_input(os.path.join(out, f"{name}.npz"),
                            convert.to_numpy(state), convert.to_numpy(params),
                            convert.to_numpy(buffers))
        cfg = dataclasses.asdict(config)
        jobs.append({"name": name, "engine": engine, "input": path,
                     "config": cfg, "checkpoints": [n_sub]})
        runs[name] = (n_sub, state, params, config, buffers)
    with open(os.path.join(out, "jobs.json"), "w") as f:
        json.dump(jobs, f)
    G.check(G.launch("sph_tpu_torch.parallel.run", n_ranks,
                     [os.path.join(out, "jobs.json")], out, backend=backend,
                     device=str(device)))
    errs, respawned = {}, {}
    for name, (n_sub, state, params, config, buffers) in runs.items():
        ref, rbuf = step.run_substeps(state, params, buffers, params.dt,
                                      n_sub, config)
        got = R.read_state(os.path.join(out, f"{name}_{n_sub}.npz"))
        respawned[name] = got["recycled"]
        if got["recycled"] != int(rbuf.recycled):
            raise AssertionError(f"{name}: {got['recycled']} rows respawned "
                                 f"against {int(rbuf.recycled)} on one device")
        rpos, rid = _valid_by_id(convert.to_numpy(ref))
        gpos, gid = _valid_by_id(got)
        if not np.array_equal(rid, gid):
            raise AssertionError(f"{name}: rows lost or duplicated "
                                 f"({len(gid)} against {len(rid)})")
        if np.isnan(gpos).any():
            raise AssertionError(f"{name}: NaN")
        err = float(np.abs(rpos - gpos).max())
        tol = GATHER_TOL if name == "gather" else TOL
        if err >= tol:
            raise AssertionError(f"{name}: {n_ranks} ranks diverged from one "
                                 f"device by {err} (tolerance {tol})")
        errs[name] = err
    return (f"dryrun({n_ranks}, {device}, {backend}): ok in "
            f"{time.perf_counter() - t0:.1f} s — slab engine "
            f"({n_ranks} z-slabs, halo exchanges, migration; max err "
            f"{errs['slab']:.2e}), fountain respawns routed across slabs "
            f"({respawned['fountain']} respawned, max err "
            f"{errs['fountain']:.2e}), river sink routed across slabs "
            f"({respawned['river']} respawned, max err {errs['river']:.2e}), "
            f"gather engine "
            f"(max err {errs['gather']:.2e}) against one device")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", choices=G.BACKENDS, default=None)
    ap.add_argument("--out", default=None,
                    help="where the ranks write (default: a temp dir)")
    ns = ap.parse_args(argv)
    device = resolve(ns.device)
    backend = ns.backend or ("nccl" if device.type == "cuda" else "gloo")
    torch.set_num_threads(1)
    if ns.out is not None:
        print(run(ns.n, device, backend, ns.out), flush=True)
        return 0
    with tempfile.TemporaryDirectory() as out:
        print(run(ns.n, device, backend, out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
