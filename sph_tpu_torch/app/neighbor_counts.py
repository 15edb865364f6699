"""How many sources a row of the cell engine has in reach, for one bench
configuration on the card: what the force kernel's queue will meet.

    python -m sph_tpu_torch.app.neighbor_counts ghost_1m
    python -m sph_tpu_torch.app.neighbor_counts default_131k --frames 2
    python -m sph_tpu_torch.app.neighbor_counts rotated_512k --frames 20,60,100

Runs ``--frames`` frames (the configuration's frame prologue, then 16
substeps; 5 by default, which is where ``app.profile_substeps`` starts its
profiled frame; a list counts after each of its frames, in one run), then
counts, for every fluid row of the sorted state, the candidates of its 9
ranges (fluid and ghost) and those within ``(1 + sweeps.FORCE_MARGIN) h`` of
it, the row itself included.  It prints the means, the quantiles, the share
of rows with more than 32, 48 and 64 in reach, the share of warps (32
consecutive sorted rows) that hold such a row: a warp whose fullest row has
more than ``sweeps.FORCE_QUEUE`` empties its queues on the way and walks
twice (``csrc/sweeps.cu``), the share of the warps with a fluid row
that take the force kernel's tile path instead (``sweeps.tile_warp_count``:
32 fluid rows in one x-run of cells or in two, those of each run at most
``sweeps.FORCE_TILE_SPAN`` cells apart or some row's own three cells
holding ``sweeps.FORCE_TILE_CROWD`` rows), which no queue limits, and the
other warps by why the rule turns them away
(``sweeps.queue_warp_reasons``: a non-fluid row or the partial last warp,
three x-runs or more, a sparse run wider than the span).  The last line of each
count is the same as one JSON object.  It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json

import torch

from sph_tpu_torch.app import configs
from sph_tpu_torch.engine.step import SceneBuffers, run_substeps
from sph_tpu_torch.neighbors import cells, sweeps

SUBSTEPS = 16
QUANTILES = (0.1, 0.25, 0.5, 0.75, 0.9, 0.99)
LIMITS = (32, 48, 64)


def reach_counts(key, pos, cell_start, cell_end, pv, ghosts, reach: float):
    """(candidates, in_reach) [F] int64 of the fluid rows, in sorted order:
    the rows of each one's 9 ranges, fluid and ghost, and those of them
    within ``reach`` of it (itself included)."""
    srcs = [(pos, cell_start, cell_end)]
    if ghosts is not None:
        srcs.append((ghosts.pos, ghosts.ghost_start, ghosts.ghost_end))
    cand, near = [], []
    for rows in sweeps._fluid_chunks(key, pv):
        c = torch.zeros(rows.shape[0], dtype=torch.int64, device=key.device)
        m_all = torch.zeros_like(c)
        for spos, starts, ends in srcs:
            idx, m = sweeps._candidates(key[rows], starts, ends, pv)
            r2 = torch.sum((pos[rows][:, None, :] - spos[idx]) ** 2, dim=-1)
            c += (m & (r2 < reach * reach)).sum(1)
            m_all += m.sum(1)
        cand.append(m_all)
        near.append(c)
    empty = torch.zeros(0, dtype=torch.int64, device=key.device)
    return (torch.cat(cand) if cand else empty,
            torch.cat(near) if near else empty)


def count(name: str, frames=(5,)):
    """Count after each of ``frames`` (ascending) frames of one run; returns
    the last count's record."""
    if not torch.cuda.is_available():
        raise RuntimeError("neighbor_counts needs a CUDA card")
    state, params, cfg = configs.build(name)
    prologue = configs.frame_prologue(name, params, SUBSTEPS)
    buffers = SceneBuffers.create(cfg)
    done, res = 0, None
    for at in sorted(frames):
        for _ in range(at - done):
            state, buffers = run_substeps(prologue(state), params, buffers,
                                          params.dt, SUBSTEPS, cfg)
        done = at
        res = count_state(name, state, params, cfg, at)
    return res


def count_state(name, state, params, cfg, frames: int):
    """One count of ``state``, after ``frames`` frames."""
    pv, ghosts = sweeps.prepare(state, params, params.dt, cfg)
    r = cells.build(state, params, cfg.grid_dims)
    cand, near = reach_counts(r.key, r.state.pos, r.cell_start, r.cell_end,
                              pv, ghosts, (1.0 + sweeps.FORCE_MARGIN) * pv.h)
    q = torch.tensor(QUANTILES, device=near.device)
    warps = near[:near.shape[0] // 32 * 32].reshape(-1, 32).max(1).values
    fluid_warps = -(-near.shape[0] // 32)
    tile = sweeps.tile_warp_count(r.key, pv.num_cells, pv.nx)
    reasons = sweeps.queue_warp_reasons(r.key, pv.num_cells, pv.nx)
    res = {
        "config": name, "card": torch.cuda.get_device_name(0),
        "substeps": frames * SUBSTEPS, "fluid_rows": int(near.shape[0]),
        "candidates_mean": float(cand.float().mean()),
        "candidates_quantiles": torch.quantile(cand.float(), q).tolist(),
        "in_reach_mean": float(near.float().mean()),
        "in_reach_quantiles": torch.quantile(near.float(), q).tolist(),
        "rows_over": {n: float((near > n).float().mean()) for n in LIMITS},
        "warps_over": {n: float((warps > n).float().mean()) for n in LIMITS},
        "tile_warps": tile, "fluid_warps": fluid_warps,
        "tile_share": tile / max(fluid_warps, 1), "queue_reasons": reasons,
    }
    print(f"{name} after {res['substeps']} substeps on {res['card']}: "
          f"{res['fluid_rows']} fluid rows; candidates mean "
          f"{res['candidates_mean']!r}, quantiles {QUANTILES} "
          f"{res['candidates_quantiles']}")
    print(f"  within {1.0 + sweeps.FORCE_MARGIN} h: mean "
          f"{res['in_reach_mean']!r}, quantiles {res['in_reach_quantiles']}; "
          f"rows over {LIMITS}: {list(res['rows_over'].values())}; warps "
          f"with such a row: {list(res['warps_over'].values())}; tile path: "
          f"{tile} of {fluid_warps} warps with a fluid row, "
          f"{res['tile_share']!r}; the others queue by {reasons}")
    print(json.dumps(res))
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config", choices=["default_131k", "ghost_1m",
                                       "rotated_512k"])
    ap.add_argument("--frames", default="5",
                    help="frames before the count, or a list: 20,60,100")
    a = ap.parse_args(argv)
    count(a.config, [int(f) for f in a.frames.split(",")])


if __name__ == "__main__":
    main()
