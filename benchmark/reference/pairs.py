"""The pairs within h of a state, counted plainly: the work the inputs
need, whatever implements it.  The rooflines of the sweep kernels count
their operations from here, never from the port."""
from __future__ import annotations

import torch

from benchmark.reference.sph import Frame, State


def count(frame: Frame, st: State) -> dict:
    """Pairs (i, j) with i a fluid row and j a fluid row or a ghost on an
    active face, at squared distance under h^2: ``density`` counts i = j,
    ``force`` does not.  Also the rows: ``fluid`` and ``ghosts`` (active
    ghosts)."""
    p = frame.p
    fluid = (st["valid"] > 0) & (st["ghost"] == 0)
    key = frame.keys(st["pos"], fluid)
    skey, order = torch.sort(key, stable=True)
    pos = st["pos"][order]
    start, end = frame.ranges(skey)
    gpos, gstart, gend = frame.ghosts(st)
    n = len(skey)
    tables = frame.tables(start, end, *((gstart, gend) if len(gpos)
                                        else (None, None)), n)
    src = torch.cat([pos, gpos])
    live = torch.nonzero(skey < p.num_cells).squeeze(1)
    total = 0
    for _, i, j in frame.pair_chunks(live, skey, tables):
        d = pos[i] - src[j]
        total += int((torch.sum(d * d, -1) < frame.h2).sum())
    return {"density": total, "force": total - len(live),
            "fluid": len(live), "ghosts": len(gpos)}
