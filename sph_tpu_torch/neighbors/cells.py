"""Cell keys, the stable key sort and per-cell row ranges
(counterpart of ``sph_tpu/neighbors/planes.py:175-267``).

The reference builds per-cell linked lists (``BuildGrid.comp:34-38``);
the JAX package sorts by cell key and scatters the sorted rows into
fixed-capacity dense slot tables for its TPU kernels.  Here the sorted
rows themselves are the neighbor structure: ``cell_start[c]`` and
``cell_end[c]`` bound cell ``c``'s rows, so no cell has a capacity and no
particle can overflow one.

The key is y-major with x fastest, ``x + nx*(z + nz*y)``, so the three
cells ``x-1 .. x+1`` at one ``(y, z)`` are one contiguous row range; the
sweeps walk 9 such ranges instead of 27 cells.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from sph_tpu_torch.core.params import FluidParams, grid_cell_coords
from sph_tpu_torch.core.state import ParticleState


def compute_keys_ymajor(pos: torch.Tensor, mask: torch.Tensor,
                        params: FluidParams,
                        dims: Tuple[int, int, int]) -> torch.Tensor:
    """y-major cell key ``x + nx*(z + nz*y)``; mask=False -> ``num_cells``."""
    nx, ny, nz = dims
    c = grid_cell_coords(pos, params, dims)
    key = c[:, 0] + nx * (c[:, 2] + nz * c[:, 1])
    return torch.where(mask, key, torch.full_like(key, nx * ny * nz))


def sort_particles(state: ParticleState, key: torch.Tensor
                   ) -> Tuple[ParticleState, torch.Tensor]:
    """Stable sort by cell key; returns (sorted state, sorted keys).

    Every field moves with its row, so the state stays in sorted order
    and ``orig_id`` keeps each particle's identity, as the JAX engine's
    does (``pallas_sweeps.py:1205-1206``)."""
    skey, order = torch.sort(key, stable=True)
    fields = {f: getattr(state, f)[order]
              for f in state.__dataclass_fields__}
    return ParticleState(**fields), skey


def cell_ranges(skey: torch.Tensor, num_cells: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[num_cells] int32 ``cell_start`` / ``cell_end`` of ascending keys.

    Stands in for the JAX package's table expand (``planes.py:331-383``):
    the sorted rows need no scatter into slots, only their bounds."""
    cells = torch.arange(num_cells, dtype=skey.dtype, device=skey.device)
    start = torch.searchsorted(skey, cells, out_int32=True)
    end = torch.searchsorted(skey, cells, right=True, out_int32=True)
    return start, end


class CellRows(NamedTuple):
    """The neighbor structure one substep's sweeps read."""
    state: ParticleState      # sorted by key
    key: torch.Tensor         # [N] i32 ascending; non-fluid = num_cells
    cell_start: torch.Tensor  # [num_cells] i32
    cell_end: torch.Tensor    # [num_cells] i32


def build(state: ParticleState, params: FluidParams,
          dims: Tuple[int, int, int]) -> CellRows:
    """Keys -> stable sort -> cell ranges.  Only fluid rows get a cell:
    ghosts and padding take key ``num_cells`` and sort last."""
    nx, ny, nz = dims
    key = compute_keys_ymajor(state.pos, state.fluid_mask(), params, dims)
    s, skey = sort_particles(state, key)
    start, end = cell_ranges(skey, nx * ny * nz)
    return CellRows(s, skey, start, end)
