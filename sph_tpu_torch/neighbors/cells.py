"""Cell keys, the stable key sort, the cell table and the ghost structure
(counterpart of ``sph_tpu/neighbors/planes.py:175-267`` and ``:541-568``).

The reference builds per-cell linked lists (``BuildGrid.comp:34-38``);
the JAX package sorts by cell key and scatters the sorted rows into
fixed-capacity dense slot tables for its TPU kernels
(``mxu_permute._expand_kernel``).  Here the sorted rows themselves are the
neighbor structure: ``cell_start[c]`` and ``cell_end[c]`` bound cell
``c``'s rows, so no cell has a capacity and no particle can overflow one.
:func:`cell_table` builds the sorted rows (pos, vel and whatever other
columns the caller hands it) and those ranges in one CUDA kernel
(``csrc/cells.cu``) on CUDA tensors, and with ``torch.searchsorted`` and
index gathers (:func:`cell_table_plain`) on CPU tensors.

The key is y-major with x fastest, ``x + nx*(z + nz*y)``, so the three
cells ``x-1 .. x+1`` at one ``(y, z)`` are one contiguous row range; the
sweeps walk 9 such ranges instead of 27 cells.
"""
from __future__ import annotations

import dataclasses
import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from sph_tpu_torch.core.params import FluidParams, grid_cell_coords
from sph_tpu_torch.core.state import ParticleState
from sph_tpu_torch.native import build as native
from sph_tpu_torch.utils import trace

# Kernel launches since the last reset_launches() — only the CUDA path
# counts, and only where it launches (``trace.counters``: ``launches.*``).
LAUNCHES = trace.launch_counts({"cell_table": 0})


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def keys_from_coords(c: torch.Tensor, mask: torch.Tensor,
                     dims: Tuple[int, int, int]) -> torch.Tensor:
    """y-major cell key ``x + nx*(z + nz*y)`` of cell coords ``c`` [N,3]
    on the grid ``dims``; mask=False -> ``num_cells``."""
    nx, ny, nz = dims
    key = c[:, 0] + nx * (c[:, 2] + nz * c[:, 1])
    return torch.where(mask, key, torch.full_like(key, nx * ny * nz))


def compute_keys_ymajor(pos: torch.Tensor, mask: torch.Tensor,
                        params: FluidParams,
                        dims: Tuple[int, int, int]) -> torch.Tensor:
    """y-major cell key ``x + nx*(z + nz*y)``; mask=False -> ``num_cells``."""
    return keys_from_coords(grid_cell_coords(pos, params, dims), mask, dims)


class CellTable(NamedTuple):
    pos: torch.Tensor                 # [N,3] sorted
    vel: Optional[torch.Tensor]       # [N,3] sorted, or None
    cell_start: torch.Tensor          # [num_cells] i32
    cell_end: torch.Tensor            # [num_cells] i32
    carried: Tuple[torch.Tensor, ...] = ()   # the other columns, sorted


def cell_table_plain(skey, order, pos, vel, num_cells: int,
                     carry: Sequence[torch.Tensor] = ()) -> CellTable:
    """Plain torch version of ``cell_table_kernel``."""
    cells = torch.arange(num_cells, dtype=skey.dtype, device=skey.device)
    start = torch.searchsorted(skey, cells, out_int32=True)
    end = torch.searchsorted(skey, cells, right=True, out_int32=True)
    return CellTable(pos[order], None if vel is None else vel[order], start,
                     end, tuple(c[order] for c in carry))


def _columns(dev, n: int, m: int, pos, vel, carry):
    """The kernel's column arguments: the [m, 3] columns (pos first, vel
    second when given) and the [m] ones of ``carry``, checked, each with a
    new contiguous [n, ...] tensor for its sorted copy.  A column may be a
    strided view of a wider buffer (the emitted-row transport's are) as long
    as its three words lie together.  Returns the C struct and the outputs
    in the order (pos, vel or None, *carry)."""
    cols = [("pos", pos)] + ([] if vel is None else [("vel", vel)]) + [
        (f"carry[{k}]", c) for k, c in enumerate(carry)]
    arg = native.CellColumnsC()
    outs = []
    for name, c in cols:
        wide = c.dim() == 2
        if c.device != dev:
            raise ValueError(f"{name} is on {c.device}, expected {dev}")
        if c.dtype not in (torch.float32, torch.int32):
            raise ValueError(f"{name} has dtype {c.dtype}: the cell table "
                             f"moves 4-byte columns (float32, int32)")
        if tuple(c.shape) != ((m, 3) if wide else (m,)):
            raise ValueError(f"{name} has shape {tuple(c.shape)}, expected "
                             f"({m}, 3) or ({m},)")
        if wide and m > 0 and c.stride(1) != 1:   # no rows: any strides
            raise ValueError(f"{name}: the three words of a row do not lie "
                             f"together")
        kind = "wide" if wide else "narrow"
        k = getattr(arg, f"n_{kind}")
        if k >= (native.CELL_MAX_WIDE if wide else native.CELL_MAX_NARROW):
            raise ValueError(f"too many [{'N, 3' if wide else 'N'}] columns "
                             f"for one cell-table launch")
        out = torch.empty((n, *c.shape[1:]), dtype=c.dtype, device=dev)
        getattr(arg, f"{kind}_in")[k] = c.data_ptr()
        getattr(arg, f"{kind}_out")[k] = out.data_ptr()
        getattr(arg, f"{kind}_stride")[k] = c.stride(0)
        setattr(arg, f"n_{kind}", k + 1)
        outs.append(out)
    if vel is None:
        outs.insert(1, None)
    return arg, outs


def cell_table(skey: torch.Tensor, order: torch.Tensor, pos: torch.Tensor,
               vel: Optional[torch.Tensor], num_cells: int,
               carry: Sequence[torch.Tensor] = ()) -> CellTable:
    """The cell table of rows sorted by key: ``pos[order]`` and
    ``vel[order]`` (``vel`` may be None), and ``cell_start[c]`` /
    ``cell_end[c]``, the first row with key >= c and the first with
    key > c (``torch.searchsorted``'s semantics, so an empty cell has
    start = end = its insertion point; on CUDA tensors the two are views of
    one array of ``num_cells + 1`` bounds).

    ``skey`` [N] int32 ascending (rows outside the table carry
    ``num_cells``), ``order`` [N] int64 into the rows of ``pos``/``vel``.
    ``carry`` are more columns of the same rows, [M] or [M, 3], float32 or
    int32: ``carried[k] = carry[k][order]``, moved in the same launch as raw
    32-bit words.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    dev = skey.device
    if dev.type == "cpu":
        return cell_table_plain(skey, order, pos, vel, num_cells, carry)
    if dev.type != "cuda":
        raise ValueError(f"the cell table takes CUDA or CPU tensors, got {dev}")
    n, m = skey.shape[0], pos.shape[0]
    if max(n, m, num_cells) >= 2**31 // 3:
        raise ValueError("too many rows or cells for the kernel's int32 "
                         "indexing")
    native.check_tensor("skey", skey, torch.int32, (n,), dev)
    if skey.data_ptr() % 16:
        raise ValueError("skey is not 16-byte aligned (a slice?): the kernel "
                         "reads it four keys at a time")
    native.check_tensor("order", order, torch.int64, (n,), dev)
    arg, outs = _columns(dev, n, m, pos, vel, carry)
    bounds = torch.empty(num_cells + 1, dtype=torch.int32, device=dev)
    err = native.library().sph_cell_table(
        skey.data_ptr(), order.data_ptr(), n, num_cells, ctypes.byref(arg),
        bounds.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    native.launched(LAUNCHES, "cell_table", err)
    return CellTable(outs[0], outs[1], bounds[:-1], bounds[1:],
                     tuple(outs[2:]))


def fluid_sort(state: ParticleState, params: FluidParams,
               dims: Tuple[int, int, int],
               key: Optional[torch.Tensor] = None):
    """(skey, order) of every row, stable; rows other than fluid take key
    ``num_cells`` and sort last.  ``key`` [N], when given, is every row's
    key on the grid ``dims`` (a slab's, ``parallel/slabs.py``) in place of
    the state's own."""
    if key is None:
        key = compute_keys_ymajor(state.pos, state.fluid_mask(), params, dims)
    return torch.sort(key, stable=True)


def ghost_sort(state: ParticleState, params: FluidParams,
               dims: Tuple[int, int, int],
               key: Optional[torch.Tensor] = None):
    """(skey, order) of the contributing ghosts (valid, ghost, face
    active) only, stable; ``order`` indexes the rows of ``state``.  ``key``
    as in :func:`fluid_sort`."""
    contrib = state.contrib_mask(params.ghost_face_active)
    trace.count("host_waits")       # nonzero waits for the card's count
    rows = torch.nonzero((state.ghost > 0) & contrib).squeeze(1)
    if key is None:
        key = compute_keys_ymajor(state.pos[rows],
                                  torch.ones_like(rows, dtype=torch.bool),
                                  params, dims)
    else:
        key = key[rows]
    skey, order = torch.sort(key, stable=True)
    return skey, rows[order]


class CellRows(NamedTuple):
    """The neighbor structure one substep's sweeps read."""
    state: ParticleState      # sorted by key
    key: torch.Tensor         # [N] i32 ascending; non-fluid = num_cells
    cell_start: torch.Tensor  # [num_cells] i32
    cell_end: torch.Tensor    # [num_cells] i32
    order: torch.Tensor       # [N] i64: sorted row i is input row order[i]


def build(state: ParticleState, params: FluidParams,
          dims: Tuple[int, int, int],
          key: Optional[torch.Tensor] = None) -> CellRows:
    """Keys -> stable sort -> cell table.  Only fluid rows get a cell:
    ghosts and padding take key ``num_cells`` and sort last.  ``key``, when
    given, is every row's key on the grid ``dims`` (:func:`fluid_sort`).

    Every field moves with its row, so the state stays in sorted order and
    ``orig_id`` keeps each particle's identity, as the JAX engine's does
    (``pallas_sweeps.py:1205-1206``); all of them move in the cell table's
    one launch."""
    nx, ny, nz = dims
    skey, order = fluid_sort(state, params, dims, key)
    names = [f.name for f in dataclasses.fields(state)
             if f.name not in ("pos", "vel")]
    tbl = cell_table(skey, order, state.pos, state.vel, nx * ny * nz,
                     carry=[getattr(state, f) for f in names])
    s = ParticleState(pos=tbl.pos, vel=tbl.vel,
                      **dict(zip(names, tbl.carried)))
    return CellRows(s, skey, tbl.cell_start, tbl.cell_end, order)


class GhostRows(NamedTuple):
    """The static ghost sources: contributing ghosts only, sorted by the
    fluid's cell key (counterpart of ``planes.GhostTables``)."""
    pos: torch.Tensor          # [G,3] sorted
    ghost_start: torch.Tensor  # [num_cells] i32
    ghost_end: torch.Tensor    # [num_cells] i32
    records: torch.Tensor      # [2,G,4] the force sweep's source records
    near: torch.Tensor         # [num_cells] u8: a ghost in the 3x3x3 block

    @property
    def count(self) -> int:
        return self.pos.shape[0]


def ghost_records(pos: torch.Tensor, rho0, mass) -> torch.Tensor:
    """The force sweep's source records of ghost sources at ``pos`` [G,3]
    (``sweeps.pack_sources`` has the layout): ``[0] = (x, y, z, rho0)``,
    ``[1] = (0, 0, 0, mass / max(rho0, 1e-12))`` -- a ghost has rho0, so
    P = 0, and v = 0 (``physics/brute_force.py``)."""
    rec = torch.zeros(2, pos.shape[0], 4, dtype=torch.float32,
                      device=pos.device)
    rho0 = torch.as_tensor(rho0, dtype=torch.float32, device=pos.device)
    rec[0, :, :3] = pos
    rec[0, :, 3] = rho0
    rec[1, :, 3] = mass / torch.clamp_min(rho0, 1e-12)
    return rec


def ghost_near(ghost_start: torch.Tensor, ghost_end: torch.Tensor,
               dims: Tuple[int, int, int]) -> torch.Tensor:
    """[num_cells] uint8: whether any cell of the cell's 3x3x3 block holds a
    ghost.  The density kernel walks the ghost ranges only where it does;
    most fluid rows lie further than a cell from every wall."""
    nx, ny, nz = dims
    has = (ghost_end > ghost_start).reshape(1, 1, ny, nz, nx).float()
    near = torch.nn.functional.max_pool3d(has, 3, stride=1, padding=1)
    return (near > 0).reshape(-1).to(torch.uint8)


def build_ghosts(state: ParticleState, params: FluidParams,
                 dims: Tuple[int, int, int],
                 key: Optional[torch.Tensor] = None) -> GhostRows:
    """The ghost structure (counterpart of ``planes.build_ghost_tables``):
    the rows that are valid, ghosts and on an active face, with the same
    y-major key (or ``key``, as in :func:`fluid_sort`), a stable sort and
    the same cell table, and their source records for the force sweep and
    the cells near a ghost.  Ghosts never move and face activation is fixed
    within a run, so this is built once per ``run_substeps``."""
    nx, ny, nz = dims
    trace.count("ghost_builds")
    with trace.span("sph.build_ghosts"):
        skey, order = ghost_sort(state, params, dims, key)
        tbl = cell_table(skey, order, state.pos, None, nx * ny * nz)
        return GhostRows(tbl.pos, tbl.cell_start, tbl.cell_end,
                         ghost_records(tbl.pos, params.rest_density,
                                       params.mass),
                         ghost_near(tbl.cell_start, tbl.cell_end, dims))
