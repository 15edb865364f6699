"""The z-slab engine: the cell engine's kernels in every rank, with halo
exchanges, migration and the respawn router (counterpart of
``sph_tpu/parallel/slabs.py`` and ``sph_tpu/parallel/slab_pallas.py``; the
port has one cell engine where the JAX package had binned and Pallas
tables).

The grid's z axis (of the container-local frame, ``core/params.py``) is cut
into ``world`` slabs of ``nz_local`` planes; a rank holds the rows whose
global z cell lies in its slab.  Each rank's sweeps walk the grid
``(nx, ny, nz_local + 2)`` whose plane 0 is global plane ``z0 - 1`` and
whose plane ``nz_local + 1`` is ``z0 + nz_local``: the halo planes, which
hold copies of the neighbours' edge rows.  A substep
(``slab_pallas._substep_body``, ``:332-459``):

1. **source halo** — each rank sends the pos and vel of its fluid rows in
   its edge planes to the neighbour across that edge, which appends them
   to its rows as halo rows (``slabs._exchange``,
   ``slab_pallas._exchange_rows``);
2. ``cells.build`` on local + halo rows, then ``sweeps.density_sources``
   (kernels #3 and #1);
3. **density halo** — the ranks send the density of the same edge rows in
   the same order, which replaces the halo rows' own (computed without the
   far side) and is written into their source records
   (``slab_pallas._exchange_rho``, ``:142-146``);
4. ``sweeps.force_xsph`` (#2), then the halo rows are dropped;
5. reassembly, the container and, in river or fountain mode, the scene
   stages;
6. ``migrate``: a row whose cell left the slab moves one slab over, which
   is exact under the CFL cap (``slabs._migrate``, ``:207-272``); or, in
   river and fountain mode, ``route_all_to_all``, which delivers every row
   to the slab of its cell, since a respawn can teleport a row across any
   number of slabs (``slab_pallas._route_all_to_all``, ``:149-233``).

The ghosts never move: :func:`prepare` builds each rank's ghost structure
once a run from its own ghosts and its neighbours' edge-plane ghosts
(``slab_pallas.make_slab_ghost_builder``, ``:462-488``).

A rank holds no fixed capacity (ROADMAP R17): ``shard_by_slab`` never
raises for a full slab, and neither the migration nor the router drops a
row, where the JAX package's fixed buffers can (``slabs.py:294-296``,
``:227-235``; ``slab_pallas.py:222-225``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from sph_tpu_torch.core.params import FluidParams, SimConfig, grid_cell_coords
from sph_tpu_torch.core.state import ParticleState
from sph_tpu_torch.engine.step import SceneBuffers, scene_stages
from sph_tpu_torch.neighbors import cells, sweeps
from sph_tpu_torch.neighbors.sweeps import CellAux
from sph_tpu_torch.parallel.group import Group

_INT_FIELDS = ("ghost", "active", "face", "color_group", "valid", "orig_id")


@dataclasses.dataclass(frozen=True)
class SlabConfig:
    """The decomposition: ``world`` slabs of the global grid ``dims``,
    whose nz is a multiple of ``world``."""
    world: int
    dims: Tuple[int, int, int]

    @property
    def nz_local(self) -> int:
        return self.dims[2] // self.world

    @property
    def sweep_dims(self) -> Tuple[int, int, int]:
        """The grid a rank's sweeps walk: its slab and the two halo
        planes."""
        return (self.dims[0], self.dims[1], self.nz_local + 2)


def make_slab_config(config: SimConfig, world: int) -> SlabConfig:
    """nz padded up to a multiple of ``world`` (``slabs.py:93-103``); the
    port keeps no per-rank capacity, so nothing else is sized."""
    nx, ny, nz = config.grid_dims
    return SlabConfig(world, (nx, ny, -(-nz // world) * world))


# ---------------------------------------------------------------------------
# rows as one float32 block, for the transport
# ---------------------------------------------------------------------------

def _width(name: str) -> int:
    return 3 if name in ("pos", "vel", "acc") else 1


def pack_rows(state: ParticleState) -> torch.Tensor:
    """[N, 18] float32: every field, the int32 ones by their bits."""
    cols = []
    for f in dataclasses.fields(ParticleState):
        t = getattr(state, f.name)
        if f.name in _INT_FIELDS:
            t = t.view(torch.float32)
        cols.append(t.reshape(state.n, _width(f.name)))
    return torch.cat(cols, dim=1)


def unpack_rows(rows: torch.Tensor) -> ParticleState:
    """The reverse of :func:`pack_rows`."""
    out, k = {}, 0
    for f in dataclasses.fields(ParticleState):
        w = _width(f.name)
        t = rows[:, k:k + w].contiguous()
        k += w
        if f.name in _INT_FIELDS:
            t = t.view(torch.int32)
        out[f.name] = t if w == 3 else t.reshape(-1)
    return ParticleState(**out)


def take(state: ParticleState, idx: torch.Tensor) -> ParticleState:
    """The rows ``idx`` of every field."""
    return ParticleState(**{f.name: getattr(state, f.name)[idx]
                            for f in dataclasses.fields(ParticleState)})


def concat(a: ParticleState, b: ParticleState) -> ParticleState:
    return ParticleState(**{f.name: torch.cat([getattr(a, f.name),
                                               getattr(b, f.name)])
                            for f in dataclasses.fields(ParticleState)})


def _compact(keep: torch.Tensor, count: int) -> torch.Tensor:
    """The indices where ``keep`` is true, in order, when the caller knows
    there are ``count`` of them; no host wait (``torch.nonzero`` has one)."""
    n = keep.shape[0]
    at = torch.cumsum(keep, 0) - 1
    dst = torch.where(keep, at, torch.full_like(at, count))
    idx = torch.empty(count + 1, dtype=torch.int64, device=keep.device)
    idx.scatter_(0, dst, torch.arange(n, device=keep.device))
    return idx[:count]


def _by_dest(dest: torch.Tensor, world: int):
    """(stable order grouping rows by ``dest``, [world] rows bound for each
    rank) of ``dest`` [N] (``world`` for none).  The counts come from the
    sorted keys, with no host wait (``torch.bincount`` waits to size its
    output) and no atomics."""
    keys, order = torch.sort(dest.to(torch.int32), stable=True)
    ranks = torch.arange(world + 1, dtype=torch.int32, device=dest.device)
    bounds = torch.searchsorted(keys, ranks)
    return order, bounds[1:] - bounds[:-1]


# ---------------------------------------------------------------------------
# slabs and keys
# ---------------------------------------------------------------------------

def _z0(scfg: SlabConfig, rank: int) -> int:
    return rank * scfg.nz_local


def slab_of(pos: torch.Tensor, params: FluidParams,
            scfg: SlabConfig) -> torch.Tensor:
    """[N] the rank whose slab holds each position's global z cell."""
    gz = grid_cell_coords(pos, params, scfg.dims)[:, 2]
    return torch.clamp(gz // scfg.nz_local, 0, scfg.world - 1)


def shard_by_slab(state: ParticleState, params: FluidParams,
                  scfg: SlabConfig, rank: int) -> ParticleState:
    """The valid rows of a global state whose global z cell lies in
    ``rank``'s slab, in their order (``slabs.shard_by_slab``,
    ``:275-305``; host-side, before a run)."""
    mine = (state.valid > 0) & (slab_of(state.pos, params, scfg) == rank)
    return take(state, torch.nonzero(mine).squeeze(1))


def _local_coords(pos, params: FluidParams, scfg: SlabConfig, rank: int):
    """Cell coords on the rank's sweep grid of rows of its slab: plane
    ``1 + (gz - z0)``, clipped into the slab's own planes."""
    c = grid_cell_coords(pos, params, scfg.dims)
    lz = torch.clamp(c[:, 2] - _z0(scfg, rank), 0, scfg.nz_local - 1)
    return c, lz


def _halo_coords(cxy: torch.Tensor, scfg: SlabConfig, n_below: int):
    """Cell coords on the sweep grid of halo rows of global cell columns
    ``cxy`` [M, 2]: the first ``n_below`` (from the rank below) on plane 0,
    the rest on plane ``nz_local + 1``."""
    plane = torch.full_like(cxy[:, 0], scfg.nz_local + 1)
    plane[:n_below] = 0
    return torch.cat([cxy, plane[:, None]], dim=1)


def _edge_rows(lz: torch.Tensor, mask: torch.Tensor, scfg: SlabConfig,
               group: Group):
    """The rows to copy to each neighbour: those of ``mask`` in the slab's
    bottom plane go to the rank below, in its top plane to the rank above
    (both, when the slab is one plane deep).  Returns (row indices grouped
    by destination, the per-destination counts on the device)."""
    rank, world = group.rank, group.world
    none = torch.full_like(lz, world)
    down = torch.where(mask & (lz == 0) & (rank > 0),
                       torch.full_like(lz, rank - 1), none)
    up = torch.where(mask & (lz == scfg.nz_local - 1) & (rank < world - 1),
                     torch.full_like(lz, rank + 1), none)
    order, counts = _by_dest(torch.cat([down, up]), world)
    return order % lz.shape[0], counts


# ---------------------------------------------------------------------------
# the per-run ghost structure
# ---------------------------------------------------------------------------

def prepare(state: ParticleState, params: FluidParams, dt,
            scfg: SlabConfig, group: Group) -> CellAux:
    """The sweep params of the rank's grid and its ghost structure: its
    contributing ghosts and those of its neighbours' edge planes, sent
    once a run (``slab_pallas.make_slab_ghost_builder``).  The counterpart
    of ``sweeps.prepare``; ``run_substeps`` builds it before its loop."""
    pv = sweeps.make_pvec(params, dt, scfg.sweep_dims)
    contrib = (state.ghost > 0) & state.contrib_mask(params.ghost_face_active)
    c, lz = _local_coords(state.pos, params, scfg, group.rank)
    rows, counts = _edge_rows(lz, contrib, scfg, group)
    splits = group.splits(counts)
    sent = rows[:sum(splits.send)]
    halo = unpack_rows(group.exchange(pack_rows(take(state, sent)), splits))
    below = splits.recv[group.rank - 1] if group.rank > 0 else 0
    ext = concat(state, halo)
    hxy = grid_cell_coords(halo.pos, params, scfg.dims)[:, :2]
    coords = torch.cat([
        torch.stack([c[:, 0], c[:, 1], lz + 1], dim=1),
        _halo_coords(hxy, scfg, below)])
    every = torch.ones_like(ext.valid, dtype=torch.bool)
    key = cells.keys_from_coords(coords, every, scfg.sweep_dims)
    if not bool((ext.ghost > 0).any()):
        return CellAux(pv, None)
    return CellAux(pv, cells.build_ghosts(ext, params, scfg.sweep_dims, key))


# ---------------------------------------------------------------------------
# the substep
# ---------------------------------------------------------------------------

def solve(state: ParticleState, params: FluidParams, scfg: SlabConfig,
          group: Group, aux: CellAux) -> ParticleState:
    """The SPH stage of a substep on the rank's rows: both halo exchanges
    around the cell engine's kernels (the counterpart of ``sweeps.substep``).
    Returns the rank's rows in sorted order."""
    pv, ghosts = aux
    n = state.n
    fluid = state.fluid_mask()
    c, lz = _local_coords(state.pos, params, scfg, group.rank)

    # 1. source halo: pos, vel and cell column of the edge planes' fluid
    # rows
    rows, counts = _edge_rows(lz, fluid, scfg, group)
    splits = group.splits(counts)
    sent = rows[:sum(splits.send)]
    got = group.exchange(torch.cat([state.pos[sent], state.vel[sent],
                                    c[sent, :2].to(torch.float32)], 1),
                         splits)
    m = got.shape[0]
    coords = torch.stack([c[:, 0], c[:, 1], lz + 1], dim=1)
    ext = state
    if m:
        halo = ParticleState.zeros(m, device=state.pos.device).replace(
            pos=got[:, 0:3].contiguous(), vel=got[:, 3:6].contiguous(),
            valid=torch.ones(m, dtype=torch.int32, device=got.device))
        below = splits.recv[group.rank - 1] if group.rank > 0 else 0
        ext = concat(state, halo)
        coords = torch.cat([coords, _halo_coords(
            got[:, 6:8].to(torch.int32), scfg, below)])
    key = cells.keys_from_coords(coords, ext.fluid_mask(), scfg.sweep_dims)

    # 2. the table (#3) and the density sweep (#1) on local + halo rows
    tbl = cells.build(ext, params, scfg.sweep_dims, key)
    s = tbl.state
    rho, pres, src = sweeps.density_sources(tbl.key, s.pos, s.vel,
                                            tbl.cell_start, tbl.cell_end, pv,
                                            ghosts)

    # 3. density halo: the owners' density of the halo rows, in the order of
    # step 1, into their density and their source records
    where = torch.empty_like(tbl.order)
    where[tbl.order] = torch.arange(ext.n, device=where.device)
    rho_in = group.exchange(rho[where[sent]], splits)
    if m:
        hrow = where[n:]
        rho[hrow] = rho_in
        sweeps.set_source_density(src, hrow, rho_in, pv)

    # 4. the force sweep (#2), then the halo rows go
    npos, nvel, acc = sweeps.force_xsph(tbl.key, s.pos, s.vel, rho,
                                        tbl.cell_start, tbl.cell_end, pv,
                                        ghosts, src)
    out = sweeps.reassemble(s, rho, pres, npos, nvel, acc, params,
                            ghosts=ghosts is not None)
    return take(out, _compact(tbl.order < n, n)) if m else out


def _send(state: ParticleState, dest: torch.Tensor,
          group: Group) -> ParticleState:
    """Move each row to rank ``dest``: the rows that stay, in their order,
    then the arrivals by source rank (the merge of ``slabs._migrate``)."""
    leave = torch.where(dest != group.rank, dest,
                        torch.full_like(dest, group.world))
    order, counts = _by_dest(leave, group.world)
    splits = group.splits(counts)
    k = sum(splits.send)
    got = group.exchange(pack_rows(take(state, order[:k])), splits)
    if not (k or got.shape[0]):
        return state
    return concat(take(state, order[k:]), unpack_rows(got))


def migrate(state: ParticleState, params: FluidParams, scfg: SlabConfig,
            group: Group) -> ParticleState:
    """Fluid rows whose cell left the slab move to the slab above or below;
    the CFL cap keeps a row within one cell of where it was."""
    rank = group.rank
    gz = grid_cell_coords(state.pos, params, scfg.dims)[:, 2]
    z0 = _z0(scfg, rank)
    fluid = state.fluid_mask()
    dest = torch.full_like(gz, rank)
    dest = torch.where(fluid & (gz < z0), rank - 1, dest)
    dest = torch.where(fluid & (gz >= z0 + scfg.nz_local), rank + 1, dest)
    return _send(state, dest, group)


def route_all_to_all(state: ParticleState, params: FluidParams,
                     scfg: SlabConfig, group: Group) -> ParticleState:
    """Every fluid row to the slab of its cell, however far (the emitters'
    respawns teleport rows)."""
    dest = torch.where(state.fluid_mask(),
                       slab_of(state.pos, params, scfg).to(torch.int32),
                       torch.full_like(state.ghost, group.rank))
    return _send(state, dest, group)


def substep(state: ParticleState, params: FluidParams,
            buffers: SceneBuffers, dt, config: SimConfig, scfg: SlabConfig,
            group: Group, aux: CellAux
            ) -> Tuple[ParticleState, SceneBuffers]:
    """One substep of the rank's slab: solve, the scene stages, then
    migration, or the router in river and fountain mode."""
    state = solve(state, params, scfg, group, aux)
    state, buffers = scene_stages(state, params, buffers, dt, config)
    if config.river_mode or config.fountain_mode:
        return route_all_to_all(state, params, scfg, group), buffers
    return migrate(state, params, scfg, group), buffers


def run_substeps(state: ParticleState, params: FluidParams,
                 buffers: SceneBuffers, dt, n_substeps: int,
                 config: SimConfig, scfg: SlabConfig, group: Group
                 ) -> Tuple[ParticleState, SceneBuffers]:
    """``n_substeps`` of the rank's slab (``engine.step.run_substeps``'
    counterpart); the ghost structure is built once, before the loop.
    ``buffers.recycled`` counts this rank's respawns: :func:`recycled`
    sums them."""
    aux = prepare(state, params, dt, scfg, group)
    for _ in range(n_substeps):
        state, buffers = substep(state, params, buffers, dt, config, scfg,
                                 group, aux)
    return state, buffers


def recycled(buffers: SceneBuffers, group: Group) -> int:
    """The rows the emitters respawned on every rank."""
    return int(group.all_sum(buffers.recycled))


def gather_global(state: ParticleState, group: Group,
                  root: int = 0) -> Optional[ParticleState]:
    """Every rank's rows on ``root``, ordered by ``orig_id``; None on the
    other ranks."""
    counts = torch.zeros(group.world, dtype=torch.int64,
                         device=state.pos.device)
    counts[root] = state.n
    got = group.exchange(pack_rows(state), group.splits(counts))
    if group.rank != root:
        return None
    out = unpack_rows(got)
    return take(out, torch.argsort(out.orig_id, stable=True))
