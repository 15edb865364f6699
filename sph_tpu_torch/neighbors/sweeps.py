"""The cell engine's two neighbor sweeps and its substep
(counterpart of ``sph_tpu/neighbors/pallas_sweeps.py``).

1. **density**    — poly6 pair sums (``shaders/SPHFluid.comp:89-106``),
   floored, with the EOS pressure.
2. **force_xsph** — spiky-gradient pressure + viscosity Laplacian +
   color-field surface tension, gravity, semi-implicit Euler, the XSPH
   sweep (fresh self pos/vel against stale neighbor pos/vel) and its
   apply, and the CFL speed cap (``SPHFluid.comp:109-207``).
   **force_xsph_emit** is the same sweep with its outputs and rho packed
   into one ``[N, 16]`` row buffer (the emitted-row transport of
   ``SimConfig.emit_rows``, ``pallas_sweeps.py:763``).

The force sweep's kernel reads each source as two 16-byte **source
records** (:func:`pack_sources`): the density kernel writes them for the
sorted rows (:func:`density_sources`), the ghost structure carries its own
(``cells.GhostRows.records``).

Each sweep is a CUDA kernel (``csrc/sweeps.cu``) with a plain torch
version of the same function beside it.  The wrapper picks by the
device of its tensors: CPU tensors take the plain version, CUDA tensors
launch the kernel, anything else raises.  Both read the same inputs: rows
sorted by cell key and the per-cell row ranges of ``cells.py``, and, for a
state with ghosts, the static ghost structure (``cells.GhostRows``), whose
sources have rho0, P = 0 and v = 0 (``physics/brute_force.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from sph_tpu_torch.core.device import filled
from sph_tpu_torch.core.params import FluidParams, SimConfig
from sph_tpu_torch.core.state import ParticleState
from sph_tpu_torch.native import build
from sph_tpu_torch.neighbors import cells
from sph_tpu_torch.neighbors.cells import GhostRows
from sph_tpu_torch.physics import common as C
from sph_tpu_torch.physics import constraints
from sph_tpu_torch.physics.kernels import _PI
from sph_tpu_torch.utils import trace

# Rows per chunk of the plain versions: candidates are gathered as
# [rows, 9 * widest range] tensors, so this bounds their memory.
_PLAIN_CHUNK = 8192

# The force kernel's queue (kQueue and kMarginFrac in csrc/sweeps.cu): its
# entries a row, and its margin around the row's predicted position in h.
# The kernel's results do not depend on them; the scripts that count what
# the queue will meet do (app/neighbor_counts.py, chip_smoke.py).
FORCE_QUEUE = 32
FORCE_MARGIN = 0.05

# Columns of force_xsph_emit's rows, as the TPU's emitted rows
# (pallas_sweeps.py:775): npx npy npz vx vy vz ax ay az rho, then zeros.
EMIT_COLS = 16


# The sweep constants in the order of ``SphSweepParams`` (csrc/sweeps.h)
CONST_NAMES = ("h", "h2", "mass", "spiky", "visc_lap", "poly6", "mu", "st",
               "gx", "gy", "gz", "dt", "rho0", "gas_k", "rho_floor")


@dataclasses.dataclass(frozen=True, eq=False)
class SweepParams:
    """The sweeps' constants (the JAX kernels' ``pvec``,
    ``pallas_sweeps.py:104-115``) as a float32 block on the params' device,
    where the kernels read them (``csrc/sweeps.h``), and the grid dims on
    the host.  ``pv.h``, ``pv.dt``, ... (``CONST_NAMES``) are the constants
    as host floats, for the plain versions: the block comes to the host at
    the first such read, which on a card waits for the device."""
    consts: torch.Tensor    # [15] float32, CONST_NAMES in order
    nx: int
    ny: int
    nz: int

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny * self.nz

    @functools.cached_property
    def host(self) -> Tuple[float, ...]:
        return tuple(self.consts.tolist())

    def __getattr__(self, name):
        if name not in CONST_NAMES:
            raise AttributeError(name)
        return self.host[CONST_NAMES.index(name)]

    def __eq__(self, other) -> bool:
        return (isinstance(other, SweepParams)
                and (self.nx, self.ny, self.nz) == (other.nx, other.ny,
                                                    other.nz)
                and torch.equal(self.consts, other.consts))

    def replace(self, **consts) -> "SweepParams":
        """These params with the constants named in ``consts`` (host
        floats, written on the device) set anew."""
        out = self.consts.clone()
        for name, v in consts.items():
            out[CONST_NAMES.index(name)] = v
        return SweepParams(out, self.nx, self.ny, self.nz)


def make_pvec(params: FluidParams, dt, dims: Tuple[int, int, int]
              ) -> SweepParams:
    """Derive the sweep constants in float32 on the params' device.  Nothing
    here waits for the device: a ``dt`` that is no tensor is written by a
    fill, not copied from the host."""
    h = params.h
    if not isinstance(dt, torch.Tensor):
        dt = filled(dt, h.device)
    consts = torch.stack([
        h, h * h, params.mass,
        -45.0 / (_PI * h**6), 45.0 / (_PI * h**6),
        315.0 / (64.0 * _PI * h**9),
        params.viscosity, params.surface_tension,
        params.gravity[0], params.gravity[1], params.gravity[2],
        dt.to(torch.float32),
        params.rest_density, params.gas_constant,
        C.DENSITY_FLOOR_FRAC * params.rest_density,
    ]).to(torch.float32)
    return SweepParams(consts, *(int(d) for d in dims))


def _mass_over(rho: torch.Tensor, pv: SweepParams) -> torch.Tensor:
    """mass / max(rho, 1e-12), a true division as the kernel's (float /
    tensor would multiply by the reciprocal), with the mass read from the
    device block."""
    mass = pv.consts[CONST_NAMES.index("mass")]
    return torch.div(mass.expand_as(rho), torch.clamp_min(rho, 1e-12))


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------

def _candidates(key: torch.Tensor, cell_start: torch.Tensor,
                cell_end: torch.Tensor, pv: SweepParams):
    """Candidate rows of each (fluid) key's 3x3x3 block: the 9 contiguous
    x-ranges, padded to the widest and masked.  Returns idx, mask
    [m, 9 * width]."""
    x = key % pv.nx
    t = key // pv.nx
    z = t % pv.nz
    y = t // pv.nz
    x0 = (x - 1).clamp_min(0)
    x1 = (x + 1).clamp_max(pv.nx - 1)
    starts, ends = [], []
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            yy, zz = y + dy, z + dz
            ok = (yy >= 0) & (yy < pv.ny) & (zz >= 0) & (zz < pv.nz)
            row = pv.nx * (zz.clamp(0, pv.nz - 1)
                           + pv.nz * yy.clamp(0, pv.ny - 1))
            s = cell_start[(row + x0).long()]
            starts.append(torch.where(ok, s, 0))
            ends.append(torch.where(ok, cell_end[(row + x1).long()], 0))
    start = torch.stack(starts, 1).long()                  # [m, 9]
    end = torch.stack(ends, 1).long()
    width = int((end - start).max()) if key.numel() else 0
    idx = start[:, :, None] + torch.arange(width, device=key.device)
    mask = idx < end[:, :, None]
    idx = torch.where(mask, idx, 0)
    return idx.reshape(key.shape[0], -1), mask.reshape(key.shape[0], -1)


def _fluid_chunks(key: torch.Tensor, pv: SweepParams):
    rows = torch.nonzero(key < pv.num_cells).squeeze(1)
    for c0 in range(0, rows.shape[0], _PLAIN_CHUNK):
        yield rows[c0:c0 + _PLAIN_CHUNK]


def _density_raw(key, pos, src, starts, ends, pv: SweepParams):
    """sum over the sources ``src`` of (h^2 - r^2)^3 within h."""
    idx, mask = _candidates(key, starts, ends, pv)
    d = pos[:, None, :] - src[idx]
    r2 = torch.sum(d * d, dim=-1)
    dd = pv.h2 - r2
    return torch.sum(torch.where(mask & (r2 < pv.h2), dd * dd * dd, 0.0),
                     dim=1)


def density_plain(key, pos, cell_start, cell_end, pv: SweepParams,
                  ghosts: Optional[GhostRows] = None):
    """Plain torch version of ``density_kernel``: (rho, pres) [N]."""
    rho = torch.zeros(key.shape[0], dtype=torch.float32, device=key.device)
    pres = torch.zeros_like(rho)
    for r in _fluid_chunks(key, pv):
        raw = _density_raw(key[r], pos[r], pos, cell_start, cell_end, pv)
        if ghosts is not None:
            raw = raw + _density_raw(key[r], pos[r], ghosts.pos,
                                     ghosts.ghost_start, ghosts.ghost_end, pv)
        rr = torch.clamp_min(pv.mass * pv.poly6 * raw, pv.rho_floor)
        rho[r] = rr
        pres[r] = torch.clamp_min(pv.gas_k * (rr - pv.rho0), 0.0)
    return rho, pres


def _new_sources(n: int, ghosts: Optional[GhostRows], device):
    """A source-record array ``[2, n + G, 4]`` with the ghosts' rows filled
    in and rows ``[0, n)`` still to be written."""
    g = 0 if ghosts is None else ghosts.count
    src = torch.empty(2, n + g, 4, dtype=torch.float32, device=device)
    if g:
        src[:, n:] = ghosts.records
    return src


def pack_sources(pos, vel, rho, pv: SweepParams,
                 ghosts: Optional[GhostRows] = None) -> torch.Tensor:
    """The force kernel's source records, ``[2, N + G, 4]`` float32:
    ``[0, j] = (x, y, z, rho)`` and ``[1, j] = (vx, vy, vz, mass /
    max(rho, 1e-12))``; rows ``[0, N)`` are the sorted rows, rows
    ``[N, N + G)`` the ghost structure's (``GhostRows.records``).  Plain
    torch version of what ``density_kernel`` packs."""
    n = pos.shape[0]
    src = _new_sources(n, ghosts, pos.device)
    src[0, :n, :3] = pos
    src[0, :n, 3] = rho
    src[1, :n, :3] = vel
    src[1, :n, 3] = _mass_over(rho, pv)
    return src


def set_source_density(src: torch.Tensor, rows: torch.Tensor,
                       rho: torch.Tensor, pv: SweepParams) -> None:
    """Write the density ``rho`` of the sorted rows ``rows`` into their
    source records ``src`` (:func:`pack_sources`' layout, in place): a slab's
    halo rows take their owner's density after the density sweep
    (``parallel/slabs.py``)."""
    src[0, rows, 3] = rho
    src[1, rows, 3] = _mass_over(rho, pv)


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _sources(key, r, pos, vel, rho, cell_start, cell_end, pv: SweepParams,
             ghosts: Optional[GhostRows]):
    """Candidate sources of the rows ``r``: (pos, vel, rho, pres, mask)
    [m, k, ...], the fluid rows (self excluded) and then the ghosts (rho0,
    P = 0, v = 0)."""
    idx, cand = _candidates(key[r], cell_start, cell_end, pv)
    cand = cand & (idx != r[:, None])
    rhoj = rho[idx]
    out = [(pos[idx], vel[idx], rhoj,
            torch.clamp_min(pv.gas_k * (rhoj - pv.rho0), 0.0),
            cand & (rhoj > 0.0))]
    if ghosts is not None:
        gidx, gcand = _candidates(key[r], ghosts.ghost_start,
                                  ghosts.ghost_end, pv)
        gp = ghosts.pos[gidx]
        out.append((gp, torch.zeros_like(gp),
                    torch.full_like(gp[..., 0], pv.rho0),
                    torch.zeros_like(gp[..., 0]), gcand))
    return [torch.cat(t, dim=1) for t in zip(*out)]


def force_xsph_plain(key, pos, vel, rho, cell_start, cell_end,
                     pv: SweepParams, ghosts: Optional[GhostRows] = None):
    """Plain torch version of ``force_xsph_kernel``: (npos, nvel, acc)."""
    npos, nvel = pos.clone(), vel.clone()
    acc = torch.zeros_like(pos)
    g = torch.tensor([pv.gx, pv.gy, pv.gz], dtype=torch.float32,
                     device=pos.device)
    for r in _fluid_chunks(key, pv):
        pj, vj, rhoj, presj, src = _sources(key, r, pos, vel, rho,
                                            cell_start, cell_end, pv, ghosts)
        pi, vi, rhoi = pos[r], vel[r], rho[r]
        presi = torch.clamp_min(pv.gas_k * (rhoi - pv.rho0), 0.0)

        # pass 1: pressure, viscosity, color field
        rij = pi[:, None, :] - pj
        rr = _norm(rij)
        live = src & (rr < pv.h)
        m_over_rho = torch.where(live, pv.mass / torch.clamp_min(rhoj, 1e-12),
                                 0.0)
        dcl = pv.h - rr
        gmag = torch.where(rr > 0.0,
                           pv.spiky * dcl * dcl / torch.clamp_min(rr, 1e-12),
                           0.0)
        lapw = pv.visc_lap * dcl
        ps = gmag * (-(presi[:, None] + presj) * 0.5 * m_over_rho)
        vs = m_over_rho * lapw
        gs = gmag * m_over_rho
        fp = torch.sum(rij * ps[..., None], dim=1)
        fv = torch.sum((vj - vi[:, None, :]) * vs[..., None], dim=1)
        gc = torch.sum(rij * gs[..., None], dim=1)
        lc = torch.sum(vs, dim=1)

        # surface tension, gravity, integrate
        glen = _norm(gc)
        st = torch.where((glen > C.SURFACE_THRESHOLD)[:, None],
                         (-pv.st * lc)[:, None]
                         * (gc / torch.clamp_min(glen, 1e-30)[:, None]), 0.0)
        a = ((fp + pv.mu * fv + g * rhoi[:, None] + st)
             / torch.clamp_min(rhoi, 1e-12)[:, None])
        nv = (vi + a * pv.dt) * C.VELOCITY_DAMPING
        np_ = pi + nv * pv.dt

        # pass 2: XSPH, fresh self against stale neighbors
        d = np_[:, None, :] - pj
        r2 = torch.sum(d * d, dim=-1)
        near = src & (r2 < pv.h2)
        dd = pv.h2 - r2
        w = torch.where(near, pv.poly6 * dd * dd * dd, 0.0)
        mw = w * pv.mass / torch.clamp_min(rhoj, 1e-12)
        xs = torch.sum((vj - nv[:, None, :]) * mw[..., None], dim=1)
        xn = torch.sum(w, dim=1)

        # XSPH apply + CFL cap
        v = nv + torch.where(
            (xn > 0.0)[:, None],
            C.XSPH_COEFF * (xs / torch.clamp_min(xn, 1e-30)[:, None]), 0.0)
        max_speed = C.CFL_FRACTION * pv.h / max(pv.dt, 1e-6)
        sp = _norm(v)
        scale = torch.where(sp > max_speed,
                            max_speed / torch.clamp_min(sp, 1e-30), 1.0)
        npos[r] = np_
        nvel[r] = v * scale[:, None]
        acc[r] = a
    return npos, nvel, acc


def force_xsph_emit_plain(key, pos, vel, rho, cell_start, cell_end,
                          pv: SweepParams, ghosts: Optional[GhostRows] = None):
    """Plain torch version of ``force_xsph_emit_kernel``: per [N, 16], the
    outputs of ``force_xsph_plain`` and ``rho`` packed by ``torch.cat``."""
    npos, nvel, acc = force_xsph_plain(key, pos, vel, rho, cell_start,
                                       cell_end, pv, ghosts)
    pad = torch.zeros(key.shape[0], EMIT_COLS - 10, dtype=torch.float32,
                      device=key.device)
    return torch.cat([npos, nvel, acc, rho[:, None], pad], dim=1)


# ---------------------------------------------------------------------------
# wrappers: plain version on CPU tensors, the CUDA kernel on CUDA tensors
# ---------------------------------------------------------------------------

def _check_rows(key, pos, cell_start, cell_end, pv: SweepParams,
                ghosts: Optional[GhostRows], **more):
    dev = key.device
    n = key.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"the sweep kernels take CUDA or CPU tensors, "
                         f"got {dev}")
    if n >= 2**31 // 3:
        raise ValueError(f"{n} rows overflow the kernels' int32 indexing")
    check = build.check_tensor
    check("sweep params", pv.consts, torch.float32, (len(CONST_NAMES),), dev)
    check("key", key, torch.int32, (n,), dev)
    check("pos", pos, torch.float32, (n, 3), dev)
    check("cell_start", cell_start, torch.int32, (pv.num_cells,), dev)
    check("cell_end", cell_end, torch.int32, (pv.num_cells,), dev)
    for name, (t, shape) in more.items():
        check(name, t, torch.float32, shape, dev)
    if ghosts is not None:
        check("ghost pos", ghosts.pos, torch.float32, (ghosts.count, 3), dev)
        check("ghost_start", ghosts.ghost_start, torch.int32,
              (pv.num_cells,), dev)
        check("ghost_end", ghosts.ghost_end, torch.int32, (pv.num_cells,),
              dev)
        check("ghost records", ghosts.records, torch.float32,
              (2, ghosts.count, 4), dev)
        check("ghost near", ghosts.near, torch.uint8, (pv.num_cells,), dev)


def _ghost_args(ghosts: Optional[GhostRows]):
    """The force kernels' ghost arguments: the ranges' start and end
    pointers and the flag (the ghosts' rows are in the source records)."""
    if ghosts is None:
        return None, None, 0
    return ghosts.ghost_start.data_ptr(), ghosts.ghost_end.data_ptr(), 1


def _density_ghost_args(ghosts: Optional[GhostRows]):
    """The density kernel's ghost arguments: the positions, the ranges'
    start and end, and the cells near a ghost; all null without ghosts."""
    if ghosts is None:
        return None, None, None, None
    return (ghosts.pos.data_ptr(), ghosts.ghost_start.data_ptr(),
            ghosts.ghost_end.data_ptr(), ghosts.near.data_ptr())


def c_params(pv: SweepParams):
    """The kernels' params arguments: the device block's address and the
    grid dims."""
    return pv.consts.data_ptr(), pv.nx, pv.ny, pv.nz


def _launch_density(key, pos, vel, cell_start, cell_end, pv: SweepParams,
                    ghosts: Optional[GhostRows], src):
    lib = build.library()
    n = key.shape[0]
    rho = torch.empty(n, dtype=torch.float32, device=key.device)
    pres = torch.empty_like(rho)
    err = lib.sph_density(
        key.data_ptr(), pos.data_ptr(),
        None if vel is None else vel.data_ptr(), cell_start.data_ptr(),
        cell_end.data_ptr(), n, *_density_ghost_args(ghosts),
        *c_params(pv), rho.data_ptr(), pres.data_ptr(),
        None if src is None else src.data_ptr(),
        0 if src is None else src.shape[1],
        torch.cuda.current_stream(key.device).cuda_stream)
    build.launched("density", err)
    return rho, pres


def density(key, pos, cell_start, cell_end, pv: SweepParams,
            ghosts: Optional[GhostRows] = None):
    """(rho, pres) [N] of the sorted rows; non-fluid rows get 0."""
    if key.device.type == "cpu":
        return density_plain(key, pos, cell_start, cell_end, pv, ghosts)
    _check_rows(key, pos, cell_start, cell_end, pv, ghosts)
    return _launch_density(key, pos, None, cell_start, cell_end, pv, ghosts,
                           None)


def density_sources(key, pos, vel, cell_start, cell_end, pv: SweepParams,
                    ghosts: Optional[GhostRows] = None):
    """(rho, pres, sources): :func:`density`, and the force sweep's source
    records of these rows and ``ghosts`` (:func:`pack_sources`), which the
    same kernel launch writes for the sorted rows."""
    if key.device.type == "cpu":
        rho, pres = density_plain(key, pos, cell_start, cell_end, pv, ghosts)
        return rho, pres, pack_sources(pos, vel, rho, pv, ghosts)
    n = key.shape[0]
    _check_rows(key, pos, cell_start, cell_end, pv, ghosts,
                vel=(vel, (n, 3)))
    src = _new_sources(n, ghosts, key.device)
    rho, pres = _launch_density(key, pos, vel, cell_start, cell_end, pv,
                                ghosts, src)
    return rho, pres, src


def _force_sources(key, pos, vel, rho, cell_start, cell_end,
                   pv: SweepParams, ghosts: Optional[GhostRows], sources):
    """Check the force kernels' inputs; the source records, packed here
    when the caller has none from :func:`density_sources`."""
    n = key.shape[0]
    _check_rows(key, pos, cell_start, cell_end, pv, ghosts,
                vel=(vel, (n, 3)), rho=(rho, (n,)))
    if sources is None:
        return pack_sources(pos, vel, rho, pv, ghosts)
    g = 0 if ghosts is None else ghosts.count
    build.check_tensor("sources", sources, torch.float32, (2, n + g, 4),
                       key.device)
    return sources


def tile_warp_mask(key: torch.Tensor, num_cells: int, nx: int
                   ) -> torch.Tensor:
    """Which warps of ``force_xsph_kernel`` take its tile path, [N // 32]
    bool: of the sorted rows' aligned groups of 32 (the kernel's warps; a
    partial last one never does), those whose rows are all fluid (``key <
    num_cells``) and of one cell, or of two cells side by side in x (keys
    k and k + 1 in one grid row of ``nx`` cells).  Plain torch, on any
    device."""
    w = key[:key.shape[0] // 32 * 32].reshape(-1, 32)
    k0 = w[:, :1]
    pair = (w == k0 + 1) & (k0 % nx + 1 < nx)
    return ((w == k0) | pair).all(1) & (w[:, 0] < num_cells)


def tile_warp_count(key: torch.Tensor, num_cells: int, nx: int) -> int:
    """How many warps take the force kernel's tile path
    (:func:`tile_warp_mask`)."""
    return int(tile_warp_mask(key, num_cells, nx).sum())


def _tile_counter(tile_warps: Optional[torch.Tensor], key, pv: SweepParams):
    """The force kernels' counter argument: null, or the address of
    ``tile_warps``, one int32 on the key's device; on CPU tensors the plain
    count is added to it here."""
    if tile_warps is None:
        return None
    build.check_tensor("tile_warps", tile_warps, torch.int32, (1,),
                       key.device)
    if key.device.type == "cpu":
        tile_warps += tile_warp_count(key, pv.num_cells, pv.nx)
    return tile_warps.data_ptr()


def force_xsph(key, pos, vel, rho, cell_start, cell_end, pv: SweepParams,
               ghosts: Optional[GhostRows] = None,
               sources: Optional[torch.Tensor] = None,
               tile_warps: Optional[torch.Tensor] = None):
    """(npos, nvel, acc) [N,3] of the sorted rows; non-fluid rows pass
    through (npos = pos, nvel = vel, acc = 0).  ``sources`` are the source
    records of ``pos``, ``vel``, ``rho`` and ``ghosts`` when the caller has
    them (:func:`density_sources`); the kernel reads only those.  Given
    ``tile_warps`` (one int32), the warps that took the kernel's tile path
    are added to it (:func:`tile_warp_count`)."""
    counter = _tile_counter(tile_warps, key, pv)
    if key.device.type == "cpu":
        return force_xsph_plain(key, pos, vel, rho, cell_start, cell_end, pv,
                                ghosts)
    src = _force_sources(key, pos, vel, rho, cell_start, cell_end, pv, ghosts,
                         sources)
    lib = build.library()
    npos = torch.empty_like(pos)
    nvel = torch.empty_like(vel)
    acc = torch.empty_like(pos)
    err = lib.sph_force_xsph(
        key.data_ptr(), src.data_ptr(), src.shape[1], cell_start.data_ptr(),
        cell_end.data_ptr(), key.shape[0], *_ghost_args(ghosts),
        *c_params(pv), npos.data_ptr(), nvel.data_ptr(), acc.data_ptr(),
        torch.cuda.current_stream(key.device).cuda_stream, counter)
    build.launched("force_xsph", err)
    return npos, nvel, acc


def force_xsph_emit(key, pos, vel, rho, cell_start, cell_end,
                    pv: SweepParams, ghosts: Optional[GhostRows] = None,
                    sources: Optional[torch.Tensor] = None,
                    tile_warps: Optional[torch.Tensor] = None):
    """per [N, 16] of the sorted rows: cols 0:3 npos, 3:6 nvel, 6:9 acc
    (as ``force_xsph``), 9 rho (the input), 10:16 zero."""
    counter = _tile_counter(tile_warps, key, pv)
    if key.device.type == "cpu":
        return force_xsph_emit_plain(key, pos, vel, rho, cell_start,
                                     cell_end, pv, ghosts)
    src = _force_sources(key, pos, vel, rho, cell_start, cell_end, pv, ghosts,
                         sources)
    lib = build.library()
    n = key.shape[0]
    per = torch.empty(n, EMIT_COLS, dtype=torch.float32, device=key.device)
    err = lib.sph_force_xsph_emit(
        key.data_ptr(), src.data_ptr(), src.shape[1], cell_start.data_ptr(),
        cell_end.data_ptr(), n, *_ghost_args(ghosts), *c_params(pv),
        per.data_ptr(), torch.cuda.current_stream(key.device).cuda_stream,
        counter)
    build.launched("force_xsph_emit", err)
    return per


# ---------------------------------------------------------------------------
# substep composition
# ---------------------------------------------------------------------------

class CellAux(NamedTuple):
    """Per-run constants of the cell engine (the counterpart of
    ``pallas_sweeps.build_aux``, ``:1180-1195``)."""
    pv: SweepParams
    ghosts: Optional[GhostRows]   # None when the state holds no ghosts


def prepare(state: ParticleState, params: FluidParams, dt,
            config: SimConfig) -> CellAux:
    """The sweep params and, for a state with ghosts, the static ghost
    structure.  Ghosts never move and face activation is fixed within a
    run, so ``engine.run_substeps`` builds this once, before its loop."""
    pv = make_pvec(params, dt, config.grid_dims)
    trace.count("host_waits")       # the bool of .any() waits for the card
    if not bool((state.ghost > 0).any()):
        return CellAux(pv, None)
    return CellAux(pv, cells.build_ghosts(state, params, config.grid_dims))


def reassemble(s: ParticleState, rho, pres, npos, nvel, acc,
               params: FluidParams, ghosts: bool = False,
               contain: bool = False) -> ParticleState:
    """Sweep outputs -> the sorted particle state, with foam
    (:func:`reassemble_plain`), and with ``contain`` the container applied
    to it as well (``constraints.apply_container``, the stage that follows
    in a substep).  On CPU tensors the plain versions, one after the other;
    on CUDA tensors one launch of the container pass
    (``constraints.container_pass``, ``csrc/container.cu``); any other
    device raises ``ValueError``."""
    if s.pos.device.type == "cpu":
        out = reassemble_plain(s, rho, pres, npos, nvel, acc, params, ghosts)
        if contain:
            out = constraints.apply_container_plain(out, params)
        return out
    return constraints.container_pass(s, params, (rho, pres, npos, nvel, acc),
                                      ghosts=ghosts, contain=contain)


def reassemble_plain(s: ParticleState, rho, pres, npos, nvel, acc,
                     params: FluidParams, ghosts: bool = False
                     ) -> ParticleState:
    """Plain torch version of the reassembly.  The sweeps already pass
    non-fluid rows through (pos, vel kept; acc, rho, pres zero), so only
    foam needs the fluid mask, and ghost rows follow the oracle
    (``brute_force.substep``, ``common.finish_density``) when ``ghosts``: a
    contributing ghost gets rho0, P = 0, v = 0 and acc = 0, a ghost on an
    inactive face keeps its old values."""
    foam = torch.where(s.fluid_mask(),
                       C.foam_update(s.foam, nvel, rho, params), s.foam)
    if ghosts:
        g = s.ghost > 0
        on = g & s.contrib_mask(params.ghost_face_active)
        off = g & ~on
        rho = torch.where(on, params.rest_density,
                          torch.where(off, s.density, rho))
        pres = torch.where(g, torch.where(on, 0.0, s.pressure), pres)
        nvel = torch.where(on[:, None], 0.0,
                           torch.where(off[:, None], s.vel, nvel))
        acc = torch.where(on[:, None], 0.0,
                          torch.where(off[:, None], s.acc, acc))
    return s.replace(pos=npos, vel=nvel, acc=acc, density=rho,
                     pressure=pres, foam=foam)


def substep(state: ParticleState, params: FluidParams, dt,
            config: SimConfig, aux: Optional[CellAux] = None,
            contain: bool = False) -> ParticleState:
    """One cell-engine substep.  Returns the state in SORTED order
    (identity lives in ``orig_id``), as the JAX engine does.  With
    ``contain`` the container is applied too, in the pass that reassembles
    the sweeps' outputs (:func:`reassemble`): ``engine.step.substep`` then
    leaves it out of its scene stages.

    With ``config.emit_rows`` the force sweep packs its outputs and rho
    into rows and the state reads pos, vel, acc and rho from there
    (``pallas_sweeps.py:1279-1335``; the pressure is the density sweep's,
    a function of the same rho); the result is bit-identical."""
    if aux is None:
        aux = prepare(state, params, dt, config)
    pv, ghosts = aux
    rows = cells.build(state, params, config.grid_dims)
    s = rows.state
    rho, pres, src = density_sources(rows.key, s.pos, s.vel, rows.cell_start,
                                     rows.cell_end, pv, ghosts)
    if config.emit_rows:
        per = force_xsph_emit(rows.key, s.pos, s.vel, rho, rows.cell_start,
                              rows.cell_end, pv, ghosts, src)
        npos, nvel, acc, rho = per[:, 0:3], per[:, 3:6], per[:, 6:9], per[:, 9]
    else:
        npos, nvel, acc = force_xsph(rows.key, s.pos, s.vel, rho,
                                     rows.cell_start, rows.cell_end, pv,
                                     ghosts, src)
    return reassemble(s, rho, pres, npos, nvel, acc, params,
                      ghosts=ghosts is not None, contain=contain)
