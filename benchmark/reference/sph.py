"""Plain reference of one frame: fixed-dt substeps of cell-list WCSPH in a
box, with ghost sources, in plain PyTorch.

A frozen copy of the plain versions that sit beside the port's kernels
(``sph_tpu_torch/neighbors/cells.py`` ``cell_table_plain``,
``neighbors/sweeps.py`` ``density_plain`` and ``force_xsph_plain``,
``physics/common.py``, ``physics/constraints.py`` ``apply_container`` with
the box projector), rewritten to stand alone: it imports nothing of the
port.  Everything the port derives from the configuration (the particle
mass, the sweep constants, the grid and the cell ranges, the ghost
structure) is worked out again here from the configuration file.

One substep, as the reference shaders run it (``SPHFluid.comp``) with the
Jacobi split of the JAX package:

1. y-major cell keys ``x + nx*(z + nz*y)`` of the fluid rows (other rows
   take ``num_cells``), a stable sort that moves every column, and each
   cell's row range;
2. density: poly6 sums over fluid sources and active ghost sources within
   h, floored at half the rest density, and the pressure;
3. force: pressure, viscosity and colour-field terms, surface tension,
   gravity, semi-implicit Euler with damping, XSPH against the stale
   sources, the CFL speed cap;
4. reassembly: foam, and the ghosts' fixed values;
5. the box container, rotated or not, with restitution and friction.

Where the configuration names a ``frame_prologue``, a frame starts with it,
once, before its substeps: the wave kick (``Scene0p.cpp:1303-1307``),
v += d A sin(2 pi / lambda (p . d) + phase) on the live fluid rows, d the
direction normalised and A = strength dt substeps (dt-premultiplied, a
frame of substeps standing in for one reference frame).

``low=True`` rounds the inputs of every matrix product (the keys', the
container's and the wave's transforms) to TF32, 10 bits of mantissa, as a
tensor core takes them: the control of the output check.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

FIELDS = ("pos", "vel", "acc", "density", "pressure", "foam", "ghost",
          "active", "face", "color_group", "valid", "orig_id")

PI = 3.141592653589
XSPH_COEFF = 0.12
VELOCITY_DAMPING = 0.995
FOAM_DECAY = 0.995
DENSITY_FLOOR_FRAC = 0.5
CFL_FRACTION = 0.4
SURFACE_THRESHOLD = 1e-6
# candidate pairs gathered at once (bounds the reference's memory)
PAIR_BUDGET = 1 << 23

State = Dict[str, torch.Tensor]


def grid_dims(box_half, h: float, cap: int,
              round_to: int = 8) -> Tuple[int, int, int]:
    """Cells per axis: ``ceil(2 (half + h) / h)``, clamped to [1, cap] and
    rounded up to a multiple of ``round_to`` (the port's
    ``compute_grid_dims`` for a box)."""
    half = np.asarray(box_half, np.float32)
    dims = []
    for e in half + np.float32(h):
        d = min(cap, max(1, int(np.ceil((2.0 * e) / h))))
        dims.append(min(cap, ((d + round_to - 1) // round_to) * round_to))
    return tuple(dims)


def rotation(euler_deg) -> np.ndarray:
    """World-from-box rotation ``Rz @ Ry @ Rx`` of XYZ euler degrees."""
    x, y, z = np.radians(np.asarray(euler_deg, np.float64))
    rx = np.array([[1, 0, 0], [0, math.cos(x), -math.sin(x)],
                   [0, math.sin(x), math.cos(x)]])
    ry = np.array([[math.cos(y), 0, math.sin(y)], [0, 1, 0],
                   [-math.sin(y), 0, math.cos(y)]])
    rz = np.array([[math.cos(z), -math.sin(z), 0],
                   [math.sin(z), math.cos(z), 0], [0, 0, 1]])
    return (rz @ ry @ rx).astype(np.float32)


def rotation32(euler_deg, device) -> torch.Tensor:
    """``rotation`` as a float32 program works it out: the degrees and
    pi / 180 in float32, their product's cosines and sines in float32, and
    ``Rz @ Ry @ Rx`` as two float32 matrix products.  The frame's keys and
    container use it: a row resting on a wall lies on a cell boundary (the
    grid starts one h outside the walls), so the last bit of R picks its
    cell, its place in the stable sort and the order of its pair sums.  At
    zero angles it is the identity, as ``rotation`` is."""
    rad = torch.tensor(euler_deg, dtype=torch.float32,
                       device=device) * (math.pi / 180.0)
    c, s = torch.cos(rad), torch.sin(rad)

    def about(axis: int, i: int, j: int) -> torch.Tensor:
        r = torch.eye(3, dtype=torch.float32, device=device)
        r[i, i], r[i, j], r[j, i], r[j, j] = c[axis], -s[axis], s[axis], \
            c[axis]
        return r

    return about(2, 0, 1) @ about(1, 2, 0) @ about(0, 1, 2)


def wave_prologue(cfg: dict):
    """The configuration's ``frame_prologue``, the wave kick, or None where
    it names none; the one check of its ``kind`` for the port's side and
    the reference's."""
    w = cfg.get("frame_prologue")
    if w is not None and w.get("kind") != "wave":
        raise ValueError(f"frame_prologue kind {w.get('kind')!r}; the "
                         f"harness runs 'wave'")
    return w


@dataclasses.dataclass(frozen=True)
class Physics:
    """The constants of one configuration, as float32 numbers, and its
    grid."""
    h: float
    mass: float
    rho0: float
    gas_k: float
    mu: float
    st: float
    gravity: Tuple[float, float, float]
    dt: float
    foam_gen: float
    foam_vel_ref: float
    box_center: Tuple[float, float, float]
    box_half: Tuple[float, float, float]
    box_euler_deg: Tuple[float, float, float]
    restitution: float
    friction: float
    faces: Tuple[int, ...]
    dims: Tuple[int, int, int]

    @classmethod
    def from_config(cls, cfg: dict) -> "Physics":
        f32 = lambda v: float(np.float32(v))  # noqa: E731
        h = np.float32(cfg["h"])
        rho0 = np.float32(cfg["rest_density"])
        spacing = np.float32(0.85) * h
        if cfg.get("shape", "box") != "box":
            raise ValueError("the reference holds the box container only")
        return cls(
            h=f32(h), mass=f32(rho0 * spacing ** 3), rho0=f32(rho0),
            gas_k=f32(cfg["gas_constant"]), mu=f32(cfg["viscosity"]),
            st=f32(cfg["surface_tension"]),
            gravity=tuple(f32(g) for g in cfg["gravity"]),
            dt=f32(cfg["dt"]), foam_gen=f32(cfg["foam_gen"]),
            foam_vel_ref=f32(cfg["foam_vel_ref"]),
            box_center=tuple(f32(c) for c in cfg["box_center"]),
            box_half=tuple(f32(c) for c in cfg["box_half"]),
            box_euler_deg=tuple(f32(c) for c in cfg["box_euler_deg"]),
            restitution=f32(cfg["wall_restitution"]),
            friction=f32(cfg["wall_friction"]),
            faces=tuple(int(f) for f in cfg["ghost_face_active"]),
            dims=grid_dims(cfg["box_half"], float(h), int(cfg["grid_cap"])))

    @property
    def num_cells(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 bits of mantissa, to nearest
    even."""
    bits = x.contiguous().view(torch.int32)
    bits = bits + (0xFFF + ((bits >> 13) & 1))
    return (bits & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, low: bool) -> torch.Tensor:
    return tf32(a) @ tf32(b) if low else a @ b


class Frame:
    """The frame of one configuration on one device: ``run(state, n)``."""

    def __init__(self, cfg: dict, device, low: bool = False):
        self.p = Physics.from_config(cfg)
        self.dev = torch.device(device)
        self.low = low
        p = self.p
        f = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                                   device=self.dev)
        self.rot = rotation32(p.box_euler_deg, self.dev)
        self.center = f(p.box_center)
        self.half = f(p.box_half)
        self.gmin = -(self.half + f(p.h))
        self.hmax = torch.tensor([d - 1 for d in p.dims], dtype=torch.int32,
                                 device=self.dev)
        self.gravity = f(p.gravity)
        self.faces = torch.tensor(p.faces, dtype=torch.int32,
                                  device=self.dev)
        h = f(p.h)
        # the kernel constants, worked out in float32 as the shaders do
        self.h2 = float(h * h)
        self.poly6 = float(315.0 / (64.0 * PI * h ** 9))
        self.spiky = float(-45.0 / (PI * h ** 6))
        self.visc_lap = float(45.0 / (PI * h ** 6))
        self.rho_floor = float(np.float32(DENSITY_FLOOR_FRAC * p.rho0))
        self.wave = wave_prologue(cfg)
        if self.wave is not None:
            d = f(self.wave["direction"])
            norm = torch.sqrt(torch.sum(d * d))
            if not float(norm) > 0.0:
                raise ValueError("the wave's direction is zero")
            self.wave_dir = d / norm

    # -- neighbour structure ------------------------------------------------
    def keys(self, pos: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        local = matmul(pos - self.center[None, :], self.rot, self.low)
        c = torch.floor((local - self.gmin[None, :])
                        / torch.tensor(self.p.h, device=self.dev)
                        ).to(torch.int32)
        c = torch.minimum(c.clamp_min(0), self.hmax[None, :])
        nx, ny, nz = self.p.dims
        key = c[:, 0] + nx * (c[:, 2] + nz * c[:, 1])
        return torch.where(mask, key, torch.full_like(key, self.p.num_cells))

    def cell_plane_gap(self, pos: torch.Tensor) -> torch.Tensor:
        """Each row's distance from the nearest plane between two cells of
        the grid, in the box's frame (in full precision)."""
        local = (pos - self.center[None, :]) @ self.rot
        u = (local - self.gmin[None, :]) / self.p.h
        return ((u - torch.round(u)).abs() * self.p.h).amin(dim=1)

    def ranges(self, skey: torch.Tensor):
        cells = torch.arange(self.p.num_cells, dtype=skey.dtype,
                             device=self.dev)
        return (torch.searchsorted(skey, cells),
                torch.searchsorted(skey, cells, right=True))

    def ghosts(self, st: State):
        """Active ghost sources sorted by key, and their cell ranges."""
        contrib = self.contrib(st)
        rows = torch.nonzero((st["ghost"] > 0) & contrib).squeeze(1)
        key = self.keys(st["pos"][rows], torch.ones_like(rows, dtype=bool))
        skey, order = torch.sort(key, stable=True)
        return (st["pos"][rows[order]],) + self.ranges(skey)

    def contrib(self, st: State) -> torch.Tensor:
        face_on = self.faces[st["face"].clamp(0, 5).long()] > 0
        return (st["valid"] > 0) & torch.where(st["ghost"] > 0, face_on,
                                               torch.ones_like(face_on))

    def block_ranges(self, key, start, end):
        """The 9 x-ranges of rows of each key's 3x3x3 block: (first, end)
        [m, 9], empty where the block leaves the grid."""
        nx, ny, nz = self.p.dims
        x, t = key % nx, key // nx
        z, y = t % nz, t // nz
        x0, x1 = (x - 1).clamp_min(0), (x + 1).clamp_max(nx - 1)
        starts, ends = [], []
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                yy, zz = y + dy, z + dz
                ok = (yy >= 0) & (yy < ny) & (zz >= 0) & (zz < nz)
                row = nx * (zz.clamp(0, nz - 1) + nz * yy.clamp(0, ny - 1))
                starts.append(torch.where(ok, start[(row + x0).long()], 0))
                ends.append(torch.where(ok, end[(row + x1).long()], 0))
        return torch.stack(starts, 1).long(), torch.stack(ends, 1).long()

    def pair_chunks(self, rows, key, tables):
        """The candidate pairs of the sorted rows ``rows``, in chunks of
        whole rows of at most about ``PAIR_BUDGET`` pairs: (rows of the
        chunk, i, j), with ``j`` into the sources of ``tables``, a list of
        (cell start, cell end, offset of these sources)."""
        firsts, counts = [], []
        for start, end, offset in tables:
            s, e = self.block_ranges(key[rows], start, end)
            firsts.append(s + offset)
            counts.append((e - s).clamp_min(0))
        first = torch.cat(firsts, 1)                   # [m, 9 * tables]
        count = torch.cat(counts, 1)
        per_row = torch.cumsum(count.sum(1), 0)
        bounds = torch.searchsorted(
            per_row, torch.arange(PAIR_BUDGET, int(per_row[-1]) + PAIR_BUDGET
                                  if len(rows) else 1, PAIR_BUDGET,
                                  device=self.dev), right=True).tolist()
        lo = 0
        for hi in sorted(set(bounds + [len(rows)])):
            if hi <= lo:
                continue
            f, c = first[lo:hi].reshape(-1), count[lo:hi].reshape(-1)
            seg = torch.repeat_interleave(torch.arange(len(c),
                                                       device=self.dev), c)
            ends = torch.cumsum(c, 0)
            j = f[seg] + torch.arange(len(seg), device=self.dev) - (
                ends - c)[seg]
            i = rows[lo:hi][seg // count.shape[1]]
            yield rows[lo:hi], i, j
            lo = hi

    def tables(self, start, end, gstart, gend, n):
        """(cell start, cell end, offset) of the fluid sources and, where
        there are ghosts, of the ghost sources after them."""
        out = [(start, end, 0)]
        if gstart is not None:
            out.append((gstart, gend, n))
        return out

    # -- one substep --------------------------------------------------------
    def substep(self, st: State) -> State:
        p = self.p
        fluid = (st["valid"] > 0) & (st["ghost"] == 0)
        key = self.keys(st["pos"], fluid)
        skey, order = torch.sort(key, stable=True)
        st = {k: v[order] for k, v in st.items()}
        start, end = self.ranges(skey)
        gpos, gstart, gend = self.ghosts(st)
        has_ghosts = len(gpos) > 0
        pos, vel = st["pos"], st["vel"]
        n = len(skey)
        tables = self.tables(start, end, *((gstart, gend) if has_ghosts
                                           else (None, None)), n)
        live = torch.nonzero(skey < p.num_cells).squeeze(1)

        # density: every source within h, itself included
        src_pos = torch.cat([pos, gpos])
        raw = torch.zeros(n, dtype=torch.float32, device=self.dev)
        for _, i, j in self.pair_chunks(live, skey, tables):
            d = pos[i] - src_pos[j]
            r2 = torch.sum(d * d, dim=-1)
            dd = self.h2 - r2
            raw.index_add_(0, i, torch.where(r2 < self.h2, dd * dd * dd, 0.0))
        rho = torch.zeros_like(raw)
        rr = torch.clamp_min(p.mass * self.poly6 * raw[live], self.rho_floor)
        rho[live] = rr
        pres = torch.zeros_like(raw)
        pres[live] = torch.clamp_min(p.gas_k * (rr - p.rho0), 0.0)

        # force, integration, XSPH and the speed cap; ghosts have rho0,
        # P = 0 and v = 0
        g = len(gpos)
        src = {"pos": src_pos,
               "vel": torch.cat([vel, torch.zeros_like(gpos)]),
               "rho": torch.cat([rho, torch.full((g,), p.rho0,
                                                 device=self.dev)]),
               "ghost": torch.cat([torch.zeros(n, dtype=torch.bool,
                                               device=self.dev),
                                   torch.ones(g, dtype=torch.bool,
                                              device=self.dev)])}
        src["pres"] = torch.where(
            src["ghost"], 0.0,
            torch.clamp_min(p.gas_k * (src["rho"] - p.rho0), 0.0))
        npos, nvel = pos.clone(), vel.clone()
        acc = torch.zeros_like(pos)
        for r, i, j in self.pair_chunks(live, skey, tables):
            npos[r], nvel[r], acc[r] = self._force(r, i, j, pos, vel, rho,
                                                   src)
        st = self._reassemble(st, rho, pres, npos, nvel, acc, has_ghosts)
        return self._container(st)

    def _force(self, r, i, j, pos, vel, rho, src):
        """New position, velocity and acceleration of the rows ``r`` from
        their candidate pairs (i, j)."""
        p = self.p
        n = len(pos)
        keep = (j != i) & (src["rho"][j] > 0.0)
        i, j = i[keep], j[keep]
        at = torch.empty(n, dtype=torch.long, device=self.dev)
        at[r] = torch.arange(len(r), device=self.dev)
        k = at[i]                                   # the pair's row in r
        m = len(r)
        pi, vi, rhoi = pos[r], vel[r], rho[r]
        presi = torch.clamp_min(p.gas_k * (rhoi - p.rho0), 0.0)
        pj, vj, rhoj = src["pos"][j], src["vel"][j], src["rho"][j]

        rij = pos[i] - pj
        rr = _norm(rij)
        near = rr < p.h
        m_over_rho = torch.where(near, p.mass / torch.clamp_min(rhoj, 1e-12),
                                 0.0)
        dcl = p.h - rr
        gmag = torch.where(rr > 0.0,
                           self.spiky * dcl * dcl / torch.clamp_min(rr, 1e-12),
                           0.0)
        lapw = self.visc_lap * dcl
        ps = gmag * (-(presi[k] + src["pres"][j]) * 0.5 * m_over_rho)
        vs = m_over_rho * lapw
        gs = gmag * m_over_rho
        zero3 = torch.zeros(m, 3, dtype=torch.float32, device=self.dev)
        fp = zero3.clone().index_add_(0, k, rij * ps[:, None])
        fv = zero3.clone().index_add_(0, k, (vj - vi[k]) * vs[:, None])
        gc = zero3.clone().index_add_(0, k, rij * gs[:, None])
        lc = torch.zeros(m, dtype=torch.float32,
                         device=self.dev).index_add_(0, k, vs)

        glen = _norm(gc)
        st = torch.where((glen > SURFACE_THRESHOLD)[:, None],
                         (-p.st * lc)[:, None]
                         * (gc / torch.clamp_min(glen, 1e-30)[:, None]), 0.0)
        a = ((fp + p.mu * fv + self.gravity * rhoi[:, None] + st)
             / torch.clamp_min(rhoi, 1e-12)[:, None])
        nv = (vi + a * p.dt) * VELOCITY_DAMPING
        np_ = pi + nv * p.dt

        d = np_[k] - pj
        r2 = torch.sum(d * d, dim=-1)
        dd = self.h2 - r2
        w = torch.where(r2 < self.h2, self.poly6 * dd * dd * dd, 0.0)
        mw = w * p.mass / torch.clamp_min(rhoj, 1e-12)
        xs = zero3.clone().index_add_(0, k, (vj - nv[k]) * mw[:, None])
        xn = torch.zeros(m, dtype=torch.float32,
                         device=self.dev).index_add_(0, k, w)

        v = nv + torch.where(
            (xn > 0.0)[:, None],
            XSPH_COEFF * (xs / torch.clamp_min(xn, 1e-30)[:, None]), 0.0)
        max_speed = CFL_FRACTION * p.h / max(p.dt, 1e-6)
        sp = _norm(v)
        scale = torch.where(sp > max_speed,
                            max_speed / torch.clamp_min(sp, 1e-30), 1.0)
        return np_, v * scale[:, None], a

    def _reassemble(self, st, rho, pres, npos, nvel, acc, has_ghosts):
        p = self.p
        fluid = (st["valid"] > 0) & (st["ghost"] == 0)
        speed = _norm(nvel)
        aer = (torch.clamp((p.rho0 - rho) / p.rho0, 0.0, 1.0)
               * torch.clamp(speed / max(p.foam_vel_ref, 1e-3), 0.0, 1.0))
        foam = torch.maximum(aer * p.foam_gen, st["foam"] * FOAM_DECAY)
        foam = torch.where(fluid, foam, st["foam"])
        if has_ghosts:
            g = st["ghost"] > 0
            on = g & self.contrib(st)
            off = g & ~on
            rho = torch.where(on, p.rho0, torch.where(off, st["density"], rho))
            pres = torch.where(g, torch.where(on, 0.0, st["pressure"]), pres)
            nvel = torch.where(on[:, None], 0.0,
                               torch.where(off[:, None], st["vel"], nvel))
            acc = torch.where(on[:, None], 0.0,
                              torch.where(off[:, None], st["acc"], acc))
        return dict(st, pos=npos, vel=nvel, acc=acc, density=rho,
                    pressure=pres, foam=foam)

    def _container(self, st: State) -> State:
        p = self.p
        rel = st["pos"] - self.center[None, :]
        local = matmul(rel, self.rot, self.low)
        q = torch.minimum(torch.maximum(local, -self.half), self.half)
        delta = local - q
        ad = torch.abs(delta)
        hit = torch.any(ad > 0.0, dim=-1)
        axis = torch.argmax(ad, dim=-1, keepdim=True)
        n_local = torch.zeros_like(local).scatter(
            -1, axis, torch.sign(torch.gather(delta, -1, axis)))
        n_world = matmul(n_local, self.rot.T, self.low)
        n_world = n_world / torch.clamp_min(_norm(n_world)[:, None], 1e-12)
        new_pos = self.center[None, :] + matmul(q, self.rot.T, self.low)
        vn = torch.sum(st["vel"] * n_world, dim=-1, keepdim=True)
        v_n = vn * n_world
        new_vel = -p.restitution * v_n + (1.0 - p.friction) * (st["vel"] - v_n)
        live = (hit & (st["ghost"] == 0) & (st["valid"] > 0))[:, None]
        return dict(st, pos=torch.where(live, new_pos, st["pos"]),
                    vel=torch.where(live, new_vel, st["vel"]))

    # -- the frame's prologue -----------------------------------------------
    def kick(self, st: State, n_substeps: int) -> State:
        """The wave kick of a frame of ``n_substeps`` substeps."""
        w, d = self.wave, self.wave_dir
        amplitude = float(w["strength"]) * self.p.dt * n_substeps
        k = 2.0 * math.pi / float(w["wavelength"])
        theta = k * matmul(st["pos"], d, self.low) + float(w["phase"])
        dv = (amplitude * torch.sin(theta))[:, None] * d[None, :]
        live = ((st["ghost"] == 0) & (st["valid"] > 0))[:, None]
        return dict(st, vel=st["vel"] + torch.where(live, dv, 0.0))

    def run(self, st: State, n_substeps: int) -> State:
        st = {k: st[k].to(self.dev) for k in FIELDS}
        if self.wave is not None:
            st = self.kick(st, n_substeps)
        for _ in range(n_substeps):
            st = self.substep(st)
        return st


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def initial_state(spawn, device, pad: int = 256) -> State:
    """The state of a spawn (``benchmark/spawn.py``) before its first
    frame: rows padded to a multiple of ``pad`` with invalid rows, every
    other field zero, ``orig_id`` the row number."""
    count = len(spawn["pos"])
    n = ((count + pad - 1) // pad) * pad

    def col(a, fill=0, width=None):
        shape = (n,) if width is None else (n, width)
        out = np.full(shape, fill, np.asarray(a).dtype)
        out[:count] = a
        return torch.as_tensor(out, device=device)

    f0 = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                device=device)
    return {"pos": col(spawn["pos"], width=3),
            "vel": col(spawn["vel"], width=3),
            "acc": f0(n, 3), "density": f0(n), "pressure": f0(n),
            "foam": f0(n), "ghost": col(spawn["ghost"]),
            "active": col(np.ones(count, np.int32)),
            "face": col(spawn["face"], fill=-1),
            "color_group": col(spawn["color_group"]),
            "valid": col(np.ones(count, np.int32)),
            "orig_id": torch.arange(n, dtype=torch.int32, device=device)}

