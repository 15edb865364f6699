"""The all-pairs engine's two kernels and its substep (counterpart of
``sph_tpu/physics/brute_pallas.py``, BASELINE config 1, ``dam_break_8k``).

1. **density** — raw density of every row: mass · poly6 ·
   Σ_j contrib_j (h² − r²)³ over r² < h², self included, no floor
   (``brute_pallas._density_kernel``).
2. **force**   — all pairs j ≠ i whose source is live (ρ_j > 0 and
   contrib_j > 0): spiky pressure and viscosity with μ folded in per
   pair, color field, surface tension, gravity, integrate ×0.995; then
   XSPH with the fresh self pos/vel against the stale neighbors, its
   apply, and the CFL cap (``brute_pallas._force_kernel``).

Each is a CUDA kernel (``csrc/brute.cu``) with a plain torch version of
the same function beside it, which follows the TPU kernel's arithmetic
(r = r² · rsqrt(max(r², 1e-24))).  The wrapper picks by the device of its
tensors: CPU tensors take the plain version, CUDA tensors launch the
kernel, anything else raises.  The engine never reorders rows, so the
self pair is excluded by row index, as in the TPU kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from sph_tpu_torch.core.params import FluidParams
from sph_tpu_torch.core.state import ParticleState
from sph_tpu_torch.native import build
from sph_tpu_torch.neighbors.sweeps import (CONST_NAMES, SweepParams,
                                           make_pvec)
from sph_tpu_torch.physics import common as C
from sph_tpu_torch.utils import trace

# i rows per chunk of the plain versions: each chunk builds [rows, n]
# pair tensors, so this bounds their memory.
_PLAIN_ROWS = 512

# Kernel launches since the last reset_launches() — only the CUDA path
# counts, and only where it launches (``trace.counters``: ``launches.*``).
LAUNCHES = trace.launch_counts({"brute_density": 0, "brute_force": 0})


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------

def _row_chunks(n: int):
    for i0 in range(0, n, _PLAIN_ROWS):
        yield slice(i0, min(n, i0 + _PLAIN_ROWS))


def density_raw_plain(pos, contrib, pv: SweepParams):
    """Plain torch version of ``brute_density_kernel``: rho_raw [N]."""
    out = torch.empty(pos.shape[0], dtype=torch.float32, device=pos.device)
    for sl in _row_chunks(pos.shape[0]):
        d = pos[sl, None, :] - pos[None, :, :]
        r2 = torch.sum(d * d, dim=-1)
        dd = torch.clamp_min(pv.h2 - r2, 0.0)
        w = torch.where(r2 < pv.h2, dd * dd * dd, 0.0) * contrib[None, :]
        out[sl] = torch.sum(w, dim=1)
    return out * (pv.mass * pv.poly6)


def force_plain(pos, vel, rho, pres, contrib, pv: SweepParams):
    """Plain torch version of ``brute_force_kernel``: (npos, nvel, acc)
    [N, 3] of every row."""
    n = pos.shape[0]
    npos, nvel, acc = (torch.empty_like(pos) for _ in range(3))
    g = torch.tensor([pv.gx, pv.gy, pv.gz], dtype=torch.float32,
                     device=pos.device)
    live = (rho > 0.0) & (contrib > 0.0)
    rho_safe_j = torch.clamp_min(rho, 1e-12)
    rows = torch.arange(n, device=pos.device)
    for sl in _row_chunks(n):
        pi, vi = pos[sl], vel[sl]
        rho_i, pres_i = rho[sl, None], pres[sl, None]
        src = live[None, :] & (rows[sl, None] != rows[None, :])

        # pass 1: pressure, viscosity, color field
        d = pi[:, None, :] - pos[None, :, :]
        r2 = torch.sum(d * d, dim=-1)
        rinv = torch.rsqrt(torch.clamp_min(r2, 1e-24))
        r = r2 * rinv
        mask = src & (r < pv.h)
        m_over_rho = torch.where(mask, pv.mass / rho_safe_j[None, :], 0.0)
        dcl = torch.clamp_min(pv.h - r, 0.0)
        gmag = torch.where(r2 > 0.0, pv.spiky * dcl * dcl * rinv, 0.0)
        lapw = pv.visc_lap * dcl
        pscale = -(pres_i + pres[None, :]) * 0.5 * m_over_rho * gmag
        vscale = m_over_rho * lapw * pv.mu
        fp = torch.sum(pscale[..., None] * d + vscale[..., None]
                       * (vel[None, :, :] - vi[:, None, :]), dim=1)
        gc = torch.sum((m_over_rho * gmag)[..., None] * d, dim=1)
        lc = torch.sum(m_over_rho * lapw, dim=1)

        # assemble_acc + integrate
        glen = torch.sqrt(torch.sum(gc * gc, dim=-1, keepdim=True))
        stm = torch.where(glen > C.SURFACE_THRESHOLD,
                          -pv.st * lc[:, None] / torch.clamp_min(glen, 1e-30),
                          0.0)
        a = (fp + stm * gc + g * rho_i) / torch.clamp_min(rho_i, 1e-12)
        nv = (vi + a * pv.dt) * C.VELOCITY_DAMPING
        np_ = pi + nv * pv.dt

        # pass 2: XSPH, fresh self against stale neighbors
        d = np_[:, None, :] - pos[None, :, :]
        rr2 = torch.sum(d * d, dim=-1)
        xmask = src & (rr2 < pv.h2)
        dd = torch.clamp_min(pv.h2 - rr2, 0.0)
        w = torch.where(xmask, pv.poly6 * dd * dd * dd, 0.0)
        mw = w * pv.mass / rho_safe_j[None, :]
        s = torch.sum(mw[..., None] * (vel[None, :, :] - nv[:, None, :]),
                      dim=1)
        norm = torch.sum(w, dim=1, keepdim=True)

        # XSPH apply + CFL cap
        inv = torch.where(norm > 0.0,
                          C.XSPH_COEFF / torch.clamp_min(norm, 1e-30), 0.0)
        v = nv + inv * s
        max_speed = C.CFL_FRACTION * pv.h / max(pv.dt, 1e-6)
        spd = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        scale = torch.where(spd > max_speed,
                            max_speed / torch.clamp_min(spd, 1e-30), 1.0)
        npos[sl], nvel[sl], acc[sl] = np_, v * scale, a
    return npos, nvel, acc


# ---------------------------------------------------------------------------
# wrappers: plain version on CPU tensors, the CUDA kernel on CUDA tensors
# ---------------------------------------------------------------------------

def _check_rows(pos, contrib, pv: SweepParams, **more):
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"the all-pairs kernels take CUDA or CPU tensors, "
                         f"got {dev}")
    n = pos.shape[0]
    if n >= 2**31 // 3:
        raise ValueError(f"{n} rows overflow the kernels' int32 indexing")
    build.check_tensor("sweep params", pv.consts, torch.float32,
                       (len(CONST_NAMES),), dev)
    build.check_tensor("pos", pos, torch.float32, (n, 3), dev)
    build.check_tensor("contrib", contrib, torch.float32, (n,), dev)
    for name, (t, shape) in more.items():
        build.check_tensor(name, t, torch.float32, shape, dev)


def density_raw(pos, contrib, pv: SweepParams):
    """rho_raw [N] of every row (``contrib`` [N] float32, 1 for a
    source)."""
    if pos.device.type == "cpu":
        return density_raw_plain(pos, contrib, pv)
    _check_rows(pos, contrib, pv)
    lib = build.library()
    n = pos.shape[0]
    rho_raw = torch.empty(n, dtype=torch.float32, device=pos.device)
    err = lib.sph_brute_density(
        pos.data_ptr(), contrib.data_ptr(), n, pv.consts.data_ptr(),
        rho_raw.data_ptr(), torch.cuda.current_stream(pos.device).cuda_stream)
    build.launched(LAUNCHES, "brute_density", err)
    return rho_raw


def force(pos, vel, rho, pres, contrib, pv: SweepParams):
    """(npos, nvel, acc) [N, 3] of every row; ``rho`` and ``pres`` are
    the finished density and pressure (``common.finish_density``)."""
    if pos.device.type == "cpu":
        return force_plain(pos, vel, rho, pres, contrib, pv)
    n = pos.shape[0]
    _check_rows(pos, contrib, pv, vel=(vel, (n, 3)), rho=(rho, (n,)),
                pres=(pres, (n,)))
    lib = build.library()
    npos, nvel, acc = (torch.empty_like(pos) for _ in range(3))
    err = lib.sph_brute_force(
        pos.data_ptr(), vel.data_ptr(), rho.data_ptr(), pres.data_ptr(),
        contrib.data_ptr(), n, pv.consts.data_ptr(), npos.data_ptr(),
        nvel.data_ptr(), acc.data_ptr(),
        torch.cuda.current_stream(pos.device).cuda_stream)
    build.launched(LAUNCHES, "brute_force", err)
    return npos, nvel, acc


# ---------------------------------------------------------------------------
# substep composition
# ---------------------------------------------------------------------------

def prepare(params: FluidParams, dt) -> SweepParams:
    """The kernels' constants (the grid dims go unread), derived on the
    device; ``engine.run_substeps`` does it once, before its loop."""
    return make_pvec(params, dt, (0, 0, 0))


def substep(state: ParticleState, params: FluidParams, dt,
            pv: Optional[SweepParams] = None) -> ParticleState:
    """One all-pairs substep through the kernels, ``brute_pallas.substep``
    (``:244-295``) line for line.  Rows stay in place: no sort.  ``pv`` is
    :func:`prepare`'s result when the caller has it; a caller without one
    has it derived here."""
    if pv is None:
        pv = prepare(params, dt)
    contrib = state.contrib_mask(params.ghost_face_active)
    contrib_f = contrib.to(torch.float32)

    rho_raw = density_raw(state.pos, contrib_f, pv)
    density, pressure = C.finish_density(
        rho_raw, state.ghost, contrib, state.density, state.pressure, params)
    new_pos, new_vel, acc = force(state.pos, state.vel, density, pressure,
                                  contrib_f, pv)
    foam = C.foam_update(state.foam, new_vel, density, params)

    fluid = state.fluid_mask()
    ghost_on = (contrib & (state.ghost > 0))[:, None]
    return state.replace(
        pos=C.select_updated(fluid, new_pos, state.pos),
        vel=torch.where(ghost_on, 0.0,
                        C.select_updated(fluid, new_vel, state.vel)),
        acc=torch.where(ghost_on, 0.0,
                        C.select_updated(fluid, acc, state.acc)),
        density=density,
        pressure=pressure,
        foam=C.select_updated(fluid, foam, state.foam),
    )
