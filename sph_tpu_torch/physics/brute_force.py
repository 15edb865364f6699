"""Brute-force O(N^2) reference solver — the port's oracle
(counterpart of ``sph_tpu/physics/brute_force.py``).

Pairs are enumerated in row chunks of the i side against all j rows, so
memory stays bounded; the physics lives in ``physics/common.py``.  The
i and j operands are separate arguments, and self-pairs are excluded by
comparing particle ids, as in the JAX package.
"""
from __future__ import annotations

import torch

from sph_tpu_torch.core.params import FluidParams
from sph_tpu_torch.core.state import ParticleState
from sph_tpu_torch.physics import common as C
from sph_tpu_torch.physics import kernels as K

_PAIRS_PER_CHUNK = 1 << 22


def _chunks(ni: int, nj: int):
    step = max(1, _PAIRS_PER_CHUNK // max(nj, 1))
    for i0 in range(0, ni, step):
        yield slice(i0, min(ni, i0 + step))


def density_pass(pos_i, pos_j, contrib_j, params: FluidParams):
    """rho_raw[i] = mass * sum_j contrib_j * poly6(r2) for r2 < h^2.

    Self-pairs are *included*, as in the GLSL density loop
    (``SPHFluid.comp:89-106`` has no j != i check).
    """
    h = params.h
    h2 = h * h
    cj = contrib_j.to(torch.float32)
    out = torch.empty(pos_i.shape[0], dtype=torch.float32, device=pos_i.device)
    for sl in _chunks(pos_i.shape[0], pos_j.shape[0]):
        diff = pos_i[sl, None, :] - pos_j[None, :, :]
        r2 = torch.sum(diff * diff, dim=-1)
        w = torch.where(r2 < h2, K.poly6(r2, h), 0.0) * cj[None, :]
        out[sl] = torch.sum(w, dim=1)
    return params.mass * out


def force_pass(pos_i, vel_i, pres_i, ids_i,
               pos_j, vel_j, rho_j, pres_j, contrib_j, ids_j,
               params: FluidParams) -> C.ForceAccum:
    """Pressure / viscosity / surface-tension accumulators, all pairs."""
    ni = pos_i.shape[0]
    h = params.h
    cj = contrib_j.to(torch.float32)
    dev = pos_i.device
    fp = torch.empty((ni, 3), dtype=torch.float32, device=dev)
    fv = torch.empty_like(fp)
    gc = torch.empty_like(fp)
    lc = torch.empty((ni,), dtype=torch.float32, device=dev)
    for sl in _chunks(ni, pos_j.shape[0]):
        rij = pos_i[sl, None, :] - pos_j[None, :, :]
        r = torch.sqrt(torch.sum(rij * rij, dim=-1))
        mask = ((ids_i[sl, None] != ids_j[None, :]) & (r < h)
                & (rho_j[None, :] > 0.0) & (cj[None, :] > 0.0))
        dfp, dfv, dgc, dlc = C.pair_force_terms(
            rij, r, vel_i[sl, None, :], vel_j[None, :, :],
            pres_i[sl, None], pres_j[None, :], rho_j[None, :],
            h, params.mass, mask)
        fp[sl], fv[sl] = dfp.sum(1), dfv.sum(1)
        gc[sl], lc[sl] = dgc.sum(1), dlc.sum(1)
    return C.ForceAccum(fp, fv, gc, lc)


def xsph_pass(new_pos_i, new_vel_i, ids_i,
              old_pos_j, old_vel_j, rho_j, contrib_j, ids_j,
              params: FluidParams):
    """XSPH smoothing: fresh self pos/vel vs stale neighbor pos/vel
    (``SPHFluid.comp:177-201``).  Returns (xsph_sum[Ni,3], xsph_norm[Ni])."""
    ni = new_pos_i.shape[0]
    h = params.h
    h2 = h * h
    cj = contrib_j.to(torch.float32)
    s = torch.empty((ni, 3), dtype=torch.float32, device=new_pos_i.device)
    norm = torch.empty((ni,), dtype=torch.float32, device=new_pos_i.device)
    for sl in _chunks(ni, old_pos_j.shape[0]):
        diff = new_pos_i[sl, None, :] - old_pos_j[None, :, :]
        r2 = torch.sum(diff * diff, dim=-1)
        mask = ((ids_i[sl, None] != ids_j[None, :]) & (r2 < h2)
                & (rho_j[None, :] > 0.0) & (cj[None, :] > 0.0))
        w = torch.where(mask, K.poly6(r2, h), 0.0)
        mw = w * params.mass / torch.clamp_min(rho_j[None, :], 1e-12)
        s[sl] = torch.sum((old_vel_j[None, :, :] - new_vel_i[sl, None, :])
                          * mw[..., None], dim=1)
        norm[sl] = torch.sum(w, dim=1)
    return s, norm


def substep(state: ParticleState, params: FluidParams, dt) -> ParticleState:
    """One full WCSPH substep with all-pairs neighbor enumeration."""
    ids = torch.arange(state.n, dtype=torch.int32, device=state.pos.device)
    contrib = state.contrib_mask(params.ghost_face_active)
    fluid = state.fluid_mask()

    rho_raw = density_pass(state.pos, state.pos, contrib, params)
    density, pressure = C.finish_density(
        rho_raw, state.ghost, contrib, state.density, state.pressure, params)

    accum = force_pass(state.pos, state.vel, pressure, ids,
                       state.pos, state.vel, density, pressure, contrib, ids,
                       params)
    acc = C.assemble_acc(accum, density, params)
    new_pos, new_vel = C.integrate(state.pos, state.vel, acc, dt)

    xsph_sum, xsph_norm = xsph_pass(new_pos, new_vel, ids,
                                    state.pos, state.vel, density, contrib,
                                    ids, params)
    new_vel = C.apply_xsph(new_vel, xsph_sum, xsph_norm)
    new_vel = C.speed_cap(new_vel, params.h, dt)
    foam = C.foam_update(state.foam, new_vel, density, params)

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
