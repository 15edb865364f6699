"""Pointwise + per-pair SPH math shared by every neighbor engine
(counterpart of ``sph_tpu/physics/common.py``).

Semantics follow ``shaders/SPHFluid.comp`` with the JAX package's one
deliberate deviation (SURVEY.md §5.2): a deterministic Jacobi split —
density pass for all particles, then a force pass reading fresh neighbor
densities, then an XSPH pass reading stale (pre-substep) neighbor pos/vel
against fresh self values (``SPHFluid.comp:177-201``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from sph_tpu_torch.core.params import FluidParams
from sph_tpu_torch.physics import kernels as K

XSPH_COEFF = 0.12          # SPHFluid.comp:179
VELOCITY_DAMPING = 0.995   # SPHFluid.comp:170
FOAM_DECAY = 0.995         # SPHFluid.comp:216
DENSITY_FLOOR_FRAC = 0.5   # SPHFluid.comp:105
CFL_FRACTION = 0.4         # SPHFluid3D.cpp:414-416
SURFACE_THRESHOLD = 1e-6   # SPHFluid.comp:159


class ForceAccum(NamedTuple):
    """Per-particle accumulators from the force sweep."""
    f_pressure: torch.Tensor   # [N,3]
    f_viscosity: torch.Tensor  # [N,3]
    grad_c: torch.Tensor       # [N,3] color-field gradient
    lap_c: torch.Tensor        # [N]   color-field Laplacian


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def pair_force_terms(rij, r, vel_i, vel_j, pres_i, pres_j, rho_j, h, mass,
                     mask):
    """Per-pair force contributions (``SPHFluid.comp:129-151``).

    Shapes broadcast: rij [..., 3]; r, pres_*, rho_j, mask [...];
    vel_* [..., 3].  Returns (fP, fV, gradC, lapC) contributions, masked.
    """
    w = mask.to(torch.float32)
    rho_safe = torch.clamp_min(rho_j, 1e-12)
    grad_w = K.spiky_grad_mag_over_r(r, h)[..., None] * rij
    lap_w = K.visc_laplacian(r, h)
    m_over_rho = mass * w / rho_safe

    f_p = grad_w * (-(pres_i + pres_j) * 0.5 * m_over_rho)[..., None]
    f_v = (vel_j - vel_i) * (m_over_rho * lap_w)[..., None]
    grad_c = grad_w * m_over_rho[..., None]
    lap_c = m_over_rho * lap_w
    return f_p, f_v, grad_c, lap_c


def finish_density(rho_raw, state_ghost, state_active_contrib,
                   old_density, old_pressure, params: FluidParams):
    """Density floor + pressure clamp + ghost overrides.

    Fluid: rho = max(sum, 0.5 rho0); P = max(k(rho - rho0), 0)
    Active ghost: rho = rho0, P = 0 (SPHFluid.comp:77-80).
    Inactive ghost: untouched (SPHFluid.comp:72-75).
    """
    rho0 = params.rest_density
    rho = torch.maximum(rho_raw, DENSITY_FLOOR_FRAC * rho0)
    pres = torch.clamp_min(params.gas_constant * (rho - rho0), 0.0)
    is_ghost = state_ghost > 0
    ghost_on = state_active_contrib
    rho = torch.where(is_ghost, torch.where(ghost_on, rho0, old_density), rho)
    pres = torch.where(is_ghost,
                       torch.where(ghost_on, torch.zeros_like(pres),
                                   old_pressure), pres)
    return rho, pres


def assemble_acc(accum: ForceAccum, density, params: FluidParams):
    """acc = (fP + mu*fV + g*rho + fST) / rho  (``SPHFluid.comp:156-166``)."""
    grad_len = _norm(accum.grad_c)
    st_dir = accum.grad_c / torch.clamp_min(grad_len, 1e-30)[..., None]
    f_st = torch.where(
        (grad_len > SURFACE_THRESHOLD)[..., None],
        -params.surface_tension * accum.lap_c[..., None] * st_dir,
        0.0,
    )
    f_grav = params.gravity[None, :] * density[..., None]
    total = (accum.f_pressure + params.viscosity * accum.f_viscosity
             + f_grav + f_st)
    return total / torch.clamp_min(density, 1e-12)[..., None]


def integrate(pos, vel, acc, dt):
    """Semi-implicit Euler + damping (``SPHFluid.comp:169-171``)."""
    new_vel = (vel + acc * dt) * VELOCITY_DAMPING
    new_pos = pos + new_vel * dt
    return new_pos, new_vel


def apply_xsph(vel, xsph_sum, xsph_norm):
    """vel += 0.12 * xsph/norm when norm > 0 (``SPHFluid.comp:200-201``)."""
    corr = torch.where((xsph_norm > 0.0)[..., None],
                       xsph_sum / torch.clamp_min(xsph_norm, 1e-30)[..., None],
                       0.0)
    return vel + XSPH_COEFF * corr


def speed_cap(vel, h, dt):
    """CFL-style cap: |v| <= 0.4 h / dt (``SPHFluid.comp:203-207``)."""
    max_speed = CFL_FRACTION * h / torch.clamp_min(torch.as_tensor(dt), 1e-6)
    sp = _norm(vel)
    scale = torch.where(sp > max_speed,
                        max_speed / torch.clamp_min(sp, 1e-30), 1.0)
    return vel * scale[..., None]


def foam_update(foam, vel, density, params: FluidParams):
    """Aeration foam factor (``SPHFluid.comp:209-217``)."""
    speed = _norm(vel)
    rho0 = params.rest_density
    aer = (torch.clamp((rho0 - density) / rho0, 0.0, 1.0)
           * torch.clamp(speed / torch.clamp_min(params.foam_vel_ref, 1e-3),
                         0.0, 1.0))
    return torch.maximum(aer * params.foam_gen, foam * FOAM_DECAY)


def select_updated(fluid_mask, new, old):
    """Apply an update only to live fluid particles (ghosts/padding keep old)."""
    m = fluid_mask
    if new.ndim > m.ndim:
        m = m[..., None]
    return torch.where(m, new, old)
