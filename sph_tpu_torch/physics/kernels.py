"""SPH smoothing kernels (counterpart of ``sph_tpu/physics/kernels.py``).

Closed forms match the reference GLSL (``shaders/SPHFluid.comp:42-64``):

    poly6(r^2)   = 315/(64 pi h^9) (h^2 - r^2)^3        for 0 <= r <= h
    spikyGrad(r) = -45/(pi h^6) (h - r)^2 * rhat        for 0 <  r <= h
    viscLap(r)   =  45/(pi h^6) (h - r)                 for 0 <= r <= h

All are masked (no branches) and safe at r = 0.
"""
from __future__ import annotations

from typing import Optional

import torch

_PI = 3.141592653589


def poly6(r2: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """W_poly6(r^2; h). Input is squared distance."""
    h2 = h * h
    coeff = 315.0 / (64.0 * _PI * h**9)
    d = torch.clamp_min(h2 - r2, 0.0)
    return torch.where(r2 <= h2, coeff * d * d * d, 0.0)


def spiky_grad(rij: torch.Tensor, h: torch.Tensor,
               r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """grad W_spiky(rij; h), vanishing at r=0 and r>h. rij: [..., 3]."""
    if r is None:
        # summed x, y, z in that order, as the JAX package's ``jnp.sum``
        # does (``torch.sum`` over three elements may not)
        sq = rij * rij
        r = torch.sqrt(sq[..., 0] + sq[..., 1] + sq[..., 2])
    coeff = -45.0 / (_PI * h**6)
    d = torch.clamp_min(h - r, 0.0)
    mag = coeff * d * d
    safe_r = torch.clamp_min(r, 1e-12)
    scale = torch.where((r > 0.0) & (r <= h), mag / safe_r, 0.0)
    return rij * scale[..., None]


def spiky_grad_mag_over_r(r: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """|grad W_spiky| / r, masked — multiply by rij to get the gradient."""
    coeff = -45.0 / (_PI * h**6)
    d = torch.clamp_min(h - r, 0.0)
    safe_r = torch.clamp_min(r, 1e-12)
    return torch.where((r > 0.0) & (r <= h), coeff * d * d / safe_r, 0.0)


def visc_laplacian(r: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Laplacian of the viscosity kernel."""
    coeff = 45.0 / (_PI * h**6)
    return torch.where((r >= 0.0) & (r <= h),
                       coeff * torch.clamp_min(h - r, 0.0), 0.0)
