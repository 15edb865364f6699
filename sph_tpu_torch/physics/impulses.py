"""Velocity impulses (counterpart of ``sph_tpu/physics/impulses.py``).

The reference dispatches its impulse shaders once per *frame*, with the
kicks pre-multiplied by dt on the host (``SPHFluid3D.cpp:532-638``,
``Scene0p.cpp:3133-3214``).  Only the wave (``WaveImpulse.comp``), which
``rotated_512k`` applies before every frame, is ported; vortex, attractor,
curl flow and stencil are ROADMAP queue 1 item 6.  Ghosts and padding are
skipped.
"""
from __future__ import annotations

import math

import torch

from sph_tpu_torch.core.state import ParticleState


def wave_impulse(state: ParticleState, amplitude, wavelength, phase,
                 direction, y_min=-math.inf, y_max=math.inf
                 ) -> ParticleState:
    """v += dhat * A sin(2pi/lambda * p.dhat + phase) within [y_min, y_max]."""
    dev = state.pos.device

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    amplitude, wavelength, phase = f32(amplitude), f32(wavelength), f32(phase)
    d = f32(direction)
    dlen = torch.sqrt(torch.sum(d * d))
    nd = torch.where(dlen > 1e-6, d / torch.clamp_min(dlen, 1e-12),
                     f32([0.0, 1.0, 0.0]))
    k = 2.0 * math.pi / torch.clamp_min(wavelength, 1e-6)
    theta = k * (state.pos @ nd) + phase
    kick = amplitude * torch.sin(theta)
    y = state.pos[:, 1]
    ok = ((state.ghost == 0) & (state.valid > 0) & (y >= y_min)
          & (y <= y_max) & (wavelength > 1e-6) & (amplitude != 0.0))
    return state.replace(vel=state.vel + torch.where(
        ok[:, None], kick[:, None] * nd[None, :], 0.0))
