"""Velocity impulses, the audio-reactive "art" primitives
(counterpart of ``sph_tpu/physics/impulses.py``).

The reference dispatches its five impulse shaders once per *frame*, with
the kicks pre-multiplied by dt on the host (``SPHFluid3D.cpp:532-638``,
``Scene0p.cpp:3133-3214``):

- wave:      sinusoidal directional kick in a Y band (``WaveImpulse.comp``)
- vortex:    whirlpool around the container's local Y axis (``VortexImpulse.comp``)
- attractor: softened inverse-distance gravity well (``AttractorImpulse.comp``)
- curl flow: divergence-free curl-noise drift (``CurlFlow.comp``)
- stencil:   spring toward per-particle target points (``StencilAttract.comp``)

All are pure transforms ``state -> state`` on the state's device; ghosts
and padding are skipped.  The curl noise's hash takes the fractional part
of products, so an ulp of difference changes its value: it is
``viz/palettes.hash13``, whose sums are written out left to right.

The wave, which a configuration may run once a frame before the frame
program (``app/configs.frame_prologue``), lies in the span
``sph.impulse.wave`` and counts ``impulses.wave`` (``utils/trace.py``).
"""
from __future__ import annotations

import math

import torch

from sph_tpu_torch.core.device import constant, filled
from sph_tpu_torch.core.params import (FluidParams, effective_half,
                                       rotation_matrix)
from sph_tpu_torch.core.state import ParticleState
from sph_tpu_torch.utils import trace
from sph_tpu_torch.viz import palettes


def _f32(v, dev) -> torch.Tensor:
    """``v`` as float32 on ``dev``: a tensor there is used as it is, host
    numbers are written there by fills (``core.device.filled``)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=torch.float32)
    return filled(v, dev)


def _fixed(v, dev) -> torch.Tensor:
    """A fixed float32 constant on ``dev``, built once there."""
    return constant(v, torch.float32, dev)


def _live(state: ParticleState) -> torch.Tensor:
    return (state.ghost == 0) & (state.valid > 0)


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / torch.clamp_min(_f32(e1 - e0, x.device), 1e-12),
                    0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def wave_impulse(state: ParticleState, amplitude, wavelength, phase,
                 direction, y_min=-math.inf, y_max=math.inf
                 ) -> ParticleState:
    """v += dhat * A sin(2pi/lambda * p.dhat + phase) within [y_min, y_max]."""
    trace.count("impulses.wave")
    with trace.span("sph.impulse.wave"):
        dev = state.pos.device
        amplitude, wavelength, phase = (_f32(amplitude, dev),
                                        _f32(wavelength, dev), _f32(phase, dev))
        d = _f32(direction, dev)
        dlen = torch.sqrt(torch.sum(d * d))
        nd = torch.where(dlen > 1e-6, d / torch.clamp_min(dlen, 1e-12),
                         _fixed((0.0, 1.0, 0.0), dev))
        k = 2.0 * math.pi / torch.clamp_min(wavelength, 1e-6)
        theta = k * (state.pos @ nd) + phase
        kick = amplitude * torch.sin(theta)
        y = state.pos[:, 1]
        ok = (_live(state) & (y >= y_min) & (y <= y_max)
              & (wavelength > 1e-6) & (amplitude != 0.0))
        return state.replace(vel=state.vel + torch.where(
            ok[:, None], kick[:, None] * nd[None, :], 0.0))


def vortex_impulse(state: ParticleState, params: FluidParams,
                   tangent_kick, inward_kick) -> ParticleState:
    """Whirlpool: tangential + inward kicks around container local +Y."""
    dev = state.pos.device
    rot = rotation_matrix(params.box_euler_deg)
    axis = rot[:, 1]                                   # local +Y in world
    half = effective_half(params)
    radius = torch.clamp_min(torch.maximum(half[0], half[2]), 1e-4)

    rel = state.pos - params.box_center[None, :]
    radial = rel - axis[None, :] * (rel @ axis)[:, None]
    r = torch.sqrt(torch.sum(radial * radial, dim=-1))
    r_hat = radial / torch.clamp_min(r, 1e-12)[:, None]
    t_hat = torch.linalg.cross(axis.expand_as(r_hat), r_hat, dim=-1)
    fall = _smoothstep(0.0, 0.35 * radius, r)
    tangent_kick, inward_kick = _f32(tangent_kick, dev), _f32(inward_kick, dev)
    dv = (t_hat * (tangent_kick * fall)[:, None]
          - r_hat * (inward_kick * fall)[:, None])
    ok = _live(state) & (r >= 1e-4)
    return state.replace(vel=state.vel + torch.where(ok[:, None], dv, 0.0))


def attractor_impulse(state: ParticleState, point, pull_kick,
                      radius) -> ParticleState:
    """Movable gravity well with softened core and outer fade."""
    dev = state.pos.device
    point = _f32(point, dev)
    radius = torch.clamp_min(_f32(radius, dev), 0.1)
    soften = torch.clamp_min(0.15 * radius, 0.2)       # SPHFluid3D.cpp:586
    rel = point[None, :] - state.pos
    d = torch.sqrt(torch.sum(rel * rel, dim=-1))
    pull = _f32(pull_kick, dev) * soften / (d + soften)
    pull = pull * (1.0 - _smoothstep(0.6 * radius, radius, d))
    dv = rel / torch.clamp_min(d, 1e-12)[:, None] * pull[:, None]
    ok = _live(state) & (d >= 1e-5)
    return state.replace(vel=state.vel + torch.where(ok[:, None], dv, 0.0))


# --- Curl-noise flow ("Silk Flow") -----------------------------------------

# CurlFlow.comp's hash13 and value noise are the palette block's functions
# (``sph_tpu/physics/impulses.py:83-108`` computes what
# ``sph_tpu/viz/palettes.py:87-109`` does)
_hash13 = palettes.hash13
_vnoise = palettes.vnoise

_P2_OFF = (31.416, 47.853, 12.793)
_P3_OFF = (-233.145, 93.912, 55.121)
_CURL_H = 0.35


def curl_noise(q: torch.Tensor) -> torch.Tensor:
    """curl of three decorrelated value-noise potentials (central diff)."""
    dev = q.device
    p2_off, p3_off = _fixed(_P2_OFF, dev), _fixed(_P3_OFF, dev)

    def p1(x):
        return _vnoise(x)

    def p2(x):
        return _vnoise(x + p2_off)

    def p3(x):
        return _vnoise(x + p3_off)

    ex = _fixed((_CURL_H, 0.0, 0.0), dev)
    ey = _fixed((0.0, _CURL_H, 0.0), dev)
    ez = _fixed((0.0, 0.0, _CURL_H), dev)
    d_p3_dy = p3(q + ey) - p3(q - ey)
    d_p2_dz = p2(q + ez) - p2(q - ez)
    d_p1_dz = p1(q + ez) - p1(q - ez)
    d_p3_dx = p3(q + ex) - p3(q - ex)
    d_p2_dx = p2(q + ex) - p2(q - ex)
    d_p1_dy = p1(q + ey) - p1(q - ey)
    curl = torch.stack([d_p3_dy - d_p2_dz, d_p1_dz - d_p3_dx,
                        d_p2_dx - d_p1_dy], dim=-1)
    return curl / (2.0 * _CURL_H)


def curl_flow(state: ParticleState, kick, scale, time) -> ParticleState:
    """Divergence-free drift; direction from curl noise, magnitude soft-capped."""
    dev = state.pos.device
    scale = torch.clamp_min(_f32(scale, dev), 1e-3)
    zero = _fixed(0.0, dev)
    q = state.pos * scale + torch.stack([zero, zero, _f32(time, dev)])
    curl = curl_noise(q)
    m = torch.sqrt(torch.sum(curl * curl, dim=-1))
    direction = torch.where((m > 1e-5)[:, None],
                            curl / torch.clamp_min(m, 1e-12)[:, None], 0.0)
    dv = direction * (torch.clamp_max(m, 1.0) * _f32(kick, dev))[:, None]
    return state.replace(
        vel=state.vel + torch.where(_live(state)[:, None], dv, 0.0))


def stencil_attract(state: ParticleState, targets: torch.Tensor, num_targets,
                    pull_kick, damp) -> ParticleState:
    """Liquid Logo: particle i springs toward targets[i % num_targets].

    ``targets`` is a fixed-capacity [T,3] buffer; ``num_targets`` a count
    (a host int or a device scalar; 0 disables).  Damp is clamped to 0.5
    as in SPHFluid3D.cpp:631.
    """
    dev = state.pos.device
    cap = targets.shape[0]
    num = torch.clamp(torch.as_tensor(num_targets, device=dev), 0, cap)
    idx = torch.where(num > 0, state.orig_id % torch.clamp_min(num, 1), 0)
    tgt = targets[idx.long()]
    damp = torch.clamp_max(_f32(damp, dev), 0.5)
    d = tgt - state.pos
    new_vel = (state.vel + d * _f32(pull_kick, dev)) * (1.0 - damp)
    ok = _live(state) & (num > 0)
    return state.replace(vel=torch.where(ok[:, None], new_vel, state.vel))
