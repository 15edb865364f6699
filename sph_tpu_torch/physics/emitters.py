"""Particle recycling emitters: fountain jet and river stream
(counterpart of ``sph_tpu/physics/emitters.py``).

Behavioral ports of ``shaders/FountainRecycle.comp`` and
``shaders/StreamEmit.comp``.  The shader-side LCG becomes a vectorized
LCG driven by (``orig_id``, per-dispatch seed), so a run is deterministic
and can be checked row by row against the JAX package.  The LCG wraps
mod 2^32: it runs in int64 and masks each product back to 32 bits (the
largest product, seed * 747796405, stays below 2^62).

Each emitter returns the new state and the mask of the rows it
respawned, which ``engine.step.substep`` counts on the device.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from sph_tpu_torch.core.params import FluidParams, effective_half
from sph_tpu_torch.core.state import ParticleState

_LCG_A = 1664525
_LCG_C = 1013904223
_U32 = 0xFFFFFFFF


def _lcg_next(s: torch.Tensor):
    """One LCG step of an int64 tensor of uint32 values: (next, uniform in
    [0, 1] from its low 24 bits)."""
    s = (s * _LCG_A + _LCG_C) & _U32
    u = (s & 0xFFFFFF).to(torch.float32) / 16777215.0
    return s, u


def _recycled(state: ParticleState, mask: torch.Tensor, pos, vel,
              params: FluidParams) -> ParticleState:
    m = mask[:, None]
    return state.replace(
        pos=torch.where(m, pos, state.pos),
        vel=torch.where(m, vel, state.vel),
        acc=torch.where(m, 0.0, state.acc),
        density=torch.where(mask, params.rest_density, state.density),
        pressure=torch.where(mask, 0.0, state.pressure),
    )


def fountain_recycle(state: ParticleState, params: FluidParams, dt,
                     seed: torch.Tensor
                     ) -> Tuple[ParticleState, torch.Tensor]:
    """Recycle pooled bottom water into an upward nozzle jet.

    Mirrors ``FountainRecycle.comp``: particles below the drain plane are
    respawned (with probability ``drain_per_sec * dt``) on the nozzle disc
    with an upward jet velocity + sideways spread cone.  Color-group tags
    survive recycling.  ``seed`` is an integer tensor holding a uint32 (the
    dispatch counter of ``engine.step.SceneBuffers``).
    """
    half = effective_half(params)
    emit = params.box_center + params.fountain_offset
    drain_y = (params.box_center[1] - half[1]) + params.fountain_drain_level
    drain_chance = torch.clamp_max(params.fountain_drain_per_sec * dt, 1.0)

    i = state.orig_id.to(torch.int64)
    mixed = (seed.to(torch.int64) * 747796405) & _U32
    s = ((i ^ mixed) + 2891336453) & _U32
    s, roll = _lcg_next(s)
    s, r1 = _lcg_next(s)
    s, r2 = _lcg_next(s)
    s, r3 = _lcg_next(s)
    s, r4 = _lcg_next(s)

    recycle = ((state.ghost == 0) & (state.valid > 0)
               & (state.pos[:, 1] < drain_y) & (roll <= drain_chance))

    ang = 2.0 * math.pi * r1
    rad = params.fountain_radius * torch.sqrt(r2)      # area-uniform disc
    new_pos = emit[None, :] + torch.stack(
        [torch.cos(ang) * rad, 0.2 * r3, torch.sin(ang) * rad], dim=-1)
    side = torch.stack([torch.cos(ang), torch.sin(ang)], -1) \
        * (params.fountain_spread * r4)[:, None]
    jet = torch.stack([side[:, 0], torch.ones_like(ang), side[:, 1]], dim=-1)
    jet = jet / torch.sqrt(torch.sum(jet * jet, dim=-1, keepdim=True))
    new_vel = params.fountain_jet_speed * jet
    return _recycled(state, recycle, new_pos, new_vel, params), recycle


def stream_emit(state: ParticleState, params: FluidParams
                ) -> Tuple[ParticleState, torch.Tensor]:
    """River recycling: dead particles respawn along the channel centerline.

    Mirrors ``StreamEmit.comp``: "dead" = below sink Y or past sink Z; the
    respawn hash depends only on the particle index (as in the reference),
    so a given row always respawns at the same jittered spot.  As in the
    reference, r2 repeats r1 (each draw reads the state before its step).
    """
    s = (state.orig_id.to(torch.int64) * _LCG_A + _LCG_C) & _U32

    def nxt16(s):
        u = (s & 0xFFFF).to(torch.float32) / 65535.0
        return (s * _LCG_A + _LCG_C) & _U32, u

    r1 = (s & 0xFFFF).to(torch.float32) / 65535.0
    s, r2 = nxt16(s)
    s, r3 = nxt16(s)
    s, r4 = nxt16(s)

    dead = ((state.ghost == 0) & (state.valid > 0)
            & ((state.pos[:, 1] < params.river_sink_y)
               | (state.pos[:, 2] > params.river_sink_z_max)))

    spread_z = params.river_sink_z_max - params.river_emitter_pos[2]
    spawn_z = params.river_emitter_pos[2] + r1 * spread_z
    cx = (params.box_center[0]
          + params.river_amp * torch.sin(params.river_freq * spawn_z
                                         + params.river_phase))
    new_pos = torch.stack([
        cx + (r4 - 0.5) * 2.0 * params.river_emitter_radius,
        params.river_emitter_pos[1] + r3 * 0.6,
        spawn_z,
    ], dim=-1)
    new_vel = params.river_emitter_vel[None, :].expand_as(state.vel)
    return _recycled(state, dead, new_pos, new_vel, params), dead
