"""The gather-parallel all-pairs engine (counterpart of
``sph_tpu/parallel/domain.py``).

Each rank owns a contiguous block of ``N / world`` rows and gathers the
per-row fields the three sweeps read from every rank: pos, vel and the
contrib mask before the density pass, density and pressure before the force
pass.  Its own block then runs the all-pairs oracle's passes
(``physics/brute_force.py``) against the gathered rows, with the global row
ids ``rank * shard_n + arange`` that exclude self pairs, and the scene
stages, which act row by row (``engine.step.scene_stages``).  Exact for any
layout of the rows, and the JAX package's engine for the emitter modes; like
it, this uses the all-pairs oracle, not kernels #4 and #5
(``domain.py:53-113`` calls the plain XLA passes).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from sph_tpu_torch.core.params import FluidParams, SimConfig
from sph_tpu_torch.core.state import ParticleState
from sph_tpu_torch.engine.step import SceneBuffers, scene_stages
from sph_tpu_torch.parallel.group import Group
from sph_tpu_torch.physics import brute_force as BF
from sph_tpu_torch.physics import common as C


def shard_state(state: ParticleState, rank: int, world: int) -> ParticleState:
    """Rank ``rank``'s contiguous block of the rows (``domain.shard_state``);
    the row count must be a multiple of ``world``."""
    if state.n % world:
        raise ValueError(f"{state.n} rows do not split into {world} ranks")
    k = state.n // world
    return ParticleState(**{
        f.name: getattr(state, f.name)[rank * k:(rank + 1) * k].clone()
        for f in dataclasses.fields(ParticleState)})


def substep(state: ParticleState, params: FluidParams, buffers: SceneBuffers,
            dt, config: SimConfig, group: Group
            ) -> Tuple[ParticleState, SceneBuffers]:
    """One substep of the rank's block (``domain._sharded_substep_body``)."""
    n = state.n
    dev = state.pos.device
    ids_i = group.rank * n + torch.arange(n, dtype=torch.int32, device=dev)
    ids_j = torch.arange(group.world * n, dtype=torch.int32, device=dev)
    contrib_i = state.contrib_mask(params.ghost_face_active)
    fluid = state.fluid_mask()

    # density sweep: gathered pos, vel, contrib
    cols = group.all_gather(torch.cat(
        [state.pos, state.vel, contrib_i[:, None].to(torch.float32)], 1))
    pos_all, vel_all = cols[:, 0:3], cols[:, 3:6]
    contrib_all = cols[:, 6] > 0
    rho_raw = BF.density_pass(state.pos, pos_all, contrib_all, params)
    density, pressure = C.finish_density(
        rho_raw, state.ghost, contrib_i, state.density, state.pressure, params)

    # the force sweep reads fresh neighbour density: a second gather
    rp = group.all_gather(torch.stack([density, pressure], 1))
    rho_all, pres_all = rp[:, 0], rp[:, 1]
    accum = BF.force_pass(state.pos, state.vel, pressure, ids_i,
                          pos_all, vel_all, rho_all, pres_all, contrib_all,
                          ids_j, params)
    acc = C.assemble_acc(accum, density, params)
    new_pos, new_vel = C.integrate(state.pos, state.vel, acc, dt)

    # XSPH: fresh self against the gathered (pre-substep) pos and vel
    xsph_sum, xsph_norm = BF.xsph_pass(new_pos, new_vel, ids_i, pos_all,
                                       vel_all, rho_all, contrib_all, ids_j,
                                       params)
    new_vel = C.apply_xsph(new_vel, xsph_sum, xsph_norm)
    new_vel = C.speed_cap(new_vel, params.h, dt)
    foam = C.foam_update(state.foam, new_vel, density, params)

    ghost_on = (contrib_i & (state.ghost > 0))[:, None]
    state = state.replace(
        pos=C.select_updated(fluid, new_pos, state.pos),
        vel=torch.where(ghost_on, 0.0,
                        C.select_updated(fluid, new_vel, state.vel)),
        acc=torch.where(ghost_on, 0.0,
                        C.select_updated(fluid, acc, state.acc)),
        density=density,
        pressure=pressure,
        foam=C.select_updated(fluid, foam, state.foam),
    )
    return scene_stages(state, params, buffers, dt, config)


def run_substeps(state: ParticleState, params: FluidParams,
                 buffers: SceneBuffers, dt, n_substeps: int,
                 config: SimConfig, group: Group
                 ) -> Tuple[ParticleState, SceneBuffers]:
    for _ in range(n_substeps):
        state, buffers = substep(state, params, buffers, dt, config, group)
    return state, buffers
