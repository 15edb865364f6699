"""Engine step composition (counterpart of ``sph_tpu/engine/step.py``).

The reference's per-substep pipeline (``SPHFluid3D.cpp:359-450``)

    ComputeGridExtents -> ClearGrid -> BuildGrid -> SPHFluid ->
    OBBConstraints -> [river: Terrain, Channel, StreamEmit] -> [Fountain]

is ``substep`` here: the SPH solve with the configured neighbor engine,
then the container pass.  Frames run a fixed-dt substep loop
(``Scene0p.cpp:1321-1333``), a plain Python loop in eager PyTorch where
the JAX package used ``lax.scan``.  River and fountain modes come with
their own slice (ROADMAP queue 1, "River and fountain modes").
"""
from __future__ import annotations

from typing import Tuple

from sph_tpu_torch.core.params import FluidParams, SimConfig
from sph_tpu_torch.core.state import ParticleState
from sph_tpu_torch.neighbors import sweeps
from sph_tpu_torch.physics import brute_force, brute_kernels, constraints


def neighbor_aux(state: ParticleState, params: FluidParams, dt,
                 config: SimConfig):
    """Per-run constants of the neighbor engine, built once outside the
    substep loop: the cell engine's sweep params and static ghost structure
    (ghosts never move and face activation is fixed within a run), the
    all-pairs kernels' sweep params (deriving them waits for the device
    once).  The oracle (``"brute"``) has none."""
    if config.neighbor_impl == "cell":
        return sweeps.prepare(state, params, dt, config)
    if config.neighbor_impl == "brute_kernel":
        return brute_kernels.prepare(params, dt)
    return None


def sph_solve(state: ParticleState, params: FluidParams, dt,
              config: SimConfig, aux=None) -> ParticleState:
    """The SPH force/integrate stage with the configured neighbor engine:
    ``"brute"`` is the all-pairs oracle, ``"cell"`` the cell engine,
    ``"brute_kernel"`` the all-pairs kernels (``brute_pallas``'s
    counterpart, ``dam_break_8k``)."""
    if config.neighbor_impl == "brute":
        return brute_force.substep(state, params, dt)
    if config.neighbor_impl == "brute_kernel":
        return brute_kernels.substep(state, params, dt, pv=aux)
    if config.neighbor_impl == "cell":
        return sweeps.substep(state, params, dt, config, aux=aux)
    raise ValueError(f"unknown neighbor_impl: {config.neighbor_impl!r}")


def substep(state: ParticleState, params: FluidParams, dt,
            config: SimConfig, aux=None) -> ParticleState:
    """One full substep: solve -> container."""
    if config.river_mode or config.fountain_mode:
        raise NotImplementedError(
            "river and fountain modes are not ported yet: see ROADMAP "
            "queue 1, 'River and fountain modes'")
    state = sph_solve(state, params, dt, config, aux=aux)
    return constraints.apply_container(state, params)


def run_substeps(state: ParticleState, params: FluidParams, dt,
                 n_substeps: int, config: SimConfig) -> ParticleState:
    """``n_substeps`` fixed-dt substeps.  The neighbor engine's per-run
    constants are built once here, before the loop."""
    aux = neighbor_aux(state, params, dt, config)
    for _ in range(n_substeps):
        state = substep(state, params, dt, config, aux=aux)
    return state


def substeps_for_frame(frame_dt: float, dt: float, max_substeps: int,
                       accumulator: float) -> Tuple[int, float]:
    """Host-side fixed-timestep accumulator (``Scene0p.cpp:1321-1333``):
    consume whole ``dt`` steps from ``accumulator + frame_dt``, capped."""
    acc = accumulator + frame_dt
    n = 0
    while acc >= dt and n < max_substeps:
        acc -= dt
        n += 1
    return n, acc
