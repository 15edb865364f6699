"""Engine step composition (counterpart of ``sph_tpu/engine/step.py``).

The reference's per-substep pipeline (``SPHFluid3D.cpp:359-450``)

    ComputeGridExtents -> ClearGrid -> BuildGrid -> SPHFluid ->
    OBBConstraints -> [river: Terrain, Channel, StreamEmit] -> [Fountain]

is ``substep`` here: the SPH solve with the configured neighbor engine,
the container pass, then river mode's terrain, channel and stream stages,
or (without river mode) the fountain's recycling.  Frames run a fixed-dt
substep loop (``Scene0p.cpp:1321-1333``), where the JAX package runs
``lax.scan`` under one ``jax.jit``: :func:`run_substeps` captures the loop
on the card into one CUDA graph and replays it (``engine/graph.py``), and
runs it as the plain Python loop :func:`run_substeps_eager` on the CPU.
The scene's device buffers (terrain, stencil targets, the fountain's seed)
ride along in :class:`SceneBuffers`; no stage waits for the host, or the
loop could not be captured.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from sph_tpu_torch.core.device import resolve
from sph_tpu_torch.core.params import FluidParams, SimConfig
from sph_tpu_torch.core.state import ParticleState
from sph_tpu_torch.engine import graph
from sph_tpu_torch.neighbors import sweeps
from sph_tpu_torch.physics import (brute_force, brute_kernels, constraints,
                                   emitters)
from sph_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class SceneBuffers:
    """Auxiliary device buffers owned by the scene (terrain SSBO, stencil
    targets SSBO, fountain RNG counter — reference bindings 5 and 7), and
    the count of rows the emitters respawned, kept on the device."""
    terrain: torch.Tensor          # [H,W] f32 heightfield (zeros when unused)
    stencil_targets: torch.Tensor  # [S,3] f32, S = stencil_capacity or 1
    stencil_count: torch.Tensor    # [] i32
    fountain_seed: torch.Tensor    # [] i64 holding a uint32, +1 per dispatch
    recycled: torch.Tensor         # [] i64, rows respawned by the emitters

    @classmethod
    def create(cls, config: SimConfig, device=None) -> "SceneBuffers":
        """Zeroed buffers on ``device``: the CUDA card unless the caller
        names another (``core.device.resolve``)."""
        device = resolve(device)
        th, tw = config.terrain_res
        s = max(1, config.stencil_capacity)
        return cls(
            terrain=torch.zeros((th, tw), dtype=torch.float32, device=device),
            stencil_targets=torch.zeros((s, 3), dtype=torch.float32,
                                        device=device),
            stencil_count=torch.zeros((), dtype=torch.int32, device=device),
            fountain_seed=torch.zeros((), dtype=torch.int64, device=device),
            recycled=torch.zeros((), dtype=torch.int64, device=device),
        )

    def replace(self, **kw) -> "SceneBuffers":
        return dataclasses.replace(self, **kw)


def neighbor_aux(state: ParticleState, params: FluidParams, dt,
                 config: SimConfig):
    """Per-run constants of the neighbor engine, built once outside the
    substep loop (and outside its capture): the cell engine's sweep params
    and static ghost structure (ghosts never move and face activation is
    fixed within a run; finding the ghosts waits for the device once), the
    all-pairs kernels' sweep params.  The oracle (``"brute"``) has none."""
    with trace.span("sph.neighbor_aux"):
        if config.neighbor_impl == "cell":
            return sweeps.prepare(state, params, dt, config)
        if config.neighbor_impl == "brute_kernel":
            return brute_kernels.prepare(params, dt)
        return None


# The JAX package's engine names (``--impl``, ``SimConfig.neighbor_impl``)
# and the port's all-pairs kernels' own -> the port's engine of
# :func:`sph_solve` (ROADMAP R13).  The cell engine has no per-cell
# capacity, so it stands in for every cell-list engine of the JAX package,
# exact where ``binned`` and ``pallas`` drop rows past a cell's capacity.
ENGINES = {"auto": "cell", "cell": "cell", "binned": "cell", "pallas": "cell",
           "brute": "brute", "brute_pallas": "brute_kernel",
           "brute_kernel": "brute_kernel"}


def engine(name: str) -> str:
    """The port's engine for ``name``, a key of :data:`ENGINES`.  Raises
    ``ValueError`` naming the choices for any other."""
    if name not in ENGINES:
        raise ValueError(f"unknown neighbor_impl {name!r}; choices: "
                         f"{', '.join(ENGINES)}")
    return ENGINES[name]


def sph_solve(state: ParticleState, params: FluidParams, dt,
              config: SimConfig, aux=None, contain: bool = False
              ) -> ParticleState:
    """The SPH force/integrate stage with the configured neighbor engine:
    ``"brute"`` is the all-pairs oracle, ``"cell"`` the cell engine,
    ``"brute_kernel"`` the all-pairs kernels (``brute_pallas``'s
    counterpart, ``dam_break_8k``).  ``contain`` has the cell engine apply
    the container in the pass that reassembles its sweeps' outputs
    (``sweeps.reassemble``); the other engines take no such pass."""
    if config.neighbor_impl == "brute":
        return brute_force.substep(state, params, dt)
    if config.neighbor_impl == "brute_kernel":
        return brute_kernels.substep(state, params, dt, pv=aux)
    if config.neighbor_impl == "cell":
        return sweeps.substep(state, params, dt, config, aux=aux,
                              contain=contain)
    raise ValueError(f"unknown neighbor_impl: {config.neighbor_impl!r}")


def scene_stages(state: ParticleState, params: FluidParams,
                 buffers: SceneBuffers, dt, config: SimConfig,
                 contained: bool = False
                 ) -> Tuple[ParticleState, SceneBuffers]:
    """The substep's stages after the solve: container (unless the solve
    ``contained`` it already), then river mode's terrain, channel and
    stream, or (without river mode) the fountain's recycling.  River mode
    takes precedence over the fountain (``sph_tpu/engine/step.py:92``).
    Nothing here waits for the host."""
    if not contained:
        state = constraints.apply_container(state, params)
    if config.river_mode:
        state = constraints.apply_terrain(state, buffers.terrain, params)
        state = constraints.apply_channel(state, params, dt)
        state, dead = emitters.stream_emit(state, params)
        buffers = buffers.replace(recycled=buffers.recycled + dead.sum())
    elif config.fountain_mode:
        state, drained = emitters.fountain_recycle(state, params, dt,
                                                   buffers.fountain_seed)
        buffers = buffers.replace(
            fountain_seed=(buffers.fountain_seed + 1) & 0xFFFFFFFF,
            recycled=buffers.recycled + drained.sum())
    return state, buffers


def substep(state: ParticleState, params: FluidParams,
            buffers: SceneBuffers, dt, config: SimConfig, aux=None
            ) -> Tuple[ParticleState, SceneBuffers]:
    """One full substep: solve -> container -> river -> fountain.  The
    cell engine applies the container inside its solve, in the one pass
    that reassembles its sweeps' outputs; the other engines in
    :func:`scene_stages`."""
    contained = config.neighbor_impl == "cell"
    state = sph_solve(state, params, dt, config, aux=aux, contain=contained)
    return scene_stages(state, params, buffers, dt, config,
                        contained=contained)


def _loop(state: ParticleState, params: FluidParams, buffers: SceneBuffers,
          dt, aux, n_substeps: int, config: SimConfig
          ) -> Tuple[ParticleState, SceneBuffers]:
    for _ in range(n_substeps):
        state, buffers = substep(state, params, buffers, dt, config, aux=aux)
    return state, buffers


def run_substeps_eager(state: ParticleState, params: FluidParams,
                       buffers: SceneBuffers, dt, n_substeps: int,
                       config: SimConfig
                       ) -> Tuple[ParticleState, SceneBuffers]:
    """``n_substeps`` fixed-dt substeps as a Python loop that launches
    each substep's work: the plain version of :func:`run_substeps`, which
    runs it on the CPU (and the tests with it), and what ``chip_smoke.py``
    holds the captured program to on the card.  The neighbor engine's
    per-run constants are built once, before the loop."""
    aux = neighbor_aux(state, params, dt, config)
    return _loop(state, params, buffers, dt, aux, n_substeps, config)


def run_substeps(state: ParticleState, params: FluidParams,
                 buffers: SceneBuffers, dt, n_substeps: int,
                 config: SimConfig) -> Tuple[ParticleState, SceneBuffers]:
    """``n_substeps`` fixed-dt substeps.  The neighbor engine's per-run
    constants are built once, before the loop, from ``params`` and ``dt``
    (:func:`neighbor_aux`); a change of the params between frames
    (gravity, the river's) needs a call of its own.

    On CPU tensors this is :func:`run_substeps_eager`.  On CUDA tensors the
    loop runs as one captured program (:func:`run_captured`), never as
    eager launches: a capture that fails raises.

    The frame is the span ``sph.run_substeps`` (``utils/trace.py``), whose
    args are the frame's index, the count of the program's replays."""
    with trace.span("sph.run_substeps", trace.counter("graph.replays")):
        dev = state.pos.device
        if dev.type == "cpu":
            return run_substeps_eager(state, params, buffers, dt, n_substeps,
                                      config)
        if dev.type != "cuda":
            raise ValueError(f"run_substeps takes CUDA or CPU tensors, got "
                             f"{dev}")
        aux = neighbor_aux(state, params, dt, config)
        return run_captured(state, params, buffers, dt, n_substeps, config,
                            aux)


def run_captured(state: ParticleState, params: FluidParams,
                 buffers: SceneBuffers, dt, n_substeps: int,
                 config: SimConfig, aux
                 ) -> Tuple[ParticleState, SceneBuffers]:
    """The loop of :func:`run_substeps` on the card, given its per-run
    ``aux``: one CUDA graph of ``n_substeps`` substeps for each
    ``(n_substeps, config)``, row and ghost count and device, captured at
    its first call (after one eager substep on a side stream) and replayed
    from then on (``engine/graph.py``).  Nothing here waits for the host.
    Returns new tensors, which later calls do not overwrite."""
    if n_substeps <= 0:
        return state, buffers
    body = functools.partial(_loop, n_substeps=n_substeps, config=config)
    warm = functools.partial(_loop, n_substeps=1, config=config)
    return graph.run(("run_substeps", n_substeps, config), body, warm,
                     (state, params, buffers, dt, aux))


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
