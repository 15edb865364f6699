"""The five bench configurations (counterpart of ``sph_tpu/app/configs.py``).

1. dam_break_8k   — 8k particles, axis-aligned box, all-pairs neighbors.
2. default_131k   — 131k particles, cell engine + surface tension.
3. rotated_512k   — 512k particles in a rotated OBB with continuous
                    wave-impulse injection.
4. ghost_1m       — 1M particles with ghost boundary shells.
5. export_4m      — 4M particles with headless frame export.

All five build as configured; ``build`` takes the JAX package's engine
names and the port's (``engine.step.ENGINES``) and raises ``ValueError``
for any other.  ``export_4m``'s frame export (``viz_export``) is
``app/bench.export_frames``, which the bench runs after its timed frames.
``frame_prologue`` is what runs before every frame of substeps
(``bench.py:79-88``): the wave impulse for ``rotated_512k``, nothing for
the others.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from sph_tpu_torch.core import params as P
from sph_tpu_torch.core import state as S
from sph_tpu_torch.core.device import resolve
from sph_tpu_torch.core.params import FluidParams, SimConfig, compute_grid_dims
from sph_tpu_torch.core.state import ParticleState
from sph_tpu_torch.engine.step import engine
from sph_tpu_torch.physics.impulses import wave_impulse


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    name: str
    n_target: int
    box_half: Tuple[float, float, float]
    h: float = 0.28
    neighbor_impl: str = "pallas"       # the JAX package's engine name
    box_euler_deg: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    surface_tension: float = 0.0728
    ghosts: bool = False
    wave_impulse: bool = False          # continuous wave each frame
    grid_cap: int = P.GRID_DIM_CAP
    viz_export: bool = False
    spawn_rotation: str = "ignore"      # see core.state.spawn_standard
    emit_rows: bool = False             # SimConfig.emit_rows


CONFIGS = {
    "dam_break_8k": BenchConfig(
        name="dam_break_8k", n_target=8192, box_half=(7.0, 7.0, 7.0),
        neighbor_impl="brute_pallas", surface_tension=0.0),
    "default_131k": BenchConfig(
        name="default_131k", n_target=131072, box_half=(9.5, 9.5, 9.5)),
    "rotated_512k": BenchConfig(
        name="rotated_512k", n_target=524288, box_half=(15.0, 15.0, 15.0),
        box_euler_deg=(20.0, 0.0, 30.0), wave_impulse=True,
        spawn_rotation="local"),
    "ghost_1m": BenchConfig(
        name="ghost_1m", n_target=1_000_000, box_half=(18.5, 18.5, 18.5),
        ghosts=True),
    "export_4m": BenchConfig(
        name="export_4m", n_target=4_000_000, box_half=(41.0, 41.0, 41.0),
        h=0.4, grid_cap=256, viz_export=True),
}


def build(cfg: Union[str, BenchConfig], seed: int = 0,
          neighbor_impl: Optional[str] = None, device=None):
    """Spawn + configure on ``device``: returns (state, params, sim_config).

    ``cfg`` is a name from ``CONFIGS`` or a ``BenchConfig``;
    ``neighbor_impl`` overrides the configuration's engine, by the JAX
    package's name or the port's (``engine.step.engine``).  ``device``
    is the CUDA card unless the caller names another: with no card,
    ``device=None`` raises (``core.device.resolve``)."""
    if isinstance(cfg, str):
        cfg = CONFIGS[cfg]
    impl = engine(neighbor_impl or cfg.neighbor_impl)
    device = resolve(device)
    spawn = S.spawn_standard(
        cfg.n_target, h=cfg.h, box_half=cfg.box_half, seed=seed,
        box_euler_deg=cfg.box_euler_deg,
        spawn_rotation=cfg.spawn_rotation)
    if cfg.ghosts:
        spawn = S.concat_spawns(
            spawn, S.spawn_ghost_box_shell(h=cfg.h, box_half=cfg.box_half))
    state = S.state_from_spawn(spawn, device=device)
    params = FluidParams.default(
        device=device,
        h=cfg.h,
        box_half=np.asarray(cfg.box_half, np.float32),
        box_euler_deg=np.asarray(cfg.box_euler_deg, np.float32),
        surface_tension=cfg.surface_tension,
    ).derive_mass()
    dims = compute_grid_dims(P.SHAPE_BOX, np.asarray(cfg.box_half),
                             np.asarray(cfg.box_euler_deg), cfg.h,
                             cap=cfg.grid_cap)
    sim = SimConfig(n=state.n, grid_dims=dims, neighbor_impl=impl,
                    emit_rows=cfg.emit_rows)
    return state, params, sim


def frame_prologue(cfg: Union[str, BenchConfig], params: FluidParams,
                   n_substeps: int) -> Callable[[ParticleState],
                                                ParticleState]:
    """What runs before each frame of ``n_substeps`` substeps
    (``bench.py:79-88``).  For a wave configuration the reference kicks
    once per frame, dt-premultiplied (``Scene0p.cpp:1303-1307``), and a
    frame of substeps stands in for one reference frame; the other
    configurations return the state unchanged.  The wave's scalars are
    built on the params' device here, once, so no frame copies them from
    the host."""
    if isinstance(cfg, str):
        cfg = CONFIGS[cfg]
    if not cfg.wave_impulse:
        return lambda state: state
    dev = params.dt.device
    amplitude, wavelength, phase = (
        torch.full((), v, dtype=torch.float32, device=dev)
        for v in (60.0 * float(params.dt) * n_substeps, 4.0, 0.7))
    direction = torch.tensor((1.0, 0.0, 0.3), dtype=torch.float32,
                             device=dev)
    return lambda state: wave_impulse(
        state, amplitude=amplitude, wavelength=wavelength, phase=phase,
        direction=direction)
