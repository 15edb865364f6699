"""Scene orchestration (counterpart of ``sph_tpu/scene/scene.py``).

Only :func:`params_from_settings` is ported so far; the ``Scene`` class
(respawn, the frame update, render, presets, checkpoints) comes with the
top layer of the port, after ``audio/`` and the rest of ``viz/``.
"""
from __future__ import annotations

from sph_tpu_torch.core.params import FluidParams
from sph_tpu_torch.scene.settings import SceneSettings

MAX_SUBSTEPS_PER_FRAME = 16          # Scene0p.h:48


def params_from_settings(s: SceneSettings, device=None) -> FluidParams:
    """SceneSettings -> FluidParams on ``device`` (the CUDA card unless the
    caller names another), mass re-derived from h."""
    return FluidParams.default(
        device=device,
        h=s.h, rest_density=s.rest_density, gas_constant=s.gas_constant,
        viscosity=s.viscosity, gravity=[0.0, s.gravity_y, 0.0],
        surface_tension=s.surface_tension, dt=s.time_step,
        foam_gen=s.foam_gen, foam_vel_ref=s.foam_vel_ref,
        box_center=s.box_center, box_half=s.box_half,
        box_euler_deg=s.box_euler, shape_type=s.shape_type,
        shape_aux=(s.shape_aux if any(s.shape_aux) else (5.0, 0.35, 2.5)),
        wall_restitution=s.wall_restitution, wall_friction=s.wall_friction,
        fountain_offset=s.fountain_pos, fountain_radius=s.fountain_radius,
        fountain_spread=s.fountain_spread, fountain_jet_speed=s.fountain_jet,
        fountain_drain_level=s.fountain_drain_level,
        fountain_drain_per_sec=s.fountain_drain_rate,
    ).derive_mass()
