"""The scene's main paths: what a user of the scene runs, frame by frame.

Each path is a scene that the JAX package's ``Scene`` sets up
(``sph_tpu/scene/scene.py``: ``respawn`` at ``:99-124``, ``enable_river``
at ``:261-276``) and that its ``update`` drives (``:176-226``): per frame
the continuous wave, the audio reaction, the fountain's jet speed from the
live values, the fixed-dt substep accumulator, then the substeps.  The
bands are ``cmd_run --audio``'s stand-in for a track
(``sph_tpu/app/main.py``), with the audio reaction on.

- ``river_65k``: ``sph_tpu.app.main run --river --particles 65536``
  (README): default settings, the box spawn, then river mode with
  ``RiverSpec.random(0)`` on a 64x64 terrain;
- ``torus_vortex_50k``: art preset 10, "Donut Vortex" (a torus, the vortex
  impulse) at 50,000 asked rows;
- ``fountain_50k``: the fountain's key toggle on the default scene.

``build`` puts everything on the CUDA card unless given a device
(``core.device.resolve``).  ``chip_smoke.py`` drives these paths,
``app/profile_substeps.py`` profiles them, and ``tests/test_torch_modes.py``
prints the JAX package's density after the same frames.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sph_tpu_torch.core import state as S
from sph_tpu_torch.core.device import resolve
from sph_tpu_torch.core.params import SimConfig, compute_grid_dims
from sph_tpu_torch.engine.step import (SceneBuffers, run_substeps,
                                       substeps_for_frame)
from sph_tpu_torch.scene import art_presets, reaction, river
from sph_tpu_torch.scene.scene import (MAX_SUBSTEPS_PER_FRAME,
                                       params_from_settings)
from sph_tpu_torch.scene.settings import SceneSettings

# path -> (particle count, art preset or None, river, fountain)
PATHS = {
    "river_65k": (65536, None, True, False),
    "torus_vortex_50k": (50000, 10, False, False),
    "fountain_50k": (50000, None, False, True),
}
FRAME_DT = 1.0 / 60.0


def settings(name: str, count=None) -> SceneSettings:
    """The path's settings (``count`` overrides its particle count)."""
    n, art, _, fountain = PATHS[name]
    s = SceneSettings()
    s.particle_count = n if count is None else count
    if art is not None:
        s = art_presets.apply_art_preset(s, art)
    s.fountain_on = fountain
    s.audio_enabled = True
    return s


def bands(frame: int):
    """(bass, mid, treble) of ``frame``: ``cmd_run --audio``'s."""
    return (0.5 + 0.5 * math.sin(frame * 0.3), 0.2, 0.1)


def build(name: str, neighbor_impl: str = "cell", seed: int = 0,
          count=None, device=None):
    """(settings, state, params, config, buffers) of the path on
    ``device``: the spawn and params of ``Scene.respawn``, and for the
    river ``Scene.enable_river(seed)``."""
    device = resolve(device)
    s = settings(name, count)
    aux = tuple(s.shape_aux) if any(s.shape_aux) else (5.0, 0.35, 2.5)
    spawn = S.spawn_standard(
        s.particle_count, h=s.h, rest_density=s.rest_density,
        box_center=tuple(s.box_center), box_half=tuple(s.box_half),
        shape_type=s.shape_type, shape_aux=aux, mix_pattern=s.mix_pattern,
        use_jitter=s.use_jitter, jitter_amp=s.jitter_amp, seed=seed,
        box_euler_deg=tuple(s.box_euler))
    state = S.state_from_spawn(spawn, device=device)
    params = params_from_settings(s, device=device)
    dims = compute_grid_dims(s.shape_type, np.asarray(s.box_half, np.float32),
                             np.asarray(s.box_euler, np.float32), s.h)
    cfg = SimConfig(n=state.n, grid_dims=dims, neighbor_impl=neighbor_impl,
                    fountain_mode=s.fountain_on)
    buffers = SceneBuffers.create(cfg, device=device)
    if PATHS[name][2]:
        spec = river.RiverSpec.random(seed)
        terrain = river.generate_river_terrain(spec, s.box_center,
                                               s.box_half,
                                               res=cfg.terrain_res)
        params = river.river_params(params, spec, s.box_center, s.box_half)
        cfg = dataclasses.replace(cfg, river_mode=True)
        buffers = buffers.replace(terrain=torch.as_tensor(terrain,
                                                          device=device))
    return s, state, params, cfg, buffers


def frame_start(index: int, state, params, s: SceneSettings,
                phases: reaction.ReactionPhases, acc: float):
    """What ``Scene.update`` does in frame ``index`` before its substeps:
    the wave, the audio reaction, the jet speed and the accumulator.
    Returns (state, params, phases, accumulator, substeps due, dt)."""
    dev = params.h.device
    state, phases = reaction.drive_continuous_wave(state, s, phases,
                                                   FRAME_DT)
    state, params, phases, live = reaction.drive_audio_reaction(
        state, params, s, phases, *bands(index), FRAME_DT)
    params = params.replace(fountain_jet_speed=torch.tensor(
        live.fountain_jet, dtype=torch.float32, device=dev))
    n_sub, acc = substeps_for_frame(FRAME_DT, s.time_step,
                                    MAX_SUBSTEPS_PER_FRAME, acc)
    dt = torch.tensor(s.time_step, dtype=torch.float32, device=dev)
    return state, params, phases, acc, n_sub, dt


def frame(index: int, state, params, buffers, cfg: SimConfig,
          s: SceneSettings, phases: reaction.ReactionPhases, acc: float):
    """Frame ``index`` as ``Scene.update`` runs it.  Returns (state,
    params, buffers, phases, accumulator, substeps run)."""
    state, params, phases, acc, n_sub, dt = frame_start(
        index, state, params, s, phases, acc)
    if n_sub > 0:
        state, buffers = run_substeps(state, params, buffers, dt, n_sub, cfg)
    return state, params, buffers, phases, acc, n_sub
