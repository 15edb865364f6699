"""River mode: procedural canyon terrain generation + river scene setup
(counterpart of ``sph_tpu/scene/river.py``; the numpy terrain is a copy,
bit-identical, and ``river_params`` writes tensors on the params' device).

Rebuild of ``SPHFluidGPU::GenerateRiverTerrain`` (``SPHFluid3D.cpp:700-806``):
a randomized sinusoidal channel carved into a noisy plateau — trapezoidal
cross-section (flat inner 50% floor, parabolic walls), gentle downstream
slope, emitter at the upstream mouth, sink just above the box floor.
Fully vectorized numpy; the heightfield uploads into
``SceneBuffers.terrain`` and the channel parameters into ``FluidParams``
for the terrain/channel/stream stages (S11-S13).

The reference implements river mode completely but never wires it to its
UI (SURVEY.md §2.5) — here it is a first-class scene mode.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

import torch

from sph_tpu_torch.core.params import FluidParams


@dataclasses.dataclass
class RiverSpec:
    """Randomized channel parameters (SPHFluid3D.cpp:704-711)."""
    amp: float
    freq: float
    phase: float
    channel_width: float      # half-width
    channel_depth: float
    slope_drop: float
    noise_phases: np.ndarray  # [8]

    @classmethod
    def random(cls, seed: int) -> "RiverSpec":
        rng = np.random.default_rng(seed)
        return cls(
            amp=0.5 + rng.random() * 1.5,
            freq=0.18 + rng.random() * 0.18,
            phase=rng.random() * 2.0 * np.pi,
            channel_width=1.8 + rng.random() * 1.2,
            channel_depth=3.5 + rng.random() * 1.0,
            slope_drop=0.3 + rng.random() * 0.5,
            noise_phases=rng.random(8).astype(np.float32) * 2.0 * np.pi)


def generate_river_terrain(
        spec: RiverSpec, box_center, box_half,
        res: Tuple[int, int] = (64, 64)) -> np.ndarray:
    """[H, W] heightfield over the exact box footprint."""
    th, tw = res
    c = np.asarray(box_center, np.float32)
    half = np.asarray(box_half, np.float32)
    x_min, z_min = c[0] - half[0], c[2] - half[2]
    x_size, z_size = 2.0 * half[0], 2.0 * half[2]
    y_base = c[1] - half[1]

    wx = x_min + (np.arange(tw, dtype=np.float32) / (tw - 1)) * x_size
    wz = z_min + (np.arange(th, dtype=np.float32) / (th - 1)) * z_size
    wx, wz = np.meshgrid(wx, wz)                     # [H, W]

    t_flow = (wz - z_min) / z_size
    center_x = c[0] + spec.amp * np.sin(spec.freq * wz + spec.phase)
    dist = np.abs(wx - center_x)

    river_floor = y_base + 1.0 - t_flow * spec.slope_drop
    channel_edge = river_floor + spec.channel_depth

    ph = spec.noise_phases
    plateau = channel_edge + 3.0
    h = (plateau
         + 0.5 * np.sin(wx * 0.35 + ph[0]) * np.cos(wz * 0.28 + ph[1])
         + 0.25 * np.sin(wx * 0.70 + ph[2]) * np.sin(wz * 0.60 + ph[3])
         + 0.12 * np.sin(wx * 1.40 + ph[4]) * np.cos(wz * 1.20 + ph[5]))
    h = np.maximum(h, channel_edge + 0.3)

    # trapezoidal channel: flat inner 50% floor + parabolic outer walls
    u = dist / spec.channel_width
    floor_frac = 0.50
    uw = np.clip((u - floor_frac) / (1.0 - floor_frac), 0.0, 1.0)
    in_channel = dist < spec.channel_width
    carved = np.where(u < floor_frac, river_floor,
                      river_floor + spec.channel_depth * uw * uw)
    h = np.where(in_channel, carved, h)
    h = np.maximum(h, y_base - 0.3)
    return h.astype(np.float32)


def river_params(params: FluidParams, spec: RiverSpec, box_center,
                 box_half) -> FluidParams:
    """Wire the channel spec + emitter/sink into FluidParams
    (``SPHFluid3D.cpp:781-793``), as float32 tensors on the params'
    device."""
    dev = params.h.device

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    c = np.asarray(box_center, np.float32)
    half = np.asarray(box_half, np.float32)
    z_min = c[2] - half[2]
    y_base = c[1] - half[1]
    emitter_z = z_min + 0.5
    start_x = c[0] + spec.amp * np.sin(spec.freq * emitter_z + spec.phase)
    floor_up = y_base + 1.0
    return params.replace(
        river_amp=f32(spec.amp),
        river_freq=f32(spec.freq),
        river_phase=f32(spec.phase),
        river_channel_width=f32(spec.channel_width),
        river_emitter_pos=f32(
            [start_x, floor_up + spec.channel_depth * 0.5, emitter_z]),
        river_emitter_vel=f32([0.0, -0.5, 0.5]),
        river_emitter_radius=f32(spec.channel_width * 0.35),
        river_sink_y=f32(y_base + 0.3),
        river_sink_z_max=f32(c[2] + half[2] - 0.5),
        gravity=f32([0.0, -120.0, 0.0]),
        terrain_min=f32([c[0] - half[0], z_min]),
        terrain_size=f32([2.0 * half[0], 2.0 * half[2]]),
    )
