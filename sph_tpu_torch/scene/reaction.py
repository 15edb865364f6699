"""Audio-reaction driver (counterpart of ``sph_tpu/scene/reaction.py``) —
rebuild of ``Scene0p::DriveAudioReaction`` (``Scene0p.cpp:3133-3221``).

Once per *frame* (not per substep) the band envelopes drive:

- banded wave impulses: bass -> bottom 40% of the container, mid -> a
  rotating horizontal direction over the 30-70% band, treble -> top 40%,
- vortex swirl (constant base + mid kick), attractor orb with bass
  pulse, curl-noise silk flow with mid kick, stencil spring with bass
  release, gravity spin,
- live render values (size/brightness/foam/hue/orbit/zoom kicks),
- the deterministic post-FX clock + trail decay.

Pure function over (state, settings, phases, bands) so reel export is
frame-accurate and reproducible (no wall clock anywhere; phases advance
by dt, the reference's determinism contract, ``Scene0p.cpp:3216-3220``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from sph_tpu_torch.core.device import filled
from sph_tpu_torch.core.params import FluidParams, effective_half_np
from sph_tpu_torch.core.state import ParticleState
from sph_tpu_torch.physics import impulses as I
from sph_tpu_torch.scene.settings import SceneSettings


@dataclasses.dataclass
class ReactionPhases:
    """Phase accumulators (zeroed at reel start, Scene0p.cpp:3297-3308)."""
    bass_phase: float = 0.0
    mid_phase: float = 0.0
    treble_phase: float = 0.0
    gravity_spin_phase: float = 0.0
    silk_time: float = 0.0
    wave_phase: float = 0.0       # manual continuous wave
    post_time: float = 0.0
    anim_time: float = 0.0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0.0)


@dataclasses.dataclass
class LiveValues:
    """Per-frame render values with audio kicks applied
    (``Scene0p.cpp:3163-3176``)."""
    radius_scale: float = 1.3
    bright_mul: float = 1.0
    foam_amount: float = 1.5
    hue_shift_deg: float = 0.0
    orbit_speed_deg: float = 0.0
    cam_dist_scale: float = 1.0
    fountain_jet: float = 25.0
    trail_decay: float = 0.0


def drive_audio_reaction(
        state: ParticleState, params: FluidParams, s: SceneSettings,
        phases: ReactionPhases, bass: float, mid: float, treble: float,
        dt: float, stencil_targets=None,
) -> Tuple[ParticleState, FluidParams, ReactionPhases, LiveValues]:
    """Apply one frame of audio-driven impulses + live values."""
    # the params' half extents on the host: one small copy a frame, none
    # in the substeps
    half = effective_half_np(params.shape_type, params.box_half.cpu().numpy())
    box_bottom = float(s.box_center[1]) - float(half[1])
    span_y = 2.0 * float(half[1])

    p = dataclasses.replace(phases)
    p.bass_phase += s.bass_phase_speed * dt
    p.mid_phase += s.mid_rot_speed * dt
    p.treble_phase += s.treble_phase_speed * dt
    p.anim_time += dt

    up = (0.0, 1.0, 0.0)
    if bass > s.bass_threshold:
        state = I.wave_impulse(
            state, s.bass_force * bass, s.bass_wavelength, p.bass_phase,
            up, box_bottom, box_bottom + span_y * 0.4)
    if mid > s.mid_threshold:
        d = np.asarray([math.cos(p.mid_phase), 0.0,
                        math.sin(p.mid_phase)], np.float32)
        state = I.wave_impulse(
            state, s.mid_force * mid, s.mid_wavelength, p.mid_phase, d,
            box_bottom + span_y * 0.3, box_bottom + span_y * 0.7)
    if treble > s.treble_threshold:
        state = I.wave_impulse(
            state, s.treble_force * treble, s.treble_wavelength,
            p.treble_phase, up, box_bottom + span_y * 0.6,
            box_bottom + span_y)

    # vortex: constant base + mid kick, dt-scaled (always runs)
    swirl = s.vortex_base + (s.vortex_audio * mid
                             if mid > s.mid_threshold else 0.0)
    if swirl != 0.0 or s.vortex_inward != 0.0:
        state = I.vortex_impulse(state, params, swirl * dt,
                                 s.vortex_inward * dt)

    # gravity spin: tip gravity sideways and sweep it around Y
    if s.spin_on:
        p.gravity_spin_phase += math.radians(s.spin_speed) * dt
        g = abs(s.gravity_y)
        tilt = math.radians(s.spin_tilt)
        gx = g * math.sin(tilt) * math.cos(p.gravity_spin_phase)
        gz = g * math.sin(tilt) * math.sin(p.gravity_spin_phase)
    else:
        gx, gz = 0.0, 0.0
    params = params.replace(gravity=filled(
        np.asarray([gx, s.gravity_y, gz], np.float32), params.gravity.device))

    # attractor orb: constant pull + bass-pulse kick
    if s.attractor_on:
        pull = s.attractor_pull
        if bass > s.bass_threshold:
            pull += s.attractor_kick * bass
        point = np.asarray(s.box_center, np.float32) \
            + np.asarray(s.attractor_pos, np.float32)
        state = I.attractor_impulse(state, point, pull * dt,
                                    s.attractor_radius)

    # liquid logo: spring toward stencil targets; bass hit releases
    if (stencil_targets is not None and len(stencil_targets) > 0
            and s.logo_strength > 0.0):
        strength = s.logo_strength
        if s.logo_bass_release and bass > s.bass_threshold:
            strength = 0.0
        if strength > 0.0:
            state = I.stencil_attract(
                state, torch.as_tensor(np.asarray(stencil_targets, np.float32),
                                       device=state.pos.device),
                len(stencil_targets), strength * dt,
                min(0.5, s.logo_damp * dt))

    # silk flow: curl-noise drift, mid band tightens it
    if s.silk_strength > 0.0 or s.silk_audio * mid > 0.0:
        p.silk_time += s.silk_drift * dt
        silk = s.silk_strength + s.silk_audio * mid
        state = I.curl_flow(state, silk * dt, s.silk_scale, p.silk_time)

    # live render values
    live = LiveValues(
        radius_scale=s.render_radius_scale * (1.0 + s.size_kick * bass),
        bright_mul=(s.bright_mul * (1.0 + s.shimmer_kick * treble)
                    * (1.0 + s.flash_kick * bass)),
        foam_amount=s.foam_amount * (1.0 + s.foam_kick * mid),
        hue_shift_deg=s.hue_shift + s.hue_kick * bass,
        orbit_speed_deg=s.orbit_speed * (1.0 + s.orbit_kick * bass),
        cam_dist_scale=1.0 - s.zoom_kick * min(bass, 1.5),
        fountain_jet=s.fountain_jet * (1.0 + s.fountain_kick * bass),
    )

    # deterministic post clock + trail decay
    p.post_time += dt
    live.trail_decay = (math.exp(-0.6931472 * dt / s.trail_half_life)
                        if s.trail_half_life > 1e-3 else 0.0)
    return state, params, p, live


def drive_continuous_wave(state: ParticleState, s: SceneSettings,
                          phases: ReactionPhases, dt: float
                          ) -> Tuple[ParticleState, ReactionPhases]:
    """Manual continuous wave (``Scene0p.cpp:1303-1307``)."""
    if not s.continuous_wave:
        return state, phases
    p = dataclasses.replace(phases)
    p.wave_phase += s.wave_phase_speed * dt
    d = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))[s.wave_dir % 3]
    state = I.wave_impulse(state, s.wave_amplitude, s.wave_wavelength,
                           p.wave_phase, d,
                           -float("inf"), float("inf"))
    return state, p
