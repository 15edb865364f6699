"""Scene-level settings + the full ~140-key preset schema (counterpart of
``sph_tpu/scene/settings.py``, copied: the port imports nothing of the
JAX package).

The reference's ``Scene0p`` god object owns every user-facing knob and
(de)serializes them in ``GatherPreset`` / ``ApplyPresetKV``
(``Scene0p.cpp:1954-2280``).  Here those knobs live in one declarative
``SceneSettings`` dataclass; the preset schema is a table of
``(key, attr, kind, structural)`` rows, so gather/apply/lerp are generic.

``structural=True`` rows need a respawn (particle count, mix pattern,
spawn jitter, logo path); the Drop Sequencer applies presets with
``structural=False`` so the fluid morphs continuously without reset
(``Scene0p.h:95-99``).

Defaults mirror the reference's member initializers
(``Scene0p.h:230-344``, ``SPHFluid3D.h:94-150``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from sph_tpu_torch.io import presets as pio
from sph_tpu_torch.viz.palettes import VizParams


def _f3(x, y, z):
    return dataclasses.field(default_factory=lambda: [x, y, z])


@dataclasses.dataclass
class SceneSettings:
    # --- sim / physics (SPHFluid3D.h:94-123) ---
    h: float = 0.28
    mass: float = 13.8                  # recomputed at spawn (mass=rho0*s^3)
    rest_density: float = 1000.0
    gas_constant: float = 2000.0
    viscosity: float = 3.5
    gravity_y: float = -980.0
    surface_tension: float = 0.0728
    time_step: float = 1e-3
    use_jitter: bool = True
    jitter_amp: float = 0.20
    foam_gen: float = 1.0
    foam_vel_ref: float = 8.0
    wall_restitution: float = 0.15
    wall_friction: float = 0.02
    particle_count: int = 50000
    # --- container ---
    box_center: List[float] = _f3(0.0, 0.0, 0.0)
    box_half: List[float] = _f3(7.0, 7.0, 7.0)
    box_euler: List[float] = _f3(0.0, 0.0, 0.0)
    shape_type: int = 0
    shape_aux: List[float] = _f3(0.0, 0.0, 0.0)
    show_outline: bool = True
    outline_color: List[float] = _f3(0.85, 0.95, 1.0)
    # --- look (Scene0p.h:252-287) ---
    render_mode: int = 0                # 0=water, 1=impostors, 2=mesh
    viz_mode: int = 0
    viz_range_min: float = 0.0
    viz_range_max: float = 10.0
    palette_id: int = 0
    two_color: bool = False
    palette_id2: int = 2
    mix_pattern: int = 0
    hue_shift: float = 0.0
    sat_mul: float = 1.0
    bright_mul: float = 1.0
    contrast_mul: float = 1.0
    invert_color: bool = False
    lit_particles: bool = True
    irid_freq: float = 3.0
    irid_shift: float = 0.0
    palette_flow: float = 0.0
    pattern_scale: float = 1.0
    duo_color_a: List[float] = _f3(0.05, 0.02, 0.10)
    duo_color_b: List[float] = _f3(1.00, 0.35, 0.75)
    sky_on: bool = False
    bg_color: List[float] = _f3(0.0, 0.0, 0.0)
    sky_horizon: List[float] = _f3(0.40, 0.55, 0.65)
    sky_zenith: List[float] = _f3(0.15, 0.28, 0.50)
    env_reflect: List[float] = _f3(0.90, 0.95, 1.00)
    foam_amount: float = 1.5
    exposure: float = 1.0
    far_plane: float = 300.0
    # --- water surface / SSFR (Scene0p.h:295-312) ---
    ssfr_half_res: bool = False
    smooth_iterations: int = 5
    world_filter_scale: float = 6.0
    surface_merge: float = 3.0
    thickness_strength: float = 0.05
    thickness_falloff: float = 4.0
    render_radius_scale: float = 1.3
    water_extinction: List[float] = _f3(0.45, 0.15, 0.05)
    thickness_scale: float = 1.0
    sun_dir: List[float] = _f3(0.4, 1.0, 0.5)
    sun_color: List[float] = _f3(1.0, 0.97, 0.9)
    deep_water_color: List[float] = _f3(0.02, 0.08, 0.25)
    specular_power: float = 256.0
    specular_strength: float = 0.8
    refraction_strength: float = 0.04
    fresnel_bias: float = 0.02
    # --- post fx (Scene0p.h:336-344) ---
    bloom_strength: float = 0.0
    bloom_threshold: float = 0.6
    trail_half_life: float = 0.0
    kaleido_segments: int = 0
    kaleido_angle: float = 0.0
    vignette: float = 0.0
    grain: float = 0.0
    chromatic: float = 0.0
    lens_aperture: float = 0.0
    lens_focus_dist: float = 22.0
    streak_strength: float = 0.0
    # --- motion (Scene0p.h:313-335) ---
    orbit_on: bool = False
    orbit_speed: float = 8.0
    orbit_kick: float = 0.0
    vortex_base: float = 0.0
    vortex_audio: float = 0.0
    vortex_inward: float = 0.0
    logo_path: str = ""
    logo_strength: float = 6.0
    logo_scale: float = 12.0
    logo_damp: float = 2.0
    logo_bass_release: bool = True
    silk_strength: float = 0.0
    silk_scale: float = 0.15
    silk_drift: float = 0.3
    silk_audio: float = 0.0
    spin_on: bool = False
    spin_speed: float = 45.0
    spin_tilt: float = 25.0
    attractor_on: bool = False
    attractor_pos: List[float] = _f3(0.0, 2.0, 0.0)
    attractor_pull: float = 8.0
    attractor_radius: float = 6.0
    attractor_kick: float = 25.0
    fountain_on: bool = False
    fountain_pos: List[float] = _f3(0.0, -5.0, 0.0)
    fountain_radius: float = 1.0
    fountain_jet: float = 25.0
    fountain_spread: float = 0.25
    fountain_drain_level: float = 1.0
    fountain_drain_rate: float = 2.0
    fountain_kick: float = 0.6
    # --- waves (manual panel, Scene0p.h:262-270) ---
    wave_amplitude: float = 1.5
    wave_wavelength: float = 3.0
    wave_phase_speed: float = 4.0
    wave_dir: int = 1
    continuous_wave: bool = False
    # --- audio (Scene0p.h:271-292) ---
    audio_enabled: bool = False
    audio_master_gain: float = 1.0
    audio_attack_ms: float = 15.0
    audio_release_ms: float = 250.0
    bass_force: float = 8.0
    bass_threshold: float = 0.05
    bass_wavelength: float = 10.0
    bass_phase_speed: float = 1.5
    mid_force: float = 4.0
    mid_threshold: float = 0.05
    mid_wavelength: float = 3.0
    mid_rot_speed: float = 1.2
    treble_force: float = 1.5
    treble_threshold: float = 0.05
    treble_wavelength: float = 1.0
    treble_phase_speed: float = 14.0
    size_kick: float = 0.3
    shimmer_kick: float = 0.5
    foam_kick: float = 0.6
    hue_kick: float = 0.0
    flash_kick: float = 0.0
    zoom_kick: float = 0.0


# (key, attr, kind, structural) — kinds: f float, i int, b bool, s str,
# f3 float triple.  Keys match the reference byte-for-byte so preset
# files interchange (GatherPreset, Scene0p.cpp:1954-2106).
PRESET_FIELDS: List[Tuple[str, str, str, bool]] = [
    ("sim.h", "h", "f", False),
    ("sim.mass", "mass", "f", False),
    ("sim.restDensity", "rest_density", "f", False),
    ("sim.gasConstant", "gas_constant", "f", False),
    ("sim.viscosity", "viscosity", "f", False),
    ("sim.gravityY", "gravity_y", "f", False),
    ("sim.surfaceTension", "surface_tension", "f", False),
    ("sim.timeStep", "time_step", "f", False),
    ("sim.useJitter", "use_jitter", "b", True),
    ("sim.jitterAmp", "jitter_amp", "f", True),
    ("sim.foamGen", "foam_gen", "f", False),
    ("sim.foamVelRef", "foam_vel_ref", "f", False),
    ("sim.wallRestitution", "wall_restitution", "f", False),
    ("sim.wallFriction", "wall_friction", "f", False),
    ("sim.particleCount", "particle_count", "i", True),
    ("box.center", "box_center", "f3", False),
    ("box.half", "box_half", "f3", False),
    ("box.euler", "box_euler", "f3", False),
    ("box.shapeType", "shape_type", "i", False),
    ("box.aux", "shape_aux", "f3", False),
    ("box.outline", "show_outline", "b", False),
    ("box.outlineColor", "outline_color", "f3", False),
    ("look.renderMode", "render_mode", "i", False),
    ("look.vizMode", "viz_mode", "i", False),
    ("look.vizRangeMin", "viz_range_min", "f", False),
    ("look.vizRangeMax", "viz_range_max", "f", False),
    ("look.paletteId", "palette_id", "i", False),
    ("look.twoColor", "two_color", "b", False),
    ("look.paletteId2", "palette_id2", "i", False),
    ("look.mixPattern", "mix_pattern", "i", True),
    ("look.hueShift", "hue_shift", "f", False),
    ("look.satMul", "sat_mul", "f", False),
    ("look.brightMul", "bright_mul", "f", False),
    ("look.contrastMul", "contrast_mul", "f", False),
    ("look.invert", "invert_color", "b", False),
    ("look.lit", "lit_particles", "b", False),
    ("look.iridFreq", "irid_freq", "f", False),
    ("look.iridShift", "irid_shift", "f", False),
    ("look.paletteFlow", "palette_flow", "f", False),
    ("look.patternScale", "pattern_scale", "f", False),
    ("look.duoA", "duo_color_a", "f3", False),
    ("look.duoB", "duo_color_b", "f3", False),
    ("look.skyOn", "sky_on", "b", False),
    ("look.bg", "bg_color", "f3", False),
    ("look.skyHorizon", "sky_horizon", "f3", False),
    ("look.skyZenith", "sky_zenith", "f3", False),
    ("look.reflect", "env_reflect", "f3", False),
    ("look.foamAmount", "foam_amount", "f", False),
    ("look.exposure", "exposure", "f", False),
    ("look.farPlane", "far_plane", "f", False),
    ("water.halfRes", "ssfr_half_res", "b", False),
    ("water.smoothIter", "smooth_iterations", "i", False),
    ("water.filterScale", "world_filter_scale", "f", False),
    ("water.surfaceMerge", "surface_merge", "f", False),
    ("water.thickStrength", "thickness_strength", "f", False),
    ("water.thickFalloff", "thickness_falloff", "f", False),
    ("water.radiusScale", "render_radius_scale", "f", False),
    ("water.extinction", "water_extinction", "f3", False),
    ("water.thicknessScale", "thickness_scale", "f", False),
    ("water.sunDir", "sun_dir", "f3", False),
    ("water.sunColor", "sun_color", "f3", False),
    ("water.deepColor", "deep_water_color", "f3", False),
    ("water.specPower", "specular_power", "f", False),
    ("water.specStrength", "specular_strength", "f", False),
    ("water.refraction", "refraction_strength", "f", False),
    ("water.fresnelBias", "fresnel_bias", "f", False),
    ("fx.bloom", "bloom_strength", "f", False),
    ("fx.bloomThreshold", "bloom_threshold", "f", False),
    ("fx.trailHalfLife", "trail_half_life", "f", False),
    ("fx.kaleidoSegments", "kaleido_segments", "i", False),
    ("fx.kaleidoAngle", "kaleido_angle", "f", False),
    ("fx.vignette", "vignette", "f", False),
    ("fx.grain", "grain", "f", False),
    ("fx.chromatic", "chromatic", "f", False),
    ("fx.aperture", "lens_aperture", "f", False),
    ("fx.focusDist", "lens_focus_dist", "f", False),
    ("fx.streak", "streak_strength", "f", False),
    ("motion.orbitOn", "orbit_on", "b", False),
    ("motion.orbitSpeed", "orbit_speed", "f", False),
    ("motion.orbitKick", "orbit_kick", "f", False),
    ("motion.vortexBase", "vortex_base", "f", False),
    ("motion.vortexAudio", "vortex_audio", "f", False),
    ("motion.vortexInward", "vortex_inward", "f", False),
    ("motion.logoPath", "logo_path", "s", True),
    ("motion.logoStrength", "logo_strength", "f", False),
    ("motion.logoScale", "logo_scale", "f", False),
    ("motion.logoDamp", "logo_damp", "f", False),
    ("motion.logoBassRelease", "logo_bass_release", "b", False),
    ("motion.silkStrength", "silk_strength", "f", False),
    ("motion.silkScale", "silk_scale", "f", False),
    ("motion.silkDrift", "silk_drift", "f", False),
    ("motion.silkAudio", "silk_audio", "f", False),
    ("motion.spinOn", "spin_on", "b", False),
    ("motion.spinSpeed", "spin_speed", "f", False),
    ("motion.spinTilt", "spin_tilt", "f", False),
    ("motion.attractorOn", "attractor_on", "b", False),
    ("motion.attractorPos", "attractor_pos", "f3", False),
    ("motion.attractorPull", "attractor_pull", "f", False),
    ("motion.attractorRadius", "attractor_radius", "f", False),
    ("motion.attractorKick", "attractor_kick", "f", False),
    ("motion.fountainOn", "fountain_on", "b", False),
    ("motion.fountainPos", "fountain_pos", "f3", False),
    ("motion.fountainRadius", "fountain_radius", "f", False),
    ("motion.fountainJet", "fountain_jet", "f", False),
    ("motion.fountainSpread", "fountain_spread", "f", False),
    ("motion.fountainDrainLevel", "fountain_drain_level", "f", False),
    ("motion.fountainDrainRate", "fountain_drain_rate", "f", False),
    ("motion.fountainKick", "fountain_kick", "f", False),
    ("waves.amplitude", "wave_amplitude", "f", False),
    ("waves.wavelength", "wave_wavelength", "f", False),
    ("waves.phaseSpeed", "wave_phase_speed", "f", False),
    ("waves.dir", "wave_dir", "i", False),
    ("waves.continuous", "continuous_wave", "b", False),
    ("audio.enabled", "audio_enabled", "b", False),
    ("audio.masterGain", "audio_master_gain", "f", False),
    ("audio.attackMs", "audio_attack_ms", "f", False),
    ("audio.releaseMs", "audio_release_ms", "f", False),
    ("audio.bassForce", "bass_force", "f", False),
    ("audio.bassThreshold", "bass_threshold", "f", False),
    ("audio.bassWavelength", "bass_wavelength", "f", False),
    ("audio.bassPhaseSpeed", "bass_phase_speed", "f", False),
    ("audio.midForce", "mid_force", "f", False),
    ("audio.midThreshold", "mid_threshold", "f", False),
    ("audio.midWavelength", "mid_wavelength", "f", False),
    ("audio.midRotSpeed", "mid_rot_speed", "f", False),
    ("audio.trebleForce", "treble_force", "f", False),
    ("audio.trebleThreshold", "treble_threshold", "f", False),
    ("audio.trebleWavelength", "treble_wavelength", "f", False),
    ("audio.treblePhaseSpeed", "treble_phase_speed", "f", False),
    ("audio.sizeKick", "size_kick", "f", False),
    ("audio.shimmerKick", "shimmer_kick", "f", False),
    ("audio.foamKick", "foam_kick", "f", False),
    ("audio.hueKick", "hue_kick", "f", False),
    ("audio.flashKick", "flash_kick", "f", False),
    ("audio.zoomKick", "zoom_kick", "f", False),
]

STRUCTURAL_KEYS = frozenset(k for k, _, _, s in PRESET_FIELDS if s)


def gather_preset(s: SceneSettings) -> pio.KV:
    """Settings -> KV dict (reference GatherPreset)."""
    kv: pio.KV = {}
    for key, attr, kind, _ in PRESET_FIELDS:
        v = getattr(s, attr)
        if kind == "f":
            pio.put_f(kv, key, float(v))
        elif kind == "i":
            pio.put_i(kv, key, int(v))
        elif kind == "b":
            pio.put_b(kv, key, bool(v))
        elif kind == "f3":
            pio.put_f3(kv, key, v)
        else:
            kv[key] = str(v)
    return kv


def apply_preset(s: SceneSettings, kv: pio.KV,
                 structural: bool = True) -> SceneSettings:
    """KV -> new settings.  Missing keys keep current values; unknown
    keys are ignored; structural rows only apply when requested
    (reference ApplyPresetKV, Scene0p.cpp:2108-2280)."""
    out = dataclasses.replace(s)
    for key, attr, kind, is_structural in PRESET_FIELDS:
        if is_structural and not structural:
            continue
        if kind == "f":
            setattr(out, attr, pio.get_f(kv, key, float(getattr(s, attr))))
        elif kind == "i":
            setattr(out, attr, pio.get_i(kv, key, int(getattr(s, attr))))
        elif kind == "b":
            setattr(out, attr, pio.get_b(kv, key, bool(getattr(s, attr))))
        elif kind == "f3":
            setattr(out, attr, list(pio.get_f3(kv, key, getattr(s, attr))))
        elif key in kv:
            setattr(out, attr, kv[key])
    if structural:
        out.particle_count = max(1000, out.particle_count)
    return out


def needs_respawn(old: SceneSettings, new: SceneSettings) -> bool:
    """True when a structural field changed (reference sets pendingReset
    on count/shape/mix edits, Scene0p.cpp:601,931-933,1245-1248)."""
    for _, attr, _, is_structural in PRESET_FIELDS:
        if is_structural and getattr(old, attr) != getattr(new, attr):
            return True
    # box.half stays LIVE like the reference's ImGui box drag (Scene0p
    # sets pendingReset only on count/shape/mix edits); the grid is
    # retracked by Scene._track_grid (SPHFluid3D.cpp:282-304 analogue)
    return old.shape_type != new.shape_type


def to_water_params(s: SceneSettings):
    """SceneSettings -> the SSFR water-surface WaterParams
    (``sph_tpu/scene/settings.py:374-393``)."""
    from sph_tpu_torch.viz.ssfr import WaterParams
    return WaterParams(
        smooth_iterations=s.smooth_iterations,
        world_filter_scale=s.world_filter_scale,
        surface_merge=s.surface_merge,
        thickness_strength=s.thickness_strength,
        thickness_falloff=s.thickness_falloff,
        radius_scale=s.render_radius_scale,
        extinction=tuple(s.water_extinction),
        thickness_scale=s.thickness_scale,
        sun_dir=tuple(s.sun_dir), sun_color=tuple(s.sun_color),
        deep_color=tuple(s.deep_water_color),
        specular_power=s.specular_power,
        specular_strength=s.specular_strength,
        refraction_strength=s.refraction_strength,
        fresnel_bias=s.fresnel_bias,
        sky_horizon=tuple(s.sky_horizon), sky_zenith=tuple(s.sky_zenith),
        foam_amount=s.foam_amount, exposure=s.exposure,
        sky_on=s.sky_on, bg_color=tuple(s.bg_color))


def to_viz_params(s: SceneSettings, anim_time: float = 0.0,
                  hue_shift_live: float | None = None,
                  bright_mul_live: float | None = None):
    """SceneSettings -> the palette block's VizParams."""
    return VizParams(
        palette_id=s.palette_id,
        palette_id2=s.palette_id2 if s.two_color else -1,
        color_drive=min(s.viz_mode, 6),
        height_min=s.box_center[1] - s.box_half[1],
        height_max=s.box_center[1] + s.box_half[1],
        viz_min=s.viz_range_min, viz_max=s.viz_range_max,
        box_center=tuple(s.box_center),
        palette_flow=s.palette_flow, anim_time=anim_time,
        irid_freq=s.irid_freq, irid_shift=s.irid_shift,
        duo_color_a=tuple(s.duo_color_a), duo_color_b=tuple(s.duo_color_b),
        pattern_scale=s.pattern_scale,
        hue_shift=(hue_shift_live if hue_shift_live is not None
                   else s.hue_shift),
        sat_mul=s.sat_mul,
        bright_mul=(bright_mul_live if bright_mul_live is not None
                    else s.bright_mul),
        contrast_mul=s.contrast_mul, invert_color=s.invert_color,
        lit_sphere=s.lit_particles,
        sun_dir=tuple(s.sun_dir), sun_color=tuple(s.sun_color))
