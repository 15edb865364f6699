"""The 14 curated art presets + the SurpriseMe randomizer (counterpart of
``sph_tpu/scene/art_presets.py``, copied: the port imports nothing of the
JAX package).

Rebuild of ``Scene0p::ApplyArtPreset`` (``Scene0p.cpp:1479-1799``) and
``Scene0p::SurpriseMe`` (``:1857-1946``).  Each preset is a dict of
``SceneSettings`` field overrides applied over a common neutral canvas
(black backdrop, neutral grade, centered unrotated container, default
physics) — so a preset lands identically no matter what was tuned
before.  Applying a preset enables audio reaction and requests a
respawn, like the reference.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Tuple

from sph_tpu_torch.scene.settings import SceneSettings

ART_PRESET_NAMES: List[str] = [
    "Zero-G Nebula", "Dream Float", "Acid Trip", "Club Water",
    "Molten Disco", "Vaporwave Orb", "Chrome Mercury", "Plasma Storm",
    "Lava Lamp", "Candy Rain", "Donut Vortex", "Capsule Wave",
    "Hourglass Drip", "Cosmic Egg",
]

# Common canvas applied before every preset (Scene0p.cpp:1482-1520).
_CANVAS: Dict = dict(
    sky_on=False, bg_color=[0.0, 0.0, 0.0],
    hue_shift=0.0, sat_mul=1.0, bright_mul=1.0, contrast_mul=1.0,
    invert_color=False,
    box_center=[0.0, 0.0, 0.0], box_euler=[0.0, 0.0, 0.0],
    h=0.28, rest_density=1000.0, time_step=1e-3,
    mass=13.8, wall_restitution=0.15, wall_friction=0.02, foam_gen=1.0,
    render_radius_scale=1.3, pattern_scale=1.0,
    bass_wavelength=10.0, bass_phase_speed=1.5,
    mid_wavelength=3.0, mid_rot_speed=1.2,
    treble_wavelength=1.0, treble_phase_speed=14.0,
    orbit_on=False, orbit_speed=8.0, orbit_kick=0.0,
    hue_kick=0.0, flash_kick=0.0,
    vortex_base=0.0, vortex_audio=0.0, vortex_inward=0.0,
    bloom_strength=0.0, bloom_threshold=0.6, trail_half_life=0.0,
    kaleido_segments=0, kaleido_angle=0.0,
    vignette=0.0, grain=0.0, chromatic=0.0,
    lens_aperture=0.0, lens_focus_dist=22.0, streak_strength=0.0,
    attractor_on=False, spin_on=False, zoom_kick=0.0,
    two_color=False, mix_pattern=0, fountain_on=False,
    silk_strength=0.0, silk_audio=0.0,
    audio_attack_ms=15.0, audio_release_ms=250.0,
)


def _impostor_look(radius=1.3):
    return dict(render_mode=1, lit_particles=True,
                render_radius_scale=radius)


ART_PRESETS: List[Dict] = [
    # 0 Zero-G Nebula: drifting cloud in a sphere, galaxy colors
    dict(shape_type=1, box_half=[7, 7, 7], gravity_y=-15.0, viscosity=6.0,
         gas_constant=1500.0, surface_tension=0.05,
         **_impostor_look(1.2), palette_id=9, viz_mode=1,
         viz_range_min=0.0, viz_range_max=8.0, palette_flow=0.05,
         audio_master_gain=1.5, bass_force=12.0, bass_threshold=0.06,
         mid_force=5.0, mid_threshold=0.06, treble_force=2.0,
         treble_threshold=0.05, size_kick=0.5, shimmer_kick=0.6,
         foam_kick=0.3),
    # 1 Dream Float: slow syrupy drift, aurora colors by depth
    dict(shape_type=0, box_half=[7, 7, 7], gravity_y=-35.0, viscosity=8.0,
         gas_constant=1200.0, surface_tension=0.08,
         **_impostor_look(1.5), palette_id=14, viz_mode=4,
         viz_range_min=8.0, viz_range_max=40.0, palette_flow=0.08,
         audio_master_gain=1.2, bass_force=8.0, bass_threshold=0.08,
         mid_force=4.0, mid_threshold=0.08, treble_force=1.5,
         treble_threshold=0.06, size_kick=0.35, shimmer_kick=0.5,
         foam_kick=0.2),
    # 2 Acid Trip: floaty sphere, kaleidoscope rings, hard audio hits
    dict(shape_type=1, box_half=[7, 7, 7], gravity_y=-60.0, viscosity=2.0,
         gas_constant=3500.0, surface_tension=0.10,
         **_impostor_look(1.1), palette_id=13, irid_freq=4.0,
         irid_shift=0.0, viz_mode=6, viz_range_min=0.0, viz_range_max=7.0,
         palette_flow=0.20, audio_master_gain=1.8, bass_force=15.0,
         bass_threshold=0.05, mid_force=7.0, mid_threshold=0.06,
         treble_force=3.0, treble_threshold=0.04, size_kick=0.6,
         shimmer_kick=1.0, foam_kick=0.3),
    # 3 Club Water: real water surface, heavy bass splashes
    dict(shape_type=0, box_half=[7, 7, 7], gravity_y=-980.0, viscosity=3.5,
         gas_constant=2500.0, surface_tension=0.10, render_mode=0,
         foam_gen=1.3, foam_amount=2.2, audio_master_gain=1.5,
         bass_force=18.0, bass_threshold=0.08, mid_force=8.0,
         mid_threshold=0.08, treble_force=4.0, treble_threshold=0.06,
         size_kick=0.2, shimmer_kick=0.4, foam_kick=1.2),
    # 4 Molten Disco: gold metal sloshing in a cylinder
    dict(shape_type=2, box_half=[6, 5, 6], gravity_y=-200.0, viscosity=4.0,
         gas_constant=2000.0, surface_tension=0.10,
         **_impostor_look(1.25), palette_id=12, viz_mode=1,
         viz_range_min=0.0, viz_range_max=12.0, palette_flow=0.10,
         audio_master_gain=1.4, bass_force=14.0, bass_threshold=0.07,
         mid_force=6.0, mid_threshold=0.07, treble_force=2.5,
         treble_threshold=0.05, size_kick=0.45, shimmer_kick=0.7,
         foam_kick=0.3),
    # 5 Vaporwave Orb: the saved live look
    dict(shape_type=1, box_half=[14.35, 14.35, 14.35], h=0.634, mass=156.5,
         gas_constant=9467.0, viscosity=4.177, gravity_y=-371.835,
         surface_tension=0.08, time_step=0.000388, wall_restitution=0.22,
         wall_friction=0.131, **_impostor_look(1.3), palette_id=6,
         viz_mode=0, viz_range_min=8.0, viz_range_max=40.0,
         palette_flow=-0.165, audio_master_gain=1.816, bass_force=25.685,
         bass_threshold=0.08, mid_force=21.629, mid_threshold=0.08,
         treble_force=27.959, treble_threshold=0.06, size_kick=2.0,
         shimmer_kick=1.092, foam_kick=1.570, bass_wavelength=17.657,
         mid_wavelength=7.385, treble_wavelength=2.043,
         bass_phase_speed=7.816, mid_rot_speed=2.579,
         treble_phase_speed=15.285),
    # 6 Chrome Mercury: cohesive metallic blob
    dict(shape_type=1, box_half=[7, 7, 7], gravity_y=-40.0, viscosity=7.0,
         gas_constant=1800.0, surface_tension=0.12,
         **_impostor_look(1.4), palette_id=11, viz_mode=5,
         viz_range_min=0.0, viz_range_max=12.0, palette_flow=0.03,
         audio_master_gain=1.5, bass_force=14.0, bass_threshold=0.06,
         mid_force=5.0, mid_threshold=0.07, treble_force=2.0,
         treble_threshold=0.05, size_kick=0.5, shimmer_kick=0.8,
         foam_kick=0.2, bass_wavelength=12.0, audio_attack_ms=18.0,
         audio_release_ms=300.0),
    # 7 Plasma Storm: energetic energy ball, snappy strobe
    dict(shape_type=1, box_half=[7, 7, 7], gravity_y=-8.0, viscosity=1.5,
         gas_constant=5000.0, surface_tension=0.05,
         **_impostor_look(1.1), palette_id=10, viz_mode=6,
         viz_range_min=0.0, viz_range_max=7.0, palette_flow=0.35,
         audio_master_gain=1.8, bass_force=16.0, bass_threshold=0.05,
         mid_force=7.0, mid_threshold=0.06, treble_force=4.0,
         treble_threshold=0.04, size_kick=0.6, shimmer_kick=1.2,
         foam_kick=0.3, treble_phase_speed=20.0, audio_attack_ms=10.0,
         audio_release_ms=160.0),
    # 8 Lava Lamp: slow rising warm blobs in a tall cylinder
    dict(shape_type=2, box_half=[5, 7, 5], gravity_y=-25.0, viscosity=10.0,
         gas_constant=900.0, surface_tension=0.15,
         **_impostor_look(1.5), palette_id=16, viz_mode=0,
         viz_range_min=-7.0, viz_range_max=7.0, palette_flow=0.04,
         audio_master_gain=1.3, bass_force=10.0, bass_threshold=0.07,
         mid_force=4.0, mid_threshold=0.08, treble_force=1.5,
         treble_threshold=0.06, size_kick=0.4, shimmer_kick=0.4,
         foam_kick=0.2, bass_wavelength=8.0, audio_attack_ms=25.0,
         audio_release_ms=420.0),
    # 9 Candy Rain: playful colorful downpour in a box
    dict(shape_type=0, box_half=[8, 8, 8], gravity_y=-500.0, viscosity=2.0,
         gas_constant=2500.0, surface_tension=0.08,
         **_impostor_look(1.1), palette_id=20, viz_mode=1,
         viz_range_min=0.0, viz_range_max=14.0, palette_flow=0.15,
         audio_master_gain=1.5, bass_force=16.0, bass_threshold=0.08,
         mid_force=8.0, mid_threshold=0.08, treble_force=5.0,
         treble_threshold=0.06, size_kick=0.3, shimmer_kick=1.0,
         foam_kick=0.4, treble_wavelength=1.5, treble_phase_speed=16.0,
         audio_attack_ms=12.0, audio_release_ms=200.0),
    # 10 Donut Vortex: fluid whirling around a torus
    dict(shape_type=3, box_half=[7.0, 2.2, 0.0], gravity_y=-60.0,
         viscosity=2.5, gas_constant=2500.0, surface_tension=0.08,
         **_impostor_look(1.2), palette_id=19, viz_mode=1,
         viz_range_min=0.0, viz_range_max=12.0, palette_flow=0.20,
         vortex_base=4.0, vortex_audio=14.0, vortex_inward=1.0,
         orbit_on=True, orbit_speed=10.0, orbit_kick=0.5, hue_kick=20.0,
         flash_kick=0.4, audio_master_gain=1.5, bass_force=12.0,
         bass_threshold=0.06, mid_force=5.0, mid_threshold=0.06,
         treble_force=2.0, treble_threshold=0.05, size_kick=0.4,
         shimmer_kick=0.7, foam_kick=0.3),
    # 11 Capsule Wave: real water sloshing end to end in a pill
    dict(shape_type=4, box_half=[4.0, 5.0, 0.0], gravity_y=-500.0,
         viscosity=3.0, gas_constant=3000.0, surface_tension=0.10,
         render_mode=0, foam_gen=1.3, foam_amount=2.0, orbit_on=True,
         orbit_speed=6.0, flash_kick=0.5, audio_master_gain=1.5,
         bass_force=20.0, bass_threshold=0.08, mid_force=8.0,
         mid_threshold=0.08, treble_force=4.0, treble_threshold=0.06,
         size_kick=0.2, shimmer_kick=0.4, foam_kick=1.0),
    # 12 Hourglass Drip: molten gold pulsing through the neck on bass
    dict(shape_type=5, box_half=[6.0, 7.0, 1.4], gravity_y=-700.0,
         viscosity=3.0, gas_constant=3000.0, surface_tension=0.10,
         **_impostor_look(1.25), palette_id=12, viz_mode=1,
         viz_range_min=0.0, viz_range_max=14.0, palette_flow=0.10,
         flash_kick=0.6, audio_master_gain=1.5, bass_force=18.0,
         bass_threshold=0.07, mid_force=6.0, mid_threshold=0.07,
         treble_force=2.5, treble_threshold=0.05, size_kick=0.4,
         shimmer_kick=0.8, foam_kick=0.3),
    # 13 Cosmic Egg: galaxy cloud drifting in an egg, reverse orbit
    dict(shape_type=6, box_half=[5.5, 7.5, 0.0], gravity_y=-20.0,
         viscosity=6.0, gas_constant=1500.0, surface_tension=0.06,
         **_impostor_look(1.3), palette_id=9, viz_mode=6,
         viz_range_min=0.0, viz_range_max=8.0, palette_flow=0.08,
         orbit_on=True, orbit_speed=-8.0, orbit_kick=1.0, hue_kick=30.0,
         flash_kick=0.5, vortex_base=1.5, audio_master_gain=1.5,
         bass_force=10.0, bass_threshold=0.06, mid_force=4.0,
         mid_threshold=0.07, treble_force=1.8, treble_threshold=0.05,
         size_kick=0.5, shimmer_kick=0.6, foam_kick=0.2),
]


def apply_art_preset(s: SceneSettings, which: int) -> SceneSettings:
    """Canvas + preset overrides; enables audio reaction.  The caller is
    responsible for the respawn (the reference sets pendingReset)."""
    which = max(0, min(which, len(ART_PRESETS) - 1))
    out = dataclasses.replace(s)
    for k, v in _CANVAS.items():
        setattr(out, k, list(v) if isinstance(v, list) else v)
    for k, v in ART_PRESETS[which].items():
        setattr(out, k, list(v) if isinstance(v, list) else v)
    out.audio_enabled = True
    return out


# --- SurpriseMe randomizer (Scene0p.cpp:1857-1946) -----------------------

_SURPRISE_SHAPES: Tuple[Tuple[int, Tuple[float, float, float]], ...] = (
    (0, (7, 7, 7)), (1, (7, 7, 7)), (2, (6, 6, 6)), (3, (7.0, 2.2, 0.0)),
    (4, (4.0, 5.0, 0.0)), (5, (6.0, 7.0, 1.4)), (6, (5.5, 7.5, 0.0)),
    (7, (6.5, 6.5, 6.5)), (8, (6.0, 6.0, 6.0)), (9, (6.5, 1.6, 0.0)),
)


def surprise_me(s: SceneSettings, seed: int | None = None) -> SceneSettings:
    """Randomize a whole look within curated ranges.  Deterministic for a
    given seed (unlike the reference's rand(), so reels can reproduce)."""
    rng = random.Random(seed)
    out = apply_art_preset(s, rng.randrange(len(ART_PRESETS)))
    shape, half = _SURPRISE_SHAPES[rng.randrange(len(_SURPRISE_SHAPES))]
    out.shape_type = shape
    out.box_half = list(half)
    out.palette_id = rng.randrange(24)
    out.viz_mode = rng.randrange(7)
    out.palette_flow = rng.uniform(-0.2, 0.35)
    out.gravity_y = -rng.uniform(8.0, 980.0)
    out.viscosity = rng.uniform(1.0, 10.0)
    out.gas_constant = rng.uniform(900.0, 5000.0)
    out.surface_tension = rng.uniform(0.03, 0.15)
    out.size_kick = rng.uniform(0.2, 0.8)
    out.shimmer_kick = rng.uniform(0.3, 1.2)
    out.hue_kick = rng.choice([0.0, 15.0, 30.0])
    out.orbit_on = rng.random() < 0.5
    out.orbit_speed = rng.uniform(-12.0, 12.0)
    out.vortex_base = rng.choice([0.0, 0.0, 1.5, 4.0])
    if rng.random() < 0.3:
        out.two_color = True
        out.palette_id2 = rng.randrange(24)
        out.mix_pattern = rng.randrange(3)
    return out
