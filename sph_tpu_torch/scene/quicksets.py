"""Physics quick-sets (counterpart of ``sph_tpu/scene/quicksets.py``, a
copy of it) — the reference's one-click "Stable Water" / "Splashy Water"
bundles (``Scene0p.cpp:824-850``).

Each bundle overwrites a handful of physics fields and queues a respawn
(the reference sets ``pendingReset = true`` because mass re-derives from
``h`` at spawn, ``SPHFluid3D.cpp:92``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from sph_tpu_torch.scene.settings import SceneSettings

# field -> value, verbatim from the reference buttons
QUICKSETS: Dict[str, Dict[str, float]] = {
    # Scene0p.cpp:824-834
    "stable": dict(
        h=0.28, rest_density=1000.0, gas_constant=2000.0,
        viscosity=3.5, gravity_y=-980.0, surface_tension=0.0,
        time_step=1e-3),
    # Scene0p.cpp:836-850
    "splashy": dict(
        h=0.22, rest_density=1000.0, gas_constant=6000.0,
        viscosity=1.2, gravity_y=-980.0, surface_tension=0.12,
        time_step=5e-4, use_jitter=False, jitter_amp=0.06,
        wall_restitution=0.05, wall_friction=0.05),
}


def apply_quickset(s: SceneSettings, name: str) -> SceneSettings:
    """Return new settings with the named bundle applied.  Raises
    KeyError on an unknown name (callers list QUICKSETS for the menu)."""
    return dataclasses.replace(s, **QUICKSETS[name])
