"""The scene's main paths: what a user of the scene runs, frame by frame.

Each path is a ``scene.scene.Scene`` set up as users start it (``respawn``,
and for the river ``enable_river``) and driven by ``Scene.update``: per
frame the continuous wave, the audio reaction, the fountain's jet speed
from the live values, the fixed-dt substep accumulator, then the substeps.
The bands are ``cmd_run --audio``'s stand-in for a track
(``sph_tpu/app/main.py``), with the audio reaction on.

- ``river_65k``: ``sph_tpu.app.main run --river --particles 65536``
  (README): default settings, the box spawn, then river mode with
  ``RiverSpec.random(0)`` on a 64x64 terrain;
- ``torus_vortex_50k``: art preset 10, "Donut Vortex" (a torus, the vortex
  impulse) at 50,000 asked rows;
- ``fountain_50k``: the fountain's key toggle on the default scene.

``build`` puts the scene on the CUDA card unless given a device
(``core.device.resolve``).  ``chip_smoke.py`` drives these paths,
``app/profile_substeps.py`` profiles them, and ``tests/test_torch_modes.py``
prints the JAX package's density after the same frames.
"""
from __future__ import annotations

import math

from sph_tpu_torch.scene import art_presets
from sph_tpu_torch.scene.scene import Scene
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
          count=None, device=None) -> Scene:
    """The path's scene on ``device``: ``Scene.respawn``'s spawn and params,
    and for the river ``Scene.enable_river(seed)``."""
    scene = Scene(settings(name, count), neighbor_impl=neighbor_impl,
                  seed=seed, device=device)
    if PATHS[name][2]:
        scene.enable_river(seed)
    return scene


def frame(index: int, scene: Scene, max_substeps=None) -> int:
    """Frame ``index`` of the path: ``Scene.update`` with the frame's
    bands.  Returns the substeps run."""
    return scene.update(FRAME_DT, bands=bands(index),
                        max_substeps=max_substeps)
