"""The doc gallery: one still for each render path and scene mode
(counterpart of ``scripts/make_gallery.py``).

    python -m sph_tpu_torch.app.gallery <out_dir>

Five looks (:data:`LOOKS`), each a ``Scene`` at 3,000 asked rows (2,000
for the river) in a box of half extent 5 with the outline on, its engine
the JAX script's ``"binned"`` (the cell engine's kernels, through
``engine.step.ENGINES``), settled for 30 to 45 frames of 1/60 s and shot
at 480x270 with the camera moved in by the look's zoom:

- ``impostors_speed``: impostor splats, the speed palette, lit spheres;
- ``water_ssfr``: the SSFR water surface with the sky;
- ``torus_two_color``: the torus container's wireframe, two-color groups;
- ``river_canyon``: the river canyon with its bank lines;
- ``postfx_bloom``: bloom and vignette over a stirred splash.

The scenes run on the CUDA card unless the caller names another device
(``core.device.resolve``).  The output directory is required: the gallery
never writes into ``docs/gallery/`` unless asked to.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from sph_tpu_torch.scene.scene import Scene
from sph_tpu_torch.scene.settings import SceneSettings
from sph_tpu_torch.viz.splat import save_png

W, H = 480, 270
FRAME_DT = 1.0 / 60.0
ENGINE = "binned"            # the JAX script's engine name
# base_settings's fields (scripts/make_gallery.py:28-36)
BASE = dict(particle_count=3000, box_half=[5.0, 5.0, 5.0], show_outline=True)


@dataclasses.dataclass(frozen=True)
class Look:
    settings: dict               # over base_settings
    seed: int
    frames: int                  # settle's frames of FRAME_DT
    zoom: float                  # the camera's distance is scaled by it
    river: Optional[int] = None  # enable_river's seed, in river mode


# the script's five calls (scripts/make_gallery.py:56-93), in its order
LOOKS: Dict[str, Look] = {
    "impostors_speed": Look(
        dict(render_mode=1, palette_id=2, viz_mode=1, lit_particles=True),
        seed=7, frames=30, zoom=0.55),
    "water_ssfr": Look(
        dict(render_mode=0, sky_on=True, show_outline=False,
             thickness_strength=0.35, foam_amount=2.0,
             render_radius_scale=2.2),
        seed=3, frames=30, zoom=0.45),
    "torus_two_color": Look(
        dict(render_mode=1, shape_type=3, box_half=[4.0, 1.5, 4.0],
             two_color=True, palette_id=6, palette_id2=12, mix_pattern=0),
        seed=5, frames=30, zoom=0.6),
    "river_canyon": Look(
        dict(render_mode=1, particle_count=2000, palette_id=14, viz_mode=0),
        seed=11, frames=40, zoom=0.6, river=11),
    "postfx_bloom": Look(
        dict(render_mode=1, palette_id=19, viz_mode=1, bloom_strength=1.2,
             bloom_threshold=0.25, vignette=0.3, show_outline=True,
             lit_particles=True, continuous_wave=True),
        seed=9, frames=45, zoom=0.55),
}


def base_settings(**kw) -> SceneSettings:
    """The default settings with :data:`BASE` and then ``kw`` set (lists
    copied, so no scene shares one with the tables)."""
    s = SceneSettings()
    for k, v in {**BASE, **kw}.items():
        setattr(s, k, copy.deepcopy(v))
    return s


def build(name: str, device=None, count: Optional[int] = None) -> Scene:
    """Look ``name``'s scene on ``device`` (the CUDA card unless the caller
    names another), before it settles; ``count`` overrides its asked
    rows."""
    look = LOOKS[name]
    kw = dict(look.settings)
    if count is not None:
        kw["particle_count"] = count
    scene = Scene(base_settings(**kw), neighbor_impl=ENGINE, seed=look.seed,
                  device=device)
    if look.river is not None:
        scene.enable_river(look.river)
    return scene


def settle(scene: Scene, frames: int = 30) -> List[int]:
    """``frames`` frames of ``Scene.update(FRAME_DT)``; returns the
    substeps of each."""
    return [scene.update(FRAME_DT) for _ in range(frames)]


def frame(scene: Scene, zoom: float = 1.0) -> np.ndarray:
    """The scene's W x H frame with the camera's distance scaled by
    ``zoom``; the distance is restored after."""
    distance = scene.camera.distance
    scene.camera.distance = distance * zoom
    try:
        return scene.render(W, H)
    finally:
        scene.camera.distance = distance


def shot(name: str, scene: Scene, out_dir: str, zoom: float = 1.0) -> str:
    """Look ``name``'s still of ``scene`` as ``<out_dir>/<name>.png``;
    returns its path."""
    path = os.path.join(out_dir, f"{name}.png")
    save_png(frame(scene, zoom), path)
    return path


def main(argv: Optional[List[str]] = None, device=None
         ) -> List[Tuple[str, Scene, str]]:
    """Render the five stills into the output directory (made if missing);
    returns (name, scene, path) for each look, in :data:`LOOKS`' order."""
    ap = argparse.ArgumentParser(prog="python -m sph_tpu_torch.app.gallery",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", help="directory to write the stills into")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    out = []
    for name, look in LOOKS.items():
        scene = build(name, device=device)
        settle(scene, look.frames)
        path = shot(name, scene, args.out_dir, zoom=look.zoom)
        print(f"wrote {path}")
        out.append((name, scene, path))
    return out


if __name__ == "__main__":
    main()
