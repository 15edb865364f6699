"""Headless terrain heightfield renderer (counterpart of
``sph_tpu/viz/terrain.py``, a copy of it over the port's host rasterizer)
— the reference's river terrain mesh pass (R12: ``terrainVert/Frag.glsl``,
mesh build ``Scene0p.cpp:2942-3123``) as a TRUE triangle mesh.

The heightfield upsamples (bilinear) to a dense vertex grid, builds the
same two-triangles-per-cell topology the reference builds on the CPU
(``Scene0p.cpp:2967-2984``), shades vertices with the fragment shader's
height-blended colors (wet rock -> dry rock -> soil -> grass,
``terrainFrag.glsl:14-26``) and Lambertian lighting from
finite-difference normals (``Scene0p.cpp:2988-2996``), then z-buffer
rasterizes with perspective-correct interpolation
(``viz/raster.py`` / ``native/tri_raster.cpp``).  Drawn before the
particle pass so the fluid occludes the ground it flows over.
"""
from __future__ import annotations

import math

import numpy as np

from sph_tpu_torch.viz import raster as R

# height-blend palette (terrainFrag.glsl:14-17)
_WET_ROCK = np.array([0.22, 0.19, 0.15], np.float32)
_DRY_ROCK = np.array([0.42, 0.37, 0.30], np.float32)
_SOIL = np.array([0.34, 0.28, 0.20], np.float32)
_GRASS = np.array([0.20, 0.36, 0.13], np.float32)


def terrain_colors(heights: np.ndarray, normals: np.ndarray,
                   sun_dir, sun_color) -> np.ndarray:
    """[M] heights + [M,3] normals -> [M,3] shaded colors
    (terrainFrag.glsl semantics)."""
    t = np.clip(heights * 0.18 + 0.35, 0.0, 1.0)
    c = np.empty((len(t), 3), np.float32)
    lo = t < 0.25
    mid = (t >= 0.25) & (t < 0.55)
    hi = t >= 0.55
    c[lo] = _WET_ROCK + (_DRY_ROCK - _WET_ROCK) * (t[lo, None] * 4.0)
    c[mid] = _DRY_ROCK + (_SOIL - _DRY_ROCK) * ((t[mid, None] - 0.25)
                                                / 0.30)
    c[hi] = _SOIL + (_GRASS - _SOIL) * ((t[hi, None] - 0.55) / 0.45)
    sd = np.asarray(sun_dir, np.float32)
    sd = sd / max(np.linalg.norm(sd), 1e-9)
    ndotl = np.maximum(0.15, normals @ sd)
    return np.clip(c * np.asarray(sun_color, np.float32)[None, :]
                   * ndotl[:, None], 0.0, 1.0)


def terrain_points(terrain: np.ndarray, box_center, box_half,
                   upsample: int = 3):
    """Heightfield -> (world positions [M,3], normals [M,3]) on a dense
    bilinear grid (upsample x the physics resolution)."""
    th, tw = terrain.shape
    c = np.asarray(box_center, np.float32)
    half = np.asarray(box_half, np.float32)
    rh, rw = th * upsample, tw * upsample

    u = np.linspace(0.0, tw - 1.0, rw, dtype=np.float32)
    v = np.linspace(0.0, th - 1.0, rh, dtype=np.float32)
    uu, vv = np.meshgrid(u, v)
    u0 = np.clip(uu.astype(np.int32), 0, tw - 2)
    v0 = np.clip(vv.astype(np.int32), 0, th - 2)
    fu = uu - u0
    fv = vv - v0
    h = (terrain[v0, u0] * (1 - fu) * (1 - fv)
         + terrain[v0, u0 + 1] * fu * (1 - fv)
         + terrain[v0 + 1, u0] * (1 - fu) * fv
         + terrain[v0 + 1, u0 + 1] * fu * fv)

    wx = c[0] - half[0] + (uu / (tw - 1)) * 2.0 * half[0]
    wz = c[2] - half[2] + (vv / (th - 1)) * 2.0 * half[2]

    dx = 2.0 * half[0] / (rw - 1)
    dz = 2.0 * half[2] / (rh - 1)
    gx = np.gradient(h, axis=1) / dx
    gz = np.gradient(h, axis=0) / dz
    n = np.stack([-gx, np.ones_like(h), -gz], -1)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)

    pos = np.stack([wx, h, wz], -1).reshape(-1, 3).astype(np.float32)
    return pos, n.reshape(-1, 3).astype(np.float32)


def draw_terrain(img: np.ndarray, terrain: np.ndarray, box_center,
                 box_half, view: np.ndarray, proj: np.ndarray,
                 sun_dir=(0.4, 1.0, 0.5), sun_color=(1.0, 0.97, 0.9),
                 upsample: int = 3, return_depth: bool = False):
    """Rasterize the terrain triangle mesh into an [H,W,3] uint8 frame
    (z-buffered, perspective-correct vertex colors — the headless
    equivalent of the reference's GL terrain pass).

    ``return_depth=True`` additionally returns the [H,W] float32 view
    depth buffer (+inf where no terrain), letting later passes occlude
    against the ground."""

    hpx, wpx = img.shape[:2]
    pos, normals = terrain_points(terrain, box_center, box_half, upsample)
    col = terrain_colors(pos[:, 1], normals, sun_dir, sun_color)
    rh = terrain.shape[0] * upsample
    rw = terrain.shape[1] * upsample
    tris = R.grid_mesh_tris(rh, rw)

    px, py, depth = R.project_to_screen(pos, view, proj, wpx, hpx)
    out = img.astype(np.float32)
    zbuf = np.full((hpx, wpx), np.inf, np.float32)
    R.rasterize(out, zbuf, px, py, depth, col, tris)
    frame = np.clip(out, 0.0, 255.0).astype(np.uint8)
    if return_depth:
        return frame, zbuf
    return frame
