"""Headless triangle rasterization + mesh assets (counterpart of
``sph_tpu/viz/raster.py``).

Backbone for the two true-geometry render paths of the reference:

- the terrain mesh pass (R12): ``Scene0p.cpp:2942-3123`` builds a
  grid-triangle mesh over the river heightfield and draws it with
  ``terrainVert/Frag.glsl`` — rebuilt by ``viz/terrain.py`` on top of
  :func:`rasterize` below;
- the instanced particle-mesh mode (C10/R2): ``Mesh.cpp:20-54`` loads
  ``meshes/Sphere.obj`` and ``defaultVert.glsl:30-35`` instances it
  per particle (translate + scale) — rebuilt by
  :func:`draw_mesh_instances` (+ :func:`load_obj` /
  :func:`icosphere`, since the reference repo does not ship its own
  Sphere.obj asset).

Rasterization is z-buffered with per-vertex colors and
perspective-correct interpolation.  It runs on the host, as in the JAX
package: the loop is the C++ core ``native/tri_raster.cpp`` (the JAX
package's source, built by ``native/build.py``; a failed build raises).
:func:`rasterize_plain` is its plain version, a numpy fill per triangle
with the same float32 operations in the same order, so the two are the
same bits.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from sph_tpu_torch.native import build


def project_to_screen(pos: np.ndarray, view: np.ndarray,
                      proj: np.ndarray, width: int, height: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """World [V,3] -> (screen x, screen y, positive view depth).
    Points at/behind the eye get depth 0 (culled by the rasterizer)."""
    vp = pos @ view[:3, :3].T + view[:3, 3]
    depth = -vp[:, 2]
    safe = np.maximum(depth, 1e-6)
    px = (vp[:, 0] * proj[0, 0] / safe * 0.5 + 0.5) * width
    py = (1.0 - (vp[:, 1] * proj[1, 1] / safe * 0.5 + 0.5)) * height
    depth = np.where(depth > 1e-6, depth, 0.0)
    return (px.astype(np.float32), py.astype(np.float32),
            depth.astype(np.float32))


def _inputs(px, py, depth, colors, tris):
    return (np.ascontiguousarray(px, np.float32),
            np.ascontiguousarray(py, np.float32),
            np.ascontiguousarray(depth, np.float32),
            np.ascontiguousarray(colors, np.float32),
            np.ascontiguousarray(np.asarray(tris).reshape(-1, 3), np.int32))


def rasterize(img: np.ndarray, zbuf: np.ndarray,
              px: np.ndarray, py: np.ndarray, depth: np.ndarray,
              colors: np.ndarray, tris: np.ndarray) -> None:
    """Z-buffered draw of ``tris`` [T,3] over screen-space vertices
    into ``img`` [H,W,3] float32 (0..255) and ``zbuf`` [H,W] float32,
    both modified in place (both C-contiguous float32), with the host
    rasterizer."""
    if not (img.dtype == zbuf.dtype == np.float32 and img.flags.c_contiguous
            and zbuf.flags.c_contiguous):
        raise ValueError("rasterize draws into C-contiguous float32 "
                         "img and zbuf")
    h, w = zbuf.shape
    vx, vy, vz, col, tri = _inputs(px, py, depth, colors, tris)
    vr, vg, vb = (np.ascontiguousarray(col[:, k]) for k in range(3))
    build.tri_library().rasterize_tris(
        img.ctypes.data, zbuf.ctypes.data, h, w, vx.ctypes.data,
        vy.ctypes.data, vz.ctypes.data, vr.ctypes.data, vg.ctypes.data,
        vb.ctypes.data, tri.ctypes.data, len(tri))


def rasterize_plain(img: np.ndarray, zbuf: np.ndarray,
                    px: np.ndarray, py: np.ndarray, depth: np.ndarray,
                    colors: np.ndarray, tris: np.ndarray) -> None:
    """:func:`rasterize` as a numpy fill per triangle over its bounding
    box: the host rasterizer's plain version, with its float32 operations
    in its order (attributes divided by depth first, then interpolated)."""
    h, w = zbuf.shape
    vx, vy, vz, col, tris = _inputs(px, py, depth, colors, tris)
    flat = img.reshape(-1, 3)
    zflat = zbuf.reshape(-1)
    one = np.float32(1.0)
    for i0, i1, i2 in tris:
        if vz[i0] <= 0 or vz[i1] <= 0 or vz[i2] <= 0:
            continue
        x0, y0, x1, y1, x2, y2 = (vx[i0], vy[i0], vx[i1], vy[i1],
                                  vx[i2], vy[i2])
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        if abs(area) < np.float32(1e-12):
            continue
        inv = one / area
        minx = max(int(math.floor(min(x0, x1, x2))), 0)
        maxx = min(int(math.ceil(max(x0, x1, x2))), w - 1)
        miny = max(int(math.floor(min(y0, y1, y2))), 0)
        maxy = min(int(math.ceil(max(y0, y1, y2))), h - 1)
        if minx > maxx or miny > maxy:
            continue
        iz0, iz1, iz2 = one / vz[i0], one / vz[i1], one / vz[i2]
        c0, c1, c2 = col[i0] * iz0, col[i1] * iz1, col[i2] * iz2
        xs = np.arange(minx, maxx + 1).astype(np.float32) + np.float32(0.5)
        ys = np.arange(miny, maxy + 1).astype(np.float32) + np.float32(0.5)
        fx, fy = np.meshgrid(xs, ys)
        w0 = ((x1 - fx) * (y2 - fy) - (x2 - fx) * (y1 - fy)) * inv
        w1 = ((x2 - fx) * (y0 - fy) - (x0 - fx) * (y2 - fy)) * inv
        w2 = one - w0 - w1
        yy, xx = np.nonzero((w0 >= 0) & (w1 >= 0) & (w2 >= 0))
        if len(yy) == 0:
            continue
        w0, w1, w2 = w0[yy, xx], w1[yy, xx], w2[yy, xx]
        z = one / (w0 * iz0 + w1 * iz1 + w2 * iz2)
        pi = (yy + miny) * w + (xx + minx)
        closer = z < zflat[pi]
        pi, z = pi[closer], z[closer]
        w0, w1, w2 = w0[closer, None], w1[closer, None], w2[closer, None]
        zflat[pi] = z
        flat[pi] = np.float32(255.0) * (w0 * c0 + w1 * c1 + w2 * c2) \
            * z[:, None]


def grid_mesh_tris(rows: int, cols: int) -> np.ndarray:
    """Triangle index list [2*(rows-1)*(cols-1), 3] for a row-major
    vertex grid (the terrain mesh topology, Scene0p.cpp:2967-2984)."""
    r = np.arange(rows - 1)[:, None]
    c = np.arange(cols - 1)[None, :]
    v00 = (r * cols + c).ravel()
    v01 = v00 + 1
    v10 = v00 + cols
    v11 = v10 + 1
    t1 = np.stack([v00, v10, v01], axis=1)
    t2 = np.stack([v01, v10, v11], axis=1)
    return np.concatenate([t1, t2], axis=0).astype(np.int32)


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal wavefront OBJ: v + f (poly faces fan-triangulated;
    v/vt/vn index forms accepted) -> (verts [V,3] f32, tris [T,3] i32).
    Mirrors the fields ``Mesh::LoadFromObj`` consumes (Mesh.cpp:20-54)."""
    verts = []
    tris = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v" and len(parts) >= 4:
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif parts[0] == "f" and len(parts) >= 4:
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    tris.append([idx[0], idx[k], idx[k + 1]])
    if not verts or not tris:
        raise ValueError(f"no geometry in OBJ file {path!r}")
    return (np.asarray(verts, np.float32),
            np.asarray(tris, np.int32))


def icosphere(subdiv: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosphere (42 verts / 80 tris at subdiv 1) — the default
    instanced-mesh asset (the reference's own meshes/Sphere.obj is
    absent from its repo, so this is the stand-in sphere)."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    verts = [tuple(x) for x in v]
    cache = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key in cache:
            return cache[key]
        m = np.asarray(verts[a]) + np.asarray(verts[b])
        m /= np.linalg.norm(m)
        verts.append(tuple(m))
        cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdiv):
        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        f = nf
    return (np.asarray(verts, np.float32),
            np.asarray(f, np.int32))


def draw_mesh_instances(img: np.ndarray, zbuf: np.ndarray,
                        centers: np.ndarray, radii, colors: np.ndarray,
                        view: np.ndarray, proj: np.ndarray,
                        mesh: Optional[Tuple[np.ndarray, np.ndarray]]
                        = None,
                        sun_dir=(0.4, 1.0, 0.5),
                        chunk: int = 2048) -> None:
    """Instanced mesh draw with the host rasterizer: one unit mesh
    translated + scaled per particle (``defaultVert.glsl:30-35``),
    Lambert-shaded from vertex normals (= unit-sphere vertex positions for
    the default asset),
    z-buffered into img/zbuf in place.  Instances process in chunks to
    bound the expanded-vertex memory."""
    h, w = zbuf.shape
    verts, tris = mesh if mesh is not None else icosphere(1)
    nv = len(verts)
    sd = np.asarray(sun_dir, np.float32)
    sd /= max(np.linalg.norm(sd), 1e-9)
    vnorm = verts / np.maximum(
        np.linalg.norm(verts, axis=1, keepdims=True), 1e-9)
    shade = (0.35 + 0.65 * np.clip(vnorm @ sd, 0.0, 1.0)
             ).astype(np.float32)
    radii = np.broadcast_to(np.asarray(radii, np.float32),
                            (len(centers),))
    for c0 in range(0, len(centers), chunk):
        cs = centers[c0:c0 + chunk]
        rs = radii[c0:c0 + chunk]
        cols = colors[c0:c0 + chunk]
        m = len(cs)
        pos = (cs[:, None, :] + rs[:, None, None] * verts[None, :, :]
               ).reshape(-1, 3)
        vcol = (cols[:, None, :] * shade[None, :, None]
                ).reshape(-1, 3).astype(np.float32)
        px, py, depth = project_to_screen(pos, view, proj, w, h)
        toff = (np.arange(m, dtype=np.int64)[:, None, None] * nv
                + tris[None, :, :]).reshape(-1, 3)
        rasterize(img, zbuf, px, py, depth, vcol, toff)
