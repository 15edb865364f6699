"""Container wireframe + river bank lines (counterpart of
``sph_tpu/viz/wireframe.py``, a copy of it) — the reference's line-render
path (``lineVert/Frag.glsl``, wireframe builder ``Scene0p.cpp:281-539``,
bank lines ``Scene0p.cpp:3030-3123``) rebuilt as headless overlay
rasterization.

Each shape yields a set of polylines (vectorized numpy, re-derived from
the analytic shape definitions in ``physics/constraints.py`` — three
great circles for the sphere, cap rings + verticals for prisms, tube
cross-sections for the torus/trefoil, parametric sections for the
superellipsoid, ...).  ``draw_polylines`` alpha-blends them into a
rendered frame by sampling each segment at sub-pixel steps (the
painter-splat analogue of a GL line draw).
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

from sph_tpu_torch.core.params import rotation_matrix_np

TWO_PI = 2.0 * math.pi


def _ring(radius: float, y: float, segs: int = 48) -> np.ndarray:
    a = np.linspace(0.0, TWO_PI, segs + 1, dtype=np.float32)
    return np.stack([np.cos(a) * radius,
                     np.full_like(a, y),
                     np.sin(a) * radius], -1)


def _circle_in_plane(radius: float, axis: int, segs: int = 48) -> np.ndarray:
    """Great circle of `radius` perpendicular to `axis`."""
    a = np.linspace(0.0, TWO_PI, segs + 1, dtype=np.float32)
    c, s = np.cos(a) * radius, np.sin(a) * radius
    z = np.zeros_like(a)
    if axis == 0:
        return np.stack([z, c, s], -1)
    if axis == 1:
        return np.stack([c, z, s], -1)
    return np.stack([c, s, z], -1)


def _verticals(radius: float, hh: float, n: int = 4) -> List[np.ndarray]:
    out = []
    for k in range(n):
        a = TWO_PI * k / n
        cx, cz = math.cos(a) * radius, math.sin(a) * radius
        out.append(np.asarray([[cx, -hh, cz], [cx, hh, cz]], np.float32))
    return out


def _trefoil(t: np.ndarray, s: float) -> np.ndarray:
    """Trefoil centerline (matches constraints.py / OBBConstraints.comp)."""
    return np.stack([
        s * (np.sin(t) + 2.0 * np.sin(2.0 * t)),
        s * 0.35 * (-np.sin(3.0 * t)),
        s * (np.cos(t) - 2.0 * np.cos(2.0 * t))], -1).astype(np.float32)


def shape_polylines(shape_type: int, half, aux=(5.0, 0.35, 2.5)
                    ) -> List[np.ndarray]:
    """Container-local polylines ([M,3] vertex chains) for shapes 0-9."""
    hx, hy, hz = (float(v) for v in half)
    lines: List[np.ndarray] = []

    if shape_type == 1:                       # sphere
        lines += [_circle_in_plane(hx, ax) for ax in range(3)]
    elif shape_type == 2:                     # cylinder
        lines += [_ring(hx, -hy), _ring(hx, hy)] + _verticals(hx, hy)
    elif shape_type == 3:                     # torus
        big_r, tube_r = hx, hy
        lines += [_ring(big_r - tube_r, 0.0), _ring(big_r + tube_r, 0.0),
                  _ring(big_r, -tube_r), _ring(big_r, tube_r)]
        for k in range(8):                    # tube cross-sections
            phi = TWO_PI * k / 8
            cx, sz = math.cos(phi), math.sin(phi)
            a = np.linspace(0.0, TWO_PI, 25, dtype=np.float32)
            rad = big_r + np.cos(a) * tube_r
            lines.append(np.stack(
                [cx * rad, np.sin(a) * tube_r, sz * rad], -1))
    elif shape_type == 4:                     # capsule
        lines += [_ring(hx, -hy), _ring(hx, hy)] + _verticals(hx, hy)
        a = np.linspace(0.0, math.pi, 25, dtype=np.float32)
        for sign, y0 in ((1.0, hy), (-1.0, -hy)):   # dome arcs
            c, e = np.cos(a) * hx, np.sin(a) * hx * sign
            z = np.zeros_like(a)
            lines.append(np.stack([c, y0 + e, z], -1))
            lines.append(np.stack([z, y0 + e, c], -1))
    elif shape_type == 5:                     # hourglass
        neck = min(hz, hx)
        lines += [_ring(hx, -hy), _ring(hx, hy), _ring(neck, 0.0)]
        for k in range(4):                    # slanted edges
            a = TWO_PI * k / 4
            cx, cz = math.cos(a), math.sin(a)
            for ys in (hy, -hy):
                lines.append(np.asarray(
                    [[cx * hx, ys, cz * hx], [cx * neck, 0.0, cz * neck]],
                    np.float32))
    elif shape_type == 6:                     # egg / ellipsoid
        a = np.linspace(0.0, TWO_PI, 49, dtype=np.float32)
        ct, st, z = np.cos(a), np.sin(a), np.zeros_like(a)
        lines.append(np.stack([ct * hx, z, st * hx], -1))       # equator
        lines.append(np.stack([ct * hx, st * hy, z], -1))       # XY section
        lines.append(np.stack([z, st * hy, ct * hx], -1))       # ZY section
    elif shape_type == 7:                     # star prism
        pts = max(3.0, float(aux[0]))
        depth = min(0.9, max(0.0, float(aux[1])))
        a = np.linspace(0.0, TWO_PI, 97, dtype=np.float32)
        r = hx * (1.0 - depth * (0.5 + 0.5 * np.cos(pts * a)))
        for y in (-hy, hy):                   # star outlines
            lines.append(np.stack(
                [np.cos(a) * r, np.full_like(a, y), np.sin(a) * r], -1))
        n_pts = int(pts + 0.5)
        av = np.pi * np.arange(2 * n_pts, dtype=np.float32) / n_pts
        rv = hx * (1.0 - depth * (0.5 + 0.5 * np.cos(pts * av)))
        for ai, ri in zip(av, rv):            # peak + valley verticals
            cx, cz = math.cos(ai) * ri, math.sin(ai) * ri
            lines.append(np.asarray([[cx, -hy, cz], [cx, hy, cz]],
                                    np.float32))
    elif shape_type == 8:                     # superellipsoid
        n = min(8.0, max(0.6, float(aux[2])))
        t = np.linspace(0.0, TWO_PI, 49, dtype=np.float32)

        def se(c):
            return np.sign(c) * np.abs(c) ** (2.0 / n)

        u, v = se(np.cos(t)), se(np.sin(t))
        z = np.zeros_like(t)
        lines.append(np.stack([hx * u, z, hx * v], -1))
        lines.append(np.stack([hx * u, hy * v, z], -1))
        lines.append(np.stack([z, hy * v, hx * u], -1))
    elif shape_type == 9:                     # trefoil knot tube
        scale, tube_r = hx, hy
        t = np.linspace(0.0, TWO_PI, 97, dtype=np.float32)
        lines.append(_trefoil(t, scale))      # centerline
        for k in range(8):                    # tube rings
            tk = TWO_PI * k / 8
            c = _trefoil(np.asarray([tk]), scale)[0]
            tan = _trefoil(np.asarray([tk + 0.05]), scale)[0] - c
            tl = np.linalg.norm(tan)
            if tl < 1e-6:
                continue
            tan = tan / tl
            up = (np.asarray([0.0, 1.0, 0.0]) if abs(tan[1]) < 0.9
                  else np.asarray([1.0, 0.0, 0.0]))
            u = np.cross(tan, up)
            u = u / np.linalg.norm(u)
            w = np.cross(tan, u)
            a = np.linspace(0.0, TWO_PI, 17, dtype=np.float32)
            ring = (c[None, :] + np.outer(np.cos(a) * tube_r, u)
                    + np.outer(np.sin(a) * tube_r, w))
            lines.append(ring.astype(np.float32))
    else:                                     # box: 12 edges
        sx = np.asarray([-1, 1], np.float32)
        corners = np.stack(np.meshgrid(sx * hx, sx * hy, sx * hz,
                                       indexing="ij"), -1).reshape(8, 3)
        edges = [(0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 7),
                 (5, 1), (5, 4), (5, 7), (6, 2), (6, 4), (6, 7)]
        lines += [corners[[a, b]] for a, b in edges]
    return lines


def container_wireframe(shape_type: int, half, center, euler_deg,
                        aux=(5.0, 0.35, 2.5)) -> List[np.ndarray]:
    """World-space container wireframe polylines."""
    rot = rotation_matrix_np(euler_deg).astype(np.float32)
    c = np.asarray(center, np.float32)
    return [pl @ rot.T + c for pl in shape_polylines(shape_type, half, aux)]


def river_bank_lines(spec, box_center, box_half,
                     n_samples: int = 64) -> List[np.ndarray]:
    """Two bank polylines at +-channel_width following the sinusoidal
    centerline, riding the carved terrain edge height
    (``Scene0p.cpp:3030-3123``)."""
    c = np.asarray(box_center, np.float32)
    half = np.asarray(box_half, np.float32)
    z_min, z_size = c[2] - half[2], 2.0 * half[2]
    y_base = c[1] - half[1]
    wz = z_min + (np.arange(n_samples, dtype=np.float32)
                  / (n_samples - 1)) * z_size
    t_flow = (wz - z_min) / z_size
    center_x = c[0] + spec.amp * np.sin(spec.freq * wz + spec.phase)
    edge_y = (y_base + 1.0 - t_flow * spec.slope_drop
              + spec.channel_depth + 0.05)
    out = []
    for side in (-1.0, 1.0):
        x = center_x + side * spec.channel_width
        out.append(np.stack([x, edge_y, wz], -1).astype(np.float32))
    return out


def draw_polylines(img: np.ndarray, polylines: Sequence[np.ndarray],
                   view: np.ndarray, proj: np.ndarray,
                   color=(0.85, 0.95, 1.0), alpha: float = 0.85,
                   samples_per_px: float = 1.5) -> np.ndarray:
    """Alpha-blend world-space polylines into an [H,W,3] uint8 frame."""
    h, w = img.shape[:2]
    out = img.astype(np.float32)
    col = np.asarray(color, np.float32) * 255.0
    for pl in polylines:
        if len(pl) < 2:
            continue
        vp = pl @ view[:3, :3].T + view[:3, 3]
        depth = -vp[:, 2]
        clip = vp @ proj[:3, :3].T + proj[:3, 3]
        ok = depth > 1e-6
        ndc = clip[:, :2] / np.maximum(depth, 1e-6)[:, None]
        px = (ndc[:, 0] * 0.5 + 0.5) * w
        py = (1.0 - (ndc[:, 1] * 0.5 + 0.5)) * h
        for i in range(len(pl) - 1):
            if not (ok[i] and ok[i + 1]):
                continue
            x0, y0, x1, y1 = px[i], py[i], px[i + 1], py[i + 1]
            length = math.hypot(x1 - x0, y1 - y0)
            n = max(2, int(length * samples_per_px))
            t = np.linspace(0.0, 1.0, n, dtype=np.float32)
            xs = np.clip(x0 + (x1 - x0) * t, 0, w - 1).astype(np.int32)
            ys = np.clip(y0 + (y1 - y0) * t, 0, h - 1).astype(np.int32)
            out[ys, xs] = out[ys, xs] * (1.0 - alpha) + col * alpha
    return np.clip(out, 0.0, 255.0).astype(np.uint8)
