"""Plain reference of the exported frame: a painter's-algorithm point
splat of the fluid rows, coloured by speed through the turbo palette, in
numpy.

It follows the port's export (``sph_tpu_torch/viz/camera.py``,
``viz/palettes.py`` for palette 1 and the speed drive, ``viz/splat.py``
``render_frame`` and ``native/splat_raster.cpp``) but stands alone: the
camera, the projection, the colours, the back-to-front order, each
particle's lit disc and the 8-bit image are worked out here again, and
particles are composed by rank (a later particle in painter's order owns
the pixel), not by a loop over particles.  ``low=True`` rounds the
positions, velocities and colours to bfloat16 first: the control of the
pixel comparison.

:func:`read_png` decodes the 8-bit RGB PNG with row filter 0 that the
port writes.
"""
from __future__ import annotations

import math
import struct
import zlib

import numpy as np

BACKGROUND = (0.03, 0.04, 0.06)
SUN_DIR = (0.35, 0.8, 0.45)
SUN_COLOR = (1.0, 0.96, 0.9)
MAX_FOOTPRINT = 4


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` rounded to bfloat16's 8 bits of mantissa, to nearest
    even."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def camera(box_half, aspect: float, margin: float = 2.4):
    """(view, proj) 4x4 float32 of the orbit camera that frames the box:
    yaw 35, pitch 20 degrees, fov 45, near 0.1, far 500, at the distance
    that fits the box's half diagonal times ``margin``."""
    r = float(np.linalg.norm(np.asarray(box_half, np.float32)))
    fov = 45.0
    dist = r * margin / math.tan(math.radians(fov) * 0.5)
    yaw, pitch = math.radians(35.0), math.radians(20.0)
    eye = np.array([dist * math.cos(pitch) * math.sin(yaw),
                    dist * math.sin(pitch),
                    dist * math.cos(pitch) * math.cos(yaw)], np.float32)
    f = -eye / max(np.linalg.norm(eye), 1e-9)
    s = np.cross(f, np.array([0.0, 1.0, 0.0], np.float32))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    view = np.eye(4, dtype=np.float32)
    view[0, :3], view[1, :3], view[2, :3] = s, u, -f
    view[:3, 3] = -view[:3, :3] @ eye
    g = 1.0 / math.tan(math.radians(fov) * 0.5)
    zn, zf = 0.1, 500.0
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0], proj[1, 1] = g / aspect, g
    proj[2, 2], proj[2, 3] = (zf + zn) / (zn - zf), 2.0 * zf * zn / (zn - zf)
    proj[3, 2] = -1.0
    return view, proj


def turbo(t: np.ndarray) -> np.ndarray:
    t = np.clip(t, 0.0, 1.0)
    return np.stack([0.1357 + 4.0 * t - 4.5 * t * t, 2.0 * t - 1.0 * t * t,
                     0.6667 - 1.5 * t + 1.0 * t * t], -1).astype(np.float32)


def hsv_round_trip(c: np.ndarray) -> np.ndarray:
    """The palette's grade at its neutral settings: RGB to HSV and back."""
    c = np.clip(c, 0.0, 1.0)
    r, g, b = c[:, 0], c[:, 1], c[:, 2]
    mx = np.maximum(np.maximum(r, g), b)
    d = mx - np.minimum(np.minimum(r, g), b)
    safe = np.maximum(d, np.float32(1e-10))
    h = np.where(mx == r, np.mod((g - b) / safe, np.float32(6.0)),
                 np.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = np.where(d <= 1e-10, 0.0, h / 6.0).astype(np.float32)
    s = np.where(mx > 1e-10, d / np.maximum(mx, np.float32(1e-10)),
                 0.0).astype(np.float32)
    k = np.stack([h + 1.0, h + 2.0 / 3.0, h + 1.0 / 3.0], -1)
    p = np.abs(np.mod(k, np.float32(1.0)) * 6.0 - 3.0)
    out = mx[:, None] * ((1.0 - s[:, None])
                         + s[:, None] * np.clip(p - 1.0, 0.0, 1.0))
    return np.clip((out - 0.5) + 0.5, 0.0, 1.0).astype(np.float32)


def render(pos, vel, draw, box_half, radius: float, width: int,
           height: int, viz_max: float = 10.0, low: bool = False
           ) -> np.ndarray:
    """The [height, width, 3] uint8 frame of the rows where ``draw``:
    positions ``pos`` and velocities ``vel`` [N, 3] float32, spheres of
    ``radius``, speed over [0, ``viz_max``] on the turbo palette."""
    pos = np.asarray(pos, np.float32)
    vel = np.asarray(vel, np.float32)
    if low:
        pos, vel = bf16(pos), bf16(vel)
    view, proj = camera(box_half, width / height)
    vpos = pos @ view[:3, :3].T + view[:3, 3]
    clip = vpos @ proj[:3, :3].T + proj[:3, 3]
    w = -vpos[:, 2]
    ndc = clip[:, :2] / np.maximum(w, np.float32(1e-6))[:, None]
    px = (ndc[:, 0] * 0.5 + 0.5) * width
    py = (1.0 - (ndc[:, 1] * 0.5 + 0.5)) * height
    draw = (np.asarray(draw, bool) & (w > 1e-6) & (px > -8)
            & (px < width + 8) & (py > -8) & (py < height + 8))

    speed = np.sqrt(np.sum(vel * vel, axis=-1))
    col = hsv_round_trip(turbo(np.clip(speed / viz_max, 0.0, 1.0)))
    if low:
        col = bf16(col)

    idx = np.nonzero(draw)[0]
    depth = -vpos[idx, 2]
    order = np.argsort(-depth, kind="stable")        # far first
    idx, depth = idx[order], depth[order]
    size = (2.0 * radius * proj[1, 1] / np.maximum(depth, 1e-6)
            * height * 0.5)
    rad = np.clip(size * 0.5, 0.5, float(MAX_FOOTPRINT)).astype(np.float32)
    cx, cy, col = px[idx], py[idx], col[idx]

    sun = np.asarray(SUN_DIR, np.float32)
    sun = sun / max(np.linalg.norm(sun), 1e-9)
    light = (view[:3, :3] @ sun).astype(np.float32)
    sun_col = np.asarray(SUN_COLOR, np.float32)

    pix_all, rank_all, rgb_all = [], [], []
    rank = np.arange(len(idx))
    for dy in range(-MAX_FOOTPRINT, MAX_FOOTPRINT + 1):
        for dx in range(-MAX_FOOTPRINT, MAX_FOOTPRINT + 1):
            d = np.float32(math.sqrt(dx * dx + dy * dy))
            sel = d <= rad
            x = (cx[sel] + np.float32(dx)).astype(np.int32)
            y = (cy[sel] + np.float32(dy)).astype(np.int32)
            inb = (x >= 0) & (x < width) & (y >= 0) & (y < height)
            if not inb.any():
                continue
            r = rad[sel][inb]
            nr = np.minimum(d / np.maximum(r, np.float32(0.5)),
                            np.float32(0.97))
            nz = np.sqrt(np.float32(1.0) - nr * nr)
            dd = max(d, np.float32(1e-6))
            diff = np.maximum((np.float32(dx) / dd) * nr * light[0]
                              + (np.float32(-dy) / dd) * nr * light[1]
                              + nz * light[2], np.float32(0.0))
            shade = np.float32(0.35) + np.float32(0.65) * diff
            spec = np.power(diff, np.float32(24.0)) * np.float32(0.4)
            rgb = np.clip(col[sel][inb] * shade[:, None]
                          + sun_col * spec[:, None], 0.0, 1.0)
            pix_all.append(y[inb].astype(np.int64) * width + x[inb])
            rank_all.append(rank[sel][inb])
            rgb_all.append(rgb.astype(np.float32))

    img = np.empty((height * width, 3), np.float32)
    img[:] = np.asarray(BACKGROUND, np.float32)
    if pix_all:
        pix = np.concatenate(pix_all)
        rk = np.concatenate(rank_all)
        rgb = np.concatenate(rgb_all)
        key = np.argsort(pix * (len(idx) + 1) + rk, kind="stable")
        pix, rgb = pix[key], rgb[key]
        last = np.r_[pix[1:] != pix[:-1], True]     # the latest writer
        img[pix[last]] = rgb[last]
    img = img.reshape(height, width, 3)
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB PNG without interlace whose rows all have filter 0, as
    [H, W, 3] uint8; raise for any other PNG or a bad checksum."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    at, header, idat = 8, None, []
    while at < len(data):
        (size,) = struct.unpack(">I", data[at:at + 4])
        tag, body = data[at + 4:at + 8], data[at + 8:at + 8 + size]
        (crc,) = struct.unpack(">I", data[at + 8 + size:at + 12 + size])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        at += 12 + size
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGB PNG (IHDR {header})")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()
