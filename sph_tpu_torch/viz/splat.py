"""Headless point-splat renderer (counterpart of ``sph_tpu/viz/splat.py``):
the export path's stand-in for the reference's impostor pass
(``shaders/particleImpostor.vert/frag``), and the instanced-mesh pass
(:func:`render_frame_mesh`, render mode 2).

Frames render by painter's algorithm: particles sort back to front by view
depth, then each one writes its footprint into the image, later particles
over earlier ones.  Point size follows the reference's perspective formula
``2r * P[1][1] / -z * H/2`` (``particleImpostor.vert:38-40``); each splat
is shaded as a fake sphere (disc normal + lit shading) like the impostor
fragment shader.  Ghost and padding rows are never drawn.

The colors (drive -> palette -> grade, ``palettes.particle_colors``) are
computed on the state's device and copied to the host once.  The
projection, the stable sort and the composition run on the host in numpy
and in the host rasterizer ``native/splat_raster.cpp`` (built by
``native/build.py``; a failed build raises), as in the JAX package, so that
the two packages' frames can be held to each other pixel for pixel.
:func:`render_frame_plain` composes with the numpy footprint loop instead,
the rasterizer's plain version, for the tests.

:func:`save_png` writes 8-bit RGB PNG with the standard library;
:func:`read_png` reads it back, and 8-bit grey, RGB and RGBA PNGs with any
row filter, so that the scene's stencil images load without PIL
(:func:`luma` converts to grey as PIL does).
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from sph_tpu_torch.native import build
from sph_tpu_torch.viz import palettes as P
from sph_tpu_torch.viz.camera import OrbitCamera


def _project(pos: np.ndarray, view: np.ndarray, proj: np.ndarray,
             width: int, height: int):
    """World -> (pixel xy, view z, ndc ok mask)."""
    vp = pos @ view[:3, :3].T + view[:3, 3]
    clip = vp @ proj[:3, :3].T + proj[:3, 3]
    w = -vp[:, 2]
    ok = w > 1e-6
    safe_w = np.maximum(w, 1e-6)
    ndc = clip[:, :2] / safe_w[:, None]
    px = (ndc[:, 0] * 0.5 + 0.5) * width
    py = (1.0 - (ndc[:, 1] * 0.5 + 0.5)) * height
    return px, py, vp, ok


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _colors(state, vp: P.VizParams, vpos: np.ndarray) -> np.ndarray:
    """Per-particle colors on the state's device, copied to the host once."""
    dev = state.pos.device
    return _host(P.particle_colors(
        vp, state.pos, torch.as_tensor(vpos.astype(np.float32), device=dev),
        state.vel, state.pressure, state.density, state.color_group))


def _base(background, width: int, height: int, scale: float) -> np.ndarray:
    """The background as an [H, W, 3] float32 image: a pre-rendered
    [H, W, 3] uint8 frame (the terrain pass, ``viz/terrain.py``) as it is,
    or a color tuple times ``scale``."""
    if isinstance(background, np.ndarray):
        return background.astype(np.float32)
    return np.broadcast_to(np.asarray(background, np.float32) * scale,
                           (height, width, 3)).copy()


def _splats(state, vp: P.VizParams, cam: OrbitCamera, width: int,
            height: int, particle_radius: float, background,
            max_footprint: int, mask):
    """Everything the composition needs, painter-sorted (far first): the
    background image [H*W, 3], the splats' centers, radii, colors and view
    depths, and the view-space light; None in place of the splats when
    none is drawn.  ``sph_tpu/viz/splat.py:51-125``."""
    view = cam.view_matrix()
    proj = cam.proj_matrix(width / height)

    pos = _host(state.pos).astype(np.float32)
    valid = _host(state.valid) > 0
    ghost = _host(state.ghost) > 0
    draw = valid & ~ghost            # ghosts discard (impostor frag main)
    if mask is not None:
        draw &= np.asarray(mask)

    px, py, vpos, ok = _project(pos, view, proj, width, height)
    draw &= ok
    draw &= (px > -8) & (px < width + 8) & (py > -8) & (py < height + 8)

    colors = _colors(state, vp, vpos)
    img = _base(background, width, height, 1.0)
    if isinstance(background, np.ndarray):
        img = img / 255.0
    img = img.reshape(-1, 3)

    idx = np.nonzero(draw)[0]
    if len(idx) == 0:
        return img, None

    # painter's sort: far first, near last (ascending -z_view descending)
    depth = -vpos[idx, 2]
    order = np.argsort(-depth, kind="stable")
    idx = idx[order]

    # perspective point size in pixels (particleImpostor.vert:38-40)
    size_px = (2.0 * particle_radius * proj[1, 1]
               / np.maximum(depth[order], 1e-6) * height * 0.5)
    rad_px = np.clip(size_px * 0.5, 0.5, float(max_footprint))

    sun_world = np.asarray(vp.sun_dir, np.float32)
    sun_world /= max(np.linalg.norm(sun_world), 1e-9)
    light = view[:3, :3] @ sun_world
    return img, (px[idx], py[idx], rad_px, colors[idx], light,
                 depth[order])


def _finish(img: np.ndarray, width: int, height: int, zbuf, return_depth):
    img = img.reshape(height, width, 3)
    out = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    if return_depth:
        return out, zbuf.reshape(height, width)
    return out


def render_frame(state, vp: P.VizParams, cam: OrbitCamera,
                 width: int = 960, height: int = 540,
                 particle_radius: float = 0.12,
                 background: Tuple[float, float, float] = (0.03, 0.04, 0.06),
                 max_footprint: int = 4,
                 mask: Optional[np.ndarray] = None,
                 return_depth: bool = False):
    """Render a ParticleState to an [H, W, 3] uint8 frame with the host
    rasterizer (``native/splat_raster.cpp``).

    ``background`` is a color or an [H, W, 3] uint8 frame; ``mask`` [N]
    bool drops rows from the draw.  ``return_depth=True`` also returns the
    [H, W] view-depth buffer (0 = background) for the DOF post pass — the
    reference's scene depth, available in impostor/mesh modes only
    (``Scene0p.cpp:2601-2603``)."""
    img, splats = _splats(state, vp, cam, width, height, particle_radius,
                          background, max_footprint, mask)
    zbuf = np.zeros(height * width, np.float32)
    if splats is None:
        return _finish(img, width, height, zbuf, return_depth)
    cx, cy, rad_px, col, light, pdepth = splats
    lib = build.splat_library()
    args = [np.ascontiguousarray(a, np.float32)
            for a in (cx, cy, rad_px, col, light, vp.sun_color, pdepth)]
    buf = np.ascontiguousarray(img, np.float32)
    ptr = [a.ctypes.data for a in args]
    lib.splat_raster(len(cx), ptr[0], ptr[1], ptr[2], ptr[3], width, height,
                     buf.ctypes.data, 1 if vp.lit_sphere else 0, ptr[4],
                     ptr[5], int(max_footprint),
                     ptr[6] if return_depth else None,
                     zbuf.ctypes.data if return_depth else None)
    return _finish(buf, width, height, zbuf, return_depth)


def render_frame_plain(state, vp: P.VizParams, cam: OrbitCamera,
                       width: int = 960, height: int = 540,
                       particle_radius: float = 0.12,
                       background: Tuple[float, float, float] = (
                           0.03, 0.04, 0.06),
                       max_footprint: int = 4,
                       mask: Optional[np.ndarray] = None,
                       return_depth: bool = False):
    """:func:`render_frame` with the numpy footprint loop in place of the
    host rasterizer (``sph_tpu/viz/splat.py:152-183``): it writes offset
    by offset, so where footprints overlap it may keep another particle's
    color than the rasterizer, which writes particle by particle."""
    img, splats = _splats(state, vp, cam, width, height, particle_radius,
                          background, max_footprint, mask)
    zbuf = np.zeros(height * width, np.float32)
    if splats is None:
        return _finish(img, width, height, zbuf, return_depth)
    cx, cy, rad_px, col, light, pdepth = splats
    r = int(max_footprint)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            d = np.sqrt(dx * dx + dy * dy)
            sel = d <= rad_px
            if not sel.any():
                continue
            x = (cx[sel] + dx).astype(np.int32)
            y = (cy[sel] + dy).astype(np.int32)
            inb = (x >= 0) & (x < width) & (y >= 0) & (y < height)
            if not inb.any():
                continue
            c = col[sel][inb]
            if vp.lit_sphere:
                # fake-sphere disc shading per footprint offset
                nr = np.minimum(d / np.maximum(rad_px[sel][inb], 0.5), 0.97)
                nz = np.sqrt(np.maximum(1.0 - nr * nr, 0.0))
                nx = (dx / max(d, 1e-6)) * nr
                ny = (-dy / max(d, 1e-6)) * nr
                diff = np.maximum(
                    nx * light[0] + ny * light[1] + nz * light[2], 0.0)
                shade = (0.35 + 0.65 * diff)[:, None]
                c = np.clip(c * shade + np.asarray(vp.sun_color)
                            * (np.maximum(diff, 0.0) ** 24.0 * 0.4)[:, None],
                            0.0, 1.0)
            img[y[inb] * width + x[inb]] = c
            zbuf[y[inb] * width + x[inb]] = pdepth[sel][inb]
    return _finish(img, width, height, zbuf, return_depth)


def render_frame_mesh(state, vp: P.VizParams, cam: OrbitCamera,
                      width: int = 960, height: int = 540,
                      particle_radius: float = 0.12,
                      background=(0.03, 0.04, 0.06),
                      mesh_obj: Optional[str] = None,
                      max_instances: int = 262144,
                      return_depth: bool = False):
    """TRUE instanced-mesh render (reference render mode 2,
    ``sph_tpu/viz/splat.py:198-251``): one unit mesh per particle,
    translated + scaled (``defaultVert.glsl:30-35``, ``Mesh.cpp:20-54``),
    z-buffered by the host triangle rasterizer (``viz/raster.py``).

    ``mesh_obj``: path to a wavefront OBJ; default is the built-in
    icosphere (the reference's own meshes/Sphere.obj asset is absent
    from its repo).  Instances beyond ``max_instances`` are dropped
    far-first to bound headless render cost."""
    from sph_tpu_torch.viz import raster as R

    view = cam.view_matrix()
    proj = cam.proj_matrix(width / height)
    pos = _host(state.pos).astype(np.float32)
    draw = (_host(state.valid) > 0) & (_host(state.ghost) == 0)
    px, py, vpos, ok = _project(pos, view, proj, width, height)
    draw &= ok
    draw &= (px > -64) & (px < width + 64) & (py > -64) & (py < height + 64)
    colors = _colors(state, vp, vpos)

    img = _base(background, width, height, 255.0)
    zbuf = np.full((height, width), np.inf, np.float32)

    idx = np.nonzero(draw)[0]
    if len(idx) > max_instances:
        near = np.argsort(-vpos[idx, 2], kind="stable")[-max_instances:]
        idx = idx[near]
    if len(idx):
        mesh = R.load_obj(mesh_obj) if mesh_obj else None
        R.draw_mesh_instances(img, zbuf, pos[idx], particle_radius,
                              colors[idx], view, proj, mesh=mesh,
                              sun_dir=tuple(np.asarray(vp.sun_dir)))
    out = np.clip(img, 0.0, 255.0).astype(np.uint8)
    if return_depth:
        depth = np.where(np.isfinite(zbuf), zbuf, 0.0).astype(np.float32)
        return out, depth
    return out


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_png(img: np.ndarray, path: str) -> None:
    """Write an [H, W, 3] uint8 image as an 8-bit RGB PNG (no interlace,
    filter type 0 on every row)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"save_png takes an [H, W, 3] uint8 image, got "
                         f"{img.dtype} {img.shape}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, 3 * w)],
                         axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


# PNG color type -> channels, for 8-bit images: grey, RGB, grey + alpha,
# RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters (None, Sub, Up, Average, Paeth) on the
    [H, 1 + stride] filtered rows; return the [H, stride] bytes."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, raw = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = raw
        elif kind == 1:
            cur = np.cumsum(raw.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:
            cur = (raw + prev) & 0xFF
        elif kind in (3, 4):
            cur = raw.copy()
            for x in range(0, stride, bpp):
                up = prev[x:x + bpp]
                left = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    ul = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    p = left + up - ul
                    pa, pb, pc = (np.abs(p - left), np.abs(p - up),
                                  np.abs(p - ul))
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, ul))
                cur[x:x + bpp] = (cur[x:x + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit PNG without interlace (grey, RGB, grey + alpha or
    RGBA, any of PNG's five row filters) into a uint8 array: [H, W] for
    grey, [H, W, C] otherwise (C = 2, 3 or 4); raise on any other kind of
    PNG or a bad checksum."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    at, header, idat = len(_PNG_SIGNATURE), None, []
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
    if (header is None or header[2] != 8 or header[3] not in _PNG_CHANNELS
            or header[4:] != (0, 0, 0)):
        raise ValueError(f"{path}: not an 8-bit grey, RGB or RGBA PNG "
                         f"without interlace (IHDR {header})")
    w, h, _, color_type = header[:4]
    ch = _PNG_CHANNELS[color_type]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(h, 1 + ch * w)
    if rows[:, 0].any():
        img = _unfilter(rows, ch)
    else:
        img = rows[:, 1:].copy()
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)


def luma(img: np.ndarray) -> np.ndarray:
    """An image from :func:`read_png` as 8-bit grey, as PIL's
    ``convert("L")`` makes it: grey as it is, the grey channel of grey +
    alpha, and of RGB or RGBA the integer luma
    ``(R*19595 + G*38470 + B*7471 + 0x8000) >> 16``."""
    if img.ndim == 2:
        return img
    if img.shape[2] == 2:
        return img[..., 0].copy()
    rgb = img[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)
