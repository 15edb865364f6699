"""Screen-space fluid rendering (SSFR, counterpart of
``sph_tpu/viz/ssfr.py``) — the reference's 5-pass water surface
(``shaders/fluidDepth.*``, ``depthSmooth.frag``, ``fluidThickness.frag``,
``skyGradient.frag``, ``fluidComposite.frag``; pass plumbing
``Scene0p.cpp:2708-2940``) rebuilt as headless image math.

Pass structure:

1. **splat** (host): the state's position, foam, valid and ghost columns
   are copied to the host in one transfer; a numpy projection and a stable
   painter sort, then the host rasterizer's ``ssfr_splat``
   (``native/splat_raster.cpp``) writes per-pixel nearest view-Z and adds
   Gaussian thickness + foam.  :func:`splat_depth_thickness_plain` is its
   plain version, the same float32 operations in the same order.
2. **smooth** (torch, the image's device): separable narrow-range
   bilateral depth filter (Truong-style): world-size kernel projected to
   pixels, samples nearer than ``center + band`` skipped, farther samples
   clamped into the band (``depthSmooth.frag:19-45``), ping-pong N
   iterations.  The taps wrap around the image's edges (``torch.roll``, as
   the JAX package's ``jnp.roll``) and are summed in the JAX package's
   order, ``-MAX_HALF_K`` to ``MAX_HALF_K``.
3. **sky** (torch): procedural horizon/zenith gradient + sun glow
   (``skyGradient.frag``) for the background and reflections.
4. **composite** (torch): view-pos reconstruction, min-|dz| depth-aware
   normals, Schlick Fresnel, Blinn-Phong sun specular, refraction UV
   offset, Beer-Lambert absorption, sky reflection, foam whitening,
   ACES tonemap + gamma + HSV grade (``fluidComposite.frag:60-174``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from sph_tpu_torch.native import build
from sph_tpu_torch.viz import palettes as P
from sph_tpu_torch.viz.camera import OrbitCamera

MAX_HALF_K = 32
SPLAT_FOOTPRINT = 3          # pixels, ssfr_splat's (native/splat_raster.cpp)


@dataclasses.dataclass(frozen=True)
class WaterParams:
    """SSFR look parameters (``Scene0p.h:295-312`` defaults)."""
    smooth_iterations: int = 5
    world_filter_scale: float = 6.0
    surface_merge: float = 3.0
    thickness_strength: float = 0.05
    thickness_falloff: float = 4.0
    radius_scale: float = 1.3
    extinction: Tuple[float, float, float] = (0.45, 0.15, 0.05)
    thickness_scale: float = 1.0
    sun_dir: Tuple[float, float, float] = (0.4, 1.0, 0.5)
    sun_color: Tuple[float, float, float] = (1.0, 0.97, 0.9)
    deep_color: Tuple[float, float, float] = (0.02, 0.08, 0.25)
    specular_power: float = 256.0
    specular_strength: float = 0.8
    refraction_strength: float = 0.04
    fresnel_bias: float = 0.02
    env_reflect: Tuple[float, float, float] = (0.90, 0.95, 1.00)
    sky_horizon: Tuple[float, float, float] = (0.40, 0.55, 0.65)
    sky_zenith: Tuple[float, float, float] = (0.15, 0.28, 0.50)
    foam_amount: float = 1.5
    exposure: float = 1.0
    sky_on: bool = False
    bg_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)


def _splats(pos, foam, view, proj, width, height, particle_radius,
            mask=None):
    """Pass 1's inputs, painter-sorted (far first): the splats' centers,
    view z, radii in pixels and foam; None when no splat lands.
    ``sph_tpu/viz/ssfr.py:65-102``."""
    pos = np.asarray(pos, np.float32)
    foam = np.asarray(foam, np.float32)
    vp = pos @ np.asarray(view[:3, :3]).T + np.asarray(view[:3, 3])
    w = -vp[:, 2]
    ok = w > 1e-6
    if mask is not None:
        ok &= np.asarray(mask)
    clip_x = vp[:, 0] * proj[0, 0]
    clip_y = vp[:, 1] * proj[1, 1]
    sw = np.maximum(w, 1e-6)
    px = (clip_x / sw * 0.5 + 0.5) * width
    py = (1.0 - (clip_y / sw * 0.5 + 0.5)) * height
    ok &= (px >= 0) & (px < width) & (py >= 0) & (py < height)

    idx = np.nonzero(ok)[0]
    if len(idx) == 0:
        return None
    # splat radius in pixels (particleImpostor.vert:38-40)
    rad_px = np.clip(particle_radius * proj[1, 1] / sw[idx] * height * 0.5,
                     0.6, 6.0)
    # painter order: far first so near depth wins the final assignment
    order = np.argsort(vp[idx, 2], kind="stable")
    return [np.ascontiguousarray(a[order], np.float32)
            for a in (px[idx], py[idx], vp[idx, 2], rad_px, foam[idx])]


def splat_depth_thickness(pos, foam, view, proj, width, height,
                          particle_radius, mask=None):
    """Pass 1 on the host with ``ssfr_splat``: -> (depth [H,W] view-z,
    thickness [H,W], foam [H,W]) as float32 numpy arrays.  depth == 0
    means background (the reference's clear value, ``fluidDepth.frag``)."""
    depth, thick, foam_img = (np.zeros(height * width, np.float32)
                              for _ in range(3))
    splats = _splats(pos, foam, view, proj, width, height, particle_radius,
                     mask)
    if splats is not None:
        cx, cy, vz, rad_px, fo = splats
        build.splat_library().ssfr_splat(
            len(cx), cx.ctypes.data, cy.ctypes.data, vz.ctypes.data,
            rad_px.ctypes.data, fo.ctypes.data, float(particle_radius),
            width, height, depth.ctypes.data, thick.ctypes.data,
            foam_img.ctypes.data)
    return tuple(a.reshape(height, width) for a in (depth, thick, foam_img))


def splat_depth_thickness_plain(pos, foam, view, proj, width, height,
                                particle_radius, mask=None):
    """:func:`splat_depth_thickness` in numpy, ``ssfr_splat``'s plain
    version: every (particle, offset) pair in the rasterizer's order
    (particles far to near, offsets row by row), the depths assigned with
    the last write winning and the blobs added in that order
    (``np.add.at``), each value by the rasterizer's float32 operations
    (the exponential through float64, rounded once, as glibc's expf)."""
    f32 = np.float32
    depth, thick, foam_img = (np.zeros(height * width, np.float32)
                              for _ in range(3))
    splats = _splats(pos, foam, view, proj, width, height, particle_radius,
                     mask)
    if splats is not None:
        cx, cy, vz, rad_px, fo = splats
        r = SPLAT_FOOTPRINT
        dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
        dx = dx.reshape(-1).astype(np.float32)
        dy = dy.reshape(-1).astype(np.float32)
        d2 = dx * dx + dy * dy                           # exact in float32
        r2 = rad_px * rad_px
        x = (cx[:, None] + dx[None, :]).astype(np.int32)
        y = (cy[:, None] + dy[None, :]).astype(np.int32)
        keep = ((d2[None, :] <= r2[:, None]) & (x >= 0) & (x < width)
                & (y >= 0) & (y < height))
        n_idx, k_idx = np.nonzero(keep)                 # particle-major
        p = y[n_idx, k_idx].astype(np.int64) * width + x[n_idx, k_idx]
        d2k, r2k = d2[k_idx], r2[n_idx]
        s = np.maximum(f32(1.0) - d2k / np.maximum(r2k, f32(0.36)),
                       f32(0.0))
        zval = vz[n_idx] + f32(particle_radius) * np.sqrt(s)
        gden = np.maximum(f32(0.5) * r2k, f32(0.18))
        g = np.exp((-d2k / gden).astype(np.float64)).astype(np.float32)
        last = np.full(height * width, -1, np.int64)
        np.maximum.at(last, p, np.arange(len(p)))
        hit = last >= 0
        depth[hit] = zval[last[hit]]
        np.add.at(thick, p, g)
        np.add.at(foam_img, p, fo[n_idx] * g)
    return tuple(a.reshape(height, width) for a in (depth, thick, foam_img))


def _consts(device, **parts):
    """Small float32 constants on ``device`` in one transfer: each keyword's
    value, flattened, as a view of one tensor (a blocking copy to the card
    waits for its stream, so the passes make one each, not one a
    constant)."""
    arrays = [np.asarray(v, np.float32) for v in parts.values()]
    flat = torch.as_tensor(np.concatenate([a.reshape(-1) for a in arrays]),
                           device=device)
    out, at = {}, 0
    for name, a in zip(parts, arrays):
        out[name] = flat[at:at + a.size].view(a.shape)
        at += a.size
    return out


def _sky_consts(wp: WaterParams) -> dict:
    return dict(horizon=wp.sky_horizon, zenith=wp.sky_zenith,
                sun=wp.sun_dir, sun_color=wp.sun_color)


def smooth_depth(depth: torch.Tensor, iterations: int, particle_radius,
                 proj_scale_y, wp: WaterParams) -> torch.Tensor:
    """Pass 2: separable narrow-range bilateral filter, `iterations`
    ping-pong rounds of horizontal+vertical (depthSmooth.frag)."""
    band = wp.surface_merge * particle_radius
    k = _consts(depth.device,
                scale=wp.world_filter_scale * particle_radius * proj_scale_y,
                taps=[-float(i * i) for i in range(-MAX_HALF_K,
                                                   MAX_HALF_K + 1)])
    scale = k["scale"]

    def one_dir(d, axis):
        center = d
        px_radius = scale / torch.clamp(-center, min=0.001)
        half_kf = torch.clamp(px_radius, 1.0, float(MAX_HALF_K))
        sigma = torch.clamp(half_kf * 0.4, min=1.0)
        two_var = 2.0 * sigma * sigma
        near_bound = center + band
        far_bound = center - band

        ssum = torch.zeros_like(d)
        wsum = torch.zeros_like(d)
        for i in range(-MAX_HALF_K, MAX_HALF_K + 1):
            s = torch.roll(d, -i, dims=axis)
            valid = ((s != 0.0) & (s <= near_bound)
                     & (abs(float(i)) <= half_kf))
            sc = torch.maximum(s, far_bound)
            ws = torch.where(valid,
                             torch.exp(k["taps"][i + MAX_HALF_K] / two_var),
                             0.0)
            ssum = ssum + sc * ws
            wsum = wsum + ws
        out = torch.where(wsum > 1e-6, ssum / torch.clamp(wsum, min=1e-6),
                          center)
        return torch.where(center == 0.0, 0.0, out)

    for _ in range(max(iterations, 0)):
        depth = one_dir(depth, axis=1)
        depth = one_dir(depth, axis=0)
    return depth


def sky_gradient(dirs: torch.Tensor, wp: WaterParams,
                 k: Optional[dict] = None) -> torch.Tensor:
    """Procedural sky along world-space directions [..., 3]
    (skyGradient.frag); ``k`` holds the constants of
    :func:`_sky_consts` on the directions' device, made here if not
    given."""
    if k is None:
        k = _consts(dirs.device, **_sky_consts(wp))
    horizon, zenith = k["horizon"], k["zenith"]
    sun = k["sun"] / torch.linalg.vector_norm(k["sun"])
    t = torch.clamp(dirs[..., 1] * 0.5 + 0.5, 0.0, 1.0) ** 0.7
    col = horizon + (zenith - horizon) * t[..., None]
    s = torch.clamp((dirs * sun).sum(-1), min=0.0)
    return col + k["sun_color"] * (s ** 128.0 * 0.8)[..., None]


def _pixel_uv(width: int, height: int, device):
    u = P.div(torch.arange(width, dtype=torch.float32, device=device) + 0.5,
              width)
    v = 1.0 - P.div(torch.arange(height, dtype=torch.float32, device=device)
                    + 0.5, height)
    return u, v


def render_background(width, height, view, proj, wp: WaterParams,
                      device=None) -> torch.Tensor:
    """Sky background (or flat bg color) in LINEAR space [H,W,3] on
    ``device`` (the card unless the caller names another)."""
    from sph_tpu_torch.core.device import resolve
    device = resolve(device)
    if not wp.sky_on:
        return _consts(device, bg=wp.bg_color)["bg"].expand(height, width, 3)
    k = _consts(device, view3=np.asarray(view)[:3, :3], **_sky_consts(wp))
    u, v = _pixel_uv(width, height, device)
    ndc_x = u * 2.0 - 1.0
    ndc_y = v * 2.0 - 1.0
    ray = torch.stack([
        P.div(ndc_x[None, :], float(proj[0, 0])).expand(height, width),
        P.div(ndc_y[:, None], float(proj[1, 1])).expand(height, width),
        -torch.ones((height, width), dtype=torch.float32, device=device)],
        dim=-1)
    world = ray @ k["view3"]                            # R^T @ ray
    world = world / torch.linalg.vector_norm(world, dim=-1, keepdim=True)
    return sky_gradient(world, wp, k)


def _aces(x):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def finish_color(c, wp: WaterParams, vp: Optional[P.VizParams] = None):
    """HDR -> display: exposure, ACES, gamma, HSV grade
    (fluidComposite.frag:69-80)."""
    c = _aces(c * wp.exposure) ** (1.0 / 2.2)
    if vp is not None:
        c = P.apply_color_adjust(vp, c)
    return c


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-9)


def composite(depth, thick, foam_img, background, view, shape_hw,
              proj00, proj11, wp: WaterParams,
              vp: Optional[P.VizParams] = None) -> torch.Tensor:
    """Pass 5: the full surface shade (fluidComposite.frag:60-174) on the
    images' device.  Returns LINEAR-graded display RGB [H,W,3] in [0,1]."""
    height, width = shape_hw
    dev = depth.device
    k = _consts(dev, view3=np.asarray(view)[:3, :3], up=[0.0, 0.0, 1.0],
                extinction=wp.extinction, deep=wp.deep_color,
                env_reflect=wp.env_reflect, zero=0.0, **_sky_consts(wp))
    u, v = _pixel_uv(width, height, dev)
    uu = u[None, :].expand(height, width)
    vv = v[:, None].expand(height, width)

    def view_pos(uuu, vvv, vz):
        ndc_x = uuu * 2.0 - 1.0
        ndc_y = vvv * 2.0 - 1.0
        return torch.stack([P.div(ndc_x, proj00) * (-vz),
                            P.div(ndc_y, proj11) * (-vz), vz], dim=-1)

    vz = depth
    pos = view_pos(uu, vv, vz)

    # min-|dz| depth-aware normals (fluidComposite.frag:109-131)
    def shifted(dx_, dy_):
        return torch.roll(torch.roll(depth, -dy_, dims=0), -dx_, dims=1)

    px_u = 1.0 / width
    px_v = 1.0 / height
    vz_r = shifted(1, 0)
    vz_l = shifted(-1, 0)
    vz_u = shifted(0, -1)
    vz_d = shifted(0, 1)
    zero = k["zero"]

    d_xf = view_pos(uu + px_u, vv, vz_r) - pos
    d_xb = pos - view_pos(uu - px_u, vv, vz_l)
    use_b_x = (vz_l != 0.0) & ((vz_r == 0.0)
                               | (d_xb[..., 2].abs() < d_xf[..., 2].abs()))
    d_x = torch.where(use_b_x[..., None], d_xb,
                      torch.where((vz_r != 0.0)[..., None], d_xf, zero))

    d_yf = view_pos(uu, vv + px_v, vz_u) - pos
    d_yb = pos - view_pos(uu, vv - px_v, vz_d)
    use_b_y = (vz_d != 0.0) & ((vz_u == 0.0)
                               | (d_yb[..., 2].abs() < d_yf[..., 2].abs()))
    d_y = torch.where(use_b_y[..., None], d_yb,
                      torch.where((vz_u != 0.0)[..., None], d_yf, zero))

    n = torch.linalg.cross(d_x, d_y, dim=-1)
    nlen = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = torch.where(nlen > 1e-5, n / torch.clamp(nlen, min=1e-9), k["up"])
    n = torch.where(n[..., 2:3] < 0.0, -n, n)

    vdir = -pos / torch.clamp(torch.linalg.vector_norm(pos, dim=-1,
                                                       keepdim=True),
                              min=1e-9)

    cos_n = torch.clamp((n * vdir).sum(-1), min=0.0)
    fres = wp.fresnel_bias + (1.0 - wp.fresnel_bias) \
        * (1.0 - cos_n) ** 5.0

    view3 = k["view3"]
    sun_w = k["sun"] / torch.linalg.vector_norm(k["sun"])
    sun_v = view3 @ sun_w
    sun_v = sun_v / torch.clamp(torch.linalg.vector_norm(sun_v), min=1e-9)
    hvec = _unit(sun_v[None, None, :] + vdir)
    spec = torch.clamp((n * hvec).sum(-1), min=0.0) ** wp.specular_power

    # refraction: background sampled at normal-offset UV (gather)
    ru = torch.clamp(uu + n[..., 0] * wp.refraction_strength, 0.001, 0.999)
    rv = torch.clamp(vv + n[..., 1] * wp.refraction_strength, 0.001, 0.999)
    xi = torch.clamp((ru * width).to(torch.int64), 0, width - 1)
    yi = torch.clamp(((1.0 - rv) * height).to(torch.int64), 0, height - 1)
    bg_sample = background[yi, xi]

    thick_s = torch.clamp(thick * wp.thickness_scale
                          * wp.thickness_strength, min=0.0)
    transmit = torch.exp(-k["extinction"] * thick_s[..., None])
    avg_t = torch.clamp(transmit.mean(-1), 0.0, 1.0)
    deep = k["deep"]
    transmitted = deep + (bg_sample * transmit - deep) * avg_t[..., None]

    # environment reflection along the world reflected ray
    refl_v = 2.0 * cos_n[..., None] * n - vdir
    refl_w = refl_v @ view3                     # R^T @ v
    env = sky_gradient(refl_w, wp, k) * k["env_reflect"]

    surface = transmitted + (env - transmitted) * fres[..., None]
    surface = surface + k["sun_color"] \
        * (spec * wp.specular_strength)[..., None]

    foam_f = torch.clamp(1.0 - torch.exp(-foam_img * wp.foam_amount),
                         0.0, 1.0)
    surface = surface + (0.95 - surface) * foam_f[..., None]

    out = torch.where((vz != 0.0)[..., None], surface, background)
    return finish_color(out, wp, vp)


def state_columns(state) -> np.ndarray:
    """The columns the water's splat reads (pos, foam, valid, ghost) as
    one [N, 6] float32 host array: one transfer from the state's device."""
    cols = torch.cat([state.pos, state.foam[:, None],
                      state.valid[:, None].to(torch.float32),
                      state.ghost[:, None].to(torch.float32)], dim=1)
    return cols.cpu().numpy()


def render_water(state, wp: WaterParams, cam: OrbitCamera,
                 width: int = 960, height: int = 540,
                 particle_radius: float = 0.18,
                 vp: Optional[P.VizParams] = None,
                 mask=None) -> np.ndarray:
    """Full SSFR path -> [H,W,3] uint8 (host).  The splat runs on the
    host; the smoothing, the background and the composite on the state's
    device."""
    view = cam.view_matrix()
    proj = cam.proj_matrix(width / height)
    dev = state.pos.device
    cols = state_columns(state)
    draw = (cols[:, 4] > 0) & (cols[:, 5] == 0)
    if mask is not None:
        draw &= np.asarray(mask)
    r = particle_radius * wp.radius_scale
    depth, thick, foam_img = torch.as_tensor(np.stack(splat_depth_thickness(
        cols[:, :3], cols[:, 3], view, proj, width, height, r, mask=draw)),
        device=dev)
    proj_scale_y = float(proj[1, 1]) * height * 0.5
    sm = smooth_depth(depth, wp.smooth_iterations, r, proj_scale_y, wp)
    bg = render_background(width, height, view, proj, wp, device=dev)
    img = composite(sm, thick, foam_img, bg, view, (height, width),
                    float(proj[0, 0]), float(proj[1, 1]), wp, vp)
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
