"""Post-processing chain (counterpart of ``sph_tpu/viz/postfx.py``) —
image-space rebuild of the reference's post stack (``shaders/post*.frag``;
plumbing ``Scene0p.cpp:2593-2706``):

DOF -> trails -> bloom -> final grade (kaleidoscope, chromatic
aberration, anamorphic streaks, vignette, deterministic film grain).

Every pass is torch ops over [H, W, 3] float32 images in [0, 1] on the
image's device; trail history threads through ``PostState``.  The bloom's
Gaussian wraps around the image's edges (``torch.roll``, as the JAX
package's ``jnp.roll``).  Grain and trail decay use the deterministic post
clock, not wall time — the reference's reel-reproducibility contract
(``Scene0p.cpp:3216-3220``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from sph_tpu_torch.viz.palettes import div


@dataclasses.dataclass(frozen=True)
class PostParams:
    """Post chain knobs (``Scene0p.h:336-344`` defaults)."""
    bloom_strength: float = 0.0
    bloom_threshold: float = 0.6
    bloom_knee: float = 0.25
    trail_half_life: float = 0.0          # seconds; 0 = off
    kaleido_segments: int = 0             # < 2 = off
    kaleido_angle: float = 0.0            # radians
    vignette: float = 0.0
    grain: float = 0.0
    chromatic: float = 0.0
    aperture: float = 0.0                 # 0 = DOF off
    focus_dist: float = 22.0
    streak_strength: float = 0.0
    streak_len_px: float = 160.0
    streak_tint: Tuple[float, float, float] = (0.55, 0.65, 1.0)


@dataclasses.dataclass
class PostState:
    """Cross-frame state: trail history + the deterministic clock."""
    trail: Optional[torch.Tensor] = None
    post_time: float = 0.0


def _hash12(p):
    """2->1 hash matching postFinal.frag:20-24 semantics, each step in the
    JAX package's order (the fractional parts of products, so a reordered
    sum moves the hash)."""
    px = torch.remainder(p[..., 0] * 0.1031, 1.0)
    py = torch.remainder(p[..., 1] * 0.1031, 1.0)
    pz = torch.remainder(p[..., 0] * 0.1031, 1.0)
    d = px * (py + 33.33) + py * (pz + 33.33) + pz * (px + 33.33)
    px, py, pz = px + d, py + d, pz + d
    return torch.remainder((px + py) * pz, 1.0)


def _bilinear(img, u, v):
    """Sample [H,W,3] at continuous uv in [0,1] (v up)."""
    h, w = img.shape[:2]
    x = torch.clamp(u * w - 0.5, 0.0, w - 1.001)
    y = torch.clamp((1.0 - v) * h - 0.5, 0.0, h - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    c00 = img[y0, x0]
    c01 = img[y0, x0 + 1]
    c10 = img[y0 + 1, x0]
    c11 = img[y0 + 1, x0 + 1]
    return ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
            + (c10 * (1 - fx) + c11 * fx) * fy)


def _uv_grid(h, w, device):
    u = div(torch.arange(w, dtype=torch.float32, device=device) + 0.5, w)
    v = 1.0 - div(torch.arange(h, dtype=torch.float32, device=device) + 0.5,
                  h)
    return u[None, :].expand(h, w), v[:, None].expand(h, w)


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32),
                           device=like.device)


# --- DOF (postLens.frag) ------------------------------------------------

_POISSON = np.asarray([
    (-0.326, -0.406), (-0.840, -0.074), (-0.696, 0.457),
    (-0.203, 0.621), (0.962, -0.195), (0.473, -0.480),
    (0.519, 0.767), (0.185, -0.893), (0.507, 0.064),
    (0.896, 0.412), (-0.322, -0.933), (-0.792, -0.598)], np.float32)


def depth_of_field(img, view_z, pp: PostParams):
    """12-tap Poisson gather with CoC from |z - focus| (postLens.frag).
    ``view_z`` is positive view distance per pixel (0 = background)."""
    if pp.aperture <= 0.0:
        return img
    h, w = img.shape[:2]
    coc = (pp.aperture * torch.abs(view_z - pp.focus_dist)
           / torch.clamp(view_z, min=0.1) * (h / 1080.0) * 10.0)
    coc = torch.clamp(coc, 0.0, 14.0)
    u, v = _uv_grid(h, w, img.device)
    acc = img
    for tx, ty in _POISSON:
        du = div(coc, w) * float(tx)
        dv = div(coc, h) * float(ty)
        acc = acc + _bilinear(img, torch.clamp(u + du, 0.0, 1.0),
                              torch.clamp(v + dv, 0.0, 1.0))
    blurred = div(acc, 13.0)
    on = (coc >= 0.5) & (view_z > 0.0)
    return torch.where(on[..., None], blurred, img)


# --- trails (postTrails.frag) ------------------------------------------

def apply_trails(img, trail, decay):
    """max(current, history*decay); returns (display, new_trail)."""
    if trail is None:
        return img, img
    out = torch.maximum(img, trail * decay)
    return out, out


# --- bloom (postBright/postBlur) ---------------------------------------

_GAUSS_W = (0.227027, 0.1945946, 0.1216216, 0.054054, 0.016216)


def _gauss1d(img, axis, step):
    w = [float(np.float32(x)) for x in _GAUSS_W]
    out = img * w[0]
    for i in range(1, 5):
        out = out + torch.roll(img, i * step, dims=axis) * w[i]
        out = out + torch.roll(img, -i * step, dims=axis) * w[i]
    return out


def bloom_brights(img, pp: PostParams, out_height: int):
    """Half-res soft-knee bright pass + 2 rounds of separable 9-tap
    Gaussian, radius scaled by output height (Scene0p.cpp:2647-2676).
    Returns a half-res blurred bright image."""
    half = img[::2, ::2]
    lum = (half * _vec([0.2126, 0.7152, 0.0722], img)).sum(-1)
    t0 = pp.bloom_threshold
    t1 = t0 + max(pp.bloom_knee, 1e-4)
    s = torch.clamp(div(lum - t0, t1 - t0), 0.0, 1.0)
    s = s * s * (3.0 - 2.0 * s)
    brights = half * s[..., None]
    step = max(1, int(round(out_height / 1080.0)))
    for _ in range(2):
        brights = _gauss1d(brights, 1, step)
        brights = _gauss1d(brights, 0, step)
    return brights


def _upsample2(img, h, w):
    up = img.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    return up[:h, :w]


# --- final grade (postFinal.frag) --------------------------------------

def final_grade(img, bloom_half, pp: PostParams, post_time: float):
    h, w = img.shape[:2]
    u, v = _uv_grid(h, w, img.device)

    # kaleidoscope mirror-fold (postFinal.frag:28-39)
    if pp.kaleido_segments >= 2:
        aspect = w / max(h, 1)
        cx = (u - 0.5) * aspect
        cy = v - 0.5
        r = torch.sqrt(cx * cx + cy * cy)
        a = torch.atan2(cy, cx) + pp.kaleido_angle
        seg = math.pi / pp.kaleido_segments
        a = torch.remainder(a, 2.0 * seg)
        a = torch.where(a > seg, 2.0 * seg - a, a)
        a = a - pp.kaleido_angle
        ku = torch.clamp(div(torch.cos(a) * r, aspect) + 0.5, 0.0, 1.0)
        kv = torch.clamp(torch.sin(a) * r + 0.5, 0.0, 1.0)
    else:
        ku, kv = u, v

    # no UV-warp effects: skip the resample entirely (exact passthrough)
    if pp.kaleido_segments < 2 and pp.chromatic <= 0.0:
        col = img
    # chromatic aberration (postFinal.frag:42-49)
    elif pp.chromatic > 0.0:
        du = (ku - 0.5) * pp.chromatic * 0.01
        dv = (kv - 0.5) * pp.chromatic * 0.01
        col = torch.stack([
            _bilinear(img, torch.clamp(ku + du, 0, 1),
                      torch.clamp(kv + dv, 0, 1))[..., 0],
            _bilinear(img, ku, kv)[..., 1],
            _bilinear(img, torch.clamp(ku - du, 0, 1),
                      torch.clamp(kv - dv, 0, 1))[..., 2]], dim=-1)
    else:
        col = _bilinear(img, ku, kv)

    if bloom_half is not None and pp.bloom_strength > 0.0:
        bloom_up = _upsample2(bloom_half, h, w)
        col = col + _bilinear(bloom_up, ku, kv) * pp.bloom_strength

        # anamorphic streaks from the blurred brights (postFinal.frag:55-65)
        if pp.streak_strength > 0.0:
            streak = torch.zeros_like(col)
            step_u = pp.streak_len_px / (8.0 * w)
            for i in range(1, 9):
                wgt = (1.0 - i / 9.0) ** 2
                streak = streak + (
                    _bilinear(bloom_up, torch.clamp(ku + step_u * i, 0, 1),
                              kv)
                    + _bilinear(bloom_up, torch.clamp(ku - step_u * i, 0, 1),
                                kv)) * wgt
            col = col + streak * (pp.streak_strength * 0.12) \
                * _vec(pp.streak_tint, img)

    if pp.vignette > 0.0:
        vx = u - 0.5
        vy = (1.0 - v) - 0.5
        d2 = (vx * vx + vy * vy) * 2.0
        s = torch.clamp(div(d2 - 0.25, 0.5), 0.0, 1.0)
        s = s * s * (3.0 - 2.0 * s)
        col = col * (1.0 - pp.vignette * s)[..., None]

    if pp.grain > 0.0:
        seed = (post_time * 0.7919) % 1.0
        g = _hash12(torch.stack([u * w + seed * 1024.0,
                                 (1.0 - v) * h + seed * 1024.0], -1))
        col = col + (g - 0.5)[..., None] * pp.grain

    return torch.clamp(col, 0.0, 1.0)


# --- full chain --------------------------------------------------------

def run_post_chain(img: torch.Tensor, pp: PostParams, state: PostState,
                   frame_dt: float,
                   view_z: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, PostState]:
    """DOF -> trails -> bloom -> final (Scene0p.cpp:2593-2706 order).
    ``img`` float [H,W,3] in [0,1]; returns (graded image, new state)."""
    img = img.to(torch.float32)

    if pp.aperture > 0.0 and view_z is not None:
        img = depth_of_field(img, view_z, pp)

    new_trail = state.trail
    if pp.trail_half_life > 1e-3:
        decay = float(np.exp(-0.6931472 * frame_dt / pp.trail_half_life))
        img, new_trail = apply_trails(
            img, state.trail if state.trail is not None else img, decay)

    bloom_half = None
    if pp.bloom_strength > 0.0 or pp.streak_strength > 0.0:
        bloom_half = bloom_brights(img, pp, img.shape[0])

    out = final_grade(img, bloom_half, pp, state.post_time)
    return out, PostState(trail=new_trail,
                          post_time=state.post_time + frame_dt)


def post_params_from_settings(s) -> PostParams:
    """SceneSettings -> PostParams."""
    return PostParams(
        bloom_strength=s.bloom_strength, bloom_threshold=s.bloom_threshold,
        trail_half_life=s.trail_half_life,
        kaleido_segments=int(s.kaleido_segments),
        kaleido_angle=math.radians(s.kaleido_angle),
        vignette=s.vignette, grain=s.grain, chromatic=s.chromatic,
        aperture=s.lens_aperture, focus_dist=s.lens_focus_dist,
        streak_strength=s.streak_strength)
