"""Container, terrain and channel constraints
(counterpart of ``sph_tpu/physics/constraints.py``).

Ports the math of the reference constraint shaders:

- ``shaders/OBBConstraints.comp`` — ten analytic container shapes; a
  particle outside is projected onto the surface in container-local space
  and its velocity reflects with restitution and friction.
- ``shaders/TerrainConstraints.comp`` — heightfield collision with
  bilinear sampling and finite-difference normals (river mode).
- ``shaders/ChannelConstraint.comp`` — tangent-following flow gravity
  along a sinusoidal channel, and its hard lateral walls (river mode).

Each shape projector returns ``(q_local, n_local, hit)``.  ``shape_type``
is a host int, so :func:`project_shape` picks one projector per call in
Python where the JAX package switches on a traced id.  The JAX package
also keeps a component-wise "plane form" of the box for its TPU table
layout; one form is enough here.  Every function is out of place: it
never writes into the tensors of the state it is given.

The container is a CUDA kernel (``csrc/container.cu``) with its plain
torch version beside it (:func:`apply_container_plain`): CPU tensors take
the plain version, CUDA tensors launch the kernel, anything else raises.
The same kernel also reassembles the cell engine's sweep outputs
(``neighbors/sweeps.reassemble``), alone or with the container in one
launch (:func:`container_pass`).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from sph_tpu_torch.core import params as P
from sph_tpu_torch.core.device import constant
from sph_tpu_torch.core.params import FluidParams, rotation_matrix
from sph_tpu_torch.core.state import ParticleState
from sph_tpu_torch.native import build as native

_EPS = 1e-6


def _norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


def _safe_unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(_norm(v, keepdim=True), 1e-12)


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on the device of ``like``, built once there."""
    return constant(tuple(values), torch.float32, like.device)


def _clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _xz_scale(p, y_c, r_max):
    """Scale the xz radius down to ``r_max`` and clamp y to ``y_c``: the
    shared tail of the cylinder-like projectors."""
    lxz = _norm(p[:, ::2])
    scale = torch.where(lxz > r_max, r_max / torch.clamp_min(lxz, _EPS), 1.0)
    q = torch.stack([p[:, 0] * scale, y_c, p[:, 2] * scale], dim=-1)
    delta = p - q
    dl = _norm(delta)
    return q, delta / torch.clamp_min(dl, 1e-12)[:, None], dl > _EPS


# Every projector: p [N,3] local coords -> (q [N,3], n [N,3], hit [N] bool)

def _project_box(p, half, aux):
    q = _clip(p, -half, half)
    delta = p - q
    ad = torch.abs(delta)
    hit = torch.any(ad > 0.0, dim=-1)
    # Normal along the most violated axis (OBBConstraints.comp:207-212);
    # argmax returns the first maximum, as jnp.argmax does
    axis = torch.argmax(ad, dim=-1, keepdim=True)
    n = torch.zeros_like(p).scatter(
        -1, axis, torch.sign(torch.gather(delta, -1, axis)))
    return q, n, hit


def _project_sphere(p, half, aux):
    r = half[0]
    d = _norm(p)
    n = torch.where((d > _EPS)[:, None], p / torch.clamp_min(d, 1e-12)[:, None],
                    _vec([0.0, 1.0, 0.0], p))
    return n * r, n, d > r


def _project_cylinder(p, half, aux):
    r, hh = half[0], half[1]
    y_c = _clip(p[:, 1], -hh, hh)
    return _xz_scale(p, y_c, r)


def _project_torus(p, half, aux):
    R, r = half[0], half[1]
    lxz = _norm(p[:, ::2])
    ring_dir = torch.where((lxz > _EPS)[:, None],
                           p[:, ::2] / torch.clamp_min(lxz, 1e-12)[:, None],
                           _vec([1.0, 0.0], p))
    ring = torch.stack([ring_dir[:, 0] * R, torch.zeros_like(lxz),
                        ring_dir[:, 1] * R], dim=-1)
    d = p - ring
    dl = _norm(d)
    n = d / torch.clamp_min(dl, _EPS)[:, None]
    return ring + n * r, n, dl > r


def _project_capsule(p, half, aux):
    r, hh = half[0], half[1]
    seg = torch.stack([torch.zeros_like(p[:, 0]),
                       _clip(p[:, 1], -hh, hh),
                       torch.zeros_like(p[:, 2])], dim=-1)
    d = p - seg
    dl = _norm(d)
    n = d / torch.clamp_min(dl, _EPS)[:, None]
    return seg + n * r, n, dl > r


def _project_hourglass(p, half, aux):
    base_r, hh = half[0], torch.clamp_min(half[1], 1e-6)
    neck_r = torch.minimum(half[2], base_r)
    y_c = _clip(p[:, 1], -hh, hh)
    r_max = neck_r + (base_r - neck_r) * torch.abs(y_c) / hh
    return _xz_scale(p, y_c, r_max)


def _project_egg(p, half, aux):
    a = torch.clamp_min(half[0], 1e-6)
    b = torch.clamp_min(half[1], 1e-6)
    e = torch.stack([a, b, a])
    u = p / e[None, :]
    d = _norm(u)
    q = (u / torch.clamp_min(d, 1e-12)[:, None]) * e[None, :]
    n = _safe_unit(q / (e * e)[None, :])
    return q, n, d > 1.0


def _project_star(p, half, aux):
    R, hh = half[0], half[1]
    pts = torch.clamp_min(aux[0], 3.0)
    depth = torch.clamp(aux[1], 0.0, 0.9)
    y_c = _clip(p[:, 1], -hh, hh)
    ang = torch.atan2(p[:, 2], p[:, 0])
    r_max = R * (1.0 - depth * (0.5 + 0.5 * torch.cos(pts * ang)))
    return _xz_scale(p, y_c, r_max)


def _project_superellipsoid(p, half, aux):
    a = torch.clamp_min(half[0], 1e-6)
    b = torch.clamp_min(half[1], 1e-6)
    n_exp = torch.clamp(aux[2], 0.6, 8.0)
    e = torch.stack([a, b, a])
    u = torch.abs(p) / e[None, :]
    F = torch.sum(torch.clamp_min(u, 1e-12) ** n_exp, dim=-1)
    # Radial projection is exact: F(k p) = k^n F(p)
    k = torch.clamp_min(F, 1e-12) ** (-1.0 / n_exp)
    q = p * k[:, None]
    g = (torch.sign(p)
         * torch.clamp_min(torch.abs(q) / e[None, :], 1e-6) ** (n_exp - 1.0)
         / e[None, :])
    return q, _safe_unit(g), F > 1.0


_TREFOIL_T = 2.0 * np.pi * np.arange(48, dtype=np.float32) / 48.0
_TREFOIL_BASE = np.stack([
    np.sin(_TREFOIL_T) + 2.0 * np.sin(2.0 * _TREFOIL_T),
    0.35 * (-np.sin(3.0 * _TREFOIL_T)),
    np.cos(_TREFOIL_T) - 2.0 * np.cos(2.0 * _TREFOIL_T),
], axis=-1).astype(np.float32)  # [48,3] unit-scale knot samples
_TREFOIL_ROWS = tuple(map(tuple, _TREFOIL_BASE.tolist()))


def _project_trefoil(p, half, aux):
    """Nearest of 48 knot samples, then the tube around it.  Builds a
    [N, 48, 3] temporary: fine at scene sizes, not at millions of rows."""
    S, r = half[0], half[1]
    curve = S * _vec(_TREFOIL_ROWS, p)                          # [48,3]
    d2 = torch.sum((p[:, None, :] - curve[None, :, :]) ** 2, dim=-1)
    best = curve[torch.argmin(d2, dim=-1)]          # first minimum [N,3]
    d = p - best
    dl = _norm(d)
    n = d / torch.clamp_min(dl, _EPS)[:, None]
    return best + n * r, n, dl > r


_PROJECTORS = (
    _project_box, _project_sphere, _project_cylinder, _project_torus,
    _project_capsule, _project_hourglass, _project_egg, _project_star,
    _project_superellipsoid, _project_trefoil,
)


def project_shape(p_local: torch.Tensor, shape_type: int,
                  box_half: torch.Tensor, shape_aux: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The projector of ``shape_type`` (clamped to the ten shapes)."""
    idx = min(max(int(shape_type), 0), P.NUM_SHAPES - 1)
    return _PROJECTORS[idx](p_local, box_half, shape_aux)


def apply_container(state: ParticleState, params: FluidParams) -> ParticleState:
    """Analytic-shape containment with restitution + friction
    (:func:`apply_container_plain`): on CPU tensors the plain version, on
    CUDA tensors one launch of ``csrc/container.cu`` in its container mode
    (:func:`container_pass`); any other device raises ``ValueError``."""
    if state.pos.device.type == "cpu":
        return apply_container_plain(state, params)
    return container_pass(state, params)


def apply_container_plain(state: ParticleState,
                          params: FluidParams) -> ParticleState:
    """Plain torch version of the container pass.

    Mirrors ``OBBConstraints.comp:41-237``: world -> local via R^T (p - c),
    project, normal back to world, reflect ``vn' = -e vn``,
    ``vt' = (1 - mu) vt``. Ghost particles are skipped.
    """
    rot = rotation_matrix(params.box_euler_deg)          # world_from_box
    rel = state.pos - params.box_center[None, :]
    p_local = rel @ rot                                  # R^T p per row
    q_local, n_local, hit = project_shape(
        p_local, params.shape_type, params.box_half, params.shape_aux)

    n_world = _safe_unit(n_local @ rot.T)
    new_pos = params.box_center[None, :] + q_local @ rot.T
    vn = torch.sum(state.vel * n_world, dim=-1, keepdim=True)
    v_n = vn * n_world
    v_t = state.vel - v_n
    new_vel = -params.wall_restitution * v_n + (1.0 - params.wall_friction) * v_t

    live = (hit & (state.ghost == 0) & (state.valid > 0))[:, None]
    return state.replace(
        pos=torch.where(live, new_pos, state.pos),
        vel=torch.where(live, new_vel, state.vel),
    )


# The FluidParams fields of SphContainerParams (csrc/container.h): field,
# the struct's name, dtype, element count
_PARAM_FIELDS = (
    ("box_center", "center", torch.float32, 3),
    ("box_half", "half", torch.float32, 3),
    ("box_euler_deg", "euler_deg", torch.float32, 3),
    ("shape_aux", "aux", torch.float32, 3),
    ("wall_restitution", "restitution", torch.float32, 1),
    ("wall_friction", "friction", torch.float32, 1),
    ("rest_density", "rest_density", torch.float32, 1),
    ("foam_gen", "foam_gen", torch.float32, 1),
    ("foam_vel_ref", "foam_vel_ref", torch.float32, 1),
    ("ghost_face_active", "face_active", torch.int32, 6),
)


def _params_arg(params: FluidParams, dev: torch.device):
    """The kernel's params: the pointers of the FluidParams tensors, read
    when the kernel runs, and of the trefoil's samples."""
    arg = native.ContainerParamsC()
    for field, name, dtype, numel in _PARAM_FIELDS:
        t = getattr(params, field)
        if t.device != dev or t.dtype != dtype or t.numel() != numel \
                or not t.is_contiguous():
            raise ValueError(f"params.{field}: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected {numel} contiguous "
                             f"{dtype} on {dev}")
        setattr(arg, name, t.data_ptr())
    arg.trefoil = constant(_TREFOIL_ROWS, torch.float32, dev).data_ptr()
    return arg


def container_pass(state: ParticleState, params: FluidParams,
                   sweep: Optional[Tuple[torch.Tensor, ...]] = None,
                   ghosts: bool = False, contain: bool = True
                   ) -> ParticleState:
    """One launch of ``csrc/container.cu`` over the rows of ``state`` (CUDA
    tensors).  With ``sweep`` = ``(rho, pres, npos, nvel, acc)``, the cell
    engine's sweep outputs for these rows, it first reassembles them as
    ``neighbors.sweeps.reassemble_plain`` does (the ghost rows too when
    ``ghosts``); with ``contain`` it applies the container to the rows as
    :func:`apply_container_plain` does.  The columns it writes are new
    tensors; the others are passed through as the plain versions pass
    them.  Raises ``ValueError`` on tensors that are not on one CUDA
    card."""
    dev = state.pos.device
    if dev.type != "cuda":
        raise ValueError(f"the container pass takes CUDA tensors, got {dev}")
    reassemble = sweep is not None
    if not (reassemble or contain):
        raise ValueError("the container pass reassembles, contains or both")
    n = state.n
    rows = native.ContainerRowsC()

    def read(name, t):
        """Check the column ``name`` and point the kernel at it: the int32
        ones contiguous, a float32 one with its row stride (a [n, 3] one
        with the three words of a row together, as the emitted rows')."""
        if name in ("ghost", "valid", "face"):
            native.check_tensor(name, t, torch.int32, (n,), dev)
        else:
            wide = name in ("pos", "vel", "acc", "npos", "nvel", "nacc")
            shape = (n, 3) if wide else (n,)
            if t.device != dev or t.dtype != torch.float32 \
                    or tuple(t.shape) != shape:
                raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on "
                                 f"{t.device}, expected float32 {shape} on "
                                 f"{dev}")
            if wide and n > 0 and t.stride(1) != 1:
                raise ValueError(f"{name}: the three words of a row do not "
                                 f"lie together")
            setattr(rows, f"{name}_stride", t.stride(0))
        setattr(rows, name, t.data_ptr())

    read("ghost", state.ghost)
    read("valid", state.valid)
    out = {}
    if reassemble:
        rho, pres, npos, nvel, acc = sweep
        for name, t in (("foam", state.foam), ("npos", npos),
                        ("nvel", nvel), ("rho", rho)):
            read(name, t)
        # as reassemble_plain passes them through
        out.update(pos=npos, vel=nvel, acc=acc, density=rho, pressure=pres)
        written = ["foam"]
        if ghosts:
            for name, t in (("face", state.face), ("vel", state.vel),
                            ("acc", state.acc), ("density", state.density),
                            ("pressure", state.pressure), ("nacc", acc),
                            ("pres", pres)):
                read(name, t)
            written += ["vel", "acc", "density", "pressure"]
    else:
        read("pos", state.pos)
        read("vel", state.vel)
        written = []
    if contain:
        written += ["pos", "vel"]
    for name in dict.fromkeys(written):
        shape = (n, 3) if name in ("pos", "vel", "acc") else (n,)
        out[name] = torch.empty(shape, dtype=torch.float32, device=dev)
        setattr(rows, f"out_{name}", out[name].data_ptr())
    err = native.library().sph_container(
        ctypes.byref(rows), ctypes.byref(_params_arg(params, dev)), n,
        int(params.shape_type), int(reassemble), int(contain), int(ghosts),
        torch.cuda.current_stream(dev).cuda_stream)
    native.launched("container", err)
    return state.replace(**out)


# ---------------------------------------------------------------------------
# Terrain heightfield (river mode)
# ---------------------------------------------------------------------------

def sample_terrain_height(terrain: torch.Tensor, wx: torch.Tensor,
                          wz: torch.Tensor, tmin: torch.Tensor,
                          tsize: torch.Tensor) -> torch.Tensor:
    """Bilinear heightfield sample; terrain is [H, W] indexed [z, x]
    (``TerrainConstraints.comp:20-33``)."""
    H, W = terrain.shape
    u = torch.clamp((wx - tmin[0]) / tsize[0] * (W - 1), 0.0, W - 2.0)
    v = torch.clamp((wz - tmin[1]) / tsize[1] * (H - 1), 0.0, H - 2.0)
    ix = u.to(torch.int32)               # truncation of a value >= 0
    iz = v.to(torch.int32)
    fx = u - ix
    fz = v - iz
    ix, iz = ix.long(), iz.long()
    h00 = terrain[iz, ix]
    h10 = terrain[iz, ix + 1]
    h01 = terrain[iz + 1, ix]
    h11 = terrain[iz + 1, ix + 1]
    return ((h00 * (1 - fx) + h10 * fx) * (1 - fz)
            + (h01 * (1 - fx) + h11 * fx) * fz)


def terrain_normal(terrain: torch.Tensor, wx, wz, tmin, tsize) -> torch.Tensor:
    """Finite-difference outward normal (``TerrainConstraints.comp:36-44``)."""
    H, W = terrain.shape
    dx = tsize[0] / (W - 1)
    dz = tsize[1] / (H - 1)
    hr = sample_terrain_height(terrain, wx + dx, wz, tmin, tsize)
    hl = sample_terrain_height(terrain, wx - dx, wz, tmin, tsize)
    hf = sample_terrain_height(terrain, wx, wz + dz, tmin, tsize)
    hb = sample_terrain_height(terrain, wx, wz - dz, tmin, tsize)
    n = torch.stack([hl - hr, (2.0 * dx).expand(wx.shape), hb - hf], -1)
    return _safe_unit(n)


def apply_terrain(state: ParticleState, terrain: torch.Tensor,
                  params: FluidParams) -> ParticleState:
    """Heightfield collision (``TerrainConstraints.comp:47-82``)."""
    wx, wy, wz = state.pos[:, 0], state.pos[:, 1], state.pos[:, 2]
    tmin, tsize = params.terrain_min, params.terrain_size
    in_fp = ((wx >= tmin[0]) & (wx <= tmin[0] + tsize[0])
             & (wz >= tmin[1]) & (wz <= tmin[1] + tsize[1]))
    ty = sample_terrain_height(terrain, wx, wz, tmin, tsize)
    below = wy < ty
    live = in_fp & below & (state.ghost == 0) & (state.valid > 0)

    n = terrain_normal(terrain, wx, wz, tmin, tsize)
    new_pos = torch.stack([wx, torch.where(live, ty + 0.001, wy), wz], -1)
    vn = torch.sum(state.vel * n, dim=-1)
    into = vn < 0.0
    v_n = vn[:, None] * n
    v_t = state.vel - v_n
    bounced = (-params.terrain_restitution * v_n
               + (1.0 - params.terrain_friction) * v_t)
    new_vel = torch.where((live & into)[:, None], bounced, state.vel)
    return state.replace(pos=torch.where(live[:, None], new_pos, state.pos),
                         vel=new_vel)


def apply_channel(state: ParticleState, params: FluidParams,
                  dt) -> ParticleState:
    """Sinusoidal channel flow + lateral walls (``ChannelConstraint.comp``)."""
    wz = state.pos[:, 2]
    cx = (params.box_center[0]
          + params.river_amp * torch.sin(params.river_freq * wz
                                         + params.river_phase))
    dx = state.pos[:, 0] - cx

    # Tangent-following flow gravity
    tdx = params.river_amp * params.river_freq * torch.cos(
        params.river_freq * wz + params.river_phase)
    tlen = torch.sqrt(tdx * tdx + 1.0)
    live = (state.ghost == 0) & (state.valid > 0)
    g = params.river_flow_gravity * dt
    vx = state.vel[:, 0] + torch.where(live, tdx / tlen * g, 0.0)
    vz = state.vel[:, 2] + torch.where(live, 1.0 / tlen * g, 0.0)

    # Hard lateral wall at the channel half-width
    outside = live & (torch.abs(dx) > params.river_channel_width)
    wall_x = cx + torch.sign(dx) * params.river_channel_width
    px = torch.where(outside, wall_x, state.pos[:, 0])
    moving_out = dx * vx > 0.0
    vx = torch.where(outside & moving_out, 0.0, vx)
    return state.replace(
        pos=torch.stack([px, state.pos[:, 1], state.pos[:, 2]], -1),
        vel=torch.stack([vx, state.vel[:, 1], vz], -1))
