"""Container constraint (counterpart of ``sph_tpu/physics/constraints.py``,
box only).

Ports the box case of ``shaders/OBBConstraints.comp``: a particle outside
the box is projected onto it in container-local space, and its velocity
reflects with restitution and friction.  The JAX package also keeps a
component-wise "plane form" of the same math for its TPU table layout;
one form is enough here.
"""
from __future__ import annotations

import torch

from sph_tpu_torch.core import params as P
from sph_tpu_torch.core.params import FluidParams, rotation_matrix
from sph_tpu_torch.core.state import ParticleState


def _safe_unit(v: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return v / torch.clamp_min(n, 1e-12)


def _project_box(p: torch.Tensor, half: torch.Tensor):
    """p [N,3] local coords -> (q [N,3], n [N,3], hit [N] bool)."""
    q = torch.maximum(torch.minimum(p, half), -half)
    delta = p - q
    ad = torch.abs(delta)
    hit = torch.any(ad > 0.0, dim=-1)
    # Normal along the most violated axis (OBBConstraints.comp:207-212);
    # argmax returns the first maximum, as jnp.argmax does
    axis = torch.argmax(ad, dim=-1, keepdim=True)
    n = torch.zeros_like(p).scatter_(
        -1, axis, torch.sign(torch.gather(delta, -1, axis)))
    return q, n, hit


def apply_container(state: ParticleState, params: FluidParams) -> ParticleState:
    """OBB containment with restitution + friction.

    Mirrors ``OBBConstraints.comp:41-237``: world -> local via R^T (p - c),
    project, normal back to world, reflect ``vn' = -e vn``,
    ``vt' = (1 - mu) vt``. Ghost particles are skipped.
    """
    if params.shape_type != P.SHAPE_BOX:
        raise NotImplementedError(
            f"shape_type {params.shape_type} "
            f"({P.SHAPE_NAMES[params.shape_type]}): only the box container "
            "is ported; see ROADMAP queue 1, 'The other 9 container "
            "shapes'")
    rot = rotation_matrix(params.box_euler_deg)          # world_from_box
    rel = state.pos - params.box_center[None, :]
    p_local = rel @ rot                                  # R^T p per row
    q_local, n_local, hit = _project_box(p_local, params.box_half)

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
