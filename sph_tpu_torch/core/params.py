"""Simulation parameter structures (counterpart of ``sph_tpu/core/params.py``).

``FluidParams`` holds the reference solver's live-tunable ``param_*``
fields (reference ``SPHFluid3D.h:94-189``) as a dataclass of tensors on
one device, so a slider edit is a tensor write and never a host round
trip.  ``shape_type`` is the one host ``int``: it picks code (which
container projector runs), not data, and eager PyTorch dispatches on it
in Python where the JAX package needed a traced ``lax.switch``.

``SimConfig`` holds the static facts of a run: particle count, grid dims
and mode flags.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from sph_tpu_torch.core.device import constant, resolve

# Shape type ids — reference SPHFluid3D.h:117-118
SHAPE_BOX = 0
SHAPE_SPHERE = 1
SHAPE_CYLINDER = 2
SHAPE_TORUS = 3
SHAPE_CAPSULE = 4
SHAPE_HOURGLASS = 5
SHAPE_EGG = 6
SHAPE_STAR = 7
SHAPE_SUPERELLIPSOID = 8
SHAPE_TREFOIL = 9
NUM_SHAPES = 10

SHAPE_NAMES = (
    "box", "sphere", "cylinder", "torus", "capsule",
    "hourglass", "egg", "star", "superellipsoid", "trefoil",
)

_DEFAULTS = dict(
    h=0.28,
    mass=1000.0 * (0.28 * 0.85) ** 3,
    rest_density=1000.0,
    gas_constant=2000.0,
    viscosity=3.5,
    gravity=(0.0, -980.0, 0.0),
    surface_tension=0.0728,
    dt=1e-3,
    foam_gen=1.0,
    foam_vel_ref=8.0,
    box_center=(0.0, 0.0, 0.0),
    box_half=(7.0, 7.0, 7.0),
    box_euler_deg=(0.0, 0.0, 0.0),
    shape_aux=(5.0, 0.35, 2.5),
    wall_restitution=0.15,
    wall_friction=0.02,
    ghost_face_active=(1, 1, 1, 1, 1, 1),
    fountain_offset=(0.0, -5.0, 0.0),
    fountain_radius=1.0,
    fountain_spread=0.25,
    fountain_jet_speed=25.0,
    fountain_drain_level=1.0,
    fountain_drain_per_sec=2.0,
    river_emitter_pos=(0.0, 3.0, -9.0),
    river_emitter_vel=(0.0, -0.5, 4.0),
    river_emitter_radius=1.5,
    river_sink_y=-8.5,
    river_sink_z_max=9.0,
    river_amp=2.0,
    river_freq=0.25,
    river_phase=0.0,
    river_channel_width=3.0,
    river_flow_gravity=80.0,
    terrain_min=(-7.0, -10.0),
    terrain_size=(14.0, 20.0),
    terrain_restitution=0.02,
    terrain_friction=0.05,
)


@dataclasses.dataclass(frozen=True)
class FluidParams:
    """Live-tunable physics + container parameters.

    Every field but ``shape_type`` is a float32 tensor (``ghost_face_active``
    int32) on one device.  Defaults mirror reference ``SPHFluid3D.h:94-123``;
    ``mass`` is derived at spawn as ``rest_density * (0.85 h)^3``
    (reference ``SPHFluid3D.cpp:92``).
    """

    h: torch.Tensor
    mass: torch.Tensor
    rest_density: torch.Tensor
    gas_constant: torch.Tensor
    viscosity: torch.Tensor
    gravity: torch.Tensor            # [3]
    surface_tension: torch.Tensor
    dt: torch.Tensor                 # default substep timestep
    foam_gen: torch.Tensor
    foam_vel_ref: torch.Tensor

    # Container (OBB / analytic shape)
    box_center: torch.Tensor         # [3]
    box_half: torch.Tensor           # [3]
    box_euler_deg: torch.Tensor      # [3] XYZ euler degrees
    shape_type: int                  # 0..9, host int (picks the projector)
    shape_aux: torch.Tensor          # [3]
    wall_restitution: torch.Tensor
    wall_friction: torch.Tensor

    ghost_face_active: torch.Tensor  # [6] int32, -X,+X,-Y,+Y,-Z,+Z

    fountain_offset: torch.Tensor    # [3]
    fountain_radius: torch.Tensor
    fountain_spread: torch.Tensor
    fountain_jet_speed: torch.Tensor
    fountain_drain_level: torch.Tensor
    fountain_drain_per_sec: torch.Tensor

    river_emitter_pos: torch.Tensor  # [3]
    river_emitter_vel: torch.Tensor  # [3]
    river_emitter_radius: torch.Tensor
    river_sink_y: torch.Tensor
    river_sink_z_max: torch.Tensor
    river_amp: torch.Tensor
    river_freq: torch.Tensor
    river_phase: torch.Tensor
    river_channel_width: torch.Tensor
    river_flow_gravity: torch.Tensor
    terrain_min: torch.Tensor        # [2] (x, z)
    terrain_size: torch.Tensor       # [2] (x, z)
    terrain_restitution: torch.Tensor
    terrain_friction: torch.Tensor

    @classmethod
    def default(cls, device=None, **overrides) -> "FluidParams":
        """The defaults with ``overrides``, on ``device``: the CUDA card
        unless the caller names another (``core.device.resolve``)."""
        device = resolve(device)
        vals = dict(_DEFAULTS)
        shape_type = int(overrides.pop("shape_type", SHAPE_BOX))
        for k, v in overrides.items():
            if k not in vals:
                raise KeyError(f"unknown FluidParams field: {k}")
            vals[k] = v
        out = {}
        for k, v in vals.items():
            proto = np.asarray(_DEFAULTS[k])
            dtype = torch.int32 if proto.dtype.kind == "i" else torch.float32
            arr = np.asarray(v, dtype=np.float32 if dtype == torch.float32
                             else np.int32).reshape(proto.shape)
            out[k] = torch.as_tensor(arr, device=device)
        return cls(shape_type=shape_type, **out)

    def derive_mass(self) -> "FluidParams":
        """mass = rest_density * spacing^3, spacing = 0.85 h (SPHFluid3D.cpp:89-92)."""
        spacing = 0.85 * self.h
        return self.replace(mass=self.rest_density * spacing**3)

    def replace(self, **kw) -> "FluidParams":
        return dataclasses.replace(self, **kw)


def rotation_matrix(euler_deg: torch.Tensor) -> torch.Tensor:
    """World-from-box rotation, R = Rz @ Ry @ Rx of the XYZ euler angles.

    Matches the reference's column-major composition
    (``SPHFluid3D.cpp:13-30``): world = R @ local.
    """
    rad = euler_deg * (math.pi / 180.0)
    c, s = torch.cos(rad), torch.sin(rad)
    one, zero = torch.ones_like(rad[0]), torch.zeros_like(rad[0])
    rx = torch.stack([
        torch.stack([one, zero, zero]),
        torch.stack([zero, c[0], -s[0]]),
        torch.stack([zero, s[0], c[0]]),
    ])
    ry = torch.stack([
        torch.stack([c[1], zero, s[1]]),
        torch.stack([zero, one, zero]),
        torch.stack([-s[1], zero, c[1]]),
    ])
    rz = torch.stack([
        torch.stack([c[2], -s[2], zero]),
        torch.stack([s[2], c[2], zero]),
        torch.stack([zero, zero, one]),
    ])
    return rz @ ry @ rx


def effective_half(params: FluidParams) -> torch.Tensor:
    """Per-shape container half extents seen by the grid and the impulses
    (``SPHFluid3D.h:125-141``).  ``shape_type`` is a host int, so a Python
    branch picks the shape where the JAX package switches on a traced id."""
    bh = params.box_half
    st = min(max(params.shape_type, 0), NUM_SHAPES - 1)
    if st == SHAPE_SPHERE:
        return torch.stack([bh[0], bh[0], bh[0]])
    if st in (SHAPE_CYLINDER, SHAPE_HOURGLASS, SHAPE_EGG, SHAPE_STAR,
              SHAPE_SUPERELLIPSOID):
        return torch.stack([bh[0], bh[1], bh[0]])
    if st == SHAPE_TORUS:
        return torch.stack([bh[0] + bh[1], bh[1], bh[0] + bh[1]])
    if st == SHAPE_CAPSULE:
        return torch.stack([bh[0], bh[1] + bh[0], bh[0]])
    if st == SHAPE_TREFOIL:
        return torch.stack([3.0 * bh[0] + bh[1], 0.35 * bh[0] + bh[1],
                            3.0 * bh[0] + bh[1]])
    return bh


def effective_half_np(shape_type: int, box_half: np.ndarray) -> np.ndarray:
    """Host-side (numpy) EffectiveHalf, for spawn and static grid sizing."""
    bh = np.asarray(box_half, dtype=np.float32)
    if shape_type == SHAPE_SPHERE:
        return np.array([bh[0], bh[0], bh[0]], np.float32)
    if shape_type in (SHAPE_CYLINDER, SHAPE_HOURGLASS, SHAPE_EGG,
                      SHAPE_STAR, SHAPE_SUPERELLIPSOID):
        return np.array([bh[0], bh[1], bh[0]], np.float32)
    if shape_type == SHAPE_TORUS:
        return np.array([bh[0] + bh[1], bh[1], bh[0] + bh[1]], np.float32)
    if shape_type == SHAPE_CAPSULE:
        return np.array([bh[0], bh[1] + bh[0], bh[0]], np.float32)
    if shape_type == SHAPE_TREFOIL:
        return np.array([
            3.0 * bh[0] + bh[1],
            0.35 * bh[0] + bh[1],
            3.0 * bh[0] + bh[1],
        ], np.float32)
    return bh.copy()


def rotation_matrix_np(euler_deg) -> np.ndarray:
    rad = np.asarray(euler_deg, np.float64) * (np.pi / 180.0)
    cx, sx = np.cos(rad[0]), np.sin(rad[0])
    cy, sy = np.cos(rad[1]), np.sin(rad[1])
    cz, sz = np.cos(rad[2]), np.sin(rad[2])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (rz @ ry @ rx).astype(np.float32)


GRID_DIM_CAP = 160  # per-axis cell cap, reference SPHFluid3D.cpp:298


def compute_grid_dims(shape_type: int, box_half, box_euler_deg, h: float,
                      round_to: int = 8,
                      cap: int = GRID_DIM_CAP) -> Tuple[int, int, int]:
    """Static grid dims: ``dim = ceil(2 (half + h) / h)`` per axis, clamped
    to [1, cap] and rounded up to a multiple of ``round_to``.

    Binning happens in the container-local frame (``grid_cell_coords``),
    so the rotation does not enter; the reference bins over the rotated
    world AABB instead (``SPHFluid3D.cpp:282-304``)."""
    del box_euler_deg
    half = effective_half_np(shape_type, np.asarray(box_half, np.float32))
    ext = half + h
    dims = []
    for e in ext:
        d = int(np.ceil((2.0 * e) / h))
        d = min(cap, max(1, d))
        d = min(cap, ((d + round_to - 1) // round_to) * round_to)
        dims.append(d)
    return tuple(dims)


def grid_min(params: FluidParams) -> torch.Tensor:
    """Container-local grid origin (positions are rotated into the
    container frame before binning; see ``grid_cell_coords``)."""
    return -(effective_half(params) + params.h)


def grid_cell_coords(pos: torch.Tensor, params: FluidParams,
                     dims) -> torch.Tensor:
    """[N,3] world positions -> [N,3] int32 cell coords, clipped.

    Bins in the container-local frame ``local = R^T (p - c)``; any spatial
    partition gives the same physics, only pair distances matter."""
    rot = rotation_matrix(params.box_euler_deg)
    local = (pos - params.box_center[None, :]) @ rot     # rows: R^T d
    gmin = grid_min(params)
    c = torch.floor((local - gmin[None, :]) / params.h).to(torch.int32)
    hi = constant(tuple(int(d) - 1 for d in dims), torch.int32, pos.device)
    return torch.minimum(c.clamp_min(0), hi[None, :])


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static configuration of a run (the reference's allocation-time
    decisions, ``SPHFluid3D.cpp:306-343,439-447``).

    The cell engine keeps no per-cell capacity, so the JAX package's
    ``cell_capacity`` and its TPU table-layout knobs have no counterpart.
    """

    n: int                                 # padded particle capacity
    grid_dims: Tuple[int, int, int]        # (nx, ny, nz) static cell dims
    # 'brute' (the all-pairs oracle) | 'cell' (the cell engine's
    # kernels) | 'brute_kernel' (the all-pairs kernels, dam_break_8k)
    neighbor_impl: str = "cell"
    river_mode: bool = False
    fountain_mode: bool = False
    stencil_capacity: int = 0              # >0 enables Liquid Logo targets
    terrain_res: Tuple[int, int] = (64, 64)
    max_substeps: int = 16                 # per-frame cap, Scene0p.h:48
    # the cell engine's force sweep also packs its outputs and rho into
    # one [N, 16] row buffer that the substep reads them from (the
    # counterpart of the JAX package's emitted-row transport, bit-identical
    # to the default)
    emit_rows: bool = False

    @property
    def num_cells(self) -> int:
        nx, ny, nz = self.grid_dims
        return nx * ny * nz
