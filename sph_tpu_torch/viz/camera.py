"""Orbit camera + perspective projection (``Scene0p.cpp:544-552,560-591``;
counterpart of ``sph_tpu/viz/camera.py``, copied as it is).

The reference orbits around a target with yaw/pitch/distance and builds
a standard perspective projection.  Host-side numpy; the matrices feed the
host projection of ``viz/splat.py``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class OrbitCamera:
    target: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    yaw_deg: float = 35.0
    pitch_deg: float = 20.0
    distance: float = 30.0
    fov_y_deg: float = 45.0
    z_near: float = 0.1
    z_far: float = 500.0

    def eye(self) -> np.ndarray:
        yaw = math.radians(self.yaw_deg)
        pitch = math.radians(self.pitch_deg)
        d = self.distance
        offset = np.array([
            d * math.cos(pitch) * math.sin(yaw),
            d * math.sin(pitch),
            d * math.cos(pitch) * math.cos(yaw)], np.float32)
        return self.target + offset

    def view_matrix(self) -> np.ndarray:
        """Right-handed look-at (camera looks down -Z in view space)."""
        eye = self.eye()
        f = self.target - eye
        f = f / max(np.linalg.norm(f), 1e-9)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        s = np.cross(f, up)
        if np.linalg.norm(s) < 1e-6:
            up = np.array([0.0, 0.0, 1.0], np.float32)
            s = np.cross(f, up)
        s = s / np.linalg.norm(s)
        u = np.cross(s, f)
        m = np.eye(4, dtype=np.float32)
        m[0, :3] = s
        m[1, :3] = u
        m[2, :3] = -f
        m[:3, 3] = -m[:3, :3] @ eye
        return m

    def proj_matrix(self, aspect: float) -> np.ndarray:
        f = 1.0 / math.tan(math.radians(self.fov_y_deg) * 0.5)
        zn, zf = self.z_near, self.z_far
        m = np.zeros((4, 4), np.float32)
        m[0, 0] = f / aspect
        m[1, 1] = f
        m[2, 2] = (zf + zn) / (zn - zf)
        m[2, 3] = 2.0 * zf * zn / (zn - zf)
        m[3, 2] = -1.0
        return m


def fit_camera(box_half, margin: float = 2.4) -> OrbitCamera:
    """Frame the container (the reference's Fit Camera analogue,
    ``Scene0p.cpp:603-627``)."""
    r = float(np.linalg.norm(np.asarray(box_half, np.float32)))
    cam = OrbitCamera()
    cam.distance = r * margin / math.tan(math.radians(cam.fov_y_deg) * 0.5)
    return cam
