"""The initial particles of a run, made from ``--seed``.

A copy of the bottom-anchored lattice spawn of the reference
(``SPHFluid3D.cpp:159-259``) for a box, and of the ghost box shell, as the
port has them (``sph_tpu_torch/core/state.py`` ``spawn_standard`` and
``spawn_ghost_box_shell``).  The harness hands the arrays it makes here to
the port and to the plain reference alike.

The fluid's lattice lies in the box's own frame: a row at ``offset`` from
the box's centre c is placed at p = c + R offset, with R the box's
rotation (``reference.sph.rotation``), so in a rotated box too every row
starts inside it, as the port's ``spawn_standard`` places it for
``spawn_rotation="local"``.  At zero angles the product is skipped, and
the rows are the axis-aligned lattice's, bit for bit.

The seed sets only the jitter: every seed gives the same number of rows in
the same lattice, so every seed asks the same work of the port.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from benchmark.reference.sph import rotation


def fluid_box(n_target: int, h: float, box_half, fill_fraction: float,
              jitter: float, seed: int) -> Dict[str, np.ndarray]:
    """Up to ``n_target`` rows on a lattice of spacing 0.85 h, from the
    box's floor up to ``fill_fraction`` of its height, each coordinate
    jittered by up to ``jitter`` spacings, in the lattice's order."""
    spacing = 0.85 * h
    ext = np.asarray(box_half, np.float32)
    layers_y = max(1, int((2.0 * ext[1] * fill_fraction) / spacing))
    side_x = max(1, int((ext[0] * 1.7) / spacing))
    side_z = max(1, int((ext[2] * 1.7) / spacing))
    xi, yi, zi = np.meshgrid(np.arange(side_x), np.arange(layers_y),
                             np.arange(side_z), indexing="ij")
    rng = np.random.default_rng(int(seed) % 2**64)
    a = spacing * jitter

    def jit():
        return rng.uniform(-a, a, xi.shape).astype(np.float32)

    wx = (-ext[0] * 0.85 + xi * spacing + jit()).astype(np.float32)
    wy = (-ext[1] + spacing + yi * spacing + jit()).astype(np.float32)
    wz = (-ext[2] * 0.85 + zi * spacing + jit()).astype(np.float32)
    pos = np.stack([wx.reshape(-1), wy.reshape(-1), wz.reshape(-1)],
                   axis=-1)[:n_target]
    count = len(pos)
    return {"pos": np.ascontiguousarray(pos, np.float32),
            "vel": np.zeros((count, 3), np.float32),
            "ghost": np.zeros(count, np.int32),
            "face": np.full(count, -1, np.int32),
            "color_group": (wx.reshape(-1)[:n_target] >= 0).astype(np.int32)}


def ghost_shell(h: float, box_half) -> Dict[str, np.ndarray]:
    """One layer of ghost rows 0.45 h outside each face of the box, at
    in-plane spacing up to 0.85 h, tagged by face: 0 = -X, 1 = +X, 2 = -Y,
    3 = +Y, 4 = -Z, 5 = +Z."""
    spacing = 0.85 * h
    hf = np.asarray(box_half, np.float32)
    pos, face = [], []
    for axis in range(3):
        u_ax, v_ax = [a for a in range(3) if a != axis]
        nu = max(1, int(np.ceil(2 * hf[u_ax] / spacing)) + 1)
        nv = max(1, int(np.ceil(2 * hf[v_ax] / spacing)) + 1)
        us = np.linspace(-hf[u_ax], hf[u_ax], nu).astype(np.float32)
        vs = np.linspace(-hf[v_ax], hf[v_ax], nv).astype(np.float32)
        uu, vv = np.meshgrid(us, vs, indexing="ij")
        for side in (0, 1):
            p = np.zeros((uu.size, 3), np.float32)
            p[:, axis] = (-1.0 if side == 0 else 1.0) * (hf[axis] + 0.45 * h)
            p[:, u_ax] = uu.reshape(-1)
            p[:, v_ax] = vv.reshape(-1)
            pos.append(p)
            face.append(np.full(len(p), axis * 2 + side, np.int32))
    pos = np.concatenate(pos)
    count = len(pos)
    return {"pos": pos, "vel": np.zeros((count, 3), np.float32),
            "ghost": np.ones(count, np.int32),
            "face": np.concatenate(face),
            "color_group": np.zeros(count, np.int32)}


def spawn(cfg: dict, seed: int) -> Dict[str, np.ndarray]:
    """The rows of configuration ``cfg`` (its file, as a dict) for
    ``seed``: the fluid, in the box's frame, then the ghost shell where the
    configuration has one."""
    out = fluid_box(cfg["fluid_rows"], cfg["h"], cfg["box_half"],
                    cfg["fill_fraction"], cfg["jitter"], seed)
    if any(cfg["box_euler_deg"]):
        out["pos"] = out["pos"] @ rotation(cfg["box_euler_deg"]).T
    if cfg["ghost_shell"]:
        shell = ghost_shell(cfg["h"], cfg["box_half"])
        out = {k: np.concatenate([out[k], shell[k]]) for k in out}
    out["pos"] = out["pos"] + np.asarray(cfg["box_center"], np.float32)
    return out
