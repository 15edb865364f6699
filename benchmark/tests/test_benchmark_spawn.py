"""The initial rows (``spawn.py``): a rotated box's lattice against the
axis-aligned one rotated, and the repo's cells' rows, at zero angles, as
they were before the spawn placed the lattice in the box's frame."""
import hashlib
import json
import os

import numpy as np
import pytest

from benchmark import spawn
from benchmark.reference import sph

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2**31 + 2024
# sha256 of every column of the rows, in sorted order of the columns'
# names, for SEED, as the axis-aligned spawn made them
ROWS_SHA256 = {
    "default_131k":
        "324ca02cf8d845c492e2669f501f4efc362979eb91d87aebf8b770894407fa6f",
    "ghost_1m":
        "4b82488bc844544dede5180f2145d021464e9e7ca77ab48fca89db8c5c0c7def",
}


def _cfg(name="default_131k", **changes):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return dict(json.load(f), **changes)


def _rotated(euler=(20.0, 0.0, 30.0)):
    return _cfg(fluid_rows=4096, box_half=[3.5, 3.0, 4.0],
                box_center=[0.5, -1.0, 2.0], box_euler_deg=list(euler))


def _sha256(rows):
    h = hashlib.sha256()
    for k in sorted(rows):
        h.update(k.encode())
        h.update(np.ascontiguousarray(rows[k]).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(ROWS_SHA256))
def test_zero_angle_cells_spawn_as_before(name):
    cfg = _cfg(name)
    assert not any(cfg["box_euler_deg"])
    assert _sha256(spawn.spawn(cfg, SEED)) == ROWS_SHA256[name]


def test_rotated_rows_are_the_lattice_rotated_about_the_centre():
    aligned = spawn.spawn(_rotated((0.0, 0.0, 0.0)), SEED)
    turned = spawn.spawn(_rotated(), SEED)
    c = np.asarray([0.5, -1.0, 2.0], np.float32)
    rot = sph.rotation([20.0, 0.0, 30.0])
    assert len(turned["pos"]) == len(aligned["pos"]) == 4096
    # float32 rounding of the centre's add and subtract: a few ulps of 4
    np.testing.assert_allclose(turned["pos"] - c,
                               (aligned["pos"] - c) @ rot.T,
                               rtol=0, atol=2e-6)
    assert not np.allclose(turned["pos"], aligned["pos"], atol=1e-2)
    for k in ("vel", "ghost", "face", "color_group"):
        assert np.array_equal(turned[k], aligned[k])


def test_rotated_rows_lie_inside_the_rotated_box():
    cfg = _rotated()
    rows = spawn.spawn(cfg, SEED)
    box = (rows["pos"] - np.asarray(cfg["box_center"], np.float32)) @ \
        sph.rotation(cfg["box_euler_deg"])
    assert np.all(np.abs(box) <= np.asarray(cfg["box_half"]) - 1e-3)
    # the axis-aligned lattice of the same box pokes out of it
    aligned = spawn.spawn(_rotated((0.0, 0.0, 0.0)), SEED)
    box = (aligned["pos"] - np.asarray(cfg["box_center"], np.float32)) @ \
        sph.rotation(cfg["box_euler_deg"])
    assert np.any(np.abs(box) > np.asarray(cfg["box_half"]))
