"""Each roofline's count on a tiny state whose pairs are counted by hand:
the pairs within h come from the harness's own plain count, the bytes
from the configuration's rows."""
import json
import os

import numpy as np
import pytest

from benchmark import cells, peaks, trace
from benchmark.reference import pairs, sph

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cfg():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "default_131k.json")) as f:
        return dict(json.load(f), box_half=[2.5, 2.5, 2.5])


def _state(with_ghost):
    # A-B and C-D 0.1 apart, B-C 0.4 apart (h = 0.28); the ghost on the
    # +Y face lies 0.2 from A and 0.224 from B
    pos = [(0, 0, 0), (0.1, 0, 0), (0.5, 0, 0), (0.6, 0, 0)]
    ghost = [0, 0, 0, 0]
    face = [-1, -1, -1, -1]
    if with_ghost:
        pos.append((0.0, 0.2, 0.0))
        ghost.append(1)
        face.append(3)
    n = len(pos)
    rows = {"pos": np.asarray(pos, np.float32),
            "vel": np.zeros((n, 3), np.float32),
            "ghost": np.asarray(ghost, np.int32),
            "face": np.asarray(face, np.int32),
            "color_group": np.zeros(n, np.int32)}
    return sph.initial_state(rows, "cpu", pad=8)


@pytest.mark.parametrize("with_ghost, density, force",
                         [(False, 8, 4), (True, 10, 6)])
def test_pairs_within_h_by_hand(with_ghost, density, force):
    frame = sph.Frame(_cfg(), "cpu")
    got = pairs.count(frame, _state(with_ghost))
    assert got == {"density": density, "force": force, "fluid": 4,
                   "ghosts": int(with_ghost)}


def _slice(kernel, seconds, counts, pair_counts, substeps=16):
    ops = [(f"void {kernel}(int)", 0.0, seconds * 1e6)]
    return trace.Slice(ops, [("frame.substeps", 0.0, seconds * 1e6)], 1,
                       substeps, counts, lambda: pair_counts)


def test_each_roofline_formula():
    counts = {"fluid": 4, "ghosts": 1, "num_cells": 1000}
    pc = {"density": 10, "force": 6, "fluid": 4, "ghosts": 1}
    t = 1e-3
    expect = {
        "cell_table_roofline": ((5 * 152 + 1001 * 4), 0),
        "density_roofline": (4 * 24 + 12 + 1001 * 4 * 2, 12 * 10 + 6 * 4),
        "force_roofline": (4 * 68 + 12 + 1001 * 4 * 2, 67 * 6 + 70 * 4),
    }
    for name, (nbytes, ops) in expect.items():
        mod = cells.reader(name)
        sl = _slice(mod.KERNEL, t, counts, pc)
        want = 100.0 * 16 * max(nbytes / peaks.HBM_BYTES_PER_S,
                                ops / peaks.FP32_FLOPS) / t
        assert mod.read(sl) == pytest.approx(want), name
        # no launch of the kernel: nothing to read
        assert mod.read(_slice("other_kernel", t, counts, pc)) is None


def test_ops_bind_when_bytes_are_few():
    counts = {"fluid": 1, "ghosts": 0, "num_cells": 1}
    pc = {"density": 10**9, "force": 10**9, "fluid": 1, "ghosts": 0}
    mod = cells.reader("force_roofline")
    got = mod.read(_slice(mod.KERNEL, 1.0, counts, pc, substeps=1))
    assert got == pytest.approx(100.0 * (67 * 10**9 + 70) / peaks.FP32_FLOPS)


def test_shares_and_spans():
    ops = [("k", 0.0, 30.0), ("k", 50.0, 60.0)]
    spans = [("frame.substeps", 0.0, 100.0), ("export.render", 100.0, 150.0),
             ("export.png", 150.0, 200.0), ("export.render", 200.0, 230.0)]
    sl = trace.Slice(ops, spans, 2, 16, {}, None)
    assert cells.reader("device_idle_share").read(sl) == pytest.approx(
        1 - 40 / 230)
    assert cells.reader("device_ops_per_substep").read(sl) == 2 / 32
    assert cells.reader("export_render_ms").read(sl) == pytest.approx(0.04)
    assert cells.reader("export_png_ms").read(sl) == pytest.approx(0.05)
    bare = trace.Slice(ops, [("frame.substeps", 0.0, 100.0)], 2, 16, {}, None)
    assert cells.reader("export_render_ms").read(bare) is None
