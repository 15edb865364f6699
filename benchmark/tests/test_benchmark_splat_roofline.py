"""``splat_roofline``'s formula on a hand-counted slice, and nothing to
read on a slice without the frame export's kernels."""
import pytest

from benchmark import cells, peaks, trace


def _slice(kernels, seconds, counts, frames=2):
    ops = [(f"void (anonymous namespace)::{k}(float const*, int)", 0.0,
            seconds * 1e6) for k in kernels]
    return trace.Slice(ops, [("export.render", 0.0, seconds * 1e6)],
                       frames, 16, counts, lambda: {})


def test_splat_roofline_by_hand():
    mod = cells.reader("splat_roofline")
    assert mod.PIXELS == 960 * 540
    counts = {"fluid": 1000, "ghosts": 10, "num_cells": 64}
    t = 1e-4
    sl = _slice(mod.KERNELS, t, counts)
    # 1,000 fluid rows of 20 bytes, 10 ghost rows of 8, 518,400 pixels of
    # 18; the three kernels take t each over two frames
    nbytes = 1000 * 20 + 10 * 8 + 518400 * 18
    ops = 65 * 1000 + 46 * 518400
    want = 100.0 * 2 * max(nbytes / peaks.HBM_BYTES_PER_S,
                           ops / peaks.FP32_FLOPS) / (3 * t)
    assert mod.read(sl) == pytest.approx(want)
    assert nbytes / peaks.HBM_BYTES_PER_S > ops / peaks.FP32_FLOPS


def test_splat_roofline_reads_nothing_without_its_kernels():
    mod = cells.reader("splat_roofline")
    counts = {"fluid": 1000, "ghosts": 0, "num_cells": 64}
    assert mod.read(_slice(["force_xsph_kernel"], 1e-4, counts)) is None
    # a kernel whose name only contains one of them is not one of them
    assert mod.read(_slice(["splat_keys_kernel2"], 1e-4, counts)) is None
