"""The traced slice's arithmetic: the busy-interval union, the idle gaps
by span, kernel names matched whole, the breakdown."""
import pytest

from benchmark import trace


def test_busy_union_counts_overlap_once():
    assert trace.busy_us([]) == 0.0
    assert trace.busy_us([(0, 10), (5, 15), (20, 30)]) == 25.0
    assert trace.busy_us([(20, 30), (0, 10), (10, 12)]) == 22.0
    assert trace.busy_us([(0, 100), (10, 20), (30, 40)]) == 100.0
    assert trace.merged([(5, 15), (0, 10), (20, 30)]) == [(0, 15), (20, 30)]


def _slice(ops, spans, frames=2, substeps=16, counts=None):
    return trace.Slice(ops, spans, frames, substeps, counts or {},
                       lambda: {"density": 0, "force": 0})


def test_slice_idle_share_and_gaps_by_span():
    spans = [("frame.substeps", 0.0, 40.0), ("frame.sync", 40.0, 100.0),
             ("export.render", 100.0, 200.0)]
    ops = [("density_kernel(int)", 10.0, 50.0), ("copy", 45.0, 60.0),
           ("force_xsph_kernel<false>", 70.0, 90.0)]
    sl = _slice(ops, spans)
    assert sl.window_s == pytest.approx(200e-6)
    assert sl.busy_s == pytest.approx(70e-6)
    gaps = dict(sl.breakdown()["idle_gaps"])
    # 0-10 under frame.substeps, 60-70 and 90-100 under frame.sync, 100-200
    # under export.render
    assert gaps == pytest.approx({"frame.substeps": 10e-6,
                                  "frame.sync": 20e-6,
                                  "export.render": 100e-6})
    ops_top = sl.breakdown()["device_ops"]
    assert ops_top[0] == ["density_kernel(int)", pytest.approx(40e-6)]


def test_kernel_names_match_whole():
    ops = [("brute_density_kernel(float)", 0.0, 5.0),
           ("void density_kernel<true>(int const*)", 5.0, 7.0),
           ("density_kernel(int)", 8.0, 9.0),
           ("cell_table_kernel", 10.0, 14.0)]
    sl = _slice(ops, [("frame.substeps", 0.0, 20.0)])
    assert sl.kernel("density_kernel") == (pytest.approx(3e-6), 2)
    assert sl.kernel("cell_table_kernel") == (pytest.approx(4e-6), 1)
    assert sl.kernel("force_xsph_kernel") == (0.0, 0)


def test_spans_label_the_trace_only_while_it_records():
    import torch
    sp = trace.Spans()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with sp("frame.substeps"):
            torch.ones(4).sum()
        sp.record = True
        with sp("frame.sync"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "frame.sync" in names and "frame.substeps" not in names
