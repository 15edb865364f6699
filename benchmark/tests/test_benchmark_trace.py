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


# the port's spans of two frames (``sph_tpu_torch/utils/trace.py``) inside
# the harness's, with the capture in the first
PORT = [("frame.substeps", 0.0, 100.0), ("frame.sync", 100.0, 110.0),
        ("sph.run_substeps", 1.0, 99.0), ("sph.neighbor_aux", 2.0, 22.0),
        ("sph.graph.run", 30.0, 90.0), ("sph.graph.capture", 40.0, 60.0),
        ("frame.substeps", 110.0, 200.0), ("frame.sync", 200.0, 220.0),
        ("sph.run_substeps", 111.0, 199.0), ("sph.neighbor_aux", 112.0, 122.0),
        ("sph.graph.run", 130.0, 170.0)]
PORT_OPS = [("density_kernel", 22.0, 30.0), ("force_xsph_kernel", 90.0, 105.0),
            ("density_kernel", 122.0, 130.0), ("force", 170.0, 215.0)]
READERS = ("aux_host_ms", "graph_host_ms", "idle_host_ms",
           "host_waits_per_frame", "captures_in_window")


def _reader(name):
    from benchmark import cells
    return cells.reader(name)


def _port_slice(counters=None, window_counters=None):
    return trace.Slice(PORT_OPS, PORT, 2, 16, {}, None, counters=counters,
                       window_counters=window_counters)


def test_port_spans_split_the_idle_and_leave_the_slice_bounds():
    sl = _port_slice()
    # start, end and busy time stay on the harness's spans
    assert (sl.start, sl.end) == (0.0, 220.0)
    assert sl.busy_s == pytest.approx(76e-6)
    # gaps 0-22, 30-90, 105-122, 130-170, 215-220, each put down to the
    # innermost span of either kind
    want = {"frame.substeps": 2e-6, "sph.run_substeps": 2e-6,
            "sph.neighbor_aux": 30e-6, "sph.graph.capture": 20e-6,
            "sph.graph.run": 80e-6, "frame.sync": 10e-6}
    assert sl.idle_gaps() == pytest.approx(want)
    assert dict(sl.breakdown()["idle_gaps"]) == pytest.approx(want)


def test_readers_of_the_ports_spans_and_counters():
    # a capture in the traced slice, and a second later in the window
    sl = _port_slice({"host_waits": 4, "graph.captures": 1,
                      "graph.replays": 2},
                     {"host_waits": 40, "graph.captures": 2,
                      "graph.replays": 20})
    got = {name: _reader(name).read(sl) for name in READERS}
    assert got == pytest.approx({
        "aux_host_ms": 1e-3 * (20 + 10) / 2,
        "graph_host_ms": 1e-3 * (60 + 40 - 20) / 2,
        "idle_host_ms": 1e-3 * (2 + 30 + 20 + 80) / 2,
        "host_waits_per_frame": 2.0,
        "captures_in_window": 2})
    # counters read but never counted in the process: none happened
    sl = _port_slice({"graph.replays": 2}, {"graph.replays": 20})
    assert _reader("host_waits_per_frame").read(sl) == 0.0
    assert _reader("captures_in_window").read(sl) == 0


def test_readers_find_nothing_without_the_ports_spans_and_counters():
    harness = [s for s in PORT if not s[0].startswith("sph.")]
    sl = trace.Slice(PORT_OPS, harness, 2, 16, {}, None)
    assert {name: _reader(name).read(sl) for name in READERS} == dict.fromkeys(
        READERS)


class _Event:
    def __init__(self, name, device, start, end):
        import torch
        self.name = name
        self.device_type = getattr(torch.autograd.DeviceType, device)
        self.time_range = type("R", (), {"start": start, "end": end})


def test_span_annotations_on_the_device_are_not_device_ops():
    """A span open while the profiler records leaves a CPU event and, on
    the card, an annotation of the same name on the device's timeline;
    only the CPU event is a span, and the annotation is no operation."""
    events = [_Event("frame.substeps", "CPU", 0.0, 100.0),
              _Event("frame.substeps", "CUDA", 5.0, 95.0),
              _Event("sph.graph.run", "CPU", 10.0, 90.0),
              _Event("sph.graph.run", "CUDA", 12.0, 92.0),
              _Event("sph.graph.replay", "CUDA", 20.0, 80.0),
              _Event("density_kernel", "CUDA", 30.0, 40.0),
              _Event("aten::add", "CPU", 50.0, 51.0)]
    prof = type("P", (), {"events": lambda self: events})()
    sl = trace.from_profiler(prof, 1, 16, {}, None, counters={"x": 1})
    assert sl.device_ops == [("density_kernel", 30.0, 40.0)]
    assert sorted(sl.spans) == [("frame.substeps", 0.0, 100.0),
                                ("sph.graph.run", 10.0, 90.0)]
    assert sl.counters == {"x": 1}
    assert _reader("device_ops_per_substep").read(sl) == 1 / 16


def test_a_traced_run_switches_the_ports_spans_on(tiny_root):
    """``--trace 1`` runs with the port's spans on from before the
    warm-up, and the window hands back the port's counters as they moved
    over the traced frames and over the whole window; ``--trace 0`` runs
    with the spans off."""
    import torch
    from benchmark import cells
    from benchmark.run import Run
    from sph_tpu_torch.utils import trace as port_trace
    cell = cells.load("tiny.sim16", root=tiny_root())
    run = Run(cell, 2**31 + 11, "cpu", traced=True)
    try:
        state = run.warm_up()
        # a window of 0 s runs one frame, and its trace stops there
        w = run.window(state, 0.0, 1, trace_frames=2)
        assert w["traced"] == 1
        names = {e.name for e in w["prof"].events()
                 if e.device_type == torch.autograd.DeviceType.CPU}
        assert {"sph.run_substeps", "sph.neighbor_aux",
                "frame.substeps"} <= names
        assert w["counters"]["ghost_builds"] == 1
        assert w["window_counters"]["ghost_builds"] == 1
        # the CPU runs the substeps eagerly: no frame program
        assert w["counters"].get("graph.replays", 0) == 0
        # the window's counters cover its untraced frames too
        w = run.window(w["state"], 3.0 * w["durations"][0], 1,
                       trace_frames=1)
        assert len(w["durations"]) >= 2
        assert w["counters"]["ghost_builds"] == 1
        assert w["window_counters"]["ghost_builds"] == len(w["durations"])
    finally:
        port_trace.enable(False)
    Run(cell, 2**31 + 11, "cpu")
    assert port_trace.span("sph.x") is port_trace._NULL
