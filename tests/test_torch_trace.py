"""The port's spans and counters (``sph_tpu_torch/utils/trace.py``) and
the idle split of ``app/profile_substeps.py``.

On the CPU: a span with tracing off is the one shared null context and
opens no profiler label; with tracing on it adds its host time, and opens
a label only while a profiler records; the frame's spans nest as the frame
does, the root's args being the frame's index; the counters count the
frame path's host waits and ghost builds, and hold the kernels' launch
counts; a frame's fields are bit-identical with tracing on and off; the
profiler's idle gaps go to the innermost span.

CUDA (marker ``cuda``, skipped without a card): a replayed frame's
``host_waits`` equal the synchronising calls that torch's sync check
reports; captures with tracing on and off give the same outputs, one
capture a key either way, and every span of the graph path.  Built with
the port alone:

    python -m pytest tests/test_torch_trace.py -q -m cuda --noconftest
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from sph_tpu_torch.app import profile_substeps
from sph_tpu_torch.core import params as TP
from sph_tpu_torch.core import state as TS
from sph_tpu_torch.engine import graph
from sph_tpu_torch.engine import step as TSTEP
from sph_tpu_torch.utils import trace

N_SUB = 4
# the spans of a frame on the card, each with its parent
GRAPH_SPANS = {"sph.run_substeps": None,
               "sph.neighbor_aux": "sph.run_substeps",
               "sph.build_ghosts": "sph.neighbor_aux",
               "sph.graph.run": "sph.run_substeps",
               "sph.graph.key": "sph.graph.run",
               "sph.graph.capture": "sph.graph.run",
               "sph.graph.copy_in": "sph.graph.run",
               "sph.graph.replay": "sph.graph.run",
               "sph.graph.clone_out": "sph.graph.run"}
# case -> (host waits, ghost builds) a frame
WAITS = {"ghosts": (2, 1), "cell": (1, 0), "brute_kernel": (0, 0)}


@pytest.fixture(autouse=True)
def tracing_off_after():
    """Each test starts and ends with spans off and nothing counted."""
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def case_inputs(case, device):
    """(state, params, config, buffers): 512 fluid rows in a box of half 3
    inside its ghost shell on six active faces, the cell engine (a small
    ``ghost_1m``), or 1,024 rows in a box of half 7 on the cell engine or
    the all-pairs kernels."""
    half = (3.0, 3.0, 3.0) if case == "ghosts" else (7.0, 7.0, 7.0)
    params = TP.FluidParams.default(
        device=device, box_half=np.asarray(half, np.float32)).derive_mass()
    dims = TP.compute_grid_dims(0, np.asarray(half, np.float32),
                                np.zeros(3, np.float32), 0.28)
    if case == "ghosts":
        fluid = TS.spawn_standard(512, h=0.28, box_half=half, seed=1)
        spawn = TS.concat_spawns(
            fluid, TS.spawn_ghost_box_shell(h=0.28, box_half=half))
    else:
        spawn = TS.spawn_standard(1024, seed=7)
    state = TS.state_from_spawn(spawn, device=device)
    cfg = TP.SimConfig(n=state.n, grid_dims=dims,
                       neighbor_impl="brute_kernel" if case == "brute_kernel"
                       else "cell")
    return state, params, cfg, TSTEP.SceneBuffers.create(cfg, device=device)


def run_frames(inputs, n_frames=2):
    state, params, cfg, buf = inputs
    for _ in range(n_frames):
        state, buf = TSTEP.run_substeps(state, params, buf, params.dt, N_SUB,
                                        cfg)
    return state, buf


def fields(out):
    state, buf = out
    return {**{f.name: getattr(state, f.name).cpu()
               for f in dataclasses.fields(state)},
            **{f"buffers.{f.name}": getattr(buf, f.name).cpu()
               for f in dataclasses.fields(buf)}}


def spy_labels(monkeypatch):
    """The (name, args) of every profiler label opened from here on."""
    opened = []
    real = torch.profiler.record_function

    def spy(name, args=None):
        opened.append((name, args))
        return real(name, args)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    return opened


def cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


# ---------------------------------------------------------------------------
# the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("on", [False, True])
@pytest.mark.parametrize("profiling", [False, True])
def test_span_times_when_on_and_labels_only_while_profiling(
        monkeypatch, on, profiling):
    opened = spy_labels(monkeypatch)
    trace.enable(on)
    prof = cpu_profile() if profiling else None
    if prof is not None:
        prof.__enter__()
    try:
        sp = trace.span("sph.test", 7)
        with sp:
            torch.ones(4).sum()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    if not on:
        assert sp is trace.span("sph.other")
        assert isinstance(sp, type(trace._NULL))
        assert trace.totals() == {}
    else:
        (name, (sec, calls)), = trace.totals().items()
        assert name == "sph.test" and calls == 1 and sec > 0
    assert opened == ([("sph.test", "7")] if on and profiling else [])
    if prof is not None:
        labels = [e.name for e in prof.events() if e.name.startswith("sph.")]
        assert labels == (["sph.test"] if on else [])


def test_frame_spans_nest_on_the_eager_path(monkeypatch):
    opened = spy_labels(monkeypatch)
    inputs = case_inputs("ghosts", "cpu")
    trace.count("graph.replays", 5)
    trace.enable(True)
    with cpu_profile() as prof:
        run_frames(inputs, n_frames=1)
    spans = {e.name: e.time_range for e in prof.events()
             if e.name.startswith("sph.")}
    assert set(spans) == {"sph.run_substeps", "sph.neighbor_aux",
                          "sph.build_ghosts"}
    for name, rng in spans.items():
        parent = GRAPH_SPANS[name]
        if parent is not None:
            assert spans[parent].start <= rng.start <= rng.end \
                <= spans[parent].end, name
    assert ("sph.run_substeps", "5") in opened
    assert {k: n for k, (_, n) in trace.totals().items()} == dict.fromkeys(
        spans, 1)


@pytest.mark.parametrize("case", sorted(WAITS))
def test_counters_count_the_frame_paths_waits_and_builds(case):
    waits, builds = WAITS[case]
    run_frames(case_inputs(case, "cpu"), n_frames=2)
    trace.count("test.counter", 3)
    got = trace.counters()
    assert got.get("host_waits", 0) == 2 * waits
    assert got.get("ghost_builds", 0) == 2 * builds
    assert trace.counter("test.counter") == 3
    assert trace.counter("never.counted") == 0
    assert {"launches.cell_table", "launches.density", "launches.force_xsph",
            "launches.force_xsph_emit", "launches.container",
            "launches.brute_density", "launches.brute_force"} <= set(got)


def test_reset_clears_counters_totals_and_launch_counts():
    from sph_tpu_torch.neighbors import sweeps
    trace.enable(True)
    with trace.span("sph.test"):
        trace.count("host_waits")
    sweeps.LAUNCHES["density"] += 2
    assert trace.counters()["launches.density"] >= 2
    trace.reset()
    assert trace.totals() == {} and trace.counter("host_waits") == 0
    assert sweeps.LAUNCHES["density"] == 0
    assert not any(trace.counters().values())


@pytest.mark.parametrize("case", ["ghosts", "brute_kernel"])
def test_run_substeps_bit_identical_with_tracing_on_and_off(case):
    inputs = case_inputs(case, "cpu")
    off = fields(run_frames(inputs))
    trace.enable(True)
    with cpu_profile():
        on = fields(run_frames(inputs))
    assert trace.totals()
    for name in off:
        assert torch.equal(on[name], off[name]), name


def test_profilers_idle_goes_to_the_innermost_span():
    """Hand-made: the window 0-100 µs, busy 10-20 and 50-90; spans
    run_substeps 5-95 holding neighbor_aux 20-40 and graph.run 40-60."""
    busy = [[10.0, 20.0], [50.0, 90.0]]
    spans = [("sph.run_substeps", 5.0, 95.0),
             ("sph.neighbor_aux", 20.0, 40.0),
             ("sph.graph.run", 40.0, 60.0)]
    got = profile_substeps._idle_by_span(busy, 0.0, 100.0, spans)
    assert got == {"outside spans": 10.0, "sph.run_substeps": 10.0,
                   "sph.neighbor_aux": 20.0, "sph.graph.run": 10.0}
    assert sum(got.values()) == 100.0 - 50.0
    assert profile_substeps._merged([(50, 90), (10, 20), (15, 18),
                                     (60, 95)]) == [[10, 20], [50, 95]]


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_host_waits_are_the_replayed_frames_syncs_on_cuda(cuda):
    inputs = case_inputs("ghosts", cuda)
    state, params, cfg, buf = inputs
    state, buf = run_frames(inputs, n_frames=1)       # the capture
    torch.cuda.synchronize()
    waits = trace.counter("host_waits")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            TSTEP.run_substeps(state, params, buf, params.dt, N_SUB, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [w for w in seen
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert trace.counter("host_waits") - waits == len(syncs) == 2, [
        str(w.message) for w in syncs]


@pytest.mark.cuda
def test_capture_same_with_tracing_on_and_off_on_cuda(cuda):
    inputs = case_inputs("ghosts", cuda)
    outs = {}
    for on in (False, True):
        trace.reset()
        trace.enable(on)
        graph._PROGRAMS.clear()
        outs[on] = fields(run_frames(inputs))
        assert trace.counter("graph.captures") == 1
        assert trace.counter("graph.replays") == 2
    calls = {k: n for k, (_, n) in trace.totals().items()}
    assert calls == {**dict.fromkeys(GRAPH_SPANS, 2), "sph.graph.capture": 1}
    for name in outs[False]:
        assert torch.equal(outs[True][name], outs[False][name]), name
