"""The cell ``rotated_512k.sim16`` on the CPU: its configuration file
shrunk through the system and the output check, and the readers of the
wave kick's span.

- ``configs/rotated_512k.json`` at 4,096 rows, in a box scaled to keep
  the rows a unit of volume, runs ``correct`` against the plain reference
  with one kick a frame, and fails the check with its prologue skipped;
- ``prologue_host_ms`` and ``prologue_idle_ms`` on hand-made slices, and
  None where the slice holds no ``sph.impulse.wave``.
"""
import dataclasses

import pytest

from benchmark import cells, check, control
from benchmark import trace as btrace
from benchmark.run import Run
from sph_tpu_torch.utils import trace

CELL = "rotated_512k.sim16"
SPAN, COUNTER = "sph.impulse.wave", "impulses.wave"
SEED = 2**31 + 2301
# 4,096 rows at the published rows per unit of volume, 524,288 / 15^3
SMALL_ROWS = 4096
SMALL_HALF = 15.0 * (SMALL_ROWS / 524288) ** (1.0 / 3.0)


@pytest.fixture(autouse=True)
def spans_off():
    """Each test starts and ends with the port's spans off and nothing
    counted."""
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


# ---------------------------------------------------------------------------
# the file shrunk, through the system and the check
# ---------------------------------------------------------------------------

def _small_run():
    cell = cells.load(CELL)
    cfg = dict(cell.config, fluid_rows=SMALL_ROWS,
               box_half=[SMALL_HALF] * 3)
    return Run(dataclasses.replace(cell, config=cfg), SEED, "cpu")


def _verdict(run):
    state = run.warm_up()
    w = run.window(state, 0.0, int(run.cell.limits["check_frames"]))
    numbers, failed = run.check(w["sample"])
    numbers["start_rows_apart"] = run.start_rows_apart()
    checks = check.verdict(numbers, run.cell.limits["limits"])
    return w, failed, {k: ok for k, _, _, ok in checks}, numbers


def test_the_file_shrunk_runs_correct_against_the_reference():
    run = _small_run()
    assert run.fluid == SMALL_ROWS
    w, failed, ok, numbers = _verdict(run)
    assert failed == 0 and all(ok.values()), numbers
    # one kick a frame, the warm-up's before the window
    frames = int(run.traffic["warmup_frames"]) + len(w["durations"])
    assert trace.counter(COUNTER) == frames
    assert w["window_counters"][COUNTER] == len(w["durations"])


def test_the_file_shrunk_fails_the_check_without_its_prologue():
    run = _small_run()
    control.plant(run.system, "prologue")
    _, failed, ok, numbers = _verdict(run)
    assert failed >= 1 and not ok["vel_apart"], numbers
    assert trace.counter(COUNTER) == 0


# ---------------------------------------------------------------------------
# the readers of the kick's span
# ---------------------------------------------------------------------------

# two frames, each a prologue holding the kick's span, the substeps and
# the sync (µs)
SPANS = [("frame.prologue", 0.0, 20.0), (SPAN, 2.0, 18.0),
         ("frame.substeps", 20.0, 100.0), ("sph.run_substeps", 21.0, 99.0),
         ("frame.sync", 100.0, 110.0),
         ("frame.prologue", 110.0, 125.0), (SPAN, 111.0, 121.0),
         ("frame.substeps", 125.0, 200.0), ("frame.sync", 200.0, 220.0)]
OPS = [("mul", 5.0, 8.0), ("sin", 12.0, 14.0), ("density_kernel", 30.0, 105.0),
       ("add", 115.0, 117.0), ("force_xsph_kernel", 130.0, 215.0)]
READERS = ("prologue_host_ms", "prologue_idle_ms")


def _slice(spans=SPANS, ops=OPS, counters={COUNTER: 2}):
    return btrace.Slice(ops, spans, 2, 16, {}, None, counters=counters,
                        window_counters=counters)


def _read(name, sl):
    return cells.reader(name).read(sl)


def test_readers_of_the_kicks_span():
    sl = _slice()
    # the kick's idle: 2-5, 8-12, 14-18 in the first frame, 111-115 and
    # 117-121 in the second
    assert sl.idle_gaps()[SPAN] == pytest.approx(19e-6)
    assert _read("prologue_host_ms", sl) == pytest.approx(
        1e3 * (16 + 10) * 1e-6 / 2)
    assert _read("prologue_idle_ms", sl) == pytest.approx(
        1e3 * 19e-6 / 2)
    # the card busy all through the kick: no idle under it, and 0, not None
    busy = _slice(ops=[("busy", 0.0, 220.0)])
    assert _read("prologue_idle_ms", busy) == 0.0
    assert _read("prologue_host_ms", busy) == pytest.approx(
        1e3 * (16 + 10) * 1e-6 / 2)


@pytest.mark.parametrize("case", ["spans off", "no prologue"])
def test_readers_of_the_kicks_span_find_nothing(case):
    # with the port's spans off (or a port without the span) the kicks are
    # counted but leave no span; a configuration without a prologue has
    # neither
    spans = [s for s in SPANS if s[0] != SPAN]
    counters = {COUNTER: 2} if case == "spans off" else {}
    sl = _slice(spans, counters=counters)
    assert {name: _read(name, sl) for name in READERS} == dict.fromkeys(
        READERS)
