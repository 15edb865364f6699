"""The traced slice of a window: ``torch.profiler`` over the first frames
of the window, reduced to what the per-layer metrics read.

The harness labels its own calls with spans (``SPANS``), and the port
labels its host work with its own (``sph.*``, ``sph_tpu_torch/utils/
trace.py``) while its spans are on; busy time and wall time come from the
same trace, so the idle share has one source.  The slice's start, end and
busy time are the harness's spans'; its idle gaps are put down to the
innermost span of either kind.
The busy-interval union is the arithmetic of
``sph_tpu_torch/app/profile_substeps.py`` ``_busy_us``, copied.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import re
from typing import Dict, Iterable, List, Optional, Tuple

SPANS = ("frame.prologue", "frame.substeps", "frame.sync", "export.render",
         "export.png")
# the first letters of the port's span names
PORT_SPANS = "sph."
TOP = 10

Interval = Tuple[float, float]


def busy_us(intervals: Iterable[Interval]) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_gaps(busy: List[Interval], start: float, end: float,
              spans: List[Tuple[str, float, float]]) -> Dict[str, float]:
    """The device's idle time between ``start`` and ``end``, summed by the
    innermost span the host was in (``"outside spans"`` where it was in
    none), in the intervals' unit.  A gap is cut where a span starts or
    ends."""
    out: Dict[str, float] = collections.defaultdict(float)
    cuts = sorted({t for _, s, e in spans for t in (s, e)})
    edges = [(start, start)] + [iv for iv in busy if iv[1] > start
                                and iv[0] < end] + [(end, end)]
    for (_, prev_end), (next_start, _) in zip(edges, edges[1:]):
        gap_s, gap_e = max(prev_end, start), min(next_start, end)
        if gap_e <= gap_s:
            continue
        points = ([gap_s] + cuts[bisect.bisect_right(cuts, gap_s):
                                 bisect.bisect_left(cuts, gap_e)] + [gap_e])
        near = [(e - s, name, s, e) for name, s, e in spans
                if s <= gap_e and e >= gap_s]
        for a, b in zip(points, points[1:]):
            mid = 0.5 * (a + b)
            cover = [(d, name) for d, name, s, e in near if s <= mid <= e]
            out[min(cover)[1] if cover else "outside spans"] += b - a
    return dict(out)


class Spans:
    """The harness's spans: a profiler label on each of its calls while a
    trace records, nothing otherwise."""

    def __init__(self):
        self.record = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.record:
            import torch
            with torch.profiler.record_function(name):
                yield
        else:
            yield


class Slice:
    """What the per-layer metrics read from one traced slice: device
    operations, the harness's and the port's spans, the frames and
    substeps it covers, the counts of the configuration, and the port's
    counters as they moved over the slice and over the whole window (None
    where they were not read)."""

    def __init__(self, device_ops: List[Tuple[str, float, float]],
                 spans: List[Tuple[str, float, float]], frames: int,
                 substeps_per_frame: int, counts: dict, pairs=None,
                 counters: Optional[Dict[str, int]] = None,
                 window_counters: Optional[Dict[str, int]] = None):
        self.device_ops = device_ops          # (name, start us, end us)
        self.spans = spans                    # (name, start us, end us)
        self.frames = frames
        self.substeps = frames * substeps_per_frame
        self.counts = counts
        self.counters = counters
        self.window_counters = window_counters
        self._pairs = pairs
        self._pair_counts: Optional[dict] = None
        frame_spans = [s for s in spans if s[0] in SPANS]
        self.start = min(s for _, s, _ in frame_spans)
        self.end = max(e for _, _, e in frame_spans)
        self.busy = merged((s, e) for _, s, e in device_ops
                           if e > self.start and s < self.end)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    @property
    def busy_s(self) -> float:
        return busy_us((max(s, self.start), min(e, self.end))
                       for s, e in self.busy) * 1e-6

    def kernel(self, name: str) -> Tuple[float, int]:
        """(device seconds, launches) of the kernel ``name``, matched as a
        whole word of the operation's name."""
        pat = re.compile(rf"(?<![A-Za-z0-9_]){re.escape(name)}"
                         rf"(?![A-Za-z0-9_])")
        hits = [(e - s) for n, s, e in self.device_ops if pat.search(n)]
        return sum(hits) * 1e-6, len(hits)

    def span_seconds(self, name: str) -> List[float]:
        return [(e - s) * 1e-6 for n, s, e in self.spans if n == name]

    def idle_gaps(self) -> Dict[str, float]:
        """The device's idle seconds in the slice by the innermost span,
        of either kind, that the host was in."""
        gaps = idle_gaps(self.busy, self.start, self.end, self.spans)
        return {k: v * 1e-6 for k, v in gaps.items()}

    def pairs(self) -> dict:
        """The pair counts of the traced state (``reference/pairs.py``),
        counted once, at the first call."""
        if self._pair_counts is None:
            self._pair_counts = self._pairs()
        return self._pair_counts

    def breakdown(self) -> dict:
        by_name: Dict[str, float] = collections.defaultdict(float)
        for n, s, e in self.device_ops:
            by_name[n[:160]] += (e - s) * 1e-6
        top = lambda d: [[k, v] for k, v in  # noqa: E731
                         sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_name), "idle_gaps": top(self.idle_gaps())}


def from_profiler(prof, frames: int, substeps_per_frame: int, counts: dict,
                  pairs, counters: Optional[Dict[str, int]] = None,
                  window_counters: Optional[Dict[str, int]] = None) -> Slice:
    """The slice of a finished ``torch.profiler.profile``: its device
    operations (kernels, copies, fills; the spans' own device-side
    annotations left out), the spans of the harness and of the port,
    ``counters``, the port's counters' moves over the slice, and
    ``window_counters``, their moves over the whole window."""
    import torch
    dev, spans = [], []
    for e in prof.events():
        rng = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name in SPANS or e.name.startswith(PORT_SPANS):
            if e.device_type == torch.autograd.DeviceType.CPU:
                spans.append(rng)
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(rng)
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    return Slice(dev, spans, frames, substeps_per_frame, counts, pairs,
                 counters, window_counters)
