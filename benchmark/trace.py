"""The traced slice of a window: ``torch.profiler`` over the first frames
of the window, reduced to what the per-layer metrics read.

The harness labels its own calls with spans (``SPANS``); busy time and
wall time come from the same trace, so the idle share has one source.
The busy-interval union is the arithmetic of
``sph_tpu_torch/app/profile_substeps.py`` ``_busy_us``, copied.
"""
from __future__ import annotations

import collections
import contextlib
import re
from typing import Dict, Iterable, List, Optional, Tuple

SPANS = ("frame.substeps", "frame.sync", "export.render", "export.png")
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
        points = [gap_s] + [t for t in cuts if gap_s < t < gap_e] + [gap_e]
        for a, b in zip(points, points[1:]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            cover = [(e - s, name) for name, s, e in spans if s <= mid <= e]
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
    operations, the harness's spans, the frames and substeps it covers,
    and the counts of the configuration."""

    def __init__(self, device_ops: List[Tuple[str, float, float]],
                 spans: List[Tuple[str, float, float]], frames: int,
                 substeps_per_frame: int, counts: dict, pairs=None):
        self.device_ops = device_ops          # (name, start us, end us)
        self.spans = spans                    # (name, start us, end us)
        self.frames = frames
        self.substeps = frames * substeps_per_frame
        self.counts = counts
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
        gaps = idle_gaps(self.busy, self.start, self.end,
                         [s for s in self.spans if s[0] in SPANS])
        top = lambda d: [[k, v] for k, v in  # noqa: E731
                         sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_name),
                "idle_gaps": top({k: v * 1e-6 for k, v in gaps.items()})}


def from_profiler(prof, frames: int, substeps_per_frame: int, counts: dict,
                  pairs) -> Slice:
    """The slice of a finished ``torch.profiler.profile``: its device
    operations (kernels, copies, fills; the spans' own device-side
    annotations left out) and the harness's spans."""
    import torch
    dev, spans = [], []
    for e in prof.events():
        rng = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name in SPANS:
            if e.device_type == torch.autograd.DeviceType.CPU:
                spans.append(rng)
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(rng)
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    return Slice(dev, spans, frames, substeps_per_frame, counts, pairs)
