"""Spans and counters of the port's host work.

A **span** times one piece of a frame's host work (``span(name)``, a
context manager; every name starts with ``sph.``).  Spans are off until
the caller switches them on with ``enable(True)``; off, ``span`` returns
one shared null context, so the frame path pays a bool check a span.  On,
each span adds its host seconds and one call to :func:`totals`, and while
a ``torch.profiler`` records it also opens
``torch.profiler.record_function``, so the span lies in the profiler's
trace on the clock of the device's operations: each stretch of the
device's idle time can be put down to the span the host was in.  The
frame path's spans: ``sph.run_substeps``, ``sph.neighbor_aux``,
``sph.build_ghosts`` and ``sph.graph.*`` (``engine/``, ``neighbors/``),
and ``sph.impulse.wave``, the wave kick that a frame's prologue runs
before the frame program (``physics/impulses.wave_impulse``).

A **counter** (``count(name)``) always counts, one dict increment:

- ``graph.captures``, ``graph.replays``: the frame program's captures and
  replays (``engine/graph.py``);
- ``host_waits``: the frame path's own device-to-host waits (the ghost
  check of ``neighbors/sweeps.prepare``, the ``nonzero`` of
  ``neighbors/cells.ghost_sort``);
- ``ghost_builds``: the static ghost structures built
  (``neighbors/cells.build_ghosts``);
- ``impulses.wave``: the wave kicks (``physics/impulses.wave_impulse``,
  under the span ``sph.impulse.wave``), which a configuration with a
  frame prologue runs once a frame before the frame program: the record
  of the kicks where spans are off, as they are by default;
- ``launches.<kernel>``: the kernels' launches, counted where a wrapper
  launches one (``native/build.launched``, the one counting point) and
  added by the frame program at each replay (``engine/graph.py``); only
  the CUDA path counts, so on the CPU every one reads 0.

Nothing here runs inside a captured program: a span or counter there
would run once, at the capture, and never at a replay.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

_on = False
_NULL = contextlib.nullcontext()
_counts: Dict[str, int] = collections.Counter()
_totals: Dict[str, List[int]] = {}     # name -> [host ns, calls]


def enable(on: bool) -> None:
    """Switch the spans on or off (off at import).  Counters always
    count."""
    global _on
    _on = bool(on)


class _Span:
    __slots__ = ("name", "args", "t0", "rf")

    def __init__(self, name: str, args):
        self.name, self.args = name, args

    def __enter__(self):
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(
                self.name, None if self.args is None else str(self.args))
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        tot = _totals.setdefault(self.name, [0, 0])
        tot[0] += ns
        tot[1] += 1
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, args=None):
    """A span of host work named ``name`` (``sph.`` first), with ``args``
    (any value, given to the profiler as its string) on its profiler
    label; the shared null context while spans are off."""
    if not _on:
        return _NULL
    return _Span(name, args)


def count(name: str, n: int = 1) -> None:
    _counts[name] += n


def counter(name: str) -> int:
    """The counter ``name`` (0 if it never counted)."""
    return _counts[name]


def counters() -> Dict[str, int]:
    """Every counter."""
    return dict(_counts)


def launches(since: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """``{kernel: launches}`` of the ``launches.<kernel>`` counters, less
    ``since`` (an earlier reading), of the kernels whose count moved."""
    since = since or {}
    moved = ((k[len("launches."):], n) for k, n in _counts.items()
             if k.startswith("launches."))
    return {k: n - since.get(k, 0) for k, n in moved if n != since.get(k, 0)}


def totals() -> Dict[str, Tuple[float, int]]:
    """``{span: (host seconds, calls)}`` since the last :func:`reset`, of
    the spans that ran while spans were on."""
    return {k: (ns * 1e-9, n) for k, (ns, n) in _totals.items()}


def reset() -> None:
    """Clear the span totals and every counter, the launch counts too."""
    _counts.clear()
    _totals.clear()
