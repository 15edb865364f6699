"""A frame's substeps as one captured program on the card (counterpart of
``sph_tpu/engine/step.py``'s ``_run_substeps_jit``, ``lax.scan`` under one
``jax.jit``).

:func:`run` captures a function of tensors into one ``torch.cuda.CUDAGraph``
the first time it meets its key, and replays that graph on every later
call.  A graph reads and writes fixed addresses, so each :class:`Program`
owns static copies of its inputs: a call copies the caller's tensors into
them (device to device, one ``_foreach_copy_``), replays, and returns
clones of the outputs, which the next replay does not overwrite.

The inputs are a tree of tensors, dataclasses, tuples and named tuples
(the state, the params, the scene's buffers, dt, the neighbor engine's
per-run aux).  Anything else in it (``shape_type``, the grid dims, a dt
given as a float, None) is baked into the capture, so it is part of the
key, with each tensor's shape, dtype and device and the caller's static
key (``engine.step``'s: the substep count and the ``SimConfig``).

Before a capture, ``warmup`` runs once on the static inputs on a side
stream (torch's recipe): the kernel library is built and its kernels
loaded, cuBLAS is set up and the constants of ``core.device.constant`` are
made, none of which may happen inside a capture.  A capture that fails
raises; nothing falls back to eager launches.

Launch counts: a program adds the ``launches.*`` counters that moved
during its capture at each replay, which calls no kernel wrapper; what the
warm-up and the capture themselves counted is taken off again, since
neither computes anything the caller gets.  The counters
``graph.captures`` and ``graph.replays`` and the spans ``sph.graph.*`` of
the host's work around a replay are ``utils/trace.py``'s; none of them
runs inside the captured function.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Hashable, List, Tuple

import torch

from sph_tpu_torch.utils import trace

# programs kept at once; the oldest goes first (the reel needs two: 33 and
# 34 substeps)
MAX_PROGRAMS = 8

_PROGRAMS: "collections.OrderedDict[Hashable, Program]" = (
    collections.OrderedDict())


def _flatten(obj) -> Tuple[List[torch.Tensor], Hashable]:
    """(tensor leaves in a fixed order, a hashable spec of the rest)."""
    leaves: List[torch.Tensor] = []
    return leaves, _spec(obj, leaves)


def _spec(o, leaves: List[torch.Tensor]) -> Hashable:
    """The spec of ``o``; its tensors are appended to ``leaves``.  A
    function of the module, not a closure: a closure that calls itself is
    a reference cycle, which would hold ``leaves`` (a frame's input state)
    until the garbage collector ran, and the allocator would take new
    device memory for the frames in between."""
    if isinstance(o, torch.Tensor):
        leaves.append(o)
        return "T"
    if dataclasses.is_dataclass(o):
        return (type(o), tuple((f.name, _spec(getattr(o, f.name), leaves))
                               for f in dataclasses.fields(o)))
    if isinstance(o, tuple):
        return (type(o), tuple(_spec(x, leaves) for x in o))
    hash(o)      # anything else is baked into the capture
    return ("=", o)


def _unflatten(spec: Hashable, leaves) -> Any:
    """The tree of ``spec`` with ``leaves`` (an iterator) in its tensors'
    places."""
    if isinstance(spec, str):
        return next(leaves)
    kind, body = spec
    if kind == "=":
        return body
    if dataclasses.is_dataclass(kind):
        return kind(**{name: _unflatten(s, leaves) for name, s in body})
    children = [_unflatten(s, leaves) for s in body]
    return tuple(children) if kind is tuple else kind(*children)


class Program:
    """One captured graph of ``fn`` over static copies of its inputs."""

    def __init__(self, fn: Callable, warmup: Callable, args: tuple):
        leaves, self.spec = _flatten(args)
        devices = {t.device for t in leaves}
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(f"a captured program takes tensors on one CUDA "
                             f"card, got {sorted(map(str, devices))}")
        dev = next(iter(devices))
        self.inputs = [t.clone() for t in leaves]
        static = _unflatten(self.spec, iter(self.inputs))
        saved = trace.launches()
        self.graph = torch.cuda.CUDAGraph()
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        try:
            with torch.cuda.device(dev), torch.cuda.stream(side):
                warmup(*static)
                warm = trace.launches()
                out = self._capture(fn, static)
            self.per_replay = [(f"launches.{k}", n)
                               for k, n in trace.launches(warm).items()]
        finally:
            for k, n in trace.launches(saved).items():
                trace.count(f"launches.{k}", -n)
        main.wait_stream(side)
        self.outputs, self.out_spec = _flatten(out)
        trace.count("graph.captures")

    def _capture(self, fn: Callable, static: tuple) -> Any:
        """``fn(*static)`` captured on the current (side) stream.
        ``torch.cuda.graph`` would also collect garbage and empty the
        allocator's cache at every capture, which costs more than the
        capture here and is not needed."""
        self.graph.capture_begin()
        try:
            out = fn(*static)
        except BaseException:
            try:
                self.graph.capture_end()
            except RuntimeError:
                pass     # the capture that failed is the error to raise
            raise
        self.graph.capture_end()
        return out

    def __call__(self, leaves: List[torch.Tensor]) -> Any:
        """Replay on the tensor leaves of inputs of this program's key."""
        with trace.span("sph.graph.copy_in"):
            torch._foreach_copy_(self.inputs, leaves)
        with trace.span("sph.graph.replay"):
            self.graph.replay()
            for k, n in self.per_replay:
                trace.count(k, n)
            trace.count("graph.replays")
        with trace.span("sph.graph.clone_out"):
            return _unflatten(self.out_spec,
                              iter([t.clone() for t in self.outputs]))


def run(static_key: Hashable, fn: Callable, warmup: Callable,
        args: tuple) -> Any:
    """``fn(*args)`` through the program of its key: captured at the first
    call (after ``warmup(*args)`` on the program's own copies), replayed
    from then on."""
    with trace.span("sph.graph.run"):
        with trace.span("sph.graph.key"):
            leaves, spec = _flatten(args)
            key = (static_key, spec,
                   tuple((tuple(t.shape), t.dtype, t.device) for t in leaves))
            prog = _PROGRAMS.get(key)
        if prog is None:
            while len(_PROGRAMS) >= MAX_PROGRAMS:
                _PROGRAMS.popitem(last=False)
            with trace.span("sph.graph.capture"):
                prog = _PROGRAMS[key] = Program(fn, warmup, args)
        else:
            _PROGRAMS.move_to_end(key)
        return prog(leaves)


def describe() -> str:
    """Which runner ran and how many programs it captured, for the tools'
    logs."""
    return (f"runner: one CUDA graph a frame (engine/graph.py), "
            f"{trace.counter('graph.captures')} captured, "
            f"{trace.counter('graph.replays')} replays, "
            f"{len(_PROGRAMS)} kept")
