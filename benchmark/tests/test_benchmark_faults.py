"""A run on the CPU, at a small size, with the timed path broken
underneath: ``correct`` comes out false for each fault a cell can have,
and true for the path as it is.  The run's look for a card is skipped
(``run.execute`` is the run without it); the limits are the repo's.  The
small cell's rows aerate from the first frame, so foam is compared."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmark import cells, control, run, system
from sph_tpu_torch.engine import step
from sph_tpu_torch.viz import splat

SEED = 2**31 + 4242


def _run(root, cell="tiny.sim16"):
    return run.execute(cells.load(cell, root=root), SEED, 0.3, False, "cpu")


def _realign(new, old):
    """``old``'s rows in ``new``'s order (by ``orig_id``)."""
    where = torch.empty_like(old.orig_id, dtype=torch.long)
    where[old.orig_id.long()] = torch.arange(old.n)
    idx = where[new.orig_id.long()]
    return old.replace(**{f.name: getattr(old, f.name)[idx]
                          for f in dataclasses.fields(old)})


def _unchanged(state, params, buffers, dt, n, config):
    return state, buffers


def _half_left_out(real):
    def broken(state, params, buffers, dt, n, config):
        out, buffers = real(state, params, buffers, dt, n, config)
        old = _realign(out, state)
        keep = (torch.arange(out.n) % 2 == 0)
        pick = lambda a, b: torch.where(  # noqa: E731
            keep.reshape(-1, *[1] * (a.dim() - 1)), a, b)
        return out.replace(**{f.name: pick(getattr(out, f.name),
                                           getattr(old, f.name))
                              for f in dataclasses.fields(out)}), buffers
    return broken


def _answer_altered(real):
    """The frame's answer written 0.01 (h / 28) off in x, every fluid
    row."""
    def broken(state, params, buffers, dt, n, config):
        out, buffers = real(state, params, buffers, dt, n, config)
        fluid = ((out.ghost == 0) & (out.valid > 0))[:, None]
        shift = torch.tensor([0.01, 0.0, 0.0])
        return out.replace(pos=torch.where(fluid, out.pos + shift,
                                           out.pos)), buffers
    return broken


def _image_block(real):
    def broken(*args, **kw):
        img = np.array(real(*args, **kw))
        img[100:140, 200:240] = 255 - img[100:140, 200:240]
        return img
    return broken


def test_sound_run_is_correct(tiny_root):
    out = _run(tiny_root())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"particle_steps_per_s", "frame_ms_p95",
                                   "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out",
                                   "answer_altered"])
def test_broken_substeps_are_caught(tiny_root, monkeypatch, fault):
    real = step.run_substeps
    broken = {"unchanged": lambda: _unchanged,
              "half_left_out": lambda: _half_left_out(real),
              "answer_altered": lambda: _answer_altered(real)}[fault]()
    monkeypatch.setattr(step, "run_substeps", broken)
    out = _run(tiny_root())
    assert not out["correct"]
    assert out["failed"] >= 1


@pytest.mark.parametrize("fault", [None] + sorted(set(control.FAULTS)
                                                  - {"prologue"}))
def test_planted_faults_are_caught(tiny_root, monkeypatch, fault):
    """``control.FAULTS``, as ``python3 -m benchmark.control --fault``
    plants them on the card: one side face's ghosts off, foam left as it
    came in (the prologue's fault is planted in a cell with a prologue,
    below).  Eight warm-up frames, so that the rows have spread to the
    side walls, as they have in a cell's window; the sound run with them
    is correct."""
    root = tiny_root()
    path = os.path.join(root, "benchmark", "traffic", "sim16.json")
    with open(path) as f:
        traffic = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(traffic, warmup_frames=8), f)
    if fault:
        real = system.System.__init__

        def broken(self, *args, **kw):
            real(self, *args, **kw)
            control.plant(self, fault)
        monkeypatch.setattr(system.System, "__init__", broken)
    out = _run(root)
    if fault is None:
        assert out["correct"], out["checks"]
        return
    assert not out["correct"]
    name = {"face": "pos_apart", "foam": "foam_gap"}[fault]
    assert out["checks"][name]["value"] > out["checks"][name]["limit"]


WAVED = dict(fluid_rows=4096, box_half=[3.5, 3.5, 3.5],
             box_euler_deg=[20.0, 0.0, 30.0],
             frame_prologue={"kind": "wave", "strength": 60.0,
                             "wavelength": 4.0, "phase": 0.7,
                             "direction": [1.0, 0.0, 0.3]})


def _waved_root(tiny_root, **changes):
    """A rotated box with the wave prologue, ``rotated_512k``'s published
    settings at 4,096 rows, under the limits of ``default_131k.sim16``."""
    return tiny_root(config="default_131k", limits_of="default_131k.sim16",
                     **dict(WAVED, **changes))


@pytest.mark.parametrize("emit_rows", [False, True])
def test_sound_rotated_waved_run_is_correct(tiny_root, monkeypatch,
                                            emit_rows):
    """The prologue runs once a frame, under its own span, and the
    reference's frame starts with the same kick."""
    kicks = []
    real = system.System.prologue
    monkeypatch.setattr(system.System, "prologue", lambda self, st: (
        kicks.append(1), real(self, st))[1])
    root = _waved_root(tiny_root, emit_rows=emit_rows)
    cell = cells.load("tiny.sim16", root=root)
    out = run.execute(cell, SEED, 0.3, False, "cpu")
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    warm = int(cell.traffic["warmup_frames"])
    assert len(kicks) == warm + out["attempted"]


def test_skipped_prologue_is_caught(tiny_root, monkeypatch):
    """``control.FAULTS["prologue"]``: the port's frames without their
    wave kick, the reference's with it."""
    real = system.System.__init__

    def broken(self, *args, **kw):
        real(self, *args, **kw)
        control.plant(self, "prologue")
    monkeypatch.setattr(system.System, "__init__", broken)
    out = _run(_waved_root(tiny_root))
    assert not out["correct"]
    assert out["checks"]["vel_apart"]["value"] > \
        out["checks"]["vel_apart"]["limit"]


def test_prologue_fault_needs_a_prologue(tiny_root):
    cell = cells.load("tiny.sim16", root=tiny_root())
    sysm = system.System(cell.config, cell.traffic,
                         run.spawn.spawn(cell.config, SEED), "cpu")
    with pytest.raises(ValueError, match="no frame prologue"):
        control.plant(sysm, "prologue")


def test_sound_export_is_correct(tiny_root):
    out = _run(tiny_root(), "tiny.export16")
    assert out["correct"], out["checks"]
    assert out["checks"]["px_apart"]["value"] == 0.0


@pytest.mark.parametrize("where", ["render_frame", "save_png"])
def test_broken_export_is_caught(tiny_root, monkeypatch, where):
    if where == "render_frame":
        monkeypatch.setattr(splat, "render_frame",
                            _image_block(splat.render_frame))
    else:
        real = splat.save_png
        monkeypatch.setattr(splat, "save_png", lambda img, path: real(
            _image_block(lambda: img)(), path))
    out = _run(tiny_root(), "tiny.export16")
    assert not out["correct"]
    assert out["checks"]["px_apart"]["value"] > 1e-3
