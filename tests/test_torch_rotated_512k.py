"""``rotated_512k`` in the port: the wave kick's span and counter, and the
benchmark's configuration file against the published configuration.

- ``physics/impulses.wave_impulse`` lies in the span ``sph.impulse.wave``
  while spans are on and in the shared null context while they are off,
  counts ``impulses.wave`` once a call either way, and gives the same
  velocities, bit for bit, both ways;
- ``benchmark/configs/rotated_512k.json`` holds the rows, box, angles,
  physics and wave of ``app/configs.CONFIGS["rotated_512k"]``,
  ``FluidParams.default()`` and ``app/configs.frame_prologue``.

The file run through the benchmark's system and check, and the readers of
the kick's span, are ``benchmark/tests/test_benchmark_rotated_512k.py``.
"""
import dataclasses
import inspect
import json
import os

import numpy as np
import pytest
import torch

from sph_tpu_torch.app import configs
from sph_tpu_torch.core import params as TP
from sph_tpu_torch.core import state as TS
from sph_tpu_torch.core.convert import state_from_numpy
from sph_tpu_torch.physics import impulses
from sph_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAN, COUNTER = "sph.impulse.wave", "impulses.wave"


@pytest.fixture(autouse=True)
def one_torch_thread_and_spans_off():
    """One torch thread; each test starts and ends with spans off and
    nothing counted."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()
    torch.set_num_threads(n)


def _state():
    """1,024 rows of a turned box with random velocities, on the CPU."""
    spawn = TS.spawn_standard(1024, box_half=(4.0, 4.0, 4.0), seed=3,
                              box_euler_deg=(20.0, 0.0, 30.0),
                              spawn_rotation="local")
    d = {f.name: np.asarray(getattr(TS.state_from_spawn(spawn, device="cpu"),
                                    f.name))
         for f in dataclasses.fields(TS.ParticleState)}
    d["vel"] = np.random.default_rng(5).standard_normal(
        d["vel"].shape).astype(np.float32)
    return state_from_numpy(d, device="cpu")


WAVE = dict(amplitude=0.96, wavelength=4.0, phase=0.7,
            direction=(1.0, 0.0, 0.3))


def _kicks(state, calls):
    for _ in range(calls):
        state = impulses.wave_impulse(state, **WAVE)
    return state


def _labels(prof):
    return [e.name for e in prof.events() if e.name.startswith("sph.")]


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


# ---------------------------------------------------------------------------
# the kick's span and counter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("on", [False, True])
def test_the_kick_lies_in_its_span_once_a_call_and_counts(monkeypatch, on):
    entered = []
    real = trace.span

    def spy(name, args=None):
        ctx = real(name, args)
        entered.append((name, ctx is trace._NULL))
        return ctx
    monkeypatch.setattr(trace, "span", spy)
    trace.enable(on)
    with _profile() as prof:
        _kicks(_state(), 3)
    assert entered == [(SPAN, not on)] * 3
    assert _labels(prof) == ([SPAN] * 3 if on else [])
    assert trace.counter(COUNTER) == 3
    if on:
        assert trace.totals()[SPAN][1] == 3
    else:
        assert trace.totals() == {}


def test_the_frame_prologue_counts_one_kick_a_frame():
    cfg = configs.CONFIGS["rotated_512k"]
    params = TP.FluidParams.default(device="cpu").derive_mass()
    kick = configs.frame_prologue(cfg, params, 16)
    state = _state()
    for _ in range(4):
        state = kick(state)
    assert trace.counter(COUNTER) == 4
    configs.frame_prologue("default_131k", params, 16)(state)
    assert trace.counter(COUNTER) == 4


def test_the_kick_is_bit_identical_with_spans_on_and_off():
    state = _state()
    off = _kicks(state, 2).vel
    trace.enable(True)
    with _profile():
        on = _kicks(state, 2).vel
    assert torch.equal(on, off)
    assert not torch.equal(off, state.vel)


# ---------------------------------------------------------------------------
# the configuration file
# ---------------------------------------------------------------------------

def _config_file():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "rotated_512k.json")) as f:
        return json.load(f)


def test_the_file_is_the_published_configuration(monkeypatch):
    got = _config_file()
    pub = configs.CONFIGS["rotated_512k"]
    assert got["fluid_rows"] == pub.n_target == 524288
    assert got["box_half"] == list(pub.box_half)
    assert got["box_euler_deg"] == list(pub.box_euler_deg)
    assert got["h"] == pub.h and got["surface_tension"] == pub.surface_tension
    assert got["ghost_shell"] is pub.ghosts is False
    assert got["grid_cap"] == pub.grid_cap
    assert got.get("emit_rows", False) is pub.emit_rows is False
    assert pub.spawn_rotation == "local"      # the harness's box-frame spawn
    assert got["engine"] == configs.engine(pub.neighbor_impl) == "cell"
    assert got["shape"] == "box" and got["box_center"] == [0.0, 0.0, 0.0]
    assert got["reduced"] == [] and got["precision"] == "float32"
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        entry = {c["name"]: c for c in json.load(f)["configs"]}[
            "rotated_512k"]
    assert entry["reduced"] == [] and entry["source"] == got["source"]
    # the physics: FluidParams.default(), as configs.build leaves it
    params = TP.FluidParams.default(device="cpu")
    for k in ("rest_density", "gas_constant", "viscosity", "gravity", "dt",
              "foam_gen", "foam_vel_ref", "wall_restitution",
              "wall_friction", "ghost_face_active"):
        np.testing.assert_array_equal(
            np.asarray(got[k], np.float32),
            getattr(params, k).numpy().astype(np.float32), err_msg=k)
    # the spawn: spawn_standard's lattice fill and jitter
    kw = inspect.signature(TS.spawn_standard).parameters
    assert got["fill_fraction"] == kw["fill_fraction"].default
    assert got["jitter"] == kw["jitter_amp"].default
    # the wave: what frame_prologue hands wave_impulse, the amplitude
    # being strength x dt x the frame's substeps
    seen = {}
    monkeypatch.setattr(configs, "wave_impulse",
                        lambda state, **kw: seen.update(kw) or state)
    configs.frame_prologue(pub, params, 16)(None)
    wave = got["frame_prologue"]
    assert wave["kind"] == "wave"
    assert float(seen["amplitude"]) == pytest.approx(
        wave["strength"] * got["dt"] * 16, rel=1e-6)
    for k in ("wavelength", "phase"):
        assert float(seen[k]) == pytest.approx(wave[k], rel=1e-6)
    np.testing.assert_array_equal(seen["direction"].numpy(),
                                  np.asarray(wave["direction"], np.float32))
