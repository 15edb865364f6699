"""The port's reel export (``scene/reel.py``: ``export_reel``,
``preview_size``, ``preview_reel``, the mux script) against
``sph_tpu.scene.reel`` on the CPU: the remaining cases of
``tests/test_river_reel.py`` through both packages, at the JAX suite's
size (4 frames at 64x96 and 1,000 asked rows, the default look: SSFR
water with five rounds of smoothing and the outline), with 1/240 s
substeps.

Tolerances:

- two reels of the port from the same scene settings and bands:
  bit-identical PNGs;
- the port's reel against the JAX package's: in each frame, at most
  ``REEL_SHARE`` (1%) of the pixels have a channel more than 1/255 apart.
  The two packages' exact engines drift apart by rounding (by 7e-5 in
  position after 4 frames, ``tests/test_torch_scene_class.py``), which can
  move a splat's edge across a pixel; on this file's reel the first three
  frames are equal and the fourth differs by up to 4/255 on 0.08% of its
  pixels (measured);
- the mux script: the same text as the JAX package's for the same
  configuration.
"""
import ctypes
import dataclasses
import os
import subprocess

import numpy as np
import pytest
import torch

from sph_tpu import native as jax_native
from sph_tpu.audio.analyze import ReelAnalysis as JReelAnalysis
from sph_tpu.scene import reel as JREEL
from sph_tpu.scene.scene import Scene as JScene
from sph_tpu.scene.settings import SceneSettings as JSettings
from sph_tpu_torch.audio.analyze import ReelAnalysis
from sph_tpu_torch.scene import reel as TREEL
from sph_tpu_torch.scene.scene import Scene
from sph_tpu_torch.scene.settings import SceneSettings
from sph_tpu_torch.viz.splat import read_png

REEL_SHARE = 0.01
W, H = 64, 96


@pytest.fixture(scope="module")
def jax_libs(tmp_path_factory):
    """The JAX package's host rasterizers built from its own sources into
    a directory of this module's (``sph_tpu.native.load`` would build into
    the package's ``_build/``, which another test process may be
    writing)."""
    out = {}
    d = tmp_path_factory.mktemp("jax_native")
    for name in ("tri_raster", "splat_raster", "audio_dsp"):
        src = os.path.join(os.path.dirname(jax_native.__file__),
                           f"{name}.cpp")
        so = str(d / f"{name}.so")
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src,
                        "-o", so], check=True, capture_output=True)
        out[name] = ctypes.CDLL(so)
    return out


@pytest.fixture(autouse=True)
def jax_native_libs(jax_libs, monkeypatch):
    for name, lib in jax_libs.items():
        monkeypatch.setitem(jax_native._CACHE, name, lib)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several processes at once, where each process's pool of torch
    threads spins against the others' (a file took 15 times as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synthetic(cls, n_frames=4):
    a = cls(frame_count=n_frames, sample_rate=48000)
    a.bass = np.linspace(0.2, 1.0, n_frames).astype(np.float32)
    a.mid = np.full(n_frames, 0.3, np.float32)
    a.treble = np.full(n_frames, 0.1, np.float32)
    return a


def settings(cls):
    s = cls()
    s.particle_count = 1000
    s.audio_enabled = True
    # 8 substeps in every frame (the JAX suite's 4e-3 s gives 8 or 9, and
    # the JAX package compiles its substep loop once for each count)
    s.time_step = 1.0 / 240.0
    return s


def port_reel(out_dir, n_frames=4, **cfg):
    scene = Scene(settings=settings(SceneSettings), seed=1, device="cpu")
    return TREEL.export_reel(
        scene, TREEL.ReelConfig(track_path="", out_dir=str(out_dir), fps=30,
                                width=W, height=H, **cfg),
        analysis=synthetic(ReelAnalysis, n_frames))


def frames(out_dir, n):
    return [read_png(os.path.join(out_dir, f"frame_{f:05d}.png"))
            for f in range(n)]


def assert_reels_close(got, want):
    for f, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape == (H, W, 3)
        off = (np.abs(a.astype(int) - b.astype(int)) > 1).any(-1).mean()
        assert off <= REEL_SHARE, (f, off)


@pytest.fixture(scope="module")
def reels(tmp_path_factory):
    """Two reels of the port and one of the JAX package, each from a
    fresh scene with seed 1."""
    root = tmp_path_factory.mktemp("reels")
    out = {k: port_reel(root / k) for k in ("a", "b")}
    jscene = JScene(settings=settings(JSettings), neighbor_impl="cell",
                    seed=1)
    out["jax"] = JREEL.export_reel(
        jscene, JREEL.ReelConfig(track_path="", out_dir=str(root / "jax"),
                                 fps=30, width=W, height=H),
        analysis=synthetic(JReelAnalysis))
    return root, out


def test_reel_export_deterministic(reels):
    root, out = reels
    for k in ("a", "b"):
        assert out[k].ok and out[k].frames_written == 4
        assert os.path.exists(out[k].mux_script)
    for a, b in zip(frames(root / "a", 4), frames(root / "b", 4)):
        np.testing.assert_array_equal(a, b)


def test_reel_matches_jax(reels):
    root, out = reels
    assert out["jax"].ok and out["jax"].frames_written == 4
    assert out["a"].drops == out["jax"].drops
    got = frames(root / "a", 4)
    assert_reels_close(got, frames(root / "jax", 4))
    for img in got:
        assert (img != img[0, 0]).any()       # water and outline drawn


def test_mux_script_matches_jax(tmp_path):
    for track in ("", "song.wav"):
        cfgs = [mod.ReelConfig(track_path=track, out_dir=str(tmp_path / k),
                               fps=24)
                for mod, k in ((TREEL, "port"), (JREEL, "jax"))]
        for c in cfgs:
            os.makedirs(c.out_dir, exist_ok=True)
        got = TREEL._write_mux_script(cfgs[0])
        want = JREEL._write_mux_script(cfgs[1])
        assert open(got).read() == open(want).read()
        assert os.access(got, os.X_OK)


def test_reel_config_and_result_match():
    assert [(f.name, f.default) for f in dataclasses.fields(
        TREEL.ReelConfig) if f.name != "auto_sequence_presets"] == \
        [(f.name, f.default) for f in dataclasses.fields(JREEL.ReelConfig)
         if f.name != "auto_sequence_presets"]
    assert TREEL.RESOLUTIONS == JREEL.RESOLUTIONS
    assert not TREEL.ReelResult().ok


def test_reel_export_bad_track(tmp_path):
    scene = Scene(settings=settings(SceneSettings), device="cpu")
    r = TREEL.export_reel(scene, TREEL.ReelConfig(
        track_path="missing.ogg", out_dir=str(tmp_path)))
    assert not r.ok and r.error
    assert not os.path.exists(tmp_path / "frame_00000.png")


def test_reel_drop_sequencer_and_supersample(tmp_path):
    """Drop presets cue the sequencer; supersample 2 renders at twice the
    size and box-filters; the substep cap limits each frame."""
    pdir = tmp_path / "presets"
    pdir.mkdir()
    from sph_tpu_torch.io import presets as pio
    from sph_tpu_torch.scene.settings import gather_preset
    hot = SceneSettings()
    hot.palette_id = 9
    pio.save_file(str(pdir / "hot.txt"), gather_preset(hot))
    scene = Scene(settings=settings(SceneSettings), seed=1,
                  preset_dir=str(pdir), device="cpu")
    a = synthetic(ReelAnalysis, 3)
    a.bass = np.asarray([0.1, 2.0, 2.0], np.float32)
    r = TREEL.export_reel(
        scene, TREEL.ReelConfig(track_path="", out_dir=str(tmp_path / "o"),
                                fps=30, width=W, height=H, supersample=2,
                                substep_cap=2,
                                auto_sequence_presets=["hot"]),
        analysis=a)
    assert r.ok and r.drops == [pytest.approx(1 / 30)]
    assert scene.sequencer.enabled and scene.settings.palette_id == 9
    assert frames(tmp_path / "o", 3)[2].shape == (H, W, 3)
    assert scene.sim_time == pytest.approx(3 / 30)


def test_preview_size_fit():
    for args in ((1080, 1920, 960, 540), (1920, 1080, 960, 540),
                 (1920, 1080, 500, 540), (1080, 1920, 1, 1),
                 (1080, 1350, 700, 700)):
        assert TREEL.preview_size(*args) == JREEL.preview_size(*args)
    assert TREEL.preview_size(1080, 1920, 960, 540) == (304, 540)
    assert TREEL.preview_size(1080, 1920, 1, 1) == (2, 2)


def test_reel_preview_reduced_res(tmp_path):
    scene = Scene(settings=settings(SceneSettings), seed=1, device="cpu")
    cfg = TREEL.ReelConfig(track_path="", out_dir=str(tmp_path / "reel"),
                           fps=30, width=1080, height=1920, supersample=2)
    r = TREEL.preview_reel(scene, cfg, window_w=96, window_h=64,
                           analysis=synthetic(ReelAnalysis, 2))
    assert r.ok and r.frames_written == 2
    img = read_png(str(tmp_path / "reel_preview" / "frame_00000.png"))
    assert img.shape == (64, 36, 3)
    assert not os.path.exists(tmp_path / "reel")
