"""The port's wireframe overlay (``viz/wireframe.py``), terrain pass
(``viz/terrain.py``), the render paths and captures of its ``Scene``, the
depth buffer of ``viz/splat.render_frame`` and ``utils/log`` against
``sph_tpu`` on the CPU: the cases of ``tests/test_wireframe_capture.py``
through both packages.

Tolerances:

- polylines, bank lines, drawn overlays and terrain frames: bit-equal to
  the JAX package's (the same numpy, the same C++ triangle rasterizer,
  the JAX one built into a directory of this module's);
- ``render_frame`` with ``return_depth``: the depth buffer equal, the
  frame within 1/255 (the colors within 1e-5 may round to the next level);
- the scene's frames: the port's own invariants (the JAX package's
  frames of the same state are held in ``tests/test_torch_scene_class.py``).
"""
import ctypes
import dataclasses
import os
import subprocess

import numpy as np
import pytest
import torch

from sph_tpu import native as jax_native
from sph_tpu.core import state as JS
from sph_tpu.scene import river as JRV
from sph_tpu.utils import log as JLOG
from sph_tpu.viz import palettes as JP
from sph_tpu.viz import splat as JSPLAT
from sph_tpu.viz import terrain as JT
from sph_tpu.viz import wireframe as JWF
from sph_tpu.viz.camera import fit_camera
from sph_tpu_torch.core.convert import state_from_numpy
from sph_tpu_torch.scene import river as TRV
from sph_tpu_torch.scene.scene import Scene
from sph_tpu_torch.scene.settings import SceneSettings
from sph_tpu_torch.utils import log as TLOG
from sph_tpu_torch.viz import palettes as TP
from sph_tpu_torch.viz import splat as TSPLAT
from sph_tpu_torch.viz import terrain as TT
from sph_tpu_torch.viz import wireframe as TWF
from sph_tpu_torch.viz.splat import read_png


@pytest.fixture(scope="module")
def jax_libs(tmp_path_factory):
    """The JAX package's host rasterizers built from its own sources into
    a directory of this module's (``sph_tpu.native.load`` would build into
    the package's ``_build/``, which another test process may be
    writing)."""
    out = {}
    d = tmp_path_factory.mktemp("jax_native")
    for name in ("tri_raster", "splat_raster"):
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


def small_settings(**kw):
    s = SceneSettings()
    s.particle_count = 512
    s.box_half = [4.0, 4.0, 4.0]
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def scene(seed=1, **kw):
    return Scene(settings=small_settings(**kw), seed=seed, device="cpu")


def assert_lines_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", list(range(10)))
def test_shape_polylines_all_shapes(shape):
    for half, aux in (((4.0, 4.0, 4.0), (5.0, 0.35, 2.5)),
                      ((6.0, 2.2, 1.4), (7.0, 0.6, 1.1))):
        lines = TWF.shape_polylines(shape, half, aux)
        assert_lines_equal(lines, JWF.shape_polylines(shape, half, aux))
    pts = np.concatenate(TWF.shape_polylines(shape, (4.0, 4.0, 4.0)))
    assert len(pts) > 0 and np.isfinite(pts).all()
    assert np.abs(pts).max() < 16.0


def test_container_wireframe_rotates():
    for euler in ((0, 0, 0), (0, 0, 45.0), (20.0, -35.0, 10.0)):
        assert_lines_equal(
            TWF.container_wireframe(3, (4, 2, 1), (1, -2, 0.5), euler),
            JWF.container_wireframe(3, (4, 2, 1), (1, -2, 0.5), euler))
    a = np.concatenate(TWF.container_wireframe(0, (4, 2, 1), (0, 0, 0),
                                               (0, 0, 0)))
    b = np.concatenate(TWF.container_wireframe(0, (4, 2, 1), (0, 0, 0),
                                               (0, 0, 45.0)))
    assert not np.allclose(a, b)
    assert np.allclose(np.linalg.norm(a, axis=1).max(),
                       np.linalg.norm(b, axis=1).max(), rtol=1e-5)


def test_draw_polylines_marks_pixels():
    cam = fit_camera([4.0, 4.0, 4.0])
    img = np.random.default_rng(0).integers(0, 60, (120, 160, 3)) \
        .astype(np.uint8)
    lines = TWF.container_wireframe(0, (4, 4, 4), (0, 0, 0), (0, 0, 0))
    lines.append(np.zeros((1, 3), np.float32))          # too short to draw
    args = (lines, cam.view_matrix(), cam.proj_matrix(160 / 120))
    out = TWF.draw_polylines(img, *args, color=(1.0, 0.0, 0.0))
    np.testing.assert_array_equal(
        out, JWF.draw_polylines(img, *args, color=(1.0, 0.0, 0.0)))
    assert out.shape == img.shape
    assert (out[..., 0] > 100).sum() > 50
    assert (out[..., 1] > 100).sum() == 0


def test_river_bank_lines():
    for seed in (3, 11):
        spec = TRV.RiverSpec.random(seed)
        banks = TWF.river_bank_lines(spec, (0, 0, 0), (7, 7, 7))
        assert_lines_equal(banks, JWF.river_bank_lines(
            JRV.RiverSpec.random(seed), (0, 0, 0), (7, 7, 7)))
        assert len(banks) == 2
        for b in banks:
            assert b.shape == (64, 3) and np.isfinite(b).all()
            assert np.abs(b[:, 2]).max() <= 7.0 + 1e-5


def test_render_mode_paths_differ():
    sc = scene(show_outline=False)
    sc.update(1 / 60)
    frames = []
    for mode in (1, 0, 2):
        sc.settings.render_mode = mode
        frames.append(sc.render(160, 120))
    for img in frames:
        assert img.shape == (120, 160, 3) and img.dtype == np.uint8
    assert not np.array_equal(frames[0], frames[1])
    assert not np.array_equal(frames[0], frames[2])


def test_render_outline_overlay_changes_frame():
    sc = scene(render_mode=1)
    sc.settings.show_outline = False
    off = sc.render(160, 120)
    sc.settings.show_outline = True
    on = sc.render(160, 120)
    assert not np.array_equal(off, on)


def test_capture_writes_png(tmp_path):
    sc = scene(render_mode=1, show_outline=True)
    p = str(tmp_path / "sub" / "shot.png")
    assert sc.capture(p, size="window", width=96, height=64,
                      supersample=2) == (96, 64)
    img = read_png(p)
    assert img.shape == (64, 96, 3) and (img != img[0, 0]).any()
    # the capture is the 2x render box-filtered
    big = sc.render(192, 128)
    np.testing.assert_array_equal(
        img, big.reshape(64, 2, 96, 2, 3).mean(axis=(1, 3)).astype(np.uint8))


def test_capture_post_active_disables_supersample(tmp_path):
    sc = scene(render_mode=1)
    sc.settings.kaleido_segments = 6
    calls = {}
    orig = sc.render

    def spy(w, h, apply_post=True):
        calls["size"] = (w, h)
        return orig(w, h, apply_post=apply_post)

    sc.render = spy
    sc.capture(str(tmp_path / "cap.png"), size="window", width=64,
               height=48)
    assert calls["size"] == (64, 48)


def test_capture_trail_warmup(tmp_path):
    """Trails on: the capture renders ``trail_warmup_frames`` frames
    first, each after a frame of physics, at the supersampled size (the
    JAX package warms up at the output size, and its trail then fails to
    broadcast against the 2x frame: a deviation, CHANGES.md)."""
    sc = scene(render_mode=1, show_outline=False)
    sc.settings.trail_half_life = 0.4
    frames = []
    orig = sc.render

    def spy(w, h, apply_post=True):
        frames.append((w, h))
        return orig(w, h, apply_post=apply_post)

    sc.render = spy
    t0 = sc.sim_time
    sc.capture(str(tmp_path / "t.png"), width=48, height=32,
               trail_warmup_frames=3)
    assert frames == [(96, 64)] * 4
    assert sc.sim_time == pytest.approx(t0 + 3 / 60)
    assert sc.post_state.trail is not None


@pytest.mark.parametrize("mod", [TLOG, JLOG], ids=["port", "jax"])
def test_logger_roundtrip(tmp_path, mod):
    p = str(tmp_path / "log.txt")
    mod.init(p, min_level=mod.INFO)
    mod.trace("hidden")
    mod.info("hello")
    mod.warning("warn")
    mod.error("bad")
    with pytest.raises(mod.EngineFatalError):
        mod.fatal("boom")
    mod.init(None)
    text = open(p).read()
    for word in ("INFO: hello", "WARNING: warn", "ERROR: bad",
                 "FATAL: boom"):
        assert word in text
    assert "hidden" not in text
    assert TLOG._NAMES == JLOG._NAMES


def test_dof_applies_with_scene_depth_in_impostor_mode():
    sc = scene(seed=2, render_mode=1, show_outline=False)
    sc.update(1 / 60)
    base = sc.render(160, 120)
    sc.settings.lens_aperture = 3.0
    sc.settings.lens_focus_dist = 5.0
    dof = sc.render(160, 120)
    assert not np.array_equal(base, dof)
    # water writes no scene depth: DOF leaves its frame as it is
    sc.settings.render_mode = 0
    water_dof = sc.render(160, 120)
    sc.settings.lens_aperture = 0.0
    np.testing.assert_array_equal(water_dof, sc.render(160, 120))


def test_render_depth_buffer():
    spawn = JS.spawn_standard(256, h=0.28, box_half=(4.0, 4.0, 4.0), seed=1)
    jst = JS.state_from_spawn(spawn)
    st = state_from_numpy({f.name: np.asarray(getattr(jst, f.name))
                           for f in dataclasses.fields(jst)}, device="cpu")
    cam = fit_camera(np.asarray([4.0, 4.0, 4.0]))
    bg = np.random.default_rng(2).integers(0, 256, (120, 160, 3)) \
        .astype(np.uint8)
    mask = np.arange(st.n) % 2 == 0
    for kw in (dict(), dict(background=bg, mask=mask)):
        img, z = TSPLAT.render_frame(st, TP.VizParams(), cam, width=160,
                                     height=120, return_depth=True, **kw)
        jimg, jz = JSPLAT.render_frame(jst, JP.VizParams(), cam, width=160,
                                       height=120, return_depth=True, **kw)
        np.testing.assert_array_equal(z, jz)
        assert np.abs(img.astype(int) - jimg.astype(int)).max() <= 1
        pimg, pz = TSPLAT.render_frame_plain(st, TP.VizParams(), cam,
                                             width=160, height=120,
                                             return_depth=True, **kw)
        assert ((pz > 0) == (z > 0)).mean() > 0.98
    covered = z > 0
    assert z.shape == (120, 160) and covered.sum() > 50
    assert z[covered].min() > 1.0 and z[covered].max() < 200.0
    none = TSPLAT.render_frame(st, TP.VizParams(), cam, width=160,
                               height=120, return_depth=True,
                               mask=np.zeros(st.n, bool))
    assert (none[1] == 0).all() and (none[0] == none[0][0, 0]).all()


def test_terrain_renderer():
    th = np.zeros((16, 16), np.float32)
    th[:, 8:] = 2.0
    pos, nrm = TT.terrain_points(th, (0, 0, 0), (5, 5, 5), upsample=2)
    jpos, jnrm = JT.terrain_points(th, (0, 0, 0), (5, 5, 5), upsample=2)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(nrm, jnrm)
    np.testing.assert_array_equal(
        TT.terrain_colors(pos[:, 1], nrm, (0.4, 1.0, 0.5), (1, 0.9, 0.8)),
        JT.terrain_colors(pos[:, 1], nrm, (0.4, 1.0, 0.5), (1, 0.9, 0.8)))
    assert np.allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-5)
    flat = np.abs(pos[:, 0]) > 3.0
    assert np.abs(nrm[flat][:, 1] - 1.0).max() < 1e-4
    cam = fit_camera([5.0, 5.0, 5.0])
    img = np.zeros((90, 160, 3), np.uint8)
    args = (th, (0, 0, 0), (5, 5, 5), cam.view_matrix(),
            cam.proj_matrix(160 / 90))
    out, zbuf = TT.draw_terrain(img, *args, return_depth=True)
    jout, jzbuf = JT.draw_terrain(img, *args, return_depth=True)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(zbuf, jzbuf)
    np.testing.assert_array_equal(out, TT.draw_terrain(img, *args))
    lit = out.sum(-1) > 0
    assert lit.sum() > 100
    span = lit_in_span = 0
    for row in lit:
        xs = np.nonzero(row)[0]
        if len(xs):
            span += xs.max() - xs.min() + 1
            lit_in_span += len(xs)
    assert lit_in_span / span > 0.93


def test_river_terrain_frame_matches_jax():
    """The river's generated terrain drawn by both packages, upsampled 3x
    (the scene's pass)."""
    spec = TRV.RiverSpec.random(6)
    terrain = TRV.generate_river_terrain(spec, (0, 0, 0), (4, 4, 4),
                                         res=(32, 32))
    cam = fit_camera([4.0, 4.0, 4.0])
    img = np.full((90, 160, 3), 20, np.uint8)
    args = (terrain, (0, 0, 0), (4, 4, 4), cam.view_matrix(),
            cam.proj_matrix(160 / 90))
    np.testing.assert_array_equal(TT.draw_terrain(img, *args),
                                  JT.draw_terrain(img, *args))


def test_river_scene_renders_terrain():
    sc = scene(seed=6, render_mode=1, particle_count=256, show_outline=False)
    sc.settings.bg_color = [0.0, 0.0, 0.0]
    no_river = sc.render(160, 90)
    sc.enable_river(6)
    sc.update(1 / 60)
    with_river = sc.render(160, 90)
    assert (with_river.sum(-1) > 0).mean() > (no_river.sum(-1) > 0).mean()
    sc.settings.show_outline = True
    assert not np.array_equal(sc.render(160, 90), with_river)
