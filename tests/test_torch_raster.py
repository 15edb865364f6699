"""The port's triangle rasterizer and mesh assets (``viz/raster.py``,
``native/tri_raster.cpp``) and its instanced-mesh render
(``viz/splat.render_frame_mesh``) against ``sph_tpu.viz`` on the CPU, the
cases of ``tests/test_raster.py`` through both packages.

Tolerances:

- the host rasterizer (``rasterize``): bit-equal to its plain version
  (``rasterize_plain``, the same float32 operations in the same order) and
  to the JAX package's (the same C++, built by each package from its own
  copy; the JAX one into a directory of this module's), image and z-buffer;
- mesh assets, projection and the instanced draw: bit-equal (the same
  numpy over the same rasterizer);
- ``render_frame_mesh``: no channel more than 1/255 from the JAX
  package's (the colors within 1e-5, ``tests/test_torch_viz.py``, may round
  to the next level), the depth equal.
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
from sph_tpu.viz import palettes as JP
from sph_tpu.viz import raster as JR
from sph_tpu.viz import splat as JSPLAT
from sph_tpu.viz.camera import fit_camera
from sph_tpu_torch.core.convert import state_from_numpy
from sph_tpu_torch.viz import palettes as TP
from sph_tpu_torch.viz import raster as TR
from sph_tpu_torch.viz import splat as TSPLAT


@pytest.fixture(scope="module")
def jax_tri(tmp_path_factory):
    """The JAX package's triangle rasterizer built from its own source
    into a directory of this module's (``sph_tpu.native.load`` would build
    into the package's ``_build/``, which another test process may be
    writing, and fall back to numpy if that failed)."""
    src = os.path.join(os.path.dirname(jax_native.__file__),
                       "tri_raster.cpp")
    out = str(tmp_path_factory.mktemp("jax_native") / "tri_raster.so")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src,
                    "-o", out], check=True, capture_output=True)
    return ctypes.CDLL(out)


@pytest.fixture(autouse=True)
def jax_native_lib(jax_tri, monkeypatch):
    monkeypatch.setitem(jax_native._CACHE, "tri_raster", jax_tri)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several processes at once, where each process's pool of torch
    threads spins against the others' (a file took 15 times as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def buffers(h, w):
    return np.zeros((h, w, 3), np.float32), np.full((h, w), np.inf,
                                                    np.float32)


def draw_all(h, w, *args):
    """The same draw through the port's rasterizer, its plain version and
    the JAX package's: three (img, zbuf) pairs."""
    out = []
    for fn in (TR.rasterize, TR.rasterize_plain, JR.rasterize):
        img, z = buffers(h, w)
        fn(img, z, *args)
        out.append((img, z))
    return out


def assert_same(pairs):
    for img, z in pairs[1:]:
        np.testing.assert_array_equal(img, pairs[0][0])
        np.testing.assert_array_equal(z, pairs[0][1])


def test_triangle_fill_and_ztest():
    px = np.array([4, 60, 32, 4, 60, 32], np.float32)
    py = np.array([4, 4, 60, 4, 4, 60], np.float32)
    d = np.array([10, 10, 10, 5, 5, 5], np.float32)
    col = np.array([[1, 0, 0]] * 3 + [[0, 1, 0]] * 3, np.float32)
    pairs = draw_all(64, 64, px, py, d, col,
                     np.array([[0, 1, 2], [3, 4, 5]], np.int32))
    assert_same(pairs)
    img, z = pairs[0]
    assert (img.sum(-1) > 0).sum() > 600
    assert img[10, 32, 1] == pytest.approx(255.0)
    assert img[10, 32, 0] == 0.0
    assert np.isclose(z[10, 32], 5.0)


@pytest.mark.parametrize("seed", range(4))
def test_plain_and_jax_match_native(seed):
    """Random overlapping triangles, some wound either way, some off the
    image, some degenerate and some with a vertex behind the eye: the three
    rasterizers give the same bits."""
    rng = np.random.default_rng(seed)
    v = 3 * 96
    px = rng.uniform(-20, 100, v).astype(np.float32)
    py = rng.uniform(-20, 80, v).astype(np.float32)
    d = rng.uniform(1, 6, v).astype(np.float32)
    d[rng.random(v) < 0.03] = 0.0                  # behind the eye
    px[3:6] = px[3]                                # a degenerate triangle
    col = rng.random((v, 3)).astype(np.float32)
    tris = rng.permutation(v).reshape(-1, 3).astype(np.int32)
    pairs = draw_all(64, 96, px, py, d, col, tris)
    assert_same(pairs)
    assert np.isfinite(pairs[0][1]).sum() > 1000


def test_perspective_correct_depth_interpolation():
    px = np.array([0, 31, 0], np.float32)
    py = np.array([16, 16, 17], np.float32)
    d = np.array([2.0, 8.0, 2.0], np.float32)
    pairs = draw_all(32, 32, px, py, d, np.ones((3, 3), np.float32),
                     np.array([[0, 1, 2]], np.int32))
    assert_same(pairs)
    row = pairs[0][1][16]
    mid = row[np.isfinite(row)][np.isfinite(row).sum() // 2]
    assert 2.0 < mid < 5.0


def test_rasterize_refuses_other_buffers():
    img, z = buffers(8, 8)
    args = (np.zeros(3, np.float32),) * 3 + (np.zeros((3, 3), np.float32),
                                            np.zeros((1, 3), np.int32))
    with pytest.raises(ValueError, match="float32"):
        TR.rasterize(img.astype(np.float64), z, *args)
    with pytest.raises(ValueError, match="float32"):
        TR.rasterize(img[:, ::2], z[:, ::2], *args)


def test_load_obj_and_fan_triangulation(tmp_path):
    obj = tmp_path / "quad.obj"
    obj.write_text("# comment\n"
                   "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                   "f 1/1/1 2/2/2 3/3/3 4/4/4\nf -1 -2 -3\n")
    verts, tris = TR.load_obj(str(obj))
    jv, jt = JR.load_obj(str(obj))
    np.testing.assert_array_equal(verts, jv)
    np.testing.assert_array_equal(tris, jt)
    np.testing.assert_array_equal(tris, [[0, 1, 2], [0, 2, 3], [3, 2, 1]])
    empty = tmp_path / "empty.obj"
    empty.write_text("# nothing\n")
    with pytest.raises(ValueError, match="no geometry"):
        TR.load_obj(str(empty))


@pytest.mark.parametrize("subdiv", [0, 1, 2])
def test_icosphere_is_unit_and_closed(subdiv):
    v, t = TR.icosphere(subdiv)
    jv, jt = JR.icosphere(subdiv)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-6)
    assert len(t) == 20 * 4 ** subdiv
    edges = {}
    for a, b, c in t:
        for e in ((a, b), (b, c), (c, a)):
            k = (min(e), max(e))
            edges[k] = edges.get(k, 0) + 1
    assert all(n == 2 for n in edges.values())


def test_grid_mesh_and_projection_match():
    np.testing.assert_array_equal(TR.grid_mesh_tris(5, 7),
                                  JR.grid_mesh_tris(5, 7))
    cam = fit_camera(np.array([2.0, 2.0, 2.0], np.float32))
    pos = np.random.default_rng(1).uniform(-30, 30, (500, 3)) \
        .astype(np.float32)
    for a, b in zip(TR.project_to_screen(pos, cam.view_matrix(),
                                         cam.proj_matrix(1.5), 96, 64),
                    JR.project_to_screen(pos, cam.view_matrix(),
                                         cam.proj_matrix(1.5), 96, 64)):
        np.testing.assert_array_equal(a, b)


def test_draw_mesh_instances_renders_and_occludes():
    cam = fit_camera(np.array([2.0, 2.0, 2.0], np.float32))
    centers = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, -1.5]], np.float32)
    cols = np.array([[1, 0, 0], [0, 1, 0]], np.float32)
    out = []
    for mod in (TR, JR):
        img, z = buffers(96, 128)
        mod.draw_mesh_instances(img, z, centers, 0.9, cols,
                                cam.view_matrix(), cam.proj_matrix(128 / 96))
        out.append((img, z))
    assert_same(out)
    img = out[0][0]
    filled = img.sum(-1) > 0
    assert filled.sum() > 50
    h, w = np.nonzero(filled)
    cy, cx = int(np.mean(h)), int(np.mean(w))
    assert img[cy, cx, 0] > img[cy, cx, 1]


def test_draw_mesh_instances_in_chunks():
    """More instances than a chunk, radii per instance, an OBJ mesh: the
    same bits as the JAX package's."""
    rng = np.random.default_rng(2)
    cam = fit_camera(np.array([3.0, 3.0, 3.0], np.float32))
    centers = rng.uniform(-3, 3, (300, 3)).astype(np.float32)
    radii = rng.uniform(0.05, 0.3, 300).astype(np.float32)
    cols = rng.random((300, 3)).astype(np.float32)
    mesh = TR.icosphere(0)
    out = []
    for mod in (TR, JR):
        img, z = buffers(72, 96)
        mod.draw_mesh_instances(img, z, centers, radii, cols,
                                cam.view_matrix(), cam.proj_matrix(96 / 72),
                                mesh=mesh, sun_dir=(0.2, 1.0, -0.4),
                                chunk=64)
        out.append((img, z))
    assert_same(out)


def test_render_frame_mesh_matches_jax(tmp_path):
    spawn = JS.spawn_standard(256, h=0.3, box_half=(2.5, 2.5, 2.5))
    jstate = JS.state_from_spawn(spawn)
    state = state_from_numpy(
        {f.name: np.asarray(getattr(jstate, f.name))
         for f in dataclasses.fields(jstate)}, device="cpu")
    vp = JP.VizParams(palette_id=1, color_drive=JP.DRIVE_HEIGHT,
                      height_min=-2.5, height_max=2.5)
    tvp = TP.VizParams(**dataclasses.asdict(vp))
    cam = fit_camera(np.array([2.5, 2.5, 2.5], np.float32))
    bg = np.random.default_rng(3).integers(0, 256, (96, 160, 3)) \
        .astype(np.uint8)
    obj = tmp_path / "tet.obj"
    obj.write_text("v 0 1 0\nv -1 -1 1\nv 1 -1 1\nv 0 -1 -1\n"
                   "f 1 2 3\nf 1 3 4\nf 1 4 2\nf 2 4 3\n")
    for kw in (dict(), dict(background=bg), dict(mesh_obj=str(obj)),
               dict(max_instances=100)):
        img, depth = TSPLAT.render_frame_mesh(
            state, tvp, cam, width=160, height=96, particle_radius=0.15,
            return_depth=True, **kw)
        jimg, jdepth = JSPLAT.render_frame_mesh(
            jstate, vp, cam, width=160, height=96, particle_radius=0.15,
            return_depth=True, **kw)
        assert img.shape == (96, 160, 3) and img.dtype == np.uint8
        assert np.abs(img.astype(int) - jimg.astype(int)).max() <= 1
        np.testing.assert_array_equal(depth, jdepth)
        assert (depth > 0).sum() > 30
    img = TSPLAT.render_frame_mesh(state, tvp, cam, width=160, height=96,
                                   particle_radius=0.15)
    assert (img.sum(-1) > 0).sum() > 100
