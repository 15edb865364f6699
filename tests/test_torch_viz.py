"""The port's headless frame export (``sph_tpu_torch.viz``: camera,
palettes, splat renderer, PNG) against ``sph_tpu.viz`` on the CPU.

Inputs are made from a seed with numpy (or by the JAX spawn) and go
through both packages.  Tolerances:

- camera matrices: equal (the same numpy code);
- drives, palettes, two-color groups, the HSV grade and the lit shading:
  elementwise within 1e-5, against the JAX functions called as
  ``tests/test_viz.py`` calls them (op by op, no ``jax.jit``);
- the pattern palettes 15, 16, 18 and 22, which go through ``hash13``
  (the fractional part of products, so an ulp of difference in a sum moves
  the hash): by the share of rows within 1e-5, at least ``HASH_SHARE``.
  Measured on this file's inputs: 1.0 for all four.  Under ``jax.jit``
  XLA fuses the hash's float32 arithmetic, and the JAX package's own
  jitted ``hash13`` differs from its op-by-op one on 26% of the same rows;
  the port follows the float32 formula of ``tests/test_viz.py``, which
  ``test_hash13_is_the_float32_formula`` holds bit for bit;
- frames of the two packages at 240x135: no channel differs by more than
  1/255 (the colors within 1e-5 may round to the next level; the
  projection, sort and rasterizer are the same host code);
- the port's rasterizer against its plain version: under 2% of pixels
  differ by more than 2/255, as ``tests/test_viz.py`` allows;
- PNG: the decoded pixels equal the array.
"""
import ctypes
import dataclasses
import os
import subprocess

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from sph_tpu import native as jax_native
from sph_tpu.core import state as JS
from sph_tpu.viz import camera as JCAM
from sph_tpu.viz import palettes as JP
from sph_tpu.viz import splat as JSPLAT
from sph_tpu_torch.core.convert import state_from_numpy
from sph_tpu_torch.viz import camera as TCAM
from sph_tpu_torch.viz import palettes as TP
from sph_tpu_torch.viz import splat as TSPLAT


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several processes at once, where each process's pool of torch
    threads spins against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5
HASH_PALETTES = (15, 16, 18, 22)
HASH_SHARE = 0.99
EXPORT_DRIVES = (JP.DRIVE_HEIGHT, JP.DRIVE_SPEED, JP.DRIVE_PRESSURE,
                 JP.DRIVE_DENSITY)
W, H = 240, 135


def port_vp(vp: JP.VizParams) -> TP.VizParams:
    return TP.VizParams(**{f.name: getattr(vp, f.name)
                           for f in dataclasses.fields(vp)})


@pytest.fixture(scope="module")
def rows():
    """4,096 particles' inputs to the color pipeline, from seed 0."""
    rng = np.random.default_rng(0)
    n = 4096
    return {
        "world_pos": rng.uniform(-8, 8, (n, 3)).astype(np.float32),
        "view_pos": rng.uniform(-30, -1, (n, 3)).astype(np.float32),
        "vel": rng.normal(0, 4, (n, 3)).astype(np.float32),
        "pressure": rng.uniform(0, 12, n).astype(np.float32),
        "density": rng.uniform(0, 12, n).astype(np.float32),
        "color_group": rng.integers(0, 2, n).astype(np.int32),
        "t": rng.uniform(-0.1, 1.1, n).astype(np.float32),
        "facing": rng.uniform(0, 1, n).astype(np.float32),
    }


def both(rows, *names):
    return ([jnp.asarray(rows[k]) for k in names],
            [torch.as_tensor(rows[k]) for k in names])


def assert_rows_close(want, got, share=1.0):
    err = np.abs(np.asarray(want) - got.numpy())
    err = err.reshape(err.shape[0], -1).max(axis=1)
    within = float((err <= ATOL).mean())
    assert within >= share, (within, float(err.max()))


@pytest.mark.parametrize("cam", [
    JCAM.fit_camera(np.asarray([41.0, 41.0, 41.0], np.float32)),
    JCAM.fit_camera(np.asarray([7.0, 3.0, 2.0], np.float32), margin=1.5),
    JCAM.OrbitCamera(target=np.asarray([1.0, -2.0, 0.5], np.float32),
                     yaw_deg=-120.0, pitch_deg=55.0, distance=12.0),
    JCAM.OrbitCamera(pitch_deg=90.0),          # looks straight down
])
def test_camera_matrices_equal(cam):
    port = TCAM.OrbitCamera(**{f.name: getattr(cam, f.name)
                               for f in dataclasses.fields(cam)})
    np.testing.assert_array_equal(port.eye(), cam.eye())
    np.testing.assert_array_equal(port.view_matrix(), cam.view_matrix())
    for aspect in (16 / 9, 1.0):
        np.testing.assert_array_equal(port.proj_matrix(aspect),
                                      cam.proj_matrix(aspect))
    half = np.asarray([41.0, 41.0, 41.0], np.float32)
    assert TCAM.fit_camera(half).distance == JCAM.fit_camera(half).distance


def test_viz_params_and_constants_carried_across():
    want = [(f.name, f.default) for f in dataclasses.fields(JP.VizParams)]
    got = [(f.name, f.default) for f in dataclasses.fields(TP.VizParams)]
    assert got == want
    vp = JP.VizParams(palette_id=7, palette_id2=3, color_drive=5,
                      hue_shift=30.0, invert_color=True)
    assert dataclasses.asdict(port_vp(vp)) == dataclasses.asdict(vp)
    for name in ("TWO_PI", "NUM_PALETTES", "DRIVE_HEIGHT", "DRIVE_SPEED",
                 "DRIVE_PRESSURE", "DRIVE_DENSITY", "DRIVE_VIEW_DEPTH",
                 "DRIVE_VELOCITY_DIR", "DRIVE_RADIAL_DIST"):
        assert getattr(TP, name) == getattr(JP, name), name


@pytest.mark.parametrize("flow", [0.0, 0.3])
@pytest.mark.parametrize("pid", range(JP.NUM_PALETTES))
def test_palette_matches_jax(rows, pid, flow):
    vp = JP.VizParams(palette_id=pid, anim_time=1.5, palette_flow=flow,
                      irid_freq=1.3, irid_shift=0.2, pattern_scale=0.4,
                      box_center=(0.5, -1.0, 0.25))
    (jt, jf, jw), (tt, tf, tw) = both(rows, "t", "facing", "world_pos")
    want = JP.apply_palette(vp, pid, jt, jf, jw)
    got = TP.apply_palette(port_vp(vp), pid, tt, tf, tw)
    assert got.shape == (tt.shape[0], 3) and got.dtype == torch.float32
    assert_rows_close(want, got,
                      HASH_SHARE if pid in HASH_PALETTES else 1.0)


PIPELINE = ("world_pos", "view_pos", "vel", "pressure", "density",
            "color_group")


@pytest.mark.parametrize("drive", range(7))
def test_drive_matches_jax(rows, drive):
    vp = JP.VizParams(color_drive=drive, viz_min=0.5, viz_max=9.0,
                      height_min=-6.0, height_max=5.0,
                      box_center=(1.0, 0.0, -1.0))
    (jw, jv, jvel, jp, jd, _), (tw, tv, tvel, tp, td, _) = both(rows,
                                                                 *PIPELINE)
    want = JP.compute_drive(vp, jw, jv, jvel, jp, jd)
    got = TP.compute_drive(port_vp(vp), tw, tv, tvel, tp, td)
    assert_rows_close(want[:, None], got[:, None])
    # the drive through a palette set, the whole pipeline
    for pid in (0, 1, 8, 12, 23):
        vp_p = dataclasses.replace(vp, palette_id=pid)
        j, t = both(rows, *PIPELINE)
        assert_rows_close(JP.particle_colors(vp_p, *j),
                          TP.particle_colors(port_vp(vp_p), *t))


@pytest.mark.parametrize("grade", [
    dict(),
    dict(hue_shift=75.0, sat_mul=0.6, bright_mul=1.3, contrast_mul=1.2),
    dict(hue_shift=-200.0, sat_mul=1.8, bright_mul=0.7, contrast_mul=0.5,
         invert_color=True),
])
@pytest.mark.parametrize("pids", [(1, 8), (3, 21), (11, 4), (0, -1)])
def test_two_color_groups_and_grade(rows, pids, grade):
    vp = JP.VizParams(palette_id=pids[0], palette_id2=pids[1],
                      color_drive=JP.DRIVE_SPEED, **grade)
    j, t = both(rows, *PIPELINE)
    facing = both(rows, "facing")
    want = JP.particle_colors(vp, *j, facing=facing[0][0])
    got = TP.particle_colors(port_vp(vp), *t, facing=facing[1][0])
    assert_rows_close(want, got)
    if pids[1] >= 0:
        # the groups took their own palettes
        one = TP.particle_colors(port_vp(dataclasses.replace(
            vp, palette_id2=-1)), *t, facing=facing[1][0])
        g = t[-1] == 1
        assert torch.equal(got[~g], one[~g]) and not torch.equal(got[g],
                                                                 one[g])


def test_hsv_and_lit_shading_match_jax(rows):
    rng = np.random.default_rng(1)
    rgb = rng.uniform(-0.1, 1.1, (4096, 3)).astype(np.float32)
    rgb[:64] = rgb[:64, :1]                            # greys: d == 0
    assert_rows_close(JP.rgb2hsv(jnp.asarray(rgb)),
                      TP.rgb2hsv(torch.as_tensor(rgb)))
    hsv = rng.uniform(-0.5, 1.5, (4096, 3)).astype(np.float32)
    assert_rows_close(JP.hsv2rgb(jnp.asarray(hsv)),
                      TP.hsv2rgb(torch.as_tensor(hsv)))
    vp = JP.VizParams(hue_shift=20.0, sat_mul=1.4, contrast_mul=1.1)
    assert_rows_close(JP.apply_color_adjust(vp, jnp.asarray(rgb)),
                      TP.apply_color_adjust(port_vp(vp),
                                            torch.as_tensor(rgb)))
    normal = rng.normal(size=(4096, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    view_dir = rng.normal(size=(4096, 3)).astype(np.float32)
    view_dir /= np.linalg.norm(view_dir, axis=1, keepdims=True)
    mat = JCAM.fit_camera(np.asarray([7.0, 7.0, 7.0])).view_matrix()[:3, :3]
    col = np.clip(rgb, 0, 1)
    args = (col, normal, view_dir, rows["facing"], mat)
    assert_rows_close(JP.shade_lit(vp, *map(jnp.asarray, args)),
                      TP.shade_lit(port_vp(vp), *map(torch.as_tensor, args)))


def test_hash13_is_the_float32_formula():
    """hash13, vnoise and fbm against the float32 formulas of
    ``tests/test_viz.py:281-329``, the dot product summed left to right,
    bit for bit on 2,048 points; and the JAX package's op-by-op hash13."""
    f32 = np.float32
    rng = np.random.default_rng(2)
    pts = rng.uniform(-20, 20, (2048, 3)).astype(f32)

    def hash13(p):
        p = (p * f32(0.1031)) % f32(1.0)
        q = p[:, ::-1] + f32(31.32)
        dot = p[:, 0] * q[:, 0] + p[:, 1] * q[:, 1] + p[:, 2] * q[:, 2]
        p = p + dot[:, None]
        return ((p[:, 0] + p[:, 1]) * p[:, 2]) % f32(1.0)

    def vnoise(p):
        i = np.floor(p)
        f = p - i
        f = f * f * (f32(3.0) - f32(2.0) * f)
        mix = lambda a, b, t: a + (b - a) * t
        n = {k: hash13(i + np.asarray(k, f32))
             for k in [(x, y, z) for z in (0, 1) for y in (0, 1)
                       for x in (0, 1)]}
        return mix(
            mix(mix(n[(0, 0, 0)], n[(1, 0, 0)], f[:, 0]),
                mix(n[(0, 1, 0)], n[(1, 1, 0)], f[:, 0]), f[:, 1]),
            mix(mix(n[(0, 0, 1)], n[(1, 0, 1)], f[:, 0]),
                mix(n[(0, 1, 1)], n[(1, 1, 1)], f[:, 0]), f[:, 1]), f[:, 2])

    def fbm(p):
        v, a = f32(0.0), f32(0.5)
        for _ in range(3):
            v = v + a * vnoise(p)
            p = p * f32(2.03)
            a *= f32(0.5)
        return v

    tp = torch.as_tensor(pts)
    np.testing.assert_array_equal(TP.hash13(tp).numpy(), hash13(pts))
    np.testing.assert_array_equal(TP.vnoise(tp).numpy(), vnoise(pts))
    np.testing.assert_array_equal(TP.fbm(tp).numpy(), fbm(pts))
    np.testing.assert_array_equal(TP.hash13(tp).numpy(),
                                  np.asarray(JP.hash13(jnp.asarray(pts))))


def scene(ghosts: bool = False):
    """The 2k dam break of tests/conftest.py as a JAX state, with speeds,
    pressures and densities from seed 5 spanning the drives' range; with
    ``ghosts``, a ghost shell and padding rows too (2,048 fluid rows)."""
    spawn = JS.spawn_standard(2048, seed=7)
    if ghosts:
        spawn = JS.concat_spawns(spawn, JS.spawn_ghost_box_shell(
            box_half=(7.0, 7.0, 7.0)))
    st = JS.state_from_spawn(spawn, pad_to=spawn.count + 300)
    rng = np.random.default_rng(5)
    n = st.n
    return st.replace(
        vel=jnp.asarray(rng.normal(0, 4, (n, 3)).astype(np.float32)),
        pressure=jnp.asarray(rng.uniform(0, 12, n).astype(np.float32)),
        density=jnp.asarray(rng.uniform(0, 12, n).astype(np.float32)),
        color_group=jnp.asarray(rng.integers(0, 2, n).astype(np.int32)))


def to_port(st):
    return state_from_numpy({f.name: np.asarray(getattr(st, f.name))
                             for f in dataclasses.fields(st)}, device="cpu")


def export_vp(drive, vp_cls=JP.VizParams):
    """The export's VizParams (bench.py:162-164) at box half 7."""
    return vp_cls(palette_id=1, color_drive=drive, height_min=-7.0,
                  height_max=7.0)


@pytest.fixture(scope="module")
def camera():
    return JCAM.fit_camera(np.asarray([7.0, 7.0, 7.0], np.float32))


@pytest.fixture(scope="module")
def jax_rasterizer(tmp_path_factory):
    """The JAX package's rasterizer, built from its own source with its
    own flags into a directory of this module's: ``sph_tpu.native.load``
    would build into the package's ``_build/``, which another test
    process may be building at the same time, and fall back to its numpy
    loop if that failed."""
    src = os.path.join(os.path.dirname(jax_native.__file__),
                       "splat_raster.cpp")
    out = str(tmp_path_factory.mktemp("jax_native") / "splat_raster.so")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src,
                    "-o", out], check=True, capture_output=True)
    return ctypes.CDLL(out)


@pytest.mark.parametrize("radius", [0.14, 0.6])     # 0.5 h, and 3x3 discs
@pytest.mark.parametrize("drive", EXPORT_DRIVES)
def test_render_frame_matches_jax(camera, jax_rasterizer, monkeypatch, drive,
                                  radius):
    monkeypatch.setattr(JSPLAT, "_native_lib", lambda: jax_rasterizer)
    st = scene()
    want = JSPLAT.render_frame(st, export_vp(drive), camera, width=W,
                               height=H, particle_radius=radius)
    got = TSPLAT.render_frame(to_port(st), export_vp(drive, TP.VizParams),
                              camera, width=W, height=H,
                              particle_radius=radius)
    assert got.shape == want.shape == (H, W, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()
    drawn = int((got != got[0, 0]).any(axis=-1).sum())
    assert drawn >= 200, drawn


@pytest.mark.parametrize("drive", EXPORT_DRIVES)
def test_ghosts_and_padding_are_not_drawn(camera, drive):
    """Ghost and padding rows are never drawn, so no drive reads their
    values: a frame is the same whatever they hold, and the same as the
    frame of the fluid rows alone.  The ghost shell lies on the box's
    faces, inside the camera's view."""
    st = scene(ghosts=True)
    fluid = np.asarray(st.valid > 0) & np.asarray(st.ghost == 0)
    assert fluid.sum() == 2048
    hidden = ~fluid
    assert (np.asarray(st.ghost) > 0).sum() > 0 and \
        (np.asarray(st.valid) == 0).sum() == 300
    rng = np.random.default_rng(9)
    idx = np.nonzero(hidden)[0]
    moved = st.replace(
        pos=st.pos.at[idx].set(
            rng.uniform(-6, 6, (len(idx), 3)).astype(np.float32)),
        vel=st.vel.at[idx].set(50.0),
        pressure=st.pressure.at[idx].set(1e6),
        density=st.density.at[idx].set(1e6))
    alone = JS.state_from_spawn(JS.spawn_standard(2048, seed=7))
    alone = alone.replace(**{f: getattr(st, f)[:2048] for f in (
        "vel", "pressure", "density", "color_group")})
    vp = export_vp(drive, TP.VizParams)
    frames = [TSPLAT.render_frame(to_port(s), vp, camera, width=W, height=H,
                                  particle_radius=0.6)
              for s in (st, moved, alone)]
    np.testing.assert_array_equal(frames[1], frames[0])
    np.testing.assert_array_equal(frames[2], frames[0])


def test_native_rasterizer_against_plain(camera):
    st = to_port(scene())
    for lit in (True, False):
        vp = dataclasses.replace(export_vp(JP.DRIVE_SPEED, TP.VizParams),
                                 lit_sphere=lit)
        a = TSPLAT.render_frame(st, vp, camera, width=W, height=H,
                                particle_radius=0.6)
        b = TSPLAT.render_frame_plain(st, vp, camera, width=W, height=H,
                                      particle_radius=0.6)
        diff = (np.abs(a.astype(int) - b.astype(int)) > 2).any(axis=-1)
        assert diff.mean() < 0.02, (lit, diff.mean())
    # splats of one pixel never overlap across offsets: equal
    vp = export_vp(JP.DRIVE_HEIGHT, TP.VizParams)
    np.testing.assert_array_equal(
        TSPLAT.render_frame(st, vp, camera, width=W, height=H),
        TSPLAT.render_frame_plain(st, vp, camera, width=W, height=H))


def test_empty_frame_is_background(camera):
    st = to_port(scene())
    st = st.replace(valid=torch.zeros_like(st.valid))
    vp = export_vp(JP.DRIVE_HEIGHT, TP.VizParams)
    for render in (TSPLAT.render_frame, TSPLAT.render_frame_plain):
        img = render(st, vp, camera, width=W, height=H)
        assert (img == np.asarray([7, 10, 15], np.uint8)).all()


def test_save_png_decodes_to_the_array(tmp_path):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    img[:10] = 0                                   # long runs compress
    TSPLAT.save_png(img, str(tmp_path / "port.png"))
    JSPLAT.save_png(img, str(tmp_path / "jax.png"))
    with Image.open(tmp_path / "port.png") as im:
        assert im.mode == "RGB" and im.size == (W, H)
        port = np.asarray(im)
    with Image.open(tmp_path / "jax.png") as im:
        jax_img = np.asarray(im)
    np.testing.assert_array_equal(port, img)
    np.testing.assert_array_equal(port, jax_img)
    np.testing.assert_array_equal(TSPLAT.read_png(str(tmp_path / "port.png")),
                                  img)
    with pytest.raises(ValueError, match="uint8"):
        TSPLAT.save_png(img.astype(np.float32), str(tmp_path / "bad.png"))
    data = bytearray((tmp_path / "port.png").read_bytes())
    data[40] ^= 0xFF                               # inside IDAT
    (tmp_path / "broken.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        TSPLAT.read_png(str(tmp_path / "broken.png"))
