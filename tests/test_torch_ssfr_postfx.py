"""The port's SSFR water renderer (``viz/ssfr.py``, the ``ssfr_splat`` of
``native/splat_raster.cpp``) against ``sph_tpu.viz`` on the CPU, the water
cases of ``tests/test_ssfr_postfx.py`` through both packages on the same
numpy inputs (its post-FX cases are in ``tests/test_torch_postfx.py``).

Tolerances:

- pass 1, the splat: ``ssfr_splat`` bit-equal to its plain version
  (``splat_depth_thickness_plain``) and to the JAX package's (the same
  C++, the JAX one built into a directory of this module's);
- the smoothing, the sky and the composite: within 1e-4 of the JAX
  package's jitted passes (XLA's fused float32 arithmetic and the torch ops
  round alike to a few ulps here);
- whole water frames (uint8): no channel more than 1/255 from the JAX
  package's.
"""
import ctypes
import dataclasses
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_tpu import native as jax_native
from sph_tpu.core import state as JS
from sph_tpu.scene import settings as JSET
from sph_tpu.viz import palettes as JP
from sph_tpu.viz import ssfr as JW
from sph_tpu.viz.camera import OrbitCamera, fit_camera
from sph_tpu_torch.core.convert import state_from_numpy
from sph_tpu_torch.scene import settings as TSET
from sph_tpu_torch.viz import palettes as TP
from sph_tpu_torch.viz import ssfr as TW

PASS_ATOL = 1e-4
W, H = 160, 90
# the water looks of the frame tests: two, since the JAX package compiles
# its smoothing anew for each look and each count of rounds (both are
# static arguments), and one round of smoothing (the default's five rounds
# are held by the reel's frames, tests/test_torch_reel.py)
WP_SKY = JW.WaterParams(sky_on=True, foam_amount=2.0, smooth_iterations=1)
WP_FLAT = JW.WaterParams(sky_on=False, bg_color=(0.0, 0.0, 0.0),
                         foam_amount=2.0, smooth_iterations=1)


@pytest.fixture(scope="module")
def jax_splat(tmp_path_factory):
    """The JAX package's splat rasterizers built from its own source into
    a directory of this module's (``sph_tpu.native.load`` would build into
    the package's ``_build/``, which another test process may be writing,
    and fall back to numpy if that failed)."""
    src = os.path.join(os.path.dirname(jax_native.__file__),
                       "splat_raster.cpp")
    out = str(tmp_path_factory.mktemp("jax_native") / "splat_raster.so")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src,
                    "-o", out], check=True, capture_output=True)
    return ctypes.CDLL(out)


@pytest.fixture(autouse=True)
def jax_native_lib(jax_splat, monkeypatch):
    monkeypatch.setitem(jax_native._CACHE, "splat_raster", jax_splat)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several processes at once, where each process's pool of torch
    threads spins against the others' (a file took 15 times as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def water_state():
    """The 2k dam break of tests/conftest.py with foam from seed 5, as a
    JAX state and as the port's on the CPU."""
    st = JS.state_from_spawn(JS.spawn_standard(2048, seed=7))
    rng = np.random.default_rng(5)
    st = st.replace(foam=jnp.asarray(rng.uniform(0, 1, st.n)
                                     .astype(np.float32)))
    port = state_from_numpy({f.name: np.asarray(getattr(st, f.name))
                             for f in dataclasses.fields(st)}, device="cpu")
    return st, port


def port_wp(wp: JW.WaterParams) -> TW.WaterParams:
    return TW.WaterParams(**dataclasses.asdict(wp))


def assert_frames_close(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


GRADE = dict(hue_shift=30.0, sat_mul=1.2, invert_color=True)


@pytest.mark.parametrize("sky_on, grade", [(False, None), (True, GRADE)])
def test_render_water_matches_jax(water_state, sky_on, grade):
    st, port = water_state
    wp = WP_SKY if sky_on else WP_FLAT
    cam = fit_camera([7.0, 7.0, 7.0])
    want = JW.render_water(st, wp, cam, width=W, height=H,
                           vp=JP.VizParams(**grade) if grade else None)
    got = TW.render_water(port, port_wp(wp), cam, width=W, height=H,
                          vp=TP.VizParams(**grade) if grade else None)
    assert_frames_close(got, want)
    if not sky_on and grade is None:
        assert (got.sum(-1) > 30).sum() > 100     # water on black


def test_render_water_mask_and_empty(water_state):
    st, port = water_state
    wp = WP_FLAT
    cam = fit_camera([7.0, 7.0, 7.0])
    mask = np.arange(st.n) % 3 == 0
    assert_frames_close(
        TW.render_water(port, port_wp(wp), cam, width=W, height=H,
                        mask=mask),
        JW.render_water(st, wp, cam, width=W, height=H, mask=mask))
    empty = TW.render_water(port, port_wp(wp), cam, width=W, height=H,
                            mask=np.zeros(st.n, bool))
    assert (empty == empty[0, 0]).all()


@pytest.mark.parametrize("radius", [0.05, 0.234, 0.6])
def test_splat_native_plain_and_jax_equal(water_state, radius):
    """Radii below the footprint's 0.6 floor, the render's and past the
    footprint's 3 pixels; particles at the image's left and top edges
    (``int()`` truncates toward zero, so two offsets of one particle can
    hit one pixel)."""
    st, _ = water_state
    pos = np.asarray(st.pos).copy()
    foam = np.asarray(st.foam)
    cam = fit_camera([7.0, 7.0, 7.0])
    view, proj = cam.view_matrix(), cam.proj_matrix(W / H)
    pos[:40] = pos[:40] * 2.2        # some off the image, some on its edge
    a = TW.splat_depth_thickness(pos, foam, view, proj, W, H, radius)
    b = TW.splat_depth_thickness_plain(pos, foam, view, proj, W, H, radius)
    c = JW.splat_depth_thickness(pos, foam, view, proj, W, H, radius)
    for x, y, z in zip(a, b, c):
        assert x.dtype == np.float32 and x.shape == (H, W)
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    assert (a[0] != 0).sum() > 100


def test_splat_depth_nearest_wins():
    pos = np.array([[0, 0, 0], [0, 0, 5.0]], np.float32)
    cam = OrbitCamera(yaw_deg=0, pitch_deg=0, distance=20.0)
    view, proj = cam.view_matrix(), cam.proj_matrix(1.0)
    out = [fn(pos, np.zeros(2, np.float32), view, proj, 64, 64, 0.3)
           for fn in (TW.splat_depth_thickness,
                      TW.splat_depth_thickness_plain,
                      JW.splat_depth_thickness)]
    for other in out[1:]:
        for x, y in zip(out[0], other):
            np.testing.assert_array_equal(x, y)
    depth, thick, _ = out[0]
    assert depth[32, 32] != 0.0 and depth[32, 32] > -16.5
    assert thick[32, 32] > thick[40, 40]


def smooth_both(d, iters, radius, scale, wp=WP_FLAT):
    want = np.asarray(JW.smooth_depth(jnp.asarray(d), iters, radius, scale,
                                      wp))
    got = TW.smooth_depth(torch.as_tensor(d), iters, radius, scale,
                          port_wp(wp)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PASS_ATOL)
    return got


# The smoothing cases of tests/test_ssfr_postfx.py draw on a 32x32 image;
# here they draw the same shapes on the frame tests' H x W image and smooth
# in the flat look's one round, which the JAX package has compiled for
# test_render_water_matches_jax (its smoothing reads only the look's
# world_filter_scale and surface_merge, the defaults in both looks).
ROUNDS = WP_FLAT.smooth_iterations


def test_smooth_depth_preserves_background_and_merges():
    d = np.zeros((H, W), np.float32)
    d[10:20, 10:20] = -10.0
    d[14, 14] = -10.4
    out = smooth_both(d, ROUNDS, 0.2, 200.0)
    assert (out[d == 0.0] == 0.0).all()
    assert abs(out[14, 14] - d[14, 14]) < 0.4
    assert out[15, 15] != 0.0


def test_smooth_depth_keeps_silhouette():
    d = np.zeros((H, W), np.float32)
    d[:, :W // 2] = -30.0
    d[:, W // 2:] = -5.0
    out = smooth_both(d, ROUNDS, 0.2, 200.0)
    assert abs(out[H // 2, W // 4] - (-30.0)) < 1.0
    assert abs(out[H // 2, 3 * W // 4] - (-5.0)) < 1.0


def test_smooth_depth_wraps_at_the_edges(water_state):
    """Taps wrap around the image (``jnp.roll``): a surface at the left
    edge merges with one at the right edge, as in the JAX package; and the
    splat of the water state in the frame tests' looks (the default's five
    rounds are held by the reel's frames, tests/test_torch_reel.py)."""
    d = np.zeros((H, W), np.float32)
    d[:, :3] = -10.0
    d[:, -3:] = -10.3
    out = smooth_both(d, ROUNDS, 0.2, 200.0)
    assert out[12, 0] < -10.0
    st, _ = water_state
    cam = fit_camera([7.0, 7.0, 7.0])
    proj = cam.proj_matrix(W / H)
    depth, _, _ = TW.splat_depth_thickness(
        np.asarray(st.pos), np.asarray(st.foam), cam.view_matrix(), proj, W,
        H, 0.234)
    for rounds in (WP_SKY.smooth_iterations, 0):
        smooth_both(depth, rounds, 0.234, float(proj[1, 1]) * H * 0.5,
                    WP_SKY)


def test_background_sky_gradient():
    cam = OrbitCamera(yaw_deg=30, pitch_deg=20, distance=10)
    for sky_on in (True, False):
        wp = JW.WaterParams(sky_on=sky_on, bg_color=(0.1, 0.2, 0.3))
        want = np.asarray(JW.render_background(64, 48, cam.view_matrix(),
                                               cam.proj_matrix(64 / 48), wp))
        got = TW.render_background(64, 48, cam.view_matrix(),
                                   cam.proj_matrix(64 / 48), port_wp(wp),
                                   device="cpu")
        assert got.shape == (48, 64, 3) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=PASS_ATOL)
    assert got.numpy()[0].mean() == want[0].mean()
    bg = TW.render_background(64, 64, cam.view_matrix(),
                              cam.proj_matrix(1.0), TW.WaterParams(
                                  sky_on=True), device="cpu").numpy()
    assert bg[0].mean() != bg[-1].mean() and np.isfinite(bg).all()


def test_composite_background_passthrough():
    wp = JW.WaterParams(bg_color=(0.2, 0.0, 0.0))
    view = OrbitCamera().view_matrix()
    z = np.zeros((16, 16), np.float32)
    bg = np.broadcast_to(np.asarray([0.2, 0.0, 0.0], np.float32),
                         (16, 16, 3))
    want = np.asarray(JW.composite(jnp.asarray(z), jnp.asarray(z),
                                   jnp.asarray(z), jnp.asarray(bg),
                                   jnp.asarray(view), (16, 16), 1.0, 1.0,
                                   wp))
    t = torch.as_tensor(z)
    got = TW.composite(t, t, t, torch.as_tensor(bg.copy()), view, (16, 16),
                       1.0, 1.0, port_wp(wp)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PASS_ATOL)
    assert (got[..., 0] > got[..., 2]).all()
    assert np.allclose(got, got[0, 0], atol=1e-5)


def test_composite_surface_matches_jax(water_state):
    """The full shade of the water state's smoothed splat, over the sky,
    with the HSV grade (the frame test's look and grade, whose jitted
    composite the JAX package has compiled already)."""
    st, _ = water_state
    wp = WP_SKY
    cam = fit_camera([7.0, 7.0, 7.0])
    view, proj = cam.view_matrix(), cam.proj_matrix(W / H)
    depth, thick, foam = JW.splat_depth_thickness(
        np.asarray(st.pos), np.asarray(st.foam), view, proj, W, H, 0.234)
    sm = np.asarray(JW.smooth_depth(jnp.asarray(depth),
                                    wp.smooth_iterations, 0.234,
                                    float(proj[1, 1]) * H * 0.5, wp))
    bg = np.asarray(JW.render_background(W, H, view, proj, wp))
    vp = GRADE
    want = np.asarray(JW.composite(
        jnp.asarray(sm), jnp.asarray(thick), jnp.asarray(foam),
        jnp.asarray(bg), jnp.asarray(view), (H, W), float(proj[0, 0]),
        float(proj[1, 1]), wp, JP.VizParams(**vp)))
    got = TW.composite(
        *(torch.as_tensor(a.copy()) for a in (sm, thick, foam, bg)), view,
        (H, W), float(proj[0, 0]), float(proj[1, 1]), port_wp(wp),
        TP.VizParams(**vp)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PASS_ATOL)
    assert (sm != 0).sum() > 100


def test_to_water_params_matches():
    s = JSET.SceneSettings()
    s.smooth_iterations = 3
    s.sky_on = True
    s.water_extinction = [0.3, 0.2, 0.1]
    want = dataclasses.asdict(JSET.to_water_params(s))
    got = dataclasses.asdict(TSET.to_water_params(
        TSET.SceneSettings(**dataclasses.asdict(s))))
    assert got == want
    assert [f.name for f in dataclasses.fields(TW.WaterParams)] == \
        [f.name for f in dataclasses.fields(JW.WaterParams)]
