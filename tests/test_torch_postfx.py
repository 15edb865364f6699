"""The port's post-FX chain (``viz/postfx.py``) against
``sph_tpu.viz.postfx`` on the CPU, the post-FX cases of
``tests/test_ssfr_postfx.py`` through both packages on the same numpy
inputs (its water cases are in ``tests/test_torch_ssfr_postfx.py``).

Tolerances: within ``POST_ATOL`` (1e-5) per element for the passes that
sample on the pixel grid (trails, bloom, streaks, vignette, grain), and
within ``WARP_ATOL`` (1e-4) for the UV-warping passes (kaleidoscope,
chromatic aberration, DOF), whose bilinear samples floor a continuous
coordinate, so that an ulp can move a sample to the next pixel; the
grain's hash bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_tpu.scene import settings as JSET
from sph_tpu.viz import postfx as JPF
from sph_tpu_torch.scene import settings as TSET
from sph_tpu_torch.viz import postfx as TPF

POST_ATOL = 1e-5
WARP_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several processes at once, where each process's pool of torch
    threads spins against the others' (a file took 15 times as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def image():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 0.4, (64, 96, 3)).astype(np.float32)
    img[30:34, 40:44] = 1.0      # a bright spot
    return img


POST_CASES = {
    "neutral": {},
    "bloom": dict(bloom_strength=1.0, bloom_threshold=0.6),
    "streaks": dict(bloom_strength=0.8, streak_strength=1.0),
    "trails": dict(trail_half_life=0.5),
    "vignette": dict(vignette=1.0),
    "grain": dict(grain=0.2),
    "kaleido": dict(kaleido_segments=4, kaleido_angle=0.3),
    "chromatic": dict(chromatic=5.0),
    "dof": dict(aperture=30.0, focus_dist=22.0),
    "all": dict(bloom_strength=1.0, streak_strength=0.7,
                trail_half_life=0.5, vignette=0.6, grain=0.2,
                kaleido_segments=6, chromatic=3.0, aperture=20.0),
}


def chain_both(frames, kw, view_z=None, post_time=0.0, dt=1 / 30):
    """Each frame of ``frames`` through both packages' chains, the state
    carried; returns the port's outputs and its final state."""
    pp, tpp = JPF.PostParams(**kw), TPF.PostParams(**kw)
    js, ts = JPF.PostState(post_time=post_time), \
        TPF.PostState(post_time=post_time)
    outs = []
    for img in frames:
        want, js = JPF.run_post_chain(
            jnp.asarray(img), pp, js, dt,
            view_z=None if view_z is None else jnp.asarray(view_z))
        got, ts = TPF.run_post_chain(
            torch.as_tensor(img), tpp, ts, dt,
            view_z=None if view_z is None else torch.as_tensor(view_z))
        assert got.dtype == torch.float32 and got.shape == img.shape
        atol = WARP_ATOL if kw.get("kaleido_segments", 0) > 1 or kw.get(
            "chromatic", 0) > 0 or kw.get("aperture", 0) > 0 else POST_ATOL
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=atol)
        assert ts.post_time == js.post_time
        outs.append(got.numpy())
    return outs, ts


@pytest.mark.parametrize("case", list(POST_CASES))
def test_post_chain_matches_jax(case):
    """Each effect alone and all at once, over two frames (the trail and
    the clock carried), with a depth buffer whose top rows are
    background."""
    rng = np.random.default_rng(1)
    z = rng.uniform(0, 60, (64, 96)).astype(np.float32)
    z[:8] = 0.0
    img = image()
    chain_both([img, np.clip(img * 1.2, 0, 1)], POST_CASES[case], view_z=z,
               post_time=1.3)


def test_post_chain_neutral_is_identity():
    (out,), st = chain_both([image()], {})
    np.testing.assert_allclose(out, image(), atol=1e-5)
    assert st.post_time == pytest.approx(1 / 30)


def test_bloom_spreads_brights():
    (out,), _ = chain_both([image()], POST_CASES["bloom"])
    assert out[28, 38].sum() > image()[28, 38].sum() + 0.01


def test_trails_decay():
    dark = np.zeros_like(image())
    _, out2, out3 = chain_both([image(), dark, dark],
                               dict(trail_half_life=0.5))[0]
    a, b = out2[31, 41].sum(), out3[31, 41].sum()
    assert a > 0.1 and b < a


def test_vignette_darkens_corners():
    (out,), _ = chain_both([np.full((64, 64, 3), 0.5, np.float32)],
                           dict(vignette=1.0))
    assert out[0, 0].mean() < out[32, 32].mean() - 0.05


def test_grain_deterministic():
    img = np.full((32, 32, 3), 0.5, np.float32)
    (a,), _ = chain_both([img], dict(grain=0.2), post_time=1.0)
    (b,), _ = chain_both([img], dict(grain=0.2), post_time=1.0)
    (c,), _ = chain_both([img], dict(grain=0.2), post_time=2.3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c) and a.std() > 0.01


def test_hash12_matches_jax():
    """The grain's hash on pixel coordinates with a seed offset, the
    fractional parts of its products, bit for bit."""
    rng = np.random.default_rng(4)
    p = rng.uniform(0, 4096, (4096, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        TPF._hash12(torch.as_tensor(p)).numpy(),
        np.asarray(JPF._hash12(jnp.asarray(p))))


def test_kaleido_symmetry():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    (out,), _ = chain_both([img], dict(kaleido_segments=4))
    assert np.abs(out - out[::-1, :]).mean() < 0.02


def test_chromatic_splits_channels():
    img = np.zeros((64, 64, 3), np.float32)
    img[:, 40:44, :] = 1.0
    (out,), _ = chain_both([img], dict(chromatic=5.0))
    assert out[32, :, 0].argmax() != out[32, :, 2].argmax()


def test_dof_blurs_out_of_focus():
    img = np.zeros((64, 64, 3), np.float32)
    img[30:34, 30:34, :] = 1.0
    z = np.full((64, 64), 50.0, np.float32)
    pp = dict(aperture=30.0, focus_dist=22.0)
    got = TPF.depth_of_field(torch.as_tensor(img), torch.as_tensor(z),
                             TPF.PostParams(**pp)).numpy()
    want = np.asarray(JPF.depth_of_field(jnp.asarray(img), jnp.asarray(z),
                                         JPF.PostParams(**pp)))
    np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)
    assert got[32, 32, 0] < 1.0 and got[32, 40, 0] > 0.0


def test_post_params_from_settings():
    s = JSET.SceneSettings()
    s.bloom_strength = 0.7
    s.kaleido_segments = 6
    s.kaleido_angle = 90.0
    s.lens_aperture = 2.0
    want = JPF.post_params_from_settings(s)
    got = TPF.post_params_from_settings(
        TSET.SceneSettings(**dataclasses.asdict(s)))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.kaleido_angle == pytest.approx(np.pi / 2)
