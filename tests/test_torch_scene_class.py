"""The port's ``Scene`` class (``scene/scene.py``), ``scene/sequencer``,
``scene/quicksets``, ``app/keys`` and the PIL-free PNG reader against
``sph_tpu`` on the CPU: the remaining cases of ``tests/test_scene.py``
through both packages.

Tolerances:

- the scene after 2 frames of ``update`` (32 substeps, default settings at
  1,000 asked rows, bands above the thresholds): the ROADMAP's engine
  tolerances (pos 1e-4, vel 1e-3, density 1.0,
  ``tests/test_brute_pallas.py:40-42``) against the JAX ``Scene`` with
  ``neighbor_impl="cell"``, rows realigned by ``orig_id``;
- after 4 frames (64 substeps) the dam break's compression amplifies
  rounding tenfold a frame, and the JAX package's own exact engines
  (``cell`` against ``brute``) differ by pos 1.6e-4, vel 1.2e-2, density
  0.48 (measured on this file's scene): the port's ``cell`` is held within
  ``SPREAD_FACTOR`` (2) times that spread of the JAX ``cell`` in each
  column (measured: 0.42, 1.14 and 0.50 of it);
- frames of the same state (render modes 0, 1 and 2, the outline, the
  terrain and the post chain): no channel more than 1/255 from the JAX
  package's; the water with the sky, the grade and post effects, and no
  round of smoothing (the JAX package compiles its unrolled smoothing
  anew for each count of rounds; the smoothing is held pass by pass in
  ``tests/test_torch_ssfr_postfx.py``, and the default look's five rounds
  by the reel's frames, ``tests/test_torch_reel.py``);
- checkpoints: bit-equal columns, either package writing, either loading;
- the PNG reader: bit-equal to PIL's decode, and its grey to PIL's
  ``convert("L")``.
"""
import ctypes
import dataclasses
import os
import struct
import subprocess
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sph_tpu import native as jax_native
from sph_tpu.io import presets as JIO
from sph_tpu.scene import quicksets as JQ
from sph_tpu.scene import reaction as JR
from sph_tpu.scene import scene as JSC
from sph_tpu.scene import sequencer as JSEQ
from sph_tpu.scene import settings as JSET
from sph_tpu.viz import camera as JCAM
from sph_tpu_torch.app.keys import KeyController, param_entries
from sph_tpu_torch.core.params import compute_grid_dims
from sph_tpu_torch.io import presets as TIO
from sph_tpu_torch.scene import quicksets as TQ
from sph_tpu_torch.scene import scene as TSC
from sph_tpu_torch.scene import sequencer as TSEQ
from sph_tpu_torch.scene import settings as TSET
from sph_tpu_torch.utils import trace
from sph_tpu_torch.viz.splat import luma, read_png

POS_TOL, VEL_TOL, RHO_TOL = 1e-4, 1e-3, 1.0
SPREAD_FACTOR = 2.0
BANDS = [(0.8, 0.2, 0.1), (0.1, 0.6, 0.1), (0.3, 0.1, 0.9), (1.2, 0.7, 0.5)]


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


def settings(cls, **kw):
    s = cls()
    s.particle_count = 1000
    s.audio_enabled = True
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def port_scene(**kw):
    return TSC.Scene(settings=settings(TSET.SceneSettings, **kw), seed=1,
                     device="cpu")


def jax_scene(impl="cell", **kw):
    return JSC.Scene(settings=settings(JSET.SceneSettings, **kw),
                     neighbor_impl=impl, seed=1)


def fluid_rows(state, field):
    """``field`` of the state's rows in ``orig_id`` order, padding
    dropped."""
    get = lambda t: t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)
    valid = get(state.valid) > 0
    order = np.argsort(np.where(valid, get(state.orig_id), 1 << 30),
                       kind="stable")[:valid.sum()]
    return get(getattr(state, field))[order]


def errors(a, b):
    return [float(np.abs(fluid_rows(a, f) - fluid_rows(b, f)).max())
            for f in ("pos", "vel", "density")]


@pytest.fixture(scope="module")
def four_frames():
    """The port's scene and the JAX package's ``cell`` and ``brute``
    scenes, each after every one of 4 frames of ``update(1/60, bands)``:
    the errors [pos, vel, density] of port against JAX ``cell`` and of
    JAX ``cell`` against JAX ``brute``, frame by frame, the substeps, the
    port's launch counts, its final scene and the JAX ``cell`` scene (which
    the render and checkpoint cases reuse, so that the JAX package builds
    and compiles one scene for them)."""
    port, jcell, jbrute = port_scene(), jax_scene("cell"), jax_scene("brute")
    out = {"port": [], "spread": [], "n_sub": [], "scene": port,
           "jax_scene": jcell}
    trace.reset()
    for bands in BANDS:
        out["n_sub"].append([sc.update(1 / 60, bands=bands)
                             for sc in (port, jcell, jbrute)])
        out["port"].append(errors(port.state, jcell.state))
        out["spread"].append(errors(jcell.state, jbrute.state))
    out["launches"] = {k: trace.counter(f"launches.{k}") for k in (
        "cell_table", "density", "force_xsph", "force_xsph_emit")}
    return out


def test_scene_update_matches_jax_within_engine_tolerances(four_frames):
    assert four_frames["n_sub"] == [[16, 16, 16]] * 4
    for frame in (0, 1):
        pos, vel, rho = four_frames["port"][frame]
        assert pos < POS_TOL and vel < VEL_TOL and rho < RHO_TOL, (frame,
                                                                   pos, vel,
                                                                   rho)
    # the port's plain versions count no launch on the CPU
    assert set(four_frames["launches"].values()) == {0}


def test_scene_after_four_frames_within_the_jax_engines_spread(four_frames):
    got, spread = four_frames["port"][3], four_frames["spread"][3]
    for name, g, s in zip(("pos", "vel", "density"), got, spread):
        assert g <= SPREAD_FACTOR * s, (name, g, s)
    sc = four_frames["scene"]
    assert np.isfinite(sc.state.pos.numpy()).all()
    assert sc.sim_time == pytest.approx(4 / 60)


def port_copy_to_jax(port, jsc):
    """The port scene's state, settings, phases, live values and camera
    into the JAX scene ``jsc``, so both render the same frame."""
    from sph_tpu.core.state import ParticleState
    jsc.settings = JSET.SceneSettings(**dataclasses.asdict(port.settings))
    jsc.state = ParticleState(**{
        f.name: jnp.asarray(getattr(port.state, f.name).numpy())
        for f in dataclasses.fields(port.state)})
    jsc.phases = JR.ReactionPhases(**dataclasses.asdict(port.phases))
    jsc.live = JR.LiveValues(**dataclasses.asdict(port.live))
    jsc.camera = JCAM.OrbitCamera(**dataclasses.asdict(port.camera))
    jsc.last_frame_dt = port.last_frame_dt


LOOKS = {
    "water_sky_post": dict(render_mode=0, smooth_iterations=0, sky_on=True,
                           bloom_strength=0.8, vignette=0.5, grain=0.1,
                           palette_id=5, hue_shift=40.0),
    "impostors": dict(render_mode=1, viz_mode=1, palette_id=3),
    "impostors_post": dict(render_mode=1, lens_aperture=3.0,
                           lens_focus_dist=5.0, bloom_strength=1.0,
                           streak_strength=0.6, trail_half_life=0.4,
                           kaleido_segments=5, chromatic=2.0),
    "mesh": dict(render_mode=2, palette_id=7, show_outline=False),
}


@pytest.mark.parametrize("look", list(LOOKS))
def test_frames_match_jax_on_the_same_state(four_frames, look):
    port = four_frames["scene"]
    for k, v in LOOKS[look].items():
        setattr(port.settings, k, v)
    port.post_state = None
    jsc = four_frames["jax_scene"]
    jsc.post_state = None
    port_copy_to_jax(port, jsc)
    for frame in range(2):            # the trail and the clock carried
        got = port.render(96, 64)
        want = jsc.render(96, 64)
        assert got.shape == (64, 96, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, frame
    assert (got != got[0, 0]).any()
    port.settings = TSET.SceneSettings(**dataclasses.asdict(
        settings(TSET.SceneSettings)))


def test_river_frames_match_jax():
    port = TSC.Scene(settings=settings(TSET.SceneSettings, particle_count=
                                       1000, render_mode=1), seed=6,
                     device="cpu")
    port.enable_river(6)
    port.update(1 / 60)
    jsc = JSC.Scene(settings=settings(JSET.SceneSettings, render_mode=1),
                    neighbor_impl="cell", seed=6)
    jsc.enable_river(6)
    np.testing.assert_array_equal(port.buffers.terrain.numpy(),
                                  np.asarray(jsc.buffers.terrain))
    port_copy_to_jax(port, jsc)
    for mode in (1, 2):
        port.settings.render_mode = jsc.settings.render_mode = mode
        got, want = port.render(96, 64), jsc.render(96, 64)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, mode


def test_sequencer_cut_and_morph(tmp_path):
    pdir = str(tmp_path)
    hot = TSET.SceneSettings()
    hot.viscosity = 9.0
    hot.palette_id = 7
    TIO.save_file(os.path.join(pdir, "hot.txt"), TSET.gather_preset(hot))

    def run(seq_mod, set_mod):
        seq = seq_mod.Sequencer(preset_dir=pdir, enabled=True)
        seq.cues = [seq_mod.SeqCue(time=1.0, preset="hot", cut=True),
                    seq_mod.SeqCue(time=5.0, preset="hot", morph_sec=2.0,
                                   cut=False),
                    seq_mod.SeqCue(time=9.0, preset="missing")]
        s = set_mod.SceneSettings()
        trail = []
        for t in (0.5, 1.1):
            s = seq.tick(s, t)
            trail.append((s.palette_id, s.viscosity))
        s.viscosity = 1.0
        for t in (5.0, 6.0, 7.5, 9.5):
            s = seq.tick(s, t)
            trail.append((s.palette_id, s.viscosity, seq.morph_active))
        return trail

    got = run(TSEQ, TSET)
    assert got == run(JSEQ, JSET)
    assert got[0][0] == 0 and got[1] == (7, pytest.approx(9.0))
    assert 4.0 < got[3][1] < 6.0
    assert abs(got[4][1] - 9.0) < 1e-4 and not got[4][2]


def test_sequencer_persistence_and_drops(tmp_path):
    path = str(tmp_path / "sequence.txt")
    seq = TSEQ.Sequencer()
    seq.cues = [TSEQ.SeqCue(2.5, "a", 1.0, True),
                TSEQ.SeqCue(9.0, "b", 3.0, False)]
    assert seq.save(path)
    back = TSEQ.Sequencer.load(path)
    jback = JSEQ.Sequencer.load(path)
    assert [dataclasses.asdict(c) for c in back.cues] == \
        [dataclasses.asdict(c) for c in jback.cues]
    assert back.cues[0].preset == "a" and back.cues[0].cut
    assert abs(back.cues[1].morph_sec - 3.0) < 1e-6
    assert TSEQ.Sequencer.load(str(tmp_path / "none.txt")).cues == []
    for s in (TSEQ.Sequencer(), JSEQ.Sequencer()):
        s.build_from_drops([4.0, 1.0, 9.0], ["x", "y"], morph_sec=0.5)
    a, b = TSEQ.Sequencer(), JSEQ.Sequencer()
    a.build_from_drops([4.0, 1.0, 9.0], ["x", "y"])
    b.build_from_drops([4.0, 1.0, 9.0], ["x", "y"])
    assert [dataclasses.asdict(c) for c in a.cues] == \
        [dataclasses.asdict(c) for c in b.cues]


def test_checkpoints_load_across_packages(tmp_path, four_frames):
    """The port writes and the JAX package loads, and the other way
    round: the columns equal, the settings, phases and clocks carried."""
    port = four_frames["scene"]
    ck = str(tmp_path / "port.npz")
    port.save_checkpoint(ck)
    jsc = four_frames["jax_scene"]
    jsc.load_checkpoint(ck)
    for f in dataclasses.fields(port.state):
        np.testing.assert_array_equal(np.asarray(getattr(jsc.state, f.name)),
                                      getattr(port.state, f.name).numpy(),
                                      err_msg=f.name)
    assert jsc.sim_time == port.sim_time
    assert dataclasses.asdict(jsc.phases) == dataclasses.asdict(port.phases)

    jsc.state = jsc.state.replace(vel=jsc.state.vel * 2.0)
    jsc.sim_time = 7.5
    ck2 = str(tmp_path / "jax.npz")
    jsc.save_checkpoint(ck2)
    other = port_scene()
    other.load_checkpoint(ck2)
    for f in dataclasses.fields(other.state):
        got = getattr(other.state, f.name)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jsc.state, f.name)),
                                      err_msg=f.name)
    assert other.sim_time == 7.5
    assert TSET.gather_preset(other.settings) == \
        JSET.gather_preset(jsc.settings)


def test_scene_update_and_checkpoint(tmp_path):
    sc = port_scene()
    n0 = sc.state.n
    assert sc.update(0.016, bands=(0.8, 0.2, 0.1)) > 0
    assert np.isfinite(sc.state.pos.numpy()).all()
    ck = str(tmp_path / "ck.npz")
    sc.save_checkpoint(ck)
    pos_before = sc.state.pos.numpy().copy()
    t_before = sc.sim_time
    sc.update(0.016)
    sc.load_checkpoint(ck)
    assert sc.state.n == n0 and sc.sim_time == t_before
    np.testing.assert_array_equal(sc.state.pos.numpy(), pos_before)


def test_scene_art_preset_respawn_and_surprise():
    sc = port_scene()
    sc.apply_art_preset(3)
    assert sc.settings.render_mode == 0
    assert abs(sc.settings.gravity_y + 980.0) < 1e-6
    assert np.isfinite(sc.state.pos.numpy()).all()
    sc.surprise_me(seed=4)
    want = JSC.AP.surprise_me(JSC.AP.apply_art_preset(
        settings(JSET.SceneSettings), 3), 4)
    assert TSET.gather_preset(sc.settings) == JSET.gather_preset(want)
    assert int((sc.state.valid > 0).sum()) > 0


def test_scene_presets_roundtrip(tmp_path):
    sc = TSC.Scene(settings=settings(TSET.SceneSettings, viscosity=4.25),
                   seed=1, preset_dir=str(tmp_path), device="cpu")
    assert sc.save_preset("My Look!")
    names = TIO.list_presets(str(tmp_path))
    assert names == JIO.list_presets(str(tmp_path)) and len(names) == 1
    sc.settings.viscosity = 1.0
    assert sc.load_preset(names[0], structural=False)
    assert sc.settings.viscosity == pytest.approx(4.25)
    assert not sc.load_preset("absent")


def test_watchdog_recovers_from_nonfinite_state(tmp_path):
    """The JAX suite runs this in its slow tier; the port's CPU scene is
    fast enough for the default one."""
    for with_checkpoint in (True, False):
        sc = port_scene(particle_count=256)
        sc.watchdog_every = 1
        if with_checkpoint:
            sc.save_checkpoint(str(tmp_path / "good.npz"))
        pos = sc.state.pos.clone()
        pos[0, 0] = float("nan")
        sc.state = sc.state.replace(pos=pos)
        # one substep carries the non-finite row into the frame's check
        assert sc.update(1.0 / 60.0, max_substeps=1) == 1
        assert np.isfinite(sc.state.pos.numpy()).all()


def test_params_from_settings_matches():
    s = settings(TSET.SceneSettings, viscosity=4.5, h=0.3)
    p = TSC.params_from_settings(s, device="cpu")
    assert abs(float(p.viscosity) - 4.5) < 1e-6
    assert abs(float(p.mass) - 1000.0 * (0.85 * 0.3) ** 3) < 1e-3


def test_live_box_growth_retracks_grid():
    s = settings(TSET.SceneSettings)
    sc = TSC.Scene(settings=s, device="cpu")
    jsc = JSC.Scene(settings=settings(JSET.SceneSettings),
                    neighbor_impl="cell")
    dims0 = sc.config.grid_dims
    assert dims0 == jsc.config.grid_dims
    big = dataclasses.replace(s, box_half=[2.0 * v for v in s.box_half])
    assert not TSET.needs_respawn(s, big)
    sc.apply_settings(big)
    jsc.apply_settings(JSET.SceneSettings(**dataclasses.asdict(big)))
    dims1 = sc.config.grid_dims
    assert dims1 == jsc.config.grid_dims
    assert all(d1 > d0 for d1, d0 in zip(dims1, dims0))
    req = compute_grid_dims(big.shape_type,
                            np.asarray(big.box_half, np.float32),
                            np.asarray(big.box_euler, np.float32), big.h)
    assert all(c >= r for c, r in zip(dims1, req))
    assert sc.update(0.016, max_substeps=1) == 1
    assert np.isfinite(sc.state.pos.numpy()).all()
    sc.apply_settings(s)
    assert sc.config.grid_dims == dims1


def test_quicksets_match_reference_bundles():
    assert TQ.QUICKSETS == JQ.QUICKSETS
    s = TSET.SceneSettings()
    for name in ("stable", "splashy"):
        got = TQ.apply_quickset(s, name)
        want = JQ.apply_quickset(JSET.SceneSettings(), name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(KeyError):
        TQ.apply_quickset(s, "nope")


def test_key_controller_live_controls():
    scene = TSC.Scene(settings=settings(TSET.SceneSettings,
                                        particle_count=256), device="cpu")
    kc = KeyController(scene, out=open(os.devnull, "w"))
    pal0 = scene.settings.palette_id
    assert kc.handle("]")
    assert scene.settings.palette_id == (pal0 + 1) % 24
    assert kc.handle("[")
    assert scene.settings.palette_id == pal0
    mode0 = scene.settings.render_mode
    kc.handle("m")
    assert scene.settings.render_mode == (mode0 + 1) % 3
    for key, attr in (("t", "attractor_on"), ("f", "fountain_on"),
                      ("b", "audio_enabled")):
        before = getattr(scene.settings, attr)
        kc.handle(key)
        assert getattr(scene.settings, attr) != before, key
    yaw0 = scene.camera.yaw_deg
    kc.handle("d")
    assert scene.camera.yaw_deg == pytest.approx(yaw0 + 6.0)
    dist0 = scene.camera.distance
    kc.handle("-")
    assert scene.camera.distance == pytest.approx(dist0 * 1.1)
    kc.handle("2")
    assert scene.settings.render_mode == JSC.AP.apply_art_preset(
        JSET.SceneSettings(), 1).render_mode
    kc.handle(" ")
    assert kc.paused
    kc.handle("r")
    assert scene.pending_reset
    assert not kc.handle("q")
    with kc:
        assert kc.poll()


def test_key_controller_quickset_and_param_mode():
    scene = TSC.Scene(settings=settings(TSET.SceneSettings,
                                        particle_count=256), device="cpu")
    kc = KeyController(scene, out=open(os.devnull, "w"))
    kc.handle("U")
    assert scene.settings.gas_constant == 6000.0 and scene.pending_reset
    scene.pending_reset = False
    entries = param_entries()
    from sph_tpu.app.keys import param_entries as jax_entries
    assert entries == jax_entries()
    labels = [e[0] for e in entries]
    kc.handle("p")
    assert kc.param_mode
    kc.param_idx = labels.index("sim.gasConstant")
    g0 = scene.settings.gas_constant
    kc.handle("+")
    assert scene.settings.gas_constant == pytest.approx(g0 * 1.1)
    assert not scene.pending_reset
    kc.handle("0")
    assert scene.settings.gas_constant == 2000.0
    kc.param_idx = labels.index("box.half.y")
    h0 = scene.settings.box_half[1]
    kc.handle("-")
    assert scene.settings.box_half[1] == pytest.approx(h0 - h0 * 0.1)
    kc.param_idx = labels.index("water.smoothIter")
    it0 = scene.settings.smooth_iterations
    kc.handle("+")
    assert scene.settings.smooth_iterations == it0 + 1
    kc.param_idx = labels.index("sim.particleCount")
    kc.handle("+")
    assert scene.settings.particle_count == 257
    i0 = kc.param_idx
    kc.handle("j")
    kc.handle("K")
    assert kc.param_idx == (i0 + 1 - 10) % len(entries)
    kc.handle("p")
    assert not kc.param_mode


# --- the PIL-free PNG reader and the stencil -----------------------------

def png_with_filters(img: np.ndarray, filters) -> bytes:
    """An 8-bit PNG of ``img`` ([H, W] grey or [H, W, C]) whose row y uses
    filter ``filters[y % len(filters)]``, encoded here by PNG's rules."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = img.reshape(h, w * ch).astype(np.int32)
    out = bytearray()
    prev = np.zeros(w * ch, np.int32)
    for y in range(h):
        kind = filters[y % len(filters)]
        cur = rows[y]
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        out.append(kind)
        out += ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_read_png_all_filters_against_pil(tmp_path, channels):
    rng = np.random.default_rng(channels)
    shape = (23, 37) if channels == 1 else (23, 37, channels)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    img[5:9] = 255                               # runs, saturated sums
    path = tmp_path / "f.png"
    path.write_bytes(png_with_filters(img, [0, 1, 2, 3, 4]))
    got = read_png(str(path))
    np.testing.assert_array_equal(got, img)
    with Image.open(path) as im:
        np.testing.assert_array_equal(got, np.asarray(im))
        np.testing.assert_array_equal(luma(got), np.asarray(im.convert("L")))
    # PIL's own encoder (its choice of filters)
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[channels]
    Image.fromarray(img, mode).save(tmp_path / "pil.png")
    with Image.open(tmp_path / "pil.png") as im:
        got = read_png(str(tmp_path / "pil.png"))
        np.testing.assert_array_equal(got, np.asarray(im))
        np.testing.assert_array_equal(luma(got), np.asarray(im.convert("L")))


def test_read_png_refuses_other_kinds(tmp_path):
    Image.fromarray(np.zeros((4, 4), np.uint8), "L").convert("P").save(
        tmp_path / "p.png")
    with pytest.raises(ValueError, match="8-bit grey, RGB or RGBA"):
        read_png(str(tmp_path / "p.png"))
    (tmp_path / "x.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(tmp_path / "x.png"))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_load_stencil_png_matches_jax(tmp_path, mode):
    """A logo with more bright pixels than the stencil's capacity (the
    targets subsampled by the same seeded choice), through both scenes."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (80, 120, 3)).astype(np.uint8)
    img[20:60, 30:90] = 250
    pil = Image.fromarray(img, "RGB").convert(mode)
    path = str(tmp_path / f"logo_{mode}.png")
    pil.save(path)
    port = port_scene(particle_count=256)
    jsc = jax_scene(particle_count=256)
    n = port.load_stencil_png(path)
    assert n == jsc.load_stencil_png(path) == TSC.STENCIL_CAPACITY
    np.testing.assert_array_equal(port.stencil_targets, jsc.stencil_targets)
    assert int(port.buffers.stencil_count) == n
    np.testing.assert_array_equal(port.buffers.stencil_targets.numpy(),
                                  np.asarray(jsc.buffers.stencil_targets))
    assert port.config.stencil_capacity == TSC.STENCIL_CAPACITY
    port.respawn()                      # the targets survive a respawn
    assert int(port.buffers.stencil_count) == n
    dark = str(tmp_path / "dark.png")
    Image.fromarray(np.zeros((8, 8), np.uint8), "L").save(dark)
    assert port.load_stencil_png(dark) == 0 and port.stencil_targets is None
