"""The port's host data layer and frame driver against ``sph_tpu``:
``io/presets`` (byte for byte on ``presets/*.txt``), ``scene/settings``
(the settings and the KV table field by field), ``scene/art_presets``,
``scene/scene.params_from_settings``, ``scene/reaction`` over frames with
bands above and below their thresholds, and ``scene/river`` with
``core/state.spawn_river`` (bit-identical numpy)."""
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from sph_tpu.core import state as JS
from sph_tpu.io import presets as JIO
from sph_tpu.scene import art_presets as JAP
from sph_tpu.scene import reaction as JR
from sph_tpu.scene import river as JRV
from sph_tpu.scene import scene as JSC
from sph_tpu.scene import settings as JSET
from sph_tpu_torch.core import state as TS
from sph_tpu_torch.core.convert import params_from_numpy, state_from_numpy
from sph_tpu_torch.io import presets as TIO
from sph_tpu_torch.scene import art_presets as TAP
from sph_tpu_torch.scene import reaction as TR
from sph_tpu_torch.scene import river as TRV
from sph_tpu_torch.scene import scene as TSC
from sph_tpu_torch.scene import settings as TSET

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET_FILES = sorted(glob.glob(os.path.join(REPO, "presets", "*.txt")))
# the velocities after a few frames of impulses (each within 1e-5 of
# JAX's, tests/test_torch_impulses.py)
VEL_ATOL = 5e-5


def to_numpy(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def port_settings(s: JSET.SceneSettings) -> TSET.SceneSettings:
    return TSET.SceneSettings(**dataclasses.asdict(s))


def assert_params_equal(tp, jp):
    want = to_numpy(jp)
    assert tp.shape_type == int(want.pop("shape_type"))
    for k, v in want.items():
        np.testing.assert_array_equal(getattr(tp, k).cpu().numpy(), v,
                                      err_msg=k)


# --- io/presets ---------------------------------------------------------------

def test_preset_files_exist():
    assert len(PRESET_FILES) == 14


@pytest.mark.parametrize("path", PRESET_FILES,
                         ids=[os.path.basename(p) for p in PRESET_FILES])
def test_preset_file_round_trips_byte_for_byte(path, tmp_path):
    """Parsed, applied, gathered and saved again: the port writes the
    file's bytes, and the same KV and settings as the JAX package."""
    text = open(path, newline="").read()
    kv = TIO.load_file(path)
    assert kv == JIO.load_file(path) and kv["version"] == "1"
    assert TIO.serialize(kv) == text == JIO.serialize(JIO.parse(text))
    s = TSET.apply_preset(TSET.SceneSettings(), kv)
    js = JSET.apply_preset(JSET.SceneSettings(), kv)
    assert dataclasses.asdict(s) == dataclasses.asdict(js)
    out = tmp_path / "again.txt"
    assert TIO.save_file(str(out), TSET.gather_preset(s))
    assert out.read_bytes() == JIO.serialize(JSET.gather_preset(js)).encode()
    assert TIO.list_presets(str(tmp_path)) == ["again"]


def test_preset_io_helpers_match_jax():
    text = ("# comment\r\nversion=1\r\nb=2\r\nb=3\r\n=x\r\ngarbage\r\n"
            "box.half=1, 2 ,3\r\nsim.h=0.3abc\r\n")
    assert TIO.parse(text) == JIO.parse(text)
    a = {"x": "1.5", "v": "0,0,1", "s": "one", "only_a": "1"}
    b = {"x": "2.5", "v": "1,1,0", "s": "two", "only_b": "7"}
    for t in (0.0, 0.25, 0.5, 1.0):
        assert TIO.lerp_kv(a, b, t) == JIO.lerp_kv(a, b, t)
    for raw in ("My Preset!", "  ", "ok_name-1", "ünï"):
        assert TIO.sanitize_name(raw) == JIO.sanitize_name(raw)
    kv = {"f": "1e-3 ", "i": "-12x", "b": "0", "f3": "1 2 3", "bad": "q"}
    for key in ("f", "i", "b", "f3", "bad", "missing"):
        assert TIO.get_f(kv, key, 9.0) == JIO.get_f(kv, key, 9.0)
        assert TIO.get_i(kv, key, 9) == JIO.get_i(kv, key, 9)
        assert TIO.get_b(kv, key, True) == JIO.get_b(kv, key, True)
        assert TIO.get_f3(kv, key, [7, 8, 9]) == JIO.get_f3(kv, key,
                                                             [7, 8, 9])
    assert TIO.load_file("/no/such/file.txt") is None
    assert TIO.list_presets("/no/such/dir") == []


# --- scene/settings ----------------------------------------------------------

def test_settings_and_kv_table_match_jax():
    """Every field of ``SceneSettings`` with its default, and every row of
    the KV table, as the JAX package's."""
    tf = [(f.name, f.type) for f in dataclasses.fields(TSET.SceneSettings)]
    jf = [(f.name, f.type) for f in dataclasses.fields(JSET.SceneSettings)]
    assert tf == jf and len(tf) == 135
    assert (dataclasses.asdict(TSET.SceneSettings())
            == dataclasses.asdict(JSET.SceneSettings()))
    assert TSET.PRESET_FIELDS == JSET.PRESET_FIELDS
    assert TSET.STRUCTURAL_KEYS == JSET.STRUCTURAL_KEYS
    assert (TSET.gather_preset(TSET.SceneSettings())
            == JSET.gather_preset(JSET.SceneSettings()))


def test_apply_preset_and_needs_respawn_match_jax():
    kv = JSET.gather_preset(JAP.apply_art_preset(JSET.SceneSettings(), 5))
    kv["sim.particleCount"] = "12"        # clamped to 1000 when structural
    kv["unknown.key"] = "3"
    for structural in (True, False):
        got = TSET.apply_preset(TSET.SceneSettings(), kv, structural)
        want = JSET.apply_preset(JSET.SceneSettings(), kv, structural)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    base = TSET.SceneSettings()
    for change in ({"particle_count": 9000}, {"shape_type": 3},
                   {"box_half": [5.0, 5.0, 5.0]}, {"mix_pattern": 2},
                   {"gravity_y": -10.0}):
        new = dataclasses.replace(base, **change)
        assert TSET.needs_respawn(base, new) == JSET.needs_respawn(
            JSET.SceneSettings(), JSET.SceneSettings(**dataclasses.asdict(
                new)))


@pytest.mark.parametrize("which", [0, 10, 13])
def test_to_viz_params_matches_jax(which):
    s = JAP.apply_art_preset(JSET.SceneSettings(), which)
    s.two_color = which == 10
    for kw in ({}, dict(anim_time=1.25, hue_shift_live=12.0,
                        bright_mul_live=1.7)):
        got = dataclasses.asdict(TSET.to_viz_params(port_settings(s), **kw))
        want = dataclasses.asdict(JSET.to_viz_params(s, **kw))
        assert got == want


# --- scene/art_presets and params_from_settings ------------------------------

@pytest.mark.parametrize("which", list(range(14)) + [-3, 99])
def test_art_preset_applied_and_its_params(which):
    """Each art preset (and the clamped out-of-range ones) over a tuned
    canvas, and the FluidParams built from the result."""
    tuned = dict(gravity_y=-5.0, bloom_strength=0.7, particle_count=20000,
                 box_center=[1.0, 2.0, 3.0])
    got = TAP.apply_art_preset(TSET.SceneSettings(**tuned), which)
    want = JAP.apply_art_preset(JSET.SceneSettings(**tuned), which)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.audio_enabled
    assert TAP.ART_PRESET_NAMES == JAP.ART_PRESET_NAMES
    assert_params_equal(TSC.params_from_settings(got, device="cpu"),
                        JSC.params_from_settings(want))


@pytest.mark.parametrize("seed", [0, 1, 2, 7, 1234])
def test_surprise_me_matches_jax(seed):
    got = TAP.surprise_me(TSET.SceneSettings(), seed)
    want = JAP.surprise_me(JSET.SceneSettings(), seed)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert_params_equal(TSC.params_from_settings(got, device="cpu"),
                        JSC.params_from_settings(want))


def test_params_from_settings_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cpu"):
        TSC.params_from_settings(TSET.SceneSettings())


# --- scene/reaction ------------------------------------------------------------

# (bass, mid, treble) of each frame: over, under and between the
# thresholds of 0.05
BANDS = ((0.9, 0.2, 0.1), (0.01, 0.3, 0.0), (0.0, 0.0, 0.0),
         (0.6, 0.04, 0.5))


def reaction_settings():
    """A look that drives every impulse: the torus preset's vortex, the
    attractor, gravity spin, silk flow, the logo and the continuous
    wave."""
    s = JAP.apply_art_preset(JSET.SceneSettings(), 10)
    s.shape_type, s.box_half = 0, [3.0, 3.0, 3.0]
    s.attractor_on, s.spin_on = True, True
    s.attractor_pos = [0.0, -1.5, 0.0]
    s.silk_strength, s.silk_audio = 3.0, 2.0
    s.continuous_wave, s.wave_dir = True, 4
    s.trail_half_life = 0.4
    return s


@pytest.mark.parametrize("logo", [False, True])
def test_reaction_matches_jax_over_frames(logo):
    """Four frames of ``drive_continuous_wave`` then ``drive_audio_reaction``
    on a 2k spawn: the same velocities, gravity, phases and live values,
    and the impulses did move the fluid."""
    from sph_tpu.core import params as JP
    s = reaction_settings()
    spawn = JS.spawn_standard(2000, box_half=tuple(s.box_half), seed=3)
    js = JS.state_from_spawn(spawn)
    jp = JSC.params_from_settings(s)
    ts = state_from_numpy(to_numpy(js), device="cpu")
    tp = params_from_numpy(to_numpy(jp), device="cpu")
    targets = (np.random.default_rng(4).uniform(-2, 2, (300, 3))
               .astype(np.float32) if logo else None)
    jph, tph = JR.ReactionPhases(), TR.ReactionPhases()
    ts_set = port_settings(s)
    dt = 1.0 / 60.0
    for bass, mid, treble in BANDS:
        js, jph = JR.drive_continuous_wave(js, s, jph, dt)
        ts, tph = TR.drive_continuous_wave(ts, ts_set, tph, dt)
        js, jp, jph, jlive = JR.drive_audio_reaction(
            js, jp, s, jph, bass, mid, treble, dt, stencil_targets=targets)
        ts, tp, tph, tlive = TR.drive_audio_reaction(
            ts, tp, ts_set, tph, bass, mid, treble, dt,
            stencil_targets=targets)
        assert dataclasses.asdict(tph) == dataclasses.asdict(jph)
        assert dataclasses.asdict(tlive) == dataclasses.asdict(jlive)
        np.testing.assert_array_equal(tp.gravity.numpy(),
                                      np.asarray(jp.gravity))
        np.testing.assert_allclose(ts.vel.numpy(), np.asarray(js.vel),
                                   rtol=0, atol=VEL_ATOL)
    assert isinstance(jp, JP.FluidParams) and tph.silk_time > 0
    assert float(ts.vel.abs().max()) > 0.5
    assert tlive.trail_decay > 0


def test_continuous_wave_off_leaves_the_state():
    s = port_settings(JSET.SceneSettings())
    ts = TS.state_from_spawn(TS.spawn_standard(300, seed=1), device="cpu")
    ph = TR.ReactionPhases()
    out, ph2 = TR.drive_continuous_wave(ts, s, ph, 0.1)
    assert out is ts and ph2 is ph


# --- scene/river and spawn_river -------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5, 42])
def test_river_terrain_and_spawn_are_bit_identical(seed):
    got_spec, want_spec = TRV.RiverSpec.random(seed), JRV.RiverSpec.random(
        seed)
    gd, wd = dataclasses.asdict(got_spec), dataclasses.asdict(want_spec)
    np.testing.assert_array_equal(gd.pop("noise_phases"),
                                  wd.pop("noise_phases"))
    assert gd == wd
    center, half = (0.5, -1.0, 0.25), (7.0, 6.0, 8.0)
    for res in ((64, 64), (48, 80)):
        got = TRV.generate_river_terrain(got_spec, center, half, res=res)
        want = JRV.generate_river_terrain(want_spec, center, half, res=res)
        assert got.dtype == np.float32 and got.shape == res
        np.testing.assert_array_equal(got, want)
    kw = dict(box_center=center, box_half=half,
              terrain_min=(center[0] - half[0], center[2] - half[2]),
              terrain_size=(2 * half[0], 2 * half[2]),
              river_amp=want_spec.amp, river_freq=want_spec.freq,
              river_phase=want_spec.phase,
              river_channel_width=want_spec.channel_width, seed=seed)
    terrain = JRV.generate_river_terrain(want_spec, center, half)
    for n in (2000, 40000):          # the second tops up at the emitter
        got, want = (mod.spawn_river(n, terrain, **kw) for mod in (TS, JS))
        assert got.count == want.count == n
        for f in ("pos", "vel", "ghost", "face", "color_group"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
    assert (want.vel[:, 2] == 2.0).any()


@pytest.mark.parametrize("seed", [0, 9])
def test_river_params_match_jax(seed):
    spec = JRV.RiverSpec.random(seed)
    center, half = (0.0, 1.0, -0.5), (7.0, 7.0, 6.0)
    s = JSET.SceneSettings()
    jp = JRV.river_params(JSC.params_from_settings(s), spec, center, half)
    tp = TRV.river_params(TSC.params_from_settings(port_settings(s),
                                                   device="cpu"),
                          TRV.RiverSpec(**dataclasses.asdict(spec)), center,
                          half)
    assert_params_equal(tp, jp)
    assert tp.river_emitter_pos.device.type == "cpu"


def test_zeros_state_matches_jax():
    got = TS.ParticleState.zeros(300, device="cpu")
    want = JS.ParticleState.zeros(300)
    for k, v in to_numpy(want).items():
        np.testing.assert_array_equal(getattr(got, k).numpy(), v, err_msg=k)
    assert got.pos.data_ptr() != got.vel.data_ptr()
