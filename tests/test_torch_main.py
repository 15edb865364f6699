"""The port's command line (``app/main.py``) against ``sph_tpu.app.main``
on the CPU, through ``main(argv, device="cpu")``: every subcommand (``run``,
``bench``, ``reel``, ``screenshot``, ``art``, ``presets``) and the
``--impl`` mapping.

The reel of a WAV track written here (a bass tone with one hit and a
treble tone, 2 frames at 30 fps, 1,000 asked rows at 64x96, the default
look but for the smoothing, given no round by ``--preset``, and 1 ms
substeps: 34 a frame) is held to the JAX package's ``main(["reel", ...])``
with ``--impl cell``: the printed drops and frame count equal, the mux
scripts equal, and in each frame at most 1% of the pixels with a channel
more than 1/255 apart (the tolerance of ``tests/test_torch_reel.py``, which
holds the default look's five rounds).  The JAX package compiles its
unrolled smoothing anew for each count of rounds, 3-10 s in one process
and several times that beside the Tier-1 run's other workers.
"""
import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sph_tpu import native as jax_native
from sph_tpu.app import main as JMAIN
from sph_tpu_torch.app import main as TMAIN
from sph_tpu_torch.viz.splat import read_png

REEL_SHARE = 0.01
REEL_ARGS = ["--particles", "1000", "--width", "64", "--height", "96",
             "--seed", "1"]


@pytest.fixture(scope="module")
def jax_libs(tmp_path_factory):
    """The JAX package's host libraries built from its own sources into a
    directory of this module's (``sph_tpu.native.load`` would build into
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


def write_track(path, seconds=2.2 / 30, fs=48000):
    """A bass tone with one hit at a third of the track, plus a treble
    tone, as 16-bit mono."""
    t = np.arange(int(seconds * fs)) / fs
    bass = 0.3 * np.sin(2 * np.pi * 55.0 * t)
    bass[len(t) // 3:] *= 4.0
    sig = bass + 0.1 * np.sin(2 * np.pi * 5000.0 * t)
    wavfile.write(path, fs, (np.clip(sig, -1, 1) * 32767).astype(np.int16))
    return path


def run_main(mod, argv, capsys, **kw):
    mod.main(argv, **kw)
    return capsys.readouterr()


@pytest.fixture(scope="module")
def track(tmp_path_factory):
    return write_track(str(tmp_path_factory.mktemp("track") / "t.wav"))


def test_reel_matches_jax(tmp_path, track, capsys):
    pdir = tmp_path / "presets"
    pdir.mkdir()
    (pdir / "unsmoothed.txt").write_text("version=1\nwater.smoothIter=0\n")
    args = REEL_ARGS + ["--preset", "unsmoothed", "--preset-dir", str(pdir)]
    out = run_main(TMAIN, ["reel", "--track", track, "--out",
                           str(tmp_path / "port")] + args, capsys,
                   device="cpu")
    got = json.loads(out.out.strip().splitlines()[-1])
    out = run_main(JMAIN, ["reel", "--track", track, "--out",
                           str(tmp_path / "jax"), "--impl", "cell"]
                   + args, capsys)
    want = json.loads(out.out.strip().splitlines()[-1])
    assert got["frames"] == want["frames"] == 2
    assert got["drops"] == want["drops"]
    assert open(got["mux"]).read() == open(want["mux"]).read()
    for f in range(2):
        a = read_png(str(tmp_path / "port" / f"frame_{f:05d}.png"))
        b = read_png(str(tmp_path / "jax" / f"frame_{f:05d}.png"))
        assert a.shape == (96, 64, 3) and (a != a[0, 0]).any()
        off = (np.abs(a.astype(int) - b.astype(int)) > 1).any(-1).mean()
        assert off <= REEL_SHARE, (f, off)


def test_reel_preview_and_errors(tmp_path, track, capsys):
    out = run_main(TMAIN, ["reel", "--track", track, "--out",
                           str(tmp_path / "r"), "--preview", "--window",
                           "40x48", "--particles", "1000"], capsys,
                   device="cpu")
    res = json.loads(out.out.strip().splitlines()[-1])
    assert res["frames"] == 2
    assert read_png(str(tmp_path / "r_preview" / "frame_00001.png")).shape \
        == (48, 27, 3)
    with pytest.raises(SystemExit, match="reel export failed"):
        TMAIN.main(["reel", "--track", str(tmp_path / "none.wav"), "--out",
                    str(tmp_path / "x"), "--particles", "1000"],
                   device="cpu")


def test_entry_point_needs_the_card_by_default(tmp_path, track):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TMAIN.main(["reel", "--track", track, "--out", str(tmp_path),
                    "--particles", "1000"])


def scene_args(**kw):
    ns = argparse.Namespace(particles=1000, impl="auto", shape=0, art=-1,
                            preset="", preset_dir="presets", seed=0,
                            river=False, quickset="", device="cpu")
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


@pytest.mark.parametrize("impl", ["auto", "brute", "brute_pallas", "cell",
                                  "binned", "pallas"])
def test_impl_maps_to_a_port_engine(impl):
    want = {"auto": "cell", "brute": "brute", "brute_pallas": "brute_kernel",
            "cell": "cell", "binned": "cell", "pallas": "cell"}[impl]
    scene = TMAIN._build_scene(scene_args(impl=impl))
    assert scene.neighbor_impl == scene.config.neighbor_impl == want
    assert scene.update(1 / 60, max_substeps=2) == 2
    assert np.isfinite(scene.state.pos.numpy()).all()


def test_scene_flags(tmp_path):
    """--art, --preset, --river and --quickset, as the JAX package applies
    them."""
    pdir = str(tmp_path / "presets")
    river = TMAIN._build_scene(scene_args(art=3, river=True, seed=2))
    assert river.river_spec is not None and river.config.river_mode
    assert river.settings.render_mode == 0 and river.update(1 / 60) == 16
    scene = TMAIN._build_scene(scene_args(quickset="splashy",
                                          preset_dir=pdir))
    assert scene.settings.gas_constant == 6000.0
    scene.save_preset("mine")
    again = TMAIN._build_scene(scene_args(preset="mine", preset_dir=pdir))
    assert again.settings.gas_constant == 6000.0
    with pytest.raises(SystemExit, match="preset not found"):
        TMAIN._build_scene(scene_args(preset="absent", preset_dir=pdir))


def test_art_and_presets_print_as_jax(capsys):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for argv in (["art"], ["presets", "--preset-dir",
                           os.path.join(repo, "presets")]):
        got = run_main(TMAIN, argv, capsys, device="cpu").out
        want = run_main(JMAIN, argv, capsys).out
        assert got == want and len(got.splitlines()) == 14


def test_run_writes_frames(tmp_path, track, capsys):
    out = run_main(TMAIN, ["run", "--frames", "3", "--particles", "1000",
                           "--audio", "--out", str(tmp_path / "f"),
                           "--every", "2", "--width", "48", "--height",
                           "32"], capsys, device="cpu")
    assert "done: 3 frames" in out.out
    names = sorted(os.listdir(tmp_path / "f"))
    assert names == ["frame_00000.png", "frame_00002.png"]
    assert read_png(str(tmp_path / "f" / names[1])).shape == (32, 48, 3)
    out = run_main(TMAIN, ["run", "--frames", "2", "--particles", "1000",
                           "--track", track], capsys, device="cpu")
    assert "done: 2 frames" in out.out


def test_screenshot(tmp_path, capsys):
    path = str(tmp_path / "shot.png")
    out = run_main(TMAIN, ["screenshot", "--out", path, "--width", "48",
                           "--height", "32", "--warmup-frames", "1",
                           "--particles", "1000"], capsys, device="cpu")
    assert f"wrote {path} (48x32)" in out.out
    img = read_png(path)
    assert img.shape == (32, 48, 3) and (img != img[0, 0]).any()


def test_bench_runs_the_port_bench(monkeypatch):
    calls = []

    def call(argv):
        calls.append(argv)
        return 0

    monkeypatch.setattr(subprocess, "call", call)
    with pytest.raises(SystemExit) as exit_info:
        TMAIN.main(["bench", "dam_break_8k", "12"], device="cpu")
    assert exit_info.value.code == 0
    assert calls[0][1:] == ["-m", "sph_tpu_torch.app.bench",
                            "dam_break_8k", "12"]
