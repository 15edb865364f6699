"""The port's ``audio/`` (bands, analyze, reactive, capture) against
``sph_tpu.audio`` on the CPU, the cases of ``tests/test_audio.py`` run
through both packages on the same numpy inputs.

Tolerances:

- the bands, the envelope states and the drops: bit-equal to the JAX
  package's (the same C++ core, ``native/audio_dsp.cpp``, built by each
  package from its own copy; the JAX one into a directory of this module's);
- the plain band loop (``bands.process_frames_plain``) within 2e-5 of the
  native core, as ``tests/test_audio.py`` holds the JAX ``lax.scan``
  fallback, and within 2e-5 of that fallback.

The mp3 and capture cases use the JAX suite's stand-ins: ``cat`` as the
mp3 decoder over WAV bytes, and a fake ``parec`` on ``PATH`` that writes
s16le PCM to stdout.
"""
import ctypes
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
from scipy.io import wavfile

from sph_tpu import native as jax_native
from sph_tpu.audio import analyze as JA
from sph_tpu.audio import bands as JB
from sph_tpu.audio import reactive as JRE
from sph_tpu_torch.audio import analyze as TA
from sph_tpu_torch.audio import bands as TB
from sph_tpu_torch.audio import reactive as TRE
from sph_tpu_torch.audio.capture import SystemCaptureSource

FS = 48000.0
PLAIN_ATOL = 2e-5          # tests/test_audio.py:76


def tone(hz, seconds, fs=FS, amp=1.0):
    t = np.arange(int(seconds * fs), dtype=np.float64)
    return (amp * np.sin(2 * math.pi * hz * t / fs)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_dsp(tmp_path_factory):
    """The JAX package's audio core built from its own source into a
    directory of this module's (``sph_tpu.native.load`` would build into
    the package's ``_build/``, which another test process may be writing
    at the same time)."""
    src = os.path.join(os.path.dirname(jax_native.__file__), "audio_dsp.cpp")
    out = str(tmp_path_factory.mktemp("jax_native") / "audio_dsp.so")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src,
                    "-o", out], check=True, capture_output=True)
    return ctypes.CDLL(out)


@pytest.fixture(autouse=True)
def jax_native_lib(jax_dsp, monkeypatch):
    monkeypatch.setitem(jax_native._CACHE, "audio_dsp", jax_dsp)


def assert_bands_equal(want, got):
    for w, g in zip(want[:3], got[:3]):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[3].as_array(), want[3].as_array())


def steady(bands):
    q = max(1, len(bands[0]) // 4)
    return [b[-q:].mean() for b in bands[:3]]


@pytest.mark.parametrize("hz, band, leaks", [
    (60.0, 0, (None, 0.35, 0.05)),        # tests/test_audio.py:28-35
    (800.0, 1, (0.3, None, 0.35)),
    (8000.0, 2, (0.05, 0.4, None)),
])
def test_band_separation(hz, band, leaks):
    mono = tone(hz, 2.0)
    got = TB.process_frames(mono, FS, 30)
    assert_bands_equal(JB.process_frames(mono, FS, 30), got)
    env = steady(got)
    assert env[band] > 0.5
    for k, leak in enumerate(leaks):
        if leak is not None:
            assert env[k] < leak * env[band], (k, env)


def test_envelope_attack_release_timing():
    mono = np.concatenate([tone(60.0, 1.0), np.zeros(int(FS), np.float32)])
    got = TB.process_frames(mono, FS, fps=100)
    assert_bands_equal(JB.process_frames(mono, FS, fps=100), got)
    bass = got[0]
    peak = bass[:100].max()
    assert bass[5] > 0.5 * peak
    assert bass[150] < 0.2 * peak
    assert bass[199] < bass[110]


def test_plain_loop_matches_native_and_scan():
    """The plain version (a numpy float32 loop over ``process_sample``)
    against the native core and against the JAX package's ``lax.scan``
    fallback, from a zero state and from a carried one."""
    mono = (tone(60, 0.25) + tone(800, 0.25, amp=0.5)
            + np.float32(0.1) * np.sin(
                np.arange(int(0.25 * FS)) * 0.9).astype(np.float32))
    start = TB.BandState(0.1, -0.2, 0.05, 0.3, 0.4, 0.1, 0.2)
    for state in (None, start):
        native = TB.process_frames(mono, FS, 30, state=state)
        plain = TB.process_frames_plain(mono, FS, 30, state=state)
        jstate = JB.BandState(*start.as_array()) if state else JB.BandState()
        scan = JB._process_frames_scan(
            mono, JB._frame_ends(len(mono), FS, 30), FS, 15.0, 250.0, jstate)
        assert len(plain[0]) == len(native[0]) == 7
        for a, b, c in zip(native[:3], plain[:3], scan[:3]):
            np.testing.assert_allclose(b, a, rtol=0, atol=PLAIN_ATOL)
            np.testing.assert_allclose(b, c, rtol=0, atol=PLAIN_ATOL)
        np.testing.assert_allclose(plain[3].as_array(),
                                   native[3].as_array(), rtol=0,
                                   atol=PLAIN_ATOL)


def test_envelope_clamped_to_4():
    mono = tone(60.0, 1.0, amp=50.0)
    got = TB.process_frames(mono, FS, 30)
    assert_bands_equal(JB.process_frames(mono, FS, 30), got)
    assert got[0].max() <= TB.ENV_CLAMP + 1e-6
    assert TB.process_frames_plain(mono[:4800], FS, 30)[0].max() \
        <= TB.ENV_CLAMP


def test_constants_and_frame_ends_match():
    for name in ("ENV_CLAMP", "BASS_HZ", "MID_LP_HZ", "MID_HP_HZ",
                 "TREBLE_HZ", "DEFAULT_ATTACK_MS", "DEFAULT_RELEASE_MS"):
        assert getattr(TB, name) == getattr(JB, name), name
    for n, fs, fps in ((48000, 48000.0, 30), (44100, 44100.0, 24),
                       (1000, 22050.0, 60), (12345, 48000.0, 7)):
        np.testing.assert_array_equal(TB._frame_ends(n, fs, fps),
                                      JB._frame_ends(n, fs, fps))
    assert TB.filter_alpha(150.0, FS) == JB.filter_alpha(150.0, FS)
    assert TB.envelope_coeff(0.0, FS) == JB.envelope_coeff(0.0, FS)


@pytest.mark.parametrize("case", ["synthetic", "adaptive", "many",
                                  "short"])
def test_detect_drops(case):
    """tests/test_audio.py:85-106, and a track with more than 16 drops
    and one too short for any."""
    fps = 30
    if case == "synthetic":
        bass = np.full(40 * fps, 0.1, np.float32)
        for t0 in (10.0, 20.0, 22.0):
            bass[int(t0 * fps):int(t0 * fps) + fps] = 2.0
        gap = 8.0
    elif case == "adaptive":
        bass = np.full(20 * fps, 1.5, np.float32)
        bass[int(10 * fps):int(10.5 * fps)] = 2.0
        gap = 0.0
    elif case == "many":
        bass = np.random.default_rng(3).uniform(0, 1.5, 60 * fps) \
            .astype(np.float32)
        gap = 0.5
    else:
        bass = np.asarray([3.0], np.float32)
        gap = 8.0
    got = TA.detect_drops(bass, fps, min_gap_sec=gap)
    assert got == JA.detect_drops(bass, fps, min_gap_sec=gap)
    if case == "synthetic":
        assert len(got) == 2 and abs(got[0] - 10.0) < 0.1 \
            and abs(got[1] - 20.0) < 0.1
    elif case == "adaptive":
        assert all(abs(d - 10.0) > 0.1 for d in got)
    elif case == "many":
        assert len(got) == 16
    else:
        assert got == []


def test_wav_roundtrip_and_analyze(tmp_path):
    path = str(tmp_path / "t.wav")
    stereo = np.stack([tone(60.0, 1.0), tone(60.0, 1.0)], axis=1)
    wavfile.write(path, int(FS), (stereo * 32767).astype(np.int16))
    mono, rate = TA.decode_to_mono(path)
    jmono, jrate = JA.decode_to_mono(path)
    assert rate == jrate == int(FS) and len(mono) == int(FS)
    np.testing.assert_array_equal(mono, jmono)
    np.testing.assert_allclose(mono[:64], stereo[:64, 0], atol=1e-3)
    for max_seconds in (0.0, 0.5):
        res = TA.analyze_track(path, fps=30, max_seconds=max_seconds)
        want = JA.analyze_track(path, fps=30, max_seconds=max_seconds)
        assert res.ok and res.frame_count == want.frame_count
        assert res.sample_rate == want.sample_rate
        for k in ("bass", "mid", "treble"):
            np.testing.assert_array_equal(getattr(res, k), getattr(want, k))
    assert TA.analyze_track(path, fps=30).frame_count == 30
    assert TA.analyze_track(path, fps=30).bass[-1] > 0.4


@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32"])
def test_wav_sample_formats(tmp_path, dtype):
    path = str(tmp_path / f"{dtype}.wav")
    sig = tone(220.0, 0.2, fs=8000.0, amp=0.5)
    data = {"uint8": (sig * 127 + 128).astype(np.uint8),
            "int32": (sig * 2 ** 31 * 0.9).astype(np.int32),
            "float32": sig}[dtype]
    wavfile.write(path, 8000, data)
    mono, rate = TA.decode_to_mono(path)
    jmono, jrate = JA.decode_to_mono(path)
    assert rate == jrate == 8000
    np.testing.assert_array_equal(mono, jmono)


def test_analyze_track_errors(tmp_path, monkeypatch):
    assert "unsupported" in TA.analyze_track(str(tmp_path / "x.bin")).error
    monkeypatch.delenv("SPH_AUDIO_DECODER", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert "decoder" in TA.analyze_track(str(tmp_path / "x.mp3")).error
    assert TA.analyze_track("").error
    assert not TA.ReelAnalysis().ok


def test_reactive_pump_tone():
    levels = []
    for mod in (TRE, JRE):
        r = mod.AudioReactive(mod.ToneSource(((60.0, 1.0),)), realtime=False)
        r.pump(n_packets=100)
        r2 = mod.AudioReactive(mod.ToneSource(((60.0, 1.0),)),
                               realtime=False)
        r2.gain = 0.1
        r2.pump(n_packets=100)
        levels.append([r.get_bass(), r.get_mid(), r.get_treble(),
                       r2.get_bass()])
    (b, m, t, b2), want = levels
    assert levels[0] == want
    assert b > 0.3 and t < 0.1 * b and b2 < b * 0.3


def test_reactive_thread_lifecycle():
    r = TRE.AudioReactive(TRE.ToneSource(((60.0, 1.0),)), realtime=False)
    assert r.status_text == "Idle"
    r.start()
    assert r.is_running
    r.stop()
    assert not r.is_running and not r.is_capturing


def test_offline_matches_live():
    mono = tone(60.0, 0.5) + tone(3500.0, 0.5, amp=0.3)
    offline = TB.process_frames(mono, FS, 30)[3]
    live = TB.BandState()
    for i in range(0, len(mono), 1024):
        live = TB.process_block(mono[i:i + 1024], FS, state=live)
    np.testing.assert_allclose(live.as_array(), offline.as_array(), atol=1e-6)
    jlive = JB.BandState()
    for i in range(0, len(mono), 1024):
        jlive = JB.process_block(mono[i:i + 1024], FS, state=jlive)
    np.testing.assert_array_equal(live.as_array(), jlive.as_array())


def test_file_source_streams_the_track(tmp_path):
    path = str(tmp_path / "t.wav")
    wavfile.write(path, 22050, (tone(60.0, 0.3, fs=22050.0) * 32767)
                  .astype(np.int16))
    got = []
    for mod in (TRE, JRE):
        src = mod.FileSource(path)
        r = mod.AudioReactive(src, realtime=False)
        r.pump(n_packets=1000)
        got.append((src.sample_rate, r.get_bass(), r.get_treble()))
        assert src.read_packet(1024) is None
    assert got[0] == got[1] and got[0][1] > 0.1


def test_mp3_decode_via_external_matches_wav_twin(tmp_path, monkeypatch):
    sr = 22050
    t = np.arange(sr * 2, dtype=np.float32) / sr
    sig = (0.6 * np.sin(2 * np.pi * 60.0 * t)
           + 0.2 * np.sin(2 * np.pi * 1000.0 * t))
    wav = tmp_path / "track.wav"
    wavfile.write(wav, sr, (sig * 32767).astype(np.int16))
    mp3 = tmp_path / "track.mp3"
    shutil.copyfile(wav, mp3)
    monkeypatch.setenv("SPH_AUDIO_DECODER", "cat")
    ra = TA.analyze_track(str(wav), fps=30)
    rb = TA.analyze_track(str(mp3), fps=30)
    rj = JA.analyze_track(str(mp3), fps=30)
    assert ra.ok and rb.ok and rj.ok
    for k in ("bass", "mid", "treble"):
        np.testing.assert_array_equal(getattr(ra, k), getattr(rb, k))
        np.testing.assert_array_equal(getattr(rb, k), getattr(rj, k))


def test_mp3_decode_without_decoder_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("SPH_AUDIO_DECODER", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    mp3 = tmp_path / "x.mp3"
    mp3.write_bytes(b"\xff\xfb\x90\x00")
    with pytest.raises(ValueError, match="no external audio decoder"):
        TA.decode_to_mono(str(mp3))


def test_system_capture_source_streams_pcm_through_reactor(tmp_path,
                                                           monkeypatch):
    """A fake ``parec`` on ``PATH`` (s16le PCM on stdout, a 60 Hz tone)
    found by ``SystemCaptureSource()`` with no command, driving the
    reactor's envelopes through the native core."""
    parec = tmp_path / "parec"
    parec.write_text(
        f"#!{sys.executable}\n"
        "import sys, math, struct\n"
        "sr = 48000\n"
        "pcm = b''.join(\n"
        "    struct.pack('<h', int(0.8 * 32767\n"
        "                          * math.sin(2 * math.pi * 60.0 * i / sr)))\n"
        "    for i in range(sr * 2))\n"
        "for i in range(0, len(pcm), 4800):\n"
        "    sys.stdout.buffer.write(pcm[i:i + 4800])\n"
        "    sys.stdout.buffer.flush()\n")
    parec.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path) + os.pathsep
                       + os.environ.get("PATH", ""))
    src = SystemCaptureSource(sample_rate=48000)
    assert src._argv[0] == "parec" and "--rate=48000" in src._argv
    reactor = TRE.AudioReactive(source=src)
    reactor.start()
    deadline = time.time() + 20.0
    bass = 0.0
    while time.time() < deadline:
        bass = reactor.get_bass()
        if bass > 0.05:
            break
        time.sleep(0.05)
    reactor.stop()
    src.close()
    assert bass > 0.05, f"bass envelope never rose (got {bass})"
    assert reactor.get_bass() >= reactor.get_treble()


def test_system_capture_source_no_tool_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no system-audio capture"):
        SystemCaptureSource()
