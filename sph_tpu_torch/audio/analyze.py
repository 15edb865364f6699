"""Offline track analysis + bass-drop detection (counterpart of
``sph_tpu/audio/analyze.py``, a copy of it over the port's ``bands``).

Rebuild of ``ComponentFramework/ReelExport.{h,cpp}``: decode an audio
file to mono (``ReelExport.cpp:24-67``), compute per-video-frame band
envelopes with the shared DSP (``:101-149``), and detect bass drops with
an adaptive rolling threshold (``:71-99``).  Pure host-side — no GL, no
device code (the reference keeps this module "Pure CPU" by design,
``ReelExport.h:6``).

WAV decodes natively (scipy.io.wavfile).  MP3 (the reference bundles
dr_mp3 for it) decodes through the first external decoder found on
PATH — ``mpg123``, ``ffmpeg`` or ``sox``, each asked to emit WAV on
stdout — via ``_decode_via_external``; the plumbing (subprocess, WAV
parse, downmix, envelope parity with a WAV twin) is covered by tests
with a substitute decoder (``cat`` over WAV bytes).
``SPH_AUDIO_DECODER`` overrides the decoder binary (argv prefix; the
input path is appended, WAV expected on stdout).
"""
from __future__ import annotations

import dataclasses
import io
import os
import shlex
import shutil
import subprocess
from typing import List, Tuple

import numpy as np

from sph_tpu_torch.audio import bands as B


@dataclasses.dataclass
class ReelAnalysis:
    """Per-frame band envelopes for a track (``ReelExport.h:8-16``)."""
    frame_count: int = 0
    sample_rate: int = 0
    bass: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float32))
    mid: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float32))
    treble: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float32))
    error: str = ""

    @property
    def ok(self) -> bool:
        return self.frame_count > 0 and not self.error


def _wav_to_mono(rate: int, data: np.ndarray) -> Tuple[np.ndarray, int]:
    """PCM array -> (mono float32, rate), downmixing channels equally
    (``ReelExport.cpp:36-41``)."""
    if data.ndim == 0 or data.size == 0:
        raise ValueError("empty audio")
    if data.dtype == np.int16:
        mono_src = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        mono_src = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        mono_src = (data.astype(np.float32) - 128.0) / 128.0
    else:
        mono_src = data.astype(np.float32)
    if mono_src.ndim == 2:
        mono_src = mono_src.mean(axis=1)
    return np.ascontiguousarray(mono_src, np.float32), int(rate)


# (tool, argv builder): each emits a WAV container on stdout, so one
# parser covers them all
_EXTERNAL_DECODERS = (
    ("mpg123", lambda p: ["mpg123", "-q", "-w", "-", p]),
    ("ffmpeg", lambda p: ["ffmpeg", "-v", "error", "-i", p,
                          "-f", "wav", "-"]),
    ("sox", lambda p: ["sox", p, "-t", "wav", "-"]),
)


def _decode_via_external(path: str) -> Tuple[np.ndarray, int]:
    """Compressed-format decode through an external tool emitting WAV
    on stdout (the reference's dr_mp3 role, ``ReelExport.cpp:24-67``)."""
    override = os.environ.get("SPH_AUDIO_DECODER", "")
    if override:
        argvs = [shlex.split(override) + [path]]
    else:
        argvs = [mk(path) for name, mk in _EXTERNAL_DECODERS
                 if shutil.which(name)]
        if not argvs:
            raise ValueError(
                "no external audio decoder found (install mpg123, "
                "ffmpeg or sox, or set SPH_AUDIO_DECODER)")
    last_err: Exception = ValueError("decode failed")
    for argv in argvs:
        try:
            out = subprocess.run(
                argv, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, timeout=600, check=True
            ).stdout
            from scipy.io import wavfile
            rate, data = wavfile.read(io.BytesIO(out))
            return _wav_to_mono(rate, data)
        except Exception as e:          # try the next tool
            last_err = e
    raise ValueError(f"external audio decode failed: {last_err}")


def decode_to_mono(path: str) -> Tuple[np.ndarray, int]:
    """Decode .wav/.mp3 (+.ogg/.flac) to (mono float32, sample_rate).
    Raises ValueError on failure."""
    if not path:
        raise ValueError("no audio file given")
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        from scipy.io import wavfile
        rate, data = wavfile.read(path)
        return _wav_to_mono(rate, data)
    if ext in (".mp3", ".ogg", ".flac", ".m4a"):
        return _decode_via_external(path)
    raise ValueError("unsupported file type (use .wav or .mp3)")


def detect_drops(bass: np.ndarray, fps: int,
                 min_gap_sec: float = 8.0) -> List[float]:
    """Bass-drop times (seconds) via rising edges over an adaptive
    threshold ``max(0.25, 1.6 * rolling-4s-mean)``; the rolling window
    trails BEHIND the current frame so a drop doesn't raise its own
    threshold; at most 16 drops (``ReelExport.cpp:71-99``)."""
    drops: List[float] = []
    bass = np.asarray(bass, np.float32)
    if fps <= 0 or len(bass) < 2:
        return drops
    win = max(1, 4 * fps)
    min_gap = max(0.0, min_gap_sec)
    roll_sum, roll_n = 0.0, 0
    last_drop = -1e9
    above = False
    for i, b in enumerate(bass):
        avg = roll_sum / roll_n if roll_n > 0 else 0.0
        th = max(0.25, 1.6 * avg)
        hot = b > th
        t = i / float(fps)
        if hot and not above and t - last_drop >= min_gap:
            drops.append(t)
            last_drop = t
            if len(drops) >= 16:
                break
        above = hot
        roll_sum += float(b)
        roll_n += 1
        if roll_n > win:
            roll_sum -= float(bass[i - win])
            roll_n -= 1
    return drops


def analyze_track(path: str, fps: int = 30,
                  max_seconds: float = 0.0) -> ReelAnalysis:
    """Full offline analysis (``ReelExport.cpp:101-149``): decode, trim
    to max_seconds, per-frame band envelopes with the live reactor's
    default attack/release (15/250 ms), clamped to 4.0."""
    out = ReelAnalysis()
    if fps <= 0:
        fps = 30
    try:
        mono, rate = decode_to_mono(path)
    except (ValueError, OSError) as e:
        out.error = str(e)
        return out
    if rate == 0 or len(mono) == 0:
        out.error = "empty audio"
        return out
    out.sample_rate = rate
    if max_seconds > 0.0:
        cap = int(max_seconds * rate)
        if 0 < cap < len(mono):
            mono = mono[:cap]
    bass, mid, treble, _ = B.process_frames(
        mono, float(rate), fps,
        attack_ms=B.DEFAULT_ATTACK_MS, release_ms=B.DEFAULT_RELEASE_MS)
    if len(bass) == 0:
        out.error = "track too short for one frame"
        return out
    out.frame_count = len(bass)
    out.bass, out.mid, out.treble = bass, mid, treble
    return out
