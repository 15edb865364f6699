"""Bass/Mid/Treble band-split + envelope DSP (counterpart of
``sph_tpu/audio/bands.py``).

Rebuild of the reference's shared DSP (``ComponentFramework/AudioBands.h``)
used by BOTH the live reactor and the offline reel analyzer so they
produce identical band values (``AudioBands.h:4-7``):

- one-pole band split: bass = LP 150 Hz; mid = LP 2 kHz then HP 250 Hz;
  treble = HP 2.8 kHz (``AudioBands.h:44-58``),
- attack/release peak-envelope follower (``AudioBands.h:33-36``),
- envelopes clamped to 4.0 when sampled (``AudioReactive.cpp:150-154``).

The per-sample recurrence is sequential, so it runs on the host in the C++
core ``native/audio_dsp.cpp`` (built by ``native/build.py``; a failed build
raises), the same source as the JAX package's, so the two packages' bands
are the same bits.  :func:`process_frames_plain` is its plain version: a
numpy loop over :func:`process_sample` with the same float32 recurrence
(the JAX package's ``lax.scan`` fallback).  The tests use it; the reel does
not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from sph_tpu_torch.native import build

ENV_CLAMP = 4.0
BASS_HZ = 150.0
MID_LP_HZ = 2000.0
MID_HP_HZ = 250.0
TREBLE_HZ = 2800.0
DEFAULT_ATTACK_MS = 15.0
DEFAULT_RELEASE_MS = 250.0


def filter_alpha(fc_hz: float, fs_hz: float) -> float:
    """One-pole lowpass smoothing coefficient (``AudioBands.h:14-16``)."""
    return 1.0 - math.exp(-2.0 * math.pi * fc_hz / fs_hz)


def envelope_coeff(tc_ms: float, fs_hz: float) -> float:
    """Envelope follower coefficient for time constant tc_ms
    (``AudioBands.h:19-21``)."""
    return 1.0 - math.exp(-1000.0 / (max(tc_ms, 0.1) * fs_hz))


@dataclasses.dataclass
class BandState:
    """Filter + envelope state (``AudioBands.h:38-41``)."""
    lp_bass: float = 0.0
    lp_mid_hi: float = 0.0
    lp_mid_lo: float = 0.0
    lp_treble: float = 0.0
    env_bass: float = 0.0
    env_mid: float = 0.0
    env_treble: float = 0.0

    def as_array(self) -> np.ndarray:
        return np.array([self.lp_bass, self.lp_mid_hi, self.lp_mid_lo,
                         self.lp_treble, self.env_bass, self.env_mid,
                         self.env_treble], np.float32)

    @classmethod
    def from_array(cls, a) -> "BandState":
        return cls(*(float(x) for x in a))


def process_sample(mono, s: BandState, fs: float, attack_coeff,
                   release_coeff) -> Tuple[float, float, float]:
    """One sample through the band filters + envelopes (reference
    ``ProcessSample``).  Returns the instantaneous (bass, mid, treble)
    band values; envelopes live in ``s``.  With ``mono``, the coefficients
    and the fields of ``s`` as ``np.float32``, every step is float32 (the
    filter coefficients are rounded to float32 first)."""
    f32 = np.float32
    a_bass = f32(filter_alpha(BASS_HZ, fs))
    a_mid_hi = f32(filter_alpha(MID_LP_HZ, fs))
    a_mid_lo = f32(filter_alpha(MID_HP_HZ, fs))
    a_treble = f32(filter_alpha(TREBLE_HZ, fs))

    s.lp_bass += a_bass * (mono - s.lp_bass)
    s.lp_mid_hi += a_mid_hi * (mono - s.lp_mid_hi)
    s.lp_mid_lo += a_mid_lo * (s.lp_mid_hi - s.lp_mid_lo)
    mid = s.lp_mid_hi - s.lp_mid_lo
    s.lp_treble += a_treble * (mono - s.lp_treble)
    treble = mono - s.lp_treble

    for attr, r in (("env_bass", abs(s.lp_bass)), ("env_mid", abs(mid)),
                    ("env_treble", abs(treble))):
        env = getattr(s, attr)
        c = attack_coeff if r > env else release_coeff
        setattr(s, attr, env + c * (r - env))
    return s.lp_bass, mid, treble


def _frame_ends(n_samples: int, fs: float, fps: int) -> np.ndarray:
    """Frame boundaries matching ``ReelExport.cpp:138``:
    ``round((f+1) * fs/fps)`` clipped to n_samples."""
    spf = fs / float(fps)
    n_frames = int(math.floor(n_samples / spf))
    ends = np.rint((np.arange(1, n_frames + 1, dtype=np.float64)) * spf)
    return np.minimum(ends, n_samples).astype(np.int64)


def _analyze(mono: np.ndarray, ends: np.ndarray, fs: float, attack_ms,
             release_ms, state: BandState):
    """The native core over ``mono`` up to each of ``ends``: (bass, mid,
    treble) at each end, clamped, and the final state."""
    st = state.as_array()
    bass, mid, treble = (np.empty(len(ends), np.float32) for _ in range(3))
    build.audio_library().sph_audio_analyze(
        mono.ctypes.data, len(mono), ends.ctypes.data, len(ends), fs,
        attack_ms, release_ms, ENV_CLAMP, st.ctypes.data, bass.ctypes.data,
        mid.ctypes.data, treble.ctypes.data)
    return bass, mid, treble, BandState.from_array(st)


def process_frames(mono: np.ndarray, fs: float, fps: int,
                   attack_ms: float = DEFAULT_ATTACK_MS,
                   release_ms: float = DEFAULT_RELEASE_MS,
                   state: BandState | None = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, BandState]:
    """Per-video-frame band envelopes over a mono track through the native
    core; returns (bass[F], mid[F], treble[F], final_state), envelopes
    clamped to 4.0."""
    mono = np.ascontiguousarray(np.asarray(mono, np.float32))
    ends = _frame_ends(len(mono), fs, fps)
    state = state or BandState()
    if len(ends) == 0:
        return (np.zeros(0, np.float32),) * 3 + (state,)
    return _analyze(mono, ends, fs, attack_ms, release_ms, state)


def process_block(mono: np.ndarray, fs: float,
                  attack_ms: float = DEFAULT_ATTACK_MS,
                  release_ms: float = DEFAULT_RELEASE_MS,
                  state: BandState | None = None) -> BandState:
    """Process one sample block and return the updated state (the live
    reactor's per-packet path — envelopes are then read off the state)."""
    mono = np.ascontiguousarray(np.asarray(mono, np.float32))
    state = state or BandState()
    if len(mono) == 0:
        return state
    ends = np.asarray([len(mono)], np.int64)
    return _analyze(mono, ends, fs, attack_ms, release_ms, state)[3]


def process_frames_plain(mono: np.ndarray, fs: float, fps: int,
                         attack_ms: float = DEFAULT_ATTACK_MS,
                         release_ms: float = DEFAULT_RELEASE_MS,
                         state: BandState | None = None):
    """:func:`process_frames` as a numpy loop over :func:`process_sample`
    in float32, the native core's plain version (the JAX package's
    ``_process_frames_scan``, ``sph_tpu/audio/bands.py:169-206``)."""
    f32 = np.float32
    mono = np.asarray(mono, np.float32)
    ends = _frame_ends(len(mono), fs, fps)
    s = BandState(*(f32(v) for v in (state or BandState()).as_array()))
    attack = f32(envelope_coeff(attack_ms, fs))
    release = f32(envelope_coeff(release_ms, fs))
    out = np.zeros((len(ends), 3), np.float32)
    i = 0
    for f, end in enumerate(ends):
        for x in mono[i:end]:
            process_sample(x, s, fs, attack, release)
        i = end
        out[f] = np.minimum([s.env_bass, s.env_mid, s.env_treble], ENV_CLAMP)
    return (out[:, 0], out[:, 1], out[:, 2],
            BandState.from_array(s.as_array()))
