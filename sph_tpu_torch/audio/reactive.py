"""Live audio reactor (counterpart of ``sph_tpu/audio/reactive.py``, a
copy of it over the port's ``bands``) — the rebuild of
``AudioReactive.{h,cpp}``.

The reference captures system audio via Windows WASAPI loopback on a
background thread and publishes bass/mid/treble envelopes as atomics
(``AudioReactive.h:12-47``).  This environment has no system-audio
loopback, so the rebuild keeps the exact main-thread API
(start/stop/is_running/is_capturing/status_text/get_bass/mid/treble with
live-tunable attack_ms/release_ms/gain) over pluggable capture sources:

- ``FileSource``   — streams a decoded WAV as if it were playing live
  (wall-clock paced by default, or stepped deterministically for tests),
- ``ToneSource``   — synthetic band tones for tests/demos,
- ``NullSource``   — silence (the "Idle, no capture device" case).

A background thread pulls sample packets from the source and feeds them
through the same shared DSP as the offline analyzer
(``sph_tpu_torch/audio/bands.py`` = ``AudioBands.h``), so live and reel values
match — the reference's core design invariant (``AudioBands.h:4-7``).
"""
from __future__ import annotations

import math
import threading
import time
from typing import Optional, Protocol, Tuple

import numpy as np

from sph_tpu_torch.audio import bands as B


class CaptureSource(Protocol):
    """One packet of mono samples per call, or None when exhausted."""
    sample_rate: int

    def read_packet(self, max_samples: int) -> Optional[np.ndarray]: ...


class NullSource:
    sample_rate = 48000

    def read_packet(self, max_samples: int) -> Optional[np.ndarray]:
        return np.zeros(max_samples, np.float32)


class ToneSource:
    """Sum of sine tones (hz, amplitude) — deterministic test signal."""

    def __init__(self, tones: Tuple[Tuple[float, float], ...],
                 sample_rate: int = 48000):
        self.tones = tones
        self.sample_rate = sample_rate
        self._t = 0

    def read_packet(self, max_samples: int) -> Optional[np.ndarray]:
        n = max_samples
        idx = np.arange(self._t, self._t + n, dtype=np.float64)
        self._t += n
        out = np.zeros(n, np.float64)
        for hz, amp in self.tones:
            out += amp * np.sin(2.0 * math.pi * hz * idx / self.sample_rate)
        return out.astype(np.float32)


class FileSource:
    """Streams a WAV file's mono samples; returns None at end-of-track."""

    def __init__(self, path: str):
        from sph_tpu_torch.audio.analyze import decode_to_mono
        self.mono, self.sample_rate = decode_to_mono(path)
        self._pos = 0

    def read_packet(self, max_samples: int) -> Optional[np.ndarray]:
        if self._pos >= len(self.mono):
            return None
        end = min(self._pos + max_samples, len(self.mono))
        out = self.mono[self._pos:end]
        self._pos = end
        return out


class AudioReactive:
    """Main-thread API mirror of the reference class
    (``AudioReactive.h:17-31``): envelopes published by a background
    capture thread, tunables read per packet."""

    PACKET = 1024

    def __init__(self, source: Optional[CaptureSource] = None,
                 realtime: bool = True):
        self.source = source if source is not None else NullSource()
        self.realtime = realtime
        # Live-tunable from the UI thread (AudioReactive.h:29-31).
        self.attack_ms = 15.0
        self.release_ms = 250.0
        self.gain = 1.0

        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._capturing = False
        self._stop = threading.Event()
        self._levels = np.zeros(3, np.float32)  # bass, mid, treble
        self._status_lock = threading.Lock()
        self._status = "Idle"

    # --- main-thread API ---

    def start(self) -> None:
        if self._running:
            return
        self._stop.clear()
        self._running = True
        self._thread = threading.Thread(target=self._capture_main,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if not self._running:
            return
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._running = False
        self._capturing = False

    @property
    def is_running(self) -> bool:
        return self._running

    @property
    def is_capturing(self) -> bool:
        return self._capturing

    @property
    def status_text(self) -> str:
        with self._status_lock:
            return self._status

    def get_bass(self) -> float:
        return float(self._levels[0])

    def get_mid(self) -> float:
        return float(self._levels[1])

    def get_treble(self) -> float:
        return float(self._levels[2])

    def pump(self, n_packets: int = 1) -> None:
        """Deterministic drive for tests/offline: process packets inline
        on the caller's thread (no background thread needed)."""
        state = getattr(self, "_state", None) or B.BandState()
        fs = float(self.source.sample_rate)
        for _ in range(n_packets):
            pkt = self.source.read_packet(self.PACKET)
            if pkt is None:
                break
            self._process_packet(pkt, fs, state)
        self._state = state

    # --- capture thread ---

    def _set_status(self, s: str) -> None:
        with self._status_lock:
            self._status = s

    def _process_packet(self, pkt: np.ndarray, fs: float,
                        state: B.BandState) -> None:
        pkt = pkt * np.float32(self.gain)
        new_state = B.process_block(pkt, fs, attack_ms=self.attack_ms,
                                    release_ms=self.release_ms, state=state)
        state.__dict__.update(new_state.__dict__)
        self._levels = np.minimum(
            new_state.as_array()[4:7], B.ENV_CLAMP).astype(np.float32)

    def _capture_main(self) -> None:
        fs = float(self.source.sample_rate)
        self._set_status(f"Capturing ({int(fs)} Hz)")
        self._capturing = True
        state = B.BandState()
        try:
            while not self._stop.is_set():
                pkt = self.source.read_packet(self.PACKET)
                if pkt is None:
                    break
                self._process_packet(pkt, fs, state)
                if self.realtime:
                    time.sleep(len(pkt) / fs)
        except Exception as e:  # publish like reference SetStatus("Error:")
            self._set_status(f"Error: {e}")
        finally:
            self._capturing = False
            if self.status_text.startswith("Capturing"):
                self._set_status("Idle")
