"""Drop Sequencer — timeline preset cuts/morphs for music-synced reels
(counterpart of ``sph_tpu/scene/sequencer.py``, a copy of it over the
port's ``io/presets`` and ``scene/settings``).

Rebuild of ``Scene0p::SequencerTick`` (``Scene0p.cpp:2285-2316``) and the
``sequence.txt`` persistence (``:1190-1227``): a list of cues
``(time, preset, morphSec, cut)``; a fired cue either slams the preset
instantly or starts a smoothstep-eased ``LerpKV`` morph from the current
gathered look; presets apply non-structurally so the fluid morphs
continuously (no respawn).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

from sph_tpu_torch.io import presets as pio
from sph_tpu_torch.scene import settings as SET


@dataclasses.dataclass
class SeqCue:
    time: float = 0.0
    preset: str = ""            # preset name ("" = unassigned)
    morph_sec: float = 1.0
    cut: bool = True


@dataclasses.dataclass
class Sequencer:
    cues: List[SeqCue] = dataclasses.field(default_factory=list)
    enabled: bool = False
    preset_dir: str = "presets"
    next_cue: int = 0
    morph_active: bool = False
    morph_start: float = 0.0
    morph_dur: float = 1.0
    _start_kv: Optional[pio.KV] = None
    _target_kv: Optional[pio.KV] = None

    def rewind(self) -> None:
        self.next_cue = 0
        self.morph_active = False

    def _load(self, name: str) -> Optional[pio.KV]:
        path = os.path.join(self.preset_dir, f"{name}.txt")
        return pio.load_file(path)

    def tick(self, settings: SET.SceneSettings,
             t_sec: float) -> SET.SceneSettings:
        """Fire due cues and advance any active morph; returns the new
        (non-structurally applied) settings."""
        if not self.enabled or not self.cues:
            return settings

        while (self.next_cue < len(self.cues)
               and self.cues[self.next_cue].time <= t_sec):
            c = self.cues[self.next_cue]
            target = self._load(c.preset) if c.preset else None
            if target is not None:
                if c.cut or c.morph_sec <= 0.01:
                    settings = SET.apply_preset(settings, target,
                                                structural=False)
                    self.morph_active = False
                else:
                    self._start_kv = SET.gather_preset(settings)
                    self._target_kv = target
                    self.morph_start = c.time
                    self.morph_dur = c.morph_sec
                    self.morph_active = True
            self.next_cue += 1

        if self.morph_active:
            t = (t_sec - self.morph_start) / max(self.morph_dur, 1e-3)
            done = t >= 1.0
            t = min(t, 1.0)
            s = t * t * (3.0 - 2.0 * t)          # smoothstep ease
            blended = pio.lerp_kv(self._start_kv, self._target_kv, s)
            settings = SET.apply_preset(settings, blended, structural=False)
            if done:
                self.morph_active = False
        return settings

    # --- sequence.txt persistence (Scene0p.cpp:1190-1227) ---

    def save(self, path: str = "sequence.txt") -> bool:
        try:
            with open(path, "w") as f:
                f.write("# SPH reel sequence v1\n")
                for c in self.cues:
                    f.write(f"{c.time:.3f}|{c.preset}|{c.morph_sec:.3f}|"
                            f"{1 if c.cut else 0}\n")
            return True
        except OSError:
            return False

    @classmethod
    def load(cls, path: str = "sequence.txt",
             preset_dir: str = "presets") -> "Sequencer":
        seq = cls(preset_dir=preset_dir)
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    parts = line.split("|")
                    if len(parts) != 4:
                        continue
                    try:
                        seq.cues.append(SeqCue(
                            time=float(parts[0]), preset=parts[1],
                            morph_sec=float(parts[2]),
                            cut=parts[3].strip() == "1"))
                    except ValueError:
                        continue
        except OSError:
            pass
        seq.cues.sort(key=lambda c: c.time)
        return seq

    def build_from_drops(self, drops: List[float], preset_names: List[str],
                         morph_sec: float = 0.0) -> None:
        """Auto-cue: one preset per detected bass drop (round-robin)."""
        self.cues = [
            SeqCue(time=t, preset=preset_names[i % len(preset_names)],
                   morph_sec=morph_sec, cut=morph_sec <= 0.01)
            for i, t in enumerate(drops)] if preset_names else []
        self.cues.sort(key=lambda c: c.time)
        self.rewind()
