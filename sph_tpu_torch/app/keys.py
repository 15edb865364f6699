"""Minimal interactive control surface for ``run --realtime``
(counterpart of ``sph_tpu/app/keys.py``, a copy of it over the port's
``Scene``).

The reference's main user-facing feature is a live ImGui panel
(``Scene0p.cpp:595-1265``) mutating simulation/look parameters while
the sim runs.  Headless runs have no GL window, so this maps the
panel's most-used controls onto raw-terminal keys; every mutation goes
through the same ``Scene.apply_settings`` / live-camera state the
preset and sequencer paths use.

    q            quit                 space        pause / resume
    [ / ]        palette prev / next  m            render mode cycle
    1..9, 0      art preset           g            SurpriseMe
    r            respawn              f            fountain toggle
    t            attractor toggle     b            audio-drive toggle
    a/d w/s      orbit yaw / pitch    - / =        zoom out / in
    u / U        quick-set stable / splashy water
    p            parameter-edit mode  h            print this help

Parameter-edit mode ('p') exposes the FULL preset schema (~140 keys:
physics, container, look, water, post-FX, motion, audio — the ImGui
panel equivalent): j/k select next/prev param, J/K jump by 10,
+/- step the value, 0 resets it to default, p exits.  Edits route
through ``apply_settings``, so structural params (count, mix, jitter)
respawn exactly like the reference's pendingReset
(``Scene0p.h:95-99``); everything else morphs live.

Reads are non-blocking (termios raw mode + select); on a non-TTY stdin
the controller is inert, so piping/CI is unaffected.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional, Tuple

HELP = "\n\n".join(__doc__.split("\n\n")[-3:-1]) if __doc__ else ""

N_PALETTES = 24


def param_entries() -> List[Tuple[str, str, str, Optional[int], bool]]:
    """The live-editable parameter table, derived from the preset schema
    (``PRESET_FIELDS``): (label, attr, kind, component, structural).
    f3 fields unroll to .x/.y/.z rows; strings are not key-editable."""
    from sph_tpu_torch.scene.settings import PRESET_FIELDS
    entries = []
    for key, attr, kind, structural in PRESET_FIELDS:
        if kind in ("f", "i", "b"):
            entries.append((key, attr, kind, None, structural))
        elif kind == "f3":
            for i in range(3):
                entries.append((f"{key}.{'xyz'[i]}", attr, "f", i,
                                structural))
    return entries


class KeyController:
    """Raw-terminal key poller bound to a Scene."""

    def __init__(self, scene, out=sys.stderr):
        self.scene = scene
        self.out = out
        self.paused = False
        self.param_mode = False
        self.param_idx = 0
        self._params = param_entries()
        self._defaults = None   # lazy SceneSettings() for '0' reset
        self._fd: Optional[int] = None
        self._saved = None

    # --- terminal plumbing ---

    def __enter__(self):
        try:
            import termios
            import tty
            if sys.stdin.isatty():
                self._fd = sys.stdin.fileno()
                self._saved = termios.tcgetattr(self._fd)
                tty.setcbreak(self._fd)
                print(HELP, file=self.out)
        except Exception:
            self._fd = None
        return self

    def __exit__(self, *exc):
        if self._fd is not None and self._saved is not None:
            import termios
            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)
        return False

    def _pending_keys(self):
        if self._fd is None:
            return
        import select
        while True:
            r, _, _ = select.select([sys.stdin], [], [], 0)
            if not r:
                return
            ch = sys.stdin.read(1)
            if not ch:
                return
            yield ch

    # --- dispatch ---

    def poll(self) -> bool:
        """Apply all pending keys; returns False when 'q' asked to quit."""
        for ch in self._pending_keys():
            if not self.handle(ch):
                return False
        return True

    def handle(self, ch: str) -> bool:
        """One key (exposed for tests). Returns False on quit."""
        scene = self.scene
        s = scene.settings
        if ch == "q":
            return False
        elif ch == "p":
            self.param_mode = not self.param_mode
            if self.param_mode:
                self._say("param mode: j/k select, J/K jump, +/- step, "
                          "0 default, p exit")
                self._show_param()
            else:
                self._say("param mode off")
        elif self.param_mode and ch in "jkJK+=-_0":
            self._handle_param(ch)
        elif ch == "u":
            self._quickset("stable")
        elif ch == "U":
            self._quickset("splashy")
        elif ch == " ":
            self.paused = not self.paused
            self._say("paused" if self.paused else "resumed")
        elif ch == "[":
            self._apply(s, palette_id=(s.palette_id - 1) % N_PALETTES)
            self._say(f"palette {scene.settings.palette_id}")
        elif ch == "]":
            self._apply(s, palette_id=(s.palette_id + 1) % N_PALETTES)
            self._say(f"palette {scene.settings.palette_id}")
        elif ch == "m":
            self._apply(s, render_mode=(s.render_mode + 1) % 3)
            self._say(f"render mode {scene.settings.render_mode}")
        elif ch.isdigit():
            which = 9 if ch == "0" else int(ch) - 1
            scene.apply_art_preset(which)
            self._say(f"art preset {which}")
        elif ch == "g":
            scene.surprise_me()
            self._say("surprise me")
        elif ch == "r":
            scene.pending_reset = True
            self._say("respawn queued")
        elif ch == "f":
            self._apply(s, fountain_on=not s.fountain_on)
            self._say(f"fountain {'on' if not s.fountain_on else 'off'}")
        elif ch == "t":
            self._apply(s, attractor_on=not s.attractor_on)
            self._say(
                f"attractor {'on' if not s.attractor_on else 'off'}")
        elif ch == "b":
            self._apply(s, audio_enabled=not s.audio_enabled)
            self._say(
                f"audio drive {'on' if not s.audio_enabled else 'off'}")
        elif ch in "adws-=":
            cam = scene.camera
            if ch == "a":
                cam.yaw_deg -= 6.0
            elif ch == "d":
                cam.yaw_deg += 6.0
            elif ch == "w":
                cam.pitch_deg = min(cam.pitch_deg + 4.0, 85.0)
            elif ch == "s":
                cam.pitch_deg = max(cam.pitch_deg - 4.0, -85.0)
            elif ch == "-":
                cam.distance *= 1.1
            elif ch == "=":
                cam.distance = max(cam.distance / 1.1, 1.0)
        elif ch == "h":
            print(HELP, file=self.out)
        return True

    # --- parameter-edit mode (the ImGui slider panel equivalent) ---

    def _handle_param(self, ch: str) -> None:
        n = len(self._params)
        if ch == "j":
            self.param_idx = (self.param_idx + 1) % n
            self._show_param()
        elif ch == "k":
            self.param_idx = (self.param_idx - 1) % n
            self._show_param()
        elif ch == "J":
            self.param_idx = (self.param_idx + 10) % n
            self._show_param()
        elif ch == "K":
            self.param_idx = (self.param_idx - 10) % n
            self._show_param()
        elif ch in "+=":
            self._step_param(+1)
        elif ch in "-_":
            self._step_param(-1)
        elif ch == "0":
            self._reset_param()

    def _param_value(self, s):
        _, attr, _, comp, _ = self._params[self.param_idx]
        v = getattr(s, attr)
        return v[comp] if comp is not None else v

    def _set_param(self, value) -> None:
        """Write through apply_settings so structural edits respawn
        (Scene0p.h:95-99) and live edits morph without reset."""
        label, attr, kind, comp, structural = self._params[self.param_idx]
        s = self.scene.settings
        if comp is not None:
            triple = list(getattr(s, attr))
            triple[comp] = float(value)
            self._apply(s, **{attr: triple})
        elif kind == "i":
            self._apply(s, **{attr: int(value)})
        elif kind == "b":
            self._apply(s, **{attr: bool(value)})
        else:
            self._apply(s, **{attr: float(value)})
        self._show_param(" (respawn)" if structural else "")

    def _step_param(self, sign: int) -> None:
        _, _, kind, _, _ = self._params[self.param_idx]
        v = self._param_value(self.scene.settings)
        if kind == "b":
            self._set_param(not v)
        elif kind == "i":
            self._set_param(int(v) + sign)
        else:
            step = max(abs(float(v)) * 0.1, 0.01)
            self._set_param(float(v) + sign * step)

    def _reset_param(self) -> None:
        if self._defaults is None:
            from sph_tpu_torch.scene.settings import SceneSettings
            self._defaults = SceneSettings()
        self._set_param(self._param_value(self._defaults))

    def _show_param(self, note: str = "") -> None:
        label, _, kind, _, structural = self._params[self.param_idx]
        v = self._param_value(self.scene.settings)
        tag = " [structural]" if structural else ""
        self._say(f"({self.param_idx + 1}/{len(self._params)}) "
                  f"{label} = {v}{tag}{note}")

    def _quickset(self, name: str) -> None:
        from sph_tpu_torch.scene.quicksets import apply_quickset
        self.scene.settings = apply_quickset(self.scene.settings, name)
        self.scene.pending_reset = True   # Scene0p.cpp:834,849
        self._say(f"quick-set: {name} water (respawn queued)")

    def _apply(self, s, **kw):
        self.scene.apply_settings(dataclasses.replace(s, **kw))

    def _say(self, msg: str):
        print(f"[keys] {msg}", file=self.out)
