"""Preset KV text I/O (counterpart of ``sph_tpu/io/presets.py``, a copy:
the port imports nothing of the JAX package) — byte-compatible with the
reference format.

Re-implements the behavior of ``PresetIO.{h,cpp}``: presets are plain
``key=value`` text files ("# SPH Fluid Preset v1" header + sorted keys),
'#' comments and garbage lines ignored, first value wins on duplicates,
unknown keys ignored on apply and missing keys keep current values —
so preset files remain forward/backward compatible.  Floats serialize
with ``%.9g`` so every float32 round-trips exactly
(``PresetIO.cpp:124-135``).  ``lerp_kv`` blends two presets for the Drop
Sequencer: numeric values lerp (scalars and "x,y,z" triples), everything
else switches from a to b at t >= 0.5 (``PresetIO.cpp:100-122``).
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

KV = Dict[str, str]

_HEADER = "# SPH Fluid Preset v1\nversion=1\n"


def serialize(kv: KV) -> str:
    out = [_HEADER]
    for k in sorted(kv):
        if k == "version":
            continue
        out.append(f"{k}={kv[k]}\n")
    return "".join(out)


def parse(text: str) -> KV:
    kv: KV = {}
    for line in text.splitlines():
        if line.endswith("\r"):
            line = line[:-1]
        if not line or line.startswith("#"):
            continue
        eq = line.find("=")
        if eq <= 0:
            continue
        key, val = line[:eq], line[eq + 1:]
        kv.setdefault(key, val)            # first value wins
    return kv


def save_file(path: str, kv: KV) -> bool:
    try:
        with open(path, "w", newline="") as f:
            f.write(serialize(kv))
        return True
    except OSError:
        return False


def load_file(path: str) -> Optional[KV]:
    try:
        with open(path, "r", newline="") as f:
            return parse(f.read())
    except OSError:
        return None


def list_presets(directory: str) -> List[str]:
    """Sorted basenames (no extension) of *.txt files; empty on error."""
    try:
        names = [os.path.splitext(e)[0] for e in os.listdir(directory)
                 if e.endswith(".txt")
                 and os.path.isfile(os.path.join(directory, e))]
    except OSError:
        return []
    return sorted(names)


def sanitize_name(raw: str) -> str:
    """Keep [A-Za-z0-9 _-], trim spaces; 'preset' if nothing survives."""
    out = "".join(c for c in raw
                  if c.isascii() and (c.isalnum() or c in " _-"))
    out = out.strip(" ")
    return out or "preset"


def _fmt_f(v: float) -> str:
    return "%.9g" % float(v)


_FLOAT_RE = re.compile(
    r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?[ \t]*$")


def _try_float(s: str) -> Optional[float]:
    """strtof semantics: parse a leading float, require only ws after."""
    try:
        # strtof accepts leading whitespace and inf/nan; match the common case
        m = re.match(r"\s*[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?", s)
        if not m or not m.group().strip():
            return None
        rest = s[m.end():]
        if rest.strip(" \t"):
            return None
        return float(m.group())
    except ValueError:
        return None


def _try_f3(s: str) -> Optional[List[float]]:
    parts = s.split(",")
    if len(parts) != 3:
        return None
    try:
        return [float(p) for p in parts]
    except ValueError:
        return None


def lerp_kv(a: KV, b: KV, t: float) -> KV:
    """Blend presets for morphs; see module docstring for the rules."""
    out: KV = {}
    for key, bv in b.items():
        av = a.get(key)
        if av is None:
            if t >= 0.5:
                out[key] = bv
            continue
        fa, fb = _try_float(av), _try_float(bv)
        if fa is not None and fb is not None:
            out[key] = _fmt_f(fa + (fb - fa) * t)
            continue
        a3, b3 = _try_f3(av), _try_f3(bv)
        if a3 is not None and b3 is not None:
            out[key] = ",".join(_fmt_f(x + (y - x) * t)
                                for x, y in zip(a3, b3))
            continue
        out[key] = av if t < 0.5 else bv
    return out


# Typed accessors (PresetIO.cpp:124-164)

def put_f(kv: KV, key: str, v: float) -> None:
    kv[key] = _fmt_f(v)


def put_i(kv: KV, key: str, v: int) -> None:
    kv[key] = str(int(v))


def put_b(kv: KV, key: str, v: bool) -> None:
    kv[key] = "1" if v else "0"


def put_f3(kv: KV, key: str, v) -> None:
    kv[key] = ",".join(_fmt_f(x) for x in v)


def get_f(kv: KV, key: str, default: float) -> float:
    s = kv.get(key)
    if s is None:
        return default
    m = re.match(r"\s*[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?", s)
    if not m or not m.group().strip():
        return default
    return float(m.group())


def get_i(kv: KV, key: str, default: int) -> int:
    s = kv.get(key)
    if s is None:
        return default
    m = re.match(r"\s*[+-]?\d+", s)
    if not m:
        return default
    return int(m.group())


def get_b(kv: KV, key: str, default: bool) -> bool:
    return get_i(kv, key, 1 if default else 0) != 0


def get_f3(kv: KV, key: str, out3: List[float]) -> List[float]:
    """Returns a new 3-list; unchanged copy if missing/bad (GetF3 semantics)."""
    s = kv.get(key)
    res = list(out3)
    if s is None:
        return res
    parts = s.replace(",", " ").split()
    if len(parts) >= 3:
        try:
            return [float(parts[0]), float(parts[1]), float(parts[2])]
        except ValueError:
            return res
    return res
