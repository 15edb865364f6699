"""Leveled append-only file logger (counterpart of
``sph_tpu/utils/log.py``, a copy of it) — the reference's Debug subsystem
(``Debug.{h,cpp}``: 5 levels, file sink opened once, timestamped lines,
``FatalError`` raising) rebuilt on the stdlib.

Usage mirrors ``Debug::Info(msg, file, line)``:

    from sph_tpu_torch.utils import log
    log.init("engine_log.txt")
    log.info("spawned 131072 particles")
    log.fatal("kernel compile failed")   # logs + raises EngineFatalError
"""
from __future__ import annotations

import datetime
import os
import sys
import threading
from typing import Optional, TextIO

TRACE, INFO, WARNING, ERROR, FATAL = range(5)   # Debug.h:10-16
_NAMES = ["TRACE", "INFO", "WARNING", "ERROR", "FATAL"]

_lock = threading.Lock()
_sink: Optional[TextIO] = None
_min_level = INFO
_echo = False


class EngineFatalError(RuntimeError):
    """Raised by ``fatal`` — the analogue of Debug::FatalError + abort."""


def init(path: Optional[str] = None, min_level: int = INFO,
         echo: bool = False) -> None:
    """Open the log sink (truncates, like ``Debug::DebugInit``)."""
    global _sink, _min_level, _echo
    with _lock:
        if _sink is not None:
            _sink.close()
        _sink = open(path, "w") if path else None
        _min_level = min_level
        _echo = echo


def log(level: int, msg: str) -> None:
    if level < _min_level:
        return
    stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    line = f"[{stamp}] {_NAMES[level]}: {msg}"
    with _lock:
        if _sink is not None:
            _sink.write(line + os.linesep)
            _sink.flush()
        if _echo or _sink is None:
            print(line, file=sys.stderr)


def trace(msg: str) -> None:
    log(TRACE, msg)


def info(msg: str) -> None:
    log(INFO, msg)


def warning(msg: str) -> None:
    log(WARNING, msg)


def error(msg: str) -> None:
    log(ERROR, msg)


def fatal(msg: str) -> None:
    log(FATAL, msg)
    raise EngineFatalError(msg)
