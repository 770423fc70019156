"""Minimal leveled logger (role of mitsuba's Logger/Appender,
include/mitsuba/core/logger.h): stdout + optional logfile sink.

The port's own copy of ppg_tpu/utils/logging.py.
"""

from __future__ import annotations

import sys
import time

LEVELS = {"trace": 0, "debug": 10, "info": 20, "warn": 30, "error": 40}
_state = {"level": 20, "file": None, "t0": time.time()}


def set_level(name):
    _state["level"] = LEVELS[str(name).lower()]


def set_logfile(path):
    _state["file"] = open(path, "a")


def log(msg, level="info"):
    if LEVELS[level] < _state["level"]:
        return
    line = f"[{time.time() - _state['t0']:8.2f}s] {level.upper():5s}  {msg}"
    print(line, file=sys.stderr if level in ("warn", "error") else sys.stdout,
          flush=True)
    if _state["file"]:
        _state["file"].write(line + "\n")
        _state["file"].flush()
