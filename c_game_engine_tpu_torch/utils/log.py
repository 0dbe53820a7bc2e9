"""ANSI logger (counterpart of c_game_engine_tpu/utils/log.py, line for
line): LogInfo/Debug/Warning/Error of the reference's Logging subsystem,
coloured on stderr and optionally appended to a log file; debug lines only
with CGE_DEBUG set."""

from __future__ import annotations

import os
import sys
import time

_COLORS = {"INFO": "\x1b[0m", "DEBUG": "\x1b[36m", "WARNING": "\x1b[33m", "ERROR": "\x1b[31m"}
_RESET = "\x1b[0m"
_t0 = time.monotonic()
_logfile = None
DEBUG_ENABLED = bool(os.environ.get("CGE_DEBUG"))


def set_log_file(path: str | None):
    """Append every later line to `path` (None stops); the previous file is
    closed."""
    global _logfile
    if _logfile:
        _logfile.close()
    _logfile = open(path, "a") if path else None


def _emit(level: str, msg: str, *args):
    text = msg % args if args else msg
    line = f"[{time.monotonic() - _t0:9.3f}] [{level}] {text}"
    print(f"{_COLORS[level]}{line}{_RESET}", file=sys.stderr)
    if _logfile:
        _logfile.write(line + "\n")
        _logfile.flush()


def log_info(msg, *args):
    _emit("INFO", msg, *args)


def log_debug(msg, *args):
    if DEBUG_ENABLED:
        _emit("DEBUG", msg, *args)


def log_warning(msg, *args):
    _emit("WARNING", msg, *args)


def log_error(msg, *args):
    _emit("ERROR", msg, *args)
