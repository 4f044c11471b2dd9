"""Leveled, colored, channel-based logging.

Reference: base util/Logger.java:317 (leveled + colored + machine-
parsable types), as in vproxy_tpu/utils/log.py:

* `Logger("channel")` — per-subsystem logger; levels debug/info/warn/
  error/alert; `alert` is the reference's ALERT log type (operator-
  visible events: device failover, ...).
* level filter — `VPROXY_TPU_LOG=debug|info|warn|error` (default info).
"""
from __future__ import annotations

import os
import sys
import threading
import time
import traceback

_LEVELS = {"debug": 0, "info": 1, "warn": 2, "error": 3, "alert": 3}
_COLORS = {"debug": "\033[0;36m", "info": "\033[0;32m",
           "warn": "\033[0;33m", "error": "\033[0;31m",
           "alert": "\033[1;31m"}
_RESET = "\033[0m"

_lock = threading.Lock()


def _min_level() -> int:
    return _LEVELS.get(os.environ.get("VPROXY_TPU_LOG", "info"), 1)


def _emit(level: str, channel: str, msg: str, exc: bool = False) -> None:
    ts = time.strftime("%Y-%m-%d %H:%M:%S")
    color = _COLORS[level] if sys.stderr.isatty() else ""
    reset = _RESET if color else ""
    line = f"{color}[{ts}] [{level.upper():5s}] [{channel}] {msg}{reset}\n"
    with _lock:
        sys.stderr.write(line)
        if exc:
            traceback.print_exc(file=sys.stderr)


class Logger:
    __slots__ = ("channel",)

    def __init__(self, channel: str):
        self.channel = channel

    def debug(self, msg: str, exc: bool = False) -> None:
        if _min_level() <= 0:
            _emit("debug", self.channel, msg, exc)

    def info(self, msg: str, exc: bool = False) -> None:
        if _min_level() <= 1:
            _emit("info", self.channel, msg, exc)

    def warn(self, msg: str, exc: bool = False) -> None:
        if _min_level() <= 2:
            _emit("warn", self.channel, msg, exc)

    def error(self, msg: str, exc: bool = False) -> None:
        _emit("error", self.channel, msg, exc)

    def alert(self, msg: str, exc: bool = False) -> None:
        _emit("alert", self.channel, msg, exc)
