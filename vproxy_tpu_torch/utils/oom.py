"""OOM survival: a pre-allocated reserve released on MemoryError so the
crash can still be logged and exit cleanly.

Parity: app/OOMHandler.java:60 — the reference pre-allocates a 2MB
buffer and frees it when an OutOfMemoryError surfaces, buying the
logger enough headroom to record the failure before the process dies
(the Daemon supervisor then restarts it). Python raises MemoryError
with the heap similarly wedged; releasing the reserve gives the
excepthook room to format and flush the alert.

The port's copy of vproxy_tpu/utils/oom.py, same names and behaviour.
"""
from __future__ import annotations

import os
import sys
import threading

from .log import Logger

_log = Logger("oom")
_reserve: list = []
_installed = False
_lock = threading.Lock()


def install(reserve_mb: int = 2) -> None:
    """Idempotent. Wraps sys.excepthook (and threading.excepthook) so an
    uncaught MemoryError releases the reserve, logs, and exits 137 —
    matching the reference's log-then-die contract; a wedged allocator
    must not linger half-alive."""
    global _installed
    with _lock:
        if _installed:
            return
        _installed = True
        _reserve.append(bytearray(reserve_mb << 20))

    prev = sys.excepthook
    prev_thread = threading.excepthook

    def hook(tp, val, tb):
        if issubclass(tp, MemoryError):
            _die(val)
        prev(tp, val, tb)

    def thread_hook(args):
        if args.exc_type is not None and \
                issubclass(args.exc_type, MemoryError):
            _die(args.exc_value)
        prev_thread(args)

    sys.excepthook = hook
    threading.excepthook = thread_hook


def _die(val) -> None:
    _reserve.clear()  # give the logger headroom
    try:
        _log.alert(f"out of memory: {val!r}; exiting for supervisor restart")
        sys.stderr.flush()
    finally:
        os._exit(137)


def installed() -> bool:
    return _installed
