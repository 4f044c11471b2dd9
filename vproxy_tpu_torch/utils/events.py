"""Flight recorder — fixed-size in-memory ring of data-plane events.

The black-box counterpart to utils/metrics: metrics answer "how much /
how fast", the recorder answers "what happened around second X". In
the engine slice its sources are classify failovers (device dispatch
errors that degraded a batch to the host index, rules/service.py) and
fired failpoints (utils/failpoint.py). Recording is a lock + deque
append, safe from any thread, and never blocks on I/O; the event shape
is vproxy_tpu's (seq, ts, mono, mono_ns, kind, msg, fields).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Optional

DEFAULT_CAPACITY = 1024


class FlightRecorder:
    _instance: Optional["FlightRecorder"] = None
    _ilock = threading.Lock()

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._ring: deque = deque(maxlen=capacity)
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self.dropped = 0  # events evicted by ring wraparound

    @classmethod
    def get(cls) -> "FlightRecorder":
        with cls._ilock:
            if cls._instance is None:
                cls._instance = FlightRecorder()
            return cls._instance

    def record(self, kind: str, msg: str, **fields) -> None:
        ev = {"seq": 0, "ts": time.time(), "mono": time.monotonic(),
              "mono_ns": time.monotonic_ns(), "kind": kind, "msg": msg}
        if fields:
            ev.update(fields)
        with self._lock:
            ev["seq"] = next(self._seq)
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(ev)

    def snapshot(self, last: int = 0) -> list:
        """Events oldest-first; `last` > 0 trims to the newest N."""
        with self._lock:
            evs = list(self._ring)
        return evs[-last:] if last > 0 else evs


def record(kind: str, msg: str, **fields) -> None:
    """Module-level convenience: FlightRecorder.get().record(...)."""
    FlightRecorder.get().record(kind, msg, **fields)
