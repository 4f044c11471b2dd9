"""Flight recorder — fixed-size in-memory ring of data-plane events.

The black-box counterpart to utils/metrics: metrics answer "how much /
how fast", the recorder answers "what happened around second X". Event
sources (all low-rate relative to the bytes they describe):

* connection lifecycle — splice-pump sessions opening/closing with byte
  counts and the error that ended them (components/tcplb.py);
* loop stalls — any event-loop callback that held the loop thread past
  the stall threshold, the known GIL-contention p999 culprit
  (net/eventloop.py);
* classify failovers — device dispatch errors that degraded a batch to
  the host oracle (rules/service.py);
* health-check up/down edges (components/servergroup.py).

Dumped over HTTP at /events (next to /metrics, /lsof, /jstack —
utils/metrics.launch_inspection_http) and via the control-plane command
`list event-log`. The ring is process-global and bounded: recording is
a lock + deque append, safe from any thread, and never blocks on I/O.

The port's copy of vproxy_tpu/utils/events.py, same names and behaviour.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Optional

DEFAULT_CAPACITY = 1024

# kind -> plane classification for `GET /events?plane=` and
# `list event-log plane=<p>` (the analytics drill-down: jump from a hot
# client in `top clients` to its accept-plane events without wading
# through cluster gossip). An event may carry an explicit plane= field
# to override; unmapped kinds land in "app".
EVENT_PLANES = ("accept", "lane", "engine", "cluster", "loop",
                "policing", "app")
_KIND_PLANE = {
    "conn": "accept", "conn_denied": "accept", "drain": "accept",
    "drain_shed": "accept", "overload": "accept",
    "overload_mode": "accept", "halfopen_shed": "accept",
    "retry": "accept", "eject": "accept", "eject_skipped": "accept",
    "readmit": "accept", "hc_up": "accept", "hc_down": "accept",
    "lanes": "lane",
    "classify_failover": "engine",
    "peer_up": "cluster", "peer_down": "cluster",
    "cluster_degrade": "cluster", "cluster_rejoin": "cluster",
    "cluster_steer_rebuild": "cluster",
    "generation_bump": "cluster", "generation_install": "cluster",
    "generation_reject": "cluster", "generation_discard": "cluster",
    "loop_stall": "loop",
    "policy_install": "policing", "policy_shed": "policing",
    "quarantine": "policing",
}


def _mono_ns(ev: dict) -> int:
    """An event's monotonic-ns stamp (derived from the float `mono`
    for events recorded before the field existed)."""
    ns = ev.get("mono_ns")
    return int(ns) if ns is not None else int(ev.get("mono", 0.0) * 1e9)


def plane_of(ev: dict) -> str:
    """The plane an event belongs to: its explicit plane= field when
    one was recorded, else the kind classification, else "app"."""
    p = ev.get("plane")
    if p:
        return p
    return _KIND_PLANE.get(ev.get("kind", ""), "app")


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

    @classmethod
    def reset(cls) -> None:
        """Test hook: drop the singleton (a new one lazily respawns)."""
        with cls._ilock:
            cls._instance = None

    def record(self, kind: str, msg: str, trace_id: int = 0,
               **fields) -> None:
        """trace_id (optional, nonzero) cross-references the event with
        a span trace (utils/trace.py): `GET /events?trace=<id>` and the
        trace waterfall join recorder events and spans instead of two
        unjoinable logs."""
        ev = {"seq": 0, "ts": time.time(), "mono": time.monotonic(),
              "mono_ns": time.monotonic_ns(), "kind": kind, "msg": msg}
        if trace_id:
            ev["trace_id"] = trace_id
        if fields:
            ev.update(fields)
        with self._lock:
            ev["seq"] = next(self._seq)
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(ev)

    def snapshot(self, last: int = 0, trace: Optional[int] = None,
                 plane: Optional[str] = None,
                 since: Optional[int] = None,
                 until: Optional[int] = None) -> list:
        """Events oldest-first; `last` > 0 trims to the newest N;
        `trace` filters to events carrying that trace_id; `plane`
        filters by plane_of() classification; `since`/`until` are
        inclusive monotonic-ns bounds on the SAME clock trace spans
        stamp t_ns with (time.monotonic_ns) — a capture or incident
        window joins recorder events against traces directly."""
        with self._lock:
            evs = list(self._ring)
        if trace is not None:
            evs = [e for e in evs if e.get("trace_id") == trace]
        if plane is not None:
            evs = [e for e in evs if plane_of(e) == plane]
        if since is not None:
            evs = [e for e in evs if _mono_ns(e) >= since]
        if until is not None:
            evs = [e for e in evs if _mono_ns(e) <= until]
        return evs[-last:] if last > 0 else evs

    def lines(self, last: int = 0, plane: Optional[str] = None,
              since: Optional[int] = None,
              until: Optional[int] = None) -> list:
        """Human-form rendering for the command surface."""
        out = []
        for ev in self.snapshot(last, plane=plane, since=since,
                                until=until):
            extras = " ".join(
                f"{k}={ev[k]}" for k in sorted(ev)
                if k not in ("seq", "ts", "mono", "mono_ns", "kind",
                             "msg"))
            stamp = time.strftime("%H:%M:%S", time.localtime(ev["ts"]))
            out.append(f"[{ev['seq']}] {stamp} {ev['kind']}: {ev['msg']}"
                       + (f" ({extras})" if extras else ""))
        return out


def record(kind: str, msg: str, **fields) -> None:
    """Module-level convenience: FlightRecorder.get().record(...)."""
    FlightRecorder.get().record(kind, msg, **fields)
