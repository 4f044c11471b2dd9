"""Failpoint — deterministic, named fault-injection sites.

The failure-containment layer (backend retry, passive outlier ejection,
graceful drain, overload shed) is only trustworthy if every behavior is
provable in tier-1 tests without ad-hoc socket monkeypatching. This
module gives the data plane named injection sites that tests (and
operators, via `add fault` / `remove fault` and `GET /faults`) can arm:

    backend.connect.refuse   Connection.connect raises ECONNREFUSED
    backend.connect.hang     the nonblocking connect never completes
                             (and never errors) — exercises timeouts
    device.dispatch.error    ClassifyService device batches raise,
                             driving the host-oracle failover path
    hc.force_down            health-check probes report failure
    pump.abort               a just-registered splice pump is killed
    pool.handover.dead       a validated warm-pool connection dies at
                             pump handover (the stale-socket race),
                             driving the fresh-connect fallback
    cluster.peer.drop        inbound membership heartbeats are dropped
                             (ctx "from=<id> <addr>"), driving the
                             peer-DOWN hysteresis edge
    cluster.replicate.torn   the leader cuts a replication frame
                             mid-transfer; followers must reject it at
                             the framing layer (no partial install)
    cluster.step.stall       a step dispatch wedges past the barrier
                             deadline, degrading the host to the
                             inline host-index path
    switch.flowcache.stale   ONE flow-cache generation bump is
                             suppressed (ctx = switch alias): proves
                             the generation gate is what prevents the
                             native flow table forwarding through a
                             stale action after a rule mutation
    engine.swap.stall        the background standby-table compile
                             (rules/engine.py TableInstaller) sleeps
                             VPROXY_TPU_SWAP_STALL_S before publishing:
                             proves dispatch keeps answering the OLD
                             generation through a slow install and
                             flips atomically after

Each armed fault carries three independent gates, all optional:

* probability p in (0, 1]  — fire on a coin flip (default 1.0). The
  coin is a per-fault `random.Random(seed)` so a seeded arm replays the
  same hit sequence — "deterministic" is the design goal, not a vibe.
  When no explicit seed is given, the seed is derived from
  `VPROXY_TPU_FAILPOINT_SEED` (read at arm time) combined with the site
  name: one process-level seed makes EVERY probability arm in a
  chaos/storm run reproducible, and the harnesses (`tools/chaos.py
  --seed`, `tools/storm.py --seed`) echo it into their report/BENCH
  artifact so a failed SLO gate can be replayed exactly.
* count n                  — fire at most n times, then auto-disarm.
* match m                  — fire only when the site's context string
  (e.g. the backend "ip:port") contains m.

The hot-path cost when nothing is armed is one module-global bool read
(`_armed` flips with registry size); sites call `failpoint.hit(name,
ctx)` unconditionally.

Env bootstrap (mirrors the VPROXY_TPU_* knob layer): arm faults at
import with `VPROXY_TPU_FAILPOINTS=name[:p[:n]][@match][,...]`, e.g.

    VPROXY_TPU_FAILPOINTS=backend.connect.refuse:0.5@:8080,pump.abort::3
"""
from __future__ import annotations

import os
import random
import threading
from typing import Optional

# the catalog of wired sites — arming anything else is a typo, and the
# command surface must reject typos loudly (a fault that never fires
# "passes" every chaos run)
SITES = (
    "backend.connect.refuse",
    "backend.connect.hang",
    "device.dispatch.error",
    "hc.force_down",
    "pump.abort",
    "pool.handover.dead",
    "cluster.peer.drop",
    "cluster.replicate.torn",
    "cluster.step.stall",
    "switch.flowcache.stale",
    "engine.swap.stall",
    "lane.entry.stale",
    # policing/engine.check consults this FIRST: a hit pins the verdict
    # to shed (ctx "<dim>:<key>", so match= selects specific keys) —
    # tests prove enforcement wiring without traffic shaping. Arming it
    # punts lane accepts to the python mirror (any_armed_excluding),
    # which is where the forced verdict applies.
    "policing.decision.force",
)

# fired (no args) after any arm/disarm/clear/auto-disarm edge — the
# accept lanes subscribe so armed faults force the classic accept path
# in C (vtl_lanes_set_punt_all) without a per-accept ctypes crossing
on_change: list = []


def _fire_change() -> None:
    for cb in list(on_change):
        try:
            cb()
        except Exception:
            pass

_lock = threading.Lock()
_registry: dict[str, "Fault"] = {}
_armed = False  # lock-free fast-path gate, true iff _registry non-empty


class Fault:
    __slots__ = ("name", "probability", "count", "match", "hits", "_rng")

    def __init__(self, name: str, probability: float = 1.0,
                 count: Optional[int] = None, match: Optional[str] = None,
                 seed: Optional[int] = None):
        if name not in SITES:
            raise ValueError(f"unknown failpoint {name!r} "
                             f"(known: {', '.join(SITES)})")
        if not 0.0 < probability <= 1.0:
            raise ValueError(f"probability must be in (0, 1], got {probability}")
        if count is not None and count <= 0:
            raise ValueError(f"count must be positive, got {count}")
        self.name = name
        self.probability = probability
        self.count = count  # remaining fires; None = unlimited
        self.match = match
        self.hits = 0
        if seed is None:
            # string seeds hash by VALUE (sha512 path), not by the
            # PYTHONHASHSEED-randomized hash — stable across processes,
            # so --seed replays the same arm sequence everywhere
            seed = f"{os.environ.get('VPROXY_TPU_FAILPOINT_SEED', '')}:{name}"
        self._rng = random.Random(seed)

    def describe(self) -> dict:
        return {"name": self.name, "probability": self.probability,
                "count": self.count, "match": self.match, "hits": self.hits}


def arm(name: str, probability: float = 1.0, count: Optional[int] = None,
        match: Optional[str] = None, seed: Optional[int] = None) -> None:
    """Arm (or re-arm, replacing) a fault site."""
    global _armed
    f = Fault(name, probability, count, match, seed)
    with _lock:
        _registry[name] = f
        _armed = True
    _fire_change()


def disarm(name: str) -> bool:
    """Disarm; returns False when the fault wasn't armed."""
    global _armed
    with _lock:
        gone = _registry.pop(name, None) is not None
        _armed = bool(_registry)
    if gone:
        _fire_change()
    return gone


def clear() -> None:
    """Test hook: drop every armed fault."""
    global _armed
    with _lock:
        _registry.clear()
        _armed = False
    _fire_change()


def active() -> list[dict]:
    """Snapshot for `GET /faults` / `list fault`."""
    with _lock:
        return [f.describe() for f in _registry.values()]


def any_armed() -> bool:
    """Any fault armed at all (the lock-free fast-path gate). The accept
    fast lane (C-side connect+pump, tcplb._fast_splice) bypasses the
    python connect path whose code hosts the backend.connect.* sites, so
    it defers to the classic path whenever faults are armed — failpoint
    semantics stay exact under test."""
    return _armed


def any_armed_excluding(prefix: str) -> bool:
    """any_armed() minus sites under `prefix` — the accept lanes force
    the classic path for every armed fault EXCEPT the lane.* sites
    themselves (lane.entry.stale suppresses a generation bump; forcing
    punts on it would make the gate untestable)."""
    with _lock:
        return any(not n.startswith(prefix) for n in _registry)


def hit(name: str, ctx: str = "") -> bool:
    """Ask a site whether its fault fires for this event. Decrements a
    count arm on fire and auto-disarms at zero. Safe from any thread."""
    global _armed
    if not _armed:
        return False
    with _lock:
        f = _registry.get(name)
        if f is None:
            return False
        if f.match is not None and f.match not in ctx:
            return False
        if f.probability < 1.0 and f._rng.random() >= f.probability:
            return False
        f.hits += 1
        auto_disarmed = False
        if f.count is not None:
            f.count -= 1
            if f.count <= 0:
                del _registry[name]
                _armed = bool(_registry)
                auto_disarmed = True
    if auto_disarmed:
        _fire_change()  # a count arm draining re-enables the lanes
    from . import events
    events.record("fault_injected", f"failpoint {name} fired",
                  failpoint=name, ctx=ctx)
    return True


def _bootstrap_env() -> None:
    """VPROXY_TPU_FAILPOINTS=name[:p[:n]][@match],... at import."""
    spec = os.environ.get("VPROXY_TPU_FAILPOINTS", "")
    for part in filter(None, (p.strip() for p in spec.split(","))):
        body, _, match = part.partition("@")
        fields = body.split(":")
        try:
            name = fields[0]
            p = float(fields[1]) if len(fields) > 1 and fields[1] else 1.0
            n = int(fields[2]) if len(fields) > 2 and fields[2] else None
            arm(name, p, n, match or None)
        except ValueError as e:
            import sys
            print(f"VPROXY_TPU_FAILPOINTS: skipping {part!r}: {e}",
                  file=sys.stderr)


_bootstrap_env()
