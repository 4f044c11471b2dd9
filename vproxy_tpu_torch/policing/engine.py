"""Policing engine — detection → decision → enforcement.

The decision plane. Operators declare policies over the analytics
dimensions (`add policy gold dim=clients rate=50 burst=100 action=shed
[tenant=10.0.0.0/8]`); each tick the engine reads the rotating sketch
windows (utils/sketch), takes every policy's dimension top-K, and
compiles the matching keys into a compact enforcement table: one token
bucket per (dim, key). The hot paths then consult that table in O(1):

* C accept lanes — `compile_recs()` packs the clients-dimension entries
  into the generation-stamped POLICE_REC ABI and every registered
  installer (components/lanes.py) pushes them into the .so, where the
  probe is one open-addressed lookup + bucket debit in `lane_client`.
* python accept path — components/tcplb._on_accept calls `check()`
  with the same integer bucket math, so a punted or laned-off accept
  reaches the same verdict the C probe would have.
* AIMD shed order — when AdaptiveOverload's ceiling sheds, tcplb asks
  `overload_spare()`: over-quota keys are never spared, in-quota
  tenants draw on a deficit-round-robin budget refilled each tick in
  proportion to their policy rate (weighted-fair: a 3:1 rate ratio
  buys a 3:1 spare ratio under pressure).
* DNS — `quarantined()` turns a shed verdict on the qnames dimension
  into a pre-packed REFUSED answer that never re-walks the group.

Verdict vocabulary (closed — the vproxy_lb_policed_total `action`
label): `monitor` counts over-quota arrivals without refusing them (the
right default while calibrating a rate), `throttle` defers to the
overload ceiling (shed only when the LB is already at its limit),
`shed` refuses outright.

Determinism: bucket state is integer milli-tokens against explicit
monotonic nanoseconds — the exact arithmetic the C probe uses — so the
same arrival sequence at the same timestamps reaches the same verdict
sequence on either side (tests/test_policing.py drives both through
`vtl.police_check` and `check_at` and asserts bit-equality). The
`policing.decision.force` failpoint pins a verdict without traffic
shaping, and inherits VPROXY_TPU_FAILPOINT_SEED like every other site.

Fleet: `gossip_summary()` rides the membership heartbeat meta (the
analytics `hh` field idiom, cluster/__init__._hb_meta) and
`ingest_peer_tables()` merges what peers enforce into the local table
with a tick-TTL — a crowd seen by one node sheds on all within one
heartbeat period, and expires everywhere within TTL ticks of the
origin dropping it.

Knob: VPROXY_TPU_POLICING=0 disables every site for exactly one module
bool read per python site and one relaxed atomic per C site — the
workload.py/sketch.py knob contract, enforced by the knob-off test.

The port's copy of vproxy_tpu/policing/engine.py, same names and behaviour.
"""
from __future__ import annotations

import hashlib
import ipaddress
import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..utils import events, failpoint, sketch
from ..utils.trace import fnv64

ON = os.environ.get("VPROXY_TPU_POLICING", "1") != "0"
# tick cadence: half an analytics window keeps enforcement at most one
# rotation behind detection without a dedicated thread (ticks are lazy,
# piggybacked on check()/drain callers — the sketch rotation idiom)
TICK_S = float(os.environ.get("VPROXY_TPU_POLICING_TICK_S", "1.0"))
# gossip-merged entries survive this many ticks without a refresh from
# the origin node — the fleet forget bound
TTL_TICKS = int(os.environ.get("VPROXY_TPU_POLICING_TTL_TICKS", "5"))

ACTIONS = ("monitor", "throttle", "shed")
ACTION_CODE = {a: i for i, a in enumerate(ACTIONS)}

_NS = 1_000_000_000
_COST_MTOK = 1000  # one arrival = one token, in milli-tokens


def _client_key_bytes(key: str) -> bytes:
    """The hash-input contract for the clients dimension: the RAW 4/16
    address bytes, NOT the rendered string — the C probe hashes what
    maglev_addr_bytes hands it, and parity lives or dies here."""
    try:
        return socket.inet_pton(socket.AF_INET, key)
    except OSError:
        pass
    try:
        return socket.inet_pton(socket.AF_INET6, key)
    except OSError:
        return key.encode("utf-8", "replace")


def key_hash(dim: str, key: str) -> int:
    """POLICE_REC.key_hash — fnv64 over the dimension's canonical key
    bytes (raw address for clients, utf-8 for everything else)."""
    kb = _client_key_bytes(key) if dim == "clients" else \
        key.encode("utf-8", "replace")
    return fnv64(kb)


class TokenBucket:
    """Integer milli-token bucket against explicit monotonic ns — the
    ONE bucket law, duplicated (deliberately, with a parity test) in
    vtl.cpp police_debit. Starts full: a key's first appearance in the
    top-K is evidence of volume, but burst is the operator's grace."""

    __slots__ = ("rate_mtok", "burst_mtok", "level_mtok", "t_ns")

    def __init__(self, rate: float, burst: float, now_ns: int):
        self.rate_mtok = max(0, int(rate * 1000))
        self.burst_mtok = max(_COST_MTOK, int(burst * 1000))
        self.level_mtok = self.burst_mtok
        self.t_ns = now_ns

    def debit(self, now_ns: int, cost_mtok: int = _COST_MTOK) -> bool:
        """True = in quota (token taken), False = over quota."""
        dt = now_ns - self.t_ns
        if dt > 0:
            self.level_mtok = min(
                self.burst_mtok,
                self.level_mtok + self.rate_mtok * dt // _NS)
            self.t_ns = now_ns
        if self.level_mtok >= cost_mtok:
            self.level_mtok -= cost_mtok
            return True
        return False


class Policy:
    """One operator-declared rule: keys surfacing in `dim`'s top-K get
    a rate/burst bucket and `action` on over-quota. `tenant` scopes the
    policy (clients: a CIDR; other dims: an exact key match) and names
    a weight class for the fair-shed order."""

    __slots__ = ("name", "dim", "rate", "burst", "action", "tenant",
                 "_net")

    def __init__(self, name: str, dim: str, rate: float, burst: float,
                 action: str, tenant: Optional[str] = None):
        if dim not in sketch.DIMS:
            raise ValueError(f"unknown policy dimension {dim!r} "
                             f"(one of {', '.join(sketch.DIMS)})")
        if action not in ACTIONS:
            raise ValueError(f"unknown policy action {action!r} "
                             f"(one of {', '.join(ACTIONS)})")
        if rate <= 0:
            raise ValueError(f"policy rate must be positive, got {rate}")
        if burst < 1:
            raise ValueError(f"policy burst must be >= 1, got {burst}")
        self.name = name
        self.dim = dim
        self.rate = float(rate)
        self.burst = float(burst)
        self.action = action
        self.tenant = tenant
        self._net = None
        if tenant and dim == "clients":
            try:
                self._net = ipaddress.ip_network(tenant, strict=False)
            except ValueError:
                pass  # route-name tenant on a clients policy: no scope

    def matches(self, key: str) -> bool:
        if self.tenant is None:
            return True
        if self._net is not None:
            try:
                return ipaddress.ip_address(key) in self._net
            except ValueError:
                return False
        return key == self.tenant

    def describe(self) -> dict:
        return {"name": self.name, "dim": self.dim, "rate": self.rate,
                "burst": self.burst, "action": self.action,
                "tenant": self.tenant}


class _Entry:
    __slots__ = ("dim", "key", "policy", "action", "rate_mtok",
                 "burst_mtok", "bucket", "origin", "ttl")

    def __init__(self, dim, key, policy, action, rate_mtok, burst_mtok,
                 bucket, origin, ttl):
        self.dim = dim
        self.key = key
        self.policy = policy        # policy name (or peer node id)
        self.action = action
        self.rate_mtok = rate_mtok
        self.burst_mtok = burst_mtok
        self.bucket = bucket
        self.origin = origin        # "local" | "peer"
        self.ttl = ttl


class PolicingEngine:
    """One node's decision plane. The module-level `default()` instance
    serves the hot paths; tests build extras to model a fleet in one
    process."""

    def __init__(self):
        self.lock = threading.RLock()
        self.policies: Dict[str, Policy] = {}
        self._table: Dict[Tuple[str, str], _Entry] = {}
        self._deficit: Dict[str, float] = {}
        self._last_tick = 0.0
        self.seq = 0
        # counters — read by the metric families and GET /policing
        self.policed: Dict[Tuple[str, str, str], int] = {}  # (lb,act,dim)
        self.tables_installed = 0
        self.gossip_merges = 0
        self.ticks = 0
        # installers: callables(recs: List[bytes]) -> bool, registered
        # by every owner of a C lane table (components/lanes.py)
        self.on_install: List[Callable] = []

    # ---------------- policy set ----------------

    def set_policy(self, pol: Policy) -> None:
        with self.lock:
            self.policies[pol.name] = pol
            self._deficit.setdefault(self._tenant_name(pol), 0.0)

    def remove_policy(self, name: str) -> bool:
        with self.lock:
            return self.policies.pop(name, None) is not None

    def set_policies(self, pols) -> None:
        """Replace the whole set (the command/replication handler)."""
        with self.lock:
            self.policies = {p.name: p for p in pols}

    def list_policies(self) -> List[dict]:
        with self.lock:
            return [p.describe() for p in self.policies.values()]

    @staticmethod
    def _tenant_name(pol: Policy) -> str:
        return pol.tenant if pol.tenant is not None else ""

    # ---------------- tick: detection -> table ----------------

    def maybe_tick(self, now: Optional[float] = None) -> bool:
        if now is None:
            now = time.monotonic()
        if now - self._last_tick < TICK_S:
            return False
        self.tick(now=now)
        return True

    def tick(self, now: Optional[float] = None,
             now_ns: Optional[int] = None) -> None:
        """Recompile the enforcement table from the current sketch
        windows, refill the fair-shed deficits, refresh TTLs, and push
        the clients-dimension slice into every registered C lane."""
        if now is None:
            now = time.monotonic()
        if now_ns is None:
            now_ns = time.monotonic_ns()
        with self.lock:
            self._last_tick = now
            self.seq += 1
            self.ticks += 1
            new: Dict[Tuple[str, str], _Entry] = {}
            dims_seen = set()
            for pol in self.policies.values():
                # refill the tenant's DRR budget: rate * tick worth of
                # spares, capped at one burst — weighted-fair by
                # construction (budget proportional to declared rate)
                tn = self._tenant_name(pol)
                self._deficit[tn] = min(
                    self._deficit.get(tn, 0.0) + pol.rate * TICK_S,
                    max(pol.burst, pol.rate * TICK_S))
                if pol.dim not in dims_seen:
                    dims_seen.add(pol.dim)
                for row in sketch.top_table(pol.dim, 0):
                    key = row["key"]
                    if not pol.matches(key):
                        continue
                    ent = self._table.get((pol.dim, key))
                    rate_mtok = int(pol.rate * 1000)
                    burst_mtok = max(_COST_MTOK, int(pol.burst * 1000))
                    if (ent is not None and ent.policy == pol.name
                            and ent.rate_mtok == rate_mtok
                            and ent.burst_mtok == burst_mtok):
                        ent.ttl = TTL_TICKS  # carry bucket state over
                        new[(pol.dim, key)] = ent
                    else:
                        new[(pol.dim, key)] = _Entry(
                            pol.dim, key, pol.name, pol.action,
                            rate_mtok, burst_mtok,
                            TokenBucket(pol.rate, pol.burst, now_ns),
                            "local", TTL_TICKS)
            # peer-merged entries age out instead of recompiling — the
            # origin node's next gossip refreshes them
            for k, ent in self._table.items():
                if ent.origin != "peer" or k in new:
                    continue
                ent.ttl -= 1
                if ent.ttl > 0:
                    new[k] = ent
            self._table = new
            installers = list(self.on_install)
            recs = self._compile_recs_locked()
        installed = 0
        for cb in installers:
            try:
                if cb(recs):
                    installed += 1
            except Exception:
                pass
        if installed:
            with self.lock:
                self.tables_installed += installed
        if ON:
            events.record(
                "policy_install",
                f"policing table seq={self.seq} keys={len(new)} "
                f"lanes={installed}",
                plane="policing", seq=self.seq, keys=len(new),
                lanes=installed)

    # ---------------- the verdict ----------------

    def check(self, dim: str, key: str, lb: str = "",
              trace_id: int = 0,
              now_ns: Optional[int] = None) -> str:
        """The python accept mirror: one dict probe + one bucket debit.
        Returns one of "admit" | ACTIONS. Accounts every non-admit
        verdict under (lb, action, dim)."""
        if not ON:
            return "admit"
        if failpoint.hit("policing.decision.force", f"{dim}:{key}"):
            self._account(lb, "shed", dim)
            self._shed_event(dim, key, lb, "shed", trace_id,
                             forced=True)
            return "shed"
        with self.lock:
            ent = self._table.get((dim, key))
            if ent is None:
                return "admit"
            if now_ns is None:
                now_ns = time.monotonic_ns()
            if ent.bucket.debit(now_ns):
                return "admit"
            action = ent.action
            self._account_locked(lb, action, dim)
        if action != "monitor":
            self._shed_event(dim, key, lb, action, trace_id)
        return action

    def check_at(self, dim: str, key: str, now_ns: int) -> str:
        """Deterministic probe at an explicit timestamp — the parity
        test's python half (no accounting, no failpoint, mirrors
        vtl.police_check exactly)."""
        with self.lock:
            ent = self._table.get((dim, key))
            if ent is None:
                return "admit"
            if ent.bucket.debit(now_ns):
                return "admit"
            return ent.action

    def quarantined(self, qname: str, lb: str = "",
                    trace_id: int = 0) -> bool:
        """DNS hook: True = answer REFUSED from the packed cache layer,
        never re-walk the group."""
        if not ON:
            return False
        v = self.check("qnames", qname, lb=lb, trace_id=trace_id)
        if v == "shed":
            events.record("quarantine",
                          f"qname {qname} quarantined on {lb}",
                          plane="policing", qname=qname, lb=lb,
                          trace_id=trace_id)
            return True
        return False

    def overload_spare(self, ip: str, lb: str = "",
                       trace_id: int = 0) -> bool:
        """The weighted-fair shed order. Called when the AIMD ceiling
        would shed this arrival: True = spare it (in-quota tenant with
        deficit budget left), False = shed as planned. Over-quota keys
        are NEVER spared — they are what the ceiling should be shedding
        first."""
        if not ON:
            return False
        with self.lock:
            ent = self._table.get(("clients", ip))
            if ent is not None:
                if not ent.bucket.debit(time.monotonic_ns()):
                    # over quota: the preferred victim
                    self._account_locked(lb, ent.action, "clients")
                    return False
            pol = self._tenant_policy(ip)
            if pol is None:
                return False  # unclassed traffic draws no spare budget
            tn = self._tenant_name(pol)
            if self._deficit.get(tn, 0.0) >= 1.0:
                self._deficit[tn] -= 1.0
                return True
            return False

    def _tenant_policy(self, ip: str) -> Optional[Policy]:
        for pol in self.policies.values():
            if pol.dim == "clients" and pol.tenant is not None \
                    and pol.matches(ip):
                return pol
        return None

    # ---------------- accounting ----------------

    def _account(self, lb: str, action: str, dim: str,
                 n: int = 1) -> None:
        with self.lock:
            self._account_locked(lb, action, dim, n)

    def _account_locked(self, lb, action, dim, n: int = 1) -> None:
        k = (lb, action, dim)
        self.policed[k] = self.policed.get(k, 0) + n

    def account_native(self, lb: str, action: str, dim: str,
                       n: int) -> None:
        """Fold a C-lane counter delta (lane 0's drain merges the .so
        tallies exactly once — the _fold_lane_sheds contract)."""
        if n > 0:
            self._account(lb, action, dim, n)

    def _shed_event(self, dim, key, lb, action, trace_id,
                    forced=False) -> None:
        events.record("policy_shed",
                      f"policing {action} {dim}:{key} on {lb}",
                      plane="policing", dim=dim, key=key, lb=lb,
                      action=action, forced=forced, trace_id=trace_id)

    def policed_total(self, lb: Optional[str] = None,
                      action: Optional[str] = None,
                      dim: Optional[str] = None) -> int:
        with self.lock:
            return sum(
                v for (l, a, d), v in self.policed.items()
                if (lb is None or l == lb)
                and (action is None or a == action)
                and (dim is None or d == dim))

    # ---------------- the C table ----------------

    def _compile_recs_locked(self) -> List[bytes]:
        from ..net import vtl
        recs = []
        for (dim, key), ent in self._table.items():
            if dim != "clients":
                continue  # the lanes only see client addresses
            recs.append(vtl.POLICE_REC.pack(
                key_hash(dim, key), ent.rate_mtok, ent.burst_mtok,
                ACTION_CODE[ent.action], 0, b"\x00\x00"))
        return recs

    def compile_recs(self) -> List[bytes]:
        with self.lock:
            return self._compile_recs_locked()

    # ---------------- fleet ----------------

    def gossip_summary(self) -> dict:
        """The heartbeat-meta payload: locally-compiled entries only
        (peer-merged state is never re-gossiped — no echo
        amplification). Always small: bounded by K per policed dim."""
        with self.lock:
            return {"seq": self.seq,
                    "t": [[e.dim, e.key, e.rate_mtok, e.burst_mtok,
                           ACTION_CODE[e.action]]
                          for e in self._table.values()
                          if e.origin == "local"]}

    def ingest_peer_tables(self, peers: dict) -> int:
        """Merge what UP peers enforce ({node_id: gossip_summary()}).
        Local entries always win (this node has its own evidence);
        peer entries enter with a fresh TTL and age out unless
        re-gossiped. Returns newly-merged key count."""
        if not ON:
            return 0
        merged = 0
        now_ns = time.monotonic_ns()
        with self.lock:
            for nid, summ in (peers or {}).items():
                for row in (summ or {}).get("t", ()):
                    try:
                        dim, key, rate_mtok, burst_mtok, act = row[:5]
                        action = ACTIONS[int(act)]
                        rate_mtok = int(rate_mtok)
                        burst_mtok = int(burst_mtok)
                    except (ValueError, IndexError, TypeError):
                        continue
                    ent = self._table.get((dim, key))
                    if ent is not None and ent.origin == "local":
                        continue
                    if (ent is not None and ent.rate_mtok == rate_mtok
                            and ent.burst_mtok == burst_mtok
                            and ACTION_CODE[ent.action] == act):
                        ent.ttl = TTL_TICKS  # refresh, keep bucket
                        continue
                    tb = TokenBucket(rate_mtok / 1000.0,
                                     burst_mtok / 1000.0, now_ns)
                    self._table[(dim, key)] = _Entry(
                        dim, key, str(nid), action, rate_mtok,
                        burst_mtok, tb, "peer", TTL_TICKS)
                    merged += 1
            if merged:
                self.gossip_merges += merged
        return merged

    # ---------------- introspection ----------------

    def table_snapshot(self) -> List[dict]:
        with self.lock:
            return [{"dim": e.dim, "key": e.key, "policy": e.policy,
                     "action": e.action,
                     "rate": e.rate_mtok / 1000.0,
                     "burst": e.burst_mtok / 1000.0,
                     "level": e.bucket.level_mtok / 1000.0,
                     "origin": e.origin, "ttl": e.ttl}
                    for e in self._table.values()]

    def status(self) -> dict:
        with self.lock:
            return {"enabled": ON, "seq": self.seq,
                    "keys": len(self._table),
                    "policies": len(self.policies),
                    "ticks": self.ticks,
                    "tables_installed_total": self.tables_installed,
                    "gossip_merges_total": self.gossip_merges,
                    "policed_total": sum(self.policed.values())}

    def policed_by_node(self) -> dict:
        """The per-node `policed` attribution merged into
        GET /analytics: {action: count} for this node."""
        with self.lock:
            out: Dict[str, int] = {}
            for (_lb, action, _dim), v in self.policed.items():
                out[action] = out.get(action, 0) + v
            return out

    def shed_receipt(self) -> str:
        """Order-independent hash over the policed key set — the storm
        row's determinism receipt (same capture + same seed => same
        receipt)."""
        with self.lock:
            keys = sorted(f"{l}|{a}|{d}|{n}"
                          for (l, a, d), n in self.policed.items())
        return hashlib.sha256("\n".join(keys).encode()).hexdigest()[:16]

    def reset(self) -> None:
        """Test/bench hook: drop table + counters, keep policies."""
        with self.lock:
            self._table.clear()
            self._deficit = {self._tenant_name(p): 0.0
                             for p in self.policies.values()}
            self.policed.clear()
            self.tables_installed = 0
            self.gossip_merges = 0
            self.ticks = 0
            self.seq = 0
            self._last_tick = 0.0


# ---------------- the module-level default engine ----------------

_default = PolicingEngine()


def default() -> PolicingEngine:
    return _default


def enabled() -> bool:
    return ON


def configure(on: Optional[bool] = None) -> None:
    """Runtime knob (bench/test hook; production uses the env). Pushes
    the on/off state into the C lanes so both planes flip together."""
    global ON
    if on is not None:
        ON = bool(on)
        try:
            from ..net import vtl
            vtl.police_set_enabled(ON)
        except Exception:
            pass  # py provider / pre-policing .so: python sites only


def push_native_knob() -> None:
    """Push the current on/off state into the C atomic — called by
    every owner of a C lane table at start (the trace_set_sample
    idiom)."""
    try:
        from ..net import vtl
        vtl.police_set_enabled(ON)
    except Exception:
        pass


def check(dim: str, key: str, lb: str = "", trace_id: int = 0) -> str:
    if not ON:
        return "admit"  # the one-branch knob-off contract
    return _default.check(dim, key, lb=lb, trace_id=trace_id)


def quarantined(qname: str, lb: str = "", trace_id: int = 0) -> bool:
    if not ON:
        return False
    return _default.quarantined(qname, lb=lb, trace_id=trace_id)


def overload_spare(ip: str, lb: str = "") -> bool:
    if not ON:
        return False
    return _default.overload_spare(ip, lb=lb)


def maybe_tick() -> bool:
    if not ON:
        return False
    return _default.maybe_tick()


def tick() -> None:
    _default.tick()


def gossip_summary() -> dict:
    return _default.gossip_summary()


def ingest_peer_tables(peers: dict) -> int:
    return _default.ingest_peer_tables(peers)


def account_native(lb: str, action: str, dim: str, n: int) -> None:
    _default.account_native(lb, action, dim, n)


def status() -> dict:
    return _default.status()


def reset() -> None:
    _default.reset()
