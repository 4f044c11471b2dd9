"""Live traffic analytics — sketch-based heavy-hitter attribution.

The metrics and tracing layers answer "how much" (metrics) and
"where did THIS request go" (traces); this module answers the production
question in between: *which clients, routes, backends, flows and qnames
are hot RIGHT NOW*. Per-client accounting for millions of users cannot
be a hash map — it is two bounded-memory sketches per dimension:

* **Count-Min** (Cormode/Muthukrishnan) — the rate estimator: depth x
  width counter matrix, every update touches `depth` cells picked by
  independent hashes, estimate = min over rows. Never undercounts;
  overcounts by at most ~e*N/width with high probability (N = total
  stream weight), so a "hot" answer is trustworthy and a "cold" answer
  errs loudly upward, never silently downward.
* **Space-Saving** (Metwally) — the top-K identity keeper: at most K
  live counters; a new key past K evicts the minimum and inherits its
  count as its error bound. Guarantee: every true heavy hitter with
  count > N/K is IN the table, and each entry's overestimate is bounded
  by its recorded `err`.

One hash contract: FNV-1a 64 over raw key bytes — the exact
`maglev_fnv64` idiom the C planes already use (rules/maglev.py, the
flow cache, the lanes), parity-tested py==C through `vtl_hh_hash`.

Dimensions (`DIMS`): clients (peer address), backends (ip:port picked),
routes (listener/LB alias + `upstream:<name>` classify attribution),
flows (the switch flow-key), qnames (DNS). Fed from every plane where
traffic flows:

* **C accept lanes** — per-lane HH shards updated inside the poll tick
  (lane-owned, no locks); each lane's own python thread drains
  `vtl_hh_drain` (HH_REC records, `vtl_hh_rec_size`-guarded like every
  shared record) and folds the (key, count) deltas in here. Shard
  overflow is counted, never silent.
* **flow cache** — per-entry hit tallies drained via
  `vtl_hh_flow_drain` on the switch's analytics tick.
* **python accept path / DNS server / ClassifyService** — direct
  `update()` calls (one branch per site when the knob is off).

Windows: epoch-rotated current+previous pairs
(`VPROXY_TPU_ANALYTICS_WINDOW_S`, default 10s): queries merge both
windows so "current rate" covers the last 10-20s and old traffic is
forgotten two rotations later — no unbounded growth, no decay math on
the hot path. `VPROXY_TPU_ANALYTICS=0` turns the whole plane off
(python sites cost one branch; the C shards gate on one relaxed load).

Surfaces: `top [clients|backends|routes|flows|qnames]` on every command
surface, `list[-detail] analytics`, `GET /analytics` on both HTTP
servers, `vproxy_hh_count{dim,slot}` gauges, and the fleet view — each
node gossips its top-K over the membership heartbeats and any node's
`GET /analytics` renders the merged table (docs/observability.md).

The port's copy of vproxy_tpu/utils/sketch.py, same names and behaviour,
less `snapshot_with_fleet`: it reads the cluster plane, which the port
does not have yet, and only the control plane calls it.
"""
from __future__ import annotations

import os
import struct
import threading
import time
from typing import Dict, List, Optional

ON = os.environ.get("VPROXY_TPU_ANALYTICS", "1") != "0"
WINDOW_S = float(os.environ.get("VPROXY_TPU_ANALYTICS_WINDOW_S", "10"))
TOPK = int(os.environ.get("VPROXY_TPU_ANALYTICS_K", "32"))
CM_WIDTH = int(os.environ.get("VPROXY_TPU_ANALYTICS_CM_WIDTH", "1024"))
CM_DEPTH = int(os.environ.get("VPROXY_TPU_ANALYTICS_CM_DEPTH", "4"))

DIMS = ("clients", "backends", "routes", "flows", "qnames")
# update-plane vocabulary (closed: the vproxy_analytics_updates_total
# label set) — lane is counted in C (vtl_hh_counters), the rest here
PLANES = ("lane", "accept", "dns", "engine", "flow", "cluster")
TOP_SLOTS = 8  # vproxy_hh_count{dim,slot} exposes this many ranks

# FNV-1a 64 — THE hash contract, bit-identical to the C side's
# maglev_fnv64 (parity surface: net/vtl.hh_hash, tests/test_sketch).
# ONE python copy, shared with the tracing sampler — a contract in two
# drifting copies is no contract.
from .trace import fnv64  # noqa: E402


class CountMin:
    """depth x width counter matrix. Row i's cell for a key derives
    from TWO fnv passes (h1 over the key, h2 over the key + one salt
    byte, forced odd) as (h1 + i*h2) mod width — the standard
    double-hashing family, so every row is pairwise independent enough
    for the e*N/width bound while the contract stays "FNV over raw key
    bytes". Linear: update(key, w) == w x update(key, 1), which is what
    makes the C shard's coalesced (key, count) deltas EXACTLY
    equivalent to per-event updates (tests/test_sketch merge test)."""

    __slots__ = ("width", "depth", "rows", "total")

    def __init__(self, width: int = CM_WIDTH, depth: int = CM_DEPTH):
        self.width = width
        self.depth = depth
        self.rows = [[0] * width for _ in range(depth)]
        self.total = 0

    @staticmethod
    def _hashes(key: bytes) -> tuple:
        h1 = fnv64(key)
        h2 = fnv64(key + b"\x9e") | 1
        return h1, h2

    def update(self, key: bytes, w: int = 1) -> None:
        h1, h2 = self._hashes(key)
        for i in range(self.depth):
            self.rows[i][(h1 + i * h2) % self.width] += w
        self.total += w

    def estimate(self, key: bytes) -> int:
        h1, h2 = self._hashes(key)
        return min(self.rows[i][(h1 + i * h2) % self.width]
                   for i in range(self.depth))


class SpaceSaving:
    """At most K live (count, err) counters. A key past capacity evicts
    the current minimum and inherits its count as the error bound —
    guaranteed superset of every key with true count > total/K, each
    entry overestimated by at most its `err`."""

    __slots__ = ("k", "counts", "evictions")

    def __init__(self, k: int = TOPK):
        self.k = k
        self.counts: Dict[str, list] = {}  # key -> [count, err]
        self.evictions = 0

    def update(self, key: str, w: int = 1) -> None:
        ent = self.counts.get(key)
        if ent is not None:
            ent[0] += w
            return
        if len(self.counts) < self.k:
            self.counts[key] = [w, 0]
            return
        mk = min(self.counts, key=lambda x: self.counts[x][0])
        mc = self.counts.pop(mk)[0]
        self.counts[key] = [mc + w, mc]
        self.evictions += 1

    def top(self, n: int = 0) -> List[tuple]:
        """[(key, count, err)] descending; n=0 = all K."""
        items = sorted(((k, v[0], v[1]) for k, v in self.counts.items()),
                       key=lambda t: t[1], reverse=True)
        return items[:n] if n > 0 else items


class WindowedSketch:
    """One dimension's epoch-rotated CountMin + SpaceSaving pair.
    Rotation is lazy (checked on update/query against the monotonic
    clock — no dedicated thread): current becomes previous, previous is
    forgotten. Queries merge both windows, so an answer always covers
    between one and two window spans of traffic."""

    def __init__(self, dim: str, window_s: float = 0.0, k: int = 0,
                 width: int = 0, depth: int = 0):
        self.dim = dim
        self.window_s = window_s or WINDOW_S
        self.k = k or TOPK
        self.width = width or CM_WIDTH
        self.depth = depth or CM_DEPTH
        self.lock = threading.Lock()
        self.updates = 0
        self.rotations = 0
        now = time.monotonic()
        self._cur = (CountMin(self.width, self.depth),
                     SpaceSaving(self.k))
        self._prev = (CountMin(self.width, self.depth),
                      SpaceSaving(self.k))
        self._cur_start = now
        self._rotate_at = now + self.window_s
        # False until a previous window has actually ELAPSED (first
        # rotation; reset again by an idle-gap wipe): the rate
        # denominator must cover only real observed time, or the first
        # window's rates read up to (1 + window/elapsed)x low
        self._has_prev = False

    # caller holds self.lock
    def _maybe_rotate(self, now: float) -> None:
        if now < self._rotate_at:
            return
        if now >= self._rotate_at + self.window_s:
            # idle gap longer than a whole window: both windows are
            # stale — forget everything, start fresh (ONE rotation
            # event; the shared tail below counts it). The wiped prev
            # covers no observed time.
            self._prev = (CountMin(self.width, self.depth),
                          SpaceSaving(self.k))
            self._has_prev = False
        else:
            self._prev = self._cur
            self._has_prev = True
        self._cur = (CountMin(self.width, self.depth),
                     SpaceSaving(self.k))
        self._cur_start = now
        self._rotate_at = now + self.window_s
        self.rotations += 1

    def update(self, key: str, w: int = 1,
               now: Optional[float] = None) -> None:
        kb = key.encode() if isinstance(key, str) else bytes(key)
        if now is None:
            now = time.monotonic()
        with self.lock:
            self._maybe_rotate(now)
            cm, ss = self._cur
            cm.update(kb, w)
            ss.update(key if isinstance(key, str) else kb.decode(
                "utf-8", "replace"), w)
            self.updates += w

    def estimate(self, key: str, now: Optional[float] = None) -> int:
        kb = key.encode() if isinstance(key, str) else bytes(key)
        if now is None:
            now = time.monotonic()
        with self.lock:
            self._maybe_rotate(now)
            return self._cur[0].estimate(kb) + self._prev[0].estimate(kb)

    def top(self, n: int = 0, now: Optional[float] = None) -> List[dict]:
        """Merged cur+prev top table: [{key, count, err, rate}]
        descending by count. rate = count / covered span (between one
        and two windows)."""
        if now is None:
            now = time.monotonic()
        with self.lock:
            self._maybe_rotate(now)
            merged: Dict[str, list] = {}
            for cm_ss in (self._prev, self._cur):
                for key, cnt, err in cm_ss[1].top():
                    ent = merged.get(key)
                    if ent is None:
                        merged[key] = [cnt, err]
                    else:
                        ent[0] += cnt
                        ent[1] += err
            span = now - self._cur_start \
                + (self.window_s if self._has_prev else 0.0)
            span = max(1e-9, min(span, 2 * self.window_s))
        out = sorted(({"key": k, "count": c, "err": e,
                       "rate": round(c / span, 3)}
                      for k, (c, e) in merged.items()),
                     key=lambda d: d["count"], reverse=True)
        return out[:n] if n > 0 else out

    def stat(self) -> dict:
        with self.lock:
            cm, ss = self._cur
            return {"dim": self.dim, "window_s": self.window_s,
                    "k": self.k, "cm_width": self.width,
                    "cm_depth": self.depth, "updates": self.updates,
                    "rotations": self.rotations,
                    "window_total": cm.total + self._prev[0].total,
                    "ss_evictions": ss.evictions
                    + self._prev[1].evictions}


# ------------------------------------------------------------ the plane

_lock = threading.Lock()
_dims: Dict[str, WindowedSketch] = {}
_plane_updates = {p: 0 for p in PLANES}
# rows beyond the top table at the MOST RECENT fleet merge (a gauge,
# not a lifetime total: fleet_table runs per render, so a cumulative
# tally would grow with dashboard poll rate, not with data loss)
_merge_truncated = 0


def _sk(dim: str) -> WindowedSketch:
    sk = _dims.get(dim)
    if sk is None:
        with _lock:
            sk = _dims.get(dim)
            if sk is None:
                sk = _dims[dim] = WindowedSketch(dim)
    return sk


def enabled() -> bool:
    return ON


def configure(on: Optional[bool] = None,
              window_s: Optional[float] = None) -> None:
    """Runtime knob (bench/test hook; production uses the env). Pushes
    the on/off state into the C planes so the lane shards and the flow
    tallies flip together with the python sites."""
    global ON, WINDOW_S
    if on is not None:
        ON = bool(on)
        try:
            from ..net import vtl
            vtl.hh_set_enabled(ON)
        except Exception:
            pass  # py provider / pre-analytics .so: python sites only
    if window_s is not None:
        WINDOW_S = float(window_s)
        with _lock:
            _dims.clear()  # fresh sketches pick up the new window
            _slot_memo.clear()


def push_native_knob() -> None:
    """Push the current on/off state into the C atomic — called from
    every owner of a C-side shard at start (components/lanes.py,
    vswitch/switch.py), the trace_set_sample idiom."""
    try:
        from ..net import vtl
        vtl.hh_set_enabled(ON)
    except Exception:
        pass


# one lock per plane: concurrent updaters (lane threads, worker loops,
# the DNS thread) must not lose increments to a read-modify-write
# interleave, and unrelated planes must not serialize on one module
# lock per observation (two accept-path updates per connection)
_plane_locks = {p: threading.Lock() for p in PLANES}


def _plane_incr(plane: str, w: int) -> None:
    with _plane_locks.get(plane) or _lock:
        _plane_updates[plane] = _plane_updates.get(plane, 0) + w


def update(dim: str, key: str, w: int = 1, plane: str = "accept") -> None:
    """One traffic observation. The knob-off cost at every call site is
    this one branch."""
    if not ON:
        return
    _sk(dim).update(key, w)
    _plane_incr(plane, w)


# the C FlowKey prefix of FLOW_REC (net/vtl.py) — rendered, not
# reinterpreted: sender_ip u32, sender_port u16, vni 3s, eth_dst 6s,
# eth_type 2s, ip_src 4s, ip_dst 4s, proto B
_FLOW_KEY = struct.Struct("<IH3s6s2s4s4sB")


def _render_flow_key(kb: bytes) -> str:
    if len(kb) < _FLOW_KEY.size:
        return kb.hex()
    (snd_ip, snd_port, vni, _dst, _etype, ip_src, ip_dst,
     proto) = _FLOW_KEY.unpack_from(kb)
    vni_i = int.from_bytes(vni, "big")
    if any(ip_src):
        flow = (f"{'.'.join(map(str, ip_src))}->"
                f"{'.'.join(map(str, ip_dst))}/{proto}")
    else:  # raw-L2 flow: no parsed v4 header
        flow = f"l2:{_dst.hex()}"
    snd = ".".join(str((snd_ip >> s) & 0xFF) for s in (24, 16, 8, 0))
    return f"vni{vni_i}:{flow} via {snd}:{snd_port}"


def ingest_hh_recs(recs) -> None:
    """Fold drained C HH_REC tuples ((count, lane, dim, key) — the
    net/vtl.py hh_drain / hh_flow_drain shape) into the dimension
    sketches. Client keys arrive as raw 4/16-byte addresses and render
    through format_ip so they merge with the python accept path's
    string keys; flow keys are the 26-byte C FlowKey."""
    if not ON:
        return
    from ..net.vtl import HH_DIMS
    from .ip import format_ip
    for count, _lane, dim_i, kb in recs:
        dim = HH_DIMS[dim_i] if dim_i < len(HH_DIMS) else None
        if dim is None:
            continue
        if dim == "clients":
            try:
                key = format_ip(kb)
            except (ValueError, OSError):
                key = kb.hex()
        elif dim == "flows":
            key = _render_flow_key(kb)
            # flow tallies are not in the C shard-update counter: tally
            # them here (the lane dims ARE — vtl_hh_counters — so
            # counting their ingest too would double them)
            _plane_incr("flow", count)
        else:  # backends: a C-precompiled "ip:port" string
            key = kb.decode("utf-8", "replace")
        _sk(dim).update(key, count)


# ------------------------------------------------------------- queries

def top_table(dim: str, n: int = TOP_SLOTS) -> List[dict]:
    if dim not in DIMS:
        raise ValueError(f"unknown analytics dimension {dim!r} "
                         f"(one of {', '.join(DIMS)})")
    return _sk(dim).top(n)


# scrape memo for the per-slot gauges: {dim: ((updates, rotations),
# rows)} — a /metrics scrape reads TOP_SLOTS gauges per dim, and
# without this each one would re-merge + re-sort the same table (8x
# redundant lock traffic against the hot update path). Keyed on the
# sketch's own change counters, so a stale entry is impossible: any
# update or rotation changes the key and the next gauge recomputes.
_slot_memo: Dict[str, tuple] = {}


def top_slot(dim: str, slot: int) -> float:
    """Rank `slot`'s merged count (0 when the slot is empty) — the
    vproxy_hh_count{dim,slot} gauge reader."""
    if not ON:
        return 0.0
    sk = _sk(dim)
    # the time bucket keeps an IDLE dimension honest: with no updates
    # the change counters freeze, but rotation must still run (top()
    # rotates lazily) or the gauges would report the last burst
    # forever while /analytics shows empty tables
    key = (sk.updates, sk.rotations,
           int(time.monotonic() / sk.window_s))
    memo = _slot_memo.get(dim)
    if memo is None or memo[0] != key:
        memo = (key, sk.top(TOP_SLOTS))
        _slot_memo[dim] = memo
    rows = memo[1]
    return float(rows[slot]["count"]) if slot < len(rows) else 0.0


def plane_updates_total(plane: str) -> int:
    n = _plane_updates.get(plane, 0)
    if plane == "lane":
        # the C shard-update atomic is the authoritative lane tally
        # (ingest_hh_recs deliberately does NOT re-count those dims);
        # python-side lane credits (the routes dim) add on top
        try:
            from ..net import vtl
            n += int(vtl.hh_counters()[0])
        except Exception:
            pass
    return n


def merge_truncated_last() -> int:
    """Rows the most recent fleet merge could not fit in the top table
    — the counted form of "the fleet view is top-N, more keys exist"."""
    return _merge_truncated


def rotations_total() -> int:
    return sum(sk.rotations for sk in list(_dims.values()))


def status() -> dict:
    """`list-detail analytics` / the GET /analytics "local" object."""
    return {"enabled": ON, "window_s": WINDOW_S, "k": TOPK,
            "cm": {"width": CM_WIDTH, "depth": CM_DEPTH},
            "updates": {p: plane_updates_total(p) for p in PLANES},
            "merge_truncated": _merge_truncated,
            "dims": {d: _sk(d).stat() for d in DIMS}}


def snapshot(n: int = TOP_SLOTS) -> dict:
    """The BENCH/storm artifact hook: every dimension's merged top
    table plus the plane counters, one JSON-ready dict."""
    return {"status": status(),
            "top": {d: top_table(d, n) for d in DIMS}}


def gossip_summary(n: int = 5) -> dict:
    """The compact per-node top-K that rides the membership heartbeats:
    {dim: [[key, count], ...]} for non-empty dimensions only (an idle
    node adds ~2 bytes to its heartbeat, not 5 empty tables)."""
    if not ON:
        return {}
    out = {}
    for d in DIMS:
        t = _sk(d).top(n)
        if t:
            out[d] = [[e["key"], e["count"]] for e in t]
    return out


def fleet_table(peers: dict, n: int = TOP_SLOTS) -> dict:
    """Merge this node's top tables with the gossiped peer summaries
    ({node_id: {dim: [[key, count], ...]}}) into one fleet-wide view.
    Truncation past the top table is VISIBLE, never silent: each dim's
    truncated-row count rides the payload (`truncated`) and the gauge
    (merge_truncated_last) holds the latest merge's total."""
    global _merge_truncated
    out: dict = {"truncated": {}}
    total_truncated = 0
    for d in DIMS:
        merged: Dict[str, int] = {}
        nodes: Dict[str, int] = {}
        for e in top_table(d, 0):
            merged[e["key"]] = merged.get(e["key"], 0) + e["count"]
            nodes[e["key"]] = nodes.get(e["key"], 0) + 1
        for _nid, summ in peers.items():
            for key, count in (summ or {}).get(d, ()):
                merged[key] = merged.get(key, 0) + int(count)
                nodes[key] = nodes.get(key, 0) + 1
        rows = sorted(({"key": k, "count": c, "nodes": nodes[k]}
                       for k, c in merged.items()),
                      key=lambda r: r["count"], reverse=True)
        if len(rows) > n:
            out["truncated"][d] = len(rows) - n
            total_truncated += len(rows) - n
            rows = rows[:n]
        out[d] = rows
    _merge_truncated = total_truncated
    return out


def render_top(dim: str, rows: Optional[List[dict]] = None) -> List[str]:
    """The `top <dim>` command's text table."""
    if rows is None:
        rows = top_table(dim)
    out = [f"top {dim} (window {WINDOW_S:g}s x2, k={TOPK})"]
    if not rows:
        out.append("  (no traffic observed)")
        return out
    for i, e in enumerate(rows):
        err = f" err<={e['err']}" if e.get("err") else ""
        nodes = f" nodes={e['nodes']}" if "nodes" in e else ""
        rate = f" {e['rate']:.1f}/s" if "rate" in e else ""
        out.append(f"  #{i} {e['key']}  count={e['count']}"
                   f"{rate}{err}{nodes}")
    return out


def reset() -> None:
    """Test hook: drop every sketch (plane counters stay — process-
    lifetime totals like every other /metrics series)."""
    with _lock:
        _dims.clear()
        _slot_memo.clear()
