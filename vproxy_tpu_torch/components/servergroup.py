"""ServerGroup — weighted backends with health checks and 3 balancing
methods.

Semantics from the reference (svrgroup/ServerGroup.java): WRR with the
subtract-sum max-index sequence (:692-741) and a random start offset
(:721-737); WLC least-connection with the C(Sm)*W(Si) > C(Si)*W(Sm)
integer comparison (:527-560); `source` sdbm hash of the client address
with linear probe past unhealthy servers (:389-398, :479-490); v4/v6
filtered variants of each (nextIPv4/nextIPv6); health checks with up/down
edge thresholds (check/HealthCheckClient.java:100-137).

The port's copy of vproxy_tpu/components/servergroup.py, same names and behaviour.
"""
from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..net import vtl
from ..net.eventloop import SelectorEventLoop
from ..rules import maglev as _maglev
from ..rules.ir import HintRule
from ..utils import failpoint
from .elgroup import EventLoopGroup

# passive outlier ejection (report_failure): N consecutive data-plane
# connect failures eject the backend immediately — detection latency is
# one RTT instead of the health checker's interval*down (~seconds)
EJECT_FAILURES = int(os.environ.get("VPROXY_TPU_EJECT_FAILURES", "3"))
EJECT_BASE_S = float(os.environ.get("VPROXY_TPU_EJECT_BASE_S", "5"))
EJECT_CAP_S = float(os.environ.get("VPROXY_TPU_EJECT_CAP_S", "300"))

# proxy-local connect failures (fd/port/buffer exhaustion on OUR side):
# not evidence against the backend — they must not feed its ejection
# streak, or an overloaded proxy ejects its whole healthy pool
import errno as _errno
LOCAL_ERRNOS = frozenset({
    _errno.EMFILE, _errno.ENFILE, _errno.EADDRNOTAVAIL,
    _errno.EADDRINUSE, _errno.ENOBUFS, _errno.ENOMEM,
})


@dataclass
class HealthCheckConfig:
    """check/HealthCheckConfig + the hc annotations of AnnotatedHcConfig
    (ConnectClient.java:166-290): http checks GET a url and accept the
    configured status classes (default 1xx-4xx), dns checks resolve a
    domain against the backend as nameserver."""
    timeout_ms: int = 2000
    period_ms: int = 5000
    up: int = 2
    down: int = 3
    protocol: str = "tcp"  # none | tcp | tcpDelay | dns | http
    http_method: str = "GET"
    http_url: str = "/"
    http_host: Optional[str] = None
    http_status: tuple = (1, 2, 3, 4)  # accepted status/100 classes
    dns_domain: str = "example.com"


@dataclass(eq=False)  # identity eq/hash: handles live in exclude-sets
class ServerHandle:
    name: str
    ip: str
    port: int
    weight: int
    healthy: bool = False
    conn_count: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    logic_delete: bool = False
    host_name: Optional[str] = None
    check_cost_ms: float = -1.0  # tcpDelay: last successful connect cost
    _up_cnt: int = 0
    _down_cnt: int = 0
    # passive outlier-ejection state (ServerGroup.report_failure)
    _consec_fails: int = 0       # consecutive data-plane connect failures
    ejected: bool = False        # down via passive ejection (not hc edge)
    _eject_backoff_s: float = 0.0  # last applied backoff (doubles per eject)
    _eject_until: float = 0.0    # monotonic re-admission gate

    @property
    def is_v4(self) -> bool:
        return ":" not in self.ip


class _HealthChecker:
    """Periodic nonblocking connect on the group's event loop; edge-triggered
    up/down transitions after N consecutive successes/failures."""

    def __init__(self, loop: SelectorEventLoop, group: "ServerGroup",
                 svr: ServerHandle):
        self.loop = loop
        self.group = group
        self.svr = svr
        self.stopped = False
        self._periodic = None
        loop.run_on_loop(self._start)

    def _start(self) -> None:
        if self.stopped:
            return
        cfg = self.group.hc
        if cfg.protocol == "none":
            self._result(True)
            self._periodic = self.loop.period(cfg.period_ms, lambda: self._result(True))
            return
        self._periodic = self.loop.period(cfg.period_ms, self._check_once)
        self._check_once()

    def _check_once(self) -> None:
        if self.stopped:
            return
        if failpoint.hit("hc.force_down",
                         f"{self.group.alias}/{self.svr.name} "
                         f"{self.svr.ip}:{self.svr.port}"):
            self._result(False)
            return
        cfg = self.group.hc
        if cfg.protocol == "http":
            self._check_http(cfg)
        elif cfg.protocol == "dns":
            self._check_dns(cfg)
        else:
            self._check_tcp(cfg)

    def _check_tcp(self, cfg: HealthCheckConfig) -> None:
        import time as _time
        try:
            fd = vtl.tcp_connect(self.svr.ip, self.svr.port)
        except OSError:
            self._result(False)
            return
        state = {"done": False}
        t0 = _time.monotonic()

        def finish(ok: bool) -> None:
            if state["done"]:
                return
            state["done"] = True
            if self.loop.registered(fd):
                self.loop.remove(fd)
            vtl.close(fd)
            if ok and cfg.protocol == "tcpDelay":
                self.svr.check_cost_ms = (_time.monotonic() - t0) * 1000.0
            self._result(ok)

        def on_ev(_fd: int, ev: int) -> None:
            finish(vtl.finish_connect(fd) == 0)

        self.loop.add(fd, vtl.EV_WRITE, on_ev)
        self.loop.delay(cfg.timeout_ms, lambda: finish(False))

    def _check_http(self, cfg: HealthCheckConfig) -> None:
        """connect, send one request, parse the status line; up iff the
        status class is in cfg.http_status (ConnectClient.java:166-215)."""
        from ..net.connection import Connection, Handler

        state = {"done": False, "buf": b"", "conn": None}

        def finish(ok: bool) -> None:
            if state["done"]:
                return
            state["done"] = True
            if state["conn"] is not None:
                state["conn"].close()
            self._result(ok)

        host = cfg.http_host or self.svr.host_name or self.svr.ip

        class H(Handler):
            def on_connected(_s, conn) -> None:
                conn.write((f"{cfg.http_method} {cfg.http_url} HTTP/1.1\r\n"
                            f"Host: {host}\r\nConnection: close\r\n\r\n"
                            ).encode())

            def on_data(_s, conn, data) -> None:
                state["buf"] += data
                if b"\r\n" not in state["buf"]:
                    if len(state["buf"]) > 4096:
                        finish(False)
                    return
                line = state["buf"].split(b"\r\n", 1)[0].split()
                if len(line) < 2 or not line[0].startswith(b"HTTP/"):
                    finish(False)
                    return
                try:
                    status = int(line[1])
                except ValueError:
                    finish(False)
                    return
                finish(100 <= status < 600 and
                       status // 100 in cfg.http_status)

            def on_eof(_s, conn) -> None:
                finish(False)

            def on_closed(_s, conn, err) -> None:
                finish(False)

        def start() -> None:
            try:
                # failpoints=False: the probe must not consume the data
                # plane's count-armed backend.connect.* faults (probes
                # have their own site, hc.force_down)
                c = Connection.connect(self.loop, self.svr.ip,
                                       self.svr.port, failpoints=False)
            except OSError:
                finish(False)
                return
            state["conn"] = c
            c.set_handler(H())
            self.loop.delay(cfg.timeout_ms, lambda: finish(False))
        start()

    def _check_dns(self, cfg: HealthCheckConfig) -> None:
        """resolve cfg.dns_domain with the backend as the nameserver; up
        iff a well-formed answer comes back (ConnectClient.java:286-290)."""
        from ..dns import packet as P
        from ..dns.client import DNSClient

        state = {"done": False}
        client = DNSClient(self.loop, [(self.svr.ip, self.svr.port)],
                           timeout_ms=cfg.timeout_ms, max_retry=1)

        def cb(resp, err) -> None:
            if state["done"]:
                return
            state["done"] = True
            # cb runs inside the client's recvfrom loop: closing the fd
            # here would make that loop read a dead (or reused) fd
            self.loop.next_tick(client.close)
            self._result(err is None and resp is not None)

        client.query(cfg.dns_domain, P.A, cb)

    def _result(self, ok: bool) -> None:
        if self.stopped:
            return
        s = self.svr
        cfg = self.group.hc
        if ok:
            s._up_cnt += 1
            s._down_cnt = 0
            if not s.healthy and s._up_cnt >= cfg.up:
                if s.ejected:
                    # passively ejected: each passing active probe halves
                    # the remaining backoff; the healthy flip waits for
                    # the (shrinking) re-admission gate to expire
                    now = time.monotonic()
                    if now < s._eject_until:
                        s._eject_until = now + (s._eject_until - now) / 2.0
                        return
                    self.group._readmit(s)
                    return
                s.healthy = True
                # fresh UP edge starts a fresh ejection streak: stale
                # pre-downtime failures must not let one post-recovery
                # blip eject the server
                s._consec_fails = 0
                self.group._notify(s, True)
        else:
            s._down_cnt += 1
            s._up_cnt = 0
            if s.healthy and s._down_cnt >= cfg.down:
                s.healthy = False
                self.group._notify(s, False)
            elif not s.healthy and s._down_cnt == cfg.down:
                self.group._notify(s, False)

    def stop(self) -> None:
        self.stopped = True
        if self._periodic is not None:
            self.loop.run_on_loop(self._periodic.cancel)


class Connector:
    """How to reach a chosen backend (SvrHandleConnector analog)."""

    def __init__(self, svr: ServerHandle, group: "ServerGroup"):
        self.svr = svr
        self.group = group
        self.ip = svr.ip
        self.port = svr.port


class ServerGroup:
    METHODS = ("wrr", "wlc", "source")

    def __init__(self, alias: str, elg: EventLoopGroup,
                 hc: Optional[HealthCheckConfig] = None, method: str = "wrr",
                 annotations: Optional[HintRule] = None):
        if method not in self.METHODS:
            raise ValueError(f"unsupported method {method}")
        self.alias = alias
        self.elg = elg
        self.hc = hc or HealthCheckConfig()
        self.method = method
        self.annotations = annotations or HintRule()
        self.servers: list[ServerHandle] = []
        self._checkers: dict[str, _HealthChecker] = {}
        self._listeners: list[Callable[[ServerHandle, bool], None]] = []
        # generic change listeners: fired on EVERY health edge AND every
        # membership/weight recalc (the superset of on_health_change).
        # The accept lanes subscribe their generation bump here so any
        # mutation of the routable set invalidates the C lane entry.
        # Callbacks may run under the group lock (recalc paths) and must
        # not take group locks themselves — bump-and-defer only.
        self._change_listeners: list = []
        # bumped on every health edge and membership/weight recalc: a
        # cheap staleness token for answer caches (dns/server.py) that
        # must never serve a backend past its DOWN edge
        self.health_version = 0
        self._lock = threading.Lock()
        self._wrr_seq: list[int] = []
        self._wrr_servers: list[ServerHandle] = []
        self._wrr_cursor = 0
        self._wrr_cache: dict[str, tuple] = {}
        # maglev state for method=source (rules/maglev.py): table per
        # family over the HEALTHY member set, rebuilt lazily when the
        # health_version token moves — identity-keyed permutations mean
        # a membership/health edge moves only the affected backend's
        # slots, never reshuffles the group
        self._maglev_prev: dict = {}   # cache key -> (table, names)
        # flow_hash(ip) is pure in the address bytes, so the memo
        # survives rebuilds (slot = h % m is re-derived per pick); it
        # is what keeps the maglev pick at WRR cost on the accept path
        self._maglev_hash: dict = {}   # ip bytes -> flow_hash
        # one-slot (fam, hv, servers, tlist, m) view of _maglev_state:
        # the pick hot path allocates NOTHING reading it (a per-call
        # cache-key tuple doubles gen0 GC pressure vs the wrr path —
        # that was the measured p99 tail, not the lookup itself)
        self._maglev_fast: Optional[tuple] = None
        self.maglev_last_remap = 0.0   # last rebuild's churn fraction

    # ------------------------------------------------------------- admin

    def add(self, name: str, ip: str, port: int, weight: int = 10) -> ServerHandle:
        with self._lock:
            if any(s.name == name for s in self.servers):
                raise ValueError(f"server {name} already exists in {self.alias}")
            s = ServerHandle(name=name, ip=ip, port=port, weight=weight)
            self.servers.append(s)
            self._recalc()
            self._checkers[name] = _HealthChecker(self.elg.next(), self, s)
        return s

    def remove(self, name: str) -> None:
        removed = None
        with self._lock:
            for i, s in enumerate(self.servers):
                if s.name == name:
                    del self.servers[i]
                    self._recalc()
                    chk = self._checkers.pop(name, None)
                    if chk:
                        chk.stop()
                    removed = s
                    break
            else:
                raise KeyError(name)
        # removal IS a DOWN edge for listeners (outside the lock, like
        # every notify): a TcpLB's warm pools for the decommissioned
        # backend must drain now, not keep redialing its address forever
        self._notify(removed, False)

    def replace_ip(self, name: str, new_ip: str) -> None:
        """Swap a server's address in place (ServerGroup.replaceIp
        :811-950): health state resets and the checker re-targets; used
        by the address updater when a hostname re-resolves."""
        swapped = None
        with self._lock:
            for s in self.servers:
                if s.name == name:
                    if s.ip == new_ip:
                        return
                    s.ip = new_ip
                    was_healthy, s.healthy = s.healthy, False
                    s._up_cnt = s._down_cnt = 0
                    # a new address is a new failure domain: drop any
                    # passive-eject state along with the hc counters
                    s.ejected = False
                    s._consec_fails = 0
                    s._eject_backoff_s = s._eject_until = 0.0
                    self._recalc()
                    # swap the checker under the lock: racing remove()
                    # must not resurrect a checker for a gone server
                    chk = self._checkers.pop(name, None)
                    if chk:
                        chk.stop()
                    self._checkers[name] = _HealthChecker(
                        self.elg.next(), self, s)
                    swapped = s if was_healthy else None
                    break
            else:
                raise KeyError(name)
        # down transition notifies like every health-checker edge does —
        # outside the lock, listeners may re-enter the group
        if swapped is not None:
            self._notify(swapped, False)

    def set_weight(self, name: str, weight: int) -> None:
        with self._lock:
            for s in self.servers:
                if s.name == name:
                    s.weight = weight
                    self._recalc()
                    return
        raise KeyError(name)

    def on_change(self, cb: Callable[[], None]) -> None:
        self._change_listeners.append(cb)

    def off_change(self, cb: Callable[[], None]) -> None:
        try:
            self._change_listeners.remove(cb)
        except ValueError:
            pass

    def _fire_change(self) -> None:
        for cb in list(self._change_listeners):
            try:
                cb()
            except Exception:
                pass

    def on_health_change(self, cb: Callable[[ServerHandle, bool], None]) -> None:
        self._listeners.append(cb)

    def off_health_change(self, cb: Callable[[ServerHandle, bool], None]) -> None:
        """Unregister (idempotent): a stopped TcpLB's pool-drain listener
        must not keep firing — or keep the LB alive — forever."""
        try:
            self._listeners.remove(cb)
        except ValueError:
            pass

    def _notify(self, svr: ServerHandle, up: bool) -> None:
        from ..utils import events
        self.health_version += 1
        events.record("hc_up" if up else "hc_down",
                      f"{self.alias}/{svr.name} {svr.ip}:{svr.port} "
                      + ("UP" if up else "DOWN"),
                      group=self.alias, server=svr.name)
        for cb in self._listeners:
            cb(svr, up)
        self._fire_change()

    # ---------------------------------------- passive outlier ejection

    def report_failure(self, svr: ServerHandle, err: int = 0) -> None:
        """Data-plane connect failure/timeout against svr. N consecutive
        failures ejects it immediately — the same DOWN edge the health
        checker drives, but at one-RTT detection latency — with
        exponential backoff re-admission (base EJECT_BASE_S, doubling to
        EJECT_CAP_S; passing active probes halve the remaining wait).
        `err` (errno, when the caller has it) filters out proxy-local
        failures that say nothing about the backend."""
        if err in LOCAL_ERRNOS:
            return
        from ..utils import events
        eject = False
        with self._lock:
            svr._consec_fails += 1
            if svr._consec_fails >= EJECT_FAILURES and svr.healthy:
                # ejection floor: never empty the pool. With no other
                # healthy backend, a possibly-flaky server beats a
                # guaranteed full-group blackout (the hc still owns the
                # hard-down edge for genuinely dead backends).
                if not any(s.healthy and s.weight > 0 and s is not svr
                           for s in self.servers):
                    if svr._consec_fails == EJECT_FAILURES:
                        events.record(
                            "eject_skipped",
                            f"{self.alias}/{svr.name} over the failure "
                            "threshold but is the last healthy backend",
                            group=self.alias, server=svr.name)
                    return
                svr.healthy = False
                svr.ejected = True
                svr._up_cnt = svr._down_cnt = 0
                backoff = (EJECT_BASE_S if svr._eject_backoff_s <= 0
                           else min(svr._eject_backoff_s * 2, EJECT_CAP_S))
                svr._eject_backoff_s = backoff
                svr._eject_until = time.monotonic() + backoff
                eject = True
        if eject:
            self._eject_counter().incr()
            events.record(
                "eject", f"{self.alias}/{svr.name} {svr.ip}:{svr.port} "
                f"EJECTED after {svr._consec_fails} connect failures, "
                f"backoff {svr._eject_backoff_s:.0f}s",
                group=self.alias, server=svr.name,
                fails=svr._consec_fails, backoff_s=svr._eject_backoff_s)
            self._notify(svr, False)

    def report_success(self, svr: ServerHandle) -> None:
        """Data-plane connect success against svr: clears the consecutive
        failure streak and decays the eject backoff back to base so the
        next ejection doesn't inherit a stale doubled penalty."""
        with self._lock:
            svr._consec_fails = 0
            if not svr.ejected:
                svr._eject_backoff_s = 0.0

    def _readmit(self, svr: ServerHandle) -> None:
        """Re-admission edge (health checker, backoff expired + up
        threshold met): same UP notify path as an hc edge."""
        from ..utils import events
        with self._lock:
            if not svr.ejected:
                return
            svr.ejected = False
            svr.healthy = True
            svr._consec_fails = 0
            svr._eject_until = 0.0
        events.record(
            "readmit", f"{self.alias}/{svr.name} {svr.ip}:{svr.port} "
            "re-admitted after eject backoff",
            group=self.alias, server=svr.name)
        self._notify(svr, True)

    def _eject_counter(self):
        from ..utils.metrics import GlobalInspection
        return GlobalInspection.get().get_counter(
            "vproxy_group_ejections_total", group=self.alias)

    def close(self) -> None:
        for chk in self._checkers.values():
            chk.stop()
        self._checkers.clear()

    # --------------------------------------------------------- balancing

    def _recalc(self) -> None:
        self.health_version += 1  # membership/weight change
        self._wrr_cache.clear()
        self._fire_change()  # lane-entry invalidation (bump-and-defer)

    @staticmethod
    def _wrr_compute(servers: list[ServerHandle]) -> list[int]:
        """The reference's subtract-sum sequence: repeatedly pick max-weight
        index, subtract the total, re-add originals until all zero."""
        if not servers:
            return []
        weights = [s.weight for s in servers]
        original = list(weights)
        total = sum(weights)
        seq: list[int] = []
        while True:
            idx = max(range(len(weights)), key=lambda i: (weights[i], -i))
            seq.append(idx)
            weights[idx] -= total
            if all(w == 0 for w in weights):
                break
            for i in range(len(weights)):
                weights[i] += original[i]
            total = sum(weights)
        # random rotation so multiple identical instances don't sync
        start = random.randrange(len(seq))
        return seq[start:] + seq[:start]

    def _subset(self, fam: Optional[str]) -> list[ServerHandle]:
        out = [s for s in self.servers if s.weight > 0]
        if fam == "v4":
            out = [s for s in out if s.is_v4]
        elif fam == "v6":
            out = [s for s in out if not s.is_v4]
        return out

    def _wrr_state(self, fam: Optional[str]):
        key = fam or "all"
        st = self._wrr_cache.get(key)
        if st is None:
            servers = self._subset(fam)
            st = {"servers": servers, "seq": self._wrr_compute(servers),
                  "cursor": 0}
            self._wrr_cache[key] = st
        return st

    def next(self, source_ip: Optional[bytes] = None,
             fam: Optional[str] = None,
             exclude: Optional[set] = None) -> Optional[Connector]:
        """exclude: ServerHandles already tried this session (connect
        retry must not re-dial the backend that just refused)."""
        if self.method == "wlc":
            return self._wlc_next(fam, exclude)
        if self.method == "source":
            return self._source_next(source_ip or b"", fam, exclude)
        return self._wrr_next(fam, exclude)

    def _wrr_next(self, fam, exclude=None) -> Optional[Connector]:
        with self._lock:
            st = self._wrr_state(fam)
            seq, servers = st["seq"], st["servers"]
            for _ in range(len(seq) + 1):
                if not seq:
                    return None
                idx = st["cursor"] % len(seq)
                st["cursor"] = idx + 1
                s = servers[seq[idx]]
                if s.healthy and not (exclude and s in exclude):
                    return Connector(s, self)
            return None

    def _wlc_next(self, fam, exclude=None) -> Optional[Connector]:
        with self._lock:
            servers = [s for s in self._subset(fam)
                       if s.healthy and not (exclude and s in exclude)]
            if not servers:
                return None
            m = servers[0]
            for s in servers[1:]:
                if m.conn_count * s.weight > s.conn_count * m.weight:
                    m = s
            return Connector(m, self)

    @staticmethod
    def _sdbm(data: bytes) -> int:
        """The reference's sdbm source hash — kept for provenance; the
        source method now rides the Maglev table (_source_next), whose
        consistency bound sdbm%N lacks entirely (one membership change
        under sdbm remaps (N-1)/N of clients; Maglev moves only the
        changed backend's share)."""
        h = 0
        for b in data:
            sb = b - 256 if b > 127 else b  # signed byte like Java
            h = (sb + (h << 6) + (h << 16) - h) & 0xFFFFFFFF
        if h & 0x80000000:
            h = (~h + 1) & 0xFFFFFFFF  # abs in int32 space
            if h & 0x80000000:  # Integer.MIN_VALUE edge
                h = 0
        return h

    def maglev_identity(self, s: ServerHandle) -> str:
        """The backend's stable maglev identity: the SAME string the
        lane compiler hashes (components/lanes.py), so the C-plane pick
        and this python pick agree bit-for-bit at a given generation."""
        return f"{self.alias}|{s.ip}:{s.port}"

    def _maglev_state(self, fam) -> dict:
        """Per-family maglev table over the healthy, weighted, live
        members — rebuilt when health_version moves (a dead backend's
        slots fall to survivors; everyone else keeps their backend) and
        dropped wholesale by _recalc's cache clear on membership
        edits. Caller holds the group lock."""
        key = ("maglev", fam or "all")
        st = self._wrr_cache.get(key)
        if st is not None and st["hv"] == self.health_version:
            return st
        MG = _maglev
        servers = [s for s in self._subset(fam)
                   if s.healthy and not s.logic_delete]
        names = [self.maglev_identity(s) for s in servers]
        tab = MG.build_table(list(zip(names, (s.weight for s in servers))),
                             MG.GROUP_M)
        prev = self._maglev_prev.get(key)
        self.maglev_last_remap = MG.remap_fraction(
            prev[0] if prev else None, tab,
            prev[1] if prev else None, names)
        self._maglev_prev[key] = (tab, names)
        # tlist: plain-int list view of the table — numpy scalar indexing
        # is ~5x a list load and next_source is the accept hot path
        st = {"hv": self.health_version, "servers": servers, "table": tab,
              "tlist": tab.tolist()}
        self._wrr_cache[key] = st
        return st

    def maglev_info(self) -> dict:
        """Detail-surface view (list-detail tcp-lb / HTTP detail)."""
        if self.method != "source":
            return {"on": False}
        with self._lock:
            st = self._maglev_state(None)
        return {"on": True, "m": int(len(st["table"])),
                "backends": len(st["servers"]),
                "last_remap": round(self.maglev_last_remap, 4)}

    def maglev_table(self, fam=None):
        """(servers, table) snapshot for the current health generation
        — the lane compiler and the parity tests read this."""
        with self._lock:
            st = self._maglev_state(fam)
            return list(st["servers"]), st["table"]

    def _source_next(self, source_ip: bytes, fam,
                     exclude=None) -> Optional[Connector]:
        """Source affinity via the Maglev table: one FNV over the client
        address + one slot load (the table already holds only healthy
        members, so the probe loop only runs for retry excludes). A
        resize moves ~weight-share of clients instead of sdbm%N's
        near-total reshuffle; the same hash/table contract as the C
        accept lanes (tests/test_maglev.py parity)."""
        with self._lock:
            fast = self._maglev_fast
            if (fast is None or fast[0] != fam
                    or fast[1] != self.health_version):
                st = self._maglev_state(fam)
                fast = self._maglev_fast = (fam, st["hv"], st["servers"],
                                            st["tlist"], len(st["tlist"]))
            _fam, _hv, servers, tab, m = fast
            if not servers:
                return None
            hc = self._maglev_hash
            h = hc.get(source_ip)
            if h is None:
                if len(hc) >= 16384:  # bounded: clear beats LRU churn
                    hc.clear()
                h = hc[source_ip] = _maglev.flow_hash(source_ip)
            slot = h % m
            idx = tab[slot]
            if idx >= 0:  # the hot path: one hash + one slot load
                s = servers[idx]
                if s.healthy and not (exclude and s in exclude):
                    return Connector(s, self)
            # probe forward (retry excludes / a health edge racing the
            # rebuild): next slots' owners, dedup'd, bounded
            tried = {idx} if idx >= 0 else set()
            for k in range(1, m):
                idx = tab[(slot + k) % m]
                if idx < 0 or idx in tried:
                    continue
                s = servers[idx]
                if s.healthy and not (exclude and s in exclude):
                    return Connector(s, self)
                tried.add(idx)
                if len(tried) >= len(servers):
                    return None
            return None
