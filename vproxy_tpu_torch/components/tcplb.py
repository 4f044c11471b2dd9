"""TcpLB — the TCP/HTTP load balancer resource.

Reference: component/app/TcpLB.java — per-acceptor-loop server socks
(:201-250), per-connection classify = securityGroup.allow then
backend.next(clientAddr, hint) (:166-180), worker round-robin (:182-199).

TPU-first data path: accept and classification decisions run in Python
(ACL + hint through the device matchers). protocol="tcp" splices
immediately through the native pump (C++, net/native/vtl.cpp) and never
touches the interpreter again; protocol="http-splice" parses only the
first request head for a Host/URI hint before dropping into the same
pump; any other protocol name resolves through the processor registry
(processors/base.py — http/http1/h2/dubbo/framed-int32) and runs the
full per-request/per-stream L7 engine (components/l7.py).

The port's copy of vproxy_tpu/components/tcplb.py, same names and behaviour.
"""
from __future__ import annotations

import errno
import os
import threading
import time
from typing import Optional

from ..net import vtl
from ..net.connection import Connection, Handler, ServerSock
from ..policing import engine as policing
from ..processors import base as processors
from ..processors.http1 import HeadParser
from ..rules.ir import Proto
from ..utils import events, failpoint, sketch, trace, workload
from ..utils.ip import parse_ip
from ..utils.log import Logger
from ..utils.metrics import accept_stage_observe, conn_observe
from .elgroup import EventLoopGroup
from .l7 import L7Engine
from .lanes import LANES, AcceptLanes
from .pool import ConnectionPool, PoolHandler
from .secgroup import SecurityGroup
from .servergroup import Connector
from .upstream import Upstream

_log = Logger("tcp-lb")

# failure-containment knobs (docs/robustness.md)
CONNECT_RETRIES = int(os.environ.get("VPROXY_TPU_CONNECT_RETRIES", "2"))
RETRY_BUDGET_RATIO = float(os.environ.get("VPROXY_TPU_RETRY_BUDGET", "0.2"))
MAX_SESSIONS = int(os.environ.get("VPROXY_TPU_MAX_SESSIONS", "1000000"))
CONNECT_TIMEOUT_MS = int(os.environ.get("VPROXY_TPU_CONNECT_TIMEOUT_MS",
                                        "3000"))
# slowloris defense (docs/robustness.md): every pre-handover phase a
# client can stall — the TLS ClientHello peek, the http-splice head
# parse — is bounded by this deadline instead of the (minutes-long)
# idle timeout, so a half-open flood cannot pin fds/parser state for
# timeout_ms per connection. Expired sessions are RST-killed and
# counted vproxy_lb_shed_total{reason=halfopen}. 0 disables (the
# idle timeout governs, as before the deadline existed).
HANDSHAKE_MS = int(os.environ.get("VPROXY_TPU_HANDSHAKE_MS", "10000"))
# accept-fast-lane knobs (docs/perf.md): pre-connected idle sockets per
# (worker loop, backend) so short connections skip the backend-connect
# round trip entirely. 0 = off (the default: pooling assumes the backend
# tolerates idle warm connections).
POOL_SIZE = int(os.environ.get("VPROXY_TPU_POOL_SIZE", "0"))
POOL_IDLE_S = float(os.environ.get("VPROXY_TPU_POOL_IDLE_S", "30"))
# sockets warmed within this window skip the MSG_PEEK liveness check at
# handover (a socket this young is as trustworthy as a fresh connect;
# RSTs are reaped by EV_ERROR, clean FINs by the peek once it ages past
# the window, and the residual race by the handover-failure fallback)
POOL_VALIDATE_S = float(os.environ.get("VPROXY_TPU_POOL_VALIDATE_S", "1"))


def _tspan(tid: int, span: str, t0: float, t1: float, **fields) -> None:
    """Accept-plane span helper: time.monotonic() floats -> ns (same
    CLOCK_MONOTONIC the C lane spans stamp). One branch when the
    request is unsampled."""
    if tid:
        trace.record_span(tid, "accept", span, int(t0 * 1e9),
                          int((t1 - t0) * 1e9), **fields)


class RetryBudget:
    """Sliding-window retry budget: retries ≤ ratio × accepts (+ a small
    burst floor so a quiet LB's first failure can still fail over). A
    dead cluster must not double its own connect load via retries, so
    the budget is enforced per LB over a two-bucket rolling window."""

    __slots__ = ("ratio", "burst", "window_s", "_lock",
                 "_t0", "_accepts", "_retries", "_p_accepts", "_p_retries")

    def __init__(self, ratio: float = RETRY_BUDGET_RATIO, burst: int = 5,
                 window_s: float = 10.0):
        self.ratio = ratio
        self.burst = burst
        self.window_s = window_s
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._accepts = 0
        self._retries = 0
        self._p_accepts = 0  # previous bucket (smooths the window edge)
        self._p_retries = 0

    def _roll(self, now: float) -> None:
        age = now - self._t0
        if age < self.window_s:
            return
        if age < 2 * self.window_s:
            self._p_accepts, self._p_retries = self._accepts, self._retries
        else:
            self._p_accepts = self._p_retries = 0
        self._accepts = self._retries = 0
        self._t0 = now

    def on_accept(self) -> None:
        with self._lock:
            self._roll(time.monotonic())
            self._accepts += 1

    def on_accepts(self, n: int) -> None:
        """Bulk credit — the C accept lanes sync their accepted counter
        in batches (per lane-poll tick): lane traffic must fund the
        budget its own connect-fail punts spend."""
        if n <= 0:
            return
        with self._lock:
            self._roll(time.monotonic())
            self._accepts += n

    def try_take(self) -> bool:
        """Reserve one retry; False when the budget is exhausted."""
        with self._lock:
            self._roll(time.monotonic())
            accepts = self._accepts + self._p_accepts
            retries = self._retries + self._p_retries
            if retries + 1 > self.ratio * accepts + self.burst:
                return False
            self._retries += 1
            return True


class _LBPoolHandler(PoolHandler):
    """How TcpLB's warm pool dials one backend: a plain data-plane
    connect (failpoint-gated like any other, bounded by the LB's connect
    timeout). No keepalive traffic — protocol=tcp can't speak for the
    backend's protocol — so staleness is bounded by idle expiry plus the
    MSG_PEEK validation at handover. Refill successes report_success:
    a pool fill is a real connect, and pooled traffic must keep clearing
    the backend's passive-ejection streak the way classic connects do."""

    __slots__ = ("svr", "group", "ip", "port", "timeout_ms")

    def __init__(self, target: Connector, timeout_ms: int):
        self.svr = target.svr
        self.group = target.group
        self.ip = target.ip
        self.port = target.port
        self.timeout_ms = timeout_ms

    def connect(self, loop) -> Connection:
        return Connection.connect(loop, self.ip, self.port,
                                  timeout_ms=self.timeout_ms)

    def on_warm(self, conn: Connection) -> None:
        self.group.report_success(self.svr)


class _SpliceBack(Handler):
    """Backend-connect handler for the splice path — ONE shared class
    (defining it per accept showed up as __build_class__ on the
    short-connection profile)."""

    __slots__ = ("lb", "loop", "front_fd", "target", "head", "front",
                 "_pid", "tls_ctx", "t_acc", "t_back", "connected",
                 "src_ip", "tried", "hint", "pooled", "tid", "t_hand")

    def __init__(self, lb, loop, front_fd: int, target: Connector,
                 head: bytes, front: str, tls_ctx: int = 0,
                 t_acc: Optional[float] = None, src_ip: bytes = b"",
                 tried: Optional[set] = None, hint=None,
                 pooled: bool = False, tid: int = 0):
        self.lb = lb
        self.loop = loop
        self.front_fd = front_fd
        self.target = target
        self.head = head
        self.front = front
        self._pid = None
        self.tls_ctx = tls_ctx  # nonzero: TLS-terminating pump
        self.t_acc = t_acc         # accept timestamp (span timers)
        self.t_back = time.monotonic()  # backend chosen -> handover span
        self.connected = False     # flips in on_connected: phase evidence
        self.src_ip = src_ip       # client addr bytes (retry re-balance)
        self.tried = tried if tried is not None else set()
        self.hint = hint           # classify hint: retries re-run the
                                   # original selection, not plain WRR
        self.pooled = pooled       # adopted a warmed pool connection
        self.tid = tid             # trace id (0 = unsampled request)
        self.t_hand = 0.0          # handover stamp (splice span start)

    def on_connected(self, conn: Connection) -> None:
        self.connected = True
        self.target.group.report_success(self.target.svr)
        if self.tried:  # a retry attempt landed
            self.lb._retries_total("success").incr()
        # do NOT consume early backend bytes (100-continue, early
        # errors): leave them queued in the kernel for the pump
        conn.pause_reading()
        if self.head:
            conn.write(self.head)
        if conn.out:
            # wait for drain before pump handover
            return
        self._handover(conn)

    def on_drained(self, conn: Connection) -> None:
        self._handover(conn)

    def _handover(self, conn: Connection) -> None:
        if conn.detached or conn.closed:
            return
        if self.pooled and self.tried:
            # the retried session is now truly served (classic connects
            # count this edge in on_connected; pooled ones count here)
            self.lb._retries_total("success").incr()
        bfd = conn.detach()
        if not vtl.pump_sets_nodelay():
            # an older prebuilt .so: its pump setup lacks pump_set_nodelay,
            # so the explicit calls stay (newer ones do it in C — two fewer
            # ctypes crossings per session)
            vtl.set_nodelay(self.front_fd)
            vtl.set_nodelay(bfd)
        if self.tls_ctx:
            pid = self.loop.pump_tls(self.front_fd, bfd, self.tls_ctx,
                                     self.lb.in_buffer_size, self._done)
        else:
            pid = self.loop.pump(self.front_fd, bfd,
                                 self.lb.in_buffer_size, self._done)
        self._pid = pid
        now = time.monotonic()
        self.lb._watch_pump(
            self.loop, pid,
            f"{self.front} -> {self.target.ip}:{self.target.port}")
        # span observations AFTER the watch registration: the native pump
        # moves bytes without the GIL, so a session-listing racing these
        # (lock-taking) calls must already see the pump as spliced
        accept_stage_observe("handover", now - self.t_back)
        self.t_hand = now
        _tspan(self.tid, "connect", self.t_back, now,
               backend=f"{self.target.ip}:{self.target.port}",
               pooled=self.pooled)
        if self.t_acc is not None:
            accept_stage_observe("total", now - self.t_acc)
            self.lb._observe_accept(now - self.t_acc)

    def _done(self, a2b: int, b2a: int, err: int) -> None:
        lb, svr = self.lb, self.target.svr
        lb._unwatch_pump(self.loop, self._pid)
        lb.bytes_in += a2b
        lb.bytes_out += b2a
        svr.bytes_in += a2b
        svr.bytes_out += b2a
        svr.conn_count -= 1
        lb._sessions_delta(-1)
        # workload capture: the python splice path's per-connection
        # size/duration (lane-served sessions fold in from C deltas)
        if workload.ON:
            t0 = self.t_acc if self.t_acc is not None else self.t_hand
            dur_ms = (time.monotonic() - t0) * 1e3 if t0 else 0.0
            conn_observe(lb.alias, a2b + b2a, dur_ms)
        if self.tid:
            now = time.monotonic()
            _tspan(self.tid, "splice", self.t_hand or now, now,
                   bytes=a2b + b2a)
            _tspan(self.tid, "close", now, now, err=err)
        events.record(
            "conn", f"{self.front} -> {self.target.ip}:{self.target.port} "
            "closed", lb=lb.alias, bytes_in=a2b, bytes_out=b2a, err=err,
            trace_id=self.tid)

    def on_closed(self, conn: Connection, err: int) -> None:
        self.target.svr.conn_count -= 1
        errno_ = -err if err < 0 else err  # close(-err) carries the errno
        if not self.connected:
            # backend refused/unreachable pre-handshake: the retry layer
            # owns the front fd from here (closes it if no retry starts).
            # This attempt's session count is released AFTER the retry
            # decision so a mid-retry drain_wait never sees a false zero.
            self.lb._backend_connect_failed(
                self.loop, self.front_fd, self.target, self.head,
                self.front, self.t_acc, self.src_ip, self.tls_ctx,
                self.tried, errno_, hint=self.hint, tid=self.tid)
            self.lb._sessions_delta(-1)
            return
        if self.pooled and self._pid is None:
            # a warmed connection died between validation and pump
            # handover: counts as a connect failure (ejection streak) and
            # falls back to a fresh connect under the retry budget
            self.lb._pooled_handover_failed(
                self.loop, self.front_fd, self.target, self.head,
                self.front, self.t_acc, self.src_ip, self.tls_ctx,
                self.tried, errno_, hint=self.hint, tid=self.tid)
            self.lb._sessions_delta(-1)
            return
        self.lb._sessions_delta(-1)
        # the backend connected and then died before pump handover — a
        # different failure domain than a refused connect, and the event
        # must say so (it used to claim "backend connect failed" here)
        vtl.close(self.front_fd)
        events.record(
            "conn", f"{self.front} -> {self.target.ip}:{self.target.port} "
            "backend closed before handover", lb=self.lb.alias, err=errno_,
            phase="pre_handover_close")


class TcpLB:
    def __init__(self, alias: str, acceptor: EventLoopGroup,
                 worker: EventLoopGroup, bind_ip: str, bind_port: int,
                 backend: Upstream, protocol: str = "tcp",
                 security_group: Optional[SecurityGroup] = None,
                 in_buffer_size: int = 65536, timeout_ms: int = 900_000,
                 cert_keys: Optional[list] = None,
                 max_sessions: int = 0, pool_size: int = -1,
                 lanes: int = -1, overload: str = ""):
        if protocol not in ("tcp", "http-splice") \
                and processors.get(protocol) is None:
            raise ValueError(f"unsupported protocol {protocol}")
        self.holder = None
        self.cert_keys = cert_keys or []
        self.protocol = protocol
        if cert_keys:
            self.set_cert_keys(cert_keys)
        self.alias = alias
        self.acceptor = acceptor
        self.worker = worker
        self.bind_ip = bind_ip
        self.bind_port = bind_port
        self.backend = backend
        self.security_group = security_group or SecurityGroup.allow_all()
        self.in_buffer_size = in_buffer_size
        self.timeout_ms = timeout_ms
        self.server_socks: list[ServerSock] = []
        self.started = False
        # failure containment: bounded connect retries under a per-LB
        # budget, accept shedding past max_sessions, graceful drain
        self.max_sessions = max_sessions if max_sessions > 0 else MAX_SESSIONS
        self.connect_retries = CONNECT_RETRIES
        self.connect_timeout_ms = CONNECT_TIMEOUT_MS
        self.draining = False
        # overload mode (docs/robustness.md): static = the first, fixed
        # ceiling; adaptive attaches the AIMD controller
        # (components/overload.py) moving an effective ceiling on loop
        # stall + accept latency, shedding with RST in both planes
        from .overload import MODE, AdaptiveOverload
        mode = overload or MODE
        if mode not in ("static", "adaptive"):
            raise ValueError(f"overload mode {mode!r}: "
                             "expected 'static' or 'adaptive'")
        self.overload_mode = mode
        self._overguard: Optional[AdaptiveOverload] = (
            AdaptiveOverload(self) if mode == "adaptive" else None)
        # sessions mutate from every worker loop and the counter now
        # gates behavior (overload shed, drain completion): the +=/-=
        # must not lose updates to GIL interleaving
        self._sess_lock = threading.Lock()
        self._retry_budget = RetryBudget()
        self._retry_ctrs: dict[str, object] = {}
        self._overload_ctr = None
        self._shed_ctrs: dict[str, object] = {}
        # warm backend pool (accept fast lane): per-(worker loop, backend)
        # pre-connected idle sockets, lazily spawned on first use,
        # drained on backend DOWN edges (hc or passive ejection)
        self.pool_size = POOL_SIZE if pool_size < 0 else pool_size
        # C accept lanes (docs/perf.md): when eligible, N native lane
        # threads own every listener and run short connections without
        # touching Python; self.lanes is the AcceptLanes manager or None
        self.lanes_n = LANES if lanes < 0 else lanes
        self.lanes: Optional[AcceptLanes] = None
        self._pools: dict[tuple, ConnectionPool] = {}
        self._pool_lock = threading.Lock()
        self._pool_groups: set = set()   # groups with our health listener
        self._pool_ctrs: dict[str, object] = {}
        # stats (cmd/ResourceType accepted-conn-count / bytes-in / bytes-out)
        self.accepted = 0
        self.active_sessions = 0
        self.bytes_in = 0
        self.bytes_out = 0
        # id(loop) -> {pid: (total, ts, desc)}; loops kept by id so the
        # session listing can marshal stat reads onto the OWNING loop
        self._pump_watch: dict[int, dict] = {}
        self._watch_loops: dict[int, object] = {}
        self._sweep_armed: set[int] = set()
        self._sweep_timers: dict[int, object] = {}  # id(loop) -> TimerEvent

    # ------------------------------------------------------------ control

    def on_loop_death(self, group, lp) -> None:
        """LBAttach semantics (TcpLB.java:45-66): an acceptor loop died —
        forget its listener (the dying loop already closed the fd) and
        bind a replacement on a surviving loop so capacity recovers."""
        if group is not self.acceptor or not self.started or self.draining:
            return
        dead = [ss for ss in self.server_socks if ss.loop is lp]
        if not dead:
            return
        self.server_socks = [ss for ss in self.server_socks
                             if ss.loop is not lp]
        if not group.loops:
            return  # nowhere to re-home; stop() semantics apply
        try:
            nlp = group.next()

            def mk() -> None:
                if not self.started:  # raced a concurrent stop()
                    return
                self.server_socks.append(ServerSock(
                    nlp, self.bind_ip, self.bind_port,
                    lambda fd, ip, port, lp=nlp: self._on_accept(
                        lp, fd, ip, port),
                    reuseport=True))
            nlp.call_sync(mk)
            if not self.started:  # stop() raced the re-home: undo
                for ss in self.server_socks:
                    ss.loop.run_on_loop(ss.close)
                self.server_socks = []
        except OSError as e:
            _log.alert(f"tcp-lb {self.alias}: re-home bind failed: {e!r}")

    # subclasses that wrap the byte stream in their own handshake
    # (Socks5Server passes protocol="tcp" but speaks RFC 1928 first)
    # MUST NOT let the C lanes raw-splice their clients
    lanes_capable = True

    def _lanes_eligible(self) -> bool:
        return (self.lanes_capable and self.lanes_n > 0
                and self.protocol == "tcp"
                and self.holder is None and vtl.lanes_supported()
                and bool(self.worker.loops))

    def start(self) -> None:
        if self.started:
            return
        self.started = True
        self.acceptor.attach(self)
        # C accept lanes: when eligible they own ALL the listeners (the
        # whole point is the accept edge never entering Python); punts
        # reach the classic path through the lane threads, so no python
        # listener is needed. Bind failure falls back to python accepts.
        if self._lanes_eligible():
            try:
                lanes = AcceptLanes(self, self.lanes_n)
                lanes.start()  # resolves bind_port when 0
                self.lanes = lanes
                if self._overguard is not None:
                    self._overguard.start()  # also flips C RST shed on
                return
            except OSError as e:
                _log.warn(f"tcp-lb {self.alias}: accept lanes failed "
                          f"({e}); falling back to python accepts")
        loops = self.acceptor.loops
        # bind loops one at a time so an ephemeral port (bind_port=0) is
        # resolved once and the remaining loops share it via REUSEPORT
        try:
            for lp in loops:
                def mk(lp=lp) -> None:
                    ss = ServerSock(
                        lp, self.bind_ip, self.bind_port,
                        lambda fd, ip, port, lp=lp: self._on_accept(lp, fd, ip, port),
                        reuseport=len(loops) > 1)
                    self.server_socks.append(ss)
                    if self.bind_port == 0:
                        self.bind_port = ss.port
                lp.call_sync(mk)
        except OSError as e:
            self.stop()
            self.started = False
            raise OSError(
                f"tcp-lb {self.alias}: bind failed on "
                f"{self.bind_ip}:{self.bind_port}: {e}") from e
        if self._overguard is not None:
            self._overguard.start()

    def stop(self) -> None:
        if not self.started:
            return
        self.started = False
        if self._overguard is not None:
            self._overguard.stop()
        self.acceptor.detach(self)
        if self.lanes is not None:
            self.lanes.shutdown()
            self.lanes = None
        for ss in self.server_socks:
            ss.loop.run_on_loop(ss.close)
        self.server_socks = []
        self._drain_pools()
        with self._pool_lock:
            groups, self._pool_groups = self._pool_groups, set()
        for g in groups:
            g.off_health_change(self._on_pool_backend_health)

    def begin_drain(self) -> None:
        """Graceful drain: close the listeners so no new connections
        arrive (upstream LBs see RSTs / healthz says draining and steer
        away) while live pumps run to completion. Raced-in accepts are
        shed in _on_accept. Idempotent; stop() still tears down fully."""
        if self.draining:
            return
        self.draining = True
        events.record("drain",
                      f"lb {self.alias} draining: listeners closing, "
                      f"{self.active_sessions} sessions in flight",
                      lb=self.alias, sessions=self.active_sessions)
        if self.started:
            if self.lanes is not None:
                # lanes stop accepting; live lane pumps run to completion
                self.lanes.close_listeners()
            for ss in self.server_socks:
                ss.loop.run_on_loop(ss.close)
            self.server_socks = []
        # warm sockets are not in-flight work: release them immediately
        # (the drain contract only protects established client sessions)
        self._drain_pools()

    # ------------------------------------------------- failure containment

    def _sessions_delta(self, d: int) -> None:
        with self._sess_lock:
            self.active_sessions += d
        self._push_lane_limit()

    def effective_max_sessions(self) -> int:
        """The live admission ceiling: max_sessions in static mode, the
        adaptive controller's current ceiling otherwise."""
        g = self._overguard
        return g.ceiling if g is not None else self.max_sessions

    def _push_lane_limit(self) -> None:
        """Forward the remaining session budget to the C lanes: the
        ceiling (static OR the adaptive controller's moving one) is
        SHARED across both admission planes — the C side admits only
        the remainder, so python-held sessions (punts) can never stack
        a second ceiling on top of the lane ones."""
        lanes = self.lanes
        if lanes is not None:
            lanes.set_limit(max(0, self.effective_max_sessions()
                                - self.active_sessions))

    def _retries_total(self, result: str):
        c = self._retry_ctrs.get(result)
        if c is None:
            from ..utils.metrics import GlobalInspection
            c = self._retry_ctrs[result] = GlobalInspection.get().get_counter(
                "vproxy_lb_retries_total", lb=self.alias, result=result)
        return c

    def _overload_total(self):
        if self._overload_ctr is None:
            from ..utils.metrics import GlobalInspection
            self._overload_ctr = GlobalInspection.get().get_counter(
                "vproxy_lb_overload_total", lb=self.alias)
        return self._overload_ctr

    def _shed_total(self, reason: str):
        """vproxy_lb_shed_total{lb,reason} — reason ∈ {static, adaptive,
        halfopen, policed}: what WAS silent (which guard refused, and
        whether the slowloris deadline fired) is now countable per
        cause."""
        c = self._shed_ctrs.get(reason)
        if c is None:
            from ..utils.metrics import GlobalInspection
            c = self._shed_ctrs[reason] = GlobalInspection.get().get_counter(
                "vproxy_lb_shed_total", lb=self.alias, reason=reason)
        return c

    def _policed_shed(self, n: int = 1) -> None:
        """Policed refusals (python mirror verdicts + lane-0's C shed
        fold). The per-action attribution lives in
        vproxy_lb_policed_total (the engine accounts it); HERE the
        legacy families move too: a policed shed is still a shed,
        and the older dashboards alerting on
        vproxy_lb_shed_total / vproxy_lb_overload_total must see it."""
        self._shed_total("policed").incr(n)
        self._overload_total().incr(n)

    def _observe_accept(self, seconds: float) -> None:
        g = self._overguard
        if g is not None:
            g.observe_accept(seconds)

    def _handshake_ms(self) -> int:
        """Pre-handover phase deadline: the module-level HANDSHAKE_MS
        (read per call so tests/ops can retune), never beyond the idle
        timeout; 0 disables (falls back to timeout_ms)."""
        hs = HANDSHAKE_MS
        return min(self.timeout_ms, hs) if hs > 0 else self.timeout_ms

    def _halfopen_count(self, desc: str) -> None:
        """One half-open release: the shed accounting shared by every
        pre-handover deadline path (TLS hello peek, http head parse) —
        one site, so the metric semantics cannot fork between them."""
        self._overload_total().incr()
        self._shed_total("halfopen").incr()
        events.record("halfopen_shed", desc, lb=self.alias)

    def _halfopen_kill(self, conn) -> None:
        """A pre-handover phase blew the handshake deadline: RST the
        client (no TIME_WAIT for flood sheds) and count it."""
        vtl.set_linger0(conn.fd)
        # count BEFORE close: the RST is the client-visible edge, so
        # the shed must already be on the counters when it lands
        self._halfopen_count(f"{conn.remote[0]}:{conn.remote[1]} shed: "
                             "handshake deadline")
        conn.close(errno.ETIMEDOUT)

    # ------------------------------------------------- warm backend pool

    def _pool_total(self, result: str):
        c = self._pool_ctrs.get(result)
        if c is None:
            from ..utils.metrics import GlobalInspection
            c = self._pool_ctrs[result] = GlobalInspection.get().get_counter(
                "vproxy_lb_pool_total", lb=self.alias, result=result)
        return c

    def set_pool_size(self, n: int) -> None:
        """Hot-set the per-(loop, backend) warm-pool capacity (0 = off).
        Existing pools are drained and lazily respawn at the new size on
        the next accept that wants one."""
        self.pool_size = max(0, n)
        self._drain_pools()

    def _drain_pools(self, svr=None) -> None:
        """Close (and forget) pools — all of them, or one backend's
        (DOWN edge / pooled-handover failure: its parked sockets are
        presumed dead and must not be handed to more clients)."""
        with self._pool_lock:
            if svr is None:
                doomed = list(self._pools.values())
                self._pools = {}
            else:
                doomed = [p for k, p in self._pools.items() if k[1] is svr]
                self._pools = {k: p for k, p in self._pools.items()
                               if k[1] is not svr}
        for p in doomed:
            p.close()

    def _on_pool_backend_health(self, svr, up: bool) -> None:
        # ejection and hc-down take the same edge (ServerGroup._notify):
        # either way the backend's warm sockets are no longer trustworthy
        if not up:
            self._drain_pools(svr)

    def _pool_for(self, loop, target: Connector) -> Optional[ConnectionPool]:
        if self.pool_size <= 0 or self.draining or not self.started:
            return None
        key = (id(loop), target.svr)
        pool = self._pools.get(key)
        if pool is None:
            if not target.svr.healthy:
                # a selection that raced the DOWN edge must not respawn
                # a pool the edge just drained — no new DOWN will arrive
                # to drain it while the backend stays down
                return None
            with self._pool_lock:
                # re-check EVERYTHING under the lock: an accept racing
                # stop()/begin_drain()/hot-set-0/the DOWN edge must not
                # recreate a pool (and re-register the health listener)
                # after the drain
                if (self.pool_size <= 0 or self.draining
                        or not self.started or not target.svr.healthy):
                    return None
                pool = self._pools.get(key)
                if pool is None:
                    # keepalive tick doubles as the idle-expiry sweep, so
                    # it must run a few times per expiry window
                    ka_ms = max(250, min(int(POOL_IDLE_S * 250), 15000))
                    pool = self._pools[key] = ConnectionPool(
                        loop, _LBPoolHandler(target,
                                             self.connect_timeout_ms),
                        self.pool_size, keepalive_ms=ka_ms,
                        park_reads=True,
                        idle_expire_ms=int(POOL_IDLE_S * 1000))
                if target.group not in self._pool_groups:
                    self._pool_groups.add(target.group)
                    target.group.on_health_change(
                        self._on_pool_backend_health)
        return pool

    def _pool_take(self, loop, target: Connector) -> Optional[Connection]:
        """One validated warm connection, or None (pool off/empty). Must
        run on the owning loop thread (it does: every _splice caller is
        loop-confined)."""
        pool = self._pool_for(loop, target)
        if pool is None:
            return None
        while True:
            conn = pool.get()
            if conn is None:
                self._pool_total("miss").incr()
                return None
            if self._pool_validate(conn):
                self._pool_total("hit").incr()
                return conn
            self._pool_total("stale").incr()
            conn.close()

    @staticmethod
    def _pool_validate(conn: Connection) -> bool:
        """Parked sockets don't watch for EOF (reads are off so early
        backend bytes survive for the pump) — so check liveness HERE,
        with a MSG_PEEK: b'' means the peer already closed. Queued bytes
        (server-first banner) are fine; they stay queued. Sockets still
        inside the POOL_VALIDATE_S warm window skip the peek syscall."""
        if conn.closed or conn.detached or conn.eof_seen:
            return False
        if (time.monotonic() - getattr(conn, "_pooled_at", 0.0)
                < POOL_VALIDATE_S):
            return True
        if vtl.PROVIDER != "native":
            # pure-python provider has no MSG_PEEK surface (recv_peek is
            # native-only, like the SNI sniffer's gate): rely on the
            # closed/eof checks above + the handover-failure fallback
            return True
        try:
            data = vtl.recv_peek(conn.fd, 1)
        except OSError:
            return False
        return data != b""  # None (nothing queued, alive) or bytes: ok

    def _take_retry_slot(self, tried: set, what: str, pick):
        """THE retry gate, shared by the splice/TLS path, Socks5 and the
        L7 engine: attempt cap -> budget -> re-selection via `pick()`
        (a callable returning Connector | None — callers bind their own
        selection semantics, e.g. hint-seek vs WRR). Returns the next
        Connector or None; every outcome lands in
        vproxy_lb_retries_total{result=} and the flight recorder.
        Retries stay allowed while draining: an accepted connection IS
        in-flight work the drain contract protects."""
        if not self.started:
            return None
        if len(tried) > self.connect_retries:
            self._retries_total("exhausted").incr()
            events.record("retry",
                          f"{what}: retries exhausted after "
                          f"{len(tried)} attempts",
                          lb=self.alias, result="exhausted")
            return None
        target = pick()
        if target is None:
            # selection BEFORE the budget take: a no-alternative outcome
            # generates zero connect load and must not burn the budget
            # other sessions need for real retries
            self._retries_total("no_backend").incr()
            events.record("retry", f"{what}: no alternative backend",
                          lb=self.alias, result="no_backend")
            return None
        if not self._retry_budget.try_take():
            self._retries_total("budget_exhausted").incr()
            events.record("retry", f"{what}: retry budget exhausted",
                          lb=self.alias, result="budget_exhausted")
            return None
        events.record("retry",
                      f"{what} retry {len(tried)} -> "
                      f"{target.ip}:{target.port}",
                      lb=self.alias, attempt=len(tried))
        return target

    def _backend_connect_failed(self, loop, front_fd: int, target: Connector,
                                head: bytes, front: str,
                                t_acc: Optional[float], src_ip: bytes,
                                tls_ctx: int, tried: set, err: int,
                                hint=None, tid: int = 0) -> None:
        """A pre-handover backend connect failed (sync raise or async
        finish_connect error). Owns front_fd: either a retry attempt
        takes it over or it is closed here. Session counters for the
        failed attempt are already released by the caller. The retry
        re-runs the ORIGINAL selection semantics (hint group first, then
        the same WRR fallback the initial classify uses when the hint
        group is empty) minus the tried set — a retry is never MORE
        willing to leave the hint group than the first pick was."""
        svr = target.svr
        tried.add(svr)
        if tid:
            now = time.monotonic()
            _tspan(tid, "connect_failed", now, now,
                   backend=f"{target.ip}:{target.port}", err=err,
                   attempt=len(tried))
        events.record(
            "conn", f"{front} -> {target.ip}:{target.port} connect failed",
            lb=self.alias, err=err, phase="connect_failed",
            attempt=len(tried), trace_id=tid)
        target.group.report_failure(svr, err)
        nxt = self._take_retry_slot(
            tried, front,
            lambda: self.backend.next_host(src_ip, hint, exclude=tried))
        if nxt is None:
            vtl.close(front_fd)
            return
        self._splice(loop, front_fd, nxt, head, front, t_acc,
                     src_ip=src_ip, tls_ctx=tls_ctx, tried=tried, hint=hint,
                     tid=tid)

    def _pooled_handover_failed(self, loop, front_fd: int, target: Connector,
                                head: bytes, front: str,
                                t_acc: Optional[float], src_ip: bytes,
                                tls_ctx: int, tried: set, err: int,
                                hint=None, tid: int = 0) -> None:
        """A warmed pool connection died at handover (post-validation).
        One stale socket says little about the backend beyond this
        session — but from the session's point of view it IS a failed
        connect: report it (feeding the passive-ejection streak), drop
        this backend's pools (its siblings were parked the same way and
        are presumed equally stale), and retry with a FRESH connect
        under the existing retry budget — same backend first while it is
        still healthy (a restarted backend accepts new connects fine;
        excluding it would strand single-backend groups), the normal
        re-selection otherwise. The backend is NOT added to `tried`
        here: if the fresh connect also fails, the ordinary
        connect-failed path excludes it then."""
        svr = target.svr
        events.record(
            "conn", f"{front} -> {target.ip}:{target.port} pooled "
            "handover failed", lb=self.alias, err=err,
            phase="pooled_handover_failed")
        target.group.report_failure(svr, err)
        self._drain_pools(svr)

        def pick():
            if svr.healthy and not svr.logic_delete:
                return Connector(svr, target.group)
            return self.backend.next_host(src_ip, hint,
                                          exclude=set(tried) | {svr})

        nxt = self._take_retry_slot(tried, front, pick)
        if nxt is None:
            vtl.close(front_fd)
            return
        self._splice(loop, front_fd, nxt, head, front, t_acc,
                     src_ip=src_ip, tls_ctx=tls_ctx, tried=tried,
                     hint=hint, fresh=True, tid=tid)

    # --------------------------------------------------------- data plane

    def _on_accept(self, loop, cfd: int, ip: str, port: int,
                   tid: int = 0, hh_counted: bool = False) -> None:
        """tid: a nonzero trace id CONTINUES a trace begun in the C
        accept plane (a sampled lane punt); 0 lets this path make its
        own 1-in-N sampling decision (utils/trace). hh_counted: the C
        lane plane already tallied this accept's analytics dims (a
        connect-fail punt whose backend vanished falls through here —
        re-counting would double its client/route)."""
        if self.draining:
            # listener close raced an in-flight accept: shed it; the
            # drain contract only protects established sessions
            events.record("drain_shed", f"{ip}:{port} shed: draining",
                          lb=self.alias)
            vtl.close(cfd)
            return
        # admission policing (vproxy_tpu/policing): the python mirror
        # of the C lane probe — same table, same integer bucket law, so
        # a punted (or lanes-off) accept reaches the verdict the lane
        # probe would have. One branch when the knob is off.
        if policing.ON:
            policing.maybe_tick()
            verdict = policing.check("clients", ip, lb=self.alias,
                                     trace_id=tid)
            if verdict == "shed" or (
                    verdict == "throttle"
                    and self.active_sessions + self.lane_active()
                    >= self.effective_max_sessions()):
                # a throttle verdict defers to the ceiling (sheds only
                # when the LB is already at its limit); shed refuses
                # outright. Account BEFORE the RST lands — the engine
                # attributed the verdict, this folds the legacy
                # families — and sample the rejection as a police span.
                self._policed_shed(1)
                if tid == 0:
                    tid = trace.maybe_sample()
                if tid:
                    now = time.monotonic()
                    _tspan(tid, "police", now, now, action=verdict)
                vtl.close_rst(cfd)
                return
        eff = self.effective_max_sessions()
        if (self.active_sessions + self.lane_active() >= eff
                and not policing.overload_spare(ip, lb=self.alias)):
            # overload guard: close-on-accept beats queueing unboundedly.
            # The policing spare above implements the weighted-fair shed
            # order: an in-quota classed tenant draws on its
            # deficit-round-robin budget (refilled per policing tick in
            # proportion to its declared rate, capped at one burst — so
            # the elasticity past the ceiling is bounded) while
            # over-quota and unclassed arrivals shed here first.
            # Lane-owned sessions count against the same budget — the C
            # side bounds itself at the shared ceiling and punts (or
            # RST-sheds, adaptive mode) past it, and this check stops
            # those punts from doubling the ceiling. Adaptive sheds RST
            # (a crowd big enough to move the ceiling would park one
            # TIME_WAIT per FIN-shed); static keeps the clean close.
            # account BEFORE closing: the close is the client-visible
            # edge, so counters/events must already be readable when a
            # shed client observes it (the probe-then-assert race)
            self._overload_total().incr()
            self._shed_total(
                "adaptive" if self._overguard is not None else
                "static").incr()
            events.record(
                "overload", f"{ip}:{port} shed: {self.active_sessions} "
                f"sessions at ceiling {eff} (max {self.max_sessions})",
                lb=self.alias, mode=self.overload_mode)
            if self._overguard is not None:
                vtl.close_rst(cfd)
            else:
                vtl.close(cfd)
            return
        self.accepted += 1
        self._retry_budget.on_accept()
        # workload capture (utils/workload): the accept-plane arrival
        # process — one branch per accept when VPROXY_TPU_WORKLOAD=0
        workload.note_arrival("accept")
        # analytics (utils/sketch): who is hot right now — one branch
        # per site when VPROXY_TPU_ANALYTICS=0
        if not hh_counted:
            sketch.update("clients", ip)
            sketch.update("routes", self.alias)
        t_acc = time.monotonic()
        if tid == 0:
            tid = trace.maybe_sample()  # one branch when the knob is off

        # ACL gate (SecurityGroup.allow — TcpLB.java:168-171); the lookup
        # rides the ClassifyService micro-batch queue, coalescing with
        # other in-flight accepts across connections/loops
        def on_verdict(ok: bool) -> None:
            now = time.monotonic()
            accept_stage_observe("acl", now - t_acc)
            _tspan(tid, "acl", t_acc, now, allow=ok)
            if not ok or not self.started:
                if not ok:
                    events.record("conn_denied",
                                  f"{ip}:{port} denied by ACL",
                                  lb=self.alias, trace_id=tid)
                vtl.close(cfd)
                return
            if self.worker is not self.acceptor:
                wl = self.worker.next()
                if not wl.run_on_loop(
                        lambda: self._serve(wl, cfd, ip, port, t_acc,
                                            tid=tid)):
                    vtl.close(cfd)  # worker loop died; don't leak the fd
            else:
                self._serve(loop, cfd, ip, port, t_acc, tid=tid)

        try:
            # the submit rides the trace context so the classify plane
            # (queue wait / dispatch / launch markers) attaches its
            # spans to THIS request's trace
            with trace.bind(tid):
                self.security_group.allow_async(Proto.TCP, parse_ip(ip),
                                                self.bind_port, on_verdict,
                                                loop)
        except Exception:
            vtl.close(cfd)  # classify queue unavailable: refuse, not leak
            raise

    def _serve(self, loop, cfd: int, ip: str, port: int,
               t_acc: Optional[float] = None, tid: int = 0) -> None:
        """Owns cfd: every branch either hands it off or closes it exactly
        once — including when `loop` died while the accept's ACL verdict
        was in flight (the verdict then runs on the dispatcher thread, or
        via the closed loop's promised-task drain)."""
        if self.holder is not None:
            self._serve_tls(loop, cfd, ip, port, t_acc)
        elif self.protocol == "tcp":
            t0 = time.monotonic()
            src_ip = parse_ip(ip)
            with trace.bind(tid):  # classify spans attach to the trace
                conn = self.backend.next(src_ip)
            now = time.monotonic()
            accept_stage_observe("backend_pick", now - t0)
            _tspan(tid, "backend_pick", t0, now)
            if conn is None:
                vtl.close(cfd)
                return
            self._splice(loop, cfd, conn, b"", front=f"{ip}:{port}",
                         t_acc=t_acc, src_ip=src_ip, tid=tid)
        elif self.protocol == "http-splice":
            self._http_classify(loop, cfd, ip, port, t_acc, tid=tid)
        else:
            try:
                L7Engine(self, loop, cfd, ip, port,
                         processors.get(self.protocol))
            except Exception:
                pass  # L7Engine closes cfd on its failure paths

    def _serve_tls(self, loop, cfd: int, ip: str, port: int,
                   t_acc: Optional[float] = None) -> None:
        """TLS termination. protocol=tcp on the native provider takes
        the C-side path: MSG_PEEK the ClientHello for SNI (cert choice +
        classify hint), then hand the untouched socket to the OpenSSL
        splice pump — handshake and record layer run in C, TLS bytes
        never enter Python (the reference's engine-speed SSL rings,
        SSLWrapRingBuffer.java:23/SSLUnwrapRingBuffer.java:28). L7
        protocols (and the pure-python provider, or mirror taps wanting
        plaintext) keep the MemoryBIO path through the L7 engine."""
        import os as _os
        if (self.protocol == "tcp" and vtl.PROVIDER == "native"
                and _os.environ.get("VPROXY_TPU_NATIVE_TLS", "1") != "0"
                and vtl.tls_available() and not self._mirror_wants_tls()):
            self._serve_tls_native(loop, cfd, ip, port, t_acc)
            return
        from ..net.tls import TlsSocket
        from ..processors.base import TcpRelaySession
        from ..rules.ir import Hint
        try:
            conn = Connection(loop, cfd, (ip, port))
        except OSError:
            vtl.close(cfd)
            return
        tls = TlsSocket(conn, self.holder.front_context)
        if self.protocol == "tcp":
            def factory(eng, addr):
                return TcpRelaySession(
                    eng, addr,
                    hint_fn=lambda: Hint.of_host(tls.sni) if tls.sni else None)
        else:
            name = "http1" if self.protocol == "http-splice" else self.protocol
            factory = processors.get(name)
        L7Engine(self, loop, cfd, ip, port, factory, front=tls)

    def _mirror_wants_tls(self) -> bool:
        """Plaintext mirror taps need the python TLS path (the native
        pump's plaintext never surfaces to the mirror)."""
        from ..utils.mirror import Mirror
        m = Mirror.get()
        return m.hot and m.wants("ssl")  # net/tls.py's mirror origin

    def _serve_tls_native(self, loop, cfd: int, ip: str, port: int,
                          t_acc: Optional[float] = None) -> None:
        """Peek the ClientHello (bytes stay queued), choose the cert and
        classify by SNI, connect the backend, then run the C-side
        TLS-terminating splice pump on the untouched client socket."""
        from ..net.sniff import MAX_HELLO, parse_client_hello_sni
        from ..rules.ir import Hint
        lb = self
        # the timeout abort gets the deadline list so it clears
        # deadline[0]: the parked-hello rearm timer guards on that, and
        # without it a post-timeout rearm could re-enable reads on a
        # RECYCLED fd number owned by an unrelated connection
        deadline: list = [None]
        # the hello peek is a pre-handover phase: bounded by the
        # handshake deadline (slowloris defense), not the idle timeout;
        # with the deadline disabled (HANDSHAKE_MS=0) expiry keeps the
        # plain-close semantics, not the RST + halfopen count
        deadline[0] = loop.delay(
            self._handshake_ms(),
            lambda: self._peek_abort(loop, cfd, deadline,
                                     halfopen=HANDSHAKE_MS > 0))

        def on_ev(fd: int, ev: int) -> None:
            if ev & vtl.EV_ERROR:
                self._peek_abort(loop, cfd, deadline)
                return
            try:
                data = vtl.recv_peek(cfd, MAX_HELLO)
            except OSError:
                self._peek_abort(loop, cfd, deadline)
                return
            if data is None:
                return  # spurious wakeup
            if not data:
                self._peek_abort(loop, cfd, deadline)  # EOF before hello
                return
            sni, complete = parse_client_hello_sni(data)
            if not complete:
                # MSG_PEEK leaves the fd readable: a level-triggered
                # re-arm here would busy-spin until the hello completes.
                # Park interest and re-check shortly (deadline still
                # bounds the total wait).
                try:
                    loop.modify(cfd, 0)

                    def rearm() -> None:
                        if deadline[0] is None:  # aborted meanwhile
                            return
                        try:
                            if loop.registered(cfd):
                                loop.modify(cfd, vtl.EV_READ)
                        except Exception:
                            pass
                    loop.delay(20, rearm)
                except Exception:
                    self._peek_abort(loop, cfd, deadline)
                return  # wait for more ClientHello bytes
            if deadline[0] is not None:
                deadline[0].cancel()
                deadline[0] = None
            loop.remove(cfd)
            ck = self.holder.choose_cert_key(sni)
            ctx = ck.native_ctx()
            if ctx is None:
                # libssl vanished / cert unreadable: python TLS fallback
                self._serve_tls_python_fallback(loop, cfd, ip, port)
                return
            hint = Hint.of_host(sni) if sni else None

            src_ip = parse_ip(ip)

            def on_back(back) -> None:
                if back is None:
                    vtl.close(cfd)
                    return
                self._splice_tls(loop, cfd, back, ctx,
                                 front=f"{ip}:{port}", t_acc=t_acc,
                                 src_ip=src_ip, hint=hint)

            lb.backend.next_async(src_ip, hint, on_back, loop=loop)

        try:
            loop.add(cfd, vtl.EV_READ, on_ev)
        except OSError:
            if deadline[0] is not None:  # the timer must not fire on a
                deadline[0].cancel()     # closed (reusable) fd number
                deadline[0] = None
            vtl.close(cfd)

    def _peek_abort(self, loop, cfd: int, deadline=None,
                    halfopen: bool = False) -> None:
        if deadline and deadline[0] is not None:
            deadline[0].cancel()
            deadline[0] = None
        try:
            if loop.registered(cfd):
                loop.remove(cfd)
        except Exception:
            pass
        if halfopen:
            # the handshake deadline fired with the hello still
            # incomplete: a slowloris/half-open client — RST (no
            # TIME_WAIT for flood sheds) and count the release
            self._halfopen_count("tls hello never completed: "
                                 "handshake deadline")
            vtl.close_rst(cfd)
            return
        vtl.close(cfd)

    def _serve_tls_python_fallback(self, loop, cfd: int, ip: str,
                                   port: int) -> None:
        from ..net.tls import TlsSocket
        from ..processors.base import TcpRelaySession
        from ..rules.ir import Hint
        try:
            conn = Connection(loop, cfd, (ip, port))
        except OSError:
            vtl.close(cfd)
            return
        tls = TlsSocket(conn, self.holder.front_context)

        def factory(eng, addr):
            return TcpRelaySession(
                eng, addr,
                hint_fn=lambda: Hint.of_host(tls.sni) if tls.sni else None)

        L7Engine(self, loop, cfd, ip, port, factory, front=tls)

    def _splice_tls(self, loop, front_fd: int, target: Connector,
                    ctx: int, front: str = "?",
                    t_acc: Optional[float] = None,
                    src_ip: bytes = b"", hint=None) -> None:
        """Like _splice, but the handover runs the TLS-terminating pump
        (client side TLS in C, backend plaintext)."""
        self._splice(loop, front_fd, target, b"", f"tls {front}",
                     t_acc=t_acc, src_ip=src_ip, tls_ctx=ctx, hint=hint)

    # ------------------------------------------------------ idle timeout

    # ------------------------------------------------- hot-settable knobs

    def set_cert_keys(self, cert_keys: list) -> None:
        """Swap the served certs without restart ("modifiable when
        running", TcpLB.java:294-320): the holder is built FIRST so a
        bad cert file leaves the old holder and cert list untouched;
        new accepts use the new holder, in-flight sessions keep theirs."""
        from .certkey import CertKeyHolder
        proc = processors.get(self.protocol)
        alpn = list(proc.alpn) if proc is not None and proc.alpn else None
        holder = CertKeyHolder(cert_keys, alpn=alpn)  # may raise: no change
        self.cert_keys = cert_keys
        self.holder = holder
        if getattr(self, "lanes", None) is not None:  # ctor calls this
            # lanes route plaintext in C — they cannot terminate TLS.
            # A hot cert install on a running lanes LB tears the lanes
            # down and rebinds python listeners on the same port.
            _log.warn(f"tcp-lb {self.alias}: TLS certs installed; "
                      "disabling C accept lanes")
            lanes, self.lanes = self.lanes, None
            lanes.shutdown()
            if self.started:
                for lp in self.acceptor.loops:
                    def mk(lp=lp) -> None:
                        self.server_socks.append(ServerSock(
                            lp, self.bind_ip, self.bind_port,
                            lambda fd, ip, port, lp=lp: self._on_accept(
                                lp, fd, ip, port),
                            reuseport=len(self.acceptor.loops) > 1))
                    lp.call_sync(mk)

    def set_security_group(self, sg: SecurityGroup) -> None:
        """Hot-swap the ACL group; a lanes LB moves its mutation hook to
        the new group and recompiles (the old entry is gen-gated out)."""
        old = self.security_group
        self.security_group = sg
        if self.lanes is not None:
            old.remove_listener(self.lanes._on_mutation)
            sg.add_listener(self.lanes._on_mutation)
            self.lanes._on_mutation()

    def lane_active(self) -> int:
        """Live lane-owned sessions (drain accounting: these are real
        in-flight client sessions invisible to active_sessions)."""
        return self.lanes.active() if self.lanes is not None else 0

    def maglev_stat(self) -> dict:
        """`list-detail tcp-lb` / HTTP detail `maglev` object: every
        consistent-hash table this LB routes through — the C lane
        route's (when the pick mode is maglev) and each source-method
        group's python table — with size, generation and the last
        resize's remap fraction (docs/perf.md)."""
        d: dict = {"lanes": None, "groups": []}
        lanes = self.lanes
        if lanes is not None:
            st = lanes.stat()
            if st.get("on") and st.get("pick") == "maglev":
                d["lanes"] = dict(st.get("maglev") or {}, gen=st["gen"])
        for gh in list(self.backend.handles):
            if gh.group.method == "source":
                info = gh.group.maglev_info()
                if info.get("on"):
                    d["groups"].append(dict(info, group=gh.group.alias))
        return d

    def set_max_sessions(self, n: int) -> None:
        """Hot-set the overload ceiling for BOTH admission paths: the
        python accept check and the C lanes' active bound. In adaptive
        mode this moves the controller's UPPER bound; the effective
        ceiling re-clamps on its next tick."""
        self.max_sessions = n if n > 0 else MAX_SESSIONS
        g = self._overguard
        if g is not None:
            g.ceiling = min(max(g.ceiling, g.floor), self.max_sessions)
        self._push_lane_limit()

    def set_overload_mode(self, mode: str) -> None:
        """Hot-flip static <-> adaptive (`update tcp-lb ... overload`).
        Leaving adaptive restores the full max_sessions bound (and the
        lanes' punt-style shed); entering it starts the controller at
        the current ceiling."""
        if mode not in ("static", "adaptive"):
            raise ValueError(f"overload mode {mode!r}: "
                             "expected 'static' or 'adaptive'")
        if mode == self.overload_mode:
            return
        from .overload import AdaptiveOverload
        if mode == "adaptive":
            self._overguard = AdaptiveOverload(self)
            if self.started:
                self._overguard.start()
        else:
            g, self._overguard = self._overguard, None
            if g is not None:
                g.stop()  # also flips the C lanes' RST shed off
        self.overload_mode = mode
        self._push_lane_limit()
        events.record("overload_mode",
                      f"lb {self.alias} overload mode -> {mode}",
                      lb=self.alias, mode=mode)

    def overload_stat(self) -> dict:
        """list-detail / HTTP detail payload: the live admission state
        (mode, bounds, controller EWMAs when adaptive)."""
        g = self._overguard
        if g is None:
            return {"mode": "static", "maxSessions": self.max_sessions,
                    "ceiling": self.max_sessions}
        return g.stat()

    def set_timeout(self, timeout_ms: int) -> None:
        """Hot-set the idle timeout AND re-arm the per-loop idle sweeps:
        an armed sweep waits timeout/4, so lowering the timeout without
        re-arming would only bite after the OLD interval elapsed. Lane
        sweeps read the C-side value per pass — forwarded here."""
        lanes = self.lanes
        if lanes is not None:
            lanes.set_timeout(timeout_ms)
        self.timeout_ms = timeout_ms
        for lid, lp in list(self._watch_loops.items()):
            def rearm(lid=lid, lp=lp) -> None:
                t = self._sweep_timers.pop(lid, None)
                if t is not None:
                    t.cancel()
                self._sweep_armed.discard(lid)
                if self._pump_watch.get(lid):
                    self._arm_sweep(lp)
            lp.run_on_loop(rearm)

    def _watch_pump(self, loop, pid: int, desc: str = "") -> None:
        """Track spliced-session activity; kill sessions idle > timeout_ms
        (the reference's tcpTimeout, Config.java:20 — default 15 min).
        `desc` ("front -> back") feeds the session/connection listing
        resources (cmd/ResourceType sess/conn)."""
        st = self._pump_watch.setdefault(id(loop), {})
        self._watch_loops[id(loop)] = loop  # session listing needs the obj
        st[pid] = (0, loop.now, desc)
        if failpoint.hit("pump.abort", desc):
            # kill the just-registered pump on the owning loop; the DONE
            # callback runs the normal cleanup path
            loop.next_tick(lambda: loop.pump_close(pid))
        if len(st) == 1:
            self._arm_sweep(loop)

    def _unwatch_pump(self, loop, pid) -> None:
        self._pump_watch.get(id(loop), {}).pop(pid, None)

    def _arm_sweep(self, loop) -> None:
        def sweep() -> None:
            st = self._pump_watch.get(id(loop), {})
            if not st or not self.started:
                self._sweep_armed.discard(id(loop))
                self._sweep_timers.pop(id(loop), None)
                return
            for pid, (last_total, last_ts, desc) in list(st.items()):
                try:
                    a2b, b2a, _err = loop.pump_stat(pid)
                except OSError:
                    st.pop(pid, None)
                    continue
                total = a2b + b2a
                if total != last_total:
                    st[pid] = (total, loop.now, desc)
                elif (loop.now - last_ts) * 1000 >= self.timeout_ms:
                    st.pop(pid, None)
                    loop.pump_close(pid)
            if st:  # interval re-read so hot-set timeouts take effect
                self._sweep_timers[id(loop)] = loop.delay(
                    max(self.timeout_ms // 4, 1000), sweep)
            else:
                self._sweep_armed.discard(id(loop))
                self._sweep_timers.pop(id(loop), None)

        if id(loop) not in self._sweep_armed:
            self._sweep_armed.add(id(loop))
            self._sweep_timers[id(loop)] = loop.delay(
                max(self.timeout_ms // 4, 1000), sweep)

    def _http_classify(self, loop, cfd: int, ip: str, port: int,
                       t_acc: Optional[float] = None,
                       tid: int = 0) -> None:
        lb = self
        parser = HeadParser()
        try:
            front = Connection(loop, cfd, (ip, port))
        except OSError:
            vtl.close(cfd)
            return
        # a client that never completes its head is a half-open
        # (slowloris) session: dropped at the HANDSHAKE deadline — not
        # the minutes-long idle timeout — with an RST, and counted, so
        # a flood can neither pin parser state nor stack TIME_WAITs.
        # The deadline bounds the CLIENT's phase only: it is cancelled
        # the moment the head completes, so a slow classify/backend
        # connect (bounded by its own timeouts) can never get a
        # well-behaved client RST-killed as "halfopen"
        head_deadline: list = [None]

        def head_timeout() -> None:
            head_deadline[0] = None
            if not front.closed and not front.detached:
                if HANDSHAKE_MS > 0:
                    lb._halfopen_kill(front)
                else:  # deadline disabled: the plain idle-expiry close
                    front.close()
        head_deadline[0] = loop.delay(lb._handshake_ms(), head_timeout)

        class Front(Handler):
            def on_data(self, conn: Connection, data: bytes) -> None:
                parser.feed(data)
                if parser.error:
                    conn.close()
                    return
                if parser.done:
                    if head_deadline[0] is not None:
                        head_deadline[0].cancel()
                        head_deadline[0] = None
                    conn.pause_reading()
                    hint = parser.hint()
                    t_cls = time.monotonic()

                    # classify via the cross-connection micro-batch queue
                    def on_back(back) -> None:
                        now = time.monotonic()
                        _tspan(tid, "classify", t_cls, now)
                        if conn.closed or conn.detached:
                            return
                        if back is None:
                            conn.write(b"HTTP/1.1 503 Service Unavailable\r\n"
                                       b"content-length: 0\r\nconnection: close\r\n\r\n")
                            loop.delay(50, conn.close)
                            return
                        buffered = bytes(parser.buf)
                        ffd = conn.detach()
                        lb._splice(loop, ffd, back, buffered,
                                   front=f"{ip}:{port}", t_acc=t_acc,
                                   src_ip=parse_ip(ip), hint=hint,
                                   tid=tid)

                    with trace.bind(tid):  # classify-plane spans attach
                        lb.backend.next_async(parse_ip(ip), hint, on_back,
                                              loop=loop)

            def on_eof(self, conn: Connection) -> None:
                conn.close()

        front.set_handler(Front())

    def _splice(self, loop, front_fd: int, target: Connector,
                head: bytes, front: str = "?",
                t_acc: Optional[float] = None, src_ip: bytes = b"",
                tls_ctx: int = 0, tried: Optional[set] = None,
                hint=None, fresh: bool = False, tid: int = 0) -> None:
        """fresh=True bypasses the warm pool (the pooled-handover retry
        path: it just drained this backend's pools and must dial a real
        connect, not fish another parked socket)."""
        if tried is None:
            tried = set()
        svr = target.svr
        # analytics: backend attribution for every python-path handover
        # (plain, pooled, fast-lane; lane-served sessions tally in C).
        # The knob gate wraps the key build too — knob-off must not pay
        # a string format per handover
        if sketch.ON:
            sketch.update("backends", f"{target.ip}:{target.port}")
        if not fresh:
            conn = self._pool_take(loop, target)
            if conn is not None:
                self._adopt_pooled(loop, front_fd, target, conn, head,
                                   front, t_acc, src_ip, tls_ctx, tried,
                                   hint, tid=tid)
                return
        # C fast lane: plain splice sessions (no head bytes, no TLS)
        # ride vtl_pump_connect — ONE native call replaces the whole
        # connect/register/nodelay/handover chain (~8 crossings).
        # Armed failpoints force the classic path: the backend.connect.*
        # injection sites live in Connection.connect.
        if (not head and not tls_ctx and not failpoint.any_armed()
                and self._fast_splice(loop, front_fd, target, front,
                                      t_acc, src_ip, tried, hint,
                                      tid=tid)):
            return
        svr.conn_count += 1
        self._sessions_delta(1)
        try:
            # the timeout turns a SYN-blackholed backend into the same
            # on_closed(-ETIMEDOUT) -> retry path a refusal takes
            back = Connection.connect(loop, target.ip, target.port,
                                      timeout_ms=self.connect_timeout_ms)
        except OSError as e:
            svr.conn_count -= 1
            # retry first, release after: active_sessions must not dip
            # to 0 mid-retry (drain_wait reads it as "drained")
            self._backend_connect_failed(loop, front_fd, target, head,
                                         front, t_acc, src_ip, tls_ctx,
                                         tried, e.errno or 1, hint=hint,
                                         tid=tid)
            self._sessions_delta(-1)
            return
        back.set_handler(_SpliceBack(self, loop, front_fd, target, head,
                                     front, tls_ctx=tls_ctx, t_acc=t_acc,
                                     src_ip=src_ip, tried=tried, hint=hint,
                                     tid=tid))

    def _fast_splice(self, loop, front_fd: int, target: Connector,
                     front: str, t_acc: Optional[float], src_ip: bytes,
                     tried: set, hint, tid: int = 0) -> bool:
        """One-crossing backend connect + pump handover in the C loop
        (net/eventloop.pump_connect). The connect resolves natively; a
        refused/unreachable/timed-out backend comes back as a
        connect_failed DONE with the client fd intact, feeding the SAME
        retry/ejection machinery the python path uses. False = fast lane
        unavailable (py provider / old .so) — caller takes the classic
        path."""
        pc = getattr(loop, "pump_connect", None)
        if pc is None:
            return False
        lb = self
        svr = target.svr
        t_back = time.monotonic()
        desc = f"{front} -> {target.ip}:{target.port}"
        pid_box = [0]
        reported = [False]  # connect success noted (streak reset) once

        def _report_ok() -> None:
            # the classic path clears the ejection streak one RTT after
            # dialing (on_connected). The fast lane hears back at DONE
            # (short sessions) or at the connect-deadline check the loop
            # runs for still-open sessions (long streams) — a bounded
            # delay of at most connect_timeout_ms, never hours.
            if not reported[0]:
                reported[0] = True
                target.group.report_success(svr)
                if tried:  # a retry attempt landed through the fast lane
                    lb._retries_total("success").incr()

        def done(a2b: int, b2a: int, err: int, flags: int = 0,
                 connect_us: int = 0) -> None:
            lb._unwatch_pump(loop, pid_box[0])
            if flags & 1:  # backend never came up: retry machinery
                # front_fd is still open (pump_fail_connect keeps it):
                # same ownership contract as a python connect failure
                svr.conn_count -= 1
                lb._backend_connect_failed(
                    loop, front_fd, target, b"", front, t_acc, src_ip,
                    0, tried, err, hint=hint, tid=tid)
                lb._sessions_delta(-1)
                return
            if flags & 2:
                # torn down while STILL mid-connect (client RST'd the
                # front fd first): says nothing about the backend —
                # neither success (a report_success here would keep
                # resetting a blackholed backend's ejection streak on
                # every impatient client) nor failure. Plain teardown.
                svr.conn_count -= 1
                lb._sessions_delta(-1)
                events.record("conn", f"{desc} client abort mid-connect",
                              lb=lb.alias, err=err,
                              phase="client_abort_connecting")
                return
            _report_ok()
            # span semantics match the classic path (_handover observes
            # once the backend is up): registration cost + the REAL
            # connect duration the C side measured — observed late, at
            # DONE, but histograms only care about the value
            accept_stage_observe("handover",
                                 reg_s + connect_us / 1e6)
            if t_acc is not None:
                accept_stage_observe(
                    "total", (t_reg - t_acc) + connect_us / 1e6)
                lb._observe_accept((t_reg - t_acc) + connect_us / 1e6)
            if tid:
                # the fast lane hears everything back at DONE: spans
                # reconstructed from the C-measured connect duration +
                # the registration stamp — values exact, observed late
                t_conn1 = t_reg + connect_us / 1e6
                _tspan(tid, "connect", t_back, t_conn1,
                       backend=f"{target.ip}:{target.port}", fast=True)
                now = time.monotonic()
                _tspan(tid, "splice", t_conn1, now, bytes=a2b + b2a)
                _tspan(tid, "close", now, now, err=err)
            lb.bytes_in += a2b
            lb.bytes_out += b2a
            svr.bytes_in += a2b
            svr.bytes_out += b2a
            svr.conn_count -= 1
            lb._sessions_delta(-1)
            # workload capture: fast-lane sessions land in the same
            # per-connection histograms as the classic splice path
            if workload.ON:
                t0 = t_acc if t_acc is not None else t_reg
                conn_observe(lb.alias, a2b + b2a,
                             (time.monotonic() - t0) * 1e3)
            events.record("conn", f"{desc} closed", lb=lb.alias,
                          bytes_in=a2b, bytes_out=b2a, err=err,
                          trace_id=tid)

        pid = pc(front_fd, target.ip, target.port, self.in_buffer_size,
                 done, timeout_ms=self.connect_timeout_ms,
                 on_connected=_report_ok)
        if not pid:
            return False  # registration failed: classic path retries
        pid_box[0] = pid
        t_reg = time.monotonic()
        reg_s = t_reg - t_back
        svr.conn_count += 1
        self._sessions_delta(1)
        self._watch_pump(loop, pid, desc)
        return True

    def _adopt_pooled(self, loop, front_fd: int, target: Connector,
                      conn: Connection, head: bytes, front: str,
                      t_acc: Optional[float], src_ip: bytes, tls_ctx: int,
                      tried: set, hint, tid: int = 0) -> None:
        """Hand a validated warm connection straight to the pump: the
        accept path skips the whole backend-connect round trip (syscalls
        + a loop iteration waiting for writability). Reads are already
        parked, so a server-first backend's early bytes are still queued
        in the kernel for the pump to deliver."""
        svr = target.svr
        svr.conn_count += 1
        self._sessions_delta(1)
        sb = _SpliceBack(self, loop, front_fd, target, head, front,
                         tls_ctx=tls_ctx, t_acc=t_acc, src_ip=src_ip,
                         tried=tried, hint=hint, pooled=True, tid=tid)
        sb.connected = True
        conn.set_handler(sb)
        # NOTE: a retried session landing on a pooled socket counts its
        # retries_total{success} in _handover, once the pump is actually
        # registered — counting here would double-count when the pooled
        # socket dies at handover and the fresh-connect fallback succeeds
        if failpoint.hit("pool.handover.dead", f"{target.ip}:{target.port}"):
            # deterministic stale-at-handover: exercises the pooled
            # failure -> fresh-connect fallback (tests/test_pool_wiring)
            conn.close(errno.ECONNRESET)
            return
        if head:
            conn.write(head)  # a dead socket closes here -> on_closed
            if conn.closed:   # handles the fallback; nothing more to do
                return
        if conn.out:
            return  # _handover on drain, like a fresh connect
        sb._handover(conn)
