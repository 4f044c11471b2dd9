"""Adaptive overload control, the slowloris pre-handover deadline and the
RST shed mechanics: the 15 cases of tests/test_overload_adaptive.py, each
run on both packages (`X`: the reference's module names from either
package; the port's matchers on the CPU). storm's flash_crowd rides
components/overload.py AdaptiveOverload and the lanes' shed forwarding.

The controller law is unit-tested deterministically (tick_once with
injected signals); the integration edges — half-open release, RST with
no TIME_WAIT pileup, lane-limit forwarding — run against real sockets.
"""
import socket
import time
from types import SimpleNamespace

import pytest

from test_torch_dns import IDS, PKGS, mod
from test_torch_tcplb import _torch_cpu, IdServer, wait_healthy  # noqa: F401


def pkg_ns(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(
        pkg=pkg, ov=mod(pkg, "components.overload"),
        T=mod(pkg, "components.tcplb"), SG=mod(pkg, "components.servergroup"),
        U=mod(pkg, "components.upstream"), EL=mod(pkg, "components.elgroup"),
        FR=mod(pkg, "utils.events").FlightRecorder,
        GI=mod(pkg, "utils.metrics").GlobalInspection,
        failpoint=mod(pkg, "utils.failpoint"), vtl=mod(pkg, "net.vtl"))


@pytest.fixture(params=PKGS, ids=IDS)
def X(request):
    return pkg_ns(request.param)


@pytest.fixture
def stack(X):
    elgs, lbs, servers, groups = [], [], [], []

    def make(n_workers=1):
        elg = X.EL.EventLoopGroup("w", n_workers)
        elgs.append(elg)
        return elg

    yield {"make_elg": make, "lbs": lbs, "servers": servers,
           "groups": groups, "elgs": elgs}
    for lb in lbs:
        lb.stop()
    for g in groups:
        g.close()
    for s in servers:
        s.close()
    for e in elgs:
        e.close()


def fast_hc(X):
    return X.SG.HealthCheckConfig(timeout_ms=500, period_ms=100, up=1,
                                  down=1)


def _mk_lb(X, stack, alias, **kw):
    elg = stack["make_elg"](1)
    s1 = IdServer("A")
    stack["servers"].append(s1)
    g = X.SG.ServerGroup(f"{alias}-g", elg, fast_hc(X))
    stack["groups"].append(g)
    g.add("a", "127.0.0.1", s1.port)
    wait_healthy(g, 1)
    ups = X.U.Upstream(f"{alias}-u")
    ups.add(g)
    lb = X.T.TcpLB(alias, elg, elg, "127.0.0.1", 0, ups, **kw)
    stack["lbs"].append(lb)
    lb.start()
    return lb


# --------------------------------------------------------- controller law

class _FakeLB:
    """Just enough TcpLB surface for AdaptiveOverload: session counts,
    loop groups (empty — stall injected via a fake loop), lane no-ops."""

    class _G:
        loops: list = []

    def __init__(self, max_sessions=1000):
        self.alias = "fake"
        self.max_sessions = max_sessions
        self.active_sessions = 0
        self.acceptor = self._G()
        self.worker = self._G()
        self.lanes = None

    def lane_active(self):
        return 0

    def _push_lane_limit(self):
        pass


class _FakeLoop:
    def __init__(self):
        self.stall_total_s = 0.0


def test_controller_converges_to_floor_and_recovers(X):
    lb = _FakeLB(max_sessions=1000)
    lp = _FakeLoop()
    lb.worker.loops = [lp]
    g = X.ov.AdaptiveOverload(lb, floor=8, tick_ms=50, stall_hi_ms=50.0,
                            accept_hi_ms=25.0, alpha=0.5)
    assert g.ceiling == 1000
    # hot: accept latency way over the setpoint, sessions live
    lb.active_sessions = 400
    now = time.monotonic()
    for i in range(40):
        for _ in range(4):
            g.observe_accept(0.120)  # 120ms spans
        now += 0.05
        g.tick_once(now)
        lb.active_sessions = min(lb.active_sessions, g.ceiling)
    assert g.ceiling == 8, g.stat()
    assert g.accept_ewma_ms > 25.0
    # calm: signals drop to zero -> additive recovery to max_sessions
    lb.active_sessions = 2
    for i in range(200):
        now += 0.05
        g.tick_once(now)
        if g.ceiling == 1000:
            break
    assert g.ceiling == 1000, g.stat()


def test_controller_trips_on_loop_stall_alone(X):
    lb = _FakeLB(max_sessions=512)
    lp = _FakeLoop()
    lb.worker.loops = [lp]
    g = X.ov.AdaptiveOverload(lb, floor=4, tick_ms=50, stall_hi_ms=50.0,
                            accept_hi_ms=25.0, alpha=0.5)
    lb.active_sessions = 64
    now = time.monotonic()
    for _ in range(20):
        lp.stall_total_s += 0.02  # 20ms of stall per 50ms tick = 400ms/s
        now += 0.05
        g.tick_once(now)
    assert g.ceiling == 4, g.stat()
    assert g.stall_ewma_ms > 50.0


def test_controller_raise_needs_sustained_calm(X):
    """One quiet tick inside a storm must NOT raise the ceiling (the
    sawtooth's top is where admitted sessions go to die)."""
    lb = _FakeLB(max_sessions=1000)
    g = X.ov.AdaptiveOverload(lb, floor=8, tick_ms=50, stall_hi_ms=50.0,
                            accept_hi_ms=25.0, alpha=1.0)
    g.ceiling = 8
    now = time.monotonic()
    now += 0.05
    g.tick_once(now)  # calm tick 1
    assert g.ceiling == 8
    g.observe_accept(0.200)  # hot again
    now += 0.05
    g.tick_once(now)
    assert g.ceiling == 8
    for _ in range(3):  # sustained calm -> raise
        now += 0.05
        g.tick_once(now)
    assert g.ceiling > 8


def test_controller_trips_on_lane_latency_alone(X):
    """The r11 lane-aware signal: the C accept plane serves whole
    sessions without ever calling observe_accept, so its accept EWMA
    (lanes_stat field 12, Lanes.accept_latency_ms) must reach the
    controller on its own — a lanes-heavy LB under pressure used to
    look IDLE to the python-side EWMA exactly when it was busiest."""

    class _FakeLanes:
        ms = 0.0

        def accept_latency_ms(self):
            return self.ms

        def shed_count(self):
            return 0

        def set_limit(self, n, shed):
            pass

    lb = _FakeLB(max_sessions=512)
    lanes = _FakeLanes()
    lb.lanes = lanes
    g = X.ov.AdaptiveOverload(lb, floor=4, tick_ms=50, stall_hi_ms=50.0,
                            accept_hi_ms=25.0, alpha=0.5)
    lb.active_sessions = 64
    now = time.monotonic()
    # zero python-side accepts, hot C plane -> the controller must trip
    lanes.ms = 120.0
    for _ in range(20):
        now += 0.05
        g.tick_once(now)
    assert g.ceiling == 4, g.stat()
    assert g.accept_ewma_ms > 25.0
    assert g.stat()["laneAcceptEwmaMs"] == 120.0
    # C plane cools -> sustained calm raises again (no stale-high memory)
    lanes.ms = 0.0
    lb.active_sessions = 2
    for _ in range(300):
        now += 0.05
        g.tick_once(now)
        if g.ceiling == 512:
            break
    assert g.ceiling == 512, g.stat()


def test_ceiling_never_starts_above_max_sessions(X):
    """An LB whose max_sessions sits BELOW the controller floor must not
    admit past its configured maximum in the window before the first
    tick's clamp runs: the ceiling starts AT max_sessions, never above."""
    lb = _FakeLB(max_sessions=32)
    g = X.ov.AdaptiveOverload(lb)  # default floor (64) > max_sessions
    assert g.ceiling == 32


def test_hot_set_max_sessions_clamps_ceiling(X, stack):
    lb = _mk_lb(X, stack, "lb-adapt-clamp", overload="adaptive")
    assert lb.effective_max_sessions() == lb.max_sessions
    lb.set_max_sessions(10)
    assert lb._overguard.ceiling <= 10
    assert lb.overload_stat()["mode"] == "adaptive"
    lb.set_overload_mode("static")
    assert lb.overload_stat()["mode"] == "static"
    assert lb.effective_max_sessions() == 10


# ------------------------------------------------- RST shed, no TIME_WAIT

def _time_wait_count(port: int) -> int:
    """TIME_WAIT sockets whose LOCAL port is `port` (the LB side — the
    side that closes first is the side that parks the TIME_WAIT)."""
    n = 0
    for path in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(path) as f:
                next(f)
                for line in f:
                    parts = line.split()
                    lport = int(parts[1].split(":")[1], 16)
                    if lport == port and parts[3] == "06":  # TIME_WAIT
                        n += 1
        except (OSError, StopIteration):
            pass
    return n


def test_adaptive_shed_is_rst_and_leaves_no_time_wait(X, stack):
    lb = _mk_lb(X, stack, "lb-adapt-rst", overload="adaptive",
                max_sessions=4096)
    lb._overguard.ceiling = 1  # deterministically force the shed edge
    ctr = X.GI.get().get_counter(
        "vproxy_lb_shed_total", lb="lb-adapt-rst", reason="adaptive")
    base = ctr.value()

    c1 = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c1.settimeout(5)
    assert c1.recv(1) == b"A"  # session 1 admitted (spliced)
    resets = 0
    for _ in range(12):
        try:
            c = socket.create_connection(("127.0.0.1", lb.bind_port),
                                         timeout=5)
        except ConnectionResetError:
            # the shed RST can land while the client is still inside
            # connect() on a loaded box — same designed shed
            resets += 1
            continue
        c.settimeout(5)
        try:
            d = c.recv(8)
            assert d == b"", d  # never served
        except ConnectionResetError:
            resets += 1  # the designed shed: RST, not FIN
        c.close()
    c1.close()
    assert resets >= 10  # RSTs, allowing a raced FIN or two
    assert ctr.value() - base >= 12
    # an RST shed parks NO state: zero TIME_WAITs on the LB port
    assert _time_wait_count(lb.bind_port) == 0
    kinds = [e["kind"] for e in X.FR.get().snapshot()]
    assert "overload" in kinds


def test_static_shed_keeps_fin_semantics(X, stack):
    """Back-compat: static mode sheds with the clean close."""
    lb = _mk_lb(X, stack, "lb-static-fin", max_sessions=1)
    c1 = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c1.settimeout(5)
    assert c1.recv(1) == b"A"
    c2 = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c2.settimeout(5)
    assert c2.recv(8) == b""  # clean FIN close
    c2.close()
    c1.close()


# --------------------------------------------------- slowloris deadline

def test_halfopen_http_head_hits_handshake_deadline(X, stack, monkeypatch):
    monkeypatch.setattr(X.T, "HANDSHAKE_MS", 300)
    lb = _mk_lb(X, stack, "lb-loris", protocol="http-splice")
    ctr = X.GI.get().get_counter(
        "vproxy_lb_shed_total", lb="lb-loris", reason="halfopen")
    base = ctr.value()
    s = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    s.settimeout(5)
    s.sendall(b"GET / HTTP/1.1\r\nHost: half")  # head never completes
    t0 = time.monotonic()
    try:
        released = s.recv(1) == b""
    except ConnectionResetError:
        released = True  # RST release: no TIME_WAIT for flood sheds
    took = time.monotonic() - t0
    s.close()
    assert released
    assert took < 3.0  # the deadline, not the 15-min idle timeout
    assert ctr.value() - base == 1
    assert lb.active_sessions == 0
    kinds = [e["kind"] for e in X.FR.get().snapshot()]
    assert "halfopen_shed" in kinds
    # a COMPLETE head still serves normally under the same deadline
    c = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c.settimeout(5)
    head = b"GET / HTTP/1.1\r\nHost: x\r\n\r\n"
    c.sendall(head)
    got = b""
    while len(got) < 1 + len(head):
        d = c.recv(256)
        if not d:
            break
        got += d
    c.close()
    assert got[:1] == b"A" and got[1:] == head


def test_completed_head_slow_backend_outlives_deadline(X, stack, monkeypatch):
    """The handshake deadline bounds the CLIENT's phase only: a head
    that completes in time CANCELS it, so a classify/backend pick slower
    than HANDSHAKE_MS (bounded by its own timeouts) must serve normally
    — not RST-kill the well-behaved client as 'halfopen'."""
    monkeypatch.setattr(X.T, "HANDSHAKE_MS", 250)
    lb = _mk_lb(X, stack, "lb-slowback", protocol="http-splice")
    ctr = X.GI.get().get_counter(
        "vproxy_lb_shed_total", lb="lb-slowback", reason="halfopen")
    base = ctr.value()
    real = lb.backend.next_async

    def slow(src_ip, hint, cb, fam=None, loop=None):
        # answer WELL past the handshake deadline (cb fires on loop)
        real(src_ip, hint,
             lambda back: loop.delay(600, lambda: cb(back)),
             fam=fam, loop=loop)

    monkeypatch.setattr(lb.backend, "next_async", slow)
    c = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c.settimeout(5)
    head = b"GET / HTTP/1.1\r\nHost: x\r\n\r\n"
    c.sendall(head)
    got = b""
    while len(got) < 1 + len(head):
        d = c.recv(256)
        if not d:
            break
        got += d
    c.close()
    assert got[:1] == b"A" and got[1:] == head  # served, not shed
    assert ctr.value() - base == 0


def test_handshake_disabled_keeps_idle_close_semantics(X, stack, monkeypatch):
    """VPROXY_TPU_HANDSHAKE_MS=0 restores the pre-r10 behavior exactly:
    a never-completed head is closed at the IDLE timeout with a FIN and
    no halfopen shed accounting — alert thresholds on the halfopen
    counter must not fire for ordinary idle expiries."""
    monkeypatch.setattr(X.T, "HANDSHAKE_MS", 0)
    lb = _mk_lb(X, stack, "lb-nohs", protocol="http-splice", timeout_ms=400)
    ctr = X.GI.get().get_counter(
        "vproxy_lb_shed_total", lb="lb-nohs", reason="halfopen")
    base = ctr.value()
    s = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    s.settimeout(5)
    s.sendall(b"GET / HTTP/1.1\r\nHost: half")  # head never completes
    assert s.recv(1) == b""  # clean FIN close — an RST would raise
    s.close()
    assert ctr.value() - base == 0


def test_peek_abort_halfopen_arm_rsts_and_counts(X, stack):
    """The TLS hello peek's deadline arm (shared _peek_abort path):
    a half-open TLS client is RST-released and counted — unit-level,
    since building a CertKey needs the absent `cryptography` lib."""
    lb = _mk_lb(X, stack, "lb-peek", protocol="tcp")
    loop = lb.worker.loops[0]
    ctr = X.GI.get().get_counter(
        "vproxy_lb_shed_total", lb="lb-peek", reason="halfopen")
    base = ctr.value()
    a, b = socket.socketpair()
    fd = b.detach()  # the "client" socket the peek deadline owns
    loop.call_sync(lambda: lb._peek_abort(loop, fd, None, halfopen=True))
    a.settimeout(2)
    try:
        released = a.recv(1) == b""
    except ConnectionResetError:
        released = True
    a.close()
    assert released
    assert ctr.value() - base == 1
    kinds = [e["kind"] for e in X.FR.get().snapshot()]
    assert "halfopen_shed" in kinds


# ------------------------------------------------------ seeded failpoints

def test_failpoint_seed_makes_probability_arms_replayable(X, monkeypatch):

    def seq(env_seed):
        monkeypatch.setenv("VPROXY_TPU_FAILPOINT_SEED", env_seed)
        X.failpoint.clear()
        X.failpoint.arm("pump.abort", probability=0.5)
        out = [X.failpoint.hit("pump.abort") for _ in range(64)]
        X.failpoint.clear()
        return out

    a = seq("42")
    b = seq("42")
    c = seq("43")
    assert a == b            # same seed -> same hit sequence
    assert a != c            # different seed -> different sequence
    assert any(a) and not all(a)  # the coin actually flips


def test_failpoint_explicit_seed_wins(X, monkeypatch):
    monkeypatch.setenv("VPROXY_TPU_FAILPOINT_SEED", "7")
    X.failpoint.clear()
    X.failpoint.arm("pump.abort", probability=0.5, seed=123)
    a = [X.failpoint.hit("pump.abort") for _ in range(32)]
    X.failpoint.clear()
    monkeypatch.setenv("VPROXY_TPU_FAILPOINT_SEED", "8")
    X.failpoint.arm("pump.abort", probability=0.5, seed=123)
    b = [X.failpoint.hit("pump.abort") for _ in range(32)]
    X.failpoint.clear()
    assert a == b  # the explicit seed ignores the env


# --------------------------------------------------------- lane coupling

def test_adaptive_limit_and_shed_forwarded_to_lanes(X, stack):
    if not X.vtl.lanes_supported():
        pytest.skip("C accept lanes unavailable")
    lb = _mk_lb(X, stack, "lb-adapt-lanes", overload="adaptive", lanes=2,
                max_sessions=4096)
    assert lb.lanes is not None
    lb._overguard.ceiling = 1
    lb._push_lane_limit()
    # one admitted session pins the only slot...
    c1 = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c1.settimeout(5)
    assert c1.recv(1) == b"A"
    # ...so the C plane RST-sheds the rest without punting to Python
    resets = 0
    for _ in range(8):
        try:
            c = socket.create_connection(("127.0.0.1", lb.bind_port),
                                         timeout=5)
        except ConnectionResetError:
            resets += 1  # the shed RST raced the handshake itself
            continue
        c.settimeout(5)
        try:
            if c.recv(4) == b"":
                pass
        except ConnectionResetError:
            resets += 1
        c.close()
    c1.close()
    assert resets >= 6
    deadline = time.monotonic() + 5
    while lb.lanes.shed_count() < 6 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert lb.lanes.shed_count() >= 6  # counted in C
    # the guard tick folds the C counter into the python metric
    lb._overguard.tick_once()
    ctr = X.GI.get().get_counter(
        "vproxy_lb_shed_total", lb="lb-adapt-lanes", reason="adaptive")
    assert ctr.value() >= 6
    assert _time_wait_count(lb.bind_port) == 0
