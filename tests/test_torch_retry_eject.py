"""Retry, passive ejection and the retry budget on the port's TcpLB and
ServerGroup: the cases of tests/test_retry_eject.py on the port's
modules, the matchers on the CPU."""
import socket
import time

import pytest

from vproxy_tpu_torch.components.elgroup import EventLoopGroup
from vproxy_tpu_torch.components import servergroup as SG
from vproxy_tpu_torch.components.servergroup import HealthCheckConfig, ServerGroup
from vproxy_tpu_torch.components.tcplb import TcpLB
from vproxy_tpu_torch.components.upstream import Upstream
from vproxy_tpu_torch.utils import failpoint
from vproxy_tpu_torch.utils.events import FlightRecorder
from vproxy_tpu_torch.utils.metrics import GlobalInspection

from test_torch_tcplb import _torch_cpu, IdServer, fast_hc, stack, tcp_get_id, wait_healthy  # noqa: F401


@pytest.fixture(autouse=True)
def _clean():
    failpoint.clear()
    FlightRecorder.reset()
    yield
    failpoint.clear()


def _retries(lb, result):
    return GlobalInspection.get().get_counter(
        "vproxy_lb_retries_total", lb=lb.alias, result=result).value()


def _ejections(group):
    return GlobalInspection.get().get_counter(
        "vproxy_group_ejections_total", group=group.alias).value()


def test_retry_failover_and_passive_ejection(stack, monkeypatch):
    """One backend refuses connects (health checks still pass — the
    classic half-dead box): every client is retried onto the good
    backend, and after EJECT_FAILURES consecutive failures the refuser
    is ejected without waiting a health-check interval."""
    monkeypatch.setattr(SG, "EJECT_FAILURES", 3)
    elg = stack["make_elg"](1)
    s1, s2 = IdServer("A"), IdServer("B")
    stack["servers"] += [s1, s2]
    # slow hc so the tcp health check can't mark the refuser down first
    g = ServerGroup("g", elg, HealthCheckConfig(
        timeout_ms=500, period_ms=60_000, up=1, down=100), "wrr")
    stack["groups"].append(g)
    g.add("a", "127.0.0.1", s1.port)
    g.add("b", "127.0.0.1", s2.port)
    wait_healthy(g, 2)
    ups = Upstream("u")
    ups.add(g)
    lb = TcpLB("lb-re", elg, elg, "127.0.0.1", 0, ups, protocol="tcp")
    stack["lbs"].append(lb)
    lb.start()

    ej0 = _ejections(g)
    failpoint.arm("backend.connect.refuse", match=f":{s1.port}")
    ids = [tcp_get_id(lb.bind_port) for _ in range(8)]
    assert ids == ["B"] * 8  # every connection failed over, none dropped
    assert _retries(lb, "success") >= 1

    # passive ejection fired at the failure threshold — no hc wait
    a = next(s for s in g.servers if s.name == "a")
    assert a.ejected and not a.healthy
    assert _ejections(g) == ej0 + 1
    kinds = [e["kind"] for e in FlightRecorder.get().snapshot()]
    assert "eject" in kinds and "retry" in kinds
    # ejected backend is out of rotation entirely: no more retries needed
    before = _retries(lb, "success")
    assert {tcp_get_id(lb.bind_port) for _ in range(4)} == {"B"}
    assert _retries(lb, "success") == before


def test_ejection_backoff_readmission_halving(stack, monkeypatch):
    """Re-admission: backoff gates the healthy flip, passing active
    probes halve the remaining wait, and the UP edge notifies like any
    health-check edge."""
    monkeypatch.setattr(SG, "EJECT_FAILURES", 2)
    monkeypatch.setattr(SG, "EJECT_BASE_S", 1.0)
    elg = stack["make_elg"](1)
    # protocol none: every probe passes without touching the network
    g = ServerGroup("g2", elg, HealthCheckConfig(
        period_ms=50, up=1, down=1, protocol="none"))
    stack["groups"].append(g)
    svr = g.add("x", "127.0.0.1", 1)
    g.add("y", "127.0.0.1", 2)  # keeps the pool non-empty: x CAN eject
    wait_healthy(g, 2)

    t0 = time.monotonic()
    g.report_failure(svr)
    g.report_failure(svr)
    assert svr.ejected and not svr.healthy
    assert svr._eject_backoff_s == 1.0

    # passing probes every 50ms halve the remaining backoff: re-admission
    # lands well before the nominal 1s expiry
    deadline = time.time() + 5
    while not svr.healthy:
        assert time.time() < deadline, "never re-admitted"
        time.sleep(0.02)
    took = time.monotonic() - t0
    assert took < 1.0, f"halving should beat the base backoff, took {took:.2f}s"
    assert not svr.ejected
    kinds = [e["kind"] for e in FlightRecorder.get().snapshot()]
    assert "eject" in kinds and "readmit" in kinds

    # a second ejection doubles the backoff from the last applied value
    g.report_failure(svr)
    g.report_failure(svr)
    assert svr.ejected and svr._eject_backoff_s == 2.0
    # ... and a data-plane success after re-admission decays it to base
    deadline = time.time() + 8
    while not svr.healthy:
        assert time.time() < deadline
        time.sleep(0.02)
    g.report_success(svr)
    assert svr._eject_backoff_s == 0.0


def test_local_errnos_do_not_feed_ejection(stack, monkeypatch):
    """Proxy-local connect failures (fd/port exhaustion) say nothing
    about the backend: they must not advance the ejection streak."""
    import errno
    monkeypatch.setattr(SG, "EJECT_FAILURES", 2)
    elg = stack["make_elg"](1)
    g = ServerGroup("g10", elg, HealthCheckConfig(
        period_ms=50, up=1, down=1, protocol="none"))
    stack["groups"].append(g)
    x = g.add("x", "127.0.0.1", 1)
    g.add("y", "127.0.0.1", 2)
    wait_healthy(g, 2)
    for _ in range(10):
        g.report_failure(x, errno.EMFILE)
        g.report_failure(x, errno.EADDRNOTAVAIL)
    assert x.healthy and not x.ejected and x._consec_fails == 0
    # backend-attributable errnos still eject
    g.report_failure(x, errno.ECONNREFUSED)
    g.report_failure(x, errno.ETIMEDOUT)
    assert x.ejected


def test_ejection_floor_spares_last_healthy_backend(stack, monkeypatch):
    """Passive ejection never empties the pool: the last healthy backend
    stays in rotation no matter how many connect failures it racks up."""
    monkeypatch.setattr(SG, "EJECT_FAILURES", 2)
    elg = stack["make_elg"](1)
    g = ServerGroup("g9", elg, HealthCheckConfig(
        period_ms=50, up=1, down=1, protocol="none"))
    stack["groups"].append(g)
    x = g.add("x", "127.0.0.1", 1)
    y = g.add("y", "127.0.0.1", 2)
    wait_healthy(g, 2)
    for _ in range(3):
        g.report_failure(x)
    assert x.ejected  # pool had y: ejection allowed
    for _ in range(10):
        g.report_failure(y)
    assert y.healthy and not y.ejected  # last healthy: floor holds
    kinds = [e["kind"] for e in FlightRecorder.get().snapshot()]
    assert "eject_skipped" in kinds


def test_connect_hang_times_out_into_retry(stack, monkeypatch):
    """backend.connect.hang: the connect deadline converts a SYN
    blackhole into the SAME failure path as a refusal — timeout, retry
    onto the healthy backend, counters drain to zero (no wedged
    sessions)."""
    monkeypatch.setattr(SG, "EJECT_FAILURES", 10_000)
    elg = stack["make_elg"](1)
    s1, s2 = IdServer("A"), IdServer("B")
    stack["servers"] += [s1, s2]
    g = ServerGroup("g8", elg, HealthCheckConfig(
        timeout_ms=500, period_ms=60_000, up=1, down=100), "wrr")
    stack["groups"].append(g)
    a = g.add("a", "127.0.0.1", s1.port)
    g.add("b", "127.0.0.1", s2.port)
    wait_healthy(g, 2)
    ups = Upstream("u8")
    ups.add(g)
    lb = TcpLB("lb-hang", elg, elg, "127.0.0.1", 0, ups, protocol="tcp")
    lb.connect_timeout_ms = 200
    stack["lbs"].append(lb)
    lb.start()

    failpoint.arm("backend.connect.hang", match=f":{s1.port}")
    t0 = time.time()
    ids = [tcp_get_id(lb.bind_port) for _ in range(4)]
    assert ids == ["B"] * 4, ids  # hung attempts timed out and failed over
    assert time.time() - t0 < 5
    assert a._consec_fails >= 1  # the timeout fed report_failure
    deadline = time.time() + 5
    while lb.active_sessions and time.time() < deadline:
        time.sleep(0.02)
    assert lb.active_sessions == 0  # nothing wedged
    evs = FlightRecorder.get().snapshot()
    assert any(e["kind"] == "conn" and e.get("phase") == "connect_failed"
               and e.get("err") == 110 for e in evs)  # ETIMEDOUT recorded


def test_hc_probe_does_not_consume_dataplane_faults(stack):
    """An http health check rides Connection.connect too, but must not
    burn count-armed backend.connect.* fires meant for the data plane."""
    from vproxy_tpu_torch.net.connection import Connection
    from vproxy_tpu_torch.net.eventloop import SelectorEventLoop
    s1 = IdServer("A", http=True)
    stack["servers"].append(s1)
    loop = SelectorEventLoop("fp-hc")
    loop.loop_thread()
    try:
        failpoint.arm("backend.connect.refuse", count=1,
                      match=f":{s1.port}")
        # probe-style connect (failpoints=False): succeeds, count intact
        c = loop.call_sync(lambda: Connection.connect(
            loop, "127.0.0.1", s1.port, failpoints=False))
        loop.call_sync(c.close)
        assert failpoint.active()[0]["count"] == 1
        # data-plane connect consumes it
        with pytest.raises(OSError):
            loop.call_sync(lambda: Connection.connect(
                loop, "127.0.0.1", s1.port))
        assert failpoint.active() == []
    finally:
        loop.close()


def test_hc_up_edge_resets_ejection_streak(stack, monkeypatch):
    """A sub-threshold failure streak frozen across an hc down/up cycle
    must not carry over: one post-recovery blip may not eject."""
    monkeypatch.setattr(SG, "EJECT_FAILURES", 3)
    elg = stack["make_elg"](1)
    s1 = IdServer("A")
    stack["servers"].append(s1)
    g = ServerGroup("g7", elg, HealthCheckConfig(
        timeout_ms=500, period_ms=50, up=1, down=1))
    stack["groups"].append(g)
    svr = g.add("a", "127.0.0.1", s1.port)
    wait_healthy(g, 1)
    g.report_failure(svr)
    g.report_failure(svr)  # streak 2, below threshold
    failpoint.arm("hc.force_down", match="g7/a")
    deadline = time.time() + 5
    while svr.healthy:
        assert time.time() < deadline
        time.sleep(0.02)
    failpoint.disarm("hc.force_down")
    deadline = time.time() + 5
    while not svr.healthy:
        assert time.time() < deadline
        time.sleep(0.02)
    g.report_failure(svr)  # one blip after recovery
    assert svr.healthy and not svr.ejected  # fresh streak: no eject


def test_hc_edges_through_force_down_failpoint(stack):
    """Health-check DOWN/UP edge transitions driven by hc.force_down
    instead of killing sockets: down after `down` consecutive forced
    failures, back up after `up` passes once disarmed."""
    elg = stack["make_elg"](1)
    s1 = IdServer("A")
    stack["servers"].append(s1)
    g = ServerGroup("g3", elg, HealthCheckConfig(
        timeout_ms=500, period_ms=50, up=2, down=2))
    stack["groups"].append(g)
    g.add("a", "127.0.0.1", s1.port)
    wait_healthy(g, 1)

    failpoint.arm("hc.force_down", match="g3/a")
    deadline = time.time() + 5
    while any(s.healthy for s in g.servers):
        assert time.time() < deadline, "forced hc failures never took it down"
        time.sleep(0.02)
    failpoint.disarm("hc.force_down")
    deadline = time.time() + 5
    while not all(s.healthy for s in g.servers):
        assert time.time() < deadline, "never came back up"
        time.sleep(0.02)
    kinds = [e["kind"] for e in FlightRecorder.get().snapshot()]
    assert "hc_down" in kinds and "hc_up" in kinds


def test_retry_budget_exhaustion_fast_close(stack, monkeypatch):
    """All backends refusing: clients see a fast close (never a hang),
    the budget stops the retry storm (counted budget_exhausted), and the
    flight recorder holds the connect-failed/retry chain."""
    monkeypatch.setattr(SG, "EJECT_FAILURES", 10_000)  # isolate the budget
    elg = stack["make_elg"](1)
    s1, s2 = IdServer("A"), IdServer("B")
    stack["servers"] += [s1, s2]
    g = ServerGroup("g4", elg, HealthCheckConfig(
        timeout_ms=500, period_ms=60_000, up=1, down=100), "wrr")
    stack["groups"].append(g)
    g.add("a", "127.0.0.1", s1.port)
    g.add("b", "127.0.0.1", s2.port)
    wait_healthy(g, 2)
    ups = Upstream("u")
    ups.add(g)
    lb = TcpLB("lb-budget", elg, elg, "127.0.0.1", 0, ups, protocol="tcp")
    stack["lbs"].append(lb)
    lb.start()

    failpoint.arm("backend.connect.refuse")  # match-all: dead cluster
    t0 = time.time()
    for _ in range(40):
        c = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
        c.settimeout(2)
        assert c.recv(64) == b""  # fast close, not a hang
        c.close()
    assert time.time() - t0 < 20
    assert _retries(lb, "budget_exhausted") >= 1
    # budget arithmetic: retries never exceeded ratio*accepts + burst
    taken = (_retries(lb, "success") + _retries(lb, "exhausted")
             + _retries(lb, "no_backend"))
    budget = lb._retry_budget
    assert taken <= budget.ratio * 40 + budget.burst + 1
    evs = FlightRecorder.get().snapshot()
    assert any(e["kind"] == "conn" and e.get("phase") == "connect_failed"
               for e in evs)
    assert any(e["kind"] == "retry" and "budget" in e["msg"] for e in evs)


def test_retry_preserves_classify_hint(stack, monkeypatch):
    """A Host-routed (http-splice) session whose hint-selected backend
    refuses must retry onto another backend of the SAME group — never
    fail over into a different service's group."""
    from vproxy_tpu_torch.rules.ir import HintRule
    from test_torch_tcplb import http_get_id

    # ejection armed at 3: after the first few retried requests the
    # refuser leaves rotation, so the retry budget never becomes the
    # limiting factor in this test
    monkeypatch.setattr(SG, "EJECT_FAILURES", 3)
    elg = stack["make_elg"](1)
    # group A (host-routed service): a1 refuses, a2 serves
    sa1, sa2 = IdServer("A1", http=True), IdServer("A2", http=True)
    # group C (the WRR-fallback service a broken retry would leak into)
    sc = IdServer("C", http=True)
    stack["servers"] += [sa1, sa2, sc]
    hc = HealthCheckConfig(timeout_ms=500, period_ms=60_000, up=1, down=100)
    ga = ServerGroup("ga", elg, hc, "wrr")
    gc = ServerGroup("gc", elg, hc, "wrr")
    stack["groups"] += [ga, gc]
    ga.add("a1", "127.0.0.1", sa1.port)
    ga.add("a2", "127.0.0.1", sa2.port)
    gc.add("c", "127.0.0.1", sc.port)
    wait_healthy(ga, 2)
    wait_healthy(gc, 1)
    ups = Upstream("u6")
    ups.add(ga, annotations=HintRule(host="a.example.com"))
    ups.add(gc)
    lb = TcpLB("lb-hint", elg, elg, "127.0.0.1", 0, ups,
               protocol="http-splice")
    stack["lbs"].append(lb)
    lb.start()

    failpoint.arm("backend.connect.refuse", match=f":{sa1.port}")
    bodies = [http_get_id(lb.bind_port, "a.example.com")[1]
              for _ in range(8)]
    # every retried request stayed inside group A
    assert bodies == ["A2"] * 8, bodies
    assert _retries(lb, "success") >= 1


def test_wrr_exclude_skips_tried_backends(stack):
    """Upstream.next(exclude=...) never returns an excluded handle even
    when it is the only hint/WRR winner."""
    elg = stack["make_elg"](1)
    g = ServerGroup("g5", elg, HealthCheckConfig(
        period_ms=50, up=1, down=1, protocol="none"))
    stack["groups"].append(g)
    a = g.add("a", "127.0.0.1", 1111)
    b = g.add("b", "127.0.0.1", 2222)
    wait_healthy(g, 2)
    ups = Upstream("u5")
    ups.add(g)
    for _ in range(8):
        c = ups.next(b"", exclude={a})
        assert c is not None and c.svr is b
    assert ups.next(b"", exclude={a, b}) is None


def test_pooled_handover_failure_respects_retry_budget(stack, monkeypatch):
    """Pool <-> retry-budget interplay: the fresh-connect fallback after
    a pooled handover failure is charged to the SAME per-LB budget as
    any other retry — with the budget pinned to zero the session is
    closed instead of dialing, and the budget_exhausted counter says
    so."""
    monkeypatch.setattr(SG, "EJECT_FAILURES", 10_000)
    elg = stack["make_elg"](1)
    s1 = IdServer("A")
    stack["servers"].append(s1)
    g = ServerGroup("g-pb", elg, HealthCheckConfig(
        timeout_ms=500, period_ms=100, up=1, down=100), "wrr")
    stack["groups"].append(g)
    g.add("a", "127.0.0.1", s1.port)
    wait_healthy(g, 1)
    ups = Upstream("u-pb")
    ups.add(g)
    lb = TcpLB("lb-pb", elg, elg, "127.0.0.1", 0, ups, protocol="tcp",
               pool_size=2)
    stack["lbs"].append(lb)
    lb.start()

    # warm the pool
    deadline = time.time() + 8
    from vproxy_tpu_torch.utils.metrics import GlobalInspection as GI

    def pool_hits():
        return GI.get().get_counter("vproxy_lb_pool_total", lb=lb.alias,
                                    result="hit").value()
    while pool_hits() < 1:
        assert time.time() < deadline
        assert tcp_get_id(lb.bind_port) == "A"
        time.sleep(0.01)

    # zero budget: a pooled failure may NOT convert into connect load
    lb._retry_budget.ratio = 0.0
    lb._retry_budget.burst = 0
    before = _retries(lb, "budget_exhausted")
    failpoint.arm("pool.handover.dead", count=1, match=f":{s1.port}")
    saw_close = False
    deadline = time.time() + 8
    while failpoint.active():
        assert time.time() < deadline, "fault never consumed"
        sid = socket.create_connection(("127.0.0.1", lb.bind_port),
                                       timeout=5)
        sid.settimeout(5)
        got = sid.recv(8)
        sid.close()
        if got == b"":
            saw_close = True  # the budget-denied session was shed
        time.sleep(0.01)
    assert saw_close
    assert _retries(lb, "budget_exhausted") >= before + 1
    deadline = time.time() + 5
    while lb.active_sessions and time.time() < deadline:
        time.sleep(0.02)
    assert lb.active_sessions == 0  # no session-count leak on that path
