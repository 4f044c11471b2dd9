"""The port's C accept lanes (components/lanes.py over its own libvtl):
the cases of tests/test_lanes.py on the port's modules, the matchers
on the CPU."""
import socket
import time

import pytest

from vproxy_tpu_torch.components.servergroup import ServerGroup
from vproxy_tpu_torch.components.tcplb import TcpLB
from vproxy_tpu_torch.components.upstream import Upstream
from vproxy_tpu_torch.net import vtl
from vproxy_tpu_torch.utils import failpoint

from test_torch_tcplb import (  # noqa: F401
    _torch_cpu, IdServer, fast_hc, stack, tcp_get_id, wait_healthy)

pytestmark = pytest.mark.skipif(
    not vtl.lanes_supported(),
    reason="native provider without accept-lane symbols")

# the maglev lane route is a graceful degrade (maglev_supported() false
# -> _compile punts source-method groups): tests of the
# maglev pick itself must skip, not fail, on an older .so
needs_maglev = pytest.mark.skipif(
    not vtl.maglev_supported(),
    reason="native provider without maglev lane symbols")


@pytest.fixture(autouse=True)
def _clean_faults():
    failpoint.clear()
    yield
    failpoint.clear()


def _mk(stack, alias, sid="A", lanes=2, **kw):
    elg = stack["make_elg"](2)
    srv = IdServer(sid)
    stack["servers"].append(srv)
    g = ServerGroup(f"{alias}-g", elg, fast_hc())
    stack["groups"].append(g)
    g.add(sid.lower(), "127.0.0.1", srv.port)
    wait_healthy(g, 1)
    ups = Upstream(f"{alias}-u")
    ups.add(g)
    lb = TcpLB(alias, elg, elg, "127.0.0.1", 0, ups, protocol="tcp",
               lanes=lanes, **kw)
    stack["lbs"].append(lb)
    lb.start()
    return lb, ups, g, srv, elg


def _wait(pred, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_lane_serves_whole_lifetime_in_c(stack):
    lb, ups, g, srv, elg = _mk(stack, "lb-lane")
    assert lb.lanes is not None, "lanes did not come up"
    assert lb.lanes.engine() in ("epoll", "uring")
    for _ in range(20):
        assert tcp_get_id(lb.bind_port) == "A"
    # every connection ran in C: the python accept path never fired
    assert lb.accepted == 0
    assert _wait(lambda: lb.lanes.stat()["served"] >= 20)
    st = lb.lanes.stat()
    assert st["on"] and st["accepted"] >= 20 and st["punts"] == 0
    assert st["hit_rate"] == 1.0
    # engine honesty: the probe fields ride the stat (BENCH provenance)
    assert set(st["uring_probe"]) == {"setup", "accept", "connect",
                                      "poll", "splice", "send_zc"}


def test_lane_stale_forward_iff_gate_suppressed(stack):
    """The flow-cache stale-gate proof, accept-plane edition: removing
    the only group normally closes the gate synchronously (conns stop
    reaching A the moment remove() returns); with `lane.entry.stale`
    suppressing that ONE bump, the lane keeps forwarding to A through
    the stale entry — stale iff suppressed."""
    lb, ups, g, srv, elg = _mk(stack, "lb-stale")
    assert tcp_get_id(lb.bind_port) == "A"

    failpoint.arm("lane.entry.stale", count=1)
    ups.remove(g)  # the one bump this would fire is suppressed
    # upstream is now EMPTY, yet the lane still forwards to A: the
    # suppressed generation bump is the only thing stale routing needs
    stale = [tcp_get_id(lb.bind_port) for _ in range(5)]
    assert stale == ["A"] * 5, stale
    assert failpoint.active() == []  # the count arm drained

    # re-adding the group fires an UNsuppressed bump: entry recompiles
    ups.add(g)
    assert _wait(lambda: tcp_get_id(lb.bind_port) == "A")

    # control arm: same mutation without the failpoint = zero stale.
    # remove() returns only after the bump, so no later conn can ride
    # the old entry; with the upstream empty the punt path closes them.
    ups.remove(g)
    c = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c.settimeout(5)
    assert c.recv(16) == b""  # no backend: closed, never served by A
    c.close()


def test_lane_zero_stale_across_mutation_matrix(stack):
    """Upstream swap / ACL deny / backend-DOWN: after each mutation
    call returns, not one lane connection reaches a no-longer-routable
    backend."""
    from vproxy_tpu_torch.components.secgroup import SecurityGroup
    from vproxy_tpu_torch.rules.ir import AclRule, Proto
    from vproxy_tpu_torch.utils.ip import Network, mask_bytes

    lb, ups, g, srv, elg = _mk(stack, "lb-matrix")

    # --- upstream swap: A out, B in — conns flip, none reach A after
    srv_b = IdServer("B")
    stack["servers"].append(srv_b)
    g2 = ServerGroup("lb-matrix-g2", elg, fast_hc())
    stack["groups"].append(g2)
    g2.add("b", "127.0.0.1", srv_b.port)
    wait_healthy(g2, 1)
    ups.add(g2)
    ups.remove(g)
    # stop A's health checkers: IdServer.hits counts EVERY accept and
    # g's 100ms-period probes keep dialing A after it left the
    # upstream — under machine load the 10-get loop below runs >100ms
    # and a probe landing inside the window flaked this assert (it
    # reproduces on an unmodified tree); with the checkers stopped,
    # hits on A can only be lane handovers, which is the contract
    g.close()
    hits_a = srv.hits
    for _ in range(10):
        assert tcp_get_id(lb.bind_port) == "B"
    assert srv.hits == hits_a  # zero stale handovers to A

    # --- ACL mutation: a deny rule makes the group non-trivial — the
    # lane entry compiles EMPTY and the python ACL path denies
    sg = lb.security_group
    sg.add_rule(AclRule(
        "deny-all", Network(bytes(4), mask_bytes(0)), Proto.TCP,
        0, 65535, False))
    c = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c.settimeout(5)
    assert c.recv(16) == b""  # denied (closed), never spliced
    c.close()
    sg.remove_rule("deny-all")
    assert _wait(lambda: tcp_get_id(lb.bind_port) == "B")

    # --- backend DOWN: hc detects the dead server, the health edge
    # bumps the generation, and the recompiled entry routes nothing
    srv_b.close()
    assert _wait(lambda: not g2.servers[0].healthy)
    c = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c.settimeout(5)
    assert c.recv(16) == b""  # no healthy backend anywhere
    c.close()


def test_lane_connect_fail_feeds_retry_and_ejection(stack):
    """A lane backend that starts refusing surfaces as connect-fail
    punts: report_failure feeds the ejection streak and the bounded
    retry re-dials the healthy backend — the client never notices."""
    lb, ups, g, srv, elg = _mk(stack, "lb-cfail")
    # second backend: a bare backlog listener (no accept thread — an
    # IdServer's accept()-blocked thread keeps the kernel socket alive
    # past close()). hc connect-probes pass against the backlog; close()
    # then refuses instantly and deterministically.
    victim = socket.socket()
    victim.bind(("127.0.0.1", 0))
    victim.listen(8)
    vport = victim.getsockname()[1]
    g.add("v", "127.0.0.1", vport)
    wait_healthy(g, 2)
    base_fail = vtl.lane_counters()[4]
    victim.close()  # refuses from here; hc down detection lags
    ok = 0
    for _ in range(20):
        sid = tcp_get_id(lb.bind_port)
        assert sid in ("A", ""), sid
        if sid == "A":
            ok += 1
    # every request landed on A (directly or via retry failover)
    assert ok >= 19, ok
    # and the lane really did hit the refusing backend and punt
    assert vtl.lane_counters()[4] > base_fail
    from vproxy_tpu_torch.utils.metrics import GlobalInspection
    retr = GlobalInspection.get().get_counter(
        "vproxy_lb_retries_total", lb="lb-cfail", result="success")
    assert retr.value() >= 1


@needs_maglev
def test_lane_source_method_maglev(stack):
    """method=source compiles the Maglev table (hash_port=0 —
    source affinity IS a consistent hash) and the lanes serve it in C;
    every connection from one client address lands on ONE backend."""
    elg = stack["make_elg"](2)
    srvs = [IdServer(c) for c in "ABC"]
    stack["servers"].extend(srvs)
    g = ServerGroup("lb-src-g", elg, fast_hc(), method="source")
    stack["groups"].append(g)
    for c, srv in zip("abc", srvs):
        g.add(c, "127.0.0.1", srv.port)
    wait_healthy(g, 3)
    ups = Upstream("lb-src-u")
    ups.add(g)
    lb = TcpLB("lb-src", elg, elg, "127.0.0.1", 0, ups, protocol="tcp",
               lanes=2)
    stack["lbs"].append(lb)
    lb.start()
    assert lb.lanes is not None
    _wait(lambda: lb.lanes.stat()["pick"] == "maglev")
    ids = {tcp_get_id(lb.bind_port) for _ in range(6)}
    # loopback clients share one source address: affinity = ONE backend
    assert len(ids) == 1
    # served counts at pump DONE — the last reap may lag the client close
    assert _wait(lambda: lb.lanes.stat()["served"] >= 6)
    st = lb.lanes.stat()
    assert lb.accepted == 0  # all served in C, zero python accepts
    assert st["maglev"] and st["maglev"]["m"] > 0
    # the C pick and the python punt path agree: group.next() with the
    # loopback source address names the same backend the lanes used
    conn = g.next(b"\x7f\x00\x00\x01")
    sid = {s.name: s for s in g.servers}
    assert {chr(ord("A") + "abc".index(conn.svr.name))} == ids
    assert sid  # sanity


@needs_maglev
def test_lane_maglev_gen_gate_stale_iff_suppressed(stack):
    """The stale-gate proof, maglev-route edition: a source-method
    (maglev) lane entry rides the SAME one-atomic-bump invariant — a
    backend-set mutation closes the gate synchronously unless the
    `lane.entry.stale` failpoint suppresses exactly that one bump."""
    elg = stack["make_elg"](2)
    srv = IdServer("A")
    stack["servers"].append(srv)
    g = ServerGroup("lb-mgate-g", elg, fast_hc(), method="source")
    stack["groups"].append(g)
    g.add("a", "127.0.0.1", srv.port)
    wait_healthy(g, 1)
    ups = Upstream("lb-mgate-u")
    ups.add(g)
    lb = TcpLB("lb-mgate", elg, elg, "127.0.0.1", 0, ups, protocol="tcp",
               lanes=2)
    stack["lbs"].append(lb)
    lb.start()
    assert lb.lanes is not None
    _wait(lambda: lb.lanes.stat()["pick"] == "maglev")
    assert tcp_get_id(lb.bind_port) == "A"

    failpoint.arm("lane.entry.stale", count=1)
    ups.remove(g)  # the one bump this would fire is suppressed
    stale = [tcp_get_id(lb.bind_port) for _ in range(5)]
    assert stale == ["A"] * 5, stale  # stale maglev route still serves
    assert failpoint.active() == []

    # control arm: an UNsuppressed mutation closes the gate before the
    # call returns — with the upstream empty, conns punt and close
    ups.add(g)
    assert _wait(lambda: tcp_get_id(lb.bind_port) == "A")
    ups.remove(g)
    c = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c.settimeout(5)
    assert c.recv(16) == b""  # never served through the stale table
    c.close()


def test_lane_wlc_method_punts(stack):
    """wlc least-connections needs live python-side conn counts: the
    lane entry compiles EMPTY and every connection takes the python
    path that owns the configured semantics."""
    elg = stack["make_elg"](2)
    srv = IdServer("A")
    stack["servers"].append(srv)
    g = ServerGroup("lb-wlc-g", elg, fast_hc(), method="wlc")
    stack["groups"].append(g)
    g.add("a", "127.0.0.1", srv.port)
    wait_healthy(g, 1)
    ups = Upstream("lb-wlc-u")
    ups.add(g)
    lb = TcpLB("lb-wlc", elg, elg, "127.0.0.1", 0, ups, protocol="tcp",
               lanes=2)
    stack["lbs"].append(lb)
    lb.start()
    assert lb.lanes is not None
    for _ in range(3):
        assert tcp_get_id(lb.bind_port) == "A"
    # every one of them punted to python (wlc semantics preserved)
    assert lb.accepted == 3
    assert lb.lanes.stat()["served"] == 0


def test_socks5_never_gets_lanes(stack):
    """The reference's Socks5Server reads protocol='tcp' but speaks RFC
    1928 first, so it sets lanes_capable=False: the lanes must refuse
    eligibility or every client's greeting would be raw-spliced to a
    backend. The port's Socks5 server comes with a later slice; the
    rule lives in TcpLB and is held here on a frontend that sets the
    same class attribute."""
    class Socks5Like(TcpLB):
        lanes_capable = False

    elg = stack["make_elg"](1)
    srv = IdServer("A")
    stack["servers"].append(srv)
    g = ServerGroup("s5-g", elg, fast_hc())
    stack["groups"].append(g)
    g.add("a", "127.0.0.1", srv.port)
    wait_healthy(g, 1)
    ups = Upstream("s5-u")
    ups.add(g)
    s5 = Socks5Like("s5", elg, elg, "127.0.0.1", 0, ups, protocol="tcp")
    s5.lanes_n = 4  # as VPROXY_TPU_ACCEPT_LANES=4 would set it
    stack["lbs"].append(s5)
    s5.start()
    assert s5.lanes is None  # lanes_capable=False wins over lanes_n


def test_lane_accepts_fund_retry_budget(stack):
    """Lane accepts sync into the RetryBudget denominator (per poll
    tick): a connect-fail burst bigger than the burst floor still fails
    over because the lane traffic itself funded the budget."""
    lb, ups, g, srv, elg = _mk(stack, "lb-budget")
    for _ in range(30):  # all lane-served: never touch _on_accept
        assert tcp_get_id(lb.bind_port) == "A"
    assert lb.accepted == 0
    # the lane-0 poll tick (<=1s) credits the budget with those accepts
    assert _wait(lambda: lb._retry_budget._accepts
                 + lb._retry_budget._p_accepts >= 30, timeout=3.0)


def test_lane_armed_failpoint_forces_classic(stack):
    """Any armed fault outside lane.* flips punt_all: connections take
    the python path (failpoint sites keep exact semantics); disarming
    re-enables the lanes."""
    lb, ups, g, srv, elg = _mk(stack, "lb-fp")
    assert tcp_get_id(lb.bind_port) == "A"
    assert lb.accepted == 0
    failpoint.arm("backend.connect.refuse", match="never-matches-any")
    assert tcp_get_id(lb.bind_port) == "A"  # served via python accept
    assert lb.accepted == 1
    served_before = lb.lanes.stat()["served"]
    failpoint.clear()
    assert _wait(lambda: (tcp_get_id(lb.bind_port) == "A"
                          and lb.lanes.stat()["served"] > served_before))
    assert lb.accepted == 1  # python path not used again


def test_lane_drain_and_stop(stack):
    """begin_drain closes lane listeners (new conns refused while live
    sessions finish); stop() tears the lanes down cleanly and a fresh
    LB can rebind the port."""
    lb, ups, g, srv, elg = _mk(stack, "lb-ldrain")
    port = lb.bind_port
    c = socket.create_connection(("127.0.0.1", port), timeout=5)
    c.settimeout(5)
    assert c.recv(1) == b"A"
    assert _wait(lambda: lb.lane_active() >= 1)
    lb.begin_drain()
    # lanes close their listeners at the next tick
    def refused():
        try:
            c2 = socket.create_connection(("127.0.0.1", port), timeout=1)
            c2.close()
            return False
        except OSError:
            return True
    assert _wait(refused)
    # the in-flight lane session still moves bytes
    c.sendall(b"still-here")
    assert c.recv(64) == b"still-here"
    c.close()
    assert _wait(lambda: lb.lane_active() == 0)
    lb.stop()
    lb2 = TcpLB("lb-ldrain2", lb.acceptor, lb.worker, "127.0.0.1", port,
                ups, protocol="tcp", lanes=2)
    stack["lbs"].append(lb2)
    lb2.start()
    assert tcp_get_id(port) == "A"
