"""End-to-end TcpLB of the port on loopback, the matchers on the CPU.

* the cases of tests/test_tcplb.py (the reference TestTcpLB pattern:
  tiny id-servers as backends, so balancing decisions are assertable)
  and of tests/test_drain_overload.py (its
  test_healthz_flips_to_draining is in test_torch_control.py), on
  vproxy_tpu_torch's modules; the two cases the reference drives
  through its control plane's command grammar go through the port's
  (control/command.py, control/app.py);
* BASELINE config #1 against both packages: an http TcpLB with health
  checks, 8 Host rules (exact, suffix, wildcard, one with a uri) on 8
  groups over 2 loopback backends; the same seeded request list goes
  through vproxy_tpu and vproxy_tpu_torch, and every request reaches
  the same backend;
* B3's entry (ops/fused_cuda.py hint_match) on CPU tensors: the plain
  tier, equal to hashmatch.hint_hash_match of both packages.
"""
import random
import socket
import threading
import time

import numpy as np
import pytest

from vproxy_tpu_torch.components.elgroup import EventLoopGroup
from vproxy_tpu_torch.components.secgroup import SecurityGroup
from vproxy_tpu_torch.components.servergroup import (HealthCheckConfig,
                                                     ServerGroup)
from vproxy_tpu_torch.components.tcplb import TcpLB
from vproxy_tpu_torch.components.upstream import Upstream
from vproxy_tpu_torch.rules.ir import AclRule, HintRule, Proto
from vproxy_tpu_torch.utils import lifecycle
from vproxy_tpu_torch.utils.events import FlightRecorder
from vproxy_tpu_torch.utils.ip import Network
from vproxy_tpu_torch.utils.metrics import GlobalInspection


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
    """The port's matchers on the CPU (its entry points default to the
    card), installs unpaced."""
    monkeypatch.setenv("VPROXY_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("VPROXY_TPU_INSTALL_PACE", "0")


class IdServer:
    """Accepts; on HTTP request replies with its id; raw mode sends id then
    echoes."""

    def __init__(self, sid: str, http: bool = False):
        self.sid = sid.encode()
        self.http = http
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(64)
        self.port = self.sock.getsockname()[1]
        self.hits = 0
        self.alive = True
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while self.alive:
            try:
                c, _ = self.sock.accept()
            except OSError:
                return
            self.hits += 1
            threading.Thread(target=self._conn, args=(c,), daemon=True).start()

    def _conn(self, c):
        try:
            if self.http:
                data = b""
                while b"\r\n\r\n" not in data and b"\n\n" not in data:
                    d = c.recv(65536)
                    if not d:
                        break
                    data += d
                body = self.sid
                c.sendall(b"HTTP/1.1 200 OK\r\ncontent-length: %d\r\n\r\n%s"
                          % (len(body), body))
                c.close()
            else:
                c.sendall(self.sid)
                while True:
                    d = c.recv(65536)
                    if not d:
                        break
                    c.sendall(d)
                c.close()
        except OSError:
            pass

    def close(self):
        self.alive = False
        try:
            self.sock.close()
        except OSError:
            pass


@pytest.fixture
def stack():
    elgs = []
    lbs = []
    servers = []
    groups = []

    def make(n_workers=1):
        elg = EventLoopGroup("w", n_workers)
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


def fast_hc():
    return HealthCheckConfig(timeout_ms=500, period_ms=100, up=1, down=1)


def wait_healthy(group, n, timeout=5.0):
    t0 = time.time()
    while sum(1 for s in group.servers if s.healthy) < n:
        if time.time() - t0 > timeout:
            raise TimeoutError(f"only {[s.healthy for s in group.servers]}")
        time.sleep(0.02)


def tcp_get_id(port):
    c = socket.create_connection(("127.0.0.1", port), timeout=5)
    c.settimeout(5)
    sid = c.recv(100)
    c.close()
    return sid.decode()


def http_get_id(port, host, path="/"):
    c = socket.create_connection(("127.0.0.1", port), timeout=5)
    c.settimeout(5)
    c.sendall(b"GET %s HTTP/1.1\r\nhost: %s\r\nconnection: close\r\n\r\n"
              % (path.encode(), host.encode()))
    data = b""
    while b"\r\n\r\n" not in data:
        d = c.recv(65536)
        if not d:
            break
        data += d
    head, _, body = data.partition(b"\r\n\r\n")
    # read remaining body
    while True:
        try:
            d = c.recv(65536)
        except socket.timeout:
            break
        if not d:
            break
        body += d
    c.close()
    return head.split(b"\r\n")[0].decode(), body.decode()


def test_tcp_mode_wrr_distribution(stack):
    elg = stack["make_elg"](1)
    s1, s2 = IdServer("A"), IdServer("B")
    stack["servers"] += [s1, s2]
    g = ServerGroup("g", elg, fast_hc(), "wrr")
    stack["groups"].append(g)
    g.add("a", "127.0.0.1", s1.port, weight=2)
    g.add("b", "127.0.0.1", s2.port, weight=1)
    wait_healthy(g, 2)
    ups = Upstream("u")
    ups.add(g)
    lb = TcpLB("lb", elg, elg, "127.0.0.1", 0, ups, protocol="tcp")
    stack["lbs"].append(lb)
    lb.start()
    ids = [tcp_get_id(lb.bind_port) for _ in range(12)]
    assert ids.count("A") == 8 and ids.count("B") == 4  # 2:1 WRR
    assert lb.accepted == 12


def test_session_and_connection_listing(stack):
    """ResourceType sess/conn/ss: a live spliced session is observable
    with its front/back addresses and byte counters, through the port's
    command grammar as the reference reads it through its own."""
    from vproxy_tpu_torch.control.app import Application
    from vproxy_tpu_torch.control.command import Command

    # split acceptor/worker groups: the session lives on a WORKER loop,
    # which the listing must still reach (not just the acceptor loops)
    elg = stack["make_elg"](1)
    elg_w = stack["make_elg"](1)
    s1 = IdServer("S")
    stack["servers"].append(s1)
    g = ServerGroup("g", elg, fast_hc(), "wrr")
    stack["groups"].append(g)
    g.add("a", "127.0.0.1", s1.port, weight=1)
    wait_healthy(g, 1)
    ups = Upstream("u")
    ups.add(g)
    lb = TcpLB("lb", elg, elg_w, "127.0.0.1", 0, ups, protocol="tcp")
    stack["lbs"].append(lb)
    lb.start()

    app = Application.create(workers=1)
    try:
        app.tcp_lbs["lb"] = lb
        c = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
        c.settimeout(5)
        assert c.recv(10) == b"S"
        deadline = time.time() + 15
        rows = []
        while time.time() < deadline:
            rows = Command.execute(app, "list-detail session in tcp-lb lb")
            if rows:
                break
            time.sleep(0.02)
        assert len(rows) == 1, rows
        assert f"-> 127.0.0.1:{s1.port}" in rows[0]
        assert "bytes-in" in rows[0]
        assert Command.execute(app, "list session in tcp-lb lb") == ["1"]
        conns = Command.execute(app, "list-detail connection in tcp-lb lb")
        assert len(conns) == 2 and f"{lb.bind_ip}:{lb.bind_port}" in conns[0]
        socks = Command.execute(app, "list-detail server-sock in tcp-lb lb")
        assert socks == [
            f"127.0.0.1:{lb.bind_port} -> loop {elg.loops[0].name}"]
        c.close()
        deadline = time.time() + 15
        while time.time() < deadline and lb.active_sessions:
            time.sleep(0.02)
        assert Command.execute(app, "list session in tcp-lb lb") == ["0"]
    finally:
        app.tcp_lbs.pop("lb", None)
        app.close()


def test_http_mode_host_rule_routing(stack):
    elg = stack["make_elg"](1)
    sa, sb, sc = IdServer("GA", http=True), IdServer("GB", http=True), IdServer("GC", http=True)
    stack["servers"] += [sa, sb, sc]
    ga = ServerGroup("ga", elg, fast_hc())
    gb = ServerGroup("gb", elg, fast_hc())
    gc = ServerGroup("gc", elg, fast_hc())
    stack["groups"] += [ga, gb, gc]
    ga.add("a", "127.0.0.1", sa.port)
    gb.add("b", "127.0.0.1", sb.port)
    gc.add("c", "127.0.0.1", sc.port)
    for g in (ga, gb, gc):
        wait_healthy(g, 1)
    ups = Upstream("u")
    ups.add(ga, annotations=HintRule(host="a.example.com"))
    ups.add(gb, annotations=HintRule(host="example.com", uri="/api"))
    ups.add(gc)  # no annotations: only reachable via WRR fallback
    lb = TcpLB("lb", elg, elg, "127.0.0.1", 0, ups, protocol="http")
    stack["lbs"].append(lb)
    lb.start()

    status, body = http_get_id(lb.bind_port, "a.example.com")
    assert status.endswith("200 OK") and body == "GA"
    status, body = http_get_id(lb.bind_port, "sub.a.example.com")  # suffix
    assert body == "GA"
    status, body = http_get_id(lb.bind_port, "example.com", "/api/users")
    assert body == "GB"
    # no rule matches -> WRR over all three groups still serves
    status, body = http_get_id(lb.bind_port, "other.org", "/x")
    assert body in ("GA", "GB", "GC")


def test_acl_denies_connection(stack):
    elg = stack["make_elg"](1)
    s1 = IdServer("A")
    stack["servers"].append(s1)
    g = ServerGroup("g", elg, fast_hc())
    stack["groups"].append(g)
    g.add("a", "127.0.0.1", s1.port)
    wait_healthy(g, 1)
    ups = Upstream("u")
    ups.add(g)
    sec = SecurityGroup("deny-lo", default_allow=True)
    lb = TcpLB("lb", elg, elg, "127.0.0.1", 0, ups, protocol="tcp",
               security_group=sec)
    stack["lbs"].append(lb)
    lb.start()
    sec.add_rule(AclRule("no-lo", Network.parse("127.0.0.0/8"), Proto.TCP,
                         1, 65535, False))
    c = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c.settimeout(2)
    assert c.recv(100) == b""  # immediately closed by ACL
    c.close()
    # flip to allow: remove the deny rule
    sec.remove_rule("no-lo")
    assert tcp_get_id(lb.bind_port) == "A"


def test_health_check_failover(stack):
    elg = stack["make_elg"](1)
    s1, s2 = IdServer("A"), IdServer("B")
    stack["servers"] += [s1, s2]
    g = ServerGroup("g", elg, fast_hc(), "wrr")
    stack["groups"].append(g)
    g.add("a", "127.0.0.1", s1.port)
    g.add("b", "127.0.0.1", s2.port)
    wait_healthy(g, 2)
    ups = Upstream("u")
    ups.add(g)
    lb = TcpLB("lb", elg, elg, "127.0.0.1", 0, ups, protocol="tcp")
    stack["lbs"].append(lb)
    lb.start()
    # kill B; after the down edge all traffic goes to A
    s2.close()
    t0 = time.time()
    while any(s.name == "b" and s.healthy for s in g.servers):
        if time.time() - t0 > 5:
            raise TimeoutError("b never went down")
        time.sleep(0.02)
    ids = {tcp_get_id(lb.bind_port) for _ in range(6)}
    assert ids == {"A"}


def test_separate_acceptor_and_worker_groups(stack):
    acceptor = stack["make_elg"](1)
    worker = stack["make_elg"](2)
    s1 = IdServer("A")
    stack["servers"].append(s1)
    g = ServerGroup("g", worker, fast_hc())
    stack["groups"].append(g)
    g.add("a", "127.0.0.1", s1.port)
    wait_healthy(g, 1)
    ups = Upstream("u")
    ups.add(g)
    lb = TcpLB("lb", acceptor, worker, "127.0.0.1", 0, ups, protocol="tcp")
    stack["lbs"].append(lb)
    lb.start()
    assert [tcp_get_id(lb.bind_port) for _ in range(6)] == ["A"] * 6


def test_bind_conflict_raises(stack):
    elg = stack["make_elg"](1)
    s1 = IdServer("A")
    stack["servers"].append(s1)
    g = ServerGroup("g", elg, fast_hc())
    stack["groups"].append(g)
    g.add("a", "127.0.0.1", s1.port)
    ups = Upstream("u")
    ups.add(g)
    lb1 = TcpLB("lb1", elg, elg, "127.0.0.1", 0, ups)
    stack["lbs"].append(lb1)
    lb1.start()
    lb2 = TcpLB("lb2", elg, elg, "127.0.0.1", lb1.bind_port, ups)
    with pytest.raises(OSError):
        lb2.start()


def test_idle_session_timeout(stack):
    elg = stack["make_elg"](1)
    s1 = IdServer("A")
    stack["servers"].append(s1)
    g = ServerGroup("g", elg, fast_hc())
    stack["groups"].append(g)
    g.add("a", "127.0.0.1", s1.port)
    wait_healthy(g, 1)
    ups = Upstream("u")
    ups.add(g)
    lb = TcpLB("lb", elg, elg, "127.0.0.1", 0, ups, protocol="tcp",
               timeout_ms=1500)
    stack["lbs"].append(lb)
    lb.start()
    c = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c.settimeout(10)
    assert c.recv(10) == b"A"
    # go idle: the sweep must kill the spliced session within ~2x timeout
    t0 = time.time()
    assert c.recv(100) == b""  # EOF when the pump is closed
    assert time.time() - t0 < 6
    c.close()
    t0 = time.time()
    while lb.active_sessions and time.time() - t0 < 5:
        time.sleep(0.05)
    assert lb.active_sessions == 0


# ----------------------------------------- drain and overload (the cases
# of tests/test_drain_overload.py)

@pytest.fixture
def _clean():
    lifecycle.reset()
    FlightRecorder.reset()
    yield
    lifecycle.reset()


def _mk_lb(stack, alias, **kw):
    elg = stack["make_elg"](1)
    s1 = IdServer("A")
    stack["servers"].append(s1)
    g = ServerGroup(f"{alias}-g", elg, fast_hc())
    stack["groups"].append(g)
    g.add("a", "127.0.0.1", s1.port)
    wait_healthy(g, 1)
    ups = Upstream(f"{alias}-u")
    ups.add(g)
    lb = TcpLB(alias, elg, elg, "127.0.0.1", 0, ups, protocol="tcp", **kw)
    stack["lbs"].append(lb)
    lb.start()
    return lb


def test_drain_lets_sessions_finish_and_sheds_new(stack, _clean):
    """The reference's case through the port's `drain` command
    (Application.request_drain) and Application.drain_wait."""
    from vproxy_tpu_torch.control.app import Application
    from vproxy_tpu_torch.control.command import Command

    lb = _mk_lb(stack, "lb-drain")
    app = Application.create(workers=1)
    try:
        app.tcp_lbs["lb-drain"] = lb
        # a live echo session that outlives the drain request
        c = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
        c.settimeout(5)
        assert c.recv(10) == b"A"

        drained = []
        app.on_drain_request.append(lambda: drained.append(True))
        assert Command.execute(app, "drain") == "OK"
        assert Command.execute(app, "drain") == "already draining"
        assert drained == [True]
        assert lifecycle.is_draining()
        assert lb.draining and lb.server_socks == []

        # the in-flight session keeps moving bytes through the pump
        c.sendall(b"still-here")
        assert c.recv(64) == b"still-here"

        # new connections are refused (listener closed) or shed on accept
        try:
            c2 = socket.create_connection(("127.0.0.1", lb.bind_port),
                                          timeout=2)
            c2.settimeout(2)
            assert c2.recv(16) == b""
            c2.close()
        except OSError:
            pass  # connection refused: equally fine

        # the live session provably holds the drain open (one sample)...
        assert app.sessions_in_flight() >= 1
        assert app.drain_wait(0) is False
        # ...and releasing it completes the drain within a deadline poll
        c.close()
        assert app.drain_wait(10) is True
        kinds = [e["kind"] for e in FlightRecorder.get().snapshot()]
        assert "drain" in kinds
    finally:
        app.tcp_lbs.pop("lb-drain", None)
        app.close()


def test_overload_guard_sheds_past_max_sessions(stack, _clean):
    lb = _mk_lb(stack, "lb-over", max_sessions=1)
    ctr = GlobalInspection.get().get_counter(
        "vproxy_lb_overload_total", lb="lb-over")
    base = ctr.value()

    c1 = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c1.settimeout(5)
    assert c1.recv(10) == b"A"  # session 1 established (spliced)

    c2 = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    c2.settimeout(5)
    assert c2.recv(16) == b""  # shed close-on-accept, not served
    c2.close()
    assert ctr.value() == base + 1
    assert any(e["kind"] == "overload"
               for e in FlightRecorder.get().snapshot())

    # capacity freed -> accepts flow again
    c1.close()
    deadline = time.time() + 5
    while lb.active_sessions and time.time() < deadline:
        time.sleep(0.02)
    assert tcp_get_id(lb.bind_port) == "A"
    # the shed connection never counted as accepted
    assert lb.accepted == 2
    # that session's teardown runs on the loop after the client saw
    # EOF: wait it out, or it holds one of the two slots below
    deadline = time.time() + 5
    while lb.active_sessions and time.time() < deadline:
        time.sleep(0.02)

    # hot-set like `update tcp-lb ... max-sessions n`
    lb.max_sessions = 2
    c1 = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    assert c1.recv(10) == b"A"
    c2 = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
    assert c2.recv(10) == b"A"
    c1.close()
    c2.close()


def test_drain_then_stop_is_clean(stack, _clean):
    """begin_drain followed by stop() must not double-close listeners or
    wedge; a fresh LB can rebind the same port after."""
    lb = _mk_lb(stack, "lb-dstop")
    port = lb.bind_port
    lb.begin_drain()
    lb.begin_drain()  # idempotent
    lb.stop()
    lb2 = TcpLB("lb-dstop2", lb.acceptor, lb.worker, "127.0.0.1", port,
                lb.backend, protocol="tcp")
    stack["lbs"].append(lb2)
    lb2.start()
    assert tcp_get_id(port) == "A"


# ----------------------------- BASELINE config #1 against both packages

# 8 Host rules on 8 groups: exact hosts (which also match their
# subdomains by suffix), a wildcard host with a uri, a host with a uri;
# each group's one server is one of two loopback backends
BASELINE1_RULES = (
    ("a.example.com", None), ("b.example.com", None),
    ("example.org", None), ("shop.example.net", None),
    ("*", "/static"), ("api.example.com", "/v2"),
    ("c.example.com", None), ("tenant.example.io", None))
BASELINE1_BACKEND = "ABBABAAB"  # group i -> backend id


def baseline1_requests(n: int, seed: int) -> list:
    """(host, path) per request, seeded: exact hosts, subdomains of the
    exact hosts (suffix matches), the wildcard's and the host+uri
    rule's paths, and one in five a host no domain rule names (the
    wildcard host rule answers those)."""
    rnd = random.Random(seed)
    out = []
    for i in range(n):
        host, uri = BASELINE1_RULES[rnd.randrange(len(BASELINE1_RULES))]
        if i % 5 == 4:
            out.append((f"none{i}.example.test", "/x"))
        elif host == "*":
            out.append((f"h{i}.cdn.test", f"{uri}/img{i}.png"))
        elif uri is not None:
            out.append((host, f"{uri}/items/{i}"))
        elif i % 3 == 0:
            out.append((f"x{i}.{host}", "/"))
        else:
            out.append((host, f"/p{i}"))
    return out


def _baseline1_stack(mods, stack, protocol):
    """One package's BASELINE #1 deployment: -> (lb, upstream)."""
    elgroup, servergroup, tcplb, upstream, ir = mods
    elg = elgroup.EventLoopGroup("w", 1)
    backends = {sid: IdServer(sid, http=True) for sid in "AB"}
    stack["servers"] += list(backends.values())
    ups = upstream.Upstream("u1")
    for i, (host, uri) in enumerate(BASELINE1_RULES):
        g = servergroup.ServerGroup(f"g{i}", elg, servergroup.HealthCheckConfig(
            timeout_ms=500, period_ms=100, up=1, down=1), "wrr")
        stack["groups"].append(g)
        g.add("s", "127.0.0.1", backends[BASELINE1_BACKEND[i]].port)
        wait_healthy(g, 1)
        ups.add(g, annotations=ir.HintRule(host=host, uri=uri))
    lb = tcplb.TcpLB("lb1", elg, elg, "127.0.0.1", 0, ups,
                     protocol=protocol)
    stack["lbs"].append(lb)
    stack["elgs"].append(elg)
    lb.start()
    return lb, ups


@pytest.mark.parametrize("protocol,mode", [
    ("http", "auto"), ("http-splice", "auto"), ("http-splice", "device")])
def test_baseline1_routes_like_the_reference(stack, monkeypatch, protocol,
                                             mode):
    """Every request of a seeded list reaches the same backend through
    the reference's LB and the port's, and the same group. The http
    engine (L7) picks per request from the host index; http-splice
    classifies each connection's head through ClassifyService: in
    "auto" mode lone queries take the inline host lane, in "device"
    mode every classify batch goes through the device tier (JAX on the
    reference's side, the torch tier on the CPU here)."""
    from vproxy_tpu.components import elgroup as r_elg
    from vproxy_tpu.components import servergroup as r_sg
    from vproxy_tpu.components import tcplb as r_lb
    from vproxy_tpu.components import upstream as r_up
    from vproxy_tpu.rules import ir as r_ir
    from vproxy_tpu.rules.service import ClassifyService as RefService
    from vproxy_tpu_torch.components import elgroup, servergroup, tcplb
    from vproxy_tpu_torch.components import upstream
    from vproxy_tpu_torch.rules import ir
    from vproxy_tpu_torch.rules.service import ClassifyService
    monkeypatch.setenv("VPROXY_TPU_CLASSIFY", mode)
    ClassifyService.reset()
    RefService.reset()
    try:
        ref_lb, ref_ups = _baseline1_stack(
            (r_elg, r_sg, r_lb, r_up, r_ir), stack, protocol)
        lb, ups = _baseline1_stack(
            (elgroup, servergroup, tcplb, upstream, ir), stack, protocol)
        for host, path in baseline1_requests(40, seed=1):
            _, want = http_get_id(ref_lb.bind_port, host, path)
            _, got = http_get_id(lb.bind_port, host, path)
            assert got == want, (host, path)
            rg = ref_ups.search_for_group(r_ir.Hint.of_host_uri(host, path))
            g = ups.search_for_group(ir.Hint.of_host_uri(host, path))
            assert (None if g is None else g.alias) == \
                (None if rg is None else rg.alias), (host, path)
            if g is not None:
                assert got == BASELINE1_BACKEND[int(g.alias[1:])], (host,
                                                                    path)
        if mode == "device":
            st = ClassifyService.get().stats
            assert st.device_queries > 0 and st.failovers == 0
    finally:
        ClassifyService.reset()
        RefService.reset()


def test_tcplb_sni_only_picks_match_the_reference():
    """The TLS LB's hint is the SNI alone (Hint.of_host): over config
    #2's rules and chip_smoke.py's TLS requests, the port's host index
    and oracle give every SNI the rule the reference's give, and a
    request aimed at a host+uri rule answers as its host-only hint does
    (the uri is not seen) in both packages."""
    from vproxy_tpu.rules import index as r_index
    from vproxy_tpu.rules import oracle as r_oracle
    from vproxy_tpu.rules.ir import Hint as RHint
    from vproxy_tpu.rules.ir import HintRule as RHintRule
    from vproxy_tpu_torch.rules import index, oracle
    from vproxy_tpu_torch.rules.ir import Hint

    import chip_smoke as CS
    rules = CS.tcplb_rules(2000, CS.TCPLB_RULE_SEED)
    r_rules = [RHintRule(host=r.host, uri=r.uri) for r in rules]
    reqs = CS.tcplb_requests(rules, 2000, CS.TLS_REQ_SEED)
    hi, r_hi = index.HintIndex(rules), r_index.HintIndex(r_rules)
    uri_aimed = 0
    for host, path in reqs:
        got = oracle.search(rules, Hint.of_host(host))
        assert got == hi.lookup(Hint.of_host(host)) == \
            r_oracle.search(r_rules, RHint.of_host(host)) == \
            r_hi.lookup(RHint.of_host(host)), host
        full = oracle.search(rules, Hint.of_host_uri(host, path))
        if full >= 0 and rules[full].uri is not None:
            uri_aimed += 1
            assert got == full, (host, path)
    assert uri_aimed > 0


def test_chip_smoke_tcplb_phase_on_cpu():
    """chip_smoke.py's TcpLB phase at a small size on the CPU: the
    backend and client processes, both LBs, the ACL and the Upstream
    build, every answer checked against the port's host index, and
    ClassifyService's hint and cidr kinds batching on the device path
    (the plain tiers here: no kernel launches)."""
    import torch

    import chip_smoke as CS
    out = CS.phase_tcplb(torch.device("cpu"), max_rules=64, bursts=2,
                         burst=24, keepalive=4, n_acl=200, https=8)
    assert out["rules"] == 64 and out["splice_connections"] == 48
    # the TLS LBs: lb-tls on the native pump (every SNI a hint query,
    # every connection a native handshake), then on the MemoryBIO
    # plane, then lb-https; every accept an ACL query
    tls = out["tls"]
    for plane, n, hint, hs in (("native", 48, 48, 48),
                               ("memorybio", 48, 0, 0), ("https", 8, 0, 0)):
        t = tls[plane]
        assert t["connections"] == n and 0 < t["matched"] <= n, plane
        assert t["handshakes"] == hs, plane
        assert t["queries"] == {"hint": hint, "cidr": n}, plane
        assert t["device_queries"] == hint + n, plane
        assert t["batches"]["cidr"] > 0 and (t["batches"]["hint"] > 0) == \
            (hint > 0), plane
        assert set(t["launches"].values()) == {0}, plane
    assert 0 < out["keepalive_matched"] < out["keepalive_requests"] == 16
    assert 0 < out["splice_matched"] < 48
    assert out["batches"]["hint"]["batches"] > 0
    assert out["batches"]["cidr"]["batches"] > 0
    assert out["launches"] == {"hint_match": 0, "cidr_first": 0,
                               "fused_classify_pick": 0}
    assert out["failovers"] == 0 and out["provider"] == "native"
    path = out["b3_on_path"]
    assert path["requests"] == 48 + 16 and 0 < path["misses"] < 64
    assert path["batches"] > 0 and path["max_abs_err"] == 0
