"""The port's DNS server (vproxy_tpu_torch/dns/server.py) against the
reference's, the matchers on the CPU.

* the 6 cases of tests/test_dns.py (the codec round trip and its
  compression pointers, DNS-as-LB answers, the answer cache and its
  health invalidation, recursion to a fake upstream resolver, the
  `*.vproxy.local` introspection), each run on both packages (`pkg`);
  the codec cases also hold the two packages' encodings byte-equal;
* one Upstream and one seeded query list through both packages'
  DNSServer: every response datagram byte-equal;
* the queue case of tests/test_service.py::test_dns_query_rides_the_
  queue, on the port with its ClassifyService in "device" mode, against
  a live loopback backend (see its docstring).
"""
import importlib
import random
import socket
import struct
import threading
import time

import pytest

from test_torch_tcplb import _torch_cpu, IdServer, wait_healthy  # noqa: F401

PKGS = ("vproxy_tpu", "vproxy_tpu_torch")
IDS = ("ref", "port")


def mod(pkg: str, name: str):
    """`pkg`'s module `name` (e.g. "dns.server")."""
    return importlib.import_module(f"{pkg}.{name}")


def fast_hc(pkg: str):
    SG = mod(pkg, "components.servergroup")
    return SG.HealthCheckConfig(timeout_ms=500, period_ms=100, up=1, down=1)


def dns_query(P, port, name, qtype=None, timeout=3, qid=99):
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.settimeout(timeout)
    pkt = P.Packet(id=qid, rd=True,
                   questions=[P.Question(name, P.A if qtype is None
                                         else qtype)])
    s.sendto(pkt.encode(), ("127.0.0.1", port))
    data, _ = s.recvfrom(4096)
    s.close()
    return P.parse(data)


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_codec_roundtrip(pkg):
    P = mod(pkg, "dns.packet")
    parse_ip = mod(pkg, "utils.ip").parse_ip
    pkt = P.Packet(id=0x1234, rd=True,
                   questions=[P.Question("x.example.com.", P.A)])
    enc = pkt.encode()
    back = P.parse(enc)
    assert back.id == 0x1234 and back.questions[0].qname == "x.example.com."
    resp = P.Packet(id=7, is_resp=True, answers=[
        P.Record("a.io.", P.A, ttl=60, rdata=parse_ip("1.2.3.4")),
        P.Record("a.io.", P.AAAA, ttl=60, rdata=parse_ip("fe80::1")),
        P.Record("a.io.", P.CNAME, ttl=60, rdata="b.io."),
        P.Record("a.io.", P.SRV, ttl=60, rdata=(0, 10, 8080, "s1.a.io.")),
        P.Record("a.io.", P.TXT, ttl=60, rdata=[b"hello", b"world"]),
    ])
    back = P.parse(resp.encode())
    assert back.answers[0].rdata == parse_ip("1.2.3.4")
    assert back.answers[1].rdata == parse_ip("fe80::1")
    assert back.answers[2].rdata == "b.io."
    assert back.answers[3].rdata == (0, 10, 8080, "s1.a.io.")
    assert back.answers[4].rdata == [b"hello", b"world"]
    # the other package encodes the same packets to the same bytes
    other = mod(PKGS[1 - PKGS.index(pkg)], "dns.packet")
    assert other.Packet(id=0x1234, rd=True, questions=[
        other.Question("x.example.com.", other.A)]).encode() == enc
    assert other.parse(resp.encode()).encode() == back.encode()


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_codec_compression_pointers(pkg):
    P = mod(pkg, "dns.packet")
    q = P._encode_name("svc.test.")
    hdr = struct.pack(">HHHHHH", 1, 0x8180, 1, 1, 0, 0)
    question = q + struct.pack(">HH", P.A, 1)
    # answer name = pointer to offset 12 (the question name)
    ans = b"\xc0\x0c" + struct.pack(">HHIH", P.A, 1, 30, 4) + bytes([9] * 4)
    pkt = P.parse(hdr + question + ans)
    assert pkt.answers[0].name == "svc.test."
    assert pkt.answers[0].rdata == bytes([9, 9, 9, 9])
    other = mod(PKGS[1 - PKGS.index(pkg)], "dns.packet")
    assert other.parse(hdr + question + ans).encode() == pkt.encode()


@pytest.fixture
def dns_stack(pkg):
    EventLoopGroup = mod(pkg, "components.elgroup").EventLoopGroup
    elg = EventLoopGroup("dns", 1)
    resources = {"elg": elg, "servers": [], "groups": [], "dns": []}
    yield resources
    for d in resources["dns"]:
        d.stop()
    for g in resources["groups"]:
        g.close()
    for s in resources["servers"]:
        s.close()
    time.sleep(0.05)
    elg.close()


def _two_backend_rrsets(pkg, dns_stack, host="svc.corp.local"):
    """A group over two live id-servers (fast health checks) in an
    Upstream with one Host rule. -> (group, upstream, s1, s2)."""
    SG = mod(pkg, "components.servergroup")
    Upstream = mod(pkg, "components.upstream").Upstream
    HintRule = mod(pkg, "rules.ir").HintRule
    elg = dns_stack["elg"]
    s1, s2 = IdServer("A"), IdServer("B")
    dns_stack["servers"] += [s1, s2]
    g = SG.ServerGroup("g", elg, fast_hc(pkg), "wrr")
    dns_stack["groups"].append(g)
    g.add("a", "127.0.0.1", s1.port)
    g.add("b", "127.0.0.1", s2.port)
    wait_healthy(g, 2)
    rr = Upstream("rr")
    rr.add(g, annotations=HintRule(host=host))
    return g, rr, s1, s2


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_dns_server_lb_answers(pkg, dns_stack):
    P = mod(pkg, "dns.packet")
    DNSServer = mod(pkg, "dns.server").DNSServer
    parse_ip = mod(pkg, "utils.ip").parse_ip
    _, rr, s1, s2 = _two_backend_rrsets(pkg, dns_stack)
    d = DNSServer("dns0", dns_stack["elg"].next(), "127.0.0.1", 0, rr,
                  hosts={"pin.corp.local": parse_ip("10.9.9.9")})
    dns_stack["dns"].append(d)
    d.start()

    # rrset hit -> A answer from a healthy backend
    resp = dns_query(P, d.bind_port, "svc.corp.local.")
    assert resp.is_resp and resp.rcode == 0
    assert resp.answers[0].rtype == P.A
    assert resp.answers[0].rdata == parse_ip("127.0.0.1")
    # subdomain (suffix) also matches the hint rule
    resp = dns_query(P, d.bind_port, "x.svc.corp.local.")
    assert resp.answers and resp.answers[0].rdata == parse_ip("127.0.0.1")
    # hosts-file entry wins
    resp = dns_query(P, d.bind_port, "pin.corp.local.")
    assert resp.answers[0].rdata == parse_ip("10.9.9.9")
    # ip literal echo
    resp = dns_query(P, d.bind_port, "4.3.2.1.")
    assert resp.answers[0].rdata == parse_ip("4.3.2.1")
    # SRV lists healthy servers with ports
    resp = dns_query(P, d.bind_port, "svc.corp.local.", P.SRV)
    assert sorted(r.rdata[2] for r in resp.answers) == \
        sorted([s1.port, s2.port])
    # unknown name without recursion -> NXDOMAIN
    resp = dns_query(P, d.bind_port, "nope.example.")
    assert resp.rcode == 3


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_dns_answer_cache_and_health_invalidation(pkg, dns_stack):
    """Repeat queries serve from the packed-answer cache; a backend
    health edge invalidates instantly; distinct query ids get the cached
    bytes re-stamped."""
    P = mod(pkg, "dns.packet")
    DNSServer = mod(pkg, "dns.server").DNSServer
    g, rr, s1, s2 = _two_backend_rrsets(pkg, dns_stack)
    d = DNSServer("dnsc", dns_stack["elg"].next(), "127.0.0.1", 0, rr)
    dns_stack["dns"].append(d)
    d.start()

    r1 = dns_query(P, d.bind_port, "svc.corp.local.", P.SRV)
    assert sorted(rec.rdata[2] for rec in r1.answers) == \
        sorted([s1.port, s2.port])
    hits0 = d.cache_hits
    r2 = dns_query(P, d.bind_port, "svc.corp.local.", P.SRV)
    assert d.cache_hits == hits0 + 1  # served from the packed cache
    assert r2.id == 99 and len(r2.answers) == len(r1.answers)
    # health edge: kill one backend -> cached answer must die with it
    s1.close()
    deadline = time.time() + 5
    while time.time() < deadline and sum(s.healthy for s in g.servers) > 1:
        time.sleep(0.05)
    assert sum(s.healthy for s in g.servers) == 1
    r3 = dns_query(P, d.bind_port, "svc.corp.local.", P.SRV)
    assert [rec.rdata[2] for rec in r3.answers] == [s2.port]


def fake_resolver(P, parse_ip, answer="7.7.7.7", n=1):
    """A loopback UDP resolver answering `n` queries with `answer` (the
    card host has no network, so recursion always goes here). -> (its
    socket, its port)."""
    up = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    up.bind(("127.0.0.1", 0))
    up.settimeout(5)

    def serve():
        for _ in range(n):
            try:
                data, addr = up.recvfrom(4096)
                req = P.parse(data)
                resp = P.Packet(id=req.id, is_resp=True,
                                questions=req.questions,
                                answers=[P.Record(req.questions[0].qname,
                                                  P.A, ttl=5,
                                                  rdata=parse_ip(answer))])
                up.sendto(resp.encode(), addr)
            except OSError:
                return
    threading.Thread(target=serve, daemon=True).start()
    return up, up.getsockname()[1]


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_dns_recursion_via_fake_upstream(pkg, dns_stack):
    P = mod(pkg, "dns.packet")
    DNSServer = mod(pkg, "dns.server").DNSServer
    DNSClient = mod(pkg, "dns.client").DNSClient
    Upstream = mod(pkg, "components.upstream").Upstream
    parse_ip = mod(pkg, "utils.ip").parse_ip
    up, up_port = fake_resolver(P, parse_ip)
    rr = Upstream("rr")
    loop = dns_stack["elg"].next()
    client = DNSClient(loop, [("127.0.0.1", up_port)], timeout_ms=1000)
    d = DNSServer("dns1", loop, "127.0.0.1", 0, rr, recursive_client=client)
    dns_stack["dns"].append(d)
    d.start()
    resp = dns_query(P, d.bind_port, "anything.example.com.")
    assert resp.answers and resp.answers[0].rdata == parse_ip("7.7.7.7")
    up.close()


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_dns_vproxy_local_introspection(pkg):
    """who.am.i answers the requester's address, who.are.you the
    server's; the resource extension resolves a live tcp-lb's bind
    address through the control plane's resolver; the cluster service
    name answers nothing without a cluster node."""
    P = mod(pkg, "dns.packet")
    Application = mod(pkg, "control.app").Application
    Command = mod(pkg, "control.command").Command
    parse_ip = mod(pkg, "utils.ip").parse_ip

    app = Application.create(workers=1)
    try:
        def run(line):
            return Command.execute(app, line)
        run("add upstream ups0")
        run("add server-group sg0 timeout 400 period 200 up 1 down 3 "
            "method wrr")
        run("add server-group sg0 to upstream ups0")
        run("add tcp-lb web address 127.0.0.1:0 upstream ups0")
        run("add dns-server dns0 address 127.0.0.1:0 upstream ups0")
        d = app.dns_servers["dns0"]

        resp = dns_query(P, d.bind_port, "who.am.i.vproxy.local.")
        assert resp.rcode == 0
        assert resp.answers[0].rdata == parse_ip("127.0.0.1")
        resp = dns_query(P, d.bind_port, "who.are.you.vproxy.local.")
        assert resp.answers[0].rdata == parse_ip("127.0.0.1")
        resp = dns_query(P, d.bind_port, "web.tcp-lb.vproxy.local.")
        assert resp.rcode == 0
        assert resp.answers and resp.answers[0].rdata == \
            parse_ip(app.tcp_lbs["web"].bind_ip)
        # unknown resource under .vproxy.local: NOT recursed, empty
        resp = dns_query(P, d.bind_port, "nope.tcp-lb.vproxy.local.")
        assert resp.rcode == 0 and not resp.answers
        resp = dns_query(P, d.bind_port, "cluster.vproxy.local.")
        assert resp.rcode == 0 and not resp.answers
    finally:
        app.close()


# ------------------------------------------------------------ parity

PARITY_RULES = (("svc.corp.local", None), ("api.corp.local", None),
                ("*.wild.test", None), ("web.example.com", "/v1"),
                ("example.com", None))


def parity_queries(seed: int, n: int) -> list:
    """(qname, qtype) per query, seeded: rule hosts and subdomains of
    them (A, AAAA, SRV), a uri-rule's host, IP literals, who.am.i, the
    resource arm, and names no rule holds."""
    rng = random.Random(seed)
    names = ["svc.corp.local.", "x.svc.corp.local.", "api.corp.local.",
             "a.b.wild.test.", "web.example.com.", "deep.example.com.",
             "4.3.2.1.", "::1.", "who.am.i.vproxy.local.",
             "web.tcp-lb.vproxy.local.", "nope.corp.other.",
             "wild.test.", "cluster.vproxy.local."]
    kinds = ("A", "AAAA", "SRV", "A", "A")
    return [(rng.choice(names), rng.choice(kinds)) for _ in range(n)]


def _parity_run(pkg: str, queries: list) -> list:
    """One Application per package: 3 groups of fixed (unreachable,
    health check "none") servers on an Upstream with PARITY_RULES, a
    dns-server and a tcp-lb; every query answered through real UDP.
    -> the response datagrams."""
    P = mod(pkg, "dns.packet")
    Application = mod(pkg, "control.app").Application
    Command = mod(pkg, "control.command").Command
    app = Application.create(workers=1)
    out = []
    try:
        def run(line):
            return Command.execute(app, line)
        run("add upstream u0")
        for gi, (host, uri) in enumerate(PARITY_RULES):
            run(f"add server-group g{gi} timeout 500 period 60000 up 1 "
                "down 1 protocol none")
            for si in range(gi % 3 + 1):
                run(f"add server s{si} to server-group g{gi} address "
                    f"127.0.{gi}.{si + 1}:{8000 + si} weight {10 + si}")
            anno = '{"vproxy/hint-host":"%s"%s}' % (
                host, "" if uri is None else ',"vproxy/hint-uri":"%s"' % uri)
            run(f"add server-group g{gi} to upstream u0 weight 10 "
                f"annotations {anno}")
        run("add tcp-lb web address 127.0.0.1:0 upstream u0")
        run("add dns-server d0 address 127.0.0.1:0 upstream u0 ttl 30")
        for g in app.server_groups.values():
            for s in g.servers:
                assert s.healthy
        port = app.dns_servers["d0"].bind_port
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.settimeout(5)
        for i, (name, kind) in enumerate(queries):
            pkt = P.Packet(id=1000 + i, rd=True,
                           questions=[P.Question(name, getattr(P, kind))])
            s.sendto(pkt.encode(), ("127.0.0.1", port))
            data, _ = s.recvfrom(4096)
            out.append(data.replace(
                socket.inet_aton(app.tcp_lbs["web"].bind_ip), b"LBIP"))
        s.close()
    finally:
        app.close()
    return out


def test_dns_responses_byte_equal_between_packages(monkeypatch):
    """The same operator config (commands) and the same seeded queries
    through both packages' DNSServer: every response datagram is the
    same bytes (answers from the rrsets, the hosts of WRR picks in
    order, SRV lists, literals, the introspection arm, NXDOMAIN). The
    answer cache lives longer than the run: an entry that expired in
    one package's run and not in the other's would move the WRR
    rotation by wall-clock time alone. A group's WRR sequence starts at
    an offset drawn from the process's `random` (servergroup.py, in
    both packages), so each run starts from the same seed."""
    monkeypatch.setenv("VPROXY_TPU_DNS_CACHE_MS", "600000")
    queries = parity_queries(71, 120)
    runs = []
    for pkg in PKGS:
        random.seed(72)
        runs.append(_parity_run(pkg, queries))
    ref, port = runs
    assert len(ref) == len(port) == len(queries)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, (i, queries[i], a, b)
    P = mod("vproxy_tpu_torch", "dns.packet")
    rcodes = {P.parse(b).rcode for b in port}
    assert {0, 3} <= rcodes  # answers and NXDOMAINs both exercised
    assert sum(bool(P.parse(b).answers) for b in port) > len(port) // 2


def test_dns_query_rides_the_queue_device_mode():
    """tests/test_service.py::test_dns_query_rides_the_queue on the
    port: the rrsets lookup of a DNS query goes through ClassifyService
    in "device" mode (the CPU matchers' plain tier here, B3 on the
    card). The reference case points its group at 10.1.2.3:80 with
    fast_hc() (period 100 ms, down=1) and forces the server healthy; the
    health check of that unreachable address can mark it DOWN again
    before the query arrives, and the answer section is then empty.
    Here the server is a live loopback id-server, so the health check
    keeps it UP."""
    from vproxy_tpu_torch.components.elgroup import EventLoopGroup
    from vproxy_tpu_torch.components.servergroup import ServerGroup
    from vproxy_tpu_torch.components.upstream import Upstream
    from vproxy_tpu_torch.dns import packet as P
    from vproxy_tpu_torch.dns.server import DNSServer
    from vproxy_tpu_torch.rules.ir import HintRule
    from vproxy_tpu_torch.rules.service import ClassifyService

    ClassifyService.reset()
    svc = ClassifyService.get()
    svc.mode = "device"
    backend = IdServer("Q")
    elg = EventLoopGroup("w", 1)
    g = ServerGroup("g", elg, fast_hc("vproxy_tpu_torch"), "wrr")
    srv = None
    try:
        g.add("a", "127.0.0.1", backend.port, weight=1)
        wait_healthy(g, 1)
        ups = Upstream("rr")
        ups.add(g, annotations=HintRule(host="web.example.com"))
        srv = DNSServer("dns", elg.next(), "127.0.0.1", 0, ups)
        srv.start()
        q0 = svc.stats.device_queries
        resp = dns_query(P, srv.bind_port, "web.example.com.", qid=7,
                         timeout=5)
        assert resp.id == 7 and resp.answers
        assert resp.answers[0].rdata == bytes([127, 0, 0, 1])
        assert svc.stats.queries >= 1
        assert svc.stats.device_queries > q0
        assert svc.stats.failovers == 0
    finally:
        if srv is not None:
            srv.stop()
        g.close()
        elg.close()
        backend.close()
        ClassifyService.reset()
