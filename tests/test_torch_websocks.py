"""The port's WebSocks (vproxy_tpu_torch/websocks/) against the
reference's: the 8 cases of tests/test_websocks.py (the agent's SOCKS5
front through the server over TCP and over KCP, the HTTP CONNECT
front, a direct rule, the fake page and an auth refusal, the PAC
endpoint, DomainChecker, the auth hash's minute window) and the 10 of
tests/test_websocks_tls.py (wss through the TLS front, garbage on it,
the SNI relay, the ClientHello parser, DomainBinder's leases, the
direct relay, the shadowsocks front twice, the agent's DNS, a failed
certificate check), each run on both packages; then the cross-package
checks, bytes equal: a port agent through a reference server and a
reference agent through a port server, over TCP and over KCP; the auth
header and its verdicts, the WebSocket frame helpers and DomainChecker's
verdicts over a seeded host list, equal in both packages."""
import base64
import os
import socket
import ssl
import struct
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_dns import IDS, PKGS, fast_hc, mod
from test_torch_tcplb import IdServer, _torch_cpu  # noqa: F401

USERS = {"alice": "p4ssw0rd"}
SELF_DOMAIN = "ws.example.com"


def pkg_ns(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(
        pkg=pkg, common=mod(pkg, "websocks.common"),
        agent=mod(pkg, "websocks.agent"), server=mod(pkg, "websocks.server"),
        tls=mod(pkg, "websocks.tls_relay"),
        certkey=mod(pkg, "components.certkey"))


@pytest.fixture(params=PKGS, ids=IDS)
def X(request):
    return pkg_ns(request.param)


def wait_for(cond, timeout=5.0, msg="condition"):
    """Poll cond() until it holds; TimeoutError at the deadline."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(msg)
        time.sleep(0.01)


class Stack:
    """Event loop groups per package, and everything to close."""

    def __init__(self):
        self.elgs = {}
        self.close = []

    def elg(self, pkg):
        if pkg not in self.elgs:
            self.elgs[pkg] = mod(pkg, "components.elgroup").EventLoopGroup(
                "ws", 2)
        return self.elgs[pkg]

    def server(self, pkg, **kw):
        S = mod(pkg, "websocks.server")
        srv = S.WebSocksProxyServer("ws", self.elg(pkg).next(), "127.0.0.1",
                                    0, USERS, **kw)
        srv.start()
        self.close.append(srv.stop)
        return srv

    def agent(self, pkg, port, kcp=False, ref_kw=None, wait=True, **kw):
        A = mod(pkg, "websocks.agent")
        ref = A.WebSocksServerRef("127.0.0.1", port, "alice", "p4ssw0rd",
                                  kcp=kcp, **(ref_kw or {}))
        agent = A.WebSocksProxyAgent(self.elg(pkg), [ref], hc=fast_hc(pkg),
                                     **kw)
        self.close.append(agent.close)
        if wait:
            wait_for(lambda: all(s.healthy for s in agent.group.servers),
                     msg="server hc")
        return agent

    def target(self, tag):
        t = IdServer(tag)
        self.close.append(t.close)
        return t


@pytest.fixture
def stack():
    st = Stack()
    yield st
    for c in reversed(st.close):
        try:
            c()
        except Exception:
            pass
    for elg in st.elgs.values():
        elg.close()


def recv_all(c, want=None) -> bytes:
    """Read until EOF, a timeout, or `want` bytes."""
    data = b""
    try:
        while want is None or len(data) < want:
            d = c.recv(65536)
            if not d:
                break
            data += d
    except (socket.timeout, OSError):
        pass
    return data


def socks5_fetch(port, host, target_port, payload=b"hello", want=None):
    """Minimal socks5 client: CONNECT host:port, send payload, read."""
    c = socket.create_connection(("127.0.0.1", port), timeout=5)
    c.settimeout(5)
    c.sendall(b"\x05\x01\x00")
    assert c.recv(2) == b"\x05\x00"
    hb = host.encode()
    c.sendall(b"\x05\x01\x00\x03" + bytes([len(hb)]) + hb +
              struct.pack(">H", target_port))
    rep = c.recv(10)
    assert rep[:2] == b"\x05\x00", rep
    c.sendall(payload)
    data = recv_all(c, want)
    c.close()
    return data


# ------------------------------------------------------- test_websocks.py


def test_agent_to_server_over_tcp(X, stack):
    target = stack.target("T")
    srv = stack.server(X.pkg)
    agent = stack.agent(X.pkg, srv.bind_port)
    got = socks5_fetch(agent.socks_port, "127.0.0.1", target.port, b"ping",
                       want=5)
    assert got == b"Tping"
    assert srv.tunneled == 1


def test_agent_to_server_over_kcp(X, stack):
    target = stack.target("K")
    srv = stack.server(X.pkg, kcp=True)
    agent = stack.agent(X.pkg, srv.bind_port, kcp=True)
    got = socks5_fetch(agent.socks_port, "127.0.0.1", target.port, b"ping",
                       want=5)
    assert got == b"Kping"


def test_http_connect_front(X, stack):
    target = stack.target("H")
    srv = stack.server(X.pkg)
    agent = stack.agent(X.pkg, srv.bind_port, http_connect_port=0)
    c = socket.create_connection(("127.0.0.1", agent.http_connect_port),
                                 timeout=5)
    c.settimeout(5)
    c.sendall(f"CONNECT 127.0.0.1:{target.port} HTTP/1.1\r\n"
              f"host: x\r\n\r\n".encode())
    head = b""
    while b"\r\n\r\n" not in head:
        head += c.recv(4096)
    assert b" 200 " in head
    # early tunnel bytes (the IdServer id) may coalesce with the reply
    head, _, data = head.partition(b"\r\n\r\n")
    c.sendall(b"yo")
    data += recv_all(c, 3 - len(data))
    c.close()
    assert data == b"Hyo"


def test_direct_rule_bypasses_proxy(X, stack):
    target = stack.target("D")
    srv = stack.server(X.pkg)
    # only *.proxied.example goes through the server
    agent = stack.agent(X.pkg, srv.bind_port,
                        proxy_rules=("proxied.example",))
    got = socks5_fetch(agent.socks_port, "127.0.0.1", target.port, b"x",
                       want=2)
    assert got == b"Dx"
    assert srv.tunneled == 0  # server untouched: direct connect


def test_fake_page_and_auth_reject(X, stack):
    srv = stack.server(X.pkg)
    c = socket.create_connection(("127.0.0.1", srv.bind_port), timeout=5)
    c.settimeout(5)
    c.sendall(b"GET / HTTP/1.1\r\nhost: x\r\nconnection: close\r\n\r\n")
    data = recv_all(c)
    c.close()
    assert b"200 OK" in data and b"Welcome" in data

    c = socket.create_connection(("127.0.0.1", srv.bind_port), timeout=5)
    c.settimeout(5)
    bad = base64.b64encode(b"alice:wrong").decode()
    c.sendall((f"GET / HTTP/1.1\r\nUpgrade: websocket\r\n"
               f"Connection: Upgrade\r\nHost: x\r\n"
               f"Sec-WebSocket-Key: abcd\r\nSec-WebSocket-Version: 13\r\n"
               f"Sec-WebSocket-Protocol: socks5\r\n"
               f"Authorization: Basic {bad}\r\n\r\n").encode())
    head = b""
    while b"\r\n\r\n" not in head:
        d = c.recv(4096)
        if not d:
            break
        head += d
    c.close()
    assert b" 401 " in head


def test_pac_endpoint(X, stack):
    srv = stack.server(X.pkg)
    agent = stack.agent(X.pkg, srv.bind_port, pac_port=0)
    c = socket.create_connection(("127.0.0.1", agent.pac_port), timeout=5)
    c.settimeout(5)
    c.sendall(b"GET /pac HTTP/1.1\r\nhost: x\r\nconnection: close\r\n\r\n")
    data = recv_all(c)
    c.close()
    assert b"FindProxyForURL" in data
    assert str(agent.socks_port).encode() in data


def test_domain_checker_rules(X):
    c = X.agent.DomainChecker(["corp.example", ":8443", "/^internal-/"])
    assert c.needs_proxy("a.corp.example", 80)
    assert c.needs_proxy("corp.example", 80)
    assert not c.needs_proxy("corpXexample", 80)
    assert not c.needs_proxy("other.com", 80)
    assert c.needs_proxy("other.com", 8443)
    assert c.needs_proxy("internal-db", 5432)
    assert X.agent.DomainChecker(["*"]).needs_proxy("anything", 1)


def test_auth_hash_minute_window(X):
    common = X.common
    now = int(time.time() * 1000) // 60_000 * 60_000
    hdr = common.auth_header("alice", "p4ssw0rd", minute_ms=now - 60_000)
    assert common.validate_auth(hdr, USERS) == "alice"
    hdr_old = common.auth_header("alice", "p4ssw0rd",
                                 minute_ms=now - 180_000)
    assert common.validate_auth(hdr_old, USERS) is None
    assert common.validate_auth("Basic garbage!!", USERS) is None


# --------------------------------------------------- test_websocks_tls.py


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    """Self-signed cert for ws.example.com via the cryptography lib."""
    pytest.importorskip("cryptography")  # optional dep: skip, not error
    from datetime import datetime, timedelta, timezone

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    d = tmp_path_factory.mktemp("certs")
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, SELF_DOMAIN)])
    now = datetime.now(timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - timedelta(days=1))
            .not_valid_after(now + timedelta(days=365))
            .add_extension(x509.SubjectAlternativeName(
                [x509.DNSName(SELF_DOMAIN)]), critical=False)
            .sign(key, hashes.SHA256()))
    cp, kp = str(d / "cert.pem"), str(d / "key.pem")
    with open(cp, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    with open(kp, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption()))
    return cp, kp


def mk_tls_front(X, stack, srv, certs, **kw):
    holder = X.certkey.CertKeyHolder([X.certkey.CertKey("ck", *certs)])
    front = X.tls.WebSocksTlsFrontend(srv, holder, "127.0.0.1", 0,
                                      self_domains=[SELF_DOMAIN], **kw)
    front.start()
    stack.close.append(front.stop)
    return front


def test_wss_agent_through_tls_server(X, stack, certs):
    target = stack.target("S")
    srv = stack.server(X.pkg)
    front = mk_tls_front(X, stack, srv, certs)
    agent = stack.agent(X.pkg, front.bind_port, ref_kw=dict(
        tls=True, tls_verify=False, tls_sni=SELF_DOMAIN))
    got = socks5_fetch(agent.socks_port, "127.0.0.1", target.port, b"ping",
                       want=5)
    assert got == b"Sping"
    assert front.terminated >= 1
    assert srv.tunneled == 1


def test_tls_front_rejects_garbage(X, stack, certs):
    srv = stack.server(X.pkg)
    front = mk_tls_front(X, stack, srv, certs)
    c = socket.create_connection(("127.0.0.1", front.bind_port), timeout=3)
    c.sendall(b"GET / HTTP/1.1\r\n\r\n")  # not a ClientHello
    c.settimeout(3)
    assert c.recv(100) == b""  # closed
    c.close()


def craft_client_hello(sni: str) -> bytes:
    """Real ClientHello bytes from the ssl library (MemoryBIO client)."""
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    bin_, bout = ssl.MemoryBIO(), ssl.MemoryBIO()
    obj = ctx.wrap_bio(bin_, bout, server_side=False, server_hostname=sni)
    try:
        obj.do_handshake()
    except ssl.SSLWantReadError:
        pass
    return bout.read()


def test_sni_relay_to_foreign_site(X, stack, certs):
    """SNI not ours -> raw TCP relay to (sni, relay_port): the probe
    sees the foreign site's bytes, not our server."""
    foreign = stack.target("F")  # raw mode: sends id then echoes

    def resolve(loop, host, cb):
        cb("127.0.0.1" if host == "other.example.com" else None)

    srv = stack.server(X.pkg, resolve=resolve)
    front = mk_tls_front(X, stack, srv, certs, relay_port=foreign.port)
    ch = craft_client_hello("other.example.com")
    c = socket.create_connection(("127.0.0.1", front.bind_port), timeout=5)
    c.settimeout(5)
    c.sendall(ch)
    assert recv_all(c, 1 + len(ch)) == b"F" + ch
    assert front.relayed == 1
    c.close()


def test_parse_client_hello_sni(X):
    parse = X.tls.parse_client_hello_sni
    ch = craft_client_hello("x.example.org")
    assert parse(ch) == ("ok", "x.example.org")
    assert parse(ch[:20])[0] == "need"
    assert parse(b"GET / HTTP/1.1\r\n")[0] == "bad"


def test_domain_binder_lease_cycle(X):
    b = X.tls.DomainBinder(ttl_s=0.2)
    ip1 = b.bind("a.example.com")
    assert ip1.startswith("127.")
    assert b.bind("a.example.com") == ip1  # stable lease
    ip2 = b.bind("b.example.com")
    assert ip2 != ip1
    assert b.lookup_ip(ip1) == "a.example.com"
    assert b.lookup_ip("127.64.99.99") is None
    time.sleep(0.25)  # the ttl passes (a lookup would refresh it)
    assert b.lookup_ip(ip2) is None  # expired


def test_direct_relay_through_websocks(X, stack):
    target = stack.target("D")

    def resolve(loop, host, cb):
        cb("127.0.0.1" if host == "echo.example.com" else None)

    srv = stack.server(X.pkg, resolve=resolve)
    agent = stack.agent(X.pkg, srv.bind_port)
    binder = X.tls.DomainBinder()
    fake_ip = binder.bind("echo.example.com")
    relay = X.tls.DirectRelayServer(agent, binder, bind_port=0,
                                    target_port=target.port)
    relay.start()
    stack.close.append(relay.stop)
    # the OS connects to the fake IP (the whole 127/8 is loopback-local)
    c = socket.create_connection((fake_ip, relay.bind_port), timeout=5)
    c.settimeout(5)
    c.sendall(b"ping")
    assert recv_all(c, 5) == b"Dping"
    assert relay.relayed == 1
    assert srv.tunneled == 1
    c.close()


def ss_session(ss, key, port, first: bytes, want: int) -> bytes:
    """Encrypt `first` behind a fresh IV, then read and decrypt `want`
    bytes of the answer (its own IV first)."""
    iv = os.urandom(16)
    enc = ss.CfbStream(key, iv, encrypt=True)
    c = socket.create_connection(("127.0.0.1", port), timeout=5)
    c.settimeout(5)
    c.sendall(iv + enc.update(first))
    raw = recv_all(c, 16 + want)
    c.close()
    if len(raw) < 16:
        return b""
    return ss.CfbStream(key, raw[:16], encrypt=False).update(raw[16:])


def test_ss_server_end_to_end(X, stack):
    pytest.importorskip("cryptography")  # ss ciphers use AES-CFB
    ss = mod(X.pkg, "websocks.ss")
    target = stack.target("Z")
    srv = ss.SSServer("ss", stack.elg(X.pkg).next(), "127.0.0.1", 0,
                      "sspass")
    srv.start()
    stack.close.append(srv.stop)
    key = ss.evp_bytes_to_key("sspass")
    addr = b"\x01\x7f\x00\x00\x01" + struct.pack(">H", target.port)
    assert ss_session(ss, key, srv.bind_port, addr + b"ping", 5) == b"Zping"


def test_ss_domain_addr_and_badtype(X, stack):
    pytest.importorskip("cryptography")  # ss ciphers use AES-CFB
    ss = mod(X.pkg, "websocks.ss")
    target = stack.target("Y")

    def resolve(loop, host, cb):
        cb("127.0.0.1" if host == "y.example.com" else None)

    srv = ss.SSServer("ss", stack.elg(X.pkg).next(), "127.0.0.1", 0, "pw2",
                      resolve=resolve)
    srv.start()
    stack.close.append(srv.stop)
    key = ss.evp_bytes_to_key("pw2")
    host = b"y.example.com"
    addr = b"\x03" + bytes([len(host)]) + host + struct.pack(">H",
                                                             target.port)
    assert ss_session(ss, key, srv.bind_port, addr + b"hi", 3) == b"Yhi"
    # bad atyp: server closes the session
    c2 = socket.create_connection(("127.0.0.1", srv.bind_port), timeout=3)
    iv2 = os.urandom(16)
    c2.sendall(iv2 + ss.CfbStream(key, iv2, encrypt=True).update(
        b"\x09junk"))
    c2.settimeout(3)
    assert c2.recv(100) == b""
    c2.close()


def test_agent_dns_fake_and_upstream(X, stack):
    P = mod(X.pkg, "dns.packet")
    AD = mod(X.pkg, "websocks.agentdns")
    checker = X.agent.DomainChecker(["example.com"])  # suffix rule
    binder = X.tls.DomainBinder()
    dns = AD.AgentDNSServer(
        "adns", stack.elg(X.pkg).next(), "127.0.0.1", 0, checker, binder,
        resolve=lambda d, t: ["9.9.9.9"] if t == P.A else [])
    dns.start()
    stack.close.append(dns.stop)

    def ask(name, qtype):
        q = P.Packet(id=7, questions=[P.Question(qname=name + ".",
                                                 qtype=qtype)])
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.settimeout(5)
        s.sendto(q.encode(), ("127.0.0.1", dns.bind_port))
        data, _ = s.recvfrom(4096)
        s.close()
        return P.parse(data)

    r = ask("web.example.com", P.A)  # proxied -> fake IP in the binder
    assert r.rcode == 0 and len(r.answers) == 1
    fake = socket.inet_ntoa(bytes(r.answers[0].rdata))
    assert binder.lookup_ip(fake) == "web.example.com"
    r = ask("web.example.com", P.AAAA)  # empty NOERROR (v4 fallback)
    assert r.rcode == 0 and not r.answers
    r = ask("other.net", P.A)  # non-proxied -> upstream, cached
    assert r.rcode == 0
    assert socket.inet_ntoa(bytes(r.answers[0].rdata)) == "9.9.9.9"
    assert dns.upstream_answers >= 1
    r2 = ask("other.net", P.A)
    assert socket.inet_ntoa(bytes(r2.answers[0].rdata)) == "9.9.9.9"


def test_wss_cert_verify_failure_fails_fast(X, stack, certs):
    """tls_verify=True against a self-signed cert: the TLS handshake
    fails before the websocks handshake starts; the front still gets a
    socks failure reply, not a hang."""
    srv = stack.server(X.pkg)
    front = mk_tls_front(X, stack, srv, certs)
    agent = stack.agent(X.pkg, front.bind_port, ref_kw=dict(
        tls=True, tls_verify=True, tls_sni=SELF_DOMAIN))
    c = socket.create_connection(("127.0.0.1", agent.socks_port), timeout=5)
    c.settimeout(5)
    c.sendall(b"\x05\x01\x00")
    assert c.recv(2) == b"\x05\x00"
    c.sendall(b"\x05\x01\x00\x01\x7f\x00\x00\x01" + struct.pack(">H", 1))
    rep = c.recv(10)  # must answer (failure), not hang
    assert rep[:2] == b"\x05\x05", rep
    c.close()


# --------------------------------------------------------- cross-package


@pytest.mark.parametrize("kcp", [False, True], ids=["tcp", "kcp"])
@pytest.mark.parametrize("agent_pkg", PKGS, ids=["ref-agent", "port-agent"])
def test_agent_and_server_across_packages(stack, agent_pkg, kcp):
    """One package's agent through the other package's server: 8
    concurrent SOCKS5 CONNECTs, each echoing a seeded 32 KiB, byte for
    byte, and the server counts every tunnel."""
    server_pkg = PKGS[1 - PKGS.index(agent_pkg)]
    target = stack.target("E")
    srv = stack.server(server_pkg, kcp=kcp)
    agent = stack.agent(agent_pkg, srv.bind_port, kcp=kcp)
    rng = np.random.default_rng(23 + kcp)
    payloads = [rng.integers(0, 256, 32 * 1024, dtype=np.uint8).tobytes()
                for _ in range(8)]
    out = [None] * len(payloads)

    def one(i):
        out[i] = socks5_fetch(agent.socks_port, "127.0.0.1", target.port,
                              payloads[i], want=1 + len(payloads[i]))
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert out == [b"E" + p for p in payloads]
    assert srv.tunneled == len(payloads)


def seeded_hosts(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    words = ["corp", "example", "internal-db", "a", "cdn", "api", "x1"]
    tlds = ["com", "net", "example", "io"]
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 4))
        out.append((".".join(words[int(i)] for i in
                             rng.integers(0, len(words), k)) + "." +
                    tlds[int(rng.integers(0, len(tlds)))],
                    int(rng.choice([80, 443, 8443, 5432]))))
    return out


def test_auth_and_domain_checker_equal_across_packages():
    """Over a seeded host list and seeded minutes: both packages'
    auth headers, validate_auth verdicts (the window's edges among
    them), upgrade requests and responses, frame constants and
    DomainChecker verdicts are equal."""
    ref, port = (pkg_ns(p) for p in PKGS)
    rng = np.random.default_rng(44)
    now = int(time.time() * 1000) // 60_000 * 60_000
    for k in range(64):
        user = f"u{int(rng.integers(0, 1000))}"
        pw = rng.integers(0, 256, 12, dtype=np.uint8).tobytes().hex()
        minute = now - 60_000 * int(rng.integers(-2, 4))
        h = ref.common.auth_header(user, pw, minute_ms=minute)
        assert port.common.auth_header(user, pw, minute_ms=minute) == h
        assert (port.common.password_hash(pw, minute) ==
                ref.common.password_hash(pw, minute))
        users = {user: pw}
        assert (port.common.validate_auth(h, users) ==
                ref.common.validate_auth(h, users))
        key = base64.b64encode(rng.bytes(16)).decode()
        assert port.common.accept_key(key) == ref.common.accept_key(key)
        assert (port.common.upgrade_response(key) ==
                ref.common.upgrade_response(key))
    for name in ("WS_GUID", "MAX_PAYLOAD_FRAME", "PONG_FRAME"):
        assert getattr(port.common, name) == getattr(ref.common, name)
    rules = ["corp.example", ":8443", "/^internal-/", "api.io", "cdn.net"]
    hosts = seeded_hosts(500, 45)
    for rs in (rules, rules[:2], ["*"], []):
        rc, pc = ref.agent.DomainChecker(rs), port.agent.DomainChecker(rs)
        verdicts = [rc.needs_proxy(h, p) for h, p in hosts]
        assert [pc.needs_proxy(h, p) for h, p in hosts] == verdicts
    assert port.server.KCP_CONV == ref.server.KCP_CONV == 0x77736B73


def test_chip_smoke_websocks_phase_on_cpu():
    """chip_smoke.py's `websocks` phase small on the CPU: a server and a
    TCP and a KCP agent as `python -m vproxy_tpu_torch websocks`
    children, 8 + 8 SOCKS5 CONNECTs and 4 HTTP CONNECTs of seeded 16 KiB,
    every byte echoed, the direct-rule host echoing with the server
    down, every child exiting 0 on SIGTERM."""
    import chip_smoke as CS
    out = CS.phase_websocks(n_tcp=8, n_kcp=8, nbytes=16 * 1024, n_http=4)
    assert out["socks5"]["tcp"]["connects"] == 8
    assert out["socks5"]["kcp"]["bytes_echoed"] == 8 * 16 * 1024
    assert out["http_connect"]["connects"] == 4
    assert out["socks5"]["first_byte"]["n"] == 16
    assert out["direct_rule"] == {"echoed": True,
                                  "server_down_refused": True}
    assert set(out["exit_codes"].values()) == {0}
    assert out["not_run"].startswith("the TLS front and shadowsocks")
