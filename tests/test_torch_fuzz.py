"""Parser robustness, port against reference: tests/test_fuzz.py's 14
parsers, each fed the same corpus (`corpus()` copied from
tests/test_fuzz.py, same seeds) in both packages. For every input the
port's parser and the reference's give the same outcome: an equal
parsed value (compared field by field, `canon`), or each raising its
own package's error type of the same name. Any other exception fails
the case, as in tests/test_fuzz.py.

Each CASES entry builds its parser from one package (`pkg`) and returns
the list of outcomes over its inputs; the valid message each corpus is
mutated from is part of the outcome, so both packages fuzz the same
bytes.
"""
import enum
import importlib
import os
import random
import socket
import ssl
import struct
from types import SimpleNamespace

import pytest

from test_torch_dns import IDS, PKGS
from test_torch_tcplb import _torch_cpu, IdServer, wait_healthy  # noqa: F401

FUZZ_N = int(os.environ.get("VPROXY_TPU_FUZZ_N", "400"))


def corpus(valid: bytes, n=None):
    """Random blobs + mutations/truncations of a valid message. Seeded
    from the valid message so each test's corpus is self-contained and a
    failure reproduces when the test runs alone."""
    n = n or FUZZ_N
    rnd = random.Random(20260730 ^ len(valid) ^ (valid[:4] or b"x")[0])
    out = []
    for _ in range(n // 2):
        out.append(bytes(rnd.getrandbits(8)
                         for _ in range(rnd.randint(0, 120))))
    v = bytearray(valid)
    for _ in range(n // 2):
        m = bytearray(v)
        for _ in range(rnd.randint(1, 6)):
            if not m:
                break
            m[rnd.randrange(len(m))] ^= 1 << rnd.randrange(8)
        if rnd.random() < 0.5 and m:
            m = m[: rnd.randrange(len(m))]
        out.append(bytes(m))
    return out


def canon(v, depth: int = 0):
    """A package-independent form of a parsed value: objects become
    (class name, {field: canon}) over their instance fields (callables
    left out), containers recurse, bytes-likes become bytes."""
    if depth > 12:
        return "..."
    if isinstance(v, (bytes, bytearray, memoryview)):
        return bytes(v)
    if v is None or isinstance(v, (str, int, float, bool)):
        return v
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.name)
    if isinstance(v, (list, tuple, set, frozenset, range)):
        items = [canon(x, depth + 1) for x in v]
        return sorted(items, key=repr) if isinstance(
            v, (set, frozenset)) else items
    if isinstance(v, dict):
        return sorted((repr(canon(k, depth + 1)), canon(x, depth + 1))
                      for k, x in v.items())
    if callable(v) and not hasattr(v, "__dict__"):
        return "<callable>"
    fields = dict(getattr(v, "__dict__", {}))
    for slot in getattr(type(v), "__slots__", ()):
        if hasattr(v, slot):
            fields[slot] = getattr(v, slot)
    return (type(v).__name__,
            sorted((k, canon(x, depth + 1)) for k, x in fields.items()
                   if not callable(x) or hasattr(x, "__dict__")))


def outcome(fn, data, *errors):
    """fn(data) -> ("ok", canon(value)) or ("raise", error type name)
    for one of the package's own `errors`; anything else propagates."""
    try:
        v = fn(data)
    except errors as e:
        return ("raise", type(e).__name__)
    return ("ok", canon(v))


def ns(pkg: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")
    return SimpleNamespace(pkg=pkg, m=m)


def _valid_eth(P):
    icmp = P.Icmp(P.ICMP_ECHO_REQ, 0, b"\x00\x01\x00\x01payload")
    ip = P.Ipv4(src=bytes([10, 0, 0, 1]), dst=bytes([10, 0, 0, 2]),
                proto=P.PROTO_ICMP, payload=b"", packet=icmp)
    return P.Ethernet(b"\x02" * 6, b"\x04" * 6, P.ETHER_TYPE_IPV4, b"", ip)


CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


@case
def ethernet_and_ip_stack(X):
    P = X.m("vswitch.packets")
    valid = _valid_eth(P).to_bytes()
    return [valid] + [outcome(P.Ethernet.parse, d, P.PacketError)
                      for d in corpus(valid)]


@case
def vxlan_and_encrypted(X):
    pytest.importorskip("cryptography")  # encrypted frames use AES-CFB
    P = X.m("vswitch.packets")
    valid = P.Vxlan(7, _valid_eth(P)).to_bytes()
    out = [valid] + [outcome(P.Vxlan.parse, d, P.PacketError)
                     for d in corpus(valid)]
    key = bytes(range(32))
    sp = P.VProxySwitchPacket("alice+++", P.VPROXY_TYPE_VXLAN,
                              P.Vxlan(7, _valid_eth(P)))
    valid_enc = sp.to_bytes(lambda u: key)
    # the encryption's IV is random: each package fuzzes its own
    # encrypted message, and the outcomes are compared by kind only
    for d in corpus(valid_enc):
        o = outcome(lambda b: P.VProxySwitchPacket.parse(b, lambda u: key),
                    d, P.PacketError)
        out.append(o[0])
    return out


@case
def tcp_udp_headers(X):
    P = X.m("vswitch.packets")
    src, dst = bytes([10, 0, 0, 1]), bytes([10, 0, 0, 2])
    tcp = P.Tcp(sport=1234, dport=80, seq=1, ack=2, flags=0x18,
                window=1024, data=b"hello").to_bytes(src, dst, False)
    udp = P.Udp(53, 5353, b"x" * 9).to_bytes(src, dst, False)
    return ([tcp] + [outcome(P.Tcp.parse, d, P.PacketError)
                     for d in corpus(tcp)] +
            [udp] + [outcome(P.Udp.parse, d, P.PacketError)
                     for d in corpus(udp)])


@case
def dns_packet(X):
    D = X.m("dns.packet")
    q = D.Packet(id=7, questions=[D.Question("svc.example.com.", D.A)])
    resp = D.Packet(id=7, is_resp=True,
                    questions=[D.Question("svc.example.com.", D.A)],
                    answers=[D.Record("svc.example.com.", D.A, ttl=60,
                                      rdata=bytes([10, 0, 0, 9]))])
    out = []
    for valid in (q.encode(), resp.encode()):
        out.append(valid)
        out += [outcome(D.parse, d, D.DNSFormatError) for d in corpus(valid)]
    return out


@case
def hpack(X):
    H = X.m("processors.hpack")
    valid = H.Encoder().encode([(b":method", b"GET"), (b":path", b"/x"),
                                (b"host", b"a.example.com"),
                                (b"x-y", b"z" * 40)])
    # a fresh table per input: corrupt input must not poison state
    return [valid] + [outcome(lambda d: H.Decoder().decode(d), d,
                              H.HpackError) for d in corpus(valid)]


@case
def http1_head_parser(X):
    H = X.m("processors.http1")
    valid = (b"GET /a/b?x=1 HTTP/1.1\r\nhost: a.example.com\r\n"
             b"content-length: 3\r\n\r\nabc")

    def feed_twice(d):
        p = H.HeadParser()
        p.feed(d)  # must set .error or parse; never raise
        p.feed(d)  # feeding more after error/done must also be safe
        return p
    return [outcome(feed_twice, d) for d in corpus(valid)]


@case
def kcp_input(X):
    K = X.m("net.kcp")
    outs = []
    k2 = K.Kcp(conv=7, output=outs.append)
    k2.send(b"hello-kcp")
    k2.update(10)
    valid = outs[0] if outs else b""
    assert valid, "expected a real kcp datagram to mutate"
    k = K.Kcp(conv=7, output=lambda d: None)
    out = [valid]
    for d in corpus(valid):
        # bad segments are dropped silently, never raise; the machine's
        # state after each input is the outcome
        out.append((outcome(k.input, d), canon(k)))
        k.update(20)
    return out


@case
def headparser_split_feeds(X):
    H = X.m("processors.http1")
    msg = b"POST /p HTTP/1.1\r\nhost: h\r\ncontent-length: 2\r\n\r\nhi"
    whole = H.HeadParser()
    whole.feed(msg)
    split = H.HeadParser()
    for i in range(len(msg)):
        split.feed(msg[i:i + 1])
    assert whole.done and split.done
    assert not whole.error and not split.error
    assert whole.method == split.method == "POST"
    assert whole.headers == split.headers
    return [canon(whole), canon(split)]


@case
def resp_request_parser(X):
    CmdError = X.m("control.command").CmdError
    R = X.m("control.resp")
    valid = (b"*3\r\n$4\r\nAUTH\r\n$2\r\npw\r\n$4\r\nlist\r\n"
             b"list upstream\r\n")

    def parse_all(data):
        rc = R._RespConn.__new__(R._RespConn)
        rc.buf = bytearray(data)
        got = []
        for _ in range(10):  # drain a few requests
            req = rc._try_parse()
            if req is None:
                break
            got.append(req)
        return got, bytes(rc.buf)
    return [outcome(parse_all, d, CmdError) for d in corpus(valid)]


@case
def streamed_session_frames(X):
    EL = X.m("net.eventloop")
    S = X.m("net.streamed")
    lp = EL.SelectorEventLoop("fuzz")
    lp.loop_thread()
    out = []
    try:
        fake = SimpleNamespace(handler=None, send=lambda d: None,
                               close=lambda: None)
        accepted = []
        sess = S.StreamedSession(lp, fake, is_client=False,
                                 on_accept=accepted.append)
        valid = (S._HEAD.pack(1, S.F_SYN, 0) + S._HEAD.pack(1, S.F_PSH, 3)
                 + b"abc")
        for data in corpus(valid):
            lp.call_sync(lambda d=data: sess.on_message(fake, d))
            out.append(len(accepted))
    finally:
        lp.close()
    return [valid] + out


@case
def h2_framing_and_hpack_path(X):
    H2 = X.m("processors.h2")
    settings = (0).to_bytes(3, "big") + bytes([0x04, 0x00]) + \
        (0).to_bytes(4, "big")
    hdrs_payload = b"\x82\x84"  # indexed :method GET, :path /
    headers = len(hdrs_payload).to_bytes(3, "big") + bytes([0x01, 0x05]) + \
        (1).to_bytes(4, "big") + hdrs_payload
    valid = H2.PREFACE + settings + headers

    def parse_all(data):
        sent = []
        side = H2._Side(server=True, send=sent.append)
        side.feed(data)
        return sent
    return [valid] + [outcome(parse_all, d, H2.H2Error)
                      for d in corpus(valid)]


@case
def dhcp_reply_parser(X):
    dhcp = X.m("dns.dhcp")
    valid_head = (b"\x02" + b"\x01\x06\x00" + (0x1234).to_bytes(4, "big") +
                  b"\x00" * (2 + 2 + 16 + 16 + 64 + 128))
    valid = valid_head + b"\x63\x82\x53\x63" + \
        bytes([53, 1, 2, 6, 4, 8, 8, 8, 8, 255])
    # None or a list; never raises
    return [outcome(lambda d: dhcp.parse_reply(d, 0x1234), d)
            for d in corpus(valid)]


@case
def socks5_live_handshake(X):
    """Garbage handshakes against a LIVE socks5 server: what it sends
    back to each (until it closes, or 0.4 s pass), then a valid
    handshake still completes."""
    EG = X.m("components.elgroup")
    SG = X.m("components.servergroup")
    S5 = X.m("components.socks5")
    U = X.m("components.upstream")
    IR = X.m("rules.ir")
    elg = EG.EventLoopGroup("s5f", 1)
    backend = IdServer("FZ")
    g = SG.ServerGroup("g", elg, SG.HealthCheckConfig(
        timeout_ms=500, period_ms=100, up=1, down=1))
    g.add("a", "127.0.0.1", backend.port)
    wait_healthy(g, 1)
    ups = U.Upstream("u")
    ups.add(g, annotations=IR.HintRule(host="svc.example.com"))
    srv = S5.Socks5Server("s5f", elg, elg, "127.0.0.1", 0, ups)
    srv.start()
    out = []
    try:
        valid = (b"\x05\x01\x00" + b"\x05\x01\x00\x03" +
                 bytes([len("svc.example.com")]) + b"svc.example.com" +
                 struct.pack(">H", 80))
        for data in corpus(valid, n=60):
            c = socket.create_connection(("127.0.0.1", srv.bind_port),
                                         timeout=5)
            c.settimeout(0.4)
            got = b""
            try:
                c.sendall(data)
                while True:
                    d = c.recv(4096)
                    if not d:
                        break
                    got += d
            except OSError:
                pass
            finally:
                c.close()
            out.append(got)
        c = socket.create_connection(("127.0.0.1", srv.bind_port), timeout=5)
        c.settimeout(5)
        c.sendall(b"\x05\x01\x00")
        assert c.recv(2) == b"\x05\x00"
        c.sendall(b"\x05\x01\x00\x03" + bytes([15]) + b"svc.example.com" +
                  struct.pack(">H", 80))
        rep = c.recv(10)
        assert rep[:2] == b"\x05\x00"
        assert c.recv(10) == b"FZ"  # IdServer banner through the tunnel
        c.close()
    finally:
        srv.stop()
        g.close()
        backend.close()
        elg.close()
    return out


def _client_hello() -> bytes:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    inb, outb = ssl.MemoryBIO(), ssl.MemoryBIO()
    obj = ctx.wrap_bio(inb, outb, server_hostname="fuzz.example.com")
    try:
        obj.do_handshake()
    except ssl.SSLWantReadError:
        pass
    return outb.read()


HELLO = []  # one stdlib ClientHello, shared by both packages' runs


@case
def client_hello_sni_parser(X):
    sniff = X.m("net.sniff")
    if not HELLO:
        HELLO.append(_client_hello())
    hello = HELLO[0]
    sni, complete = sniff.parse_client_hello_sni(hello)
    assert complete and sni == "fuzz.example.com"
    # total on every truncation prefix and every corpus blob
    return ([sniff.parse_client_hello_sni(hello[:i])
             for i in range(len(hello))] +
            [sniff.parse_client_hello_sni(b) for b in corpus(hello)])


@pytest.mark.parametrize("name", sorted(CASES))
def test_parser_outcomes_equal_across_packages(name):
    ref, port = (CASES[name](ns(pkg)) for pkg in PKGS)
    assert len(ref) == len(port)
    bad = [i for i, (a, b) in enumerate(zip(ref, port)) if a != b]
    assert not bad, (name, bad[:5], ref[bad[0]], port[bad[0]])


def test_every_reference_parser_is_a_case():
    """The 14 parser tests of tests/test_fuzz.py, one case each."""
    import test_fuzz
    ref = sorted(n[len("test_fuzz_"):] for n in dir(test_fuzz)
                 if n.startswith("test_fuzz_"))
    assert ref == sorted(CASES) and len(CASES) == 14
    assert IDS == ("ref", "port")
