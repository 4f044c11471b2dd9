"""TLS termination on the port's TcpLB: the cases of tests/test_tls.py
on the port's modules (all but test_tls_command_grammar, which drives
the control plane the port does not have yet), the matchers on the
CPU. Certificates are minted with openssl, as the reference's are."""
import socket
import ssl
import subprocess

import pytest

from vproxy_tpu_torch.components.certkey import CertKey, CertKeyHolder
from vproxy_tpu_torch.components.servergroup import ServerGroup
from vproxy_tpu_torch.components.tcplb import TcpLB
from vproxy_tpu_torch.components.upstream import Upstream
from vproxy_tpu_torch.rules.ir import HintRule

from test_torch_tcplb import _torch_cpu, IdServer, fast_hc, stack, wait_healthy  # noqa: F401


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    """Self-signed certs: one for a.example.com, one wildcard *.w.example.com."""
    d = tmp_path_factory.mktemp("certs")

    def mk(name, cn, sans):
        cert, key = d / f"{name}.crt", d / f"{name}.key"
        san = ",".join(f"DNS:{s}" for s in sans)
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", str(key), "-out", str(cert), "-days", "2",
             "-subj", f"/CN={cn}", "-addext", f"subjectAltName={san}"],
            check=True, capture_output=True)
        return str(cert), str(key)

    a = mk("a", "a.example.com", ["a.example.com"])
    w = mk("w", "*.w.example.com", ["*.w.example.com"])
    return {"a": a, "w": w}


def test_certkey_sni_choose(certs):
    pytest.importorskip("cryptography")  # CertKey parses SAN/CN with it
    ck_a = CertKey("a", *certs["a"])
    ck_w = CertKey("w", *certs["w"])
    assert ck_a.dns_names == ["a.example.com"]
    assert ck_w.matches("x.w.example.com")
    assert not ck_w.matches("x.y.w.example.com")  # single-label wildcard
    holder = CertKeyHolder([ck_a, ck_w])
    assert holder.choose("a.example.com") is not None
    assert holder.choose("b.w.example.com") is holder.choose("c.w.example.com")
    assert holder.choose("unknown.org") is None  # falls back to default


def _tls_get(port, sni, host, path="/"):
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    raw = socket.create_connection(("127.0.0.1", port), timeout=5)
    c = ctx.wrap_socket(raw, server_hostname=sni)
    c.settimeout(5)
    peer_cn = c.getpeercert(binary_form=True)
    c.sendall(b"GET %s HTTP/1.1\r\nhost: %s\r\nconnection: close\r\n\r\n"
              % (path.encode(), host.encode()))
    data = b""
    while True:
        try:
            d = c.recv(65536)
        except (ssl.SSLError, socket.timeout, ConnectionResetError):
            break
        if not d:
            break
        data += d
    c.close()
    _, _, body = data.partition(b"\r\n\r\n")
    return body, peer_cn


def test_tls_terminating_lb_routes_by_host(stack, certs):
    pytest.importorskip("cryptography")  # CertKey parses SAN/CN with it
    sa = IdServer("TA", http=True)
    sb = IdServer("TB", http=True)
    stack["servers"] += [sa, sb]
    elg = stack["make_elg"](1)
    ups = Upstream("u")
    for i, (srv, rule) in enumerate([
            (sa, HintRule(host="a.example.com")),
            (sb, HintRule(host="b.w.example.com"))]):
        g = ServerGroup(f"g{i}", elg, fast_hc())
        stack["groups"].append(g)
        g.add("s", "127.0.0.1", srv.port)
        wait_healthy(g, 1)
        ups.add(g, annotations=rule)
    cks = [CertKey("a", *certs["a"]), CertKey("w", *certs["w"])]
    lb = TcpLB("lb", elg, elg, "127.0.0.1", 0, ups, protocol="http",
               cert_keys=cks)
    stack["lbs"].append(lb)
    lb.start()

    body, cert_a = _tls_get(lb.bind_port, "a.example.com", "a.example.com")
    assert body == b"TA"
    body, cert_w = _tls_get(lb.bind_port, "b.w.example.com", "b.w.example.com")
    assert body == b"TB"
    # SNI picked DIFFERENT certificates for the two names
    assert cert_a != cert_w
    # unknown SNI serves the default (first) cert and still proxies
    body, cert_d = _tls_get(lb.bind_port, "other.org", "a.example.com")
    assert body == b"TA" and cert_d == cert_a


def test_tls_tcp_mode_uses_sni_as_hint(stack, certs):
    pytest.importorskip("cryptography")  # CertKey parses SAN/CN with it
    sa = IdServer("RA")  # raw id servers (send id on connect)
    sb = IdServer("RB")
    stack["servers"] += [sa, sb]
    elg = stack["make_elg"](1)
    ups = Upstream("u")
    for i, (srv, rule) in enumerate([
            (sa, HintRule(host="a.example.com")),
            (sb, HintRule(host="b.w.example.com"))]):
        g = ServerGroup(f"g{i}", elg, fast_hc())
        stack["groups"].append(g)
        g.add("s", "127.0.0.1", srv.port)
        wait_healthy(g, 1)
        ups.add(g, annotations=rule)
    cks = [CertKey("a", *certs["a"]), CertKey("w", *certs["w"])]
    lb = TcpLB("lb", elg, elg, "127.0.0.1", 0, ups, protocol="tcp",
               cert_keys=cks)
    stack["lbs"].append(lb)
    lb.start()

    def probe(sni):
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        raw = socket.create_connection(("127.0.0.1", lb.bind_port), timeout=5)
        c = ctx.wrap_socket(raw, server_hostname=sni)
        c.settimeout(5)
        c.sendall(b"x")  # first data triggers backend selection
        sid = c.recv(10)
        c.close()
        return sid

    assert probe("a.example.com").startswith(b"RA")
    assert probe("b.w.example.com").startswith(b"RB")


def test_native_tls_splice_large_bidirectional(stack, certs):
    """The C-side TLS pump (vtl_tls_pump_new) moves multi-megabyte
    payloads BOTH directions through ring wraps, and the LB byte
    counters prove the session rode the native pump (bytes_in counts
    a2b plaintext only on pump completion)."""
    import socket as _s
    import threading
    import time

    from vproxy_tpu_torch.net import vtl
    if not vtl.tls_available() or vtl.PROVIDER != "native":
        pytest.skip("native TLS unavailable")
    elg = stack["make_elg"](1)

    # echo backend that returns exactly what it receives
    srv = _s.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    sport = srv.getsockname()[1]

    def serve_one(c):
        c.settimeout(10)
        try:
            while True:
                d = c.recv(65536)
                if not d:
                    break
                c.sendall(d)
        except OSError:
            pass
        c.close()

    def echo():  # accept loop: health-check probes connect too
        while True:
            try:
                c, _ = srv.accept()
            except OSError:
                return
            threading.Thread(target=serve_one, args=(c,),
                             daemon=True).start()

    t = threading.Thread(target=echo, daemon=True)
    t.start()

    g = ServerGroup("g", elg, fast_hc(), "wrr")
    stack["groups"].append(g)
    g.add("e", "127.0.0.1", sport)
    wait_healthy(g, 1)
    u = Upstream("u")
    u.add(g)
    ck = CertKey("a", *certs["a"])
    lb = TcpLB("lb-ntls", elg, elg, "127.0.0.1", 0, u,
               protocol="tcp", cert_keys=[ck])
    stack["lbs"].append(lb)
    lb.start()

    payload = bytes(range(256)) * 4096 * 4  # 4 MiB (many ring wraps)
    cx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    cx.check_hostname = False
    cx.verify_mode = ssl.CERT_NONE
    got = bytearray()
    with _s.create_connection(("127.0.0.1", lb.bind_port), timeout=10) as raw:
        with cx.wrap_socket(raw, server_hostname="a.example.com") as c:
            # single-threaded nonblocking interleave: send and drain
            # concurrently without the two-threads-on-one-SSLSocket trap
            c.setblocking(False)
            view = memoryview(payload)
            deadline = time.time() + 60
            while len(got) < len(payload):
                assert time.time() < deadline, (len(got), len(view))
                progressed = False
                if view:
                    try:
                        n = c.send(view[:65536])
                        view = view[n:]
                        progressed = True
                    except (ssl.SSLWantWriteError, ssl.SSLWantReadError,
                            BlockingIOError):
                        pass
                try:
                    d = c.recv(65536)
                    if d:
                        got += d
                        progressed = True
                except (ssl.SSLWantReadError, ssl.SSLWantWriteError):
                    pass
                if not progressed:
                    time.sleep(0.001)
    assert bytes(got) == payload
    srv.close()
    # pump completion is async; the byte counters land on DONE
    deadline = time.time() + 5
    while time.time() < deadline and lb.bytes_in < len(payload):
        time.sleep(0.05)
    assert lb.bytes_in >= len(payload)   # plaintext a2b through the pump
    assert lb.bytes_out >= len(payload)  # plaintext b2a through the pump


def test_native_tls_partial_hello_rearm(stack, certs):
    """A ClientHello delivered in two fragments with a pause: the SNI
    peek parks read interest between fragments (no level-triggered
    busy-spin) and completes the handshake when the rest arrives."""
    import socket as _s
    import threading
    import time

    from vproxy_tpu_torch.net import vtl
    if not vtl.tls_available() or vtl.PROVIDER != "native":
        pytest.skip("native TLS unavailable")
    elg = stack["make_elg"](1)
    srv = IdServer("P")
    stack["servers"].append(srv)
    g = ServerGroup("g", elg, fast_hc(), "wrr")
    stack["groups"].append(g)
    g.add("p", "127.0.0.1", srv.port)
    wait_healthy(g, 1)
    u = Upstream("u")
    u.add(g)
    lb = TcpLB("lb-part", elg, elg, "127.0.0.1", 0, u,
               protocol="tcp", cert_keys=[CertKey("a", *certs["a"])])
    stack["lbs"].append(lb)
    lb.start()

    # build a real ClientHello by handshaking against a throwaway
    # in-memory server? simpler: capture the bytes a python client
    # would send by sniffing through a plain socket pair is overkill —
    # drive the split through a socket proxy thread instead.
    up = _s.socket()
    up.bind(("127.0.0.1", 0))
    up.listen(1)
    pport = up.getsockname()[1]

    def splitter():
        c, _ = up.accept()
        c.settimeout(10)
        out = _s.create_connection(("127.0.0.1", lb.bind_port), timeout=10)
        first = c.recv(65536)  # the client's full ClientHello
        out.sendall(first[:20])          # fragment 1: record prefix only
        time.sleep(0.3)                  # parked window
        out.sendall(first[20:])          # rest of the hello
        # then relay transparently both ways
        c.setblocking(False)
        out.setblocking(False)
        end = time.time() + 10
        while time.time() < end:
            moved = False
            for a, b in ((c, out), (out, c)):
                try:
                    d = a.recv(65536)
                    if d:
                        b.sendall(d)
                        moved = True
                except (BlockingIOError, _s.error):
                    pass
            if not moved:
                time.sleep(0.01)

    threading.Thread(target=splitter, daemon=True).start()

    cx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    cx.check_hostname = False
    cx.verify_mode = ssl.CERT_NONE
    with _s.create_connection(("127.0.0.1", pport), timeout=10) as raw:
        with cx.wrap_socket(raw, server_hostname="a.example.com") as c:
            c.settimeout(10)
            c.sendall(b"frag")
            assert c.recv(10).startswith(b"P")
