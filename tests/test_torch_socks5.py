"""The port's Socks5Server (vproxy_tpu_torch/components/socks5.py)
against the reference's: the 5 cases of tests/test_socks5.py (a domain
CONNECT classified to the Upstream's group, an IP CONNECT matched
against the backend list, an unknown target refused, the direct connect
of allow-non-backend, a bad auth method), each run on both packages,
the matchers on the CPU."""
import socket
import struct

import pytest

from test_torch_dns import IDS, PKGS, fast_hc, mod
from test_torch_tcplb import _torch_cpu, IdServer, wait_healthy  # noqa: F401


def _s5(pkg: str, allow_non_backend: bool):
    EventLoopGroup = mod(pkg, "components.elgroup").EventLoopGroup
    Socks5Server = mod(pkg, "components.socks5").Socks5Server
    ServerGroup = mod(pkg, "components.servergroup").ServerGroup
    Upstream = mod(pkg, "components.upstream").Upstream
    HintRule = mod(pkg, "rules.ir").HintRule
    elg = EventLoopGroup("s5", 1)
    backend = IdServer("S5A")
    g = ServerGroup("g", elg, fast_hc(pkg))
    g.add("a", "127.0.0.1", backend.port)
    wait_healthy(g, 1)
    ups = Upstream("u")
    ups.add(g, annotations=HintRule(host="svc.example.com"))
    srv = Socks5Server("s5", elg, elg, "127.0.0.1", 0, ups,
                       allow_non_backend=allow_non_backend)
    srv.start()
    return srv, backend, elg, g


@pytest.fixture(params=PKGS, ids=IDS)
def s5(request):
    made = []

    def make(allow_non_backend=False):
        made.append(_s5(request.param, allow_non_backend))
        return made[-1][:3]
    yield make
    for srv, backend, elg, g in made:
        srv.stop()
        g.close()
        backend.close()
        elg.close()


def socks5_connect(port, atyp, addr, dport):
    c = socket.create_connection(("127.0.0.1", port), timeout=5)
    c.settimeout(5)
    c.sendall(b"\x05\x01\x00")
    assert c.recv(2) == b"\x05\x00"
    if atyp == 3:
        req = (b"\x05\x01\x00\x03" + bytes([len(addr)]) + addr.encode()
               + struct.pack(">H", dport))
    else:
        req = (b"\x05\x01\x00\x01" + socket.inet_aton(addr)
               + struct.pack(">H", dport))
    c.sendall(req)
    rep = c.recv(10)
    return c, rep[1] if len(rep) > 1 else None


def test_socks5_domain_to_backend(s5):
    srv, backend, _ = s5()
    c, rep = socks5_connect(srv.bind_port, 3, "svc.example.com", 80)
    assert rep == 0
    assert c.recv(10) == b"S5A"  # IdServer sends its id on connect
    c.sendall(b"ping")
    assert c.recv(10) == b"ping"  # echo through the pump
    c.close()


def test_socks5_ip_matches_backend_list(s5):
    srv, backend, _ = s5()
    c, rep = socks5_connect(srv.bind_port, 1, "127.0.0.1", backend.port)
    assert rep == 0
    assert c.recv(10) == b"S5A"
    c.close()


def test_socks5_unknown_target_rejected(s5):
    srv, _, _ = s5()
    c, rep = socks5_connect(srv.bind_port, 3, "unknown.example.org", 443)
    assert rep == 2  # not allowed by ruleset (allow_non_backend=False)
    c.close()


def test_socks5_non_backend_direct(s5):
    srv, _, _ = s5(allow_non_backend=True)
    other = IdServer("DIRECT")
    try:
        c, rep = socks5_connect(srv.bind_port, 1, "127.0.0.1", other.port)
        assert rep == 0
        assert c.recv(20) == b"DIRECT"
        c.close()
    finally:
        other.close()


def test_socks5_bad_auth_method(s5):
    srv, _, _ = s5()
    c = socket.create_connection(("127.0.0.1", srv.bind_port), timeout=5)
    c.settimeout(5)
    c.sendall(b"\x05\x01\x02")  # only username/password offered
    assert c.recv(2) == b"\x05\xff"
    assert c.recv(10) == b""  # closed
    c.close()
