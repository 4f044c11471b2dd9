"""The port's DHCP DNS discovery (vproxy_tpu_torch/dns/dhcp.py) against
the reference's: the three DHCP cases of tests/test_wrapfd_dhcp.py
(its two wrapfd cases are in test_torch_net.py), each run on both
packages, then the codec across packages, bytes equal: the DISCOVER
both build for seeded xids and macs, and the DNS servers both parse
out of seeded OFFER / ACK replies (foreign xids, requests and
truncated replies among them)."""
import socket
import struct
import threading

import numpy as np
import pytest

from test_torch_dns import IDS, PKGS, mod


@pytest.fixture(params=PKGS, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def loop(pkg):
    elg = mod(pkg, "components.elgroup").EventLoopGroup("wf", 1)
    yield elg.next()
    elg.close()


def offer(dhcp, xid: int, chaddr: bytes, dns_ips, msg_type=None) -> bytes:
    head = struct.pack(">BBBBIHH", 2, 1, 6, 0, xid, 0, 0)
    head += b"\x00" * 16 + chaddr + b"\x00" * 192
    opts = bytes([dhcp.OPT_MSG_TYPE, 1,
                  dhcp.OFFER if msg_type is None else msg_type,
                  dhcp.OPT_DNS, 4 * len(dns_ips)])
    for ip in dns_ips:
        opts += socket.inet_aton(ip)
    return head + dhcp.MAGIC + opts + bytes([dhcp.OPT_END])


def fake_dhcp_server(dhcp, dns_ips):
    """Minimal DHCP responder on an ephemeral loopback port."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]

    def serve():
        s.settimeout(10)
        try:
            data, addr = s.recvfrom(2048)
        except OSError:
            return
        (xid,) = struct.unpack(">I", data[4:8])
        s.sendto(offer(dhcp, xid, data[28:44], dns_ips), addr)
        s.close()

    threading.Thread(target=serve, daemon=True).start()
    return port


def test_dhcp_discovers_dns_servers(pkg, loop):
    dhcp = mod(pkg, "dns.dhcp")
    port = fake_dhcp_server(dhcp, ["10.0.0.53", "10.0.0.54"])
    out = {}
    done = threading.Event()

    def cb(found, err):
        out["found"], out["err"] = found, err
        done.set()

    dhcp.get_dns_servers(loop, cb, server=("127.0.0.1", port),
                         bind_ip="127.0.0.1", timeout_ms=1500)
    assert done.wait(5)
    assert out["err"] is None
    assert out["found"] == {socket.inet_aton("10.0.0.53"),
                            socket.inet_aton("10.0.0.54")}


def test_dhcp_timeout_reports_error(pkg, loop):
    dhcp = mod(pkg, "dns.dhcp")
    out = {}
    done = threading.Event()
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))  # a port nobody answers on
    dhcp.get_dns_servers(loop, lambda f, e: (out.update(f=f, e=e),
                                             done.set()),
                         server=("127.0.0.1", s.getsockname()[1]),
                         bind_ip="127.0.0.1", timeout_ms=300, retries=0)
    assert done.wait(5)
    s.close()
    assert out["f"] == set() and isinstance(out["e"], TimeoutError)


def test_dhcp_codec_roundtrip(pkg):
    dhcp = mod(pkg, "dns.dhcp")
    pkt = dhcp.build_discover(0xAABBCCDD)
    assert pkt[0] == 1 and pkt[236:240] == dhcp.MAGIC
    # reply parser rejects foreign xid and non-reply ops
    assert dhcp.parse_reply(pkt, 0xAABBCCDD) is None  # a request, not reply
    head = struct.pack(">BBBBIHH", 2, 1, 6, 0, 7, 0, 0) + b"\x00" * 224
    opts = bytes([dhcp.OPT_MSG_TYPE, 1, dhcp.ACK, dhcp.OPT_DNS, 4,
                  1, 2, 3, 4, dhcp.OPT_END])
    data = head + dhcp.MAGIC + opts
    assert dhcp.parse_reply(data, 7) == [bytes([1, 2, 3, 4])]
    assert dhcp.parse_reply(data, 8) is None


def test_dhcp_codec_bytes_equal_across_packages():
    """Seeded xids and macs: equal DISCOVER bytes; seeded replies
    (OFFER and ACK, 0-4 DNS servers, a foreign xid, a request, a NAK
    type, cuts at every length of one reply): equal parses."""
    ref, port = (mod(p, "dns.dhcp") for p in PKGS)
    for name in ("MAGIC", "OPT_MSG_TYPE", "OPT_PRL", "OPT_DNS", "OPT_END",
                 "DISCOVER", "OFFER", "ACK", "DHCP_SERVER_PORT",
                 "DHCP_CLIENT_PORT"):
        assert getattr(port, name) == getattr(ref, name), name
    rng = np.random.default_rng(67)
    replies = []
    for _ in range(200):
        xid = int(rng.integers(0, 1 << 32))
        mac = rng.bytes(6)
        d = ref.build_discover(xid, mac)
        assert port.build_discover(xid, mac) == d
        assert port.build_discover(xid) == ref.build_discover(xid)
        ips = [socket.inet_ntoa(rng.bytes(4))
               for _ in range(int(rng.integers(0, 5)))]
        kind = int(rng.choice([ref.OFFER, ref.ACK, 6]))
        r = offer(ref, xid, d[28:44], ips, kind)
        want = xid if rng.random() < 0.8 else xid ^ 1
        replies += [(r, want), (d, xid)]
    replies += [(replies[0][0][:n], replies[0][1])
                for n in range(len(replies[0][0]))]
    for data, xid in replies:
        assert port.parse_reply(data, xid) == ref.parse_reply(data, xid)
