"""The port's virtual switch (vproxy_tpu_torch/vswitch/) against the
reference's, the matchers on the CPU.

Ported reference cases, each run on both packages (`pkg`):

* tests/test_vswitch.py (12): the packet codecs, the route table's
  insert-order LPM, switches over loopback UDP (ARP/ICMP for synthetic
  ips, L2 forwarding, cross-VNI routing, the batched burst with its ACL,
  two linked switches, the encrypted user tunnel) and the command
  grammar with its persistence;
* tests/test_vtcp.py (5): the user-space TCP stack in the switch;
* test_control_extras.py::test_vpc_proxy_bridges_to_host and the switch
  half of its test_update_switch_and_socks5;
* test_mirror.py::test_switch_tap_captures_frames,
  test_loop_death.py::test_switch_rehomes_on_crash and the swmetrics
  vocabulary of test_metrics.py's pre-registration case.

The fast path, the native flow cache and the parity gates between the
packages are in test_torch_vswitch_parity.py.
"""
import hashlib
import os
import socket
import struct
import time

import pytest

from test_torch_dns import IDS, PKGS, mod
from test_torch_tcplb import _torch_cpu, IdServer  # noqa: F401

# name -> (module of the package, attribute; None for the module itself)
NAMES = {
    "EventLoopGroup": ("components.elgroup", "EventLoopGroup"),
    "SecurityGroup": ("components.secgroup", "SecurityGroup"),
    "SelectorEventLoop": ("net.eventloop", "SelectorEventLoop"),
    "RouteRule": ("rules.ir", "RouteRule"),
    "AclRule": ("rules.ir", "AclRule"),
    "Proto": ("rules.ir", "Proto"),
    "Network": ("utils.ip", "Network"),
    "parse_ip": ("utils.ip", "parse_ip"),
    "mask_bytes": ("utils.ip", "mask_bytes"),
    "P": ("vswitch.packets", None),
    "VpcNetwork": ("vswitch.network", "VpcNetwork"),
    "Switch": ("vswitch.switch", "Switch"),
    "synthetic_mac": ("vswitch.switch", "synthetic_mac"),
    "VConn": ("vswitch.fds", "VConn"),
    "VServerSock": ("vswitch.fds", "VServerSock"),
    "get_l4": ("vswitch.fds", "get_l4"),
    "Application": ("control.app", "Application"),
    "Command": ("control.command", "Command"),
    "CmdError": ("control.command", "CmdError"),
    "persist": ("control.persist", None),
    "Mirror": ("utils.mirror", "Mirror"),
    "GlobalInspection": ("utils.metrics", "GlobalInspection"),
    "swmetrics": ("vswitch.swmetrics", None),
    "vtl": ("net.vtl", None),
    "failpoint": ("utils.failpoint", None),
    "sketch": ("utils.sketch", None),
    "fastpath": ("vswitch.fastpath", None),
}


class NS:
    """The names the reference's switch tests import, from `pkg`."""

    def __init__(self, pkg: str):
        self.pkg = pkg

    def __getattr__(self, name):
        module, attr = NAMES[name]
        m = mod(self.pkg, module)
        return m if attr is None else getattr(m, attr)


@pytest.fixture(params=PKGS, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def X(pkg):
    return NS(pkg)


# ------------------------------------------------ tests/test_vswitch.py

def test_ethernet_arp_roundtrip(X):
    P, parse_ip = X.P, X.parse_ip
    arp = P.Arp(P.ARP_REQUEST, sha=P.parse_mac("02:00:00:00:00:01"),
                spa=parse_ip("10.0.0.1"), tha=b"\x00" * 6,
                tpa=parse_ip("10.0.0.2"))
    e = P.Ethernet(P.BROADCAST_MAC, arp.sha, P.ETHER_TYPE_ARP, b"", arp)
    raw = e.to_bytes()
    e2 = P.Ethernet.parse(raw)
    assert isinstance(e2.packet, P.Arp)
    assert e2.packet.spa == arp.spa and e2.packet.op == P.ARP_REQUEST
    assert e2.to_bytes() == raw


def test_ipv4_icmp_roundtrip_checksums(X):
    P, parse_ip = X.P, X.parse_ip
    icmp = P.Icmp(P.ICMP_ECHO_REQ, 0, b"\x12\x34\x00\x01payload")
    ip = P.Ipv4(parse_ip("10.0.0.1"), parse_ip("10.0.0.2"), P.PROTO_ICMP,
                b"", packet=icmp)
    raw = ip.to_bytes()
    assert P.checksum(raw[:20]) == 0
    ip2 = P.Ipv4.parse(raw)
    assert isinstance(ip2.packet, P.Icmp)
    assert ip2.packet.body == icmp.body
    assert P.checksum(raw[20:]) == 0


def test_tcp_udp_roundtrip(X):
    P, parse_ip = X.P, X.parse_ip
    tcp = P.Tcp(1234, 80, seq=1000, ack=0, flags=P.TCP_SYN, window=65535,
                options=b"\x02\x04\x05\xb4")
    ip = P.Ipv4(parse_ip("10.0.0.1"), parse_ip("10.0.0.2"), P.PROTO_TCP,
                b"", packet=tcp)
    ip2 = P.Ipv4.parse(ip.to_bytes())
    assert isinstance(ip2.packet, P.Tcp)
    assert ip2.packet.mss_option() == 1460
    assert ip2.packet.flags == P.TCP_SYN
    udp = P.Udp(53, 5353, b"hello")
    ip6 = P.Ipv6(parse_ip("fd00::1"), parse_ip("fd00::2"), P.PROTO_UDP,
                 b"", packet=udp)
    ip62 = P.Ipv6.parse(ip6.to_bytes())
    assert isinstance(ip62.packet, P.Udp) and ip62.packet.data == b"hello"


def test_vxlan_and_encrypted_roundtrip(X):
    pytest.importorskip("cryptography")  # encrypted frames use AES-CFB
    P, parse_ip = X.P, X.parse_ip
    arp = P.Arp(P.ARP_REPLY, sha=b"\x02" * 6, spa=parse_ip("10.1.0.1"),
                tha=b"\x04" * 6, tpa=parse_ip("10.1.0.2"))
    e = P.Ethernet(b"\x04" * 6, b"\x02" * 6, P.ETHER_TYPE_ARP, b"", arp)
    vx = P.Vxlan(1314, e)
    vx2 = P.Vxlan.parse(vx.to_bytes())
    assert vx2.vni == 1314 and isinstance(vx2.ether.packet, P.Arp)
    key = hashlib.sha256(b"pass123").digest()

    def key_for(user):
        return key if user == "alice5AA" else None

    sp = P.VProxySwitchPacket("alice5AA", P.VPROXY_TYPE_VXLAN, vx)
    raw = sp.to_bytes(key_for)
    sp2 = P.VProxySwitchPacket.parse(raw, key_for)
    assert sp2.user == "alice5AA" and sp2.vxlan.vni == 1314
    with pytest.raises(P.PacketError):
        P.VProxySwitchPacket.parse(raw,
                                   lambda u: hashlib.sha256(b"x").digest())


def test_route_table_insert_order_lpm(X):
    Network, RouteRule, parse_ip = X.Network, X.RouteRule, X.parse_ip
    net = X.VpcNetwork(1, Network.parse("10.0.0.0/8"))
    net.add_route(RouteRule("wide", Network.parse("10.0.0.0/8"), to_vni=1))
    net.add_route(RouteRule("mid", Network.parse("10.1.0.0/16"), to_vni=2))
    net.add_route(RouteRule("narrow", Network.parse("10.1.2.0/24"),
                            to_vni=3))
    assert net.route_lookup(parse_ip("10.1.2.3")).alias == "narrow"
    assert net.route_lookup(parse_ip("10.1.9.9")).alias == "mid"
    assert net.route_lookup(parse_ip("10.9.9.9")).alias == "wide"
    assert net.route_lookup(parse_ip("11.0.0.1")) is None
    net.remove_route("narrow")
    assert net.route_lookup(parse_ip("10.1.2.3")).alias == "mid"
    with pytest.raises(ValueError):
        net.add_route(RouteRule("mid", Network.parse("10.3.0.0/16"),
                                to_vni=9))


class FakeHost:
    """A VXLAN VTEP host simulated with one UDP socket: sends/receives
    encapsulated frames for a (mac, ip) endpoint."""

    def __init__(self, X, mac: str, ip: str, vni: int, switch_addr):
        self.P = P = X.P
        self.parse_ip = X.parse_ip
        self.mac = P.parse_mac(mac)
        self.ip = X.parse_ip(ip)
        self.vni = vni
        self.switch_addr = switch_addr
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(5)

    def send_ether(self, ether):
        self.sock.sendto(self.P.Vxlan(self.vni, ether).to_bytes(),
                         self.switch_addr)

    def recv_ether(self, want=None, timeout=5.0):
        t0 = time.time()
        while time.time() - t0 < timeout:
            try:
                data, _ = self.sock.recvfrom(65536)
            except socket.timeout:
                break
            vx = self.P.Vxlan.parse(data)
            if want is None or want(vx.ether):
                return vx.ether
        raise TimeoutError("no matching frame")

    def gratuitous_arp(self):
        P = self.P
        arp = P.Arp(P.ARP_REPLY, sha=self.mac, spa=self.ip, tha=self.mac,
                    tpa=self.ip)
        self.send_ether(P.Ethernet(P.BROADCAST_MAC, self.mac,
                                   P.ETHER_TYPE_ARP, b"", arp))

    def arp_request(self, target_ip: str):
        P = self.P
        arp = P.Arp(P.ARP_REQUEST, sha=self.mac, spa=self.ip,
                    tha=b"\x00" * 6, tpa=self.parse_ip(target_ip))
        self.send_ether(P.Ethernet(P.BROADCAST_MAC, self.mac,
                                   P.ETHER_TYPE_ARP, b"", arp))

    def ping(self, dst_mac: bytes, dst_ip: str, ident=b"\x00\x07\x00\x01"):
        P = self.P
        icmp = P.Icmp(P.ICMP_ECHO_REQ, 0, ident + b"ping-data")
        ip = P.Ipv4(self.ip, self.parse_ip(dst_ip), P.PROTO_ICMP, b"",
                    packet=icmp)
        self.send_ether(P.Ethernet(dst_mac, self.mac, P.ETHER_TYPE_IPV4,
                                   b"", ip))

    def close(self):
        self.sock.close()


@pytest.fixture
def sw_env(X):
    elg = X.EventLoopGroup("sw", 1)
    objs = {"switches": [], "hosts": []}
    yield elg, objs
    for s in objs["switches"]:
        s.stop()
    for h in objs["hosts"]:
        h.close()
    time.sleep(0.05)
    elg.close()


def test_switch_arp_and_icmp_for_synthetic_ip(X, sw_env):
    P, parse_ip, synthetic_mac = X.P, X.parse_ip, X.synthetic_mac
    elg, objs = sw_env
    sw = X.Switch("sw0", elg.next(), "127.0.0.1", 0)
    objs["switches"].append(sw)
    sw.start()
    net = sw.add_network(1314, X.Network.parse("172.16.0.0/16"))
    gw_ip = parse_ip("172.16.0.1")
    net.ips.add(gw_ip, synthetic_mac(1314, gw_ip))
    h = FakeHost(X, "02:aa:00:00:00:01", "172.16.0.11", 1314,
                 ("127.0.0.1", sw.bind_port))
    objs["hosts"].append(h)
    h.arp_request("172.16.0.1")
    reply = h.recv_ether(lambda e: isinstance(e.packet, P.Arp)
                         and e.packet.op == P.ARP_REPLY)
    assert reply.packet.sha == synthetic_mac(1314, gw_ip)
    assert reply.packet.spa == gw_ip
    h.ping(reply.packet.sha, "172.16.0.1")
    echo = h.recv_ether(lambda e: isinstance(e.packet, P.Ipv4)
                        and isinstance(e.packet.packet, P.Icmp)
                        and e.packet.packet.type == P.ICMP_ECHO_REPLY)
    assert echo.packet.packet.body.endswith(b"ping-data")
    assert echo.packet.src == gw_ip


def test_switch_l2_forwarding_between_hosts(X, sw_env):
    P = X.P
    elg, objs = sw_env
    sw = X.Switch("sw0", elg.next(), "127.0.0.1", 0)
    objs["switches"].append(sw)
    sw.start()
    sw.add_network(2, X.Network.parse("10.2.0.0/16"))
    addr = ("127.0.0.1", sw.bind_port)
    h1 = FakeHost(X, "02:aa:00:00:00:11", "10.2.0.11", 2, addr)
    h2 = FakeHost(X, "02:aa:00:00:00:12", "10.2.0.12", 2, addr)
    objs["hosts"] += [h1, h2]
    h1.gratuitous_arp()
    h2.gratuitous_arp()
    time.sleep(0.1)
    h1.ping(h2.mac, "10.2.0.12")
    got = h2.recv_ether(lambda e: isinstance(e.packet, P.Ipv4)
                        and isinstance(e.packet.packet, P.Icmp))
    assert got.packet.src == h1.ip and got.packet.dst == h2.ip
    assert got.src == h1.mac


def _two_vpcs(X, sw):
    n1 = sw.add_network(101, X.Network.parse("10.1.0.0/16"))
    n2 = sw.add_network(102, X.Network.parse("10.2.0.0/16"))
    for net, gw in ((n1, "10.1.0.1"), (n2, "10.2.0.1")):
        ip = X.parse_ip(gw)
        net.ips.add(ip, X.synthetic_mac(net.vni, ip))
    n1.add_route(X.RouteRule("to2", X.Network.parse("10.2.0.0/16"),
                             to_vni=102))
    return n1, n2


def test_switch_cross_vni_routing(X, sw_env):
    P = X.P
    elg, objs = sw_env
    sw = X.Switch("sw0", elg.next(), "127.0.0.1", 0)
    objs["switches"].append(sw)
    sw.start()
    _two_vpcs(X, sw)
    addr = ("127.0.0.1", sw.bind_port)
    h1 = FakeHost(X, "02:aa:00:00:01:01", "10.1.0.11", 101, addr)
    h2 = FakeHost(X, "02:aa:00:00:02:02", "10.2.0.22", 102, addr)
    objs["hosts"] += [h1, h2]
    h1.gratuitous_arp()
    h2.gratuitous_arp()
    time.sleep(0.1)
    gw1_mac = X.synthetic_mac(101, X.parse_ip("10.1.0.1"))
    h1.ping(gw1_mac, "10.2.0.22")
    got = h2.recv_ether(lambda e: isinstance(e.packet, P.Ipv4)
                        and isinstance(e.packet.packet, P.Icmp))
    assert got.packet.src == h1.ip and got.packet.dst == h2.ip
    assert got.packet.ttl == 63


def test_burst_routing_and_acl_batch(X, sw_env):
    """A burst takes the batched path (batched bare ACL + one LPM
    dispatch per vpc) with per-packet results identical to the single
    path; a default-deny ACL drops the whole burst."""
    P, Network = X.P, X.Network
    elg, objs = sw_env
    allow_lo = X.SecurityGroup("lo-only", default_allow=False)
    allow_lo.add_rule(X.AclRule("lo", Network.parse("127.0.0.0/8"),
                                X.Proto.UDP, 0, 65535, True))
    sw = X.Switch("sw0", elg.next(), "127.0.0.1", 0,
                  bare_vxlan_access=allow_lo)
    objs["switches"].append(sw)
    sw.start()
    _two_vpcs(X, sw)
    addr = ("127.0.0.1", sw.bind_port)
    h1 = FakeHost(X, "02:aa:00:00:01:01", "10.1.0.11", 101, addr)
    h2 = FakeHost(X, "02:aa:00:00:02:02", "10.2.0.22", 102, addr)
    objs["hosts"] += [h1, h2]
    h1.gratuitous_arp()
    h2.gratuitous_arp()
    time.sleep(0.1)
    gw1_mac = X.synthetic_mac(101, X.parse_ip("10.1.0.1"))
    n_burst = 100
    for i in range(n_burst):
        h1.ping(gw1_mac, "10.2.0.22",
                ident=b"\x00\x07" + i.to_bytes(2, "big"))
    got = set()
    deadline = time.time() + 5
    while len(got) < n_burst and time.time() < deadline:
        e = h2.recv_ether(lambda e: isinstance(e.packet, P.Ipv4)
                          and isinstance(e.packet.packet, P.Icmp))
        assert e.packet.ttl == 63
        got.add(e.packet.packet.body[2:4])
    assert len(got) == n_burst

    deny = X.SecurityGroup("deny-all", default_allow=False)
    sw2 = X.Switch("sw1", elg.next(), "127.0.0.1", 0,
                   bare_vxlan_access=deny)
    objs["switches"].append(sw2)
    sw2.start()
    _two_vpcs(X, sw2)
    addr2 = ("127.0.0.1", sw2.bind_port)
    g1 = FakeHost(X, "02:aa:00:00:01:01", "10.1.0.11", 101, addr2)
    g2 = FakeHost(X, "02:aa:00:00:02:02", "10.2.0.22", 102, addr2)
    objs["hosts"] += [g1, g2]
    g1.gratuitous_arp()
    g2.gratuitous_arp()
    for _ in range(10):
        g1.ping(gw1_mac, "10.2.0.22")
    with pytest.raises(TimeoutError):
        g2.recv_ether(lambda e: isinstance(e.packet, P.Ipv4), timeout=0.6)


def test_two_switches_linked(X, sw_env):
    P = X.P
    elg, objs = sw_env
    sw1 = X.Switch("sw1", elg.next(), "127.0.0.1", 0)
    sw2 = X.Switch("sw2", elg.next(), "127.0.0.1", 0)
    objs["switches"] += [sw1, sw2]
    sw1.start()
    sw2.start()
    sw1.add_network(7, X.Network.parse("10.7.0.0/16"))
    sw2.add_network(7, X.Network.parse("10.7.0.0/16"))
    sw1.add_remote_switch("to2", "127.0.0.1", sw2.bind_port)
    sw2.add_remote_switch("to1", "127.0.0.1", sw1.bind_port)
    h1 = FakeHost(X, "02:bb:00:00:00:01", "10.7.0.1", 7,
                  ("127.0.0.1", sw1.bind_port))
    h2 = FakeHost(X, "02:bb:00:00:00:02", "10.7.0.2", 7,
                  ("127.0.0.1", sw2.bind_port))
    objs["hosts"] += [h1, h2]
    h1.gratuitous_arp()
    h2.gratuitous_arp()
    time.sleep(0.15)
    h1.arp_request("10.7.0.2")
    req = h2.recv_ether(lambda e: isinstance(e.packet, P.Arp)
                        and e.packet.op == P.ARP_REQUEST)
    assert req.packet.spa == h1.ip
    arp = P.Arp(P.ARP_REPLY, sha=h2.mac, spa=h2.ip, tha=h1.mac, tpa=h1.ip)
    h2.send_ether(P.Ethernet(h1.mac, h2.mac, P.ETHER_TYPE_ARP, b"", arp))
    rep = h1.recv_ether(lambda e: isinstance(e.packet, P.Arp)
                        and e.packet.op == P.ARP_REPLY)
    assert rep.packet.sha == h2.mac
    h1.ping(h2.mac, "10.7.0.2")
    got = h2.recv_ether(lambda e: isinstance(e.packet, P.Ipv4)
                        and isinstance(e.packet.packet, P.Icmp))
    assert got.packet.src == h1.ip


def test_encrypted_user_tunnel(X, sw_env):
    pytest.importorskip("cryptography")  # encrypted frames use AES-CFB
    P = X.P
    elg, objs = sw_env
    server = X.Switch("server", elg.next(), "127.0.0.1", 0)
    client = X.Switch("client", elg.next(), "127.0.0.1", 0)
    objs["switches"] += [server, client]
    server.start()
    client.start()
    server.add_network(9, X.Network.parse("10.9.0.0/16"))
    client.add_network(9, X.Network.parse("10.9.0.0/16"))
    server.add_user("alice5AA", "sekrit", 9)
    client.add_user_client("alice5AA", "sekrit", 9, "127.0.0.1",
                           server.bind_port)
    time.sleep(0.2)
    assert any(i.name == "user:alice5AA" for i in server.list_ifaces())
    hs = FakeHost(X, "02:cc:00:00:00:01", "10.9.0.1", 9,
                  ("127.0.0.1", server.bind_port))
    hc = FakeHost(X, "02:cc:00:00:00:02", "10.9.0.2", 9,
                  ("127.0.0.1", client.bind_port))
    objs["hosts"] += [hs, hc]
    hs.gratuitous_arp()
    hc.gratuitous_arp()
    time.sleep(0.15)
    hs.arp_request("10.9.0.2")
    req = hc.recv_ether(lambda e: isinstance(e.packet, P.Arp)
                        and e.packet.op == P.ARP_REQUEST)
    assert req.packet.spa == hs.ip


def test_switch_command_grammar(X, sw_env):
    Command = X.Command
    app = X.Application.create(workers=1)
    try:
        Command.execute(app, "add switch sw0 address 127.0.0.1:0")
        Command.execute(app, "add vpc 1314 to switch sw0 v4network "
                             "172.16.0.0/16")
        Command.execute(app, "add ip 172.16.0.21 to vpc 1314 in switch sw0")
        Command.execute(app, "add route r1 to vpc 1314 in switch sw0 "
                             "network 172.17.0.0/16 vni 1315")
        Command.execute(app, "add user bob00000 to switch sw0 password pw "
                             "vni 1314")
        assert Command.execute(app, "list vpc in switch sw0") == ["1314"]
        assert Command.execute(app, "list user in switch sw0") == \
            ["bob00000"]
        routes = Command.execute(
            app, "list-detail route in vpc 1314 in switch sw0")
        assert routes == ["r1 -> network 172.17.0.0/16 vni 1315"]
        cfg = X.persist.current_config(app)
        assert "add switch sw0 address" in cfg
        assert "add vpc 1314 to switch sw0 v4network 172.16.0.0/16" in cfg
        assert "add user bob00000 to switch sw0 password pw vni 1314" in cfg
        Command.execute(app, "remove route r1 from vpc 1314 in switch sw0")
        assert Command.execute(app, "list route in vpc 1314 in switch "
                                    "sw0") == []
        Command.execute(app, "remove switch sw0")
        assert Command.execute(app, "list switch") == []
    finally:
        app.close()


# --------------------------------------------------- tests/test_vtcp.py

class _H:
    def on_connected(self, c): ...

    def on_data(self, c, data): ...

    def on_eof(self, c):
        c.close()

    def on_closed(self, c, err): ...

    def on_drained(self, c): ...


@pytest.fixture
def env(X):
    elg = X.EventLoopGroup("vtcp", 1)
    objs = []
    yield elg, objs
    for o in objs:
        try:
            o.stop() if isinstance(o, X.Switch) else o.close()
        except Exception:
            pass
    time.sleep(0.05)
    elg.close()


def _switch(X, elg, objs, vni, net):
    sw = X.Switch("sw", elg.next(), "127.0.0.1", 0)
    objs.append(sw)
    sw.start()
    return sw, sw.add_network(vni, X.Network.parse(net))


def test_in_switch_echo(X, env):
    """Client VConn -> server VServerSock entirely inside one VPC."""
    elg, objs = env
    sw, _ = _switch(X, elg, objs, 5, "10.5.0.0/16")
    got = {"data": b"", "eof": False, "connected": False, "closed": 0}

    class EchoH(_H):
        def on_data(self, c, data):
            c.write(data)

        def on_closed(self, c, err):
            got["closed"] += 1

    class ClientH(_H):
        def on_connected(self, c):
            got["connected"] = True
            c.write(b"hello user-space tcp")
            c.shutdown_write()

        def on_data(self, c, data):
            got["data"] += data

        def on_eof(self, c):
            got["eof"] = True
            c.close()

        def on_closed(self, c, err):
            got["closed"] += 1

    def setup():
        X.VServerSock(sw, 5, X.parse_ip("10.5.0.1"), 8080,
                      lambda c: c.set_handler(EchoH()))
        vc = X.VConn.connect(sw, 5, X.parse_ip("10.5.0.2"),
                             X.parse_ip("10.5.0.1"), 8080)
        vc.set_handler(ClientH())

    sw.loop.call_sync(setup)
    t0 = time.time()
    while time.time() - t0 < 5 and not got["eof"]:
        time.sleep(0.01)
    assert got["connected"]
    assert got["data"] == b"hello user-space tcp"
    assert got["eof"]


def test_large_transfer_in_switch(X, env):
    """Window/segmentation: 1MB through MSS-sized user-space segments."""
    elg, objs = env
    sw, _ = _switch(X, elg, objs, 6, "10.6.0.0/16")
    payload = bytes(range(256)) * 4096
    got = {"data": b"", "eof": False}

    class SinkH(_H):
        def on_data(self, c, data):
            got["data"] += data

        def on_eof(self, c):
            got["eof"] = True
            c.close()

    class SendH(SinkH):
        def on_connected(self, c):
            c.write(payload)
            c.shutdown_write()

    def setup():
        X.VServerSock(sw, 6, X.parse_ip("10.6.0.1"), 9090,
                      lambda c: c.set_handler(SinkH()))
        vc = X.VConn.connect(sw, 6, X.parse_ip("10.6.0.2"),
                             X.parse_ip("10.6.0.1"), 9090)
        vc.set_handler(SendH())

    sw.loop.call_sync(setup)
    t0 = time.time()
    while time.time() - t0 < 20 and not got["eof"]:
        time.sleep(0.02)
    assert got["eof"], f"got {len(got['data'])} bytes"
    assert got["data"] == payload


class WireTcpPeer(FakeHost):
    """A VXLAN host that speaks raw TCP segments against the switch's
    user-space stack (exactly what goes on the wire)."""

    def announce(self):
        self.gratuitous_arp()

    def send_tcp(self, dst_mac, dst_ip, tcp):
        P = self.P
        ip = P.Ipv4(self.ip, dst_ip, P.PROTO_TCP, b"", packet=tcp)
        self.send_ether(P.Ethernet(dst_mac, self.mac, P.ETHER_TYPE_IPV4,
                                   b"", ip))

    def recv_tcp(self, timeout=5.0):
        P = self.P
        e = self.recv_ether(lambda e: isinstance(e.packet, P.Ipv4)
                            and isinstance(e.packet.packet, P.Tcp),
                            timeout=timeout)
        return e.packet.packet


def test_wire_handshake_data_fin(X, env):
    P = X.P
    elg, objs = env
    sw, _ = _switch(X, elg, objs, 8, "10.8.0.0/16")
    srv_ip = X.parse_ip("10.8.0.1")
    received = []

    class H(_H):
        def on_data(self, c, data):
            received.append(data)
            c.write(b"pong:" + data)

    sw.loop.call_sync(lambda: X.VServerSock(
        sw, 8, srv_ip, 7070, lambda c: c.set_handler(H())))
    srv_mac = X.synthetic_mac(8, srv_ip)
    peer = WireTcpPeer(X, "02:dd:00:00:00:01", "10.8.0.99", 8,
                       ("127.0.0.1", sw.bind_port))
    objs.append(peer)
    peer.announce()
    time.sleep(0.1)
    peer.send_tcp(srv_mac, srv_ip, P.Tcp(40000, 7070, seq=1000, ack=0,
                                         flags=P.TCP_SYN, window=65535))
    synack = peer.recv_tcp()
    assert synack.flags & P.TCP_SYN and synack.flags & P.TCP_ACK
    assert synack.ack == 1001
    isn = synack.seq
    peer.send_tcp(srv_mac, srv_ip, P.Tcp(40000, 7070, seq=1001,
                                         ack=isn + 1, flags=P.TCP_ACK,
                                         window=65535, data=b"ping"))
    seen_data = b""
    for _ in range(4):
        seg = peer.recv_tcp()
        if seg.data:
            seen_data += seg.data
            peer.send_tcp(srv_mac, srv_ip, P.Tcp(
                40000, 7070, seq=1005,
                ack=(seg.seq + len(seg.data)) & 0xFFFFFFFF,
                flags=P.TCP_ACK, window=65535))
            break
    assert seen_data == b"pong:ping"
    assert received == [b"ping"]
    peer.send_tcp(srv_mac, srv_ip, P.Tcp(40000, 7070, seq=1005,
                                         ack=(isn + 6) & 0xFFFFFFFF,
                                         flags=P.TCP_FIN | P.TCP_ACK,
                                         window=65535))
    fin_seen = False
    for _ in range(4):
        try:
            seg = peer.recv_tcp(timeout=2)
        except TimeoutError:
            break
        if seg.flags & P.TCP_FIN:
            fin_seen = True
            break
    assert fin_seen


def test_wire_rst_on_closed_port(X, env):
    P = X.P
    elg, objs = env
    sw, net = _switch(X, elg, objs, 9, "10.9.0.0/16")
    ip = X.parse_ip("10.9.0.1")
    net.ips.add(ip, X.synthetic_mac(9, ip))
    sw.loop.call_sync(lambda: X.get_l4(sw))
    peer = WireTcpPeer(X, "02:dd:00:00:00:02", "10.9.0.99", 9,
                       ("127.0.0.1", sw.bind_port))
    objs.append(peer)
    peer.announce()
    time.sleep(0.1)
    peer.send_tcp(X.synthetic_mac(9, ip), ip,
                  P.Tcp(41000, 1, seq=5, ack=0, flags=P.TCP_SYN,
                        window=1000))
    seg = peer.recv_tcp()
    assert seg.flags & P.TCP_RST


def test_retransmission_recovers_lost_segment(X, env):
    """Drop the first data segment at the fake peer; retransmit
    delivers."""
    P = X.P
    elg, objs = env
    sw, _ = _switch(X, elg, objs, 11, "10.11.0.0/16")
    srv_ip = X.parse_ip("10.11.0.1")

    class H(_H):
        def on_connected(self, c):
            c.write(b"DATA")

    sw.loop.call_sync(lambda: X.VServerSock(
        sw, 11, srv_ip, 6060, lambda c: c.set_handler(H())))
    srv_mac = X.synthetic_mac(11, srv_ip)
    peer = WireTcpPeer(X, "02:dd:00:00:00:03", "10.11.0.99", 11,
                       ("127.0.0.1", sw.bind_port))
    objs.append(peer)
    peer.announce()
    time.sleep(0.1)
    peer.send_tcp(srv_mac, srv_ip, P.Tcp(42000, 6060, seq=1, ack=0,
                                         flags=P.TCP_SYN, window=65535))
    synack = peer.recv_tcp()
    isn = synack.seq
    peer.send_tcp(srv_mac, srv_ip, P.Tcp(42000, 6060, seq=2, ack=isn + 1,
                                         flags=P.TCP_ACK, window=65535))
    first = peer.recv_tcp()
    assert first.data == b"DATA"
    second = peer.recv_tcp(timeout=5)
    assert second.data == b"DATA" and second.seq == first.seq


# ------------------------------------- tests/test_control_extras.py

@pytest.fixture
def app(X):
    a = X.Application.create(workers=1)
    yield a
    a.close()


def test_vpc_proxy_bridges_to_host(X, app):
    Command = X.Command
    target = IdServer("P")  # raw: sends id then echoes
    try:
        Command.execute(app, "add switch sw0 address 127.0.0.1:0")
        Command.execute(app, "add vpc 7 to switch sw0 v4network "
                             "10.7.0.0/16")
        assert Command.execute(
            app, "add proxy 10.7.0.9:80 to vpc 7 in switch sw0 "
                 f"address 127.0.0.1:{target.port}") == "OK"
        assert Command.execute(
            app, "list proxy in vpc 7 in switch sw0") == ["10.7.0.9:80"]
        detail = Command.execute(
            app, "list-detail proxy in vpc 7 in switch sw0")
        assert f"127.0.0.1:{target.port}" in detail[0]
        sw = app.switches["sw0"]
        got = {"data": b""}

        class ClientH(_H):
            def on_connected(self, c):
                c.write(b"ping")

            def on_data(self, c, data):
                got["data"] += data

        def setup():
            vc = X.VConn.connect(sw, 7, X.parse_ip("10.7.0.5"),
                                 X.parse_ip("10.7.0.9"), 80)
            vc.set_handler(ClientH())

        sw.loop.call_sync(setup)
        t0 = time.time()
        while time.time() - t0 < 5 and got["data"] != b"Pping":
            time.sleep(0.01)
        assert got["data"] == b"Pping"
        assert Command.execute(
            app, "remove proxy 10.7.0.9:80 from vpc 7 in switch sw0") == "OK"
        assert Command.execute(app, "list proxy in vpc 7 in switch sw0") \
            == []
    finally:
        target.close()


def test_update_switch(X, app):
    """test_update_switch_and_socks5's switch half (its socks5 half is
    test_torch_control.py's test_update_socks5)."""
    Command = X.Command
    Command.execute(app, "add switch swu address 127.0.0.1:0")
    Command.execute(app, "add vpc 4 to switch swu v4network 10.4.0.0/16")
    assert Command.execute(
        app, "update switch swu mac-table-timeout 60000 "
             "arp-table-timeout 120000") == "OK"
    sw = app.switches["swu"]
    assert sw.mac_table_timeout_ms == 60000
    net = sw.networks[4]
    assert net.macs.timeout_ms == 60000 and net.arps.timeout_ms == 120000
    Command.execute(app, "remove switch swu")
    assert app.switches == {}


# ------------------------ test_mirror / test_loop_death / test_metrics

def read_pcap(path):
    """-> list of frame bytes (validates headers)."""
    with open(path, "rb") as f:
        head = f.read(24)
        magic, _, _, _, _, _, link = struct.unpack("<IHHiIII", head)
        assert magic == 0xA1B2C3D4 and link == 1
        frames = []
        while True:
            rh = f.read(16)
            if len(rh) < 16:
                break
            _, _, caplen, _ = struct.unpack("<IIII", rh)
            frames.append(f.read(caplen))
    return frames


def _arp_to_gateway(X, vni, spa, tpa):
    P = X.P
    arp = P.Arp(P.ARP_REQUEST, sha=b"\x02" * 6, spa=X.parse_ip(spa),
                tha=b"\x00" * 6, tpa=X.parse_ip(tpa))
    e = P.Ethernet(b"\xff" * 6, b"\x02" * 6, P.ETHER_TYPE_ARP, b"", arp)
    return P.Vxlan(vni, e).to_bytes()


def test_switch_tap_captures_frames(X, tmp_path):
    Mirror = X.Mirror
    Mirror.reset()
    out = str(tmp_path / "sw.pcap")
    Mirror.get().set_config({"enabled": True, "output": out,
                             "origins": [{"origin": "switch"}]})
    elg = X.EventLoopGroup("sw", 1)
    sw = X.Switch("sw0", elg.next(), "127.0.0.1", 0)
    try:
        sw.add_network(7, X.Network(X.parse_ip("10.7.0.0"),
                                    X.mask_bytes(24)))
        sw.start()
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(_arp_to_gateway(X, 7, "10.7.0.2", "10.7.0.1"),
                 ("127.0.0.1", sw.bind_port))
        s.close()
        t0 = time.time()
        while time.time() - t0 < 5:
            if os.path.exists(out) and read_pcap(out):
                break
            time.sleep(0.05)
        frames = read_pcap(out)
        assert frames and frames[0][:6] == b"\xff" * 6
    finally:
        sw.stop()
        elg.close()
        Mirror.reset()


def crash_loop(lp, timeout=5.0):
    """Simulate an abnormal loop death: make the poll machinery raise."""
    def boom():
        raise RuntimeError("injected loop crash")
    lp.one_poll = boom
    lp.run_on_loop(lambda: None)
    t0 = time.time()
    while lp._thread.is_alive() and time.time() - t0 < timeout:
        time.sleep(0.01)
    assert not lp._thread.is_alive(), "loop thread did not die"


def test_switch_rehomes_on_crash(X):
    P = X.P
    elg = X.EventLoopGroup("sw", 2)
    sw = X.Switch("sw0", elg.next(), "127.0.0.1", 0, elg=elg)
    try:
        sw.add_network(9, X.Network.parse("10.9.0.0/16"))
        sw.start()
        gw = X.parse_ip("10.9.0.1")
        sw.networks[9].ips.add(gw, X.synthetic_mac(9, gw))

        def arp_probe():
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.settimeout(2)
            s.sendto(_arp_to_gateway(X, 9, "10.9.0.2", "10.9.0.1"),
                     ("127.0.0.1", sw.bind_port))
            try:
                data, _ = s.recvfrom(4096)
            except socket.timeout:
                return None
            finally:
                s.close()
            vx = P.Vxlan.parse(data)
            return vx.ether.packet.op \
                if isinstance(vx.ether.packet, P.Arp) else None

        assert arp_probe() == P.ARP_REPLY
        victim = sw.loop
        crash_loop(victim)
        t0 = time.time()
        while not (sw.loop is not victim and sw.started):
            assert time.time() - t0 < 5, "switch re-home"
            time.sleep(0.02)
        deadline = time.time() + 5
        while time.time() < deadline:
            if arp_probe() == P.ARP_REPLY:
                break
        else:
            raise AssertionError("switch never answered after re-home")
    finally:
        sw.stop()
        elg.close()


def test_switch_families_pre_registered(X):
    """test_metrics.py's pre-registration case, its swmetrics half:
    the switch's closed-vocabulary families exist, at zero, on a scrape
    before any event."""
    X.swmetrics  # noqa: B018 — the registry module
    text = X.GlobalInspection.get().registry.prometheus_text()
    for reason in ("acl_deny", "arp_unresolved", "egress_short_write",
                   "route_miss", "same_iface", "unknown_vni"):
        assert f'vproxy_switch_drops_total{{reason="{reason}"}}' in text
    assert 'vproxy_switch_slowpath_total{reason="bad_csum"}' in text
    assert 'vproxy_switch_forwards_total{path="fast"}' in text
    assert "vproxy_switch_rx_total" in text
