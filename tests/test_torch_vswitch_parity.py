"""The port's switch data plane against the reference's, the matchers
on the CPU.

Ported reference cases, each run on both packages (`pkg`):

* tests/test_fastpath.py (7): the numpy fast path against the object
  path on the same burst (routed, L2, ACL, no raw egress, vni override,
  drop counters, corrupt checksums, the incremental checksum);
* tests/test_flowcache.py (8, skipped like the reference's without the
  native flow cache): the native flow table over real UDP sockets;
* test_sketch.py::test_flow_cache_hits_drain_into_flows_dim.

Parity gates between the packages, exact (bytes and int counts):

* one seeded burst (300 IPv4 and 200 IPv6 routes, a 200-rule UDP ACL:
  above SMALL_TABLE, so the matchers serve) through both packages'
  switches in object mode and fast mode, on "torch" / "jax" and
  "torch-fp" / "jax-fp": equal egress bytes and drop counters, and the
  CidrMatchers really dispatched;
* one command script of switch, vpc, ip, route, arp, user, user-client,
  remote switch and proxy gives equal output in both packages, and a
  config saved by either loads in the other;
* a KernelError raised by the CIDR wrapper during a burst reaches the
  caller, and no frame of the burst is forwarded;
* chip_smoke.py's `switch` phase at a small size.
"""
import os
import random
import socket
import time

import pytest

from test_torch_dns import PKGS, mod
from test_torch_tcplb import _torch_cpu, IdServer  # noqa: F401
from test_torch_vswitch import NS, X, pkg  # noqa: F401

def switch_counters(X):
    """The switch's counters (swmetrics) by name.label, as the
    reference's bench_snapshot keys them."""
    SM = X.swmetrics
    out = {f"vproxy_switch_drops_total.{r}":
           SM._ctr("vproxy_switch_drops_total", reason=r).value()
           for r in SM.DROP_REASONS}
    out.update({f"vproxy_switch_slowpath_total.{r}":
                SM._ctr("vproxy_switch_slowpath_total", reason=r).value()
                for r in SM.SLOWPATH_REASONS})
    out.update({f"vproxy_switch_forwards_total.{p}":
                SM._ctr("vproxy_switch_forwards_total", path=p).value()
                for p in SM.FORWARD_PATHS})
    out["vproxy_switch_rx_total"] = SM._ctr("vproxy_switch_rx_total").value()
    return out


def delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


# ------------------------------------------------ tests/test_fastpath.py

class RecIface:
    """Recording egress iface with raw support."""

    local_side_vni = 0

    def __init__(self, name):
        self.name = name
        self.frames: list = []

    def send_vxlan(self, sw, pkt) -> None:
        self.frames.append(pkt.to_bytes())

    def send_vxlan_raw(self, sw, data) -> None:
        self.frames.append(data)


class ObjOnlyIface(RecIface):
    """No raw support: fast path must fall back to the object path."""

    send_vxlan_raw = None


def mk_world(X, fastpath: bool, out_cls=RecIface, acl_rules=None,
             default_allow=True):
    os.environ["VPROXY_TPU_SWITCH_FASTPATH"] = "1" if fastpath else "0"
    try:
        Network, parse_ip = X.Network, X.parse_ip
        loop = X.SelectorEventLoop("fp-t")
        loop.loop_thread()
        sg = X.SecurityGroup("t", default_allow=default_allow)
        if acl_rules:
            sg.extend_rules(acl_rules)
        sw = X.Switch("swt", loop, "127.0.0.1", 0, bare_vxlan_access=sg)
        sw.start()
        n1 = sw.add_network(101, Network.parse("10.1.0.0/16"))
        n2 = sw.add_network(102, Network.parse("10.2.0.0/16"))
        gw1 = parse_ip("10.1.0.1")
        n1.ips.add(gw1, X.synthetic_mac(101, gw1))
        s2 = parse_ip("10.2.255.254")
        n2.ips.add(s2, X.synthetic_mac(102, s2))
        for i in range(40):
            n1.add_route(X.RouteRule(f"r{i}",
                                     Network.parse(f"10.2.{i}.0/24"),
                                     to_vni=102))
        out = out_cls("out")
        dst_mac = b"\x02\xfe\x00\x00\x00\x01"
        n2.macs.record(dst_mac, out)
        for i in range(40):
            for c in (1, 2, 3):
                n2.arps.record(bytes([10, 2, i, c]), dst_mac)
        l2out = out_cls("l2out")
        n1.macs.record(b"\x02\xee\x00\x00\x00\x07", l2out)
        return loop, sw, n1, n2, out, l2out
    finally:
        os.environ.pop("VPROXY_TPU_SWITCH_FASTPATH", None)


def mk_burst(X, n=200):
    """Mixed burst: routed-v4 (fast), known-unicast L2 (fast), arp
    (slow), ttl-expired (slow), route miss (drop)."""
    P, parse_ip = X.P, X.parse_ip
    gw1_mac = X.synthetic_mac(101, parse_ip("10.1.0.1"))
    l2_mac = b"\x02\xee\x00\x00\x00\x07"
    burst = []
    for i in range(n):
        src_mac = bytes([0x02, 0xaa, 0, 0, i >> 8, i & 255])
        src_ip = bytes([10, 1, (i >> 8) & 255, 1 + (i % 250)])
        kind = i % 8
        if kind < 4:
            ip = P.Ipv4(src=src_ip, dst=bytes([10, 2, i % 40, 1 + i % 3]),
                        proto=17, payload=b"u" * (10 + i % 5), ttl=64)
            eth = P.Ethernet(gw1_mac, src_mac, 0x0800, b"", packet=ip)
        elif kind == 4:
            ip = P.Ipv4(src=src_ip, dst=bytes([10, 1, 9, 9]),
                        proto=17, payload=b"l2", ttl=9)
            eth = P.Ethernet(l2_mac, src_mac, 0x0800, b"", packet=ip)
        elif kind == 5:
            arp = P.Arp(P.ARP_REQUEST, sha=src_mac, spa=src_ip,
                        tha=b"\x00" * 6, tpa=parse_ip("10.1.0.1"))
            eth = P.Ethernet(P.BROADCAST_MAC, src_mac, P.ETHER_TYPE_ARP,
                             b"", arp)
        elif kind == 6:
            ip = P.Ipv4(src=src_ip, dst=bytes([10, 2, 1, 1]),
                        proto=17, payload=b"t", ttl=1)
            eth = P.Ethernet(gw1_mac, src_mac, 0x0800, b"", packet=ip)
        else:
            ip = P.Ipv4(src=src_ip, dst=bytes([10, 77, 1, 1]),
                        proto=17, payload=b"m", ttl=64)
            eth = P.Ethernet(gw1_mac, src_mac, 0x0800, b"", packet=ip)
        burst.append((P.Vxlan(101, eth).to_bytes(),
                      f"127.0.0.{1 + i % 9}", 40000 + i % 13))
    return burst


def _norm(X, frames):
    """Parsed, normalized egress (vni, macs, ttl, checksum, ip header
    fields, payload), each IPv4 header checksum checked on the bytes."""
    P = X.P
    out = []
    for f in frames:
        vx = P.Vxlan.parse(f)
        e = vx.ether
        rec = [vx.vni, e.dst.hex(), e.src.hex(), e.ether_type]
        p = e.packet
        if isinstance(p, P.Ipv4):
            rec += [p.src.hex(), p.dst.hex(), p.ttl, p.proto,
                    bytes(p.payload).hex()]
            hdr = bytearray(f[22:42])
            want = (hdr[10] << 8) | hdr[11]
            hdr[10:12] = b"\x00\x00"
            assert P.checksum(bytes(hdr)) == want, "bad ip checksum"
        elif isinstance(p, P.Arp):
            rec += [p.op, p.sha.hex(), p.spa.hex(), p.tpa.hex()]
        out.append(tuple(rec))
    return sorted(out)


def run_both(X, burst, **kw):
    res = []
    for fast in (True, False):
        loop, sw, n1, n2, out, l2out = mk_world(X, fast, **kw)
        assert (sw.fastpath is not None) == fast
        try:
            loop.call_sync(lambda: sw._input_batch(list(burst)),
                           timeout=120)
            time.sleep(0.05)
            res.append((_norm(X, out.frames), _norm(X, l2out.frames),
                        sorted(m for m, _ in n1.macs.entries()),
                        sorted(a for a, _ in n1.arps.entries()),
                        sorted(a for a, _ in n2.arps.entries())))
        finally:
            sw.stop()
            loop.close()
    return res


def test_fastpath_parity_mixed_burst(X):
    fast, slow = run_both(X, mk_burst(X, 200))
    assert fast[0] == slow[0], "routed egress diverged"
    assert len(fast[0]) > 0
    assert fast[1] == slow[1], "l2 egress diverged"
    assert fast[2] == slow[2], "mac learns diverged"
    assert fast[3] == slow[3], "ingress arp learns diverged"
    assert fast[4] == slow[4]


def test_fastpath_parity_with_acl(X):
    acls = [X.AclRule("deny7", X.Network.parse("127.0.0.7/32"),
                      X.Proto.UDP, 0, 65535, False),
            X.AclRule("allow-lo", X.Network.parse("127.0.0.0/8"),
                      X.Proto.UDP, 0, 65535, True)]
    fast, slow = run_both(X, mk_burst(X, 200), acl_rules=acls,
                          default_allow=False)
    assert fast[0] == slow[0]
    assert len(fast[0]) > 0
    noacl, _ = run_both(X, mk_burst(X, 200))
    assert len(fast[0]) < len(noacl[0])


def test_fastpath_falls_back_without_raw_egress(X):
    fast, slow = run_both(X, mk_burst(X, 200), out_cls=ObjOnlyIface)
    assert fast[0] == slow[0]
    assert len(fast[0]) > 0


def test_fastpath_vni_override_parity(X):
    """An ingress iface forcing a vni: both paths rewrite it."""
    P = X.P
    burst = mk_burst(X, 120)
    res = []
    for fastp in (True, False):
        loop, sw, n1, n2, out, l2out = mk_world(X, fastp)
        try:
            remotes = {(b[1], b[2]) for b in burst}

            def reg():
                for r in remotes:
                    sw._resolve_remote(r).local_side_vni = 101
            loop.call_sync(reg, timeout=30)
            re_burst = [(P.Vxlan(999, P.Vxlan.parse(data).ether).to_bytes(),
                         ip, port) for data, ip, port in burst]
            loop.call_sync(lambda: sw._input_batch(re_burst), timeout=120)
            time.sleep(0.05)
            res.append(_norm(X, out.frames))
        finally:
            sw.stop()
            loop.close()
    assert res[0] == res[1]
    assert len(res[0]) > 0


def test_fastpath_drop_reason_counters(X):
    """Route misses, ACL denies and rx/forward totals land in the
    vproxy_switch_* counters."""
    burst = mk_burst(X, 200)
    n_miss = sum(1 for i in range(200) if i % 8 == 7)
    before = switch_counters(X)
    loop, sw, n1, n2, out, l2out = mk_world(X, True)
    try:
        loop.call_sync(lambda: sw._input_batch(list(burst)), timeout=120)
        time.sleep(0.05)
    finally:
        sw.stop()
        loop.close()
    d = delta(before, switch_counters(X))
    assert d.get("vproxy_switch_rx_total") == 200
    assert d.get("vproxy_switch_drops_total.route_miss") == n_miss
    assert d.get("vproxy_switch_forwards_total.fast", 0) > 0
    assert "vproxy_switch_drops_total.acl_deny" not in d

    before = switch_counters(X)
    loop, sw, n1, n2, out, l2out = mk_world(X, True, default_allow=False)
    try:
        loop.call_sync(lambda: sw._input_batch(list(burst)), timeout=120)
        time.sleep(0.05)
        assert not out.frames
    finally:
        sw.stop()
        loop.close()
    d = delta(before, switch_counters(X))
    assert d.get("vproxy_switch_drops_total.acl_deny", 0) > 0


def test_fastpath_corrupt_checksum_parity(X):
    """Frames with a corrupt inbound IPv4 header checksum go to the
    object path (slowpath bad_csum) so both pipelines stay identical."""
    P, parse_ip = X.P, X.parse_ip
    gw1_mac = X.synthetic_mac(101, parse_ip("10.1.0.1"))
    burst = []
    for i in range(60):
        src_mac = bytes([0x02, 0xaa, 0, 0, 0, 1 + i])
        ip = P.Ipv4(src=bytes([10, 1, 0, 1 + i]),
                    dst=bytes([10, 2, i % 40, 1 + i % 3]),
                    proto=17, payload=b"c" * (8 + i % 4), ttl=64)
        eth = P.Ethernet(gw1_mac, src_mac, 0x0800, b"", packet=ip)
        raw = bytearray(P.Vxlan(101, eth).to_bytes())
        if i % 3 == 0:
            raw[32] ^= 0x55
        burst.append((bytes(raw), f"127.0.0.{1 + i % 9}", 40000 + i))
    before = switch_counters(X)
    res = []
    for fastp in (True, False):
        loop, sw, n1, n2, out, l2out = mk_world(X, fastp)
        try:
            loop.call_sync(lambda: sw._input_batch(list(burst)),
                           timeout=120)
            time.sleep(0.05)
            res.append(_norm(X, out.frames))
        finally:
            sw.stop()
            loop.close()
    assert res[0] == res[1], "corrupt-checksum egress diverged"
    assert len(res[0]) > 0
    d = delta(before, switch_counters(X))
    assert d.get("vproxy_switch_slowpath_total.bad_csum", 0) == 20


def test_fastpath_incremental_checksum_exact(X):
    """RFC 1624 incremental update == full recompute for every ttl."""
    P = X.P
    _IP_CSUM, _IP_TTL = X.fastpath._IP_CSUM, X.fastpath._IP_TTL
    for ttl in (2, 3, 64, 128, 255):
        ip = P.Ipv4(src=bytes([10, 1, 2, 3]), dst=bytes([10, 2, 3, 4]),
                    proto=17, payload=b"x" * 9, ttl=ttl)
        raw = bytearray(b"\x00" * 22 + ip.to_bytes())
        c = (raw[_IP_CSUM] << 8) | raw[_IP_CSUM + 1]
        raw[_IP_TTL] -= 1
        x = (c ^ 0xFFFF) + 0xFEFF
        x = (x & 0xFFFF) + (x >> 16)
        x = (x & 0xFFFF) + (x >> 16)
        c2 = x ^ 0xFFFF
        hdr = bytearray(raw[22:42])
        hdr[10:12] = b"\x00\x00"
        assert P.checksum(bytes(hdr)) == c2, ttl


# ----------------------------------------------- tests/test_flowcache.py

DST_MAC = b"\x02\xfe\x00\x00\x00\x01"


@pytest.fixture
def fc(X, monkeypatch):
    """The package's vtl, its flow cache required (the reference's
    module skip), single-datagram bursts classified (MIN_BURST 1)."""
    vtl = X.vtl
    if not (vtl.PROVIDER == "native" and vtl.flowcache_supported()):
        pytest.skip("native flow cache unavailable (provider/.so)")
    monkeypatch.setattr(X.fastpath, "MIN_BURST", 1)
    yield vtl
    X.failpoint.clear()


class World:
    """Switch + 2 VPCs + routes + a real receiver socket as egress."""

    def __init__(self, X, flowcache=True, size=None, pollers=0,
                 default_allow=True):
        self.X = X
        self.vtl = vtl = X.vtl
        Network, parse_ip = X.Network, X.parse_ip
        env = {"VPROXY_TPU_FLOWCACHE": "1" if flowcache else "0",
               "VPROXY_TPU_FLOWCACHE_TTL_MS": "60000",
               "VPROXY_TPU_SWITCH_POLLERS": str(pollers)}
        if size:
            env["VPROXY_TPU_FLOWCACHE_SIZE"] = str(size)
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            self.loop = X.SelectorEventLoop("fc-t")
            self.loop.loop_thread()
            self.sg = X.SecurityGroup("fc-acl", default_allow=default_allow)
            self.sw = X.Switch("fct", self.loop, "127.0.0.1", 0,
                               bare_vxlan_access=self.sg)
            self.sw.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        self.n1 = self.sw.add_network(101, Network.parse("10.1.0.0/16"))
        self.n2 = self.sw.add_network(102, Network.parse("10.2.0.0/16"))
        self.gw_mac = X.synthetic_mac(101, parse_ip("10.1.0.1"))
        self.n1.ips.add(parse_ip("10.1.0.1"), self.gw_mac)
        self.n2.ips.add(parse_ip("10.2.255.254"),
                        X.synthetic_mac(102, parse_ip("10.2.255.254")))
        self.n1.add_route(X.RouteRule("r0", Network.parse("10.2.0.0/16"),
                                      to_vni=102))
        self.rx, self.rx_port = self.mk_rx()
        self.sw.add_remote_switch("out", "127.0.0.1", self.rx_port)
        self.out = self.sw.ifaces[("remote", "out")][0]
        self.n2.macs.record(DST_MAC, self.out)
        self.tx = vtl.udp_socket()

    def mk_rx(self):
        rx = self.vtl.udp_bind("127.0.0.1", 0)
        self.vtl.set_rcvbuf(rx, 4 << 20)
        return rx, self.vtl.sock_name(rx)[1]

    def frame(self, last_octet, ttl=64, src=9, src_mac_tail=1):
        P, parse_ip = self.X.P, self.X.parse_ip
        dst = parse_ip(f"10.2.0.{last_octet}")
        self.n2.arps.record(dst, DST_MAC)
        ip = P.Ipv4(src=parse_ip(f"10.1.{src // 250}.{1 + src % 250}"),
                    dst=dst, proto=17, payload=b"x" * 18, ttl=ttl)
        eth = P.Ethernet(self.gw_mac,
                         b"\x02\xaa\x00\x00\x00" + bytes([src_mac_tail]),
                         0x0800, b"", packet=ip)
        return P.Vxlan(101, eth).to_bytes()

    def send(self, dgrams, tx=None):
        tx = tx if tx is not None else self.tx
        for d in dgrams:
            self.vtl.sendto(tx, d, "127.0.0.1", self.sw.bind_port)

    def drain(self, rx=None, expect=0, timeout=2.0):
        rx = rx if rx is not None else self.rx
        got, t0 = [], time.monotonic()
        while time.monotonic() - t0 < timeout:
            r = self.vtl.recvmmsg(rx)
            if r:
                got.extend(r)
                if expect and len(got) >= expect:
                    break
            else:
                time.sleep(0.01)
        return got

    def converge(self, dgrams, tries=6, rx=None):
        """Send waves until the C table serves them; -> hits delta of
        the final wave, then a flush of the leftovers."""
        dh = 0
        for _ in range(tries):
            h0 = self.vtl.flowcache_counters()[0]
            self.send(dgrams)
            self.drain(rx=rx, expect=len(dgrams), timeout=1.0)
            dh = self.vtl.flowcache_counters()[0] - h0
            if dh >= len(dgrams):
                break
        self.drain(rx=rx, timeout=0.3)
        return dh

    def close(self):
        try:
            self.sw.stop()
            time.sleep(0.2)
            self.loop.close()
        except Exception:
            pass
        for fd in (self.rx, self.tx):
            try:
                self.vtl.close(fd)
            except OSError:
                pass


@pytest.fixture
def world(X, fc):
    w = World(X)
    yield w
    w.close()


def test_install_hit_and_rewrite_parity(world, fc):
    vtl = fc
    dgrams = [world.frame(i) for i in range(1, 33)]
    world.send(dgrams)
    first = world.drain(expect=len(dgrams))
    assert len(first) == len(dgrams)
    assert world.converge(dgrams) >= len(dgrams)
    h0 = vtl.flowcache_counters()[0]
    world.send(dgrams)
    second = world.drain(expect=len(dgrams))
    assert vtl.flowcache_counters()[0] - h0 >= len(dgrams)
    assert len(second) == len(dgrams)
    assert sorted(d for d, _, _ in first) == sorted(d for d, _, _ in second)
    d = second[0][0]
    assert d[4:7] == (102).to_bytes(3, "big")
    assert d[8:14] == DST_MAC
    assert d[30] == 63
    info = world.sw.flowcache_info()
    assert info["active"] and info["used"] >= len(dgrams)


def test_cache_off_equivalence(X, fc):
    won, woff = World(X), World(X, flowcache=False)
    try:
        assert woff.sw._fc is None and woff.sw.flowcache_info() is None
        dg_on = [won.frame(i) for i in range(1, 20)]
        dg_off = [woff.frame(i) for i in range(1, 20)]
        won.converge(dg_on)
        won.send(dg_on)
        got_on = won.drain(expect=len(dg_on))
        woff.send(dg_off)
        got_off = woff.drain(expect=len(dg_off))
        assert sorted(d for d, _, _ in got_on) == \
            sorted(d for d, _, _ in got_off)
    finally:
        won.close()
        woff.close()


def test_route_mutation_invalidates(world, fc):
    dgrams = [world.frame(i) for i in range(1, 9)]
    assert world.converge(dgrams) >= len(dgrams)
    s0 = fc.flowcache_counters()[3]
    world.n1.remove_route("r0")
    world.send(dgrams)
    assert world.drain(timeout=0.8) == []
    assert fc.flowcache_counters()[3] > s0


def test_acl_mutation_invalidates(X, world, fc):
    dgrams = [world.frame(i) for i in range(1, 9)]
    assert world.converge(dgrams) >= len(dgrams)
    world.sg.add_rule(X.AclRule("deny-lo", X.Network.parse("127.0.0.0/8"),
                                X.Proto.UDP, 0, 65535, False))
    world.send(dgrams)
    assert world.drain(timeout=0.8) == []
    world.send(dgrams)
    world.drain(timeout=0.5)
    assert fc.flowcache_counters()[5] > 0  # the acl_deny reason slot


def test_mac_move_and_iface_down_invalidate(world, fc):
    dgrams = [world.frame(i) for i in range(1, 9)]
    assert world.converge(dgrams) >= len(dgrams)
    rx2, rx2_port = world.mk_rx()
    try:
        world.sw.add_remote_switch("out2", "127.0.0.1", rx2_port)
        world.n2.macs.record(DST_MAC,
                             world.sw.ifaces[("remote", "out2")][0])
        world.send(dgrams)
        assert len(world.drain(rx=rx2, expect=len(dgrams))) == len(dgrams)
        assert world.drain(timeout=0.3) == []
        world.converge(dgrams, rx=rx2)
        world.sw.remove_iface("remote:out2")
        s0 = fc.flowcache_counters()[3]
        world.send(dgrams)
        assert world.drain(rx=rx2, timeout=0.8) == []
        assert fc.flowcache_counters()[3] > s0
    finally:
        fc.close(rx2)


def test_eviction_under_small_table(X, fc):
    w = World(X, size=256)
    try:
        dgrams = [w.frame(1 + (i % 250), src=1 + (i // 250))
                  for i in range(1000)]
        e0 = fc.flowcache_counters()[2]
        for _ in range(3):
            w.send(dgrams)
            w.drain(expect=len(dgrams), timeout=2.0)
        assert fc.flowcache_counters()[2] > e0
        info = w.sw.flowcache_info()
        assert info["size"] == 256 and info["used"] <= 256
    finally:
        w.close()


def test_multiqueue_pollers_deliver(X, fc):
    w = World(X, pollers=2)
    try:
        assert len(w.sw._pollers) == 2
        txs = [fc.udp_socket() for _ in range(4)]
        per_tx = [[w.frame(i, src=16 * k + i, src_mac_tail=k + 1)
                   for i in range(1, 9)] for k in range(4)]
        total = sum(len(d) for d in per_tx)
        try:
            for _ in range(5):
                for tx, dgrams in zip(txs, per_tx):
                    w.send(dgrams, tx=tx)
                w.drain(expect=total, timeout=2.0)
            w.drain(timeout=0.3)
            h0 = fc.flowcache_counters()[0]
            for tx, dgrams in zip(txs, per_tx):
                w.send(dgrams, tx=tx)
            assert len(w.drain(expect=total, timeout=3.0)) == total
            assert fc.flowcache_counters()[0] > h0
        finally:
            for tx in txs:
                fc.close(tx)
        w.loop.call_sync(lambda: w.sw.set_flowcache(False))
        assert w.sw._pollers == []
        w.send(dgrams)
        assert len(w.drain(expect=len(dgrams))) == len(dgrams)
    finally:
        w.close()


def test_failpoint_proves_generation_gate(X, world, fc):
    """With switch.flowcache.stale armed the route removal's bump is
    suppressed and the C table keeps forwarding the dead route; the
    next mutation's bump lands and forwarding stops."""
    dgrams = [world.frame(i) for i in range(1, 9)]
    assert world.converge(dgrams) >= len(dgrams)
    X.failpoint.arm("switch.flowcache.stale", count=1)
    world.n1.remove_route("r0")
    world.send(dgrams)
    assert len(world.drain(expect=len(dgrams))) == len(dgrams)
    world.n1.add_route(X.RouteRule("r-dummy",
                                   X.Network.parse("10.3.0.0/24"),
                                   to_vni=102))
    world.send(dgrams)
    assert world.drain(timeout=0.8) == []


def test_flow_cache_hits_drain_into_flows_dim(X, fc):
    """test_sketch.py's flow-cache case: the C per-flow hit tallies
    reach the analytics flows dimension through the switch's tick."""
    sketch = X.sketch
    sketch.configure(on=True)
    sketch.reset()
    w = World(X)
    try:
        frames = [w.frame(5)] * 6
        assert w.converge(frames) >= len(frames)
        w.sw._hh_flow_tick()
        top = sketch.top_table("flows")
        assert top, "flow hits did not reach the flows dimension"
        assert any("10.1.0" in e["key"] and "->10.2.0.5/17" in e["key"]
                   for e in top), top
        assert sketch.plane_updates_total("flow") > 0
    finally:
        w.close()
        sketch.reset()


# ------------------------------------------------ parity between packages

BACKENDS = {"torch": ("vproxy_tpu", "jax", "vproxy_tpu_torch", "torch"),
            "fp": ("vproxy_tpu", "jax-fp", "vproxy_tpu_torch", "torch-fp")}


def parity_burst(seed=5, n=1024):
    """-> (routes4, routes6, acl, burst spec): 300 IPv4 /24s and 200
    IPv6 /64s in vpc 1 into vni 2, 200 UDP ACL rules over the senders
    (every other one deny, some port-gated away from every port the
    switch can bind), and n frames: v4 and v6 to routed and unrouted
    addresses from 48 senders, a few ARP requests to the gateway."""
    rng = random.Random(seed)
    r4 = [f"10.{1 + i // 200}.{i % 200}.0/24" for i in range(300)]
    r6 = [f"fd00:2:{i:x}::/64" for i in range(200)]
    acl = []
    for i in range(200):
        lo, hi = (0, 65535) if i % 5 else (1, 1023)
        acl.append((f"a{i}", f"127.{1 + i // 100}.{i % 100}.0/24", lo, hi,
                    i % 2 == 0))
    senders = [f"127.{1 + j // 100}.{j % 100}.{7 + j % 3}"
               for j in rng.sample(range(200), 16)]
    senders += [f"127.9.0.{k}" for k in range(1, 33)]
    spec = []
    for i in range(n):
        k = rng.randrange(len(senders))
        kind = rng.random()
        if kind < 0.55:
            net = r4[rng.randrange(300)].split("/")[0].split(".")
            dst = f"{net[0]}.{net[1]}.{net[2]}.{rng.randrange(1, 255)}"
        elif kind < 0.65:
            dst = f"10.{rng.randrange(100, 200)}.{rng.randrange(256)}.9"
        elif kind < 0.85:
            dst = f"fd00:2:{rng.randrange(200):x}::{rng.randrange(1, 99):x}"
        elif kind < 0.95:
            dst = f"fd00:9:{rng.randrange(99):x}::1"
        else:
            dst = None  # ARP request to the gateway
        spec.append((i, k, dst))
    return r4, r6, acl, senders, spec


def parity_world(X, backend, fastpath, data):
    """Both vpcs, the routes, the ACL and a recording egress in vni 2,
    on `backend` (VPROXY_TPU_MATCHER as an operator sets it)."""
    r4, r6, acl, _, _ = data
    saved = {k: os.environ.get(k) for k in ("VPROXY_TPU_MATCHER",
                                            "VPROXY_TPU_SWITCH_FASTPATH")}
    os.environ["VPROXY_TPU_MATCHER"] = backend
    os.environ["VPROXY_TPU_SWITCH_FASTPATH"] = "1" if fastpath else "0"
    try:
        Network, parse_ip = X.Network, X.parse_ip
        loop = X.SelectorEventLoop("par-t")
        loop.loop_thread()
        sg = X.SecurityGroup("par", default_allow=True)
        sg.extend_rules([X.AclRule(a, Network.parse(n), X.Proto.UDP, lo, hi,
                                   ok) for a, n, lo, hi, ok in acl])
        sw = X.Switch("swp", loop, "127.0.0.1", 0, bare_vxlan_access=sg)
        sw.start()
        n1 = sw.add_network(1, Network.parse("10.0.0.0/8"),
                            Network.parse("fd00::/16"))
        n2 = sw.add_network(2, Network.parse("10.0.0.0/8"),
                            Network.parse("fd00::/16"))
        gw = parse_ip("10.0.0.1")
        n1.ips.add(gw, X.synthetic_mac(1, gw))
        n1.ips.add(parse_ip("fd00::1"), X.synthetic_mac(1, gw))
        for a in ("10.255.255.254", "fd00:ffff::1"):
            n2.ips.add(parse_ip(a), X.synthetic_mac(2, parse_ip(a)))
        for i, net in enumerate(r4 + r6):
            n1.routes.add(X.RouteRule(f"r{i}", Network.parse(net), to_vni=2))
        n1._sync_routes()
        out = RecIface("out")
        for m in range(4):
            n2.macs.record(bytes([2, 0xfe, 0, 0, 0, m]), out)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return loop, sw, sg, n1, n2, out


def parity_frames(X, sw, n2, data):
    """The burst's datagrams; every routed destination's neighbour
    entry recorded in vpc 2."""
    P, parse_ip = X.P, X.parse_ip
    _, _, _, senders, spec = data
    gw_mac = X.synthetic_mac(1, parse_ip("10.0.0.1"))
    out = []
    for i, k, dst in spec:
        src_mac = bytes([2, 0xaa, 0, 0, 0, k])
        if dst is None:
            pkt = P.Arp(P.ARP_REQUEST, sha=src_mac,
                        spa=bytes([10, 0, 1, 1 + k]), tha=b"\x00" * 6,
                        tpa=parse_ip("10.0.0.1"))
            eth = P.Ethernet(P.BROADCAST_MAC, src_mac, P.ETHER_TYPE_ARP, b"",
                             pkt)
        else:
            d = parse_ip(dst)
            n2.arps.record(d, bytes([2, 0xfe, 0, 0, 0, d[-1] % 4]))
            payload = i.to_bytes(4, "big") + b"p" * (6 + i % 7)
            if len(d) == 4:
                ip = P.Ipv4(src=bytes([10, 0, 1, 1 + k]), dst=d, proto=17,
                            payload=payload, ttl=64)
                eth = P.Ethernet(gw_mac, src_mac, 0x0800, b"", packet=ip)
            else:
                ip = P.Ipv6(src=parse_ip(f"fd00:1::{k + 1:x}"), dst=d,
                            next_header=17, payload=payload, hop_limit=64)
                eth = P.Ethernet(gw_mac, src_mac, 0x86DD, b"", packet=ip)
        out.append((P.Vxlan(1, eth).to_bytes(), senders[k], 4789))
    return out


def run_parity(pkg, backend, fastpath, data):
    """-> (egress bytes in order, drop counter deltas, CidrMatcher
    dispatches) of the burst through `pkg`'s switch, in bursts of
    RECV_BURST // 2 (so the matchers see more than one batch)."""
    X = NS(pkg)
    loop, sw, sg, n1, n2, out = parity_world(X, backend, fastpath, data)
    E = mod(pkg, "rules.engine")
    try:
        assert (sw.fastpath is not None) == fastpath
        want_be = BACKENDS["fp" if "fp" in backend else "torch"][
            1 if pkg == "vproxy_tpu" else 3]
        assert sg._tables[X.Proto.UDP][0].backend == want_be
        assert n1._matcher_v4.backend == n1._matcher_v6.backend == want_be
        frames = parity_frames(X, sw, n2, data)
        c0 = switch_counters(X)
        calls = []
        match = E.CidrMatcher.match

        def counted(self, addrs, ports=None):
            calls.append(len(addrs))
            return match(self, addrs, ports)

        E.CidrMatcher.match = counted
        try:
            half = sw.RECV_BURST // 2
            for i in range(0, len(frames), half):
                chunk = frames[i:i + half]
                loop.call_sync(lambda: sw._input_batch(chunk), timeout=300)
        finally:
            E.CidrMatcher.match = match
        d = delta(c0, switch_counters(X))
        return list(out.frames), d, calls
    finally:
        sw.stop()
        loop.close()


@pytest.mark.parametrize("fastpath", [False, True], ids=["object", "fast"])
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_switch_burst_equal_between_packages(backend, fastpath):
    """The same seeded burst through both packages' switches: the same
    egress bytes in the same order and the same drop counters, with the
    CidrMatchers dispatching (above SMALL_TABLE) in both."""
    data = parity_burst()
    ref_pkg, ref_be, port_pkg, _ = BACKENDS[backend]
    ref = run_parity(ref_pkg, ref_be, fastpath, data)
    port = run_parity(port_pkg, ref_be, fastpath, data)
    assert len(port[0]) > 200 and port[0] == ref[0]
    assert port[1] == ref[1]
    for r in ("acl_deny", "route_miss"):
        assert port[1].get(f"vproxy_switch_drops_total.{r}", 0) > 0, r
    # the object path classifies the ACL and both families on the
    # matchers; the fast path the v6 rows (its v4 tries are host-side)
    assert port[2] == ref[2] and len(port[2]) >= (6 if not fastpath else 2)


def switch_script(ports: dict) -> list:
    """One operator session over the switch's resources: their
    list / list-detail views, updates, errors, teardown."""
    sw = "sw0"
    return [
        "add security-group sgs default allow",
        "add security-group-rule s0 to security-group sgs network "
        "127.0.0.0/8 protocol udp port-range 0,65535 default allow",
        f"add switch {sw} address 127.0.0.1:{ports['sw']} "
        "mac-table-timeout 60000 arp-table-timeout 120000 "
        "security-group sgs",
        "list switch", "list-detail switch",
        f"add vpc 7 to switch {sw} v4network 172.16.0.0/16 v6network "
        'fd07::/64 annotations {"net":"a"}',
        f"add vpc 8 to switch {sw} v4network 172.17.0.0/16",
        f"add vpc 8 to switch {sw} v4network 172.17.0.0/16",
        f"list vpc in switch {sw}", f"list-detail vpc in switch {sw}",
        f"add ip 172.16.0.1 to vpc 7 in switch {sw}",
        f"add ip 172.16.0.2 to vpc 7 in switch {sw} mac 02:00:00:00:00:09",
        f"add ip fd07::1 to vpc 7 in switch {sw}",
        f"list ip in vpc 7 in switch {sw}",
        f"add route r1 to vpc 7 in switch {sw} network 172.17.0.0/16 vni 8",
        f"add route r2 to vpc 7 in switch {sw} network 172.17.1.0/24 "
        "via 172.16.0.9",
        f"add route r3 to vpc 7 in switch {sw} network fd08::/64 vni 8",
        f"add route r1 to vpc 7 in switch {sw} network 10.0.0.0/8 vni 8",
        f"add route r9 to vpc 7 in switch {sw} network 10.0.0.0/8",
        f"list route in vpc 7 in switch {sw}",
        f"list-detail route in vpc 7 in switch {sw}",
        f"add arp 02:00:00:00:00:42 to vpc 7 in switch {sw} address "
        "172.16.0.42",
        f"add arp zz:00 to vpc 7 in switch {sw} address 172.16.0.43",
        f"list-detail arp in vpc 7 in switch {sw}",
        f"add user alice1 to switch {sw} password pw1 vni 7",
        f"add user al to switch {sw} password pw1 vni 7",
        f"list user in switch {sw}", f"list-detail user in switch {sw}",
        f"add user-client bob22 to switch {sw} password pw2 vni 8 address "
        "127.0.0.1:18472",
        f"list user-client in switch {sw}",
        f"add switch rsw to switch {sw} address 127.0.0.1:18473",
        f"list iface in switch {sw}",
        f"add proxy 172.16.0.1:80 to vpc 7 in switch {sw} address "
        f"127.0.0.1:{ports['backend']}",
        f"list proxy in vpc 7 in switch {sw}",
        f"list-detail proxy in vpc 7 in switch {sw}",
        f"update switch {sw} mac-table-timeout 30000",
        "list-detail switch",
        f"add vpc 9 to switch nope v4network 10.0.0.0/8",
        f"remove route r9 from vpc 7 in switch {sw}",
        f"remove route r2 from vpc 7 in switch {sw}",
        f"remove ip 172.16.0.2 from vpc 7 in switch {sw}",
        f"remove user alice1 from switch {sw}",
        f"remove user-client bob22 from switch {sw}",
        f"remove switch rsw from switch {sw}",
        f"remove proxy 172.16.0.1:80 from vpc 7 in switch {sw}",
        f"list iface in switch {sw}",
        f"remove vpc 8 from switch {sw}",
        f"list-detail vpc in switch {sw}",
        f"remove switch {sw}", "list switch",
    ]


def _free_udp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_script(pkg, lines):
    X = NS(pkg)
    app = X.Application.create(workers=1)
    out = []
    try:
        for line in lines:
            try:
                out.append(X.Command.execute(app, line))
            except Exception as e:
                out.append(f"{type(e).__name__}: {e}")
    finally:
        app.close()
    return out


def test_switch_command_script_equal_between_packages():
    backend = IdServer("P")
    try:
        lines = switch_script({"sw": _free_udp_port(),
                               "backend": backend.port})
        ref, port = (run_script(p, lines) for p in PKGS)
    finally:
        backend.close()
    for line, a, b in zip(lines, ref, port):
        assert a == b, (line, a, b)
    assert sum(isinstance(x, str) and x.startswith("CmdError: ")
               for x in port) >= 5
    assert port[lines.index("list-detail switch")][0].startswith(
        "sw0 -> bind 127.0.0.1:")


@pytest.mark.parametrize("src,dst", [PKGS, PKGS[::-1]],
                         ids=["ref-to-port", "port-to-ref"])
def test_switch_config_saved_by_one_package_loads_in_the_other(src, dst,
                                                              tmp_path):
    """A switch config (vpcs with v6 and annotations, ips with their
    macs, routes by vni and by gateway, users, a remote switch) built by
    `src` and saved loads in both packages with equal views and an
    equal re-saved config."""
    sw_port = _free_udp_port()
    lines = [ln for ln in switch_script({"sw": sw_port, "backend": 1})
             if ln.startswith("add ") and "proxy" not in ln
             and "user-client" not in ln]
    cfg = tmp_path / "vproxy.last"
    views = {}
    for pkg, build in ((src, True), (src, False), (dst, False)):
        X = NS(pkg)
        app = X.Application.create(workers=1)
        try:
            if build:
                for line in lines:
                    try:
                        X.Command.execute(app, line)
                    except X.CmdError:
                        pass  # the script's error lines
                X.persist.save(app, str(cfg))
            else:
                assert X.persist.load(app, str(cfg)) == len(
                    [ln for ln in cfg.read_text().splitlines() if ln])
                C = X.Command.execute
                v = {t: C(app, f"list-detail {t} in vpc 7 in switch sw0")
                     for t in ("route", "ip")}
                v["vpc"] = C(app, "list-detail vpc in switch sw0")
                v["user"] = C(app, "list-detail user in switch sw0")
                v["iface"] = C(app, "list iface in switch sw0")
                v["switch"] = C(app, "list-detail switch")
                views[pkg] = (v, X.persist.current_config(app))
        finally:
            app.close()
    (sv, scfg), (dv, dcfg) = views[src], views[dst]
    assert sv == dv
    assert scfg == dcfg == cfg.read_text()
    assert "add switch sw0 address" in scfg
    assert "add route r2 to vpc 7 in switch sw0 network 172.17.1.0/24 " \
        "via 172.16.0.9" in scfg


def test_kernel_fault_reaches_the_caller_and_drops_nothing(monkeypatch):
    """A KernelError from the CIDR wrapper during a burst (the object
    path's route batch) reaches the caller of _input_batch instead of
    being logged as a dropped frame, and no frame of the burst is
    forwarded."""
    X = NS("vproxy_tpu_torch")
    from vproxy_tpu_torch.ops import hashmatch as H
    from vproxy_tpu_torch.ops.fused_cuda import KernelError
    data = parity_burst(n=256)
    loop, sw, sg, n1, n2, out = parity_world(X, "jax", False, data)
    try:
        # no ARP request: its flood would count as a (slow) forward
        frames = [f for f, (_, _, dst) in zip(
            parity_frames(X, sw, n2, data), data[4]) if dst is not None]
        c0 = switch_counters(X)
        calls = []
        real = H.cidr_hash_match

        def faulty(t, a16, fam, port=None):
            if port is None:  # a route batch (the ACL's carries ports)
                calls.append(1)
                raise KernelError("injected: the card cannot serve")
            return real(t, a16, fam, port)

        monkeypatch.setattr(H, "cidr_hash_match", faulty)
        with pytest.raises(KernelError, match="injected"):
            loop.call_sync(lambda: sw._input_batch(frames), timeout=120)
        assert calls, "the route batch never reached the wrapper"
        d = delta(c0, switch_counters(X))
        assert not out.frames
        assert not any(k.startswith("vproxy_switch_forwards_total")
                       for k in d), d
        assert "vproxy_switch_drops_total.route_miss" not in d
        # the per-frame guard too: a fault inside one frame's own lookup

        def frame_fault(pkt, iface):
            raise KernelError("injected in a frame")
        monkeypatch.setattr(sw.stack, "input_vxlan", frame_fault)
        with pytest.raises(KernelError, match="in a frame"):
            loop.call_sync(lambda: sw.stack.input_vxlan_batch(
                [(X.P.Vxlan.parse(frames[0][0]), out)]), timeout=60)
        assert not out.frames
    finally:
        sw.stop()
        loop.close()


def test_chip_smoke_switch_phase_on_cpu():
    """chip_smoke.py's `switch` phase small on the CPU: the build by
    command and in bulk, the three runs (object path, the default plane
    over loopback with the flow cache, the object path on "torch-fp"),
    every outcome the host indexes', egress bytes equal across runs,
    the drop counters, the engine's dispatches per batch (the plain
    tiers here: no kernel launches)."""
    import torch

    import chip_smoke as CS
    out = CS.phase_switch(torch.device("cpu"), n_routes=300, n_acl=200,
                          n_packets=2048, build_s=0.5, min_cmd=64)
    assert out["routes"] == 300 and out["acl_rules"] == 200
    b = out["build"]
    assert 64 <= b["acl_by_command"] <= 200
    assert 64 <= b["routes_by_command"] <= 300
    o = out["outcomes"]
    assert o["delivered"] + o["acl_deny"] + o["route_miss"] == 2048
    assert o["acl_deny"] == 2048 // 8  # one sender in eight is denied
    for run in ("object_torch", "object_fp"):
        r = out[run]
        assert r["bursts"] == 2 and r["acl_batches"] == 2
        assert r["route_batches"] == 2 and r["engine_dispatches"] == 4
        assert r["drops"]["acl_deny"] == o["acl_deny"]
        assert not any(r["launches"].values())
    dp = out["default_plane"]
    assert dp["engine_dispatches"] == 0  # the host tries and the C table
    assert dp["passes"][1]["flow_hits"] > 0
    assert out["launches"] == {"cidr_first": 0, "cidr_fp_match": 0}
