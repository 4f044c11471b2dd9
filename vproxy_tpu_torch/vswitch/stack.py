"""L2/L3 pipeline of the virtual switch.

The port of `vproxy_tpu/vswitch/stack.py`, same names and behaviour,
but for one thing: the per-frame guard of input_vxlan_batch re-raises
KernelError, so a fault of the card reaches the caller instead of
being logged as one dropped frame.

Parity: core vswitch/stack/L2.java:296 (mac learn / known-unicast
forward / flood) and stack/L3.java:822 (ARP request/reply handling
:119-206, NDP NS/NA :207-327, ICMP echo for synthetic IPs :224-311,
route() :423-517 — synthetic-IP gate, LPM lookup through the VPC's
route matcher, cross-VNI delivery and gateway resolution :573-601).
L4 (user-space TCP) attaches via VpcNetwork.conntrack (stack/L4.java).
"""
from __future__ import annotations

import struct
from typing import Optional

from ..ops.fused_cuda import KernelError
from ..utils.log import Logger
from . import swmetrics
from .network import VpcNetwork
from .packets import (ARP_REPLY, ARP_REQUEST, BROADCAST_MAC, ETHER_TYPE_ARP,
                      ETHER_TYPE_IPV4, ETHER_TYPE_IPV6, ICMP_ECHO_REPLY,
                      ICMP_ECHO_REQ, ICMP_TIME_EXCEEDED, ICMPV6_ECHO_REPLY,
                      ICMPV6_ECHO_REQ, ICMPV6_NDP_NA, ICMPV6_NDP_NS,
                      PROTO_ICMP, PROTO_ICMPV6, PROTO_TCP, Arp, Ethernet,
                      Icmp, Icmpv6, Ipv4, Ipv6, Vxlan)


_log = Logger("vswitch")


def _is_multicast(mac: bytes) -> bool:
    return bool(mac[0] & 1)


class NetworkStack:
    def __init__(self, sw):
        self.sw = sw  # Switch
        self.l4 = None  # installed by stack_tcp (task: user-space TCP)
        # active burst collector: route() appends instead of looking up
        self._route_pend: Optional[list] = None

    # ----------------------------------------------------------------- L2

    def input_vxlan_batch(self, items) -> None:
        """Process a drained burst [(Vxlan, iface)]: L2/ARP/ICMP run per
        packet, but every route-needing packet's LPM lookup is collected
        and classified in ONE matcher dispatch per (vpc, family) — on a
        50k-route device table, per-packet match_one would pay a device
        dispatch each; the burst amortizes it."""
        pend: list = []
        self._route_pend = pend
        try:
            for pkt, iface in items:
                try:
                    self.input_vxlan(pkt, iface)
                except KernelError:
                    raise  # a card fault is not a bad frame: never a drop
                except Exception as e:  # one bad frame must not kill the burst
                    _log.warn(f"dropping frame from {iface.name}: {e!r}")
        finally:
            # flush inside finally: already-accepted packets' routes must
            # not be dropped retroactively by a later failure
            self._route_pend = None
            if pend:
                self._route_flush(pend)

    def input_vxlan(self, pkt: Vxlan, src_iface) -> None:
        net = self.sw.networks.get(pkt.vni)
        if net is None:
            swmetrics.drop("unknown_vni")
            return
        ether = pkt.ether
        from ..utils.mirror import Mirror
        mir = Mirror.get()
        # wants() (not just .active/.hot) BEFORE serializing: an ssl-only
        # config must not tax the forwarding path with to_bytes()
        if mir.hot and mir.wants("switch"):
            Mirror.get().mirror("switch", ether.to_bytes(), raw_ether=True)
        if not _is_multicast(ether.src):
            net.macs.record(ether.src, src_iface)
        if _is_multicast(ether.dst):
            self._flood(net, pkt, src_iface)
            self.l3_input(net, ether, src_iface)
            return
        # unicast to a switch-owned (synthetic) mac -> L3
        if net.ips.find_by_mac(ether.dst) is not None:
            self.l3_input(net, ether, src_iface)
            return
        out = net.macs.lookup(ether.dst)
        if out is not None:
            if out is not src_iface:
                out.send_vxlan(self.sw, pkt)
                swmetrics.forward("slow")
            else:
                swmetrics.drop("same_iface")
            return
        self._flood(net, pkt, src_iface)

    def _flood(self, net: VpcNetwork, pkt: Vxlan, src_iface) -> None:
        sent = 0
        for iface in self.sw.ifaces_for_vni(net.vni):
            if iface is not src_iface:
                iface.send_vxlan(self.sw, pkt)
                sent += 1
        swmetrics.forward("slow", sent)

    def send_ether(self, net: VpcNetwork, ether: Ethernet) -> None:
        """Emit a switch-originated frame into the VPC (L2 path)."""
        pkt = Vxlan(net.vni, ether)
        if _is_multicast(ether.dst):
            self._flood(net, pkt, None)
            return
        if net.ips.find_by_mac(ether.dst) is not None:
            # switch-owned destination (e.g. two user-space TCP endpoints
            # inside the same VPC): loop back into L3 on the next tick to
            # keep the stack re-entrancy-free
            self.sw.loop.next_tick(lambda: self.l3_input(net, ether, None))
            return
        out = net.macs.lookup(ether.dst)
        if out is not None:
            out.send_vxlan(self.sw, pkt)
            swmetrics.forward("slow")
        else:
            self._flood(net, pkt, None)

    # ----------------------------------------------------------------- L3

    def l3_input(self, net: VpcNetwork, ether: Ethernet, src_iface) -> None:
        p = ether.packet
        if isinstance(p, Arp):
            self._arp(net, ether, p)
        elif isinstance(p, Ipv4):
            net.arps.record(p.src, ether.src)
            self._ip_input(net, ether, p, v6=False)
        elif isinstance(p, Ipv6):
            if isinstance(p.packet, Icmpv6) and p.packet.type in (
                    ICMPV6_NDP_NS, ICMPV6_NDP_NA):
                self._ndp(net, ether, p, p.packet)
                return
            net.arps.record(p.src, ether.src)
            self._ip_input(net, ether, p, v6=True)

    # --- arp/ndp ---

    def _arp(self, net: VpcNetwork, ether: Ethernet, arp: Arp) -> None:
        net.arps.record(arp.spa, arp.sha)
        if arp.op != ARP_REQUEST:
            return
        mac = net.ips.lookup_mac(arp.tpa)
        if mac is None:
            return
        reply = Ethernet(ether.src, mac, ETHER_TYPE_ARP, b"", Arp(
            ARP_REPLY, sha=mac, spa=arp.tpa, tha=arp.sha, tpa=arp.spa))
        self.send_ether(net, reply)

    def _ndp(self, net: VpcNetwork, ether: Ethernet, ip6: Ipv6,
             icmp: Icmpv6) -> None:
        target = icmp.ndp_target
        lladdr = icmp.ndp_lladdr_option()
        if icmp.type == ICMPV6_NDP_NA and target is not None:
            net.arps.record(target, lladdr or ether.src)
            return
        if icmp.type != ICMPV6_NDP_NS or target is None:
            return
        if lladdr is not None:
            net.arps.record(ip6.src, lladdr)
        mac = net.ips.lookup_mac(target)
        if mac is None:
            return
        # neighbor advertisement: R=0 S=1 O=1, target lladdr option
        body = struct.pack(">I", 0x60000000) + target + b"\x02\x01" + mac
        na = Icmpv6(ICMPV6_NDP_NA, 0, body)
        reply = Ethernet(ether.src, mac, ETHER_TYPE_IPV6, b"", Ipv6(
            src=target, dst=ip6.src, next_header=PROTO_ICMPV6, payload=b"",
            hop_limit=255, packet=na))
        self.send_ether(net, reply)

    # --- ip ---

    def _ip_input(self, net: VpcNetwork, ether: Ethernet, ip, v6: bool) -> None:
        dst = ip.dst
        my_mac = net.ips.lookup_mac(dst)
        if my_mac is not None:
            inner = ip.packet
            if not v6 and isinstance(inner, Icmp) and inner.type == ICMP_ECHO_REQ:
                self._echo_reply(net, ether, ip, inner, v6=False)
                return
            if v6 and isinstance(inner, Icmpv6) and inner.type == ICMPV6_ECHO_REQ:
                self._echo_reply(net, ether, ip, inner, v6=True)
                return
            if ip.proto_num() == PROTO_TCP and self.l4 is not None:
                self.l4.input(net, ether, ip, v6)
                return
            return
        self.route(net, ether, ip, v6)

    def _echo_reply(self, net: VpcNetwork, ether: Ethernet, ip, icmp,
                    v6: bool) -> None:
        if v6:
            resp_icmp = Icmpv6(ICMPV6_ECHO_REPLY, 0, icmp.body)
            resp_ip = Ipv6(src=ip.dst, dst=ip.src, next_header=PROTO_ICMPV6,
                           payload=b"", hop_limit=64, packet=resp_icmp)
            et = ETHER_TYPE_IPV6
        else:
            resp_icmp = Icmp(ICMP_ECHO_REPLY, 0, icmp.body)
            resp_ip = Ipv4(src=ip.dst, dst=ip.src, proto=PROTO_ICMP,
                           payload=b"", packet=resp_icmp)
            et = ETHER_TYPE_IPV4
        mac = net.ips.lookup_mac(ip.dst)
        self.send_ether(net, Ethernet(ether.src, mac, et, b"", resp_ip))

    # --- routing ---

    def route(self, net: VpcNetwork, ether: Ethernet, ip, v6: bool) -> None:
        """L3.route(): LPM through the VPC route matcher; targets are
        another VNI (cross-VPC delivery) or a gateway IP."""
        if self._route_pend is not None:  # burst mode: defer the lookup
            self._route_pend.append((net, ether, ip, v6))
            return
        self._route_with(net, ether, ip, v6, net.route_lookup(ip.dst))

    def _route_flush(self, pend: list) -> None:
        groups: dict[int, list[int]] = {}
        nets: dict[int, VpcNetwork] = {}
        for i, (net, _e, _ip, _v) in enumerate(pend):
            groups.setdefault(id(net), []).append(i)
            nets[id(net)] = net
        for key, idxs in groups.items():
            net = nets[key]
            rules = net.route_lookup_batch([pend[i][2].dst for i in idxs])
            for i, rule in zip(idxs, rules):
                n_, e_, ip_, v6_ = pend[i]
                self._route_with(n_, e_, ip_, v6_, rule)

    def _route_with(self, net: VpcNetwork, ether: Ethernet, ip, v6: bool,
                    rule) -> None:
        if rule is None:
            swmetrics.drop("route_miss")
            return
        # ttl/hop-limit handling
        if v6:
            if ip.hop_limit <= 1:
                return
            ip.hop_limit -= 1
        else:
            if ip.ttl <= 1:
                self._time_exceeded(net, ether, ip)
                return
            ip.ttl -= 1
        if rule.to_vni:
            target = self.sw.networks.get(rule.to_vni)
            if target is None:
                swmetrics.drop("unknown_vni")
                return
            self._deliver(target, ip, v6)
            return
        if rule.via_ip is not None:
            gw_mac = net.arps.lookup(rule.via_ip)
            src = net.ips.first_in(net.v6net if v6 and net.v6net else net.v4net)
            if gw_mac is None:
                swmetrics.drop("arp_unresolved")
                if src is not None and not v6:
                    self._arp_request(net, src[1], src[0], rule.via_ip)
                return
            src_mac = src[1] if src is not None else ether.dst
            out = Ethernet(gw_mac, src_mac,
                           ETHER_TYPE_IPV6 if v6 else ETHER_TYPE_IPV4, b"", ip)
            self.send_ether(net, out)

    def _deliver(self, net: VpcNetwork, ip, v6: bool) -> None:
        """Deliver a routed packet inside `net`: resolve the target mac,
        source mac is a synthetic ip in that network."""
        dst_mac = net.arps.lookup(ip.dst)
        src = net.ips.first_in(net.v6net if v6 and net.v6net else net.v4net)
        src_mac = src[1] if src is not None else b"\x02\x00\x00\x00\x00\x01"
        if dst_mac is None:
            swmetrics.drop("arp_unresolved")
            if not v6 and src is not None:
                self._arp_request(net, src[1], src[0], ip.dst)
            return
        out = Ethernet(dst_mac, src_mac,
                       ETHER_TYPE_IPV6 if v6 else ETHER_TYPE_IPV4, b"", ip)
        self.send_ether(net, out)

    def _arp_request(self, net: VpcNetwork, src_mac: bytes, src_ip: bytes,
                     target_ip: bytes) -> None:
        req = Ethernet(BROADCAST_MAC, src_mac, ETHER_TYPE_ARP, b"", Arp(
            ARP_REQUEST, sha=src_mac, spa=src_ip,
            tha=b"\x00" * 6, tpa=target_ip))
        self.send_ether(net, req)

    def _time_exceeded(self, net: VpcNetwork, ether: Ethernet, ip) -> None:
        src = net.ips.first_in(net.v4net)
        if src is None:
            return
        body = b"\x00" * 4 + ip.to_bytes()[:28]
        icmp = Icmp(ICMP_TIME_EXCEEDED, 0, body[4:])
        resp = Ipv4(src=src[0], dst=ip.src, proto=PROTO_ICMP, payload=b"",
                    packet=icmp)
        self.send_ether(net, Ethernet(ether.src, src[1], ETHER_TYPE_IPV4,
                                      b"", resp))
