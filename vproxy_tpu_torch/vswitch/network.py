"""Per-VNI network state: MAC table, ARP/neighbor table, synthetic IPs,
route table.

The port of `vproxy_tpu/vswitch/network.py`, same names and behaviour.

Parity: core vswitch/Table.java:13 (the VPC object), MacTable.java:14
(mac -> iface with TTL), ArpTable.java:13 (ip -> mac with TTL),
SyntheticIpHolder, RouteTable (the IR RouteTable from rules/ir.py keeps
the reference's most-specific-first insert order; lookups go through the
classify engine's CidrMatcher — the LPM path on the card (the CIDR
kernel, or B7 on a "torch-fp" matcher), with the host oracle for small
tables).
"""
from __future__ import annotations

import time
from typing import Optional

from ..rules.engine import CidrMatcher
from ..rules.ir import RouteRule, RouteTable
from ..utils.ip import Network, format_ip
from .packets import mac_str

MAC_TABLE_TIMEOUT = 300_000  # ms (SwitchHandle defaults)
ARP_TABLE_TIMEOUT = 4 * 3600_000


class MacTable:
    """mac -> iface, expiring entries after timeout ms.

    `version` counts MAPPING changes (new mac, mac moved to another
    iface, removals) — NOT timestamp refreshes — so the burst fast
    path's vectorized view (vswitch/fastpath.py) stays valid across
    steady-state re-learns and rebuilds only when the topology moves."""

    def __init__(self, timeout_ms: int = MAC_TABLE_TIMEOUT):
        self.timeout_ms = timeout_ms
        self.version = 0
        # fires on every version bump (mapping change): the owning
        # switch points this at its flow-cache generation bump so a
        # topology move can never forward through a stale native entry
        self.on_change = None
        self._e: dict[bytes, tuple[object, float]] = {}

    def _bump(self) -> None:
        self.version += 1
        if self.on_change is not None:
            self.on_change()

    def record(self, mac: bytes, iface) -> None:
        old = self._e.get(mac)
        self._e[mac] = (iface, time.monotonic())
        if old is None or old[0] is not iface:
            self._bump()

    def lookup(self, mac: bytes):
        ent = self._e.get(mac)
        if ent is None:
            return None
        iface, ts = ent
        if (time.monotonic() - ts) * 1000 > self.timeout_ms:
            del self._e[mac]
            self._bump()
            return None
        return iface

    def remove_iface(self, iface) -> None:
        for mac, (i, _) in list(self._e.items()):
            if i is iface:
                del self._e[mac]
                self._bump()

    def expire(self) -> None:
        now = time.monotonic()
        for mac, (_, ts) in list(self._e.items()):
            if (now - ts) * 1000 > self.timeout_ms:
                del self._e[mac]
                self._bump()

    def entries(self) -> list[tuple[str, object]]:
        self.expire()
        return [(mac_str(m), i) for m, (i, _) in self._e.items()]


class ArpTable:
    """ip(bytes, canonical 4/16) -> mac, with TTL. `version` counts
    mapping changes only (see MacTable.version)."""

    def __init__(self, timeout_ms: int = ARP_TABLE_TIMEOUT):
        self.timeout_ms = timeout_ms
        self.version = 0
        self.on_change = None  # see MacTable.on_change
        self._e: dict[bytes, tuple[bytes, float]] = {}

    def _bump(self) -> None:
        self.version += 1
        if self.on_change is not None:
            self.on_change()

    def record(self, ip: bytes, mac: bytes) -> None:
        old = self._e.get(ip)
        self._e[ip] = (mac, time.monotonic())
        if old is None or old[0] != mac:
            self._bump()

    def lookup(self, ip: bytes) -> Optional[bytes]:
        ent = self._e.get(ip)
        if ent is None:
            return None
        mac, ts = ent
        if (time.monotonic() - ts) * 1000 > self.timeout_ms:
            del self._e[ip]
            self._bump()
            return None
        return mac

    def expire(self) -> None:
        now = time.monotonic()
        for ip, (_, ts) in list(self._e.items()):
            if (now - ts) * 1000 > self.timeout_ms:
                del self._e[ip]
                self._bump()

    def entries(self) -> list[tuple[str, str]]:
        self.expire()
        return [(format_ip(ip), mac_str(mac)) for ip, (mac, _) in self._e.items()]


class SyntheticIpHolder:
    """Virtual IPs owned by the switch inside this VPC (each with its own
    mac): ARP/NDP answered, ICMP echo answered, routed gateways."""

    _MISS = object()

    def __init__(self):
        self.version = 0
        self.on_change = None  # see MacTable.on_change
        self._ips: dict[bytes, bytes] = {}  # ip -> mac
        # first_in runs once per ROUTED PACKET (gateway source pick);
        # memoized per network, invalidated on any mutation. _by_mac is
        # the reverse index for find_by_mac (runs per L2-forwarded
        # packet): mac -> FIRST ip added with it, matching the old
        # insertion-order scan
        self._first_cache: dict = {}
        self._by_mac: dict[bytes, bytes] = {}

    def add(self, ip: bytes, mac: bytes) -> None:
        old = self._ips.get(ip)
        if old is not None and old != mac:
            self._unindex_mac(ip, old)  # re-add with a new mac
        self._ips[ip] = mac
        self._by_mac.setdefault(mac, ip)
        self._first_cache.clear()
        self.version += 1
        if self.on_change is not None:
            self.on_change()

    def remove(self, ip: bytes) -> None:
        mac = self._ips.pop(ip, None)
        if mac is not None:
            self._unindex_mac(ip, mac)
        self._first_cache.clear()
        self.version += 1
        if self.on_change is not None:
            self.on_change()

    def _unindex_mac(self, ip: bytes, mac: bytes) -> None:
        if self._by_mac.get(mac) == ip:
            del self._by_mac[mac]
            for ip2, m2 in self._ips.items():  # next-oldest takes over
                if m2 == mac and ip2 != ip:
                    self._by_mac[mac] = ip2
                    break

    def lookup_mac(self, ip: bytes) -> Optional[bytes]:
        return self._ips.get(ip)

    def find_by_mac(self, mac: bytes) -> Optional[bytes]:
        return self._by_mac.get(mac)

    def first_in(self, net: Network) -> Optional[tuple[bytes, bytes]]:
        """-> (ip, mac) of a synthetic ip inside net (gateway source pick)."""
        hit = self._first_cache.get(net, self._MISS)
        if hit is not self._MISS:
            return hit
        found = None
        for ip, mac in self._ips.items():
            if net.contains_ip(ip):
                found = (ip, mac)
                break
        self._first_cache[net] = found
        return found

    def ips(self) -> dict[bytes, bytes]:
        return dict(self._ips)


class VpcNetwork:
    """One VNI's state (Table.java)."""

    def __init__(self, vni: int, v4net: Network,
                 v6net: Optional[Network] = None,
                 mac_timeout_ms: int = MAC_TABLE_TIMEOUT,
                 arp_timeout_ms: int = ARP_TABLE_TIMEOUT,
                 matcher_backend: Optional[str] = None,
                 annotations: Optional[dict] = None):
        self.vni = vni
        self.v4net = v4net
        self.v6net = v6net
        # free-form key/value tags (Table.java annotations; the docker
        # network driver stores its networkId mapping here)
        self.annotations: dict = annotations or {}
        self.macs = MacTable(mac_timeout_ms)
        self.arps = ArpTable(arp_timeout_ms)
        self.ips = SyntheticIpHolder()
        self.routes = RouteTable()
        self._matcher_v4 = CidrMatcher(backend=matcher_backend)
        self._matcher_v6 = CidrMatcher(backend=matcher_backend)
        self.on_route_change = None  # see MacTable.on_change
        self.conntrack = None  # installed by the L4 stack

    # -------------------------------------------------------------- routes

    def add_route(self, r: RouteRule) -> None:
        self.routes.add(r)
        self._sync_routes()

    def remove_route(self, alias: str) -> None:
        self.routes.remove(alias)
        self._sync_routes()

    def _sync_routes(self) -> None:
        self._matcher_v4.set_networks([r.rule for r in self.routes.rules_v4])
        self._matcher_v6.set_networks([r.rule for r in self.routes.rules_v6])
        if self.on_route_change is not None:
            self.on_route_change()

    def route_lookup(self, ip: bytes) -> Optional[RouteRule]:
        """LPM through the classify engine (insert order = priority,
        matching RouteTable.lookup's first-contains semantics)."""
        if len(ip) == 4:
            rules, m = self.routes.rules_v4, self._matcher_v4
        else:
            rules, m = self.routes.rules_v6, self._matcher_v6
        if not rules:
            return None
        i = m.match_one(ip)
        return rules[i] if i >= 0 else None

    def route_lookup_batch(self, addrs) -> list:
        """Batched LPM for a drained packet burst: ONE matcher dispatch
        per family instead of per-packet match_one (which pays a device
        dispatch each on big tables). -> [Optional[RouteRule]] aligned
        with addrs."""
        from ..rules.engine import SMALL_TABLE
        out: list = [None] * len(addrs)
        for rules, m, fam_len in (
                (self.routes.rules_v4, self._matcher_v4, 4),
                (self.routes.rules_v6, self._matcher_v6, 16)):
            idx = [i for i, a in enumerate(addrs) if len(a) == fam_len]
            if not idx or not rules:
                continue
            if len(rules) <= SMALL_TABLE:
                # small tables: match_one's host scan beats a dispatch
                for i in idx:
                    r = m.match_one(addrs[i])
                    if r >= 0:
                        out[i] = rules[r]
                continue
            res = m.match([addrs[i] for i in idx])
            for i, r in zip(idx, res):
                if r >= 0:
                    out[i] = rules[int(r)]
        return out
