"""Unified rule IR for the classify() engine.

This is the host-side intermediate representation that all three
rule-matching sites compile down from (see SURVEY.md §7 L2):

* Upstream Host/SNI/URI hint rules (reference Hint.java:92-160 scoring,
  Upstream.searchForGroup Upstream.java:187-198 linear scan)
* DNS qname -> server-group (DNSServer.java:136 — same Hint machinery)
* RouteTable LPM (RouteTable.java:44-59 ordered first-contains scan)
* SecurityGroup ACL (SecurityGroup.java:30-45 ordered first-match)

The IR is deliberately tiny: rule lists plus payload indices. The
compilers in ops/ turn these into fixed-shape padded device
tables; rules/oracle.py is the pure-Python reference
implementation used as correctness oracle and host fallback matcher.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

from ..utils.ip import Network, parse_ip, is_ipv6_literal


def format_host(s: Optional[str]) -> Optional[str]:
    """Hint.formatHost: values WITHOUT a port (or v6 literals) pass through
    unchanged; only when a :port is stripped does the leading "www." get
    stripped and empty collapse to None (Hint.java:57-71)."""
    if s is None:
        return None
    colon = s.find(":")
    if is_ipv6_literal(s) or colon == -1:
        return s
    s = s[:colon]
    if s.startswith("www."):
        s = s[len("www."):]
    return s or None


def format_uri(s: Optional[str]) -> Optional[str]:
    """Hint.formatUri: strip ?query, keep '/', strip one trailing '/'."""
    if s is None:
        return None
    q = s.find("?")
    if q != -1:
        s = s[:q]
    if s == "/":
        return s
    if s.endswith("/"):
        s = s[:-1]
    return s


@dataclass(frozen=True)
class Hint:
    """A classification query: (host, port, uri), any may be absent."""

    host: Optional[str] = None
    port: int = 0
    uri: Optional[str] = None

    @staticmethod
    def of_host(host: str) -> "Hint":
        return Hint(host=format_host(host))

    @staticmethod
    def of_host_port(host: str, port: int) -> "Hint":
        return Hint(host=format_host(host), port=port)

    @staticmethod
    def of_host_uri(host: str, uri: str) -> "Hint":
        return Hint(host=format_host(host), uri=format_uri(uri))

    @staticmethod
    def of_host_port_uri(host: str, port: int, uri: str) -> "Hint":
        return Hint(host=format_host(host), port=port, uri=format_uri(uri))

    @staticmethod
    def of_uri(uri: str) -> "Hint":
        return Hint(uri=format_uri(uri))


@dataclass(frozen=True)
class HintRule:
    """One Upstream group's annotations (vproxy/hint-host|port|uri)."""

    host: Optional[str] = None  # exact domain, or "*" wildcard
    port: int = 0
    uri: Optional[str] = None  # uri prefix, or "*" wildcard

    def is_empty(self) -> bool:
        return self.host is None and self.port == 0 and self.uri is None


class Proto(Enum):
    TCP = "tcp"
    UDP = "udp"


@dataclass(frozen=True)
class AclRule:
    """SecurityGroupRule: CIDR + protocol + inclusive port range."""

    alias: str
    network: Network
    protocol: Proto
    min_port: int
    max_port: int
    allow: bool

    def match(self, addr: bytes, port: int) -> bool:
        return self.network.contains_ip(addr) and self.min_port <= port <= self.max_port


@dataclass(frozen=True)
class RouteRule:
    """RouteTable.RouteRule: network -> vni or gateway ip."""

    alias: str
    rule: Network
    to_vni: int = 0
    via_ip: Optional[bytes] = None


@dataclass
class RouteTable:
    """Ordered route list; insertion keeps more-specific-first among
    overlapping rules, exactly as RouteTable.addRule (RouteTable.java:110-154).
    Lookup is first-contains in list order."""

    rules_v4: list[RouteRule] = field(default_factory=list)
    rules_v6: list[RouteRule] = field(default_factory=list)

    def add(self, r: RouteRule) -> None:
        for rr in self.rules_v4 + self.rules_v6:
            if rr.alias == r.alias:
                raise ValueError(f"route {r.alias} already exists")
            if rr.rule == r.rule:
                raise ValueError(f"route {rr.alias} has the same network rule")
        rules = self.rules_v4 if len(r.rule.ip) == 4 else self.rules_v6
        self._insert(r, rules)

    @staticmethod
    def _insert(r: RouteRule, rules: list[RouteRule]) -> None:
        similar = -1
        for i, ri in enumerate(rules):
            if ri.rule.contains_net(r.rule) or r.rule.contains_net(ri.rule):
                similar = i
                break
        if similar == -1:
            rules.append(r)
            return
        insert_index = 0
        i = similar
        while i < len(rules):
            curr = rules[i]
            nxt = rules[i + 1] if i + 1 < len(rules) else None
            if curr.rule.contains_net(r.rule):
                insert_index = i
                break
            if r.rule.contains_net(curr.rule):
                if nxt is None:
                    insert_index = i + 1
                    break
                if r.rule.contains_net(nxt.rule):
                    i += 1
                    continue
                if nxt.rule.contains_net(r.rule):
                    insert_index = i + 1
                    break
            insert_index = i + 1
            break
        rules.insert(insert_index, r)

    def remove(self, alias: str) -> None:
        for rules in (self.rules_v4, self.rules_v6):
            for i, ri in enumerate(rules):
                if ri.alias == alias:
                    del rules[i]
                    return
        raise KeyError(alias)

    def lookup(self, addr: bytes) -> Optional[RouteRule]:
        rules = self.rules_v4 if len(addr) == 4 else self.rules_v6
        for r in rules:
            if r.rule.contains_ip(addr):
                return r
        return None

    @property
    def rules(self) -> list[RouteRule]:
        return self.rules_v4 + self.rules_v6
