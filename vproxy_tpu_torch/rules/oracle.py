"""Pure-Python reference matchers — correctness oracle + host fallback.

These replicate, bit-for-bit, the reference's linear-scan semantics:
Hint.matchLevel (Hint.java:92-160), Upstream.searchForGroup
(Upstream.java:187-198), SecurityGroup.allow (SecurityGroup.java:30-45),
RouteTable.lookup (RouteTable.java:44-59 — already on the IR class).

They double as the `matcher=host` provider behind the same seam as the
torch matcher (`backend="torch"`), mirroring the reference's -Dvfd SPI.
"""
from __future__ import annotations

from typing import Optional, Sequence

from .ir import AclRule, Hint, HintRule, Proto

HOST_SHIFT = 10
HOST_EXACT = 3
HOST_SUFFIX = 2
HOST_WILDCARD = 1
URI_MAX = 1023
URI_WILDCARD = 1


def match_level(hint: Hint, rule: HintRule) -> int:
    """Hint.matchLevel against one rule's annotations."""
    if rule.is_empty():
        return 0
    if hint.port != 0 and rule.port != 0 and hint.port != rule.port:
        return 0

    host_level = 0
    if rule.host is not None and hint.host is not None:
        if hint.host == rule.host:
            host_level = HOST_EXACT
        elif hint.host.endswith("." + rule.host):
            host_level = HOST_SUFFIX
        elif rule.host == "*":
            host_level = HOST_WILDCARD

    uri_level = 0
    if rule.uri is not None and hint.uri is not None:
        if hint.uri == rule.uri:
            uri_level = len(hint.uri) + URI_WILDCARD
        elif hint.uri.startswith(rule.uri):
            uri_level = len(rule.uri) + URI_WILDCARD
        elif rule.uri == "*":
            uri_level = URI_WILDCARD
        uri_level = min(uri_level, URI_MAX)

    return (host_level << HOST_SHIFT) + uri_level


def search(rules: Sequence[HintRule], hint: Hint) -> int:
    """Upstream.searchForGroup: strictly-greater max, earliest wins.
    Returns the matching rule index, or -1 when nothing matches."""
    best_level = 0
    best = -1
    for i, r in enumerate(rules):
        lv = match_level(hint, r)
        if lv > best_level:
            best_level = lv
            best = i
    return best


def acl_allow(rules: Sequence[AclRule], default_allow: bool,
              proto: Proto, addr: bytes, port: int) -> bool:
    """SecurityGroup.allow: first matching rule in order wins."""
    sub = [r for r in rules if r.protocol == proto]
    if not sub:
        return default_allow
    for r in sub:
        if r.match(addr, port):
            return r.allow
    return default_allow


def acl_first_match(rules: Sequence[AclRule], proto: Proto,
                    addr: bytes, port: int) -> int:
    """Index (within the proto-filtered order) of the first matching rule,
    or -1. Helper for table-compiler parity tests."""
    for i, r in enumerate(r for r in rules if r.protocol == proto):
        if r.match(addr, port):
            return i
    return -1
