"""IP address / network value types.

Semantics modeled on the reference's vfd/IP.java and
vproxybase/util/Network.java: addresses are raw
big-endian byte strings (4 bytes for v4, 16 for v6); a Network keeps its
mask as a byte string whose length is 4 when masklen <= 32 else 16, and
`contains` implements the mixed v4/v6 cases of Network.maskMatch
(Network.java:183-278) including IPv4-compatible (::a.b.c.d) and
IPv4-mapped (::ffff:a.b.c.d) v6 addresses matching v4 rules.
"""
from __future__ import annotations

import socket
from dataclasses import dataclass


def parse_ip(s: str) -> bytes:
    """Parse an IPv4 or IPv6 literal into raw bytes. Raises ValueError."""
    s = s.strip()
    if s.startswith("[") and s.endswith("]"):
        s = s[1:-1]
    try:
        return socket.inet_aton(s) if ("." in s and ":" not in s) else socket.inet_pton(socket.AF_INET6, s)
    except OSError as e:
        raise ValueError(f"invalid ip literal: {s!r}") from e


def is_ip_literal(s: str) -> bool:
    try:
        parse_ip(s)
        return True
    except ValueError:
        return False


def is_ipv6_literal(s: str) -> bool:
    return is_ip_literal(s) and len(parse_ip(s)) == 16


def format_ip(b: bytes) -> str:
    if len(b) == 4:
        return socket.inet_ntoa(b)
    if len(b) == 16:
        return socket.inet_ntop(socket.AF_INET6, b)
    raise ValueError(f"bad address length {len(b)}")


def to16(b: bytes) -> bytes:
    """Canonicalize to 16 bytes (v4 -> low 4 bytes, high 12 zero)."""
    if len(b) == 16:
        return b
    if len(b) == 4:
        return b"\x00" * 12 + b
    raise ValueError(f"bad address length {len(b)}")


def _low_bits_v6_v4(ip: bytes, last_low: int, second_last: int) -> bool:
    # Utils.lowBitsV6V4 (reference base/.../util/Utils.java:122-133)
    for i in range(second_last):
        if ip[i] != 0:
            return False
    if ip[last_low] == 0:
        return ip[second_last] == 0
    if ip[last_low] == 0xFF:
        return ip[second_last] == 0xFF
    return False


def mask_bytes(masklen: int) -> bytes:
    """Network.parseMask: 4 bytes when masklen <= 32, else 16."""
    if masklen > 128 or masklen < 0:
        raise ValueError(f"unknown mask {masklen}")
    n = 16 if masklen > 32 else 4
    out = bytearray(n)
    m = masklen
    for i in range(n):
        ones = 8 if m > 8 else max(m, 0)
        out[i] = (0xFF << (8 - ones)) & 0xFF if ones > 0 else 0
        m -= 8
    return bytes(out)


def mask_match(inp: bytes, rule: bytes, mask: bytes) -> bool:
    """Network.maskMatch's five mixed-length cases (Network.java:183-278)."""
    if len(inp) == len(rule) and len(rule) > len(mask):
        # v6 input, v6 rule, mask <= 32: compare first 4 bytes
        return all((inp[i] & mask[i]) == rule[i] for i in range(len(mask)))
    if len(inp) < len(rule) and len(rule) > len(mask):
        # v4 input, v6 rule, mask <= 32
        return False
    if len(inp) < len(rule) and len(rule) == len(mask):
        # v4 input, v6 rule, mask > 32: compare low 4 bytes + rule-high check
        off = len(rule) - len(inp)
        for i in range(len(inp)):
            if (inp[i] & mask[i + off]) != rule[i + off]:
                return False
        return _low_bits_v6_v4(rule, off - 1, off - 2)
    # cases 4 (v6 input, v4 rule) and 5 (same length): compare from the end
    n = min(len(inp), len(rule), len(mask))
    for i in range(n):
        if (inp[-1 - i] & mask[-1 - i]) != rule[-1 - i]:
            return False
    if len(inp) > len(rule):
        off = len(inp) - len(rule)
        return _low_bits_v6_v4(inp, off - 1, off - 2)
    return True


@dataclass(frozen=True)
class Network:
    """A CIDR network; `ip` is already in network form (host bits zero)."""

    ip: bytes
    mask: bytes

    @staticmethod
    def parse(net: str) -> "Network":
        if "/" not in net:
            raise ValueError(f"invalid network {net!r}")
        ip_s, _, m_s = net.rpartition("/")
        masklen = int(m_s)
        ip = parse_ip(ip_s)
        mask = mask_bytes(masklen)
        if len(ip) < len(mask):
            raise ValueError(f"invalid network {net!r}: v4 address with mask > 32")
        for i in range(len(mask)):
            if (ip[i] & mask[i]) != ip[i]:
                raise ValueError(f"invalid network {net!r}: host bits set")
        for i in range(len(mask), len(ip)):
            if ip[i] != 0:
                raise ValueError(f"invalid network {net!r}: host bits set")
        return Network(ip, mask)

    @property
    def masklen(self) -> int:
        zeros = 0
        for b in reversed(self.mask):
            if b == 0:
                zeros += 8
            else:
                while not (b & 1):
                    zeros += 1
                    b >>= 1
                break
        return len(self.mask) * 8 - zeros

    def contains_ip(self, addr: bytes) -> bool:
        return mask_match(addr, self.ip, self.mask)

    def contains_net(self, other: "Network") -> bool:
        # Network.contains(Network): strict (mask must be narrower)
        return self.contains_ip(other.ip) and self.masklen < other.masklen

    def __str__(self) -> str:
        return f"{format_ip(self.ip)}/{self.masklen}"


@dataclass(frozen=True)
class IPPort:
    ip: bytes
    port: int

    @staticmethod
    def parse(s: str) -> "IPPort":
        host, _, port = s.rpartition(":")
        return IPPort(parse_ip(host), int(port))

    def __str__(self) -> str:
        ip = format_ip(self.ip)
        return f"[{ip}]:{self.port}" if len(self.ip) == 16 else f"{ip}:{self.port}"
