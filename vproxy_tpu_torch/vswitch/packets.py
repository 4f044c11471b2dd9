"""Binary packet codecs for the virtual switch.

The port of `vproxy_tpu/vswitch/packets.py`, same names and behaviour.

Parity: base vpacket/* (EthernetPacket, ArpPacket.java:227,
Ipv4Packet.java:351, Ipv6Packet.java:342, TcpPacket.java:456, VXLanPacket,
VProxyEncryptedPacket) — standard wire formats, parsed into light
dataclass-style objects and re-serialized with checksums computed.
All multi-byte fields are network byte order.
"""
from __future__ import annotations

import os
import struct
from typing import Optional

ETHER_TYPE_ARP = 0x0806
ETHER_TYPE_IPV4 = 0x0800
ETHER_TYPE_IPV6 = 0x86DD

PROTO_ICMP = 1
PROTO_TCP = 6
PROTO_UDP = 17
PROTO_ICMPV6 = 58

ARP_REQUEST = 1
ARP_REPLY = 2

ICMP_ECHO_REPLY = 0
ICMP_ECHO_REQ = 8
ICMP_TIME_EXCEEDED = 11
ICMP_UNREACHABLE = 3

ICMPV6_ECHO_REQ = 128
ICMPV6_ECHO_REPLY = 129
ICMPV6_NDP_NS = 135  # neighbor solicitation
ICMPV6_NDP_NA = 136  # neighbor advertisement

BROADCAST_MAC = b"\xff\xff\xff\xff\xff\xff"

# vproxy-encrypted switch packet (VProxyEncryptedPacket.java wire layout)
VPROXY_SWITCH_MAGIC = 0x8776
VPROXY_TYPE_VXLAN = 1
VPROXY_TYPE_PING = 2


class PacketError(Exception):
    pass


def checksum(data: bytes) -> int:
    """Internet (ones'-complement) checksum."""
    if len(data) % 2:
        data += b"\x00"
    s = sum(struct.unpack(f">{len(data) // 2}H", data))
    while s >> 16:
        s = (s & 0xFFFF) + (s >> 16)
    return (~s) & 0xFFFF


def _pseudo_v4(src: bytes, dst: bytes, proto: int, length: int) -> bytes:
    return src + dst + struct.pack(">BBH", 0, proto, length)


def _pseudo_v6(src: bytes, dst: bytes, proto: int, length: int) -> bytes:
    return src + dst + struct.pack(">IHBB", length, 0, 0, proto)


class Ethernet:
    """Inner layers parse LAZILY: the switch forwards most frames
    without ever looking past the header it needs, and to_bytes passes
    untouched payloads through as the original bytes — the router fast
    path (no re-serialization, no checksum recompute)."""

    __slots__ = ("dst", "src", "ether_type", "payload", "_pkt",
                 "_pkt_parsed")

    def __init__(self, dst: bytes, src: bytes, ether_type: int, payload,
                 packet=None):
        self.dst = dst
        self.src = src
        self.ether_type = ether_type
        self.payload = payload  # bytes
        self._pkt = packet      # parsed upper packet or None
        # builders that pass an object are "parsed"; parse() defers
        self._pkt_parsed = packet is not None or not payload

    @property
    def packet(self):
        if not self._pkt_parsed:
            self._pkt_parsed = True
            try:
                if self.ether_type == ETHER_TYPE_ARP:
                    self._pkt = Arp.parse(self.payload)
                elif self.ether_type == ETHER_TYPE_IPV4:
                    self._pkt = Ipv4.parse(self.payload)
                elif self.ether_type == ETHER_TYPE_IPV6:
                    self._pkt = Ipv6.parse(self.payload)
            except PacketError:
                self._pkt = None
        return self._pkt

    @packet.setter
    def packet(self, v) -> None:
        self._pkt = v
        self._pkt_parsed = True

    @classmethod
    def parse(cls, data: bytes) -> "Ethernet":
        if len(data) < 14:
            raise PacketError("ethernet too short")
        return cls(data[:6], data[6:12],
                   struct.unpack(">H", data[12:14])[0], data[14:])

    def to_bytes(self) -> bytes:
        body = self._pkt.to_bytes() if self._pkt is not None else self.payload
        return self.dst + self.src + struct.pack(">H", self.ether_type) + body


class Arp:
    __slots__ = ("op", "sha", "spa", "tha", "tpa")

    def __init__(self, op: int, sha: bytes, spa: bytes, tha: bytes, tpa: bytes):
        self.op = op
        self.sha = sha  # sender mac
        self.spa = spa  # sender ipv4
        self.tha = tha
        self.tpa = tpa

    @classmethod
    def parse(cls, data: bytes) -> "Arp":
        if len(data) < 28:
            raise PacketError("arp too short")
        htype, ptype, hlen, plen, op = struct.unpack(">HHBBH", data[:8])
        if htype != 1 or ptype != ETHER_TYPE_IPV4 or hlen != 6 or plen != 4:
            raise PacketError("unsupported arp")
        return cls(op, data[8:14], data[14:18], data[18:24], data[24:28])

    def to_bytes(self) -> bytes:
        return struct.pack(">HHBBH", 1, ETHER_TYPE_IPV4, 6, 4, self.op) + \
            self.sha + self.spa + self.tha + self.tpa


class Ipv4:
    __slots__ = ("tos", "ident", "flags_frag", "ttl", "proto", "src", "dst",
                 "options", "payload", "_pkt", "_pkt_parsed")

    def __init__(self, src: bytes, dst: bytes, proto: int, payload,
                 ttl: int = 64, tos: int = 0, ident: int = 0,
                 flags_frag: int = 0x4000, options: bytes = b"", packet=None):
        self.src = src
        self.dst = dst
        self.proto = proto
        self.payload = payload
        self.ttl = ttl
        self.tos = tos
        self.ident = ident
        self.flags_frag = flags_frag
        self.options = options
        self._pkt = packet
        self._pkt_parsed = packet is not None or not payload

    @property
    def packet(self):
        """Transport layer, parsed LAZILY: a routed packet never pays
        the ICMP/TCP/UDP parse (or the re-serialization on egress)."""
        if not self._pkt_parsed:
            self._pkt_parsed = True
            try:
                if self.proto == PROTO_ICMP:
                    self._pkt = Icmp.parse(self.payload)
                elif self.proto == PROTO_TCP:
                    self._pkt = Tcp.parse(self.payload)
                elif self.proto == PROTO_UDP:
                    self._pkt = Udp.parse(self.payload)
            except PacketError:
                self._pkt = None
        return self._pkt

    @packet.setter
    def packet(self, v) -> None:
        self._pkt = v
        self._pkt_parsed = True

    @classmethod
    def parse(cls, data: bytes) -> "Ipv4":
        if len(data) < 20:
            raise PacketError("ipv4 too short")
        ver_ihl = data[0]
        if ver_ihl >> 4 != 4:
            raise PacketError("not ipv4")
        ihl = (ver_ihl & 0xF) * 4
        if ihl < 20 or len(data) < ihl:
            raise PacketError("bad ihl")
        tos = data[1]
        total = struct.unpack(">H", data[2:4])[0]
        if total < ihl or total > len(data):
            raise PacketError("bad total length")
        ident, flags_frag = struct.unpack(">HH", data[4:8])
        ttl, proto = data[8], data[9]
        return cls(data[12:16], data[16:20], proto, data[ihl:total], ttl,
                   tos, ident, flags_frag, data[20:ihl])

    def to_bytes(self) -> bytes:
        body = self.payload if self._pkt is None else \
            self._pkt.to_bytes(self.src, self.dst, v6=False)
        ihl = 20 + len(self.options)
        total = ihl + len(body)
        head = bytearray(struct.pack(
            ">BBHHHBBH", (4 << 4) | (ihl // 4), self.tos, total, self.ident,
            self.flags_frag, self.ttl, self.proto, 0))
        head += self.src + self.dst + self.options
        csum = checksum(bytes(head))
        head[10:12] = struct.pack(">H", csum)
        return bytes(head) + body

    def proto_num(self) -> int:
        return self.proto


class Ipv6:
    __slots__ = ("src", "dst", "next_header", "hop_limit", "payload",
                 "_pkt", "_pkt_parsed", "flow")

    def __init__(self, src: bytes, dst: bytes, next_header: int, payload,
                 hop_limit: int = 64, flow: int = 0, packet=None):
        self.src = src
        self.dst = dst
        self.next_header = next_header
        self.payload = payload
        self.hop_limit = hop_limit
        self.flow = flow
        self._pkt = packet
        self._pkt_parsed = packet is not None or not payload

    @property
    def packet(self):
        if not self._pkt_parsed:
            self._pkt_parsed = True
            try:
                if self.next_header == PROTO_ICMPV6:
                    self._pkt = Icmpv6.parse(self.payload)
                elif self.next_header == PROTO_TCP:
                    self._pkt = Tcp.parse(self.payload)
                elif self.next_header == PROTO_UDP:
                    self._pkt = Udp.parse(self.payload)
            except PacketError:
                self._pkt = None
        return self._pkt

    @packet.setter
    def packet(self, v) -> None:
        self._pkt = v
        self._pkt_parsed = True

    @classmethod
    def parse(cls, data: bytes) -> "Ipv6":
        if len(data) < 40:
            raise PacketError("ipv6 too short")
        first = struct.unpack(">I", data[:4])[0]
        if first >> 28 != 6:
            raise PacketError("not ipv6")
        plen, nh, hl = struct.unpack(">HBB", data[4:8])
        if len(data) < 40 + plen:
            raise PacketError("short payload")
        return cls(data[8:24], data[24:40], nh, data[40:40 + plen], hl,
                   first & 0x0FFFFFFF)

    def to_bytes(self) -> bytes:
        body = self.payload if self._pkt is None else \
            self._pkt.to_bytes(self.src, self.dst, v6=True)
        return struct.pack(">IHBB", (6 << 28) | self.flow, len(body),
                           self.next_header, self.hop_limit) + \
            self.src + self.dst + body

    def proto_num(self) -> int:
        return self.next_header


class Icmp:
    __slots__ = ("type", "code", "body")

    def __init__(self, type_: int, code: int, body: bytes):
        self.type = type_
        self.code = code
        self.body = body  # rest-of-header + data

    @classmethod
    def parse(cls, data: bytes) -> "Icmp":
        if len(data) < 4:
            raise PacketError("icmp too short")
        return cls(data[0], data[1], data[4:])

    def to_bytes(self, src: bytes = b"", dst: bytes = b"",
                 v6: bool = False) -> bytes:
        raw = bytearray(struct.pack(">BBH", self.type, self.code, 0) + self.body)
        raw[2:4] = struct.pack(">H", checksum(bytes(raw)))
        return bytes(raw)


class Icmpv6:
    __slots__ = ("type", "code", "body")

    def __init__(self, type_: int, code: int, body: bytes):
        self.type = type_
        self.code = code
        self.body = body

    @classmethod
    def parse(cls, data: bytes) -> "Icmpv6":
        if len(data) < 4:
            raise PacketError("icmpv6 too short")
        return cls(data[0], data[1], data[4:])

    def to_bytes(self, src: bytes, dst: bytes, v6: bool = True) -> bytes:
        raw = bytearray(struct.pack(">BBH", self.type, self.code, 0) + self.body)
        ps = _pseudo_v6(src, dst, PROTO_ICMPV6, len(raw))
        raw[2:4] = struct.pack(">H", checksum(ps + bytes(raw)))
        return bytes(raw)

    # --- NDP helpers (RFC 4861) ---

    @property
    def ndp_target(self) -> Optional[bytes]:
        if self.type in (ICMPV6_NDP_NS, ICMPV6_NDP_NA) and len(self.body) >= 20:
            return self.body[4:20]
        return None

    def ndp_lladdr_option(self) -> Optional[bytes]:
        """source (NS) / target (NA) link-layer address option."""
        off = 20
        want = 1 if self.type == ICMPV6_NDP_NS else 2
        while off + 8 <= len(self.body):
            t, ln = self.body[off], self.body[off + 1]
            if ln == 0:
                return None
            if t == want:
                return self.body[off + 2:off + 8]
            off += ln * 8
        return None


class Udp:
    __slots__ = ("sport", "dport", "data", "csum_ok")

    def __init__(self, sport: int, dport: int, data: bytes):
        self.sport = sport
        self.dport = dport
        self.data = data

    @classmethod
    def parse(cls, data: bytes) -> "Udp":
        if len(data) < 8:
            raise PacketError("udp too short")
        sport, dport, ln, _ = struct.unpack(">HHHH", data[:8])
        if ln < 8 or ln > len(data):
            raise PacketError("bad udp length")
        return cls(sport, dport, data[8:ln])

    def to_bytes(self, src: bytes, dst: bytes, v6: bool) -> bytes:
        ln = 8 + len(self.data)
        raw = bytearray(struct.pack(">HHHH", self.sport, self.dport, ln, 0))
        raw += self.data
        ps = (_pseudo_v6 if v6 else _pseudo_v4)(src, dst, PROTO_UDP, ln)
        cs = checksum(ps + bytes(raw)) or 0xFFFF
        raw[6:8] = struct.pack(">H", cs)
        return bytes(raw)


TCP_FIN, TCP_SYN, TCP_RST, TCP_PSH, TCP_ACK, TCP_URG = 1, 2, 4, 8, 16, 32


class Tcp:
    __slots__ = ("sport", "dport", "seq", "ack", "flags", "window", "options",
                 "data")

    def __init__(self, sport: int, dport: int, seq: int, ack: int, flags: int,
                 window: int, data: bytes = b"", options: bytes = b""):
        self.sport = sport
        self.dport = dport
        self.seq = seq
        self.ack = ack
        self.flags = flags
        self.window = window
        self.options = options
        self.data = data

    @classmethod
    def parse(cls, data: bytes) -> "Tcp":
        if len(data) < 20:
            raise PacketError("tcp too short")
        sport, dport, seq, ack = struct.unpack(">HHII", data[:12])
        off = (data[12] >> 4) * 4
        flags = data[13]
        window = struct.unpack(">H", data[14:16])[0]
        if off < 20 or off > len(data):
            raise PacketError("bad tcp offset")
        return cls(sport, dport, seq, ack, flags, window, data[off:],
                   data[20:off])

    def to_bytes(self, src: bytes, dst: bytes, v6: bool) -> bytes:
        opts = self.options
        if len(opts) % 4:
            opts += b"\x00" * (4 - len(opts) % 4)
        off = 20 + len(opts)
        raw = bytearray(struct.pack(
            ">HHIIBBHHH", self.sport, self.dport, self.seq, self.ack,
            (off // 4) << 4, self.flags, self.window, 0, 0))
        raw += opts + self.data
        ps = (_pseudo_v6 if v6 else _pseudo_v4)(src, dst, PROTO_TCP, len(raw))
        raw[16:18] = struct.pack(">H", checksum(ps + bytes(raw)))
        return bytes(raw)

    def mss_option(self) -> Optional[int]:
        off = 0
        while off < len(self.options):
            k = self.options[off]
            if k == 0:
                return None
            if k == 1:
                off += 1
                continue
            if off + 1 >= len(self.options):
                return None
            ln = self.options[off + 1]
            if ln < 2:
                return None
            if k == 2 and ln == 4:
                return struct.unpack(">H", self.options[off + 2:off + 4])[0]
            off += ln
        return None


class Vxlan:
    __slots__ = ("vni", "ether")

    def __init__(self, vni: int, ether: Ethernet):
        self.vni = vni
        self.ether = ether

    @classmethod
    def parse(cls, data: bytes) -> "Vxlan":
        if len(data) < 8:
            raise PacketError("vxlan too short")
        flags = data[0]
        if not flags & 0x08:
            raise PacketError("vxlan I flag not set")
        vni = int.from_bytes(data[4:7], "big")
        return cls(vni, Ethernet.parse(data[8:]))

    def to_bytes(self) -> bytes:
        return bytes([0x08, 0, 0, 0]) + self.vni.to_bytes(3, "big") + b"\x00" + \
            self.ether.to_bytes()


# ------------------------------------------------- encrypted switch packet

def _aes_cfb(key: bytes, iv: bytes, data: bytes, encrypt: bool) -> bytes:
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
    c = Cipher(algorithms.AES(key), modes.CFB(iv))
    op = c.encryptor() if encrypt else c.decryptor()
    return op.update(data) + op.finalize()


class VProxySwitchPacket:
    """User-authenticated encrypted VXLAN tunnel packet
    (VProxyEncryptedPacket.java layout): user(6) iv(16) then
    AES-256-CFB(magic(4) type(2) [vxlan])."""

    __slots__ = ("user", "type", "vxlan")

    def __init__(self, user: str, type_: int, vxlan: Optional[Vxlan]):
        self.user = user  # base64 (no padding) of the 6 raw bytes
        self.type = type_
        self.vxlan = vxlan

    @classmethod
    def parse(cls, data: bytes, key_for) -> "VProxySwitchPacket":
        import base64
        if len(data) < 28:
            raise PacketError("switch packet too short")
        user = base64.b64encode(data[:6]).decode().replace("=", "")
        key = key_for(user)
        if key is None:
            raise PacketError(f"no key for user {user}")
        iv = data[6:22]
        plain = _aes_cfb(key, iv, data[22:], encrypt=False)
        magic = struct.unpack(">I", plain[:4])[0]
        if magic != VPROXY_SWITCH_MAGIC:
            raise PacketError("wrong magic (bad key?)")
        type_ = struct.unpack(">H", plain[4:6])[0]
        if type_ == VPROXY_TYPE_VXLAN:
            return cls(user, type_, Vxlan.parse(plain[6:]))
        if type_ == VPROXY_TYPE_PING:
            if len(plain) != 6:
                raise PacketError("extra bytes in ping")
            return cls(user, type_, None)
        raise PacketError(f"bad switch packet type {type_}")

    def to_bytes(self, key_for) -> bytes:
        import base64
        import binascii
        pad = self.user + "=" * (-len(self.user) % 4)
        try:
            raw_user = base64.b64decode(pad)
        except binascii.Error as e:
            raise PacketError(f"user is not wire-encodable: {e}") from e
        if len(raw_user) != 6:
            raise PacketError("user must decode to 6 bytes")
        key = key_for(self.user)
        if key is None:
            raise PacketError(f"no key for user {self.user}")
        iv = os.urandom(16)
        plain = struct.pack(">IH", VPROXY_SWITCH_MAGIC, self.type)
        if self.vxlan is not None:
            plain += self.vxlan.to_bytes()
        return raw_user + iv + _aes_cfb(key, iv, plain, encrypt=True)


def mac_str(mac: bytes) -> str:
    return ":".join(f"{b:02x}" for b in mac)


def parse_mac(s: str) -> bytes:
    parts = s.split(":")
    if len(parts) != 6:
        raise PacketError(f"bad mac {s!r}")
    return bytes(int(p, 16) for p in parts)
