"""DNS wire codec (RFC 1035 subset).

Parity target: the reference's dns/Formatter.java + DNSPacket/rdata/*
(A/AAAA/SRV/CNAME/TXT — base dns, SURVEY.md §2.1). Parsing handles
name-compression pointers; encoding writes uncompressed names (legal,
simpler, and responses stay under typical EDNS sizes for our record
counts).

The port's copy of vproxy_tpu/dns/packet.py, same names and behaviour.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

from ..utils.ip import format_ip, parse_ip

# qtype / type codes
A, NS, CNAME, SOA, PTR, TXT, AAAA, SRV, OPT, ANY = (
    1, 2, 5, 6, 12, 16, 28, 33, 41, 255)
CLASS_IN = 1


class DNSFormatError(Exception):
    pass


def _encode_name(name: str) -> bytes:
    if name and not name.endswith("."):
        name += "."
    out = bytearray()
    for label in name.split("."):
        if not label:
            continue
        raw = label.encode()
        if len(raw) > 63:
            raise DNSFormatError(f"label too long: {label!r}")
        out.append(len(raw))
        out += raw
    out.append(0)
    return bytes(out)


def _decode_name(data: bytes, off: int) -> tuple[str, int]:
    labels = []
    jumps = 0
    end = -1
    while True:
        if off >= len(data):
            raise DNSFormatError("truncated name")
        ln = data[off]
        if ln == 0:
            if end < 0:
                end = off + 1
            break
        if ln & 0xC0 == 0xC0:
            if off + 1 >= len(data):
                raise DNSFormatError("truncated pointer")
            ptr = ((ln & 0x3F) << 8) | data[off + 1]
            if end < 0:
                end = off + 2
            off = ptr
            jumps += 1
            if jumps > 64:
                raise DNSFormatError("compression loop")
            continue
        if off + 1 + ln > len(data):
            raise DNSFormatError("truncated label")
        labels.append(data[off + 1: off + 1 + ln].decode("latin-1"))
        off += 1 + ln
    return ".".join(labels) + ".", end


@dataclass
class Question:
    qname: str  # always with trailing dot
    qtype: int
    qclass: int = CLASS_IN


@dataclass
class Record:
    name: str
    rtype: int
    rclass: int = CLASS_IN
    ttl: int = 0
    # interpreted rdata (by rtype): A/AAAA -> ip bytes; CNAME/PTR -> str;
    # SRV -> (prio, weight, port, target); TXT -> list[bytes]; else raw bytes
    rdata: object = b""

    def _encode_rdata(self) -> bytes:
        if self.rtype in (A, AAAA):
            return bytes(self.rdata)
        if self.rtype in (CNAME, PTR, NS):
            return _encode_name(self.rdata)
        if self.rtype == SRV:
            prio, weight, port, target = self.rdata
            return struct.pack(">HHH", prio, weight, port) + _encode_name(target)
        if self.rtype == TXT:
            out = bytearray()
            for chunk in self.rdata:
                out.append(len(chunk))
                out += chunk
            return bytes(out)
        return bytes(self.rdata)


@dataclass
class Packet:
    id: int = 0
    is_resp: bool = False
    opcode: int = 0
    aa: bool = False
    tc: bool = False
    rd: bool = True
    ra: bool = False
    rcode: int = 0
    questions: list = field(default_factory=list)
    answers: list = field(default_factory=list)
    authorities: list = field(default_factory=list)
    additionals: list = field(default_factory=list)

    def encode(self) -> bytes:
        flags = 0
        if self.is_resp:
            flags |= 0x8000
        flags |= (self.opcode & 0xF) << 11
        if self.aa:
            flags |= 0x0400
        if self.tc:
            flags |= 0x0200
        if self.rd:
            flags |= 0x0100
        if self.ra:
            flags |= 0x0080
        flags |= self.rcode & 0xF
        out = bytearray(struct.pack(
            ">HHHHHH", self.id, flags, len(self.questions), len(self.answers),
            len(self.authorities), len(self.additionals)))
        for q in self.questions:
            out += _encode_name(q.qname) + struct.pack(">HH", q.qtype, q.qclass)
        for r in self.answers + self.authorities + self.additionals:
            rd = r._encode_rdata()
            out += _encode_name(r.name)
            out += struct.pack(">HHIH", r.rtype, r.rclass, r.ttl, len(rd))
            out += rd
        return bytes(out)


def _parse_record(data: bytes, off: int) -> tuple[Record, int]:
    name, off = _decode_name(data, off)
    if off + 10 > len(data):
        raise DNSFormatError("truncated record")
    rtype, rclass, ttl, rdlen = struct.unpack(">HHIH", data[off: off + 10])
    off += 10
    if off + rdlen > len(data):
        raise DNSFormatError("truncated rdata")
    raw = data[off: off + rdlen]
    rdata: object = raw
    if rtype in (A, AAAA):
        rdata = raw
    elif rtype in (CNAME, PTR, NS):
        rdata, _ = _decode_name(data, off)
    elif rtype == SRV:
        if rdlen < 6:
            raise DNSFormatError("truncated SRV rdata")
        prio, weight, port = struct.unpack(">HHH", raw[:6])
        target, _ = _decode_name(data, off + 6)
        rdata = (prio, weight, port, target)
    elif rtype == TXT:
        chunks = []
        i = 0
        while i < len(raw):
            ln = raw[i]
            chunks.append(raw[i + 1: i + 1 + ln])
            i += 1 + ln
        rdata = chunks
    off += rdlen
    return Record(name=name, rtype=rtype, rclass=rclass, ttl=ttl, rdata=rdata), off


def parse(data: bytes) -> Packet:
    if len(data) < 12:
        raise DNSFormatError("short packet")
    pid, flags, nq, nan, nau, nad = struct.unpack(">HHHHHH", data[:12])
    p = Packet(
        id=pid,
        is_resp=bool(flags & 0x8000),
        opcode=(flags >> 11) & 0xF,
        aa=bool(flags & 0x0400),
        tc=bool(flags & 0x0200),
        rd=bool(flags & 0x0100),
        ra=bool(flags & 0x0080),
        rcode=flags & 0xF,
    )
    off = 12
    for _ in range(nq):
        qname, off = _decode_name(data, off)
        if off + 4 > len(data):
            raise DNSFormatError("truncated question")
        qtype, qclass = struct.unpack(">HH", data[off: off + 4])
        off += 4
        p.questions.append(Question(qname, qtype, qclass))
    for n, lst in ((nan, p.answers), (nau, p.authorities), (nad, p.additionals)):
        for _ in range(n):
            rec, off = _parse_record(data, off)
            lst.append(rec)
    return p
