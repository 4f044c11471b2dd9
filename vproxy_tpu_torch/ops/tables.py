"""Rule-table compilers: rule IR -> fixed-shape padded tables.

The port's copy of `vproxy_tpu/ops/tables.py` (numpy only, byte for byte
the reference's arrays):

* the table-shape constants the hash and fingerprint paths read (the
  host/uri byte limits, the address-family codes, the capacity padding
  rule) and the address encoder of CIDR queries (`encode_ips`);
* the dense bit-plane compilers of the "torch-dense" backend (the
  reference's "jax-dense"): HintTable (Upstream Host/SNI/URI rules,
  Hint.java:92-160 scoring, Upstream.java:187 scan) and CidrTable
  (RouteTable.java:44 and SecurityGroup.java:30: each rule expands to
  <=3 (value16, mask16, family) patterns that reproduce
  Network.maskMatch's mixed v4/v6 cases, Network.java:183-278), and the
  query encoder `encode_hints`.

Tables are fixed-capacity arrays: capacity pads to a bucket, and an
update that fits re-fills arrays of the same shape.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..rules.ir import AclRule, HintRule, Proto, RouteRule
from ..utils.ip import to16
from .bitmatch import compile_patterns

MAX_HOST = 64  # max host/domain byte length in device tables
MAX_URI = 128  # max uri prefix byte length
HOST_SLOT = MAX_HOST + 2  # +1 dot-boundary spill slot, +1 length byte
URI_MAX_SCORE = 1023

V4, V6 = 0, 1

MATCH_CHUNK = 8192  # rules per scan step in the chunked matchers


def _pad_cap(n: int, bucket: int = 256) -> int:
    # big tables pad to a multiple of MATCH_CHUNK so the scanned matchers
    # can slice even chunks
    if n > MATCH_CHUNK:
        bucket = MATCH_CHUNK
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def encode_host(host: Optional[str]) -> np.ndarray:
    """Query-side host encoding: reversed bytes + length byte at the end."""
    out = np.zeros(HOST_SLOT, dtype=np.uint8)
    if host is not None:
        b = host.encode()[::-1]
        # length byte carries the TRUE length so a truncated over-long query
        # can never exact-match a max-length rule; suffix matching only uses
        # the first MAX_HOST reversed bytes (the domain tail), which survive.
        out[-1] = min(len(b), 255)
        # keep MAX_HOST+1 reversed bytes so the dot-boundary spill slot is
        # populated for suffix matches against max-length rule hosts
        b = b[: MAX_HOST + 1]
        out[: len(b)] = np.frombuffer(b, dtype=np.uint8)
    return out


def encode_uri(uri: Optional[str]) -> tuple[np.ndarray, int]:
    out = np.zeros(MAX_URI, dtype=np.uint8)
    if uri is None:
        return out, 0
    b = uri.encode()[:MAX_URI]
    out[: len(b)] = np.frombuffer(b, dtype=np.uint8)
    return out, len(b)


@dataclass
class HintTable:
    """Compiled hint-rule table (numpy; upload with
    torchenv.tables_from_reference)."""

    n: int  # live rule count
    cap: int  # padded capacity
    # host patterns: slot 0 = exact, slot 1 = dot-suffix
    host_w: np.ndarray  # [HOST_SLOT*8, cap*2] f32
    host_c: np.ndarray  # [cap*2] f32
    host_valid: np.ndarray  # [cap, 2] bool
    host_wild: np.ndarray  # [cap] bool
    # uri prefix patterns
    uri_w: np.ndarray  # [MAX_URI*8, cap] f32
    uri_c: np.ndarray  # [cap] f32
    uri_valid: np.ndarray  # [cap] bool
    uri_wild: np.ndarray  # [cap] bool
    uri_score: np.ndarray  # [cap] i32  (min(len+1, 1023))
    port: np.ndarray  # [cap] i32
    active: np.ndarray  # [cap] bool


def compile_hint_rules(rules: Sequence[HintRule], cap: Optional[int] = None) -> HintTable:
    n = len(rules)
    cap = cap or _pad_cap(n)
    assert n <= cap
    hv = np.zeros((cap * 2, HOST_SLOT), dtype=np.uint8)
    hm = np.zeros((cap * 2, HOST_SLOT), dtype=np.uint8)
    host_valid = np.zeros((cap, 2), dtype=bool)
    host_wild = np.zeros(cap, dtype=bool)
    uv = np.zeros((cap, MAX_URI), dtype=np.uint8)
    um = np.zeros((cap, MAX_URI), dtype=np.uint8)
    uri_valid = np.zeros(cap, dtype=bool)
    uri_wild = np.zeros(cap, dtype=bool)
    uri_score = np.zeros(cap, dtype=np.int32)
    port = np.zeros(cap, dtype=np.int32)
    active = np.zeros(cap, dtype=bool)

    for i, r in enumerate(rules):
        if r.is_empty():
            continue
        active[i] = True
        port[i] = r.port
        if r.host is not None:
            hb = r.host.encode()[::-1]
            if len(hb) > MAX_HOST:
                raise ValueError(
                    f"host rule longer than MAX_HOST={MAX_HOST}: {r.host!r}")
            # exact: bytes + length byte must both match
            hv[2 * i, : len(hb)] = np.frombuffer(hb, dtype=np.uint8)
            hm[2 * i, : len(hb)] = 0xFF
            hv[2 * i, -1] = len(hb) & 0xFF
            hm[2 * i, -1] = 0xFF
            host_valid[i, 0] = True
            # suffix: query endswith("." + host) — bytes + '.' boundary,
            # length byte unconstrained (query strictly longer)
            hv[2 * i + 1, : len(hb)] = np.frombuffer(hb, dtype=np.uint8)
            hm[2 * i + 1, : len(hb)] = 0xFF
            hv[2 * i + 1, len(hb)] = ord(".")
            hm[2 * i + 1, len(hb)] = 0xFF
            host_valid[i, 1] = True
            if r.host == "*":
                host_wild[i] = True
        if r.uri is not None:
            ub = r.uri.encode()
            if len(ub) > MAX_URI:
                raise ValueError(
                    f"uri rule longer than MAX_URI={MAX_URI}: {r.uri!r}")
            uv[i, : len(ub)] = np.frombuffer(ub, dtype=np.uint8)
            um[i, : len(ub)] = 0xFF
            uri_valid[i] = True
            uri_score[i] = min(len(ub) + 1, URI_MAX_SCORE)
            if r.uri == "*":
                uri_wild[i] = True

    host_w, host_c = compile_patterns(hv, hm)
    uri_w, uri_c = compile_patterns(uv, um)
    return HintTable(
        n=n, cap=cap,
        host_w=host_w, host_c=host_c, host_valid=host_valid, host_wild=host_wild,
        uri_w=uri_w, uri_c=uri_c, uri_valid=uri_valid, uri_wild=uri_wild,
        uri_score=uri_score, port=port, active=active,
    )


@dataclass
class CidrTable:
    """Compiled CIDR pattern table (3 pattern slots per rule)."""

    n: int
    cap: int
    w: np.ndarray  # [128, cap*3] f32
    c: np.ndarray  # [cap*3] f32
    family: np.ndarray  # [cap*3] i32 (V4/V6)
    valid: np.ndarray  # [cap*3] bool
    # ACL extras (unused for routes):
    min_port: np.ndarray  # [cap] i32
    max_port: np.ndarray  # [cap] i32
    allow: np.ndarray  # [cap] bool


def _expand_cidr(network, vals, masks, fams, valids, base: int) -> None:
    """Fill up to 3 pattern slots (starting at `base`) for one Network,
    reproducing Network.maskMatch. vals/masks are uint8 [slots, 16]."""
    ip, mask = network.ip, network.mask
    if len(ip) == 4:
        # v4 rule: v4 inputs (case 5) + v6 ::x / ::ffff:x inputs (case 4)
        vals[base, 12:] = np.frombuffer(ip, dtype=np.uint8)
        masks[base, 12:] = np.frombuffer(mask, dtype=np.uint8)
        fams[base], valids[base] = V4, True
        vals[base + 1, 12:] = np.frombuffer(ip, dtype=np.uint8)
        masks[base + 1, :12] = 0xFF
        masks[base + 1, 12:] = np.frombuffer(mask, dtype=np.uint8)
        fams[base + 1], valids[base + 1] = V6, True
        vals[base + 2, 10:12] = 0xFF
        vals[base + 2, 12:] = np.frombuffer(ip, dtype=np.uint8)
        masks[base + 2, :12] = 0xFF
        masks[base + 2, 12:] = np.frombuffer(mask, dtype=np.uint8)
        fams[base + 2], valids[base + 2] = V6, True
    elif len(mask) == 4:
        # v6 rule, mask <= 32: v6 inputs only, compare first 4 bytes (case 1)
        vals[base, :4] = np.frombuffer(ip[:4], dtype=np.uint8)
        masks[base, :4] = np.frombuffer(mask, dtype=np.uint8)
        fams[base], valids[base] = V6, True
    else:
        # v6 rule, mask > 32: v6 inputs (case 5) ...
        vals[base, :] = np.frombuffer(ip, dtype=np.uint8)
        masks[base, :] = np.frombuffer(mask, dtype=np.uint8)
        fams[base], valids[base] = V6, True
        # ... and v4 inputs iff rule high bytes are [0]*10 + (0000|ffff)
        hi_ok = all(b == 0 for b in ip[:10]) and (ip[10:12] in (b"\x00\x00", b"\xff\xff"))
        if hi_ok:
            vals[base + 1, 12:] = np.frombuffer(ip[12:], dtype=np.uint8)
            masks[base + 1, 12:] = np.frombuffer(mask[12:], dtype=np.uint8)
            fams[base + 1], valids[base + 1] = V4, True


def compile_cidr_rules(networks: Sequence, cap: Optional[int] = None,
                       acl: Optional[Sequence[AclRule]] = None) -> CidrTable:
    """networks: list of Network in match-priority order (first wins)."""
    n = len(networks)
    cap = cap or _pad_cap(n)
    assert n <= cap
    vals = np.zeros((cap * 3, 16), dtype=np.uint8)
    masks = np.zeros((cap * 3, 16), dtype=np.uint8)
    fams = np.zeros(cap * 3, dtype=np.int32)
    valids = np.zeros(cap * 3, dtype=bool)
    min_port = np.zeros(cap, dtype=np.int32)
    max_port = np.zeros(cap, dtype=np.int32)
    allow = np.zeros(cap, dtype=bool)
    for i, net in enumerate(networks):
        _expand_cidr(net, vals, masks, fams, valids, 3 * i)
    if acl is not None:
        for i, r in enumerate(acl):
            min_port[i], max_port[i], allow[i] = r.min_port, r.max_port, r.allow
    w, c = compile_patterns(vals, masks)
    return CidrTable(n=n, cap=cap, w=w, c=c, family=fams, valid=valids,
                     min_port=min_port, max_port=max_port, allow=allow)


def compile_route_table(rules: Sequence[RouteRule], cap: Optional[int] = None) -> CidrTable:
    return compile_cidr_rules([r.rule for r in rules], cap)


def compile_acl(rules: Sequence[AclRule], proto: Proto, cap: Optional[int] = None) -> CidrTable:
    sub = [r for r in rules if r.protocol == proto]
    return compile_cidr_rules([r.network for r in sub], cap, acl=sub)


def encode_hints(hints: Sequence) -> dict:
    """Batch of Hint queries -> device-ready arrays."""
    b = len(hints)
    host = np.zeros((b, HOST_SLOT), dtype=np.uint8)
    has_host = np.zeros(b, dtype=bool)
    uri = np.zeros((b, MAX_URI), dtype=np.uint8)
    has_uri = np.zeros(b, dtype=bool)
    port = np.zeros(b, dtype=np.int32)
    for i, h in enumerate(hints):
        if h.host is not None:
            host[i] = encode_host(h.host)
            has_host[i] = True
        if h.uri is not None:
            uri[i], _ = encode_uri(h.uri)
            has_uri[i] = True
        port[i] = h.port
    return {"host": host, "has_host": has_host, "uri": uri,
            "has_uri": has_uri, "port": port}


def encode_ips(addrs: Sequence[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """-> (addr16 [B,16] uint8, family [B] i32)."""
    b = len(addrs)
    # all-v4 fast path (the switch burst, LB accept batches): one buffer
    # reshape instead of a python loop
    if b and all(len(a) == 4 for a in addrs):
        out = np.zeros((b, 16), dtype=np.uint8)
        out[:, 12:] = np.frombuffer(b"".join(addrs),
                                    dtype=np.uint8).reshape(b, 4)
        return out, np.full(b, V4, dtype=np.int32)
    out = np.zeros((b, 16), dtype=np.uint8)
    fam = np.zeros(b, dtype=np.int32)
    for i, a in enumerate(addrs):
        out[i] = np.frombuffer(to16(a), dtype=np.uint8)
        fam[i] = V4 if len(a) == 4 else V6
    return out, fam
