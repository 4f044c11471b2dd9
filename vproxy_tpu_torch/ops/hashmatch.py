"""Hash-based classify — host compilers plus the torch tiers.

The O(1)-per-query fast path of `vproxy_tpu/ops/hashmatch.py`, split in
two halves:

* **Host half (numpy):** `compile_hint_hash` builds the cuckoo-hashed
  rule tables, `encode_hint_queries` hashes a query batch into probe
  slots; `compile_cidr_hash` builds the per-(family, mask) cuckoo
  tables of a route list or ACL. All are copies of the reference's and
  produce byte-identical arrays (tests/test_torch_host.py,
  tests/test_torch_cidr.py).
* **Torch tiers:** `hint_hash_match` scores every candidate a query's
  probes and the wildcard lists surface with the full Hint.matchLevel
  formula (Hint.java:92-160) and reduces to (max level, min rule index)
  (Upstream.java:187-198). It serves unfused hint batches on any device.
  `cidr_hash_match` is the ordered first match of a route or ACL table
  (RouteTable.java:44, SecurityGroup.java:30): the plain tier of the
  CIDR kernel (ops/cidr_cuda.py), which serves CPU tensors;
  `classify_hash_all` stacks hint, route and ACL answers.
* **Sharded half (numpy):** `compile_hint_hash_sharded` /
  `compile_cidr_hash_sharded` compile S contiguous rule slices under one
  unified caps dict and stack them (`ShardedHashTable`);
  `encode_hint_queries_sharded` encodes a batch for every shard in one
  pass. Copies of the reference's, byte-identical
  (tests/test_torch_sharded.py).

Semantics notes carried over from the reference: a JAX gather clamps an
out-of-range index, torch indexing raises, so every index the reference
clamps (`jnp.maximum(x, 0)`, `clip`) is clamped here too; candidate
indices outside the clamps are in range by construction.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..rules.ir import AclRule, HintRule
from . import cuckoo as CK
from .tables import MAX_HOST, MAX_URI, V4, V6, _pad_cap

HOST_SHIFT = 10
URI_MAX_SCORE = 1023
DOT = ord(".")

# probe-count tiers for host dot-suffixes: the encoder picks the smallest
# tier covering the batch, so the probe arrays take few shapes. Every
# padded probe is one wasted row gather per query, so the low tiers are
# fine-grained: typical 3-5-label domains land on 5/7 instead of 9
MAXP_TIERS = (5, 7, 9, 17, 33, 66)


def _pow2(n: int, lo: int = 2) -> int:
    c = lo
    while c < n:
        c <<= 1
    return c


# --------------------------------------------------------------- hint side


@dataclass
class HashHintTable:
    """Compiled hash-path hint table: device arrays + host-side meta the
    encoder needs (salts, caps, the rule-uri length set).

    `hw`/`uw` are the host/uri byte-compare windows — sized to the
    table's longest key (rounded up), not the global MAX_HOST/MAX_URI,
    because the query payload is h2d-bandwidth that bounds classify
    throughput: bytes beyond the longest rule key can never influence a
    match (exact needs equal lengths, suffix/prefix compare only rule
    bytes), so they are never shipped."""

    n: int
    r_cap: int
    arrays: dict  # numpy arrays; engine device_puts them
    host_cap: int
    host_salts: tuple
    uri_cap: int
    uri_salts: tuple
    lset: list  # distinct rule-uri lengths (normal rules)
    hw: int  # host window: max rule-host len + 1 boundary byte (padded)
    uw: int  # uri window: max rule-uri len (padded)
    caps: dict = field(default_factory=dict)  # all static caps for reuse


class CapsExceeded(Exception):
    """A caps-reusing recompile outgrew the reused shapes: the caller
    rebuilds with fresh caps (the fingerprint backend's compilers raise
    it under `strict`, ops/fphash.py)."""


def _prune_list(rules, items, sig):
    seen, keep = set(), []
    for i in sorted(items):
        s = sig(rules[i])
        if s not in seen:
            seen.add(s)
            keep.append(i)
    return keep


def compile_hint_hash(rules: Sequence[HintRule],
                      caps: Optional[dict] = None) -> HashHintTable:
    caps = dict(caps or {})
    n = len(rules)
    r_cap = caps.get("r_cap") or _pad_cap(n, 256)
    if n > r_cap:
        r_cap = _pad_cap(n, 256)
    # past _PACK_I32_MAX rules the kernel's (level, index) reduction
    # switches from i32 packing to the two-pass form (see
    # hint_hash_match) — no capacity assert needed anymore

    host_buckets: dict[bytes, list[int]] = {}
    uri_buckets: dict[bytes, list[int]] = {}
    wh: list[int] = []
    wu: list[int] = []
    max_hl = max_ul = 0
    for i, r in enumerate(rules):
        if not (i & 31):
            CK.coop_yield()
        if r.is_empty():
            continue
        if r.host is not None:
            if len(r.host.encode()) > MAX_HOST:
                raise ValueError(f"host rule longer than {MAX_HOST}: {r.host!r}")
            max_hl = max(max_hl, len(r.host.encode()))
        if r.uri is not None:
            if len(r.uri.encode()) > MAX_URI:
                raise ValueError(f"uri rule longer than {MAX_URI}: {r.uri!r}")
            max_ul = max(max_ul, len(r.uri.encode()))
    # compare windows: +1 host byte for the suffix boundary dot
    hw = min(MAX_HOST + 1, max(caps.get("hw", 0), _pow2(max_hl + 1, 8)))
    uw = min(MAX_URI, max(caps.get("uw", 0), _pow2(max(max_ul, 1), 8)))

    r_active = np.zeros(r_cap, bool)
    r_port = np.zeros(r_cap, np.int32)
    r_host_kind = np.zeros(r_cap, np.int32)  # 0 none / 1 normal / 2 wild
    r_host_len = np.zeros(r_cap, np.int32)
    r_host = np.zeros((r_cap, hw), np.uint8)  # reversed bytes
    r_uri_kind = np.zeros(r_cap, np.int32)
    r_uri_len = np.zeros(r_cap, np.int32)
    r_uri = np.zeros((r_cap, uw), np.uint8)
    r_uri_score = np.zeros(r_cap, np.int32)

    for i, r in enumerate(rules):
        if not (i & 31):
            CK.coop_yield()
        if r.is_empty():
            continue
        r_active[i] = True
        r_port[i] = r.port
        if r.host is not None:
            hb = r.host.encode()[::-1]
            r_host_kind[i] = 2 if r.host == "*" else 1
            r_host_len[i] = len(hb)
            r_host[i, : len(hb)] = np.frombuffer(hb, np.uint8)
            host_buckets.setdefault(bytes(hb), []).append(i)
            if r.host == "*":
                wh.append(i)
        if r.uri is not None:
            ub = r.uri.encode()
            r_uri_kind[i] = 2 if r.uri == "*" else 1
            r_uri_len[i] = len(ub)
            r_uri[i, : len(ub)] = np.frombuffer(ub, np.uint8)
            r_uri_score[i] = min(len(ub) + 1, URI_MAX_SCORE)
            uri_buckets.setdefault(bytes(ub), []).append(i)
            if r.uri == "*":
                wu.append(i)

    # Bucket pruning (exactness-preserving): members of one bucket share
    # the keyed attribute, so a later member whose OTHER attributes equal
    # an earlier member's can never outscore it (same level, later index)
    # — keep only the earliest per residual signature. For uri buckets
    # the residual is just the port: a member whose host matches a query
    # surfaces via the (complete) host bucket with a >= level, so among
    # pure-uri contributions, earliest-per-port dominates. This is what
    # keeps candidate counts O(1) when thousands of rules share one uri.
    for bi, k in enumerate(host_buckets):
        if not (bi & 63):
            CK.coop_yield()
        host_buckets[k] = _prune_list(rules, host_buckets[k],
                                      lambda r: (r.uri, r.port))
    for bi, k in enumerate(uri_buckets):
        if not (bi & 63):
            CK.coop_yield()
        uri_buckets[k] = _prune_list(rules, uri_buckets[k], lambda r: r.port)
    # wh (host="*") members differ in uri, which the wildcard path must
    # itself score -> dedupe per (uri, port). wu (uri="*") members' host
    # relation is covered by the complete host buckets whenever it fires,
    # so the global list only represents the host-miss (0|1) case ->
    # earliest per port suffices even with thousands of wu rules.
    wh = _prune_list(rules, wh, lambda r: (r.uri, r.port))
    wu = _prune_list(rules, wu, lambda r: r.port)

    ht, hb_items = CK.build_cuckoo(host_buckets, hw,
                                   cap=caps.get("host_cap"), salt_base=1)
    ut, ub_items = CK.build_cuckoo(uri_buckets, uw,
                                   cap=caps.get("uri_cap"), salt_base=2)
    bh = max(caps.get("bh", 0), _pow2(int(ht.bucket_count.max(initial=1))))
    bu = max(caps.get("bu", 0), _pow2(int(ut.bucket_count.max(initial=1))))
    whc = max(caps.get("wh", 0), _pow2(len(wh), 2))
    wuc = max(caps.get("wu", 0), _pow2(len(wu), 2))
    hbc = max(caps.get("hb_items", 0), _pow2(max(len(hb_items), 1), 256))
    ubc = max(caps.get("ub_items", 0), _pow2(max(len(ub_items), 1), 256))

    lset = sorted({int(l) for l, k in zip(r_uri_len, r_uri_kind) if k == 1})
    lset_cap = max(caps.get("lset", 0), _pow2(max(len(lset), 1), 4))
    if len(lset) > lset_cap:
        lset_cap = _pow2(len(lset), 4)

    def pad_items(items, cap):
        out = np.full(cap, -1, np.int32)
        out[: len(items)] = items
        return out

    arrays = {
        "r_active": r_active, "r_port": r_port,
        "r_host_kind": r_host_kind, "r_host_len": r_host_len, "r_host": r_host,
        "r_uri_kind": r_uri_kind, "r_uri_len": r_uri_len, "r_uri": r_uri,
        "r_uri_score": r_uri_score,
        "hk_used": ht.used, "hk_len": ht.key_len, "hk_bytes": ht.key_bytes,
        "hk_bs": ht.bucket_start, "hk_bc": np.minimum(ht.bucket_count, bh),
        "hb_items": pad_items(hb_items, hbc),
        "uk_used": ut.used, "uk_len": ut.key_len, "uk_bytes": ut.key_bytes,
        "uk_bs": ut.bucket_start, "uk_bc": np.minimum(ut.bucket_count, bu),
        "ub_items": pad_items(ub_items, ubc),
        "wh_idx": pad_items(wh, whc), "wu_idx": pad_items(wu, wuc),
        # bucket caps as array shapes: [bh]/[bu] dummy arange carries the
        # static bucket width into the jitted kernel
        "bh_iota": np.arange(bh, dtype=np.int32),
        "bu_iota": np.arange(bu, dtype=np.int32),
    }
    return HashHintTable(
        n=n, r_cap=r_cap, arrays=arrays,
        host_cap=ht.cap, host_salts=(ht.salt1, ht.salt2),
        uri_cap=ut.cap, uri_salts=(ut.salt1, ut.salt2), lset=lset,
        hw=hw, uw=uw,
        caps={"r_cap": r_cap, "host_cap": ht.cap, "uri_cap": ut.cap,
              "bh": bh, "bu": bu, "wh": whc, "wu": wuc, "hw": hw, "uw": uw,
              "hb_items": hbc, "ub_items": ubc, "lset": lset_cap})


def _fill_query_windows(hints: Sequence, hw: int, uw: int, cap: int):
    """Shared query-byte-window fill for the vectorized encoders:
    -> (hostb [cap,hw] u8 reversed, hlen, has_host, urib [cap,uw] u8,
    ulen, has_uri, port). Rows past len(hints) stay zero (pad rows).
    The small-batch encoder fuses this walk with its per-hint hashing
    and intentionally does not share it."""
    q_hostb = np.zeros((cap, hw), np.uint8)
    q_hlen = np.zeros(cap, np.int32)
    q_has_host = np.zeros(cap, bool)
    q_urib = np.zeros((cap, uw), np.uint8)
    q_ulen = np.zeros(cap, np.int32)
    q_has_uri = np.zeros(cap, bool)
    q_port = np.zeros(cap, np.int32)
    for i, h in enumerate(hints):
        if h.host is not None:
            hb = h.host.encode()[::-1]
            q_hlen[i] = min(len(hb), 1 << 20)
            q_hostb[i, : min(len(hb), hw)] = np.frombuffer(hb[:hw],
                                                           np.uint8)
            q_has_host[i] = True
        if h.uri is not None:
            ub = h.uri.encode()
            q_ulen[i] = min(len(ub), 1 << 20)
            q_urib[i, : min(len(ub), uw)] = np.frombuffer(ub[:uw],
                                                          np.uint8)
            q_has_uri[i] = True
        q_port[i] = h.port
    return (q_hostb, q_hlen, q_has_host, q_urib, q_ulen, q_has_uri,
            q_port)


# the python-int FNV form lives in ops/cuckoo (single source for the
# bit-identity-critical constants); aliased for the hot loop below
_FNV64_MASK = CK._M64
_FNV64_PRIME_I = CK._FNV64_PRIME_I
_FNV64_OFFSET_I = CK._FNV64_OFFSET_I
# at or below this batch size the per-hint pure-python encoder runs:
# the vectorized rolling-FNV pass costs ~W sequential numpy calls whose
# per-call overhead dwarfs the math on accept-path-sized batches. The
# crossover is vproxy_tpu's (same knob, same default), and both
# encoders produce identical arrays.
SMALL_ENCODE = int(os.environ.get("VPROXY_TPU_SMALL_ENCODE", "28"))


def _encode_hint_queries_small(hints: Sequence, tab: HashHintTable,
                               pad_to: int) -> dict:
    """Per-hint python encoder, bit-identical outputs to the vectorized
    path (same probe order: dot suffixes ascending, exact slot last;
    same shapes: MAXP tier + lset_cap widths), O(bytes) python ints
    instead of O(W) numpy dispatches."""
    b = len(hints)
    cap = max(b, pad_to)
    W = tab.hw
    q_hostb = np.zeros((cap, W), np.uint8)
    q_hlen = np.zeros(cap, np.int32)
    q_has_host = np.zeros(cap, bool)
    q_urib = np.zeros((cap, tab.uw), np.uint8)
    q_ulen = np.zeros(cap, np.int32)
    q_has_uri = np.zeros(cap, bool)
    q_port = np.zeros(cap, np.int32)

    s1, s2 = int(tab.host_salts[0]), int(tab.host_salts[1])
    us1, us2 = int(tab.uri_salts[0]), int(tab.uri_salts[1])
    hmask = tab.host_cap - 1
    umask = tab.uri_cap - 1
    probes: list[list] = []  # per hint: [(plen, slot1, slot2)]
    uprobes: list[list] = []  # per hint: [(lset_pos, plen, s1, s2)]
    need = 0
    for i, h in enumerate(hints):
        pr: list = []
        if h.host is not None:
            hb = h.host.encode()[::-1]
            hl = min(len(hb), 1 << 20)
            q_hlen[i] = hl
            win = hb[:W]
            q_hostb[i, : len(win)] = np.frombuffer(win, np.uint8)
            q_has_host[i] = True
            # one python pass: rolling FNV64 pair + dot probes
            h1 = _FNV64_OFFSET_I ^ s1
            h2 = _FNV64_OFFSET_I ^ s2
            lim = min(len(hb), W - 1)
            for p in range(lim):
                by = hb[p]
                if by == DOT and 1 <= p < hl:
                    pr.append((p, h1 & hmask, h2 & hmask))
                h1 = ((h1 ^ by) * _FNV64_PRIME_I) & _FNV64_MASK
                h2 = ((h2 ^ by) * _FNV64_PRIME_I) & _FNV64_MASK
            # boundary dot at position lim (a dot can be a probe
            # position without its byte being hashed into the prefix)
            if lim < len(hb) and lim < W and hb[lim] == DOT \
                    and 1 <= lim < hl:
                pr.append((lim, h1 & hmask, h2 & hmask))
            if hl <= W - 1:  # exact slot, last (vectorized order)
                pr.append((hl, h1 & hmask, h2 & hmask))
        probes.append(pr)
        need = max(need, len(pr))
        upr: list = []
        if h.uri is not None:
            ub = h.uri.encode()
            ul = min(len(ub), 1 << 20)
            q_ulen[i] = ul
            uwin = ub[: tab.uw]
            q_urib[i, : len(uwin)] = np.frombuffer(uwin, np.uint8)
            q_has_uri[i] = True
            u1 = _FNV64_OFFSET_I ^ us1
            u2 = _FNV64_OFFSET_I ^ us2
            pos = 0
            for li, l in enumerate(tab.lset):
                if l > ul:
                    break
                while pos < l:  # lset ascending: resume the roll
                    by = uwin[pos] if pos < len(uwin) else 0
                    u1 = ((u1 ^ by) * _FNV64_PRIME_I) & _FNV64_MASK
                    u2 = ((u2 ^ by) * _FNV64_PRIME_I) & _FNV64_MASK
                    pos += 1
                upr.append((li, l, u1 & umask, u2 & umask))
        uprobes.append(upr)
        q_port[i] = h.port

    maxp = next((t for t in MAXP_TIERS if t >= need), MAXP_TIERS[-1])
    hp_len = np.full((cap, maxp), -1, np.int32)
    hp_slot1 = np.full((cap, maxp), -1, np.int32)
    hp_slot2 = np.full((cap, maxp), -1, np.int32)
    for i, pr in enumerate(probes):
        for j, (plen, sl1, sl2) in enumerate(pr[:maxp]):
            hp_len[i, j] = plen
            hp_slot1[i, j] = sl1
            hp_slot2[i, j] = sl2
    lset_cap = tab.caps["lset"]
    up_len = np.full((cap, lset_cap), -1, np.int32)
    up_slot1 = np.full((cap, lset_cap), -1, np.int32)
    up_slot2 = np.full((cap, lset_cap), -1, np.int32)
    for i, upr in enumerate(uprobes):
        for (li, l, sl1, sl2) in upr:
            up_len[i, li] = l
            up_slot1[i, li] = sl1
            up_slot2[i, li] = sl2

    return {
        "hostb": q_hostb, "hlen": q_hlen, "has_host": q_has_host,
        "urib": q_urib, "ulen": q_ulen, "has_uri": q_has_uri,
        "port": q_port,
        "hp_len": hp_len, "hp_slot1": hp_slot1, "hp_slot2": hp_slot2,
        "up_len": up_len, "up_slot1": up_slot1, "up_slot2": up_slot2,
    }


def encode_hint_queries(hints: Sequence, tab: HashHintTable,
                        pad_to: int = 0) -> dict:
    """Hints -> device-ready query dict incl. precomputed probe slots.

    Host-side work is vectorized numpy: two rolling-FNV passes over the
    reversed host window and the uri window give every suffix/prefix
    hash; probe positions are the dots (host) and the table's rule-uri
    length set (uri). Batches up to SMALL_ENCODE take the per-hint
    python path instead (same outputs, ~5x cheaper at accept-path batch
    sizes). pad_to: emit arrays at this batch bucket, pad rows being
    invalid probes (never encode padding).
    """
    if len(hints) <= SMALL_ENCODE:
        return _encode_hint_queries_small(hints, tab,
                                          max(pad_to, len(hints)))
    b = len(hints)
    W = tab.hw  # reversed-host compare window (suffix boundary incl.)
    (q_hostb, q_hlen, q_has_host, q_urib, q_ulen, q_has_uri,
     q_port) = _fill_query_windows(hints, W, tab.uw, b)

    # --- host probes: exact (p = hlen) + every dot position p (suffix).
    # Valid probe lengths p <= hw-1 (no rule host is longer), so the
    # rolling window of hw-1 bytes covers every probe, incl. a boundary
    # dot at position hw-1 (max-length rule host + '.').
    h1 = CK.rolling_fnv64(q_hostb[:, : W - 1], tab.host_salts[0])
    h2 = CK.rolling_fnv64(q_hostb[:, : W - 1], tab.host_salts[1])
    pos = np.arange(W)[None, :]
    probe_ok = np.concatenate([
        (q_hostb == DOT) & (pos < q_hlen[:, None]) & (pos >= 1),
        (q_has_host & (q_hlen <= W - 1))[:, None],  # exact slot
    ], axis=1) & q_has_host[:, None]  # [B, W+1]
    probe_len = np.concatenate([
        np.broadcast_to(pos, (b, W)),
        q_hlen[:, None],
    ], axis=1).astype(np.int32)
    need = int(probe_ok.sum(axis=1).max(initial=0))
    maxp = next((t for t in MAXP_TIERS if t >= need), MAXP_TIERS[-1])

    # compact valid probes to the left (stable argsort on ~ok)
    order = np.argsort(~probe_ok, axis=1, kind="stable")[:, :maxp]
    pv = np.take_along_axis(probe_ok, order, 1)
    pl = np.where(pv, np.take_along_axis(probe_len, order, 1), 0)
    hp_len = np.where(pv, pl, -1).astype(np.int32)
    mask = np.uint64(tab.host_cap - 1)
    hp_slot1 = np.where(pv, (np.take_along_axis(h1, pl, 1) & mask).astype(np.int32), -1)
    hp_slot2 = np.where(pv, (np.take_along_axis(h2, pl, 1) & mask).astype(np.int32), -1)

    # --- uri probes at each rule-uri length <= query len
    lset_cap = tab.caps["lset"]
    lset = np.full(lset_cap, -1, np.int32)
    lset[: len(tab.lset)] = tab.lset
    u1 = CK.rolling_fnv64(q_urib, tab.uri_salts[0])
    u2 = CK.rolling_fnv64(q_urib, tab.uri_salts[1])
    lv = (lset[None, :] >= 0) & (lset[None, :] <= q_ulen[:, None]) & \
        q_has_uri[:, None]
    ll = np.where(lv, np.maximum(lset[None, :], 0), 0)
    umask = np.uint64(tab.uri_cap - 1)
    up_len = np.where(lv, ll, -1).astype(np.int32)
    up_slot1 = np.where(lv, (np.take_along_axis(u1, ll, 1) & umask).astype(np.int32), -1)
    up_slot2 = np.where(lv, (np.take_along_axis(u2, ll, 1) & umask).astype(np.int32), -1)

    return {
        "hostb": q_hostb, "hlen": q_hlen, "has_host": q_has_host,
        "urib": q_urib, "ulen": q_ulen, "has_uri": q_has_uri, "port": q_port,
        "hp_len": hp_len, "hp_slot1": hp_slot1, "hp_slot2": hp_slot2,
        "up_len": up_len, "up_slot1": up_slot1, "up_slot2": up_slot2,
    }




# ------------------------------------------------------------ torch tier


def _probe_buckets(slots, plen, used, klen, kbytes, bs, bc, qbytes, iota):
    """Byte-verified cuckoo probe -> candidate rule indices.

    slots/plen: [B, P] (slot -1 / len -1 = invalid); table arrays used
    [C], klen [C], kbytes [C, K], bs/bc [C]; qbytes [B, K'] query window
    (K' >= K); iota [BK]. -> [B, P, BK] candidate indices (-1 = none).
    """
    k = kbytes.shape[1]
    s = slots.clamp(min=0).long()
    ok = (slots >= 0) & used[s] & (klen[s] == plen)
    kb = kbytes[s]  # [B, P, K]
    span = torch.arange(k, dtype=torch.int32, device=slots.device)
    eq = (kb == qbytes[:, None, :k]) | (span[None, None, :] >= plen[:, :, None])
    ok = ok & eq.all(dim=-1)
    start, cnt = bs[s], bc[s]
    j = iota[None, None, :]
    return torch.where(ok[:, :, None] & (j < cnt[:, :, None]),
                       start[:, :, None] + j, -1)


# largest r_cap whose (level, index) pair still packs into one i32
# (max level = (3 << HOST_SHIFT) + URI_MAX_SCORE = 4095)
_PACK_I32_MAX = (2**31 - 1) // 4096 - 1


def _reduce_best(level, c, r_cap: int):
    """(max level, min index among level-winners) -> (idx, level).
    Small tables keep the single-reduction i32 packing; past
    _PACK_I32_MAX the packed product would overflow i32, so the same
    winner comes from two reductions. Identical winners in both."""
    if r_cap <= _PACK_I32_MAX:
        pack = torch.where(level > 0, level * (r_cap + 1) + (r_cap - c), 0)
        best = pack.amax(dim=1)
        best_level = best // (r_cap + 1)
        best_idx = r_cap - best % (r_cap + 1)
        return torch.where(best > 0, best_idx, -1).to(torch.int32), \
            best_level.to(torch.int32)
    best_level = level.amax(dim=1)
    cand = torch.where((level == best_level[:, None]) & (level > 0), c,
                       r_cap)
    best_idx = cand.amin(dim=1)
    return torch.where(best_level > 0, best_idx, -1).to(torch.int32), \
        best_level.to(torch.int32)


def _items(items, ch):
    """Bucket positions -> rule indices (-1 stays -1)."""
    return torch.where(ch >= 0, items[ch.clamp(min=0).long()], -1)


def hint_hash_match(t: dict, q: dict):
    """-> (best rule idx [B] i32 or -1, best level [B] i32).

    `t`: a compiled table's arrays as tensors (utils/torchenv
    tables_from_reference); `q`: an encoded query batch as tensors on
    the same device. Candidates from host/uri probes + wildcard lists,
    scored with the full Hint.matchLevel formula from gathered rule
    records. The plain version of B3's CUDA kernel (ops/fused_cuda.py
    hint_match); `cuda_calls` counts the calls made on CUDA tensors,
    which only a comparison with the kernel makes.
    """
    if q["hostb"].is_cuda:
        hint_hash_match.cuda_calls += 1
    r_cap = t["r_active"].shape[0]
    b = q["hostb"].shape[0]

    ch1 = _probe_buckets(q["hp_slot1"], q["hp_len"], t["hk_used"], t["hk_len"],
                         t["hk_bytes"], t["hk_bs"], t["hk_bc"], q["hostb"],
                         t["bh_iota"])
    ch2 = _probe_buckets(q["hp_slot2"], q["hp_len"], t["hk_used"], t["hk_len"],
                         t["hk_bytes"], t["hk_bs"], t["hk_bc"], q["hostb"],
                         t["bh_iota"])
    cu1 = _probe_buckets(q["up_slot1"], q["up_len"], t["uk_used"], t["uk_len"],
                         t["uk_bytes"], t["uk_bs"], t["uk_bc"], q["urib"],
                         t["bu_iota"])
    cu2 = _probe_buckets(q["up_slot2"], q["up_len"], t["uk_used"], t["uk_len"],
                         t["uk_bytes"], t["uk_bs"], t["uk_bc"], q["urib"],
                         t["bu_iota"])
    cand = torch.cat([
        _items(t["hb_items"], ch1).reshape(b, -1),
        _items(t["hb_items"], ch2).reshape(b, -1),
        _items(t["ub_items"], cu1).reshape(b, -1),
        _items(t["ub_items"], cu2).reshape(b, -1),
        t["wh_idx"][None].expand(b, -1),
        t["wu_idx"][None].expand(b, -1),
    ], dim=1)  # [B, NC]

    c = cand.clamp(min=0)
    ci = c.long()
    valid = (cand >= 0) & t["r_active"][ci]

    # port gate (Hint.java: ports both set and different -> no match)
    qport = q["port"][:, None]
    rp = t["r_port"][ci]
    pg = (qport == 0) | (rp == 0) | (qport == rp)

    # host level: exact=3 / dot-suffix=2 / wildcard=1 (max of applicable)
    hw = t["r_host"].shape[1]
    hk, hl_ = t["r_host_kind"][ci], t["r_host_len"][ci]
    rb = t["r_host"][ci]  # [B, NC, hw]
    span = torch.arange(hw, dtype=torch.int32, device=cand.device)
    heq = ((rb == q["hostb"][:, None, :hw]) |
           (span[None, None, :] >= hl_[:, :, None])).all(dim=-1)
    exact = heq & (hl_ == q["hlen"][:, None])
    boundary = torch.gather(q["hostb"], 1, hl_.clamp(0, hw - 1).long())
    suffix = heq & (hl_ < q["hlen"][:, None]) & (boundary == DOT)
    host_level = torch.maximum(
        torch.maximum(torch.where(exact, 3, 0), torch.where(suffix, 2, 0)),
        torch.where(hk == 2, 1, 0))
    host_level = torch.where((hk > 0) & q["has_host"][:, None], host_level, 0)

    # uri level: exact/prefix -> min(len(rule.uri)+1, 1023), wildcard -> 1
    uw = t["r_uri"].shape[1]
    uk, ul = t["r_uri_kind"][ci], t["r_uri_len"][ci]
    ub = t["r_uri"][ci]  # [B, NC, uw]
    uspan = torch.arange(uw, dtype=torch.int32, device=cand.device)
    ueq = ((ub == q["urib"][:, None, :]) |
           (uspan[None, None, :] >= ul[:, :, None])).all(dim=-1)
    prefix = ueq & (ul <= q["ulen"][:, None])
    uri_level = torch.maximum(
        torch.where(prefix, t["r_uri_score"][ci], 0),
        torch.where(uk == 2, 1, 0))
    uri_level = torch.where((uk > 0) & q["has_uri"][:, None], uri_level, 0)

    level = (host_level << HOST_SHIFT) + uri_level
    level = torch.where(valid & pg, level, 0).to(torch.int32)
    return _reduce_best(level, c, r_cap)


hint_hash_match.cuda_calls = 0  # calls on CUDA tensors


# --------------------------------------------------------------- cidr side


def _expand_patterns(net) -> list:
    """Network -> [(key16, mask16, family)] reproducing Network.maskMatch
    (Network.java:183-278) — same cases as tables._expand_cidr."""
    ip, mask = net.ip, net.mask
    out = []

    def mk(key, m, fam):
        out.append((bytes(np.frombuffer(bytes(key), np.uint8) &
                          np.frombuffer(bytes(m), np.uint8)), bytes(m), fam))

    if len(ip) == 4:
        mk(b"\x00" * 12 + ip, b"\x00" * 12 + mask, V4)
        mk(b"\x00" * 12 + ip, b"\xff" * 12 + mask, V6)
        mk(b"\x00" * 10 + b"\xff\xff" + ip, b"\xff" * 12 + mask, V6)
    elif len(mask) == 4:
        mk(ip[:4] + b"\x00" * 12, mask + b"\x00" * 12, V6)
    else:
        mk(ip, mask, V6)
        hi_ok = all(b == 0 for b in ip[:10]) and ip[10:12] in (b"\x00\x00", b"\xff\xff")
        if hi_ok:
            mk(b"\x00" * 12 + ip[12:], b"\x00" * 12 + mask[12:], V4)
    return out


@dataclass
class HashCidrTable:
    n: int
    r_cap: int
    arrays: dict
    caps: dict = field(default_factory=dict)


def _fnv32_bytes(key: bytes, salt: int) -> int:
    return int(CK.fnv32_masked(np.frombuffer(key, np.uint8), salt))


def _prune_acl_members(items: list, acl) -> list:
    """Members share one network; drop j when an earlier member's port
    range contains j's (the earlier one is always the first match).
    A copy of `vproxy_tpu/ops/fphash.py` `_prune_acl_members`; the
    port's fingerprint backend imports it from here."""
    keep = []
    for j in sorted(items):
        if not any(acl[i].min_port <= acl[j].min_port and
                   acl[i].max_port >= acl[j].max_port for i in keep):
            keep.append(j)
    return keep


def compile_cidr_hash(networks: Sequence, acl: Optional[Sequence[AclRule]] = None,
                      caps: Optional[dict] = None) -> HashCidrTable:
    """Networks (+ the ACL's port ranges) -> per-(family, mask) cuckoo
    tables over the masked 16-byte keys, every group in one slot array
    (`g_off` is a group's first slot). `caps` from an earlier compile
    keeps every shape that still fits; a larger table grows them."""
    caps = dict(caps or {})
    n = len(networks)
    r_cap = caps.get("r_cap") or _pad_cap(n, 256)
    if n > r_cap:
        r_cap = _pad_cap(n, 256)

    groups: dict[tuple, dict[bytes, list[int]]] = {}
    for i, net in enumerate(networks):
        if not (i & 31):
            CK.coop_yield()
        for key, mask, fam in _expand_patterns(net):
            groups.setdefault((fam, mask), {}).setdefault(key, []).append(i)

    g_live = sorted(groups.keys())
    g_cap = max(caps.get("g_cap", 0), _pow2(max(len(g_live), 1), 8))
    if len(g_live) > g_cap:
        g_cap = _pow2(len(g_live), 8)

    g_fam = np.full(g_cap, -1, np.int32)
    g_mask = np.zeros((g_cap, 16), np.uint8)
    g_off = np.zeros(g_cap, np.int32)
    g_capmask = np.zeros(g_cap, np.int32)
    g_salt1 = np.zeros(g_cap, np.uint32)
    g_salt2 = np.zeros(g_cap, np.uint32)

    tabs = []
    flat_items: list[int] = []
    off = 0
    bk = caps.get("bk", 1)
    for gi, (fam, mask) in enumerate(g_live):
        t, items = CK.build_cuckoo(groups[(fam, mask)], 16,
                                   hasher=_fnv32_bytes, salt_base=3 + gi)
        g_fam[gi] = fam
        g_mask[gi] = np.frombuffer(mask, np.uint8)
        g_off[gi] = off
        g_capmask[gi] = t.cap - 1
        g_salt1[gi] = t.salt1
        g_salt2[gi] = t.salt2
        t.bucket_start += len(flat_items)
        flat_items.extend(items.tolist())
        bk = max(bk, _pow2(int(t.bucket_count.max(initial=1))))
        tabs.append(t)
        off += t.cap

    ct = max(caps.get("ct", 0), _pow2(max(off, 1), 256))
    s_used = np.zeros(ct, bool)
    s_key = np.zeros((ct, 16), np.uint8)
    s_bs = np.zeros(ct, np.int32)
    s_bc = np.zeros(ct, np.int32)
    o = 0
    for t in tabs:
        s_used[o: o + t.cap] = t.used
        s_key[o: o + t.cap] = t.key_bytes
        s_bs[o: o + t.cap] = t.bucket_start
        s_bc[o: o + t.cap] = np.minimum(t.bucket_count, bk)
        o += t.cap

    cb = max(caps.get("cb", 0), _pow2(max(len(flat_items), 1), 256))
    cb_items = np.full(cb, -1, np.int32)
    cb_items[: len(flat_items)] = flat_items

    r_valid = np.zeros(r_cap, bool)
    r_valid[:n] = True
    min_port = np.zeros(r_cap, np.int32)
    max_port = np.full(r_cap, 65535, np.int32)
    allow = np.zeros(r_cap, bool)
    if acl is not None:
        for i, r in enumerate(acl):
            min_port[i], max_port[i], allow[i] = r.min_port, r.max_port, r.allow

    arrays = {
        "g_fam": g_fam, "g_mask": g_mask, "g_off": g_off,
        "g_capmask": g_capmask, "g_salt1": g_salt1, "g_salt2": g_salt2,
        "s_used": s_used, "s_key": s_key, "s_bs": s_bs, "s_bc": s_bc,
        "cb_items": cb_items, "r_valid": r_valid,
        "min_port": min_port, "max_port": max_port, "allow": allow,
        "bk_iota": np.arange(bk, dtype=np.int32),
    }
    return HashCidrTable(n=n, r_cap=r_cap, arrays=arrays,
                         caps={"r_cap": r_cap, "g_cap": g_cap, "ct": ct,
                               "cb": cb, "bk": bk})


_M32 = 0xFFFFFFFF


def _fnv32_device(masked, salt):
    """masked [B, G, 16] u8, salt [G] u32 -> [B, G] int64 holding the
    u32 hash; bit-identical to cuckoo.fnv32_masked. The u32 wraparound
    multiply runs in int64 (a u32 times the 24-bit prime fits) and is
    masked back to 32 bits each round."""
    h = (int(CK.FNV32_OFFSET) ^ salt.to(torch.int64))[None, :].expand(
        masked.shape[:2])
    prime = int(CK.FNV32_PRIME)
    m = masked.to(torch.int64)
    for p in range(16):
        h = ((h ^ m[:, :, p]) * prime) & _M32
    return h


def _u32_as_i32(h):
    """The int32 a u32 value (held in int64) reinterprets as."""
    return torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)


def _cidr_slots(t: dict, addr16, fam):
    """Per (query, group, salt): the slot a masked address probes and
    whether the group applies. -> (masked [B, G, 16], gok [B, G],
    [slot [B, G] per salt])."""
    masked = addr16[:, None, :] & t["g_mask"][None]  # [B, G, 16]
    gok = (t["g_fam"][None] >= 0) & (fam[:, None] == t["g_fam"][None])
    slots = [t["g_off"][None] + (_u32_as_i32(_fnv32_device(masked, salt))
                                 & t["g_capmask"][None])
             for salt in (t["g_salt1"], t["g_salt2"])]
    return masked, gok, slots


def _first_valid(cand, valid, r_cap: int):
    """min rule index among the valid candidates, -1 for none."""
    first = torch.where(valid, cand.clamp(min=0), r_cap).amin(dim=1)
    return torch.where(first < r_cap, first, -1).to(torch.int32)


def cidr_hash_match(t: dict, addr16, fam, port=None):
    """-> first-matching rule index [B] i32 (ordered-scan semantics), -1
    if none. addr16 [B,16] u8, fam [B] i32, port [B] i32 (ACL only).
    The plain tier: CPU tensors; ops/cidr_cuda.py is the CUDA entry."""
    r_cap = t["r_valid"].shape[0]
    b = addr16.shape[0]
    ct, cb = t["s_used"].shape[0], t["cb_items"].shape[0]
    masked, gok, slots = _cidr_slots(t, addr16, fam)
    cands = []
    for slot in slots:
        s = slot.clamp(0, ct - 1).long()
        key = t["s_key"][s]  # [B, G, 16]
        ok = gok & t["s_used"][s] & (key == masked).all(dim=-1)
        start, cnt = t["s_bs"][s], t["s_bc"][s]
        j = t["bk_iota"][None, None, :]
        cands.append(torch.where(ok[:, :, None] & (j < cnt[:, :, None]),
                                 start[:, :, None] + j, -1))
    slot_cand = torch.cat(cands, dim=1).reshape(b, -1)
    cand = torch.where(slot_cand >= 0,
                       t["cb_items"][slot_cand.clamp(0, cb - 1).long()], -1)
    c = cand.clamp(0, r_cap - 1).long()
    valid = (cand >= 0) & t["r_valid"][c]
    if port is not None:
        valid = valid & (t["min_port"][c] <= port[:, None]) & \
            (port[:, None] <= t["max_port"][c])
    return _first_valid(cand, valid, r_cap)


def classify_hash_all(hint_t: dict, route_t: dict, acl_t: dict,
                      hint_q: dict, addr16, fam, port):
    """One call classifies a micro-batch of hints + route LPM + ACL
    checks -> one packed [B, 3] i32 result (hint, route, acl)."""
    h_idx, _ = hint_hash_match(hint_t, hint_q)
    r_idx = cidr_hash_match(route_t, addr16, fam, None)
    a_idx = cidr_hash_match(acl_t, addr16, fam, port)
    return torch.stack([h_idx, r_idx, a_idx], dim=1)


# ----------------------------------------------------- mesh-sharded path
#
# Rule-axis sharding for the hash path (the reference's sharded half,
# copied): the rule list is split into S contiguous slices, each
# compiled into its OWN cuckoo table (hash probing is slot-local, so
# sharding the compiled arrays directly would turn every probe into a
# cross-shard gather). All shards share one unified `caps` dict, so the
# per-shard arrays have identical shapes and stack along a leading
# shard axis (parallel/mesh.py puts each shard slot's slice on its
# device). Each shard runs the unchanged single-shard matcher; the
# global winner is the highest level, then the least global index among
# the level winners (Upstream.java:187's strictly-greater-max +
# earliest-index-tie semantics), which B8 (ops/sharded_cuda.py) decides
# in one launch over all of a process's shards.


@dataclass
class ShardedHashTable:
    """S per-shard tables with unified shapes, stacked for the mesh."""

    shards: list  # per-shard HashHintTable | HashCidrTable
    arrays: dict  # stacked [S, ...] numpy arrays
    shard_size: int  # rules per shard (global idx = shard * size + local)
    n: int
    r_cap: int  # per-shard capacity
    # hint tables only (compile_hint_hash_sharded): the sorted union of
    # the shards' rule-uri length sets, precomputed so the single-pass
    # encoder does no per-dispatch set algebra; None for cidr/foreign
    # stabs (the encoder falls back to the legacy per-shard path)
    lset_u: Optional[list] = None


def _unify_caps(tabs_caps: list) -> dict:
    out: dict = {}
    for c in tabs_caps:
        for k, v in c.items():
            out[k] = max(out.get(k, 0), v)
    return out


def _compile_sharded(items: Sequence, n_shards: int, compile_one,
                     caps: Optional[dict]) -> ShardedHashTable:
    """compile_one(slice, item_offset, caps) -> per-shard table; the
    offset is the slice's start index in `items`, so positional side
    tables (ACL windows) stay aligned with the slicing by construction.
    When caps is supplied (the runtime-update fast path), the result
    MUST fit: growth raises CapsExceeded instead of silently changing
    shapes and retracing the caller's jitted classify.

    Memory-lean: once the per-shard arrays are stacked, the per-shard
    copies are dropped (the shard objects stay — encoders read their
    salts/caps/lset, never the arrays). A 1M-rule table would otherwise
    sit in host RAM twice before it ever reaches the device."""
    reused = dict(caps) if caps else None
    per = max(1, -(-len(items) // n_shards))  # ceil; empty tail shards ok
    slices = [list(items[d * per: (d + 1) * per]) for d in range(n_shards)]
    caps = dict(caps or {})
    for _ in range(6):  # caps only grow; fixed point in a few rounds
        tabs = []
        for d, s in enumerate(slices):
            tabs.append(compile_one(s, d * per, caps))
            CK.coop_yield()  # standby-compile courtesy: explicit
            #                  preemption point between shard builds
        merged = _unify_caps([t.caps for t in tabs])
        if all(t.caps == merged for t in tabs):
            if reused is not None and merged != reused:
                raise CapsExceeded(
                    f"update outgrew reused caps: {reused} -> {merged}")
            arrays = {}
            for k in tabs[0].arrays:
                CK.coop_yield()  # stack chunks are multi-MB memcpys:
                #                  paced per key like the build loops
                arrays[k] = np.stack([t.arrays[k] for t in tabs])
            for t in tabs:
                t.arrays = {}
            return ShardedHashTable(shards=tabs, arrays=arrays,
                                    shard_size=per, n=len(items),
                                    r_cap=tabs[0].r_cap)
        caps = merged
    raise RuntimeError("sharded table caps did not converge")


def compile_hint_hash_sharded(rules: Sequence[HintRule], n_shards: int,
                              caps: Optional[dict] = None) -> ShardedHashTable:
    """Per-shard compiles under unified caps, plus the UNION uri-length
    cap ("lset_u") the single-pass sharded encoder sizes its probe axis
    by: a caps-stable width, so same-caps rule updates keep one query
    trace shape (the no-retrace contract) — an update whose uri-length
    union outgrows it raises CapsExceeded like any other caps growth
    (the engine transparently rebuilds + retraces once)."""
    reused_u = (caps or {}).get("lset_u")
    inner = dict(caps) if caps else None
    if inner is not None:
        inner.pop("lset_u", None)  # per-shard compiles don't know it
    stab = _compile_sharded(
        rules, n_shards,
        lambda s, off, caps: compile_hint_hash(s, caps=caps), inner)
    union = set()
    for t in stab.shards:
        union.update(t.lset)
    u_cap = _pow2(max(len(union), 1), 4)
    if reused_u:
        if u_cap > reused_u:
            raise CapsExceeded(
                f"uri-length union outgrew reused cap: {reused_u} -> "
                f"{u_cap}")
        u_cap = reused_u
    for t in stab.shards:
        t.caps["lset_u"] = u_cap
    stab.lset_u = sorted(union)
    return stab


def compile_cidr_hash_sharded(networks: Sequence, n_shards: int,
                              acl: Optional[Sequence[AclRule]] = None,
                              caps: Optional[dict] = None) -> ShardedHashTable:
    # each shard's ACL window follows its rule slice positionally (the
    # offset comes FROM the slicer, so they cannot drift apart)
    return _compile_sharded(
        networks, n_shards,
        lambda s, off, caps: compile_cidr_hash(
            s, acl=None if acl is None else acl[off: off + len(s)],
            caps=caps), caps)


def encode_hint_queries_sharded(hints: Sequence, stab: ShardedHashTable,
                                pad_to: Optional[int] = None) -> dict:
    """Per-shard probe encoding stacked on the leading shard axis.

    Probe slots/salts are shard-local, so the same hint batch encodes
    differently per shard — but only in the HASH VALUES: the unified
    caps guarantee every shard shares the compare windows and table
    capacities, and the probe POSITIONS (dots, uri lengths) depend only
    on query content. So this runs the byte walk and the rolling-FNV
    pass ONCE for all shards (rolling_fnv64_multi over the salt
    vector), instead of the S sequential re-encodes the original path
    paid — measured 8x of the whole dispatch's host cost at S=8.

    uri probes ride the UNION of the shards' rule-uri length sets: a
    probe at a length some shard lacks byte-verifies off (no key of
    that length exists there), so correctness is per-shard exact while
    the probe arrays stay shard-uniform.

    pad_to: encode the real hints only and zero/-1-fill the probe rows
    up to the batch bucket (a pad row has no probes and can never
    match). Each device still receives only its own slice (the stacked
    dims are sharded (rules, batch) on the mesh)."""
    shards = stab.shards
    t0 = shards[0]
    # compile_hint_hash_sharded guarantees unified shard shapes and
    # precomputes the uri-length union; a foreign-built stab (no
    # lset_u) pays the uniformity scan once per dispatch or drops to
    # the legacy per-shard encode
    if stab.lset_u is None and not all(
            t.hw == t0.hw and t.uw == t0.uw
            and t.host_cap == t0.host_cap and t.uri_cap == t0.uri_cap
            for t in shards):
        # non-unified shard shapes (foreign-built stab): legacy path
        if pad_to and pad_to > len(hints):
            from ..rules.ir import Hint
            hints = list(hints) + [Hint()] * (pad_to - len(hints))
        per = [encode_hint_queries(hints, t) for t in shards]
        return {k: np.stack([p[k] for p in per]) for k in per[0]}

    S = len(shards)
    b = len(hints)
    cap = max(b, pad_to or 0)
    W = t0.hw
    (q_hostb, q_hlen, q_has_host, q_urib, q_ulen, q_has_uri,
     q_port) = _fill_query_windows(hints, W, t0.uw, cap)

    def shared(a: np.ndarray) -> np.ndarray:
        # shard-invariant keys: a zero-stride broadcast view on the
        # shard axis (device_put materializes each device's slice)
        return np.broadcast_to(a, (S,) + a.shape)

    # --- host probes (positions shared; slots per shard salt)
    h1 = CK.rolling_fnv64_multi(
        q_hostb[:, : W - 1],
        [t.host_salts[0] for t in shards])  # [S, cap, W]
    h2 = CK.rolling_fnv64_multi(
        q_hostb[:, : W - 1], [t.host_salts[1] for t in shards])
    pos = np.arange(W)[None, :]
    probe_ok = np.concatenate([
        (q_hostb == DOT) & (pos < q_hlen[:, None]) & (pos >= 1),
        (q_has_host & (q_hlen <= W - 1))[:, None],  # exact slot
    ], axis=1) & q_has_host[:, None]  # [cap, W+1]
    probe_len = np.concatenate([
        np.broadcast_to(pos, (cap, W)), q_hlen[:, None],
    ], axis=1).astype(np.int32)
    need = int(probe_ok.sum(axis=1).max(initial=0))
    maxp = next((t for t in MAXP_TIERS if t >= need), MAXP_TIERS[-1])
    order = np.argsort(~probe_ok, axis=1, kind="stable")[:, :maxp]
    pv = np.take_along_axis(probe_ok, order, 1)
    pl = np.where(pv, np.take_along_axis(probe_len, order, 1), 0)
    hp_len = np.where(pv, pl, -1).astype(np.int32)  # [cap, P] shared
    mask = np.uint64(t0.host_cap - 1)
    pl_s = np.broadcast_to(pl, (S,) + pl.shape)
    hp_slot1 = np.where(pv[None],
                        (np.take_along_axis(h1, pl_s, 2) & mask)
                        .astype(np.int32), -1)
    hp_slot2 = np.where(pv[None],
                        (np.take_along_axis(h2, pl_s, 2) & mask)
                        .astype(np.int32), -1)

    # --- uri probes at the UNION of the shards' rule-uri length sets;
    # width = the caps-stable "lset_u" cap (compile_hint_hash_sharded)
    # so caps-reusing updates keep ONE query trace shape
    lset_u = stab.lset_u if stab.lset_u is not None else sorted(
        set().union(*[set(t.lset) for t in shards]))
    lw = t0.caps.get("lset_u") or _pow2(max(len(lset_u), 1), 4)
    lset = np.full(lw, -1, np.int32)
    lset[: len(lset_u)] = lset_u
    u1 = CK.rolling_fnv64_multi(q_urib,
                                [t.uri_salts[0] for t in shards])
    u2 = CK.rolling_fnv64_multi(q_urib,
                                [t.uri_salts[1] for t in shards])
    lv = (lset[None, :] >= 0) & (lset[None, :] <= q_ulen[:, None]) & \
        q_has_uri[:, None]  # [cap, lw]
    ll = np.where(lv, np.maximum(lset[None, :], 0), 0)
    umask = np.uint64(t0.uri_cap - 1)
    up_len = np.where(lv, ll, -1).astype(np.int32)  # shared
    ll_s = np.broadcast_to(ll, (S,) + ll.shape)
    up_slot1 = np.where(lv[None],
                        (np.take_along_axis(u1, ll_s, 2) & umask)
                        .astype(np.int32), -1)
    up_slot2 = np.where(lv[None],
                        (np.take_along_axis(u2, ll_s, 2) & umask)
                        .astype(np.int32), -1)

    return {
        "hostb": shared(q_hostb), "hlen": shared(q_hlen),
        "has_host": shared(q_has_host),
        "urib": shared(q_urib), "ulen": shared(q_ulen),
        "has_uri": shared(q_has_uri), "port": shared(q_port),
        "hp_len": shared(hp_len), "hp_slot1": hp_slot1,
        "hp_slot2": hp_slot2,
        "up_len": shared(up_len), "up_slot1": up_slot1,
        "up_slot2": up_slot2,
    }
