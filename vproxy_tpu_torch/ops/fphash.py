"""Packed-fingerprint classify: host compilers plus the plain torch tier.

The port of `vproxy_tpu/ops/fphash.py`, the fingerprint-verified
single-probe backend (engine backend "torch-fp", the reference's
"jax-fp"): one wide slot row per probe, verified by a 64-bit fingerprint
pair instead of a byte compare, so a query touches ~1 row per probe
where the cuckoo path (ops/hashmatch.py) touches dozens. Same semantics
as the cuckoo path (Upstream.searchForGroup Upstream.java:187-198,
Hint.matchLevel Hint.java:92-160, RouteTable.lookup RouteTable.java:44,
SecurityGroup.allow SecurityGroup.java:30-45): exact for every key in
the table; a query key NOT in the table can false-positive with
probability 2^-64 per probe (the build rejects co-slotted keys that
share a fingerprint pair, and the (0, 0) pair that marks empty entries).

* **Host half (numpy):** `compile_hint_fp` / `encode_hint_queries_fp`
  (hint tables and their probe encodings) and `compile_cidr_fp` (per
  (family, mask) group tables, plus a 16/8/8 direct-index trie over the
  V4-family patterns), copies of the reference's that produce
  byte-identical arrays and caps (tests/test_torch_fphash.py).
* **Plain torch tier:** `hint_fp_match` (B6), `cidr_fp_match` (B7) and
  `classify_fp_all` — the CPU tier and the yardstick of the CUDA kernels
  (ops/fphash_cuda.py, which serves CUDA tensors). u32 hash arithmetic
  runs in int64 with every product masked back to 32 bits (`_mul32`:
  a u32 times a 32-bit constant would overflow int64).

* **Sharded half (numpy):** `compile_hint_fp_sharded`,
  `compile_cidr_fp_sharded` and `encode_hint_queries_fp_sharded`, the
  reference's, for the "torch-fp-sharded" backend.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..rules.ir import AclRule, HintRule
from . import cuckoo as CK
from .hashmatch import (MAXP_TIERS, CapsExceeded, _expand_patterns, _pow2,
                        _prune_acl_members, _prune_list, _u32_as_i32)
from .tables import MAX_HOST, MAX_URI, V4, _pad_cap

HOST_SHIFT = 10
URI_MAX_SCORE = 1023
DOT = ord(".")
LSET_MAX = 128  # lset index packs into 7 meta bits


def _fmix32_np(h: np.ndarray) -> np.ndarray:
    """murmur3 finalizer: FNV-1a's final multiply leaves the low bits a
    pure function of the tail byte's low bits (no avalanche), which
    collapses `hash & (cap-1)` slot spreading for structured keys —
    E=30 slot pileups on the bench ACL table (the reference's note).
    Must stay bit-identical to _fmix32_dev and the CUDA kernels'."""
    h = np.asarray(h, np.uint32)
    with np.errstate(over="ignore"):
        h = h ^ (h >> 16)
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> 13)
        h = h * np.uint32(0xC2B2AE35)
        h = h ^ (h >> 16)
    return h


def rolling_fnv32(qbytes: np.ndarray, salt: int) -> np.ndarray:
    """uint8 [B, L] -> uint32 [B, L+1]; column p = fmix32(fnv32 of the
    row prefix [:p])."""
    b, l = qbytes.shape
    out = np.empty((b, l + 1), dtype=np.uint32)
    h = np.full(b, CK.FNV32_OFFSET ^ np.uint32(salt), dtype=np.uint32)
    out[:, 0] = h
    with np.errstate(over="ignore"):
        for p in range(l):
            h = (h ^ qbytes[:, p].astype(np.uint32)) * CK.FNV32_PRIME
            out[:, p + 1] = h
    return _fmix32_np(out)


_M32 = 0xFFFFFFFF
_FNV32_OFFSET_I = int(CK.FNV32_OFFSET)
_FNV32_PRIME_I = int(CK.FNV32_PRIME)


def _fmix32_i(h: int) -> int:
    """_fmix32_np on a python int — bit-identical mod 2^32."""
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def fnv32_bytes(key: bytes, salt: int) -> int:
    """Python-int FNV-32+fmix (bit-identical to the numpy form, ~10x
    less GIL hold — this is the standby-install build hot loop)."""
    h = (_FNV32_OFFSET_I ^ int(salt)) & _M32
    for by in key:
        h = ((h ^ by) * _FNV32_PRIME_I) & _M32
    return _fmix32_i(h)


def fnv32_words_np(words: np.ndarray, salt) -> np.ndarray:
    """uint32 [..., 4] -> uint32 [...]; fmix32(FNV-32) over LE-packed
    u32 words (4 rounds instead of 16 byte rounds — cheaper on device)."""
    h = np.full(words.shape[:-1], 0, np.uint32)
    h[...] = CK.FNV32_OFFSET ^ np.uint32(salt)
    with np.errstate(over="ignore"):
        for p in range(4):
            h = (h ^ words[..., p]) * CK.FNV32_PRIME
    return _fmix32_np(h)



def _pack_words16(b16: np.ndarray) -> np.ndarray:
    """uint8 [..., 16] -> uint32 [..., 4] little-endian."""
    w = b16.astype(np.uint32).reshape(b16.shape[:-1] + (4, 4))
    return w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) | (w[..., 3] << 24)



def _i32(u) -> np.ndarray:
    """uint32 bits viewed as int32 (device tables are all-i32)."""
    return np.asarray(u, np.uint32).view(np.int32)


class FpBuildError(Exception):
    pass


def _place_fp(keys: Sequence[bytes], hasher, cap: int, salt_base: int,
              max_attempts: int = 16):
    """Place keys into cap slots (single probe); returns (salts, slot[],
    fp1[], fp2[], per-slot entry lists). Re-salts until no two co-slotted
    distinct keys share a fingerprint pair and no pair is (0, 0)."""
    for attempt in range(max_attempts):
        s_slot = 0x9E3779B1 ^ (salt_base * 2654435761 + attempt * 40503) & 0x7FFFFFFF
        s_fp1 = (s_slot * 3 + 0x85EBCA6B) & 0x7FFFFFFF
        s_fp2 = (s_slot * 7 + 0xC2B2AE35) & 0x7FFFFFFF
        slots = {}
        ok = True
        for ki, k in enumerate(keys):
            if not (ki & 7):
                CK.coop_yield()  # cooperative: see cuckoo._try_build
            sl = hasher(k, s_slot) & (cap - 1)
            f1, f2 = hasher(k, s_fp1), hasher(k, s_fp2)
            if f1 == 0 and f2 == 0:
                ok = False
                break
            ent = slots.setdefault(sl, [])
            if any(ef1 == f1 and ef2 == f2 for _, ef1, ef2 in ent):
                ok = False
                break
            ent.append((k, f1, f2))
        if ok:
            return (s_slot, s_fp1, s_fp2), slots
    raise FpBuildError(f"fingerprint salting failed after {max_attempts}")


# --------------------------------------------------------------- hint side


@dataclass
class FpHintTable:
    """Compiled packed hint table. `caps` carries every static dimension
    for shape-stable rebuilds (sharding / runtime updates)."""

    n: int
    r_cap: int
    arrays: dict
    host_cap: int
    host_salts: tuple  # (slot, fp1, fp2) — fp salts shared with q_hmeta
    uri_cap: int
    uri_salts: tuple   # (slot, fp1, fp2) — fp salts shared with up_fp
    lset: list
    hw: int
    uw: int
    caps: dict = field(default_factory=dict)



def _host_member(r: HintRule, idx: int, lset_pos: dict,
                 usalts: tuple) -> list:
    """Member record for host-bucket / wh entries: the rule's URI side.
    meta = port | uri_kind<<16 | lset_idx<<18. A "*" uri keeps its
    content fingerprint too: a literal query uri "*" (or "*x...")
    content-matches at score len+1, above the wildcard level 1."""
    if r.uri is None:
        kind, lidx, f1, f2 = 0, 0, 0, 0
    else:
        ub = r.uri.encode()
        kind = 2 if r.uri == "*" else 1
        lidx = lset_pos[len(ub)]
        f1, f2 = fnv32_bytes(ub, usalts[1]), fnv32_bytes(ub, usalts[2])
    meta = (r.port & 0xFFFF) | (kind << 16) | (lidx << 18)
    return [meta, idx, int(_i32(f1)), int(_i32(f2))]


def _uri_member(r: HintRule, idx: int, hsalts: tuple) -> list:
    """Member record for uri-bucket / wu entries: the rule's HOST side.
    meta = port | host_kind<<16 | host_len<<18. Host fingerprints are
    over the REVERSED host bytes so they equal the query's rolling
    fingerprint at position host_len; a "*" host keeps its content
    fingerprint (literal "*" / ".*"-suffix queries score 3/2)."""
    if r.host is None:
        kind, hlen, f1, f2 = 0, 0, 0, 0
    else:
        hb = r.host.encode()[::-1]
        kind = 2 if r.host == "*" else 1
        hlen = len(hb)
        f1, f2 = fnv32_bytes(hb, hsalts[1]), fnv32_bytes(hb, hsalts[2])
    meta = (r.port & 0xFFFF) | (kind << 16) | (hlen << 18)
    return [meta, idx, int(_i32(f1)), int(_i32(f2))]


def _fill_rec(cap: int, e: int, m: int, slots: dict, buckets: dict,
              member_of) -> np.ndarray:
    """rec [cap, e*(2+4m)] i32: per entry [fp1, fp2, m*(meta,idx,f1,f2)];
    empty entries keep fp (0,0); unused member slots keep idx -1."""
    ew = 2 + 4 * m
    rec = np.zeros((cap, e * ew), np.int32)
    for j in range(e):
        rec[:, j * ew + 3::4][:, :m] = -1  # idx lanes
    for sl, ents in slots.items():
        for j, (key, f1, f2) in enumerate(ents):
            base = j * ew
            rec[sl, base] = _i32(f1)
            rec[sl, base + 1] = _i32(f2)
            for mi, ridx in enumerate(buckets[key]):
                rec[sl, base + 2 + 4 * mi: base + 6 + 4 * mi] = \
                    member_of(ridx)
    return rec


def compile_hint_fp(rules: Sequence[HintRule],
                    caps: Optional[dict] = None,
                    strict: bool = True) -> FpHintTable:
    """strict=True (engine runtime updates): outgrowing supplied caps
    raises CapsExceeded. strict=False (sharded cap unification): caps
    grow silently toward the fixed point."""
    caps = dict(caps or {})
    n = len(rules)
    r_cap = caps.get("r_cap") or _pad_cap(n, 256)
    if n > r_cap:
        r_cap = _pad_cap(n, 256)
    assert 4095 * (r_cap + 1) + r_cap < 2**31, "table too large for i32 packing"

    host_buckets: dict[bytes, list[int]] = {}
    uri_buckets: dict[bytes, list[int]] = {}
    wh: list[int] = []
    wu: list[int] = []
    max_hl = max_ul = 0
    for i, r in enumerate(rules):
        if r.is_empty():
            continue
        if r.host is not None:
            hb = r.host.encode()
            if len(hb) > MAX_HOST:
                raise ValueError(f"host rule longer than {MAX_HOST}: {r.host!r}")
            max_hl = max(max_hl, len(hb))
            host_buckets.setdefault(hb[::-1], []).append(i)
            if r.host == "*":
                wh.append(i)
        if r.uri is not None:
            ub = r.uri.encode()
            if len(ub) > MAX_URI:
                raise ValueError(f"uri rule longer than {MAX_URI}: {r.uri!r}")
            max_ul = max(max_ul, len(ub))
            uri_buckets.setdefault(ub, []).append(i)
            if r.uri == "*":
                wu.append(i)

    hw = min(MAX_HOST + 1, max(caps.get("hw", 0), _pow2(max_hl + 1, 8)))
    uw = min(MAX_URI, max(caps.get("uw", 0), _pow2(max(max_ul, 1), 8)))

    # pruning: identical exactness arguments as ops/hashmatch.py:166-181
    for k in host_buckets:
        host_buckets[k] = _prune_list(rules, host_buckets[k],
                                      lambda r: (r.uri, r.port))
    for k in uri_buckets:
        uri_buckets[k] = _prune_list(rules, uri_buckets[k], lambda r: r.port)
    wh = _prune_list(rules, wh, lambda r: (r.uri, r.port))
    wu = _prune_list(rules, wu, lambda r: r.port)

    # lset covers "*" too: wildcard-uri CONTENT matches ride the probes
    lset = sorted({len(r.uri.encode()) for r in rules
                   if r.uri is not None and not r.is_empty()})
    if len(lset) > LSET_MAX:
        raise FpBuildError(f"more than {LSET_MAX} distinct uri lengths")
    lset_cap = max(caps.get("lset", 0), _pow2(max(len(lset), 1), 4))
    if len(lset) > lset_cap:
        lset_cap = _pow2(len(lset), 4)
    lset_pos = {l: j for j, l in enumerate(lset)}

    def table_for(buckets, salt_base, cap_key, e_key, m_key):
        cap = max(caps.get(cap_key, 0), _pow2(2 * max(len(buckets), 1), 16))
        if len(buckets) > cap:  # keep load factor <= 0.5 when reused
            cap = _pow2(2 * len(buckets), 16)
        salts, slots = _place_fp(list(buckets.keys()), fnv32_bytes, cap,
                                 salt_base)
        e_need = max((len(v) for v in slots.values()), default=1)
        m_need = max((len(v) for v in buckets.values()), default=1)
        e = max(caps.get(e_key, 0), e_need)
        m = max(caps.get(m_key, 0), m_need)
        return cap, salts, slots, e, m

    host_cap, hsalts, hslots, hE, hM = table_for(
        host_buckets, 11, "host_cap", "hE", "hM")
    uri_cap, usalts, uslots, uE, uM = table_for(
        uri_buckets, 23, "uri_cap", "uE", "uM")

    host_rec = _fill_rec(host_cap, hE, hM, hslots, host_buckets,
                         lambda i: _host_member(rules[i], i, lset_pos, usalts))
    uri_rec = _fill_rec(uri_cap, uE, uM, uslots, uri_buckets,
                        lambda i: _uri_member(rules[i], i, hsalts))
    # ONE combined slot table: uri slots live at host_cap + slot (the
    # encoder applies the offset), so the kernel fetches all host+uri
    # probe rows in a single gather instead of two
    rw = max(host_rec.shape[1], uri_rec.shape[1])
    rec = np.zeros((host_cap + uri_cap, rw), np.int32)
    rec[:host_cap, : host_rec.shape[1]] = host_rec
    rec[host_cap:, : uri_rec.shape[1]] = uri_rec

    whc = max(caps.get("whc", 0), _pow2(max(len(wh), 1), 2))
    wuc = max(caps.get("wuc", 0), _pow2(max(len(wu), 1), 2))
    wh_rec = np.zeros((whc, 4), np.int32)
    wh_rec[:, 1] = -1
    for j, i in enumerate(wh):
        wh_rec[j] = _host_member(rules[i], i, lset_pos, usalts)
    wu_rec = np.zeros((wuc, 4), np.int32)
    wu_rec[:, 1] = -1
    for j, i in enumerate(wu):
        wu_rec[j] = _uri_member(rules[i], i, hsalts)

    lset_arr = np.full(lset_cap, -1, np.int32)
    lset_arr[: len(lset)] = lset

    arrays = {
        "rec": rec,
        "wh_rec": wh_rec, "wu_rec": wu_rec,
        "lset": lset_arr,
        "rcap_iota": np.zeros(r_cap, np.int32),
        "h_em": np.zeros((hE, hM), np.int32),   # shape carriers
        "u_em": np.zeros((uE, uM), np.int32),
    }
    new_caps = {"r_cap": r_cap, "host_cap": host_cap, "uri_cap": uri_cap,
                "hE": hE, "hM": hM, "uE": uE, "uM": uM,
                "whc": whc, "wuc": wuc, "lset": lset_cap,
                "hw": hw, "uw": uw}
    if strict and caps and any(caps.get(k, 0) and new_caps[k] > caps[k]
                               for k in new_caps):
        raise CapsExceeded(f"update outgrew reused caps: {caps} -> {new_caps}")
    return FpHintTable(
        n=n, r_cap=r_cap, arrays=arrays,
        host_cap=host_cap, host_salts=hsalts,
        uri_cap=uri_cap, uri_salts=usalts,
        lset=lset, hw=hw, uw=uw, caps=new_caps)


def encode_hint_queries_fp(hints: Sequence, tab: FpHintTable) -> dict:
    """Hints -> device-ready probe arrays. All hashing is host-side
    numpy rolling FNV-32 (three salts per table: slot + fingerprint
    pair); the kernel never touches query BYTES, only fingerprints."""
    b = len(hints)
    W = tab.hw
    q_hostb = np.zeros((b, W), np.uint8)
    q_hlen = np.zeros(b, np.int32)
    q_has_host = np.zeros(b, bool)
    q_urib = np.zeros((b, tab.uw), np.uint8)
    q_ulen = np.zeros(b, np.int32)
    q_has_uri = np.zeros(b, bool)
    q_port = np.zeros(b, np.int32)
    for i, h in enumerate(hints):
        if h.host is not None:
            hb = h.host.encode()[::-1]
            q_hlen[i] = min(len(hb), 1 << 20)
            q_hostb[i, : min(len(hb), W)] = np.frombuffer(hb[:W], np.uint8)
            q_has_host[i] = True
        if h.uri is not None:
            ub = h.uri.encode()
            q_ulen[i] = min(len(ub), 1 << 20)
            q_urib[i, : min(len(ub), tab.uw)] = np.frombuffer(
                ub[: tab.uw], np.uint8)
            q_has_uri[i] = True
        q_port[i] = h.port

    hs = [rolling_fnv32(q_hostb[:, : W - 1], s) for s in tab.host_salts]
    pos = np.arange(W)[None, :]
    # probes: every dot position (suffix rules) + the exact-length slot
    probe_ok = np.concatenate([
        (q_hostb == DOT) & (pos < q_hlen[:, None]) & (pos >= 1),
        (q_has_host & (q_hlen <= W - 1))[:, None],
    ], axis=1) & q_has_host[:, None]  # [B, W+1]
    probe_len = np.concatenate([
        np.broadcast_to(pos, (b, W)), q_hlen[:, None]], axis=1)
    probe_lvl = np.concatenate([
        np.full((b, W), 2, np.int32), np.full((b, 1), 3, np.int32)], axis=1)
    need = int(probe_ok.sum(axis=1).max(initial=0))
    maxp = next((t for t in MAXP_TIERS if t >= need), MAXP_TIERS[-1])
    order = np.argsort(~probe_ok, axis=1, kind="stable")[:, :maxp]
    pv = np.take_along_axis(probe_ok, order, 1)
    pl = np.where(pv, np.take_along_axis(probe_len, order, 1), 0)
    mask = np.uint32(tab.host_cap - 1)
    hp_slot = np.where(pv, np.take_along_axis(hs[0], pl, 1) & mask, 0)
    hp_fp1 = np.where(pv, np.take_along_axis(hs[1], pl, 1), 0)
    hp_fp2 = np.where(pv, np.take_along_axis(hs[2], pl, 1), 0)
    hp_level = np.where(pv, np.take_along_axis(probe_lvl, order, 1), 0)

    # q_hmeta[p] = (fp1, fp2, isdot) of the reversed-host prefix [:p] —
    # what a uri-bucket member's host fingerprint is compared against.
    # Positions beyond the query host length are zeroed so a longer rule
    # host can never fp-match the rolling hash of padding.
    valid_p = np.arange(W)[None, :] <= np.minimum(q_hlen, W - 1)[:, None]
    isdot = np.concatenate([
        (q_hostb == DOT) & (pos >= 1) & (pos < q_hlen[:, None]),
    ], axis=1)
    q_hmeta = np.zeros((b, W, 3), np.int32)
    q_hmeta[:, :, 0] = np.where(valid_p, hs[1][:, :W], 0).view(np.int32)
    q_hmeta[:, :, 1] = np.where(valid_p, hs[2][:, :W], 0).view(np.int32)
    q_hmeta[:, :, 2] = isdot

    us = [rolling_fnv32(q_urib, s) for s in tab.uri_salts]
    lset_cap = tab.caps["lset"]
    lset = np.full(lset_cap, -1, np.int32)
    lset[: len(tab.lset)] = tab.lset
    lv = (lset[None, :] >= 0) & (lset[None, :] <= q_ulen[:, None]) & \
        q_has_uri[:, None]
    ll = np.where(lv, np.maximum(lset[None, :], 0), 0)
    umask = np.uint32(tab.uri_cap - 1)
    # uri slots are offset into the combined host+uri slot table
    up_slot = np.where(
        lv, (np.take_along_axis(us[0], ll, 1) & umask) + tab.host_cap, 0)
    up_fp1 = np.where(lv, np.take_along_axis(us[1], ll, 1), 0)
    up_fp2 = np.where(lv, np.take_along_axis(us[2], ll, 1), 0)
    up_score = np.where(lv, np.minimum(ll + 1, URI_MAX_SCORE), 0)

    # The probe arrays are TRIMMED to the batch's live probe count —
    # each padded probe is one wasted row read per query. When
    # trimming happens, full lset-indexed um_* copies are kept for
    # host-side member evaluation (members reference lset positions);
    # untrimmed batches reuse the up_* arrays directly (kernel fallback)
    um = {}
    uneed = int(lv.sum(axis=1).max(initial=0))
    utier = next((t for t in (1, 2, 4, 8, 16, 32, 64, 128)
                  if t >= max(uneed, 1)), lset_cap)
    utier = min(utier, lset_cap)
    if utier < lset_cap:
        um = {"um_fp1": up_fp1.astype(np.uint32).view(np.int32),
              "um_fp2": up_fp2.astype(np.uint32).view(np.int32),
              "um_score": up_score.astype(np.int32)}
        uorder = np.argsort(~lv, axis=1, kind="stable")[:, :utier]
        up_slot = np.take_along_axis(up_slot, uorder, 1)
        up_fp1 = np.take_along_axis(up_fp1, uorder, 1)
        up_fp2 = np.take_along_axis(up_fp2, uorder, 1)
        up_score = np.take_along_axis(up_score, uorder, 1)

    return {
        **um,
        "hp_slot": hp_slot.astype(np.int32),
        "hp_fp1": hp_fp1.astype(np.uint32).view(np.int32),
        "hp_fp2": hp_fp2.astype(np.uint32).view(np.int32),
        "hp_level": hp_level.astype(np.int32),
        "up_slot": up_slot.astype(np.int32),
        "up_fp1": up_fp1.astype(np.uint32).view(np.int32),
        "up_fp2": up_fp2.astype(np.uint32).view(np.int32),
        "up_score": up_score.astype(np.int32),
        "q_hmeta": q_hmeta,
        "hlen": q_hlen, "port": q_port,
        "has_host": q_has_host, "has_uri": q_has_uri,
    }



@dataclass
class FpCidrTable:
    """Packed-single-probe CIDR table. Groups (one per (family, mask)
    pattern) are laid out family-V4-first so an all-V4 batch can run on
    the `arrays_v4` slice (about 1/3 of the groups — the v4-in-v6
    duplicate patterns only serve V6-typed queries)."""

    n: int
    r_cap: int
    arrays: dict
    n4: int  # padded count of leading V4-family groups
    caps: dict = field(default_factory=dict)

    @property
    def arrays_v4(self) -> dict:
        g_keys = ("g_mask4", "g_fam", "g_salt_s", "g_salt_f1", "g_salt_f2",
                  "g_off", "g_capmask")
        return {k: (v[: self.n4] if k in g_keys else v)
                for k, v in self.arrays.items()}


def _fnv32_key16(key: bytes, salt: int) -> int:
    """fnv32_words_np(_pack_words16(key)) on python ints — bit-identical
    (LE word packing, 4 FNV rounds, fmix32), ~10x less GIL hold in the
    cidr fp build loop."""
    h = (_FNV32_OFFSET_I ^ int(salt)) & _M32
    for j in range(0, 16, 4):
        w = (key[j] | (key[j + 1] << 8) | (key[j + 2] << 16)
             | (key[j + 3] << 24))
        h = ((h ^ w) * _FNV32_PRIME_I) & _M32
    return _fmix32_i(h)



# ------------------------------------------------- v4 direct-index trie
#
# Every V4-family pattern is a contiguous-prefix mask over the low 32
# bits (_expand_patterns), so the whole V4 side compresses into a 16/8/8
# direct-index trie: 3 scalar gathers per query instead of one wide row
# gather per (query, mask-group): the reference's cost model, where a
# gathered row is the unit of cost, is why this layout exists. Semantics
# are exact: each cell resolves to the
# FIRST-matching rule in list order (min index among covering patterns)
# — route mode paints cells in descending rule order so the lowest index
# lands last; ACL cells keep the full pruned covering-rule list in
# `mrows` so the port filter still picks the first match.
#
# Cell encoding (i32): <0 -> next-level table id (-(id+1)); route mode:
# 0 = miss, v>0 = rule idx + 1; ACL mode: v>=0 = member-row id (row 0 is
# the all-empty row = miss).

_TRIE_TOUCH_LIMIT = 3_000_000  # build-cost guard: fall back to groups


def _trie4_tables(pats4: list, caps: dict):
    """Phase A — allocate subtables. pats4: [(key4, masklen, idx)].
    -> (l0_ptr [65536], l1_ptr [S1cap,256], sub-counts S1, S2)."""
    l0_ptr = np.full(65536, -1, np.int64)
    n_s1 = 0
    for key, m, _ in pats4:
        if m > 16:
            h = (key[0] << 8) | key[1]
            if l0_ptr[h] < 0:
                l0_ptr[h] = n_s1
                n_s1 += 1
    s1_cap = max(caps.get("S1", 0), _pow2(max(n_s1, 1), 4))
    if n_s1 > s1_cap:
        s1_cap = _pow2(n_s1, 4)
    l1_ptr = np.full((s1_cap, 256), -1, np.int64)
    n_s2 = 0
    for key, m, _ in pats4:
        if m > 24:
            s = l0_ptr[(key[0] << 8) | key[1]]
            if l1_ptr[s, key[2]] < 0:
                l1_ptr[s, key[2]] = n_s2
                n_s2 += 1
    s2_cap = max(caps.get("S2", 0), _pow2(max(n_s2, 1), 4))
    if n_s2 > s2_cap:
        s2_cap = _pow2(n_s2, 4)
    return l0_ptr, l1_ptr, s1_cap, s2_cap


def _trie4_paint_route(pats4: list, caps: dict) -> dict:
    """Route cells: min rule idx among covering patterns (descending
    paint order; numpy range writes)."""
    l0_ptr, l1_ptr, s1_cap, s2_cap = _trie4_tables(pats4, caps)
    l0_val = np.zeros(65536, np.int64)
    l1_val = np.zeros((s1_cap, 256), np.int64)
    l2_val = np.zeros((s2_cap, 256), np.int64)
    for key, m, idx in sorted(pats4, key=lambda p: -p[2]):
        v = idx + 1
        if m <= 16:
            lo = (key[0] << 8) | key[1]
            hi = lo + (1 << (16 - m))
            l0_val[lo:hi] = v
            subs = l0_ptr[lo:hi]
            subs = np.unique(subs[subs >= 0])
            if subs.size:
                l1_val[subs] = v
                l2s = l1_ptr[subs]
                l2s = np.unique(l2s[l2s >= 0])
                if l2s.size:
                    l2_val[l2s] = v
        elif m <= 24:
            s = l0_ptr[(key[0] << 8) | key[1]]
            lo = key[2]
            hi = lo + (1 << (24 - m))
            l1_val[s, lo:hi] = v
            l2s = l1_ptr[s, lo:hi]
            l2s = np.unique(l2s[l2s >= 0])
            if l2s.size:
                l2_val[l2s] = v
        else:
            t2 = l1_ptr[l0_ptr[(key[0] << 8) | key[1]], key[2]]
            lo = key[3]
            l2_val[t2, lo: lo + (1 << (32 - m))] = v
    return _trie4_pack(
        np.where(l0_ptr >= 0, -(l0_ptr + 1), l0_val),
        np.where(l1_ptr >= 0, -(l1_ptr + 1), l1_val),
        l2_val, s1_cap, s2_cap)


def _trie4_pack(l0, l1, l2, s1_cap, s2_cap) -> dict:
    """Flat levels walked with scalar loads (the reference's layout,
    which the CUDA kernel reads as it is)."""
    return {"t_l0": l0.astype(np.int32),
            "t_l1": l1.astype(np.int32).reshape(-1),
            "t_l2": l2.astype(np.int32).reshape(-1),
            "S1": s1_cap, "S2": s2_cap}


def _trie4_cells_acl(pats4: list, caps: dict):
    """ACL cells: the ordered covering-rule LIST per cell (first-match
    with port ranges can't reduce to one winner at build time). Returns
    the raw (l0_ptr, l1_ptr, s1_cap, s2_cap, cell -> rule list) tuple;
    compile_cidr_fp prunes the lists, assigns member rows and encodes
    the level tables. Raises FpBuildError when the build-cost guard
    trips (caller falls back to mask groups)."""
    l0_ptr, l1_ptr, s1_cap, s2_cap = _trie4_tables(pats4, caps)
    touches = 0
    for key, m, _ in pats4:
        if m <= 16:
            lo = (key[0] << 8) | key[1]
            span = 1 << (16 - m)
            touches += span
            subs = l0_ptr[lo: lo + span]
            subs = subs[subs >= 0]
            touches += subs.size * 256
            # descending into every l2 under the covered l1 cells too
            touches += int((l1_ptr[subs] >= 0).sum()) * 256
        elif m <= 24:
            s = l0_ptr[(key[0] << 8) | key[1]]
            lo = key[2]
            span = 1 << (24 - m)
            touches += span
            touches += int((l1_ptr[s, lo: lo + span] >= 0).sum()) * 256
        else:
            touches += 1 << (32 - m)
    if touches > _TRIE_TOUCH_LIMIT:
        raise FpBuildError(f"acl trie too wide to build ({touches} cell"
                           " touches)")
    lists: dict = {}  # cell key -> [rule idx ...] ascending by paint order

    def add(cell, idx):
        lists.setdefault(cell, []).append(idx)

    for key, m, idx in sorted(pats4, key=lambda p: p[2]):
        if m <= 16:
            lo = (key[0] << 8) | key[1]
            for c in range(lo, lo + (1 << (16 - m))):
                s = l0_ptr[c]
                if s < 0:
                    add(("0", c), idx)
                else:
                    for c1 in range(256):
                        t2 = l1_ptr[s, c1]
                        if t2 < 0:
                            add(("1", s, c1), idx)
                        else:
                            for c2 in range(256):
                                add(("2", t2, c2), idx)
        elif m <= 24:
            s = l0_ptr[(key[0] << 8) | key[1]]
            lo = key[2]
            for c1 in range(lo, lo + (1 << (24 - m))):
                t2 = l1_ptr[s, c1]
                if t2 < 0:
                    add(("1", s, c1), idx)
                else:
                    for c2 in range(256):
                        add(("2", t2, c2), idx)
        else:
            t2 = l1_ptr[l0_ptr[(key[0] << 8) | key[1]], key[2]]
            lo = key[3]
            for c2 in range(lo, lo + (1 << (32 - m))):
                add(("2", t2, c2), idx)
    return l0_ptr, l1_ptr, s1_cap, s2_cap, lists


def compile_cidr_fp(networks: Sequence, acl: Optional[Sequence[AclRule]] = None,
                    caps: Optional[dict] = None,
                    strict: bool = True) -> FpCidrTable:
    caps = dict(caps or {})
    n = len(networks)
    r_cap = caps.get("r_cap") or _pad_cap(n, 256)
    if n > r_cap:
        r_cap = _pad_cap(n, 256)

    all_pats = []  # (key16, mask16, fam, rule idx)
    for i, net in enumerate(networks):
        for key, mask, fam in _expand_patterns(net):
            all_pats.append((key, mask, fam, i))

    if os.environ.get("VPROXY_TPU_NO_TRIE"):
        caps["no_trie"] = 1  # A/B escape hatch: force the group-only build
    use_trie = not caps.get("no_trie")
    groups: dict[tuple, dict[bytes, list[int]]] = {}
    pats4 = []  # (key4, masklen, rule idx) — contiguous-prefix by construction
    for key, mask, fam, i in all_pats:
        if fam == V4 and use_trie:
            m = bin(int.from_bytes(mask[12:], "big")).count("1")
            pats4.append((key[12:], m, i))
        else:
            groups.setdefault((fam, mask), {}).setdefault(key, []).append(i)

    trie = None
    trie_acl = None
    if use_trie and not pats4 and not caps.get("S1"):
        # v6-only table (and no reused-caps shape to honor): skip the
        # all-miss trie entirely — no build, upload, or per-query walk
        use_trie = False
    if use_trie:
        try:
            if acl is None:
                trie = _trie4_paint_route(pats4, caps)
            else:
                trie_acl = _trie4_cells_acl(pats4, caps)
        except FpBuildError:
            caps["no_trie"] = 1
            use_trie = False
            for key, mask, fam, i in all_pats:
                if fam == V4:
                    groups.setdefault((fam, mask), {}).setdefault(key, []).append(i)

    g4 = sorted(k for k in groups if k[0] == V4)
    g6 = sorted(k for k in groups if k[0] != V4)
    if use_trie:
        n4 = 0  # the trie serves every V4-family pattern
    else:
        n4 = max(caps.get("n4", 0), _pow2(max(len(g4), 1), 4))
    if len(g4) > n4:
        n4 = _pow2(len(g4), 4)
    n6 = max(caps.get("n6", 0), _pow2(max(len(g6), 1), 4))
    if len(g6) > n6:
        n6 = _pow2(len(g6), 4)
    g_cap = n4 + n6

    mk = 1
    trie_lists: list = []      # unique pruned covering lists (trie ACL)
    trie_list_ids: dict = {}   # tuple(list) -> position in trie_lists
    if acl is not None:
        for buckets in groups.values():
            for k in buckets:
                buckets[k] = _prune_acl_members(buckets[k], acl)
                mk = max(mk, len(buckets[k]))
        if trie_acl is not None:
            cells = trie_acl[4]
            for cell, items in cells.items():
                pruned = _prune_acl_members(items, acl)
                tup = tuple(pruned)
                if tup not in trie_list_ids:
                    trie_list_ids[tup] = len(trie_lists)
                    trie_lists.append(pruned)
                cells[cell] = tup
                mk = max(mk, len(pruned))
            if mk > 128:
                # degenerate stacking: rebuild without the trie
                caps["no_trie"] = 1
                return compile_cidr_fp(networks, acl=acl, caps=caps,
                                       strict=strict)
    # both modes use 3-lane slot entries: route = (fp, fp, min idx);
    # ACL = (fp, fp, member-row id) with the (idx, port-range) members
    # in a SECOND narrow table — a query reads the slot row for every
    # group but member rows only for its (single) fp-matched key,
    # instead of every co-slotted key's members
    Mk = max(caps.get("Mk", 0), mk)
    ew = 3

    g_mask4 = np.zeros((g_cap, 4), np.uint32)
    g_fam = np.full(g_cap, -1, np.int32)
    g_salt = np.zeros((3, g_cap), np.uint32)
    g_off = np.zeros(g_cap, np.int32)
    g_capmask = np.zeros(g_cap, np.int32)

    placed = []  # (gi, cap, salts, slots, buckets)
    off = 0
    e_need = 1
    # v4 groups occupy [0, len(g4)), v6 groups [n4, n4+len(g6))
    order = [(i, k) for i, k in enumerate(g4)] + \
            [(n4 + i, k) for i, k in enumerate(g6)]
    for gi, (fam, mask) in order:
        buckets = groups[(fam, mask)]
        cap = _pow2(2 * max(len(buckets), 1), 4)
        # E (entries per slot row) sets the gathered row WIDTH for the
        # whole table — the dominant per-query HBM cost. Grow a group's
        # slot cap until co-slotted keys stop stacking.
        while True:
            salts, slots = _place_fp(list(buckets.keys()), _fnv32_key16,
                                     cap, salt_base=101 + gi)
            e_here = max((len(v) for v in slots.values()), default=1)
            if e_here <= 4 or cap >= 64 * len(buckets):
                break
            cap *= 2
        e_need = max(e_need, e_here)
        g_mask4[gi] = _pack_words16(np.frombuffer(mask, np.uint8))
        g_fam[gi] = fam
        g_salt[0][gi], g_salt[1][gi], g_salt[2][gi] = salts
        g_off[gi] = off
        g_capmask[gi] = cap - 1
        placed.append((gi, cap, salts, slots, buckets))
        off += cap

    E = max(caps.get("E", 0), e_need)
    if E > 128:
        raise FpBuildError(f"degenerate slot pileup: E={E}")
    n_keys = sum(len(groups[k]) for k in groups)
    nm = max(caps.get("nm", 0), _pow2(n_keys + len(trie_lists) + 1, 256))
    ct = max(caps.get("ct", 0), _pow2(max(off, 1), 256))
    rec = np.zeros((ct, E * ew), np.int32)
    mrows = np.full((nm if acl is not None else 1, 2 * Mk), -1, np.int32)
    next_mrow = 1  # row 0 = empty (all idx -1)
    for gi, cap, salts, slots, buckets in placed:
        base_off = g_off[gi]
        for sl, ents in slots.items():
            row = base_off + sl
            for j, (key, f1, f2) in enumerate(ents):
                if acl is None:
                    rec[row, j * ew: j * ew + 3] = [
                        _i32(f1), _i32(f2), min(buckets[key])]
                    continue
                mrow = next_mrow
                next_mrow += 1
                for mi, ridx in enumerate(buckets[key]):
                    r = acl[ridx]
                    mrows[mrow, 2 * mi] = ridx
                    mrows[mrow, 2 * mi + 1] = _i32(
                        (r.min_port & 0xFFFF) | ((r.max_port & 0xFFFF) << 16))
                rec[row, j * ew: j * ew + 3] = [_i32(f1), _i32(f2), mrow]

    if trie_acl is not None:
        # member rows for the trie's per-cell covering lists, then the
        # encoded cell tables (cell value = member-row id, 0 = miss)
        l0_ptr, l1_ptr, s1_cap, s2_cap, cells = trie_acl
        row_of = {}
        for tup, _pos in trie_list_ids.items():
            row = next_mrow
            next_mrow += 1
            for mi, ridx in enumerate(tup):
                r = acl[ridx]
                mrows[row, 2 * mi] = ridx
                mrows[row, 2 * mi + 1] = _i32(
                    (r.min_port & 0xFFFF) | ((r.max_port & 0xFFFF) << 16))
            row_of[tup] = row
        l0_val = np.zeros(65536, np.int64)
        l1_val = np.zeros((s1_cap, 256), np.int64)
        l2_val = np.zeros((s2_cap, 256), np.int64)
        for cell, tup in cells.items():
            v = row_of[tup]
            if cell[0] == "0":
                l0_val[cell[1]] = v
            elif cell[0] == "1":
                l1_val[cell[1], cell[2]] = v
            else:
                l2_val[cell[1], cell[2]] = v
        trie = _trie4_pack(
            np.where(l0_ptr >= 0, -(l0_ptr + 1), l0_val),
            np.where(l1_ptr >= 0, -(l1_ptr + 1), l1_val),
            l2_val, s1_cap, s2_cap)

    allow = np.zeros(r_cap, bool)
    if acl is not None:
        for i, r in enumerate(acl):
            allow[i] = r.allow

    arrays = {
        "g_mask4": g_mask4, "g_fam": g_fam,
        "g_salt_s": g_salt[0], "g_salt_f1": g_salt[1], "g_salt_f2": g_salt[2],
        "g_off": g_off, "g_capmask": g_capmask,
        "rec": rec, "allow": allow,
        "rcap_iota": np.zeros(r_cap, np.int32),
        "e_m": np.zeros((E, 1), np.int32),
    }
    if acl is not None:
        arrays["mrows"] = mrows
    new_caps = {"r_cap": r_cap, "n4": n4, "n6": n6, "E": E, "ct": ct,
                "Mk": Mk, "nm": nm}
    if trie is not None:
        arrays["t_l0"] = trie["t_l0"]
        arrays["t_l1"] = trie["t_l1"]
        arrays["t_l2"] = trie["t_l2"]
        new_caps["S1"] = trie["S1"]
        new_caps["S2"] = trie["S2"]
    if caps.get("no_trie"):
        new_caps["no_trie"] = 1
    if strict and caps and any(caps.get(k, 0) and new_caps[k] > caps[k]
                               for k in new_caps):
        raise CapsExceeded(f"update outgrew reused caps: {caps} -> {new_caps}")
    return FpCidrTable(n=n, r_cap=r_cap, arrays=arrays, n4=n4,
                       caps=new_caps)


# ------------------------------------------------------ plain torch tier
#
# u32 values ride int64 tensors (`>>` on int32 is arithmetic); a product
# of a u32 and a 32-bit constant can pass 2^63, so _mul32 splits the
# constant into 16-bit halves.


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for u32 values h held in int64, no overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _fmix32_dev(h: torch.Tensor) -> torch.Tensor:
    """_fmix32_np on u32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _fnv32_words_dev(words: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """words [B, G, 4], salt [G] (u32 values, any integer dtype) ->
    int64 [B, G] holding the u32 hash; bit-identical to fnv32_words_np
    (incl. the fmix32 finalizer)."""
    words = words.to(torch.int64)
    h = (_FNV32_OFFSET_I ^ salt.to(torch.int64))[None, :].expand(
        words.shape[:-1])
    for p in range(4):
        h = ((h ^ words[..., p]) * _FNV32_PRIME_I) & _M32
    return _fmix32_dev(h)


def _pack_words16_dev(b16: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 16] -> int64 [..., 4] little-endian u32 words."""
    w = b16.to(torch.int64).reshape(b16.shape[:-1] + (4, 4))
    return w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) | (w[..., 3] << 24)


def _member_fields(members: torch.Tensor):
    """members [..., 4] -> (port, kind, aux, idx, f1, f2)."""
    meta = members[..., 0]
    return (meta & 0xFFFF, (meta >> 16) & 3, (meta >> 18) & 0x7F,
            members[..., 1], members[..., 2], members[..., 3])


MEMBER_MODES = ("gather", "selgather", "reduce")


def default_member_mode() -> str:
    """VPROXY_TPU_FP_MEMBER, default "gather": the reference's lowering
    of hint_fp_match's member evaluation (vproxy_tpu/ops/fphash.py
    default_member_mode). Its three modes are three lowerings of one
    function, which the reference's tests hold bit for bit equal; this
    package computes that one function in one plain form, and on the
    card the kernel evaluates the matched entry's members only, so the
    mode selects nothing here (as VPROXY_TPU_FUSED_KERNEL). It is still
    read and checked, with the reference's ValueError, so the knob means
    the same in both packages."""
    mode = os.environ.get("VPROXY_TPU_FP_MEMBER", "gather")
    if mode not in MEMBER_MODES:
        raise ValueError(
            f"VPROXY_TPU_FP_MEMBER={mode!r} not in {MEMBER_MODES}")
    return mode


def _sel_entry(ok: torch.Tensor, mem: torch.Tensor):
    """The unique fp-matched entry's member records, as a masked sum over
    the E axis. ok [b, P, E]; mem [b, P, E, M, 4] -> ([b, P, M, 4],
    any-entry-matched [b, P]). Exact: at most one entry of a slot row
    can match (_place_fp rejects duplicate fingerprint pairs); with none
    the sum is all-zero and the caller gates on the returned mask."""
    sel = torch.where(ok[..., None, None], mem, 0).sum(dim=2,
                                                      dtype=torch.int32)
    return sel, ok.any(dim=2)


def _gather_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab [b, L, C], idx [b, X] -> tab[i, idx[i, x]] [b, X, C], the index
    clamped into [0, L) as JAX's gather clamps it."""
    i = idx.clamp(0, tab.shape[1] - 1).long()
    return torch.gather(tab, 1, i[..., None].expand(-1, -1, tab.shape[2]))


def hint_fp_match(t: dict, q: dict, mode: Optional[str] = None):
    """-> (best rule idx [B] i32 or -1, best level [B] i32): the plain
    version of B6 (vproxy_tpu/ops/fphash.py hint_fp_match). `t`: a
    compiled FpHintTable's arrays as tensors; `q`: an encoded batch
    (encode_hint_queries_fp) as tensors on the same device. Every probe
    reads one slot row; the matched entry's members (_sel_entry) score
    against the query's uri fingerprints (um_* when the uri probes were
    trimmed, else up_*) or its rolling host fingerprints (q_hmeta); the
    wildcard lists score every query; the winner is the max
    level*(r_cap+1)+(r_cap-idx). `mode` is checked, and selects nothing
    (default_member_mode). `cuda_calls` counts the calls made on CUDA
    tensors, which only a comparison with the kernel makes."""
    mode = mode or default_member_mode()
    if mode not in MEMBER_MODES:
        raise ValueError(f"unknown member mode {mode!r}")
    if q["hp_slot"].is_cuda:
        hint_fp_match.cuda_calls += 1
    r_cap = t["rcap_iota"].shape[0]
    b, p_cnt = q["hp_slot"].shape
    hE, hM = t["h_em"].shape
    uE, uM = t["u_em"].shape
    port = q["port"][:, None]
    has_uri = q["has_uri"].to(torch.int32)[:, None]
    has_host = q["has_host"].to(torch.int32)[:, None]
    q_umeta = torch.stack([q.get("um_fp1", q["up_fp1"]),
                           q.get("um_fp2", q["up_fp2"]),
                           q.get("um_score", q["up_score"])], dim=-1)
    q_hmeta = q["q_hmeta"]

    def uri_side_level(lidx, uf1, uf2, ukind):
        """uri level of host-side members ([b, X]; kind 0 none / 1
        normal / 2 wildcard), lidx indexing the lset probes."""
        um = _gather_rows(q_umeta, lidx)
        fp_ok = (um[..., 0] == uf1) & (um[..., 1] == uf2) & (um[..., 2] > 0)
        content = torch.where(fp_ok, um[..., 2], 0)
        return torch.where(ukind == 1, content,
                           torch.where(ukind == 2,
                                       torch.maximum(content, has_uri), 0))

    def host_side_level(hlen, hf1, hf2, hkind):
        """host level of uri-side members: exact 3 / dot-suffix 2 /
        wildcard 1, via the rolling q_hmeta fingerprints."""
        hm = _gather_rows(q_hmeta, hlen)
        fp_ok = (hm[..., 0] == hf1) & (hm[..., 1] == hf2)
        exact = fp_ok & (hlen == q["hlen"][:, None])
        suffix = fp_ok & (hm[..., 2] != 0)
        lvl = torch.maximum(torch.where(exact, 3, 0),
                            torch.where(suffix, 2, 0))
        return torch.where(hkind == 1, lvl,
                           torch.where(hkind == 2,
                                       torch.maximum(lvl, has_host), 0))

    levels, idxs = [], []

    def add(level, idx, mport):
        pg = (port == 0) | (mport == 0) | (mport == port)
        levels.append(torch.where((idx >= 0) & pg, level, 0))
        idxs.append(idx)

    def probe_members(rows, fp1, fp2, live, e, m):
        """rows [b, X, >= e(2+4m)] -> the matched entry's member fields
        ([b, X*m] each) and whether an entry matched ([b, X*m])."""
        ew = 2 + 4 * m
        ents = rows[..., : e * ew].reshape(b, -1, e, ew)
        ok = (ents[..., 0] == fp1[:, :, None]) & \
            (ents[..., 1] == fp2[:, :, None]) & live[:, :, None]
        sel, anym = _sel_entry(ok, ents[..., 2:].reshape(b, -1, e, m, 4))
        fields = [f.reshape(b, -1) for f in _member_fields(sel)]
        return fields, anym[:, :, None].expand(-1, -1, m).reshape(b, -1)

    # every probe row (host + offset uri slots) in one gather
    slots = torch.cat([q["hp_slot"], q["up_slot"]], dim=1)
    rows = t["rec"][slots.clamp(0, t["rec"].shape[0] - 1).long()]

    (mport, ukind, lidx, midx, uf1, uf2), hit = probe_members(
        rows[:, :p_cnt], q["hp_fp1"], q["hp_fp2"], q["hp_level"] > 0, hE, hM)
    hl = q["hp_level"][:, :, None].expand(-1, -1, hM).reshape(b, -1)
    ul = uri_side_level(lidx, uf1, uf2, ukind)
    add(torch.where(hit, (hl << HOST_SHIFT) + ul, 0),
        torch.where(hit, midx, -1), mport)

    (mport, hkind, hlen, midx, hf1, hf2), hit = probe_members(
        rows[:, p_cnt:], q["up_fp1"], q["up_fp2"], q["up_score"] > 0, uE, uM)
    ul = q["up_score"][:, :, None].expand(-1, -1, uM).reshape(b, -1)
    hl = host_side_level(hlen, hf1, hf2, hkind)
    add(torch.where(hit, (hl << HOST_SHIFT) + ul, 0),
        torch.where(hit, midx, -1), mport)

    # the wildcard lists: every query scores every member
    mport, ukind, lidx, midx, uf1, uf2 = (
        f[None].expand(b, -1) for f in _member_fields(t["wh_rec"]))
    ul = uri_side_level(lidx, uf1, uf2, ukind)
    add((has_host << HOST_SHIFT) + ul, midx, mport)

    mport, hkind, hlen, midx, hf1, hf2 = (
        f[None].expand(b, -1) for f in _member_fields(t["wu_rec"]))
    hl = host_side_level(hlen, hf1, hf2, hkind)
    add((hl << HOST_SHIFT) + has_uri, midx, mport)

    level = torch.cat(levels, dim=1).to(torch.int64)
    c = torch.cat(idxs, dim=1).clamp(min=0).to(torch.int64)
    pack = torch.where(level > 0, level * (r_cap + 1) + (r_cap - c), 0)
    best = pack.amax(dim=1)
    best_idx = r_cap - best % (r_cap + 1)
    return torch.where(best > 0, best_idx, -1).to(torch.int32), \
        (best // (r_cap + 1)).to(torch.int32)


hint_fp_match.cuda_calls = 0  # calls on CUDA tensors


def _trie4_lookup(t: dict, addr16: torch.Tensor) -> torch.Tensor:
    """The 16/8/8 direct-index walk on the low 32 bits. -> the raw cell
    value [B] (route: idx+1, 0 miss; ACL: member-row id)."""
    a = addr16.to(torch.int64)

    def load(level, i):
        return level[i.clamp(0, level.shape[0] - 1)].to(torch.int64)

    v0 = load(t["t_l0"], a[:, 12] * 256 + a[:, 13])
    s1 = torch.where(v0 < 0, -v0 - 1, 0)
    v1 = load(t["t_l1"], s1 * 256 + a[:, 14])
    r1 = torch.where(v0 < 0, v1, v0)
    s2 = torch.where(r1 < 0, -r1 - 1, 0)
    v2 = load(t["t_l2"], s2 * 256 + a[:, 15])
    return torch.where(r1 < 0, v2, r1)


def _acl_first(mem: torch.Tensor, port: Optional[torch.Tensor],
               r_cap: int) -> torch.Tensor:
    """mem [B, X, 2] (idx, lo|hi<<16) -> first matching idx or r_cap."""
    midx = mem[..., 0]
    valid = midx >= 0
    if port is not None:
        ports = mem[..., 1]
        lo = ports & 0xFFFF
        hi = (ports >> 16) & 0xFFFF
        p = port[:, None]
        valid = valid & (lo <= p) & (p <= hi)
    b = mem.shape[0]
    return torch.where(valid, midx, r_cap).reshape(b, -1).amin(dim=1)


def cidr_fp_match(t: dict, addr16: torch.Tensor, fam: torch.Tensor,
                  port: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-> first-matching rule index [B] i32 (ordered-scan semantics), -1
    if none: the plain version of B7 (vproxy_tpu/ops/fphash.py
    cidr_fp_match). V4-family queries walk the direct-index trie when
    the table has one; every other query reads one slot row per group
    of its family. addr16 u8 [B, 16], fam i32 [B] (-1: a pad row), port
    i32 [B] or None (routes)."""
    r_cap = t["rcap_iota"].shape[0]
    b = addr16.shape[0]
    rec = t["rec"]
    E = t["e_m"].shape[0]
    ew = rec.shape[1] // E
    G = t["g_fam"].shape[0]
    acl_mode = "mrows" in t
    have_trie = "t_l0" in t

    eok = ents = None
    if G:
        aw = _pack_words16_dev(addr16)  # [B, 4]
        masked = aw[:, None, :] & t["g_mask4"].to(torch.int64)[None]
        hs = _fnv32_words_dev(masked, t["g_salt_s"])
        f1 = _u32_as_i32(_fnv32_words_dev(masked, t["g_salt_f1"]))
        f2 = _u32_as_i32(_fnv32_words_dev(masked, t["g_salt_f2"]))
        slot = t["g_off"].to(torch.int64)[None] + (
            hs & t["g_capmask"].to(torch.int64)[None])
        rows = rec[slot.clamp(0, rec.shape[0] - 1)]  # [B, G, E*ew]
        gok = (t["g_fam"][None] >= 0) & (fam[:, None] == t["g_fam"][None])
        ents = rows.reshape(b, G, E, ew)
        eok = (ents[..., 0] == f1[:, :, None]) & \
            (ents[..., 1] == f2[:, :, None]) & gok[:, :, None]

    first = torch.full((b,), r_cap, dtype=torch.int32, device=addr16.device)
    if not acl_mode:  # route: an entry carries its bucket's min index
        if G:
            idx = torch.where(eok, ents[..., 2], r_cap)
            first = idx.reshape(b, -1).amin(dim=1).to(torch.int32)
        if have_trie:
            tri = _trie4_lookup(t, addr16) - 1
            tri = torch.where(tri >= 0, tri, r_cap).to(torch.int32)
            first = torch.where(fam == V4, tri, first)
        return torch.where(first < r_cap, first, -1).to(torch.int32)

    # ACL: an entry carries a member-row id; at most one entry of a
    # group matches, so each group reads one (idx, lo|hi<<16) row
    mrows = t["mrows"]
    nm = mrows.shape[0]
    if G:
        mrow = torch.where(eok, ents[..., 2], 0).amax(dim=2)  # [B, G]
        mem = mrows[mrow.clamp(0, nm - 1).long()]  # [B, G, 2*Mk]
        first = _acl_first(mem.reshape(b, -1, 2), port,
                           r_cap).to(torch.int32)
    if have_trie:
        mrow_t = _trie4_lookup(t, addr16)
        mem_t = mrows[mrow_t.clamp(0, nm - 1)]  # [B, 2*Mk]
        first_t = _acl_first(mem_t.reshape(b, -1, 2), port,
                             r_cap).to(torch.int32)
        first = torch.where(fam == V4, first_t, first)
    return torch.where(first < r_cap, first, -1).to(torch.int32)


def classify_fp_all(hint_t: dict, route_t: dict, acl_t: dict,
                    hint_q: dict, addr16: torch.Tensor, fam: torch.Tensor,
                    port: torch.Tensor) -> torch.Tensor:
    """One micro-batch's hint, route and ACL answers -> int32 [B, 3]
    (hint, route, acl): the plain version of the fingerprint flagship
    step (vproxy_tpu/ops/fphash.py classify_fp_all); on the card
    ops/fphash_cuda.py classify_fp_all launches B6 once and B7 twice."""
    h_idx, _ = hint_fp_match(hint_t, hint_q)
    r_idx = cidr_fp_match(route_t, addr16, fam, None)
    a_idx = cidr_fp_match(acl_t, addr16, fam, port)
    return torch.stack([h_idx, r_idx, a_idx], dim=1)


# ----------------------------------------------------- mesh-sharded path
#
# Rule-axis sharding mirrors ops/hashmatch's ShardedHashTable (copies of
# the reference's helpers): the rule list is sliced, each slice compiled
# into its OWN fp table under ONE unified caps dict (identical shapes),
# and the per-shard arrays stack on a leading shard axis. Each shard
# runs the unchanged single-shard fp matcher (B6 / B7's routines inside
# B8 on the card); winners reduce as the cuckoo path's do.

from .hashmatch import _compile_sharded, ShardedHashTable  # noqa: E402


def compile_hint_fp_sharded(rules: Sequence[HintRule], n_shards: int,
                            caps: Optional[dict] = None) -> ShardedHashTable:
    return _compile_sharded(
        rules, n_shards,
        lambda s, off, caps: compile_hint_fp(s, caps=caps, strict=False),
        caps)


def compile_cidr_fp_sharded(networks: Sequence, n_shards: int,
                            acl: Optional[Sequence[AclRule]] = None,
                            caps: Optional[dict] = None) -> ShardedHashTable:
    return _compile_sharded(
        networks, n_shards,
        lambda s, off, caps: compile_cidr_fp(
            s, acl=None if acl is None else acl[off: off + len(s)],
            caps=caps, strict=False), caps)


def encode_hint_queries_fp_sharded(hints: Sequence,
                                   stab: ShardedHashTable) -> dict:
    """Per-shard probe encodings stacked on the leading shard axis
    (salts and slot offsets are shard-local). Probe widths are
    content-dependent (trimmed to each shard's live probes), so they
    are re-padded to the widest shard before stacking."""
    per = [encode_hint_queries_fp(hints, t) for t in stab.shards]
    # um_* exist iff that shard's uri probes were trimmed; shards must
    # agree on keys (fallback = the shard's untrimmed up_* arrays)
    if any("um_fp1" in p for p in per):
        for p in per:
            for mk_, pk_ in (("um_fp1", "up_fp1"), ("um_fp2", "up_fp2"),
                             ("um_score", "up_score")):
                p.setdefault(mk_, p[pk_])
    for k in ("hp_slot", "hp_fp1", "hp_fp2", "hp_level",
              "up_slot", "up_fp1", "up_fp2", "up_score"):
        w = max(p[k].shape[1] for p in per)
        for p in per:
            if p[k].shape[1] < w:
                p[k] = np.pad(p[k], ((0, 0), (0, w - p[k].shape[1])))
    return {k: np.stack([p[k] for p in per]) for k in per[0]}
