"""Fused classify+pick — packed tables and the plain torch tier.

Two layers, as in `vproxy_tpu/ops/fused.py`:

* **Packing** (`pack_hint_table`): the compiled hash tables
  (ops/hashmatch) re-packed so resolving a candidate is two row gathers
  — ONE int32 meta row (`pk_meta`, [r_cap, 8]) and ONE uint8 byte row
  (`pk_bytes`, [r_cap, hw+uw]) — and a cuckoo probe one slot row
  (`pk_hslot`/`pk_uslot`, [C, 4]); `pack_cidr_table` likewise for a
  cidr table (one slot row, one meta row per rule). Copies of the
  reference's; the arrays are byte-identical. Packing runs inside the
  matcher's standby compile (rules/engine.py), so packed generations
  publish through the same double-buffered swap as everything else.

* **The plain tier** (`fused_classify_pick`): hint verdict + Maglev
  pick (+ the CIDR route, with a packed cidr table) over the packed
  tables as torch ops, -> int32 [B, 2] or [B, 3]. It is the reference
  semantics the CUDA kernel (ops/fused_cuda.py) is held to, and the
  tier that serves CPU tensors. Verdicts are bit-identical to
  `hashmatch.hint_hash_match`, picks to `maglev._device_take`, routes
  to `hashmatch.cidr_hash_match`; `_cidr_first_packed` alone is the
  plain version of the CIDR kernel (ops/cidr_cuda.py).

There is one fused tier per device (the kernel on CUDA tensors, this
tier on CPU ones), so VPROXY_TPU_FUSED_KERNEL, which picks between the
reference's jit and Pallas tiers, has nothing to select here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import cuckoo as CK
from .hashmatch import (DOT, HOST_SHIFT, _cidr_slots, _first_valid,
                        _items, _reduce_best)

# Packed-table layout version: bump on ANY change to the pk_* array
# shapes/column meanings (the same version as vproxy_tpu's layout,
# which these arrays match byte for byte). The CUDA kernel's build is
# keyed on it (ops/fused_cuda.py), so a layout change rebuilds it.
PACK_LAYOUT_V = 1


# ------------------------------------------------------------- packing

def pack_hint_table(a: dict, uri: Optional[bool] = None) -> dict:
    """HashHintTable.arrays -> packed numpy arrays (see module doc).

    Column map (pk_meta, int32 [r_cap, 8]):
      0 active  1 port  2 host_kind  3 host_len
      4 uri_kind  5 uri_len  6 uri_score  7 reserved
    pk_bytes (uint8 [r_cap, hw+uw]): [0:hw] reversed host bytes,
    [hw:] uri bytes — hw is carried statically by pk_hsplit's shape.
    pk_hslot/pk_uslot (int32 [C, 4]): 0 klen-or--1-when-unused,
    1 bucket_start, 2 bucket_count, 3 reserved.

    Static specialization: a generation with ZERO uri rules (no
    normal, no wildcard) can never match by uri, so the uri half of
    the sweep — probe tables, uri byte columns, wildcard list — is
    OMITTED from the packed dict entirely. The dict's key set selects
    the program: the plain tier skips the uri half and the CUDA kernel
    launches its uri-free instance, so such a table pays no uri work.
    `uri` overrides that choice (ops/sharded_cuda.py keeps the uri half
    in every shard of a stack when any shard has a uri rule)."""
    r_cap = a["r_active"].shape[0]
    hw = a["r_host"].shape[1]
    has_uri = bool((a["r_uri_kind"] > 0).any()) if uri is None else uri
    meta = np.zeros((r_cap, 8), np.int32)
    meta[:, 0] = a["r_active"]
    meta[:, 1] = a["r_port"]
    meta[:, 2] = a["r_host_kind"]
    meta[:, 3] = a["r_host_len"]
    meta[:, 4] = a["r_uri_kind"]
    meta[:, 5] = a["r_uri_len"]
    meta[:, 6] = a["r_uri_score"]
    CK.coop_yield()  # standby-compile pacing: multi-MB memcpys below
    by = np.concatenate([a["r_host"], a["r_uri"]], axis=1) if has_uri \
        else np.ascontiguousarray(a["r_host"])
    CK.coop_yield()

    def slot_pack(used, klen, bs, bc):
        s = np.zeros((used.shape[0], 4), np.int32)
        s[:, 0] = np.where(used, klen, -1)
        s[:, 1] = bs
        s[:, 2] = bc
        return s

    out = {
        "pk_meta": meta, "pk_bytes": by,
        "pk_hsplit": np.zeros(hw, np.int8),  # hw as a static shape
        "pk_hslot": slot_pack(a["hk_used"], a["hk_len"], a["hk_bs"],
                              a["hk_bc"]),
        "pk_hkey": a["hk_bytes"],
        "hb_items": a["hb_items"], "wh_idx": a["wh_idx"],
        "bh_iota": a["bh_iota"],
    }
    if has_uri:
        out.update({
            "pk_uslot": slot_pack(a["uk_used"], a["uk_len"], a["uk_bs"],
                                  a["uk_bc"]),
            "pk_ukey": a["uk_bytes"], "ub_items": a["ub_items"],
            "wu_idx": a["wu_idx"], "bu_iota": a["bu_iota"],
        })
    CK.coop_yield()
    return out


def pack_cidr_table(a: dict) -> dict:
    """HashCidrTable.arrays -> packed arrays. pk_cslot (int32 [CT, 4]):
    0 used, 1 bucket_start, 2 bucket_count, 3 reserved; pk_cmeta
    (int32 [r_cap, 4]): 0 valid, 1 min_port, 2 max_port, 3 reserved.
    The small per-group arrays (g_*) stay as-is — they are read once
    per batch, not per candidate. Both CUDA kernels that answer a CIDR
    lookup (ops/cidr_cuda.py, and the route column of
    ops/fused_cuda.py) read this layout: a slot is one 16-byte record
    and one 16-byte key, a candidate one 16-byte meta row."""
    cs = np.zeros((a["s_used"].shape[0], 4), np.int32)
    cs[:, 0] = a["s_used"]
    cs[:, 1] = a["s_bs"]
    cs[:, 2] = a["s_bc"]
    CK.coop_yield()
    cm = np.zeros((a["r_valid"].shape[0], 4), np.int32)
    cm[:, 0] = a["r_valid"]
    cm[:, 1] = a["min_port"]
    cm[:, 2] = a["max_port"]
    CK.coop_yield()
    return {
        "pk_cslot": cs, "pk_cmeta": cm, "s_key": a["s_key"],
        "cb_items": a["cb_items"], "g_fam": a["g_fam"],
        "g_mask": a["g_mask"], "g_off": a["g_off"],
        "g_capmask": a["g_capmask"], "g_salt1": a["g_salt1"],
        "g_salt2": a["g_salt2"], "bk_iota": a["bk_iota"],
    }


# ---------------------------------------------------------- plain tier

def _packed_probe(slots, plen, pslot, kbytes, qbytes, iota):
    """Byte-verified cuckoo probe against the PACKED slot rows: one
    [B, P, 4] gather answers used+klen+bucket. Unused slots carry klen
    -1, and a valid probe's plen is >= 0, so (klen == plen) subsumes
    the used test."""
    k = kbytes.shape[1]
    s = slots.clamp(min=0).long()
    srec = pslot[s]  # [B, P, 4] — the ONE slot gather
    ok = (slots >= 0) & (srec[..., 0] == plen)
    kb = kbytes[s]  # [B, P, K]
    span = torch.arange(k, dtype=torch.int32, device=slots.device)
    eq = (kb == qbytes[:, None, :k]) | (span[None, None, :] >= plen[:, :, None])
    ok = ok & eq.all(dim=-1)
    start, cnt = srec[..., 1], srec[..., 2]
    j = iota[None, None, :]
    return torch.where(ok[:, :, None] & (j < cnt[:, :, None]),
                       start[:, :, None] + j, -1)


def _hint_verdict_packed(t: dict, q: dict):
    """hint_hash_match over the packed layout: candidate resolve is
    TWO row gathers (pk_meta + pk_bytes). Formula-for-formula the
    unfused tier — bit-identical winners."""
    r_cap = t["pk_meta"].shape[0]
    b = q["hostb"].shape[0]
    hw = t["pk_hsplit"].shape[0]
    has_uri = "pk_uslot" in t  # uri-free tables carry NO uri work

    parts = [_items(t["hb_items"], _packed_probe(
        q[f"hp_slot{f}"], q["hp_len"], t["pk_hslot"], t["pk_hkey"],
        q["hostb"], t["bh_iota"])).reshape(b, -1) for f in (1, 2)]
    if has_uri:
        parts += [_items(t["ub_items"], _packed_probe(
            q[f"up_slot{f}"], q["up_len"], t["pk_uslot"], t["pk_ukey"],
            q["urib"], t["bu_iota"])).reshape(b, -1) for f in (1, 2)]
    parts.append(t["wh_idx"][None].expand(b, -1))
    if has_uri:
        parts.append(t["wu_idx"][None].expand(b, -1))
    cand = torch.cat(parts, dim=1)  # [B, NC]

    c = cand.clamp(min=0)
    ci = c.long()
    meta = t["pk_meta"][ci]   # [B, NC, 8] — one sweep over the records
    by = t["pk_bytes"][ci]    # [B, NC, hw+uw] — one sweep over the bytes
    valid = (cand >= 0) & (meta[..., 0] > 0)

    qport = q["port"][:, None]
    rp = meta[..., 1]
    pg = (qport == 0) | (rp == 0) | (qport == rp)

    hk, hl_ = meta[..., 2], meta[..., 3]
    rb = by[..., :hw]
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

    if has_uri:
        uw = by.shape[-1] - hw
        uk, ul = meta[..., 4], meta[..., 5]
        ub = by[..., hw:]
        uspan = torch.arange(uw, dtype=torch.int32, device=cand.device)
        ueq = ((ub == q["urib"][:, None, :uw]) |
               (uspan[None, None, :] >= ul[:, :, None])).all(dim=-1)
        prefix = ueq & (ul <= q["ulen"][:, None])
        uri_level = torch.maximum(torch.where(prefix, meta[..., 6], 0),
                                  torch.where(uk == 2, 1, 0))
        uri_level = torch.where((uk > 0) & q["has_uri"][:, None],
                                uri_level, 0)
    else:
        uri_level = 0  # no uri rules exist: nothing can score by uri

    level = (host_level << HOST_SHIFT) + uri_level
    level = torch.where(valid & pg, level, 0).to(torch.int32)
    return _reduce_best(level, c, r_cap)


def _cidr_first_packed(t: dict, addr16, fam, port):
    """hashmatch.cidr_hash_match over the packed layout: slot resolve
    one [B, G, 4] gather + the key row; rule gate one pk_cmeta row.
    The plain version of the CUDA kernels' CIDR routine
    (csrc/cidr_first.cuh), and bit-identical to cidr_hash_match."""
    r_cap = t["pk_cmeta"].shape[0]
    b = addr16.shape[0]
    ct, cb = t["pk_cslot"].shape[0], t["cb_items"].shape[0]
    masked, gok, slots = _cidr_slots(t, addr16, fam)
    cands = []
    for slot in slots:
        s = slot.clamp(0, ct - 1).long()
        srec = t["pk_cslot"][s]  # [B, G, 4]
        key = t["s_key"][s]      # [B, G, 16]
        ok = gok & (srec[..., 0] > 0) & (key == masked).all(dim=-1)
        start, cnt = srec[..., 1], srec[..., 2]
        j = t["bk_iota"][None, None, :]
        cands.append(torch.where(ok[:, :, None] & (j < cnt[:, :, None]),
                                 start[:, :, None] + j, -1))
    slot_cand = torch.cat(cands, dim=1).reshape(b, -1)
    cand = torch.where(slot_cand >= 0,
                       t["cb_items"][slot_cand.clamp(0, cb - 1).long()], -1)
    meta = t["pk_cmeta"][cand.clamp(0, r_cap - 1).long()]  # [B, NC, 4]
    valid = (cand >= 0) & (meta[..., 0] > 0)
    if port is not None:
        valid = valid & (meta[..., 1] <= port[:, None]) & \
            (port[:, None] <= meta[..., 2])
    return _first_valid(cand, valid, r_cap)


def fused_classify_pick(ht: dict, q: dict, mtab, slots, ct=None, a16=None,
                        fam=None, port=None):
    """The plain fused program: hint verdict + Maglev pick (+ the CIDR
    first-match route when a packed cidr table `ct` and the address
    batch ride along) -> int32 [B, 2] (verdict, pick) or [B, 3]
    (verdict, pick, route). `ht`: packed hint tensors; `q`: encoded
    query tensors; `mtab`: int32 [M] Maglev column; `slots`: int64 [B]
    host-side FNV Maglev slots (the shared hash contract of
    rules/maglev.py), taken with the clamp of jnp.take(mode="clip");
    `a16` u8 [B, 16], `fam` i32 [B], `port` i32 [B] or None (no port
    gate)."""
    v, _level = _hint_verdict_packed(ht, q)
    p = mtab[slots.clamp(0, mtab.shape[0] - 1).long()].to(torch.int32)
    cols = [v, p]
    if ct is not None:
        cols.append(_cidr_first_packed(ct, a16, fam, port))
    return torch.stack(cols, dim=1)
