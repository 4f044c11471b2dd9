"""Batched dense matchers over compiled bit-plane tables (the
"torch-dense" backend, the reference's "jax-dense").

The port's copy of `vproxy_tpu/ops/matchers.py`, as torch functions:
the plain tier of B9, the brute-force cross-check that compares every
query with every rule. Selection semantics reproduce the reference
exactly:

* hint match: strictly-greater max level, earliest rule wins ties
  (Upstream.searchForGroup, Upstream.java:187-198); level encoding is
  (host_level << 10) + uri_level (Hint.java:92-160).
* cidr first-match: smallest rule index among matching patterns
  (RouteTable.lookup RouteTable.java:44; SecurityGroup.allow
  SecurityGroup.java:38-43).

`hint_match` ... `classify_all` run on any device (chip_smoke.py holds
the kernels against them on the card); the `_chunked` forms keep the
[B, chunk] mismatch matrix the largest intermediate, so `cuda_calls`
counts their calls on tensors off the CPU.

The entries the engine serves with are `hint_dense`, `hint_dense_pick`
(a classify+pick batch: the verdict and the Maglev pick in one launch),
`cidr_dense` and `classify_dense`: CPU tensors take the plain tier
(`hint_dense_pick_plain` for the pick column), every other tensor
the hand-written CUDA kernels (ops/dense_cuda.py, csrc/dense_match.cu),
which raise KernelError unless they launched (fused_cuda.card_entry).
There is no fallback.
"""
from __future__ import annotations

import numpy as np
import torch

from .bitmatch import mismatch_counts, unpack_bits
from .tables import MATCH_CHUNK

HOST_SHIFT = 10
NO_MATCH = -1


def _no_match(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, NO_MATCH, dtype=torch.int32)


def hint_match(table: dict, q_host, q_has_host, q_uri_bits, q_has_uri,
               q_port):
    """-> (best_idx [B] i32 (-1 none), best_level [B] i32).

    q_host: [B, HOST_SLOT] uint8 (reversed bytes + length byte)
    q_uri_bits: [B, MAX_URI*8] f32 bit-planes
    """
    # NOTE: uri scoring only needs the RULE-side length (uri_score): an
    # exact uri match scores len(hint.uri)+1 and a prefix match
    # len(rule.uri)+1, which coincide whenever both fire
    # (Hint.java:144-152).
    cap = table["active"].shape[0]
    hb = unpack_bits(q_host)  # [B, HOST_SLOT*8]
    level = _hint_levels(table, hb, q_has_host, q_uri_bits, q_has_uri, q_port)
    # strictly-greater max, earliest index wins ties
    order = torch.arange(cap, dtype=torch.int64, device=level.device)
    key = level.to(torch.int64) * cap + (cap - 1 - order)[None]
    idx = key.argmax(dim=1)
    best_level = level.gather(1, idx[:, None])[:, 0]
    return (torch.where(best_level > 0, idx.to(torch.int32),
                        _no_match(best_level)), best_level)


def cidr_first_match(table: dict, q_addr, q_family, q_port=None):
    """-> first-matching rule index [B] i32, or -1.

    q_addr: [B, 16] uint8 canonical; q_family: [B] i32 (0=v4, 1=v6).
    q_port: [B] i32 for ACL tables (port-range gate), None for routes.
    """
    cap3 = table["valid"].shape[0]
    cap = cap3 // 3
    ab = unpack_bits(q_addr)  # [B, 128]
    mm = mismatch_counts(ab, table["w"], table["c"])  # [B, cap*3]
    match = (mm == 0) & table["valid"][None] & (
        q_family[:, None] == table["family"][None])
    rule_idx = torch.arange(cap3, dtype=torch.int32,
                            device=mm.device) // 3  # pattern -> rule
    if q_port is not None:
        port_ok = (table["min_port"][rule_idx][None] <= q_port[:, None]) & (
            q_port[:, None] <= table["max_port"][rule_idx][None])
        match = match & port_ok
    masked = torch.where(match, rule_idx[None], torch.full_like(
        rule_idx, cap)[None])
    first = masked.min(dim=1).values
    return torch.where(first < cap, first, _no_match(first))


def _lex_better(lvl, idx, best_lvl, best_idx):
    """(level, earliest-index) lexicographic winner — avoids the level*cap
    int32 key overflow for very large tables."""
    take = (lvl > best_lvl) | ((lvl == best_lvl) & (idx < best_idx))
    return torch.where(take, lvl, best_lvl), torch.where(take, idx, best_idx)


_HINT_COLS = {  # key -> (axis, rows per rule) of a chunk's slice
    "host_w": (1, 2), "host_c": (0, 2), "host_valid": (0, 1),
    "host_wild": (0, 1), "uri_w": (1, 1), "uri_c": (0, 1),
    "uri_valid": (0, 1), "uri_wild": (0, 1), "uri_score": (0, 1),
    "port": (0, 1), "active": (0, 1)}


def hint_match_chunked(table: dict, q_host, q_has_host, q_uri_bits,
                       q_has_uri, q_port, chunk: int = MATCH_CHUNK):
    """hint_match for big tables: a loop over rule chunks so the [B, cap]
    mismatch matrix never materializes beyond [B, chunk]."""
    if table["active"].device.type != "cpu":
        hint_match_chunked.cuda_calls += 1
    cap = table["active"].shape[0]
    if cap <= chunk:
        return hint_match(table, q_host, q_has_host, q_uri_bits, q_has_uri,
                          q_port)
    assert cap % chunk == 0, (cap, chunk)
    b = q_host.shape[0]
    dev = q_host.device
    best_lvl = torch.zeros(b, dtype=torch.int32, device=dev)
    best_idx = torch.full((b,), 2**31 - 1, dtype=torch.int32, device=dev)
    hb = unpack_bits(q_host)
    order = torch.arange(chunk, dtype=torch.int64, device=dev)
    for i in range(cap // chunk):
        sub = {k: table[k].narrow(axis, i * chunk * per, chunk * per)
               for k, (axis, per) in _HINT_COLS.items()}
        level = _hint_levels(sub, hb, q_has_host, q_uri_bits, q_has_uri,
                             q_port)
        key = level.to(torch.int64) * chunk + (chunk - 1 - order)[None]
        loc = key.argmax(dim=1)
        lvl = level.gather(1, loc[:, None])[:, 0]
        idx = loc.to(torch.int32) + i * chunk
        best_lvl, best_idx = _lex_better(lvl, idx, best_lvl, best_idx)
    return torch.where(best_lvl > 0, best_idx, _no_match(best_idx)), best_lvl


hint_match_chunked.cuda_calls = 0  # calls on tensors off the CPU


def cidr_first_match_chunked(table: dict, q_addr, q_family, q_port=None,
                             chunk: int = MATCH_CHUNK):
    """cidr_first_match over rule chunks (chunk counts rules, each rule
    has 3 pattern slots)."""
    if table["valid"].device.type != "cpu":
        cidr_first_match_chunked.cuda_calls += 1
    cap3 = table["valid"].shape[0]
    cap = cap3 // 3
    if cap <= chunk:
        return cidr_first_match(table, q_addr, q_family, q_port)
    assert cap % chunk == 0, (cap, chunk)
    b = q_addr.shape[0]
    dev = q_addr.device
    ab = unpack_bits(q_addr)
    rule_idx = torch.arange(chunk * 3, dtype=torch.int32, device=dev) // 3
    first = torch.full((b,), cap, dtype=torch.int32, device=dev)
    for i in range(cap // chunk):
        s3, s1 = i * chunk * 3, i * chunk
        mm = mismatch_counts(ab, table["w"].narrow(1, s3, chunk * 3),
                             table["c"].narrow(0, s3, chunk * 3))
        match = (mm == 0) & table["valid"].narrow(0, s3, chunk * 3)[None] & (
            q_family[:, None] == table["family"].narrow(0, s3, chunk * 3)[None])
        if q_port is not None:
            minp = table["min_port"].narrow(0, s1, chunk)
            maxp = table["max_port"].narrow(0, s1, chunk)
            port_ok = (minp[rule_idx][None] <= q_port[:, None]) & (
                q_port[:, None] <= maxp[rule_idx][None])
            match = match & port_ok
        masked = torch.where(match, rule_idx[None] + i * chunk,
                             torch.full_like(rule_idx, cap)[None])
        first = torch.minimum(first, masked.min(dim=1).values)
    return torch.where(first < cap, first, _no_match(first))


cidr_first_match_chunked.cuda_calls = 0  # calls on tensors off the CPU


def _hint_levels(table, hb, q_has_host, q_uri_bits, q_has_uri, q_port):
    """[B, cap] int32 match levels for one (sub-)table. Shared by
    direct/chunked."""
    cap = table["active"].shape[0]
    i32 = torch.int32
    hmm = mismatch_counts(hb, table["host_w"], table["host_c"])
    hmatch = (hmm == 0).reshape(-1, cap, 2) & table["host_valid"][None]
    exact, suffix = hmatch[..., 0], hmatch[..., 1]
    host_level = torch.maximum(
        torch.maximum(exact.to(i32) * 3, suffix.to(i32) * 2),
        table["host_wild"][None].to(i32))
    host_level = torch.where(q_has_host[:, None], host_level, 0)
    umm = mismatch_counts(q_uri_bits, table["uri_w"], table["uri_c"])
    prefix = (umm == 0) & table["uri_valid"][None]
    uri_level = torch.maximum(prefix.to(i32) * table["uri_score"][None],
                              table["uri_wild"][None].to(i32))
    uri_level = torch.where(q_has_uri[:, None], uri_level, 0)
    level = (host_level << HOST_SHIFT) + uri_level
    port_ok = (q_port[:, None] == 0) | (table["port"][None] == 0) | (
        q_port[:, None] == table["port"][None])
    return torch.where(port_ok & table["active"][None], level, 0).to(i32)


def _allow(acl_table: dict, a_idx):
    return torch.where(a_idx >= 0,
                       acl_table["allow"][a_idx.clamp(min=0).long()],
                       torch.zeros_like(a_idx, dtype=torch.bool))


def classify_all(hint_table: dict, route_table: dict, acl_table: dict,
                 hint_q: dict, route_q: dict, acl_q: dict):
    """The flagship step: one call classifies a micro-batch of LB hints
    + DNS qnames (hint_q), route lookups and ACL checks. -> (hint index,
    hint level, route index, ACL index, ACL allow)."""
    h_idx, h_level = hint_match_chunked(
        hint_table, hint_q["host"], hint_q["has_host"],
        unpack_bits(hint_q["uri"]), hint_q["has_uri"], hint_q["port"])
    r_idx = cidr_first_match_chunked(route_table, route_q["addr"],
                                     route_q["family"])
    a_idx = cidr_first_match_chunked(acl_table, acl_q["addr"],
                                     acl_q["family"], acl_q["port"])
    return h_idx, h_level, r_idx, a_idx, _allow(acl_table, a_idx)


def table_arrays(t) -> dict:
    """HintTable/CidrTable dataclass -> dict of its numpy arrays."""
    return {k: v for k, v in vars(t).items() if isinstance(v, np.ndarray)}


# ------------------------------------------------------- serving entries

def _on_cpu(table: dict) -> bool:
    return next(iter(table.values())).device.type == "cpu"


def hint_dense(table: dict, q: dict):
    """B9's hint entry: (rule index int32 [B], -1 for none; level int32
    [B]) for an encode_hints batch `q` (tensors: host, has_host, uri,
    has_uri, port). CPU tensors take the plain tier
    (hint_match_chunked); CUDA tensors launch the kernel
    (dense_cuda.hint_dense_cuda) over the table's packed layout, which
    raises unless it launched."""
    if _on_cpu(table):
        return hint_match_chunked(table, q["host"], q["has_host"],
                                  unpack_bits(q["uri"]), q["has_uri"],
                                  q["port"])
    from . import dense_cuda as DC
    return DC.hint_dense_cuda(table, q)


def hint_dense_pick_plain(table: dict, q: dict, mtab: torch.Tensor,
                          slots: torch.Tensor) -> torch.Tensor:
    """The plain version of B9's hint with its Maglev column: the plain
    tier's rule index (hint_match_chunked) beside B5's plain take
    (take_cuda.take_plain) -> int32 [B, 2]."""
    from .take_cuda import take_plain
    idx = hint_match_chunked(table, q["host"], q["has_host"],
                             unpack_bits(q["uri"]), q["has_uri"],
                             q["port"])[0]
    return torch.stack([idx.to(torch.int32),
                        take_plain(mtab, slots).to(torch.int32)], dim=1)


def hint_dense_pick(table: dict, q: dict, mtab: torch.Tensor,
                    slots: torch.Tensor) -> torch.Tensor:
    """B9's classify+pick entry: int32 [B, 2] (rule index, -1 for none;
    Maglev pick mtab[clamp(slot, 0, M - 1)]) for an encode_hints batch
    and its flow slots. CPU tensors take the plain version
    (hint_dense_pick_plain); CUDA tensors ONE launch of B9's hint with
    its Maglev column (dense_cuda.hint_dense_cuda), which raises unless
    it launched."""
    if _on_cpu(table):
        return hint_dense_pick_plain(table, q, mtab, slots)
    from . import dense_cuda as DC
    return DC.hint_dense_cuda(table, q, mtab=mtab, slots=slots)


def cidr_dense(table: dict, a16, fam, port=None):
    """B9's cidr entry: the first matching rule, int32 [B], -1 for
    none. CPU tensors take the plain tier (cidr_first_match_chunked),
    every other tensor the kernel (dense_cuda.cidr_dense_cuda)."""
    if _on_cpu(table):
        return cidr_first_match_chunked(table, a16, fam, port)
    from . import dense_cuda as DC
    return DC.cidr_dense_cuda(table, a16, fam, port)


def classify_dense(hint_table: dict, route_table: dict, acl_table: dict,
                   hint_q: dict, route_q: dict, acl_q: dict):
    """classify_all's entry: CPU tensors take the plain tier; CUDA
    tensors launch B9 three times (hint, routes, the ACL with its
    ports) on one stream, with no host round trip; the allow column is
    a gather, as the reference's is."""
    if _on_cpu(hint_table):
        return classify_all(hint_table, route_table, acl_table, hint_q,
                            route_q, acl_q)
    from . import dense_cuda as DC
    h_idx, h_level = DC.hint_dense_cuda(hint_table, hint_q)
    r_idx = DC.cidr_dense_cuda(route_table, route_q["addr"],
                               route_q["family"])
    a_idx = DC.cidr_dense_cuda(acl_table, acl_q["addr"], acl_q["family"],
                               acl_q["port"])
    return h_idx, h_level, r_idx, a_idx, _allow(acl_table, a_idx)
