"""Indexed host-side matchers — the lone-query latency floor.

The linear oracle (rules/oracle.py) replicates the reference's scan
loops exactly but costs O(rules) per query. These indexes answer a
single query in O(probes) with EXACTLY the oracle's semantics, using the
same probe/bucket/pruning structure the device tables compile to
(ops/hashmatch.py):

* HintIndex — host buckets (exact + dot-suffix probes), uri buckets
  (rule-length prefix probes), wildcard lists, members pruned with the
  identical exactness-preserving signatures (_prune_list); candidates
  are scored with oracle.match_level itself (Upstream.searchForGroup,
  Upstream.java:187-198).
* CidrIndex — per-(family, mask) masked-key dicts over the same
  pattern expansion as the device tables (_expand_patterns mirrors
  Network.maskMatch, Network.java:183-278); route mode keeps the
  bucket's min rule index (ordered-scan winner), ACL mode keeps the
  port-range member list pruned by containment (_prune_acl_members).

ClassifyService answers lone queries inline from them, and serves
batches from them when the device is down; FusedPair.index_snap pairs
HintIndex with the O(1) Maglev read.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..ops.hashmatch import _expand_patterns, _prune_acl_members, _prune_list
from ..ops.tables import V4, V6
from . import oracle
from .ir import AclRule, Hint, HintRule


class HintIndex:
    """O(probes) exact Hint matcher (same winner as oracle.search)."""

    def __init__(self, rules: Sequence[HintRule]):
        self.rules = list(rules)
        self.host_buckets: dict[str, list[int]] = {}
        self.uri_buckets: dict[str, list[int]] = {}
        wh: list[int] = []
        wu: list[int] = []
        lset = set()
        from ..ops.cuckoo import coop_yield
        for i, r in enumerate(self.rules):
            if not (i & 31):
                coop_yield()  # cooperative: builds run on the engine's
                #               background installer (cuckoo.coop_yield)
            if r.is_empty():
                continue
            if r.host is not None:
                self.host_buckets.setdefault(r.host, []).append(i)
                if r.host == "*":
                    wh.append(i)
            if r.uri is not None:
                self.uri_buckets.setdefault(r.uri, []).append(i)
                lset.add(len(r.uri))
                if r.uri == "*":
                    wu.append(i)
        # identical pruning signatures as the device table compilers —
        # the exactness argument is ops/hashmatch.py:166-181 verbatim
        for bi, k in enumerate(self.host_buckets):
            if not (bi & 63):
                coop_yield()
            self.host_buckets[k] = _prune_list(
                self.rules, self.host_buckets[k], lambda r: (r.uri, r.port))
        for bi, k in enumerate(self.uri_buckets):
            if not (bi & 63):
                coop_yield()
            self.uri_buckets[k] = _prune_list(
                self.rules, self.uri_buckets[k], lambda r: r.port)
        self.wh = _prune_list(self.rules, wh, lambda r: (r.uri, r.port))
        self.wu = _prune_list(self.rules, wu, lambda r: r.port)
        self.lset = sorted(lset)

    def lookup(self, hint: Hint) -> int:
        """-> matching rule index or -1; winner == oracle.search()."""
        rules = self.rules
        best_lv = 0
        best = -1

        def consider(idxs):
            nonlocal best_lv, best
            for i in idxs:
                lv = oracle.match_level(hint, rules[i])
                if lv > best_lv or (lv == best_lv and best >= 0 and i < best):
                    best_lv, best = lv, i

        hb = self.host_buckets
        if hint.host is not None:
            h = hint.host
            m = hb.get(h)
            if m is not None:
                consider(m)
            # dot-suffix probes: every rule host that q ends with ".host"
            pos = h.find(".")
            while pos >= 0:
                m = hb.get(h[pos + 1:])
                if m is not None:
                    consider(m)
                pos = h.find(".", pos + 1)
            consider(self.wh)
        if hint.uri is not None:
            u = hint.uri
            ub = self.uri_buckets
            for l in self.lset:
                if l > len(u):
                    break
                m = ub.get(u[:l])
                if m is not None:
                    consider(m)
            consider(self.wu)
        return best if best_lv > 0 else -1


class CidrIndex:
    """O(groups) exact first-match CIDR lookup (routes / ACL)."""

    def __init__(self, networks: Sequence,
                 acl: Optional[Sequence[AclRule]] = None):
        # (fam, mask_int) -> {masked_key_int: min idx | [(idx, lo, hi)]}
        self.groups: dict[tuple, dict] = {}
        self.acl = list(acl) if acl is not None else None
        buckets: dict[tuple, dict[int, list[int]]] = {}
        from ..ops.cuckoo import coop_yield
        for i, net in enumerate(networks):
            if not (i & 31):
                coop_yield()  # cooperative: see HintIndex.__init__
            for key, mask, fam in _expand_patterns(net):
                g = buckets.setdefault(
                    (fam, int.from_bytes(mask, "big")), {})
                g.setdefault(int.from_bytes(key, "big"), []).append(i)
        for gk, keys in buckets.items():
            out: dict = {}
            for key, items in keys.items():
                if self.acl is None:
                    out[key] = min(items)
                else:
                    out[key] = [
                        (j, self.acl[j].min_port, self.acl[j].max_port)
                        for j in _prune_acl_members(items, self.acl)]
            self.groups[gk] = out

    def lookup(self, addr: bytes, port: Optional[int] = None) -> int:
        """-> first matching rule index in insert order, or -1. Matches
        CidrMatcher.oracle_snap (Network.contains_ip + port gate)."""
        if len(addr) == 4:
            a, fam = int.from_bytes(b"\x00" * 12 + addr, "big"), V4
        else:
            a, fam = int.from_bytes(addr, "big"), V6
        best = -1
        for (gfam, mask), keys in self.groups.items():
            if gfam != fam:
                continue
            hit = keys.get(a & mask)
            if hit is None:
                continue
            if self.acl is None:
                if best < 0 or hit < best:
                    best = hit
            else:
                for j, lo, hi in hit:
                    if port is None or lo <= port <= hi:
                        if best < 0 or j < best:
                            best = j
                        break
        return best
