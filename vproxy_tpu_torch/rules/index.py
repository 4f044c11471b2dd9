"""Indexed host-side hint matcher — the lone-query latency floor.

The linear oracle (rules/oracle.py) replicates the reference's scan
loop exactly but costs O(rules) per query. HintIndex answers a single
query in O(probes) with EXACTLY the oracle's semantics, using the same
probe/bucket/pruning structure the device tables compile to
(ops/hashmatch.py): host buckets (exact + dot-suffix probes), uri
buckets (rule-length prefix probes), wildcard lists, members pruned with
the identical exactness-preserving signatures (_prune_list); candidates
are scored with oracle.match_level itself (Upstream.searchForGroup,
Upstream.java:187-198).

ClassifyService answers lone queries inline from it, and serves batches
from it when the device is down; FusedPair.index_snap pairs it with the
O(1) Maglev read. The CIDR index waits for the route/ACL slice.
"""
from __future__ import annotations

from typing import Sequence

from ..ops.hashmatch import _prune_list
from . import oracle
from .ir import Hint, HintRule


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
