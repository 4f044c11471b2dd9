"""Hint verdicts: vproxy's Hint.matchLevel scored against every rule,
the strictly greater level winning and the earliest rule among equals
(Upstream.searchForGroup).

A rule scores above 0 only when its host equals the query's host, is a
dot-suffix of it or is "*", or its uri is a prefix of the query's uri or
"*". So the scan visits exactly those rules; every other rule scores 0
and could never win.
"""
from __future__ import annotations

from collections import defaultdict

HOST_SHIFT = 10
URI_MAX = 1023


def level(q: tuple, r: tuple) -> int:
    """Hint.matchLevel of query q against rule r, both (host, port, uri)."""
    qh, qp, qu = q
    rh, rp, ru = r
    if rh is None and rp == 0 and ru is None:
        return 0
    if qp != 0 and rp != 0 and qp != rp:
        return 0
    hl = 0
    if rh is not None and qh is not None:
        if qh == rh:
            hl = 3
        elif qh.endswith("." + rh):
            hl = 2
        elif rh == "*":
            hl = 1
    ul = 0
    if ru is not None and qu is not None:
        if qu == ru:
            ul = len(qu) + 1
        elif qu.startswith(ru):
            ul = len(ru) + 1
        elif ru == "*":
            ul = 1
        ul = min(ul, URI_MAX)
    return (hl << HOST_SHIFT) + ul


class HintReference:
    """The scan, with rules of one key (host, port, uri) scored once: a
    key's level is its rules' level, so the earliest rule of the best
    keys is the earliest rule of the best level."""

    def __init__(self, rules: list):
        self.rules = rules
        span = {}
        for i, r in enumerate(rules):
            if r in span:
                span[r][1] = i
            else:
                span[r] = [i, i]
        self.span = span
        self.by_host, self.by_uri = defaultdict(list), defaultdict(list)
        for k in span:
            if k[0] is not None:
                self.by_host[k[0]].append(k)
            if k[2] is not None:
                self.by_uri[k[2]].append(k)

    def candidates(self, q: tuple) -> set:
        """Every key that can score above 0 for q."""
        qh, _qp, qu = q
        names = []
        if qh is not None:
            names += [qh, "*"] + [qh[p + 1:] for p, c in enumerate(qh)
                                  if c == "."]
            out = {k for h in names for k in self.by_host.get(h, ())}
        else:
            out = set()
        if qu is not None:
            for u in [qu[:k] for k in range(len(qu) + 1)] + ["*"]:
                out.update(self.by_uri.get(u, ()))
        return out

    def verdict(self, q: tuple, ties_last: bool = False) -> int:
        """The winning rule's index, -1 for none. ties_last=True is the
        control: the LAST rule among equal levels wins."""
        best, best_lv = -1, 0
        for k in self.candidates(q):
            lv = level(q, k)
            if lv <= 0 or lv < best_lv:
                continue
            i = self.span[k][1] if ties_last else self.span[k][0]
            if lv > best_lv or (i > best if ties_last else i < best):
                best, best_lv = i, lv
        return best

    def key_bytes(self, i: int) -> int:
        """Bytes of rule i's keys (host, uri, port): what a lookup reads
        to confirm it."""
        h, _p, u = self.rules[i]
        return len((h or "").encode()) + len((u or "").encode()) + 2
