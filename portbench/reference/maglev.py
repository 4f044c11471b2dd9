"""Maglev backend picks (Eisenbud et al., NSDI'16) as vproxy_tpu's
consistent-hash contract states them: a prime-size slot table filled by
each backend's (offset, skip) permutation from two FNV-1a 64 hashes of
its identity, backends claiming slots in a weighted subtract-sum turn
order; a flow's slot is FNV-1a 64 of its source address bytes, plus the
source port as two big-endian bytes unless the port is None (source
affinity), modulo the table size.
"""
from __future__ import annotations

import math

import numpy as np

FNV64_OFFSET = 0xCBF29CE484222325
FNV64_PRIME = 0x100000001B3
MASK64 = (1 << 64) - 1
TURN_CAP = 4096


def fnv64(data: bytes) -> int:
    h = FNV64_OFFSET
    for b in data:
        h = ((h ^ b) * FNV64_PRIME) & MASK64
    return h


def flow_key(ip: bytes, port) -> bytes:
    return ip if port is None else ip + bytes((port >> 8 & 0xFF, port & 0xFF))


def turns(weights: list) -> list:
    """The weighted turn order: subtract-sum WRR over gcd-reduced
    weights, renormalised past TURN_CAP turns."""
    if len(set(weights)) == 1:
        return list(range(len(weights)))
    g = 0
    for w in weights:
        g = math.gcd(g, w)
    weights = [w // g for w in weights]
    total = sum(weights)
    if total > TURN_CAP:
        weights = [max(1, (w * TURN_CAP) // total) for w in weights]
        total = sum(weights)
    if total > TURN_CAP:
        return list(range(len(weights)))
    cur = list(weights)
    seq = []
    while True:
        idx = max(range(len(cur)), key=lambda i: (cur[i], -i))
        seq.append(idx)
        cur[idx] -= total
        if all(w == 0 for w in cur):
            return seq
        for i in range(len(cur)):
            cur[i] += weights[i]


def build_table(entries: list, m: int) -> np.ndarray:
    """slot -> backend index, int32 [m]."""
    tab = [-1] * m
    offs = [fnv64(b"o:" + name.encode()) % m for name, _w in entries]
    skips = [fnv64(b"s:" + name.encode()) % (m - 1) + 1 for name, _w in entries]
    order = turns([max(1, int(w)) for _n, w in entries])
    nxt = list(offs)
    filled = 0
    while filled < m:
        for i in order:
            sl = nxt[i]
            while tab[sl] >= 0:
                sl = (sl + skips[i]) % m
            tab[sl] = i
            nxt[i] = (sl + skips[i]) % m
            filled += 1
            if filled >= m:
                break
    return np.asarray(tab, np.int32)


class MaglevReference:
    def __init__(self, entries: list, m: int):
        self.m = m
        self.table = build_table(entries, m)

    def pick(self, ip: bytes, port, affinity_only: bool = False) -> int:
        """The backend of flow (ip, port). affinity_only=True is the
        control: the port is dropped, every flow of an address lands on
        one backend."""
        key = flow_key(ip, None if affinity_only else port)
        return int(self.table[fnv64(key) % self.m])
