"""Seeded generators of the benchmark's tables and query streams.

Frozen copies of `chip_smoke.py`'s generators (`mk_rules`, `mk_queries`,
`mk_ips`, `backends`, `_rand_net`, `acl_rules`), which in turn copy the
fused-path and CIDR tests of `tests/test_fused.py` and
`tests/test_torch_cidr.py`, and the benchmark's own generators in the
originals' mixes: `route_nets` (ordered as RouteTable.addRule keeps a
table, where the original swaps a tenth of its routes out of that
order), and `family_queries` and `acl_ports` (cidr_queries' and
acl_queries' draws with a stated family mix, in bulk). They return plain
data (tuples of str, int and bytes) instead of the program's types, so
the plain reference can read them without importing the program;
`deploy/` turns them into the program's objects. The program may
change; these may not.

Where a traffic mix asks for more than the originals drew (Zipf-drawn
rules, a source port per flow), the extra draws come after the
originals' and are marked as such.

Plain shapes:
* hint rule  (host | None, port, uri | None)
* hint query (host | None, port, uri | None), already formatted
* network    (ip bytes, mask bytes): 4 or 16 bytes each, host bits zero
* ACL rule   (alias, network, min_port, max_port, allow), protocol TCP
"""
from __future__ import annotations

import random

import numpy as np

# ------------------------------------------------------------ hint rules
# origin: chip_smoke.py mk_rules / mk_queries / mk_ips / backends


def mk_rules(n: int, seed: int) -> list:
    """60% exact hosts, 15% host+uri, 10% port-gated hosts, 10% uri
    prefixes, 5% wildcard-host uri rules, in a seeded order."""
    rnd = random.Random(seed)
    out = []
    for i in range(n):
        r = rnd.randrange(20)
        if r < 12:
            out.append((f"svc{i}.ns{i % 997}.example.com", 0, None))
        elif r < 15:
            out.append((f"svc{i}.ns{i % 997}.example.com", 0,
                        f"/api/v{i % 17}"))
        elif r < 17:
            out.append((f"svc{i}.ns{i % 997}.example.com", 443, None))
        elif r < 19:
            out.append((None, 0, f"/static/{i}"))
        else:
            out.append(("*", 0, f"/w{i % 5}"))
    return out


def zipf_ranks(n_items: int, b: int, s: float, rng) -> np.ndarray:
    """b draws of an item index under a Zipf law of exponent s over
    n_items, the ranks shuffled onto items by one seeded permutation
    (added for the benchmark: the originals draw uniformly)."""
    w = np.arange(1, n_items + 1, dtype=np.float64) ** -s
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    ranks = np.searchsorted(cdf, rng.random(b), side="right")
    ranks = np.minimum(ranks, n_items - 1)
    return rng.permutation(n_items)[ranks]


def mk_queries(rules: list, b: int, seed: int, zipf_s: float = 0.0) -> list:
    """b hint queries in mk_queries' four shapes in turn: host,
    "x." + host with an /api uri, host with port 443 or 8443, uri only.
    zipf_s > 0 draws the rule each query aims at under a Zipf law
    (added for the benchmark); 0 draws it uniformly, as the original."""
    rnd = random.Random(seed)
    if zipf_s > 0:
        js = zipf_ranks(len(rules), b, zipf_s,
                        np.random.default_rng(seed)).tolist()
    out = []
    for i in range(b):
        j = js[i] if zipf_s > 0 else rnd.randrange(len(rules))
        host = rules[j][0]
        if host is None or host == "*":
            host = f"nohost{j}.ns.example.com"
        k = i % 4
        if k == 0:
            out.append((host, 0, None))
        elif k == 1:
            out.append(("x." + host, 0, f"/api/v{j % 17}/s"))
        elif k == 2:
            out.append((host, 443 if i % 2 else 8443, None))
        else:
            out.append((None, 0, f"/static/{j}"))
    return out


def mk_ips(n: int, seed: int) -> list:
    rnd = random.Random(seed)
    return [bytes([10 + rnd.randrange(14), rnd.randrange(256),
                   rnd.randrange(256), rnd.randrange(256)])
            for _ in range(n)]


def flow_ports(n: int, seed: int, none_every: int) -> list:
    """A source port per flow, None (source affinity) for every
    none_every-th (added for the benchmark)."""
    rnd = random.Random(seed)
    return [None if none_every and i % none_every == 0
            else rnd.randrange(1024, 65536) for i in range(n)]


def backends(n: int) -> list:
    """(identity, weight) of n backends, weights 1-4 in turn."""
    return [(f"10.{i // 250}.{i % 250}.1:80", 1 + i % 4) for i in range(n)]


# ------------------------------------------------------------ CIDR tables
# origin: chip_smoke.py _rand_net / acl_rules; route_nets, family_queries
# and acl_ports in the mixes of its route_nets, cidr_queries, acl_queries

CIDR_POOL = (10, 44, 100, 172, 192, 203)
V6_MASKS = (8, 16, 24, 32, 48, 64, 96, 112, 128)
ACL_PORTS = (22, 53, 80, 443, 3306, 8080)


def mask_bytes(masklen: int) -> bytes:
    """Network.parseMask: 4 bytes when masklen <= 32, else 16."""
    n = 16 if masklen > 32 else 4
    out = bytearray(n)
    m = masklen
    for i in range(n):
        ones = 8 if m > 8 else max(m, 0)
        out[i] = (0xFF << (8 - ones)) & 0xFF if ones > 0 else 0
        m -= 8
    return bytes(out)


def masklen(net: tuple) -> int:
    return sum(bin(b).count("1") for b in net[1])


def _rand_net(rng, v6: bool, ml: int) -> tuple:
    m = mask_bytes(ml)
    raw = (b"\xfd" + rng.bytes(15)) if v6 else \
        bytes([int(rng.choice(CIDR_POOL))]) + rng.bytes(3)
    return (bytes(a & b for a, b in zip(raw, m)) + bytes(len(raw) - len(m)),
            m)


def _mask_rows(ml: np.ndarray) -> np.ndarray:
    """uint8 [n, 16]: the first ml[k] bits of row k set."""
    return np.packbits(np.arange(128) < ml[:, None], axis=1)


def _effective_len(net: tuple) -> int:
    """The mask's length, a ::v4 or ::ffff:v4 network's less 96."""
    ml = masklen(net)
    return ml - 96 if len(net[1]) == 16 and net[0][:10] == bytes(10) else ml


def route_nets(n: int, seed: int) -> list:
    """n distinct networks in the mix of chip_smoke.py's route_nets: v4
    /0-/32 (most /16-/24) under six first bytes so they nest, 5% v6
    under fd00::/8, 1% over ::v4 and ::ffff:v4. Drawn in bulk (not the
    original's draws) and ordered as vswitch's RouteTable.addRule keeps
    a table: the more specific of two overlapping routes first, so the
    first route that holds an address is its longest prefix. Equal
    lengths keep the order drawn."""
    rng = np.random.default_rng(seed)
    w = np.array([0.0005] + [0.002] * 7 + [0.02] * 8 + [0.08] * 9 +
                 [0.015] * 8)
    w /= w.sum()
    pool = np.array(CIDR_POOL, np.uint8)
    nets, seen = [], set()
    while len(nets) < n:
        m = 2 * (n - len(nets)) + 64
        kind = rng.random(m)
        v6, mapped = kind < 0.05, (kind >= 0.05) & (kind < 0.06)
        ml = np.where(v6, rng.choice(V6_MASKS, size=m),
                      np.where(mapped, rng.integers(112, 129, size=m),
                               rng.choice(33, size=m, p=w)))
        raw = rng.integers(0, 256, size=(m, 16), dtype=np.uint8)
        first = rng.choice(pool, size=m)
        ffff = np.where(rng.random(m) < 0.5, 0xFF, 0).astype(np.uint8)
        raw[v6, 0] = 0xFD
        raw[mapped, :10] = 0
        raw[mapped, 10] = ffff[mapped]
        raw[mapped, 11] = ffff[mapped]
        raw[mapped, 12] = first[mapped]
        v4 = ~(v6 | mapped)
        raw[v4, 0] = first[v4]
        mask = _mask_rows(ml)
        ip = raw & mask
        ip_len = np.where(v4, 4, 16)
        m_len = np.where(ml > 32, 16, 4)
        for k in range(m):
            net = (ip[k, :ip_len[k]].tobytes(), mask[k, :m_len[k]].tobytes())
            if net not in seen:
                seen.add(net)
                nets.append(net)
                if len(nets) == n:
                    break
    nets.sort(key=lambda net: -_effective_len(net))
    return nets


def acl_rules(n: int, seed: int) -> list:
    """n TCP rules over nested networks (v4 /8-/32, 5% v6), a fifth on
    an earlier rule's network with another port range; single ports,
    spans or 0-65535; allow or deny at random; no two equivalent."""
    rng = np.random.default_rng(seed)
    mls, mp = (8, 12, 16, 20, 24, 28, 32), \
        (0.02, 0.05, 0.2, 0.2, 0.3, 0.13, 0.1)
    out, seen = [], set()
    while len(out) < n:
        if out and rng.random() < 0.2:
            net = out[int(rng.integers(len(out)))][1]
        elif rng.random() < 0.05:
            net = _rand_net(rng, True, int(rng.choice(V6_MASKS)))
        else:
            net = _rand_net(rng, False, int(rng.choice(mls, p=mp)))
        r = rng.random()
        if r < 0.3:
            lo = hi = int(rng.choice(ACL_PORTS))
        elif r < 0.8:
            lo = int(rng.integers(0, 60000))
            hi = lo + int(rng.integers(0, 5000))
        else:
            lo, hi = 0, 65535
        if (net, lo, hi) in seen:
            continue
        seen.add((net, lo, hi))
        out.append((f"acl{len(out)}", net, lo, hi, bool(rng.random() < 0.5)))
    return out


def _net_rows(nets: list) -> tuple:
    """(ip, mask, ip length) of each network: uint8 [n, 16] each, the
    mask zero past its own bytes, and int [n]."""
    n = len(nets)
    ip = np.zeros((n, 16), np.uint8)
    mask = np.zeros((n, 16), np.uint8)
    for k, (a, m) in enumerate(nets):
        ip[k, :len(a)] = np.frombuffer(a, np.uint8)
        mask[k, :len(m)] = np.frombuffer(m, np.uint8)
    return ip, mask, np.array([len(a) for a, _m in nets])


MAPPED = bytes(10) + b"\xff\xff"


def family_queries(nets: list, b: int, seed: int, v4: float, v6: float,
                   mapped: float, random_every: int) -> list:
    """chip_smoke.py's cidr_queries with a stated family mix, drawn in
    bulk (added for the benchmark): of the aimed addresses a share v4 (4
    bytes, under a v4 network), v6 (16 bytes, under a 16-byte network)
    and mapped (::ffff:a.b.c.d under a v4 network), each a random
    network's address with random host bits; every random_every-th a
    random address, v4 or fd00::/8 v6 in turn (v4 only where v6 and
    mapped are 0), mostly unmatched. -> [(addr, index aimed at, or -1)]."""
    rng = np.random.default_rng(seed)
    ip, mask, ln = _net_rows(nets)
    fam4, fam6 = np.flatnonzero(ln == 4), np.flatnonzero(ln == 16)
    cut = np.cumsum([v4, v6, mapped]) / (v4 + v6 + mapped)
    only4 = v6 == 0 and mapped == 0
    f = np.minimum(np.searchsorted(cut, rng.random(b), side="right"), 2)
    j = fam4[rng.integers(len(fam4), size=b)]
    if len(fam6):
        j = np.where(f == 1, fam6[rng.integers(len(fam6), size=b)], j)
    host = rng.integers(0, 256, size=(b, 16), dtype=np.uint8)
    addr = (ip[j] & mask[j]) | (host & ~mask[j])
    out = []
    for i in range(b):
        if random_every and i % random_every == random_every - 1:
            six = not only4 and (i // random_every) % 2 == 1
            out.append((b"\xfd" + host[i, 1:].tobytes() if six
                        else host[i, :4].tobytes(), -1))
            continue
        k = int(j[i])
        a = addr[i, :ln[k]].tobytes()
        out.append((MAPPED + a if f[i] == 2 and ln[k] == 4 else a, k))
    return out


def acl_ports(rules: list, aimed: list, seed: int) -> list:
    """chip_smoke.py's acl_queries' ports, drawn in bulk: for an address
    aimed at a rule, at or around that rule's range (min, max, min - 1,
    max + 1) or random, a fifth each; random for the others."""
    rng = np.random.default_rng(seed + 1)
    b = len(aimed)
    k = rng.integers(5, size=b)
    anyport = rng.integers(0, 65536, size=b)
    j = np.array([x[1] for x in aimed])
    jj = np.maximum(j, 0)
    lo = np.array([r[2] for r in rules])[jj]
    hi = np.array([r[3] for r in rules])[jj]
    near = np.stack([lo, hi, lo - 1, hi + 1], 1)[np.arange(b),
                                                 np.minimum(k, 3)]
    p = np.where((j < 0) | (k == 4), anyport, near)
    return np.clip(p, 0, 65535).tolist()
