"""Chip smoke test: the torch port's classify serving paths on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout's sources (the fused
classify+pick kernel B1, with its route column, and the CIDR kernel
B4), holds them bit for bit against their plain torch tiers, serves
hint and classify+pick bursts through ClassifyService over a 100k-rule
Host/SNI/URI table and a 65,537-slot Maglev table over 256 weighted
backends, and again for TLS connections accepted on the port's own
event loop, ACL checks through a SecurityGroup of 5,000 TCP rules and
route lookups against a 50,000-route table (BASELINE config #4, not
cut), times the kernels, and prints one JSON line per result. Phases,
in order:

1. environment: a CUDA device, or exit 1; the card's name and power
   limit as nvidia-smi reports them;
2. build: nvcc of csrc/fused_classify_pick.cu and csrc/cidr_first.cu,
   and g++ of the port's native/vtl.cpp (the host FD layer; it must
   load as the native provider, from vproxy_tpu_torch/_build/), all
   started together, with their seconds, and per kernel instance (B1:
   uri or uri-free, compare word; B4: one) ptxas's registers and
   spills (any spill fails) and its global loads and asynchronous
   copies in the SASS (cuobjdump, kept beside the library as
   <lib>.sass);
3. kernel vs plain tier, int32-exact, on identical device tensors: 100k
   rules with uri rules, 100k host-only rules (the uri-free kernel), a
   few hundred rules at r_cap 600,000 (the plain tier's two-pass
   reduction), the CPU parity cases long_hosts (host window 65: 1-byte
   words), shared_keys and random_300_b600, wide_buckets (more live
   candidates per query than the kernel lists at once), and the
   boundary sets at every compare word, each with and without its uri
   rules;
4. service: 4 bursts of 512 submit_classify_pick requests through a
   FusedPair and 4 of 512 submit_hint requests, every answer equal to
   the host index (HintIndex + maglev.pick), no failover, every query
   answered by the device, one kernel launch per classify+pick batch;
5. event plane: one of the port's SelectorEventLoops accepts 4 bursts
   of 512 loopback connections (512 open at once, one client thread
   each, the threads in a spawned process so they do not share the
   loop's interpreter lock) through a ServerSock on the native vtl;
   each client writes a real TLS ClientHello (stdlib ssl), the loop
   peeks it, parses its SNI and submits classify+pick to
   ClassifyService over phase 4's FusedPair; the answer comes back on
   the loop thread, which closes the connection. Every (verdict, pick) equal to the host index and
   Maglev's host pick, every matched pick equal to the C lookup the
   accept lanes run (vtl_maglev_pick), no failover, every query
   answered by the device, one B1 launch per batch, every callback on
   the loop thread; prints connections, batches, mean and max batch,
   B1 launches, accept->delivery p50/p99 (us, on the loop thread's
   monotonic clock) split at the submit, and the service's
   submit->delivery percentiles, with the card's line;
6. CIDR kernel vs plain tier, int32-exact: B4 on the 50k route table
   and the 5k ACL at B = 16 / 512 / 4096 (v4, ::v4, ::ffff:v4 and v6
   queries, an eighth of each batch pad rows, the ACL with its ports
   and with port=None), on the CPU parity sets of
   tests/test_torch_cidr.py (v6_many_masks takes the routine's probe
   loop past one round, acl_deep_buckets its entry list past one
   window, or the phase fails), and on tables cut short where the
   reference clamps; per case, what the routine's design depends on
   (cidr_design: live pairs and bucket entries per query, probe rounds
   and entry windows); B1's [B, 3] form against the 3-column plain
   tier on the 100k hint table + the 50k routes, and on an ACL with
   ports;
7. CIDR service: the SecurityGroup answers allow_async for 4 x 512
   (address, port) pairs, and a 50k-route CidrMatcher answers 4 x 512
   submit_cidr(port=None), one burst mixed with port-carrying queries;
   every answer equal to CidrIndex.lookup and the linear oracle_snap,
   one B4 launch per cidr batch, no failover, every query answered by
   the device; then 4 fused_dispatch_all batches of 512 (verdict, pick
   and route in one B1 launch each), every column equal to the host
   index;
8. times at B = 16, 512, 4096: the kernel's and the plain tier's device
   time per call (profiler) with the 22.7 MB table L2-warm, as under
   steady serving; the kernel's device time with L2 flushed before each
   launch (cold: every table byte comes from HBM); wall time per call
   back to back (CUDA events, host launch cost included), for the
   published table (checked once) and for a plain dict (checked every
   call); and the least time the card could take (bytes this batch
   must move over the 3.35 TB/s HBM rate, or its integer operations
   over the INT32 rate, whichever is larger). The bound is an HBM
   bound, read against the cold time; the warm time, served from L2,
   may beat it; then the warm kernel time alone at B = 512 to 8192, to
   show where it stops being set by one query's chain of loads;
9. the same times for B4 (route table, ACL) and for B1 with its route
   column, each row with its batch's cidr_design, and where one cidr
   batch of 512 spends its host time
   (address encode, upload, wrapper call with the kernel, the whole
   CidrMatcher.match round trip);
10. the {"kernels": [...]} line (B1, B1 with the route column, B4),
   then the card's line, then the device line.

Any failed phase raises, and the script exits non-zero.
"""
from __future__ import annotations

import json
import os
import random
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N_RULES = 100_000
SERVICE_BATCH = 512
BURSTS = 4
TIME_BATCHES = (16, 512, 4096)
SWEEP_BATCHES = (1024, 2048, 8192)  # warm kernel time only: how it scales
MAGLEV_M = 65_537
BACKENDS = 256
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
INT_OPS_PER_S = 132 * 64 * 1.98e9  # INT32 lanes per SM x SMs x boost clock

REPLACES = "vproxy_tpu/ops/fused_pallas.py:56"
KERNEL = "fused_kernel"  # the kernel's name, as the profiler lists it
SOURCE = "vproxy_tpu_torch/csrc/fused_classify_pick.cu"
# the CIDR half (BASELINE config #4: a 50k-route LPM table + 5k ACL)
N_ROUTES = 50_000
N_ACL = 5_000
ROUTE_SEED, ACL_SEED = 41, 42
REPLACES_B4 = "vproxy_tpu/ops/hashmatch.py:723"
KERNEL_B4 = "cidr_first_kernel"
SOURCE_B4 = "vproxy_tpu_torch/csrc/cidr_first.cu"
# B1's route column is B1's kernel; its contract is the 3-column form
REPLACES_ROUTE = "vproxy_tpu/ops/fused.py:304"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke failed: {what}")


# ------------------------------------------------------------ workload
# The rule and query generators of the reference's fused-path tests: a
# mix of exact hosts, host+uri prefixes, port-gated hosts, pure uri
# prefixes and wildcard-host uri rules.

def mk_rules(n, seed=11):
    from vproxy_tpu_torch.rules.ir import HintRule
    rnd = random.Random(seed)
    out = []
    for i in range(n):
        r = rnd.randrange(20)
        if r < 12:
            out.append(HintRule(host=f"svc{i}.ns{i % 997}.example.com"))
        elif r < 15:
            out.append(HintRule(host=f"svc{i}.ns{i % 997}.example.com",
                                uri=f"/api/v{i % 17}"))
        elif r < 17:
            out.append(HintRule(host=f"svc{i}.ns{i % 997}.example.com",
                                port=443))
        elif r < 19:
            out.append(HintRule(uri=f"/static/{i}"))
        else:
            out.append(HintRule(host="*", uri=f"/w{i % 5}"))
    return out


def mk_host_rules(n):
    """Host-only rules (exact, port-gated, one wildcard): a table with
    no uri rule packs without the uri half."""
    from vproxy_tpu_torch.rules.ir import HintRule
    out = [HintRule(host=f"svc{i}.ns{i % 997}.example.com",
                    port=443 if i % 7 == 0 else 0) for i in range(n - 1)]
    return out + [HintRule(host="*")]


def mk_queries(rules, b, seed=7):
    from vproxy_tpu_torch.rules.ir import Hint
    rnd = random.Random(seed)
    hints = []
    for i in range(b):
        j = rnd.randrange(len(rules))
        host = rules[j].host
        if host is None or host == "*":
            host = f"nohost{j}.ns.example.com"
        k = i % 4
        if k == 0:
            hints.append(Hint.of_host(host))
        elif k == 1:
            hints.append(Hint.of_host_uri("x." + host, f"/api/v{j % 17}/s"))
        elif k == 2:
            hints.append(Hint.of_host_port(host, 443 if i % 2 else 8443))
        else:
            hints.append(Hint(uri=f"/static/{j}"))
    return hints


# The rule sets of the port's CPU parity cases (tests/test_torch_host.py,
# tests/test_torch_kernels.py), carried here because tests/ is not part
# of what this script may import; tier-1 holds these copies equal to
# those.

WORDS = ["a", "bb", "ccc", "x", "api", "web", "cdn", "img", "v2", "svc"]
TLDS = ["com", "net", "io", "local"]


def rand_rules(n, seed):
    """The reference hashmatch tests' rule mix: hosts, wildcards, uri
    prefixes, ports, shared keys."""
    from vproxy_tpu_torch.rules.ir import HintRule
    rnd = random.Random(seed)

    def dom():
        return ".".join(rnd.choice(WORDS) for _ in range(rnd.randint(1, 3))) \
            + "." + rnd.choice(TLDS)

    def uri():
        return "/" + "/".join(rnd.choice(WORDS)
                              for _ in range(rnd.randint(1, 4)))

    out = []
    for _ in range(n):
        host = u = None
        port = 0
        while host is None and u is None and port == 0:
            if rnd.random() < 0.7:
                host = "*" if rnd.random() < 0.1 else dom()
            if rnd.random() < 0.5:
                u = "*" if rnd.random() < 0.1 else uri()
            if rnd.random() < 0.3:
                port = rnd.choice([80, 443, 8080])
        out.append(HintRule(host=host, port=port, uri=u))
    return out


def rand_hints(rules, n, seed):
    from vproxy_tpu_torch.rules.ir import Hint, HintRule
    rnd = random.Random(seed)
    out = []
    for i in range(n):
        r = rules[rnd.randrange(len(rules))] if rules else HintRule()
        host = r.host if r.host not in (None, "*") else f"h{i}.io"
        if rnd.random() < 0.4:
            host = rnd.choice(WORDS) + "." + host
        u = (r.uri if r.uri not in (None, "*") else "/a") + \
            rnd.choice(["", "/x", "yz"])
        out.append(Hint(host=host if rnd.random() < 0.85 else None,
                        port=rnd.choice([0, 80, 443, 8080]),
                        uri=u if rnd.random() < 0.6 else None))
    return out


def shared_keys():
    """Rules sharing host and uri keys, and the queries that split them.
    -> (rules, hints)."""
    from vproxy_tpu_torch.rules.ir import Hint, HintRule
    rules = [HintRule(host="a.com", uri="/x"),
             HintRule(host="a.com", uri="/xy"), HintRule(host="a.com"),
             HintRule(host="a.com", port=443),
             HintRule(host="a.com", uri="/xy"), HintRule(host="com"),
             HintRule(host="*", uri="/x"), HintRule(uri="/xy"),
             HintRule(uri="*")]
    return rules, [
        Hint(host="a.com", uri="/xyz"), Hint(host="a.com", uri="/xy"),
        Hint(host="a.com"), Hint(host="a.com", port=443),
        Hint(host="a.com", port=8080), Hint(host="b.a.com", uri="/x"),
        Hint(host="z.com"), Hint(uri="/xyq"), Hint(uri="/zzz"),
        Hint(host="*"), Hint(host="q.*"), Hint(uri="*")]


def long_hosts():
    """Two hosts of 64 and 32 bytes (host window hw = 65). -> (rules,
    hints)."""
    from vproxy_tpu_torch.rules.ir import Hint, HintRule
    h64 = "a" * 31 + "." + "b" * 32
    return [HintRule(host=h64), HintRule(host="b" * 32)], [
        Hint(host=h64), Hint(host="x." + h64), Hint(host="q" + h64)]


def wide_buckets():
    """More live candidates per query than the kernel lists at once
    (128): one host bucket of 200 rules (distinct uris survive the
    bucket pruning), 150 wildcard-host rules and port-gated uri rules.
    -> (rules, hints)."""
    from vproxy_tpu_torch.rules.ir import Hint, HintRule
    rules = [HintRule(host="a.example.com", uri=f"/p{i}") for i in range(200)]
    rules += [HintRule(host="*", uri=f"/w{i}") for i in range(150)]
    rules += [HintRule(uri=f"/p{i}", port=443) for i in range(0, 200, 3)]
    hints = [Hint(host="a.example.com", uri=f"/p{i}/x", port=(0, 443)[i % 2])
             for i in range(0, 200, 7)]
    hints += [Hint(host="b.a.example.com", uri=f"/w{i}") for i in range(0, 150, 11)]
    hints += [Hint(host="zz.com", uri="/p3", port=443), Hint(uri="/p1")]
    return rules, hints


BOUNDARY_HOSTS = (7, 8, 15, 16, 17, 31, 32, 33, 64)
BOUNDARY_URIS = (7, 8, 15, 16, 17, 128)
# The boundary set per compare word of the kernel: the whole set (hw 65:
# 1-byte words), and cuts of it whose windows split into 16-, 8- and
# 4-byte words (the last through compile caps, as a caps-reusing update
# compile could give). -> (host lengths, uri lengths, caps)
BOUNDARY_SETS = {
    "boundary": (BOUNDARY_HOSTS, BOUNDARY_URIS, None),
    "boundary_w16": (BOUNDARY_HOSTS[:-1], BOUNDARY_URIS, None),
    "boundary_w8": ((7,), (7, 8), None),
    "boundary_w4": ((7, 8, 15), (7, 8, 15, 16, 17), {"hw": 20, "uw": 36}),
}
# each set as it is (the uri instance) and cut to its host-only rules
# (the uri-free instance)
BOUNDARY_CASES = tuple(n + s for n in BOUNDARY_SETS for s in ("", "_hosts"))


def boundary(name="boundary"):
    """Rules and queries at the edges of the kernel's word-wide masked
    compares. Host h_L is L bytes ("hh...h.com"), so shorter hosts are
    byte prefixes of longer ones in the reversed compare order; uri u_M
    is M bytes ("/uu...u"), each a prefix of the longer ones. Rules:
    every host and uri alone, port-gated copies, host+uri pairs, a
    suffix parent ("com"), every uri under a wildcard host and every
    host under a wildcard uri (so every query reaches every row's
    compare). Queries, for every host and every uri: equal to a rule;
    one byte short; one byte longer (a '.' at the host's boundary);
    differing only in the last compared byte; a subdomain or a longer
    path; alone and beside the other half of a host+uri rule, with
    ports 0, 443 and 8443 in turn; and four that match nothing. A name
    ending in "_hosts" keeps only the rules without a uri.
    -> (rules, hints, caps)."""
    from vproxy_tpu_torch.rules.ir import Hint, HintRule
    hls, uls, caps = BOUNDARY_SETS[name.removesuffix("_hosts")]
    host = ["h" * (n - 4) + ".com" for n in hls]
    uri = ["/" + "u" * (n - 1) for n in uls]
    pairs = list(zip(host, uri * len(host)))
    rules = [HintRule(host=h, port=443) for h in host]
    rules += [HintRule(uri=u, port=8443) for u in uri]
    rules += [HintRule(host=h) for h in host]
    rules += [HintRule(uri=u) for u in uri]
    rules += [HintRule(host=h, uri=u) for h, u in pairs]
    rules += [HintRule(host="com")]
    rules += [HintRule(host="*", uri=u) for u in uri]
    rules += [HintRule(host=h, uri="*") for h in host]

    def hvar(h):
        return [h, h[1:], "." + h, chr(ord(h[0]) + 1) + h[1:], "x." + h]

    def uvar(u):
        return [u, u[:-1], u + ".", u[:-1] + chr(ord(u[-1]) + 1), u + "/r"]

    qs = [(h, None) for h0 in host for h in hvar(h0)]
    qs += [(None, u) for u0 in uri for u in uvar(u0)]
    for h0, u0 in pairs:
        qs += [(h, u0 + "/r") for h in hvar(h0)]
        qs += [(h0, u) for u in uvar(u0)]
    qs += [("h" * 10 + ".net", None), (None, "/v"), ("hhh.con", "/x"),
           (None, None)]  # no match
    hints = [Hint(host=h, uri=u, port=(0, 443, 8443)[i % 3])
             for i, (h, u) in enumerate(qs)]
    if name.endswith("_hosts"):
        rules = [r for r in rules if r.uri is None]
    return rules, hints, caps


def mk_ips(n, seed=5):
    rnd = random.Random(seed)
    return [bytes([10 + rnd.randrange(14), rnd.randrange(256),
                   rnd.randrange(256), rnd.randrange(256)])
            for _ in range(n)]


def backends():
    return [(f"10.{i // 250}.{i % 250}.1:80", 1 + i % 4)
            for i in range(BACKENDS)]


# The CIDR generators of tests/test_torch_cidr.py (the same copies
# rule, held equal by tier-1): routes, ACL rules, queries, the
# reference's small cases and the clamp cuts.

CIDR_POOL = (10, 44, 100, 172, 192, 203)  # first bytes v4 networks nest under
V6_MASKS = (8, 16, 24, 32, 48, 64, 96, 112, 128)


def _rand_net(rng, v6: bool, ml: int):
    """A random network of prefix length ml: v4 under a CIDR_POOL first
    byte, v6 under fd00::/8 (with a 4-byte mask at /<=32, so the bytes
    past the first 4 are zero)."""
    from vproxy_tpu_torch.utils.ip import Network, mask_bytes
    m = mask_bytes(ml)
    raw = (b"\xfd" + rng.bytes(15)) if v6 else \
        bytes([int(rng.choice(CIDR_POOL))]) + rng.bytes(3)
    return Network(bytes(a & b for a, b in zip(raw, m)) +
                   bytes(len(raw) - len(m)), m)


def _mapped_net(rng, ml: int):
    """A v6 network over the v4-compatible (::a.b.c.d) or v4-mapped
    (::ffff:a.b.c.d) range, /112-/128 (a v4 /16-/32): the V4 family
    matches it too."""
    from vproxy_tpu_torch.utils.ip import Network, mask_bytes
    m = mask_bytes(ml)
    raw = bytes(10) + (b"\xff\xff" if rng.random() < 0.5 else bytes(2)) + \
        bytes([int(rng.choice(CIDR_POOL))]) + rng.bytes(3)
    return Network(bytes(a & b for a, b in zip(raw, m)), m)


def route_nets(n: int, seed: int) -> list:
    """A route table of n distinct networks: v4 prefixes over /0-/32,
    most at /16-/24, all under six first bytes so they nest; 5% v6
    under fd00::/8, /<=32 (4-byte masks) among them; 1% over ::v4 and
    ::ffff:v4. Most-specific first, as RouteTable keeps overlapping
    routes, but a tenth of them swapped with one up to 5,000 places
    earlier, so list order decides among overlaps (a ::v4 network sorts
    by its v4 prefix)."""
    rng = np.random.default_rng(seed)
    w = np.array([0.0005] + [0.002] * 7 + [0.02] * 8 + [0.08] * 9 +
                 [0.015] * 8)
    w /= w.sum()
    nets, seen = [], set()
    while len(nets) < n:
        kind = rng.random()
        if kind < 0.05:
            net = _rand_net(rng, True, int(rng.choice(V6_MASKS)))
        elif kind < 0.06:
            net = _mapped_net(rng, int(rng.integers(112, 129)))
        else:
            net = _rand_net(rng, False, int(rng.choice(33, p=w)))
        if net not in seen:
            seen.add(net)
            nets.append(net)
    nets.sort(key=lambda net: -(net.masklen - 96 if len(net.mask) == 16
                                and net.ip[:10] == bytes(10)
                                else net.masklen))
    for j in rng.choice(n, size=n // 10, replace=False):
        k = max(0, int(j) - int(rng.integers(1, 5000)))
        nets[j], nets[k] = nets[k], nets[j]
    return nets


ACL_PORTS = (22, 53, 80, 443, 3306, 8080)


def acl_rules(n: int, seed: int) -> list:
    """A TCP ACL of n rules over nested networks (v4 /8-/32 under the
    pool's first bytes, 5% v6), a fifth of them on an earlier rule's
    network with another port range; ranges are single ports, spans or
    0-65535; allow and deny at random. No two rules are equivalent
    (SecurityGroup refuses those)."""
    from vproxy_tpu_torch.rules.ir import AclRule, Proto
    rng = np.random.default_rng(seed)
    mls, mp = (8, 12, 16, 20, 24, 28, 32), \
        (0.02, 0.05, 0.2, 0.2, 0.3, 0.13, 0.1)
    out, seen = [], set()
    while len(out) < n:
        if out and rng.random() < 0.2:
            net = out[int(rng.integers(len(out)))].network
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
        out.append(AclRule(f"acl{len(out)}", net, Proto.TCP, lo, hi,
                           bool(rng.random() < 0.5)))
    return out


def cidr_queries(nets: list, b: int, seed: int) -> list:
    """b addresses aimed at `nets`: a random network's address with
    random host bits — as v4, ::v4 and ::ffff:v4 in turn for a v4
    network, as v6 for a v6 one — and every 8th a random v4 or v6
    address. -> [(addr, index of the network aimed at, or -1)]."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(b):
        if i % 8 == 7:
            out.append((rng.bytes(4) if i % 16 == 7 else
                        b"\xfd" + rng.bytes(15), -1))
            continue
        j = int(rng.integers(len(nets)))
        net = nets[j]
        m = net.mask + bytes(len(net.ip) - len(net.mask))
        host = rng.bytes(len(net.ip))
        a = bytes((x & y) | (h & ~y & 0xFF)
                  for x, y, h in zip(net.ip, m, host))
        if len(a) == 4 and i % 3 == 1:
            a = bytes(12) + a
        elif len(a) == 4 and i % 3 == 2:
            a = bytes(10) + b"\xff\xff" + a
        out.append((a, j))
    return out


def acl_queries(rules: list, b: int, seed: int) -> list:
    """cidr_queries over the rules' networks, each with a port at or
    around its rule's range (min, max, min - 1, max + 1) or a random
    one. -> [(addr, port)]."""
    rng = np.random.default_rng(seed + 1)
    out = []
    for a, j in cidr_queries([r.network for r in rules], b, seed):
        k = int(rng.integers(5))
        if j < 0 or k == 4:
            p = int(rng.integers(0, 65536))
        else:
            r = rules[j]
            p = (r.min_port, r.max_port, r.min_port - 1, r.max_port + 1)[k]
        out.append((a, min(65535, max(0, p))))
    return out


def hashmatch_route_case(seed=1234):
    """tests/test_hashmatch.py's route parity set: up to 200 v4 routes
    of /0-/32 in RouteTable order, and 400 addresses. -> (nets, addrs)"""
    from vproxy_tpu_torch.rules.ir import RouteRule, RouteTable
    from vproxy_tpu_torch.utils.ip import Network, mask_bytes
    rnd = random.Random(seed)
    rt = RouteTable()
    for i in range(200):
        ml = rnd.choice([0, 8, 12, 16, 24, 32])
        ip = bytes([10 + i % 5, rnd.randint(0, 255), rnd.randint(0, 255), 0])
        m = mask_bytes(ml)
        net = Network(bytes(a & b for a, b in zip(ip, m)), m)
        try:
            rt.add(RouteRule(f"r{i}", net))
        except ValueError:
            continue
    addrs = [bytes([10 + rnd.randint(0, 6), rnd.randint(0, 255),
                    rnd.randint(0, 255), rnd.randint(0, 255)])
             for _ in range(400)]
    return [r.rule for r in rt.rules], addrs


def acl_port_buckets():
    """tests/test_hashmatch.py's ACL case: one network, three port
    ranges in one bucket, and a /0 behind them. -> (acl, [(addr,
    port)])"""
    from vproxy_tpu_torch.rules.ir import AclRule, Proto
    from vproxy_tpu_torch.utils.ip import Network, mask_bytes, parse_ip
    net = Network(parse_ip("10.1.0.0"), mask_bytes(16))
    acl = [AclRule("a", net, Proto.TCP, 80, 80, False),
           AclRule("b", net, Proto.TCP, 0, 1000, True),
           AclRule("c", net, Proto.TCP, 0, 65535, False),
           AclRule("d", Network(parse_ip("0.0.0.0"), mask_bytes(0)),
                   Proto.TCP, 0, 65535, True)]
    addrs = [parse_ip("10.1.2.3")] * 4 + [parse_ip("9.9.9.9")]
    return acl, list(zip(addrs, [80, 443, 2000, 65535, 80]))


def mixed_families():
    """tests/test_hashmatch.py's family case: a v4 /16 matched by v4,
    ::v4 and ::ffff:v4 queries, a v6 /8 (a 4-byte mask). -> (nets,
    addrs)"""
    from vproxy_tpu_torch.utils.ip import Network, mask_bytes, parse_ip
    nets = [Network(parse_ip("192.168.0.0"), mask_bytes(16)),
            Network(parse_ip("fd00::"), mask_bytes(8))]
    addrs = [parse_ip("192.168.3.4"), parse_ip("::192.168.3.4"),
             parse_ip("::ffff:192.168.3.4"), parse_ip("fd00::1"),
             parse_ip("192.169.0.1")]
    return nets, addrs


def _prefix_net(raw: bytes, ml: int):
    """The network of prefix length ml over the address bytes raw (a
    4-byte mask at /<=32, as _rand_net makes them)."""
    from vproxy_tpu_torch.utils.ip import Network, mask_bytes
    m = mask_bytes(ml)
    return Network(bytes(a & b for a, b in zip(raw, m)) +
                   bytes(len(raw) - len(m)), m)


def _under(rng, raw: bytes, ml: int) -> bytes:
    """An address with the first ml bits of raw and random bits after."""
    nbits = 8 * len(raw)
    keep = ((1 << ml) - 1) << (nbits - ml)
    a = int.from_bytes(raw, "big") & keep
    r = int.from_bytes(rng.bytes(len(raw)), "big") & ~keep
    return (a | r).to_bytes(len(raw), "big")


def _v4_form(a: bytes, k: int) -> bytes:
    """A 4-byte address as itself, ::v4 or ::ffff:v4, by k mod 3."""
    return (a, bytes(12) + a, bytes(10) + b"\xff\xff" + a)[k % 3]


def v6_many_masks(seed: int = 21):
    """v4 routes at every prefix length /0-/32 (each also in the v6
    groups, as ::v4 and ::ffff:v4) and v6 routes at most lengths
    /1-/128, nested under three addresses of each family, in random
    order; 400 addresses under the nests at every depth (v4 ones as v4,
    ::v4 and ::ffff:v4 in turn), every 8th random. A 16-byte query
    probes every v6 group: more than 128 (group, salt) pairs. -> (nets,
    addrs)"""
    rng = np.random.default_rng(seed)
    v4 = [bytes([int(rng.choice(CIDR_POOL))]) + rng.bytes(3)
          for _ in range(3)]
    v6 = [b"\xfd" + rng.bytes(15) for _ in range(3)]
    nets = [_prefix_net(v4[int(rng.integers(3))], ml) for ml in range(33)]
    nets += [_prefix_net(v6[int(rng.integers(3))], ml)
             for ml in range(1, 129) if rng.random() < 0.8]
    nets = [nets[int(i)] for i in rng.permutation(len(nets))]
    addrs = []
    for i in range(400):
        if i % 8 == 7:
            addrs.append(rng.bytes(4) if i % 16 == 7 else
                         b"\xfd" + rng.bytes(15))
        elif i % 2:
            addrs.append(_under(rng, v6[i % 3], int(rng.integers(129))))
        else:
            addrs.append(_v4_form(
                _under(rng, v4[i % 3], int(rng.integers(33))), i // 2))
    return nets, addrs


def acl_deep_buckets(seed: int = 23):
    """TCP ACL rules stacked on two nests of six networks (v4 /8-/28 and
    v6 /32-/112 over one address each), 20-30 rules per network with
    port ranges disjoint within a network and overlapping across them,
    in random order; 300 queries under the nests at every depth (v4
    ones as v4, ::v4 and ::ffff:v4 in turn), each with a port inside
    the range of a rule above it, or, every 5th, past every range (no
    rule admits it). A query under a nest's deepest network matches all
    six of its buckets: more than 128 entries. -> (acl, [(addr,
    port)])"""
    from vproxy_tpu_torch.rules.ir import AclRule, Proto
    rng = np.random.default_rng(seed)
    nests = ((bytes([int(rng.choice(CIDR_POOL))]) + rng.bytes(3),
              (8, 12, 16, 20, 24, 28)),
             (b"\xfd" + rng.bytes(15), (32, 48, 64, 80, 96, 112)))
    spec = []
    for n, (raw, mls) in enumerate(nests):
        for ml in mls:
            for k in range(int(rng.integers(20, 31))):
                lo = 2000 * k + int(rng.integers(1000))
                spec.append((n, ml, lo, lo + int(rng.integers(1500))))
    spec = [spec[int(i)] for i in rng.permutation(len(spec))]
    acl = [AclRule(f"deep{i}", _prefix_net(nests[n][0], ml), Proto.TCP,
                   lo, hi, bool(rng.random() < 0.5))
           for i, (n, ml, lo, hi) in enumerate(spec)]
    out = []
    for i in range(300):
        raw, mls = nests[i % 2]
        depth = mls[-1] if rng.random() < 0.6 else int(rng.choice(mls))
        a = _under(rng, raw, depth)
        if len(a) == 4:
            a = _v4_form(a, i // 2)
        if i % 5 == 4:
            port = int(rng.integers(61000, 65536))
        else:
            above = [s for s in spec if s[0] == i % 2 and s[1] <= depth]
            _, _, lo, hi = above[int(rng.integers(len(above)))]
            port = int(rng.integers(lo, hi + 1))
        out.append((a, port))
    return acl, out


def cut_table(ct: dict, how: str) -> dict:
    """A packed cidr table cut short so that indices the reference
    gathers with JAX's clamp run past an array: "bk" (a bucket walk of
    one entry where buckets list more), "items" (bucket entries past
    cb_items), "slots" (group slots past pk_cslot / s_key), "meta" (rule
    indices past pk_cmeta). The kernels must clamp where JAX does."""
    out = dict(ct)
    if how == "bk":
        out["bk_iota"] = ct["bk_iota"][:1]
    elif how == "items":
        out["cb_items"] = ct["cb_items"][: ct["cb_items"].shape[0] // 5]
    elif how == "slots":
        n = ct["pk_cslot"].shape[0] // 3
        out["pk_cslot"], out["s_key"] = ct["pk_cslot"][:n], ct["s_key"][:n]
    else:
        assert how == "meta"
        out["pk_cmeta"] = ct["pk_cmeta"][: ct["pk_cmeta"].shape[0] // 3]
    return out


CUTS = ("bk", "items", "slots", "meta")
CUT_CASES = ("routes_2k", "acl_500", "acl_deep_buckets")  # cut every way


# -------------------------------------------------------------- phases

def phase_env() -> str:
    if not torch.cuda.is_available():
        print("chip smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return smi


def instance(mangled: str) -> str:
    """A kernel's mangled name -> "uri W=16" and the like for
    fused_kernel<URI, W>, "B4" for the CIDR kernel."""
    if KERNEL_B4 in mangled:
        return "B4"
    m = re.search(r"fused_kernelILb([01])ELi(\d+)E", mangled)
    return (f"{'uri' if m.group(1) == '1' else 'uri-free'} W={m.group(2)}"
            if m else mangled)


def _ptxas(lib: str) -> dict:
    """{instance: {registers, spill_stores, spill_loads, ldg, ldgsts}}
    from nvcc's log beside the library and its SASS (cuobjdump, written
    beside it as <lib>.sass): global loads, and asynchronous copies to
    shared memory (cp.async)."""
    from vproxy_tpu_torch.ops import fused_cuda as FC
    kern, name = {}, None
    with open(lib + ".log") as f:
        for line in f.read().splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties"
                          r" for) '?(\w+)", line)
            if m:
                name = instance(m.group(1))
                kern.setdefault(name, {})
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and name:
                kern[name]["spill_stores"] = int(m.group(1))
                kern[name]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                kern[name]["registers"] = int(m.group(1))
    dump = os.path.join(os.path.dirname(FC._nvcc()), "cuobjdump")
    sass = subprocess.run([dump, "-sass", lib], capture_output=True,
                          text=True) if os.access(dump, os.X_OK) else None
    if sass is not None and sass.returncode == 0:
        with open(lib + ".sass", "w") as f:
            f.write(sass.stdout)
        for part in sass.stdout.split("Function : ")[1:]:
            name = instance(part.split()[0])
            kern.setdefault(name, {})["ldg"] = len(
                re.findall(r"\bLDG\b", part))
            kern[name]["ldgsts"] = len(re.findall(r"\bLDGSTS\b", part))
    return kern


def phase_build() -> dict:
    """Both kernel libraries, one nvcc each, and the port's libvtl (g++),
    started together. -> {library: {"build_s": seconds, "instances":
    _ptxas()}}."""
    from vproxy_tpu_torch.ops import cidr_cuda as CC
    from vproxy_tpu_torch.ops import fused_cuda as FC

    def timed(fn):
        t0 = time.monotonic()
        return fn(), time.monotonic() - t0

    with ThreadPoolExecutor(3) as ex:
        futs = {"fused": ex.submit(timed, FC.build),
                "cidr": ex.submit(timed, CC.build),
                "vtl": ex.submit(timed, native_vtl)}
        built = {k: f.result() for k, f in futs.items()}
    vtl, secs = built.pop("vtl")
    log(f"build: libvtl (g++) {secs:.2f} s -> "
        f"{os.path.relpath(vtl.LIB_PATH, os.path.dirname(vtl.BUILD_DIR))}"
        f" from {os.path.relpath(vtl.SOURCE, os.path.dirname(vtl.BUILD_DIR))}"
        f", provider {vtl.PROVIDER}")
    out = {"vtl": {"build_s": secs}}
    for lib_name, want in (("fused", 8), ("cidr", 1)):
        lib, secs = built[lib_name]
        log(f"build: {lib_name} {secs:.2f} s -> {os.path.basename(lib)}")
        kern = _ptxas(lib)
        for name in sorted(kern):
            k = kern[name]
            log(f"  ptxas: {lib_name} {name}: {k.get('registers')} "
                f"registers, {k.get('spill_stores')} B spill stores, "
                f"{k.get('spill_loads')} B spill loads; SASS "
                f"{k.get('ldg')} LDG, {k.get('ldgsts')} LDGSTS")
        if lib_name == "cidr":
            log(f"  B4: {kern.get('B4', {}).get('ldg')} LDG in the SASS "
                f"for a chain of 4 dependent global steps per query "
                f"(cidr_first.cuh: group rows + query, slot records + "
                f"keys, bucket entries, meta rows)")
        check(len(kern) == want and all(k.get("registers") for k in
                                        kern.values()),
              f"ptxas reported {len(kern)} {lib_name} kernel instances, "
              f"want {want}")
        check(all(k.get("spill_stores") == k.get("spill_loads") == 0
                  for k in kern.values()), f"a {lib_name} instance spills")
        out[lib_name] = {"build_s": secs, "instances": kern}
    return out


def packed_case(rules, device, caps=None):
    """-> (compiled table, packed tensors, Maglev column tensor)."""
    from vproxy_tpu_torch.ops import fused as F
    from vproxy_tpu_torch.ops import hashmatch as H
    from vproxy_tpu_torch.rules import maglev as M
    from vproxy_tpu_torch.utils.torchenv import tables_from_reference
    from vproxy_tpu_torch.ops import fused_cuda as FC
    tab = H.compile_hint_hash(rules, caps=caps)
    ht = FC.prepare_table(tables_from_reference(
        F.pack_hint_table(tab.arrays), device))
    mt = M.build_table(backends(), MAGLEV_M)
    mtab = torch.from_numpy(mt).to(device)
    return tab, ht, mtab


def encode(tab, hints, device, seed=7):
    """Query tensors and Maglev slots for `hints` on `device`."""
    from vproxy_tpu_torch.ops import hashmatch as H
    from vproxy_tpu_torch.rules import maglev as M
    from vproxy_tpu_torch.utils.torchenv import tables_from_reference
    b = len(hints)
    q = tables_from_reference(H.encode_hint_queries(hints, tab), device)
    slots = torch.from_numpy(M.flow_slots(
        MAGLEV_M, mk_ips(b, seed), [1024 + i for i in range(b)])).to(device)
    return q, slots


def kernel_cases():
    """-> (name, rules, hints, caps) of each kernel-vs-plain case."""
    for name, rules, caps in (
            ("100k uri", mk_rules(N_RULES), None),
            ("100k host-only", mk_host_rules(N_RULES), None),
            ("few hundred, r_cap 600000", mk_rules(300),
             {"r_cap": 600_000})):
        yield name, rules, mk_queries(rules, SERVICE_BATCH), caps
    for name, gen in (("long_hosts", long_hosts),
                      ("shared_keys", shared_keys),
                      ("wide_buckets", wide_buckets)):
        yield (name, *gen(), None)
    rules = rand_rules(300, 11)
    yield "random_300_b600", rules, rand_hints(rules, 600, 11), None
    for name in BOUNDARY_CASES:
        yield (name, *boundary(name))


def phase_kernel_vs_plain(device):
    """Every kernel_cases() case, int32-exact. -> (max |kernel - plain|,
    the 100k uri table pieces reused by the timing phase)."""
    from vproxy_tpu_torch.ops import fused as F
    from vproxy_tpu_torch.ops import fused_cuda as FC
    from vproxy_tpu_torch.ops.hashmatch import _PACK_I32_MAX
    err = 0
    keep = None
    words = set()
    for name, rules, hints, caps in kernel_cases():
        t0 = time.monotonic()
        tab, ht, mtab = packed_case(rules, device, caps)
        q, slots = encode(tab, hints, device)
        got = FC.fused_classify_pick_cuda(ht, q, mtab, slots)
        ref = F.fused_classify_pick(ht, q, mtab, slots)
        torch.cuda.synchronize()
        d = int((got.long() - ref.long()).abs().max())
        err = max(err, d)
        r_cap = ht["pk_meta"].shape[0]
        words.add((ht.uri, ht.word))
        log(f"kernel vs plain [{name}]: r_cap {r_cap} uri={ht.uri} "
            f"hw {ht.hw} uw {ht.uw} word {ht.word} "
            f"two_pass={r_cap > _PACK_I32_MAX} "
            f"matched {int((ref[:, 0] >= 0).sum())}/{len(hints)} "
            f"max_abs_err {d} ({time.monotonic() - t0:.1f} s)")
        check(torch.equal(got, ref), f"kernel != plain tier [{name}]")
        if keep is None:
            keep = (rules, tab, ht, mtab)
    check(len(words) == 8, f"cases ran {len(words)} of the 8 kernel "
          f"instances: {sorted(words)}")
    return err, keep


def _answers(svc, submit, payloads):
    """Submit one burst and wait for every callback. -> results list."""
    out = [None] * len(payloads)
    done = threading.Event()
    left = [len(payloads)]
    lock = threading.Lock()

    def cb_for(i):
        def cb(*res):
            out[i] = res[:-1]
            with lock:
                left[0] -= 1
                if left[0] == 0:
                    done.set()
        return cb

    for i, p in enumerate(payloads):
        submit(*p, cb_for(i))
    check(done.wait(120), "a burst was not answered within 120 s")
    return out


def phase_service(device, rules):
    """The main path: ClassifyService over a FusedPair. -> (launches of
    the fused kernel during the run, the FusedPair)."""
    from vproxy_tpu_torch.ops import fused_cuda as FC
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules import maglev as M
    from vproxy_tpu_torch.rules import oracle
    from vproxy_tpu_torch.rules.service import ClassifyService
    t0 = time.monotonic()
    hm = E.HintMatcher(rules, backend="torch", device=device)
    mm = M.MaglevMatcher(backends(), m=MAGLEV_M, device=device)
    pair = M.FusedPair(hm, mm)
    log(f"service: tables built in {time.monotonic() - t0:.1f} s "
        f"({hm.published_table_bytes() + mm.published_table_bytes()} "
        f"unfused + {hm.fused_stat()['packed_bytes']} packed bytes)")
    check(E.fused_kernel_name() == "cuda",
          f"fused_kernel_name() is {E.fused_kernel_name()!r}")
    hsnap, msnap = hm.snapshot(), mm.snapshot()
    check(isinstance(hsnap[5], FC.PackedTable),
          "the published packed table was not prepared for the kernel")
    svc = ClassifyService(mode="device")
    n = SERVICE_BATCH * BURSTS
    try:
        FC.fused_classify_pick_cuda.launches = 0
        d0, f0 = svc.stats.dispatches, E.fused_dispatches_total()
        t0 = time.monotonic()
        for k in range(BURSTS):
            hints = mk_queries(rules, SERVICE_BATCH, seed=100 + k)
            ips = mk_ips(SERVICE_BATCH, seed=200 + k)
            ports = [None if i % 3 == 0 else 1024 + i
                     for i in range(SERVICE_BATCH)]
            got = _answers(
                svc, lambda h, ip, port, cb: svc.submit_classify_pick(
                    pair, h, ip, port, cb), list(zip(hints, ips, ports)))
            for i in range(SERVICE_BATCH):
                want = (hm.index_snap(hsnap, hints[i]),
                        M.pick(msnap[0], ips[i], ports[i]))
                check(got[i] == want, f"cpick burst {k} row {i}: "
                      f"{got[i]} != host {want}")
        cpick_s = time.monotonic() - t0
        launches = FC.fused_classify_pick_cuda.launches
        cpick_batches = svc.stats.dispatches - d0
        check(launches == cpick_batches
              == E.fused_dispatches_total() - f0,
              f"kernel launches {launches}, cpick batches "
              f"{cpick_batches}, fused dispatches "
              f"{E.fused_dispatches_total() - f0}")
        t0 = time.monotonic()
        for k in range(BURSTS):
            hints = mk_queries(rules, SERVICE_BATCH, seed=300 + k)
            got = _answers(svc, lambda h, cb: svc.submit_hint(hm, h, cb),
                           [(h,) for h in hints])
            for i, h in enumerate(hints):
                check(got[i] == (hm.index_snap(hsnap, h),),
                      f"hint burst {k} row {i}")
        hint_s = time.monotonic() - t0
        st = svc.stats
        check(st.failovers == 0, f"{st.failovers} device failovers")
        check(st.device_queries == 2 * n and st.oracle_queries == 0,
              f"device answered {st.device_queries} of {2 * n}")
        check(FC.fused_classify_pick_cuda.launches == launches,
              "hint bursts launched the fused kernel")
        # the host index itself against the linear oracle (the
        # reference scan), on a sample
        sample = mk_queries(rules, 32, seed=400)
        for h in sample:
            check(hm.index_snap(hsnap, h) == oracle.search(rules, h),
                  f"host index != linear oracle for {h}")
        log(f"service: {n} cpick in {cpick_batches} batches "
            f"({cpick_s:.2f} s), {n} hint ({hint_s:.2f} s); "
            f"dispatches {st.dispatches} failovers {st.failovers} "
            f"device_queries {st.device_queries} max_batch "
            f"{st.max_batch}; fused kernel launches {launches}")
    finally:
        svc.close()
    return launches, pair


# ------------------------------------------------------ the event plane
# The port's accept path up to the backend connect: a SelectorEventLoop
# accepts loopback connections through the native FD layer, peeks each
# ClientHello (the bytes stay queued), parses its SNI, classifies and
# picks through ClassifyService (one B1 launch per batch) and gets the
# answer back on its own thread, where it closes the connection. The
# accept handler follows vproxy_tpu/components/tcplb.py:1035-1110.

LOOP_CONCURRENCY = 512  # connections open at once (one per client thread)
NOFILE_MIN = 1100       # two fds per open connection, and room besides
LOOPBACK = "127.0.0.1"


def loop_hosts(rules, n: int, seed: int) -> list:
    """SNI hosts drawn from the table's hosts, one in five a host the
    table lacks (the wildcard-host rules answer those), like
    mk_queries' host mix."""
    rnd = random.Random(seed)
    out = []
    for i in range(n):
        j = rnd.randrange(len(rules))
        host = rules[j].host
        if host is None or host == "*" or i % 5 == 4:
            host = f"miss{j}.ns{i % 97}.example.com"
        out.append(host)
    return out


def tls_hellos(hosts) -> list:
    """A real ClientHello per host from stdlib ssl: the first
    do_handshake() of a client SSLObject over MemoryBIOs leaves it in
    the outgoing BIO."""
    import ssl
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    out = []
    for h in hosts:
        inb, outb = ssl.MemoryBIO(), ssl.MemoryBIO()
        obj = ctx.wrap_bio(inb, outb, server_hostname=h)
        try:
            obj.do_handshake()
        except ssl.SSLWantReadError:
            pass
        out.append(outb.read())
    return out


def raise_nofile() -> int:
    """Soft RLIMIT_NOFILE up to the hard limit; -> the soft limit."""
    import resource
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft != hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    return soft if soft != resource.RLIM_INFINITY else 1 << 30


def native_vtl():
    """The port's FD layer, which must be the native provider loaded
    from the library built out of this checkout's native/vtl.cpp into
    vproxy_tpu_torch/_build/ (never the Python pump). -> the module."""
    from vproxy_tpu_torch.net import vtl
    build = os.path.realpath(vtl.BUILD_DIR)
    lib = os.path.realpath(vtl.LIB_PATH or "")
    check(vtl.PROVIDER == "native", f"FD provider is {vtl.PROVIDER!r}")
    check(os.path.dirname(lib) == build and
          build == os.path.realpath(os.path.join(
              os.path.dirname(os.path.abspath(__file__)),
              "vproxy_tpu_torch", "_build")),
          f"libvtl loaded from {lib}, not from {build}")
    return vtl


def _client(port: int, hello: bytes) -> int:
    """One loopback client: connect, write the ClientHello, wait for the
    server to close. -> the client's port."""
    import socket
    s = socket.create_connection((LOOPBACK, port), timeout=60)
    try:
        cport = s.getsockname()[1]
        s.sendall(hello)
        try:
            s.recv(1)  # b"" on FIN; the unread hello makes it an RST
        except ConnectionResetError:
            pass
        return cport
    finally:
        s.close()


_CLIENTS = None  # the client process's thread pool, kept across bursts


def _client_burst(port: int, hellos: list, concurrency: int) -> list:
    """Runs in the client process: one connection per hello, at most
    `concurrency` open at once. -> the clients' ports, in order."""
    global _CLIENTS
    if _CLIENTS is None:
        _CLIENTS = ThreadPoolExecutor(concurrency)
    return list(_CLIENTS.map(lambda h: _client(port, h), hellos))


def phase_loop(device, pair, rules, bursts=BURSTS, burst=SERVICE_BATCH,
               concurrency=LOOP_CONCURRENCY) -> tuple:
    """Bursts of loopback TLS-hello connections through the port's event
    loop, ServerSock and native vtl, classified and picked by
    ClassifyService; every answer is checked against the host index and
    Maglev's host pick, every matched pick against the C lookup the
    accept lanes run. -> (the phase's numbers, its answers as (host,
    client ip, client port, verdict, pick) rows)."""
    import ctypes
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from vproxy_tpu_torch.net.connection import ServerSock
    from vproxy_tpu_torch.net.eventloop import SelectorEventLoop
    from vproxy_tpu_torch.net.sniff import MAX_HELLO, parse_client_hello_sni
    from vproxy_tpu_torch.ops import fused_cuda as FC
    from vproxy_tpu_torch.rules import maglev as M
    from vproxy_tpu_torch.rules.ir import Hint
    from vproxy_tpu_torch.rules.service import ClassifyService
    from vproxy_tpu_torch.utils.ip import parse_ip
    vtl = native_vtl()
    nofile = raise_nofile()
    check(nofile >= NOFILE_MIN, f"RLIMIT_NOFILE {nofile} < {NOFILE_MIN}")
    hm, mm = pair.hm, pair.mm
    hsnap, msnap = hm.snapshot(), mm.snapshot()
    tab = msnap[0]
    # the table converted once, as vtl.maglev_pick converts it per call
    # (65,537 slots: tens of ms a call), then the same C symbol per row
    c_tab = (ctypes.c_int32 * len(tab))(*[int(x) for x in tab])

    def c_pick(ip: bytes, port: int) -> int:
        return int(vtl.LIB.vtl_maglev_pick(c_tab, len(tab), ip, len(ip),
                                           port, 1))

    plan = []
    for k in range(bursts):
        hosts = loop_hosts(rules, burst, seed=500 + k)
        plan.append((hosts, tls_hellos(hosts)))
    svc = ClassifyService(mode="device")
    lp = SelectorEventLoop("chip-smoke-accept")
    th = lp.loop_thread()
    lock = threading.Lock()
    # (burst, client port) -> answer records: a client's port is free
    # again once the server closed, so a later client of the same burst
    # may connect from it
    got: dict = {}
    faults: list = []
    st = {"burst": 0, "rearms": 0, "answered": 0}
    burst_done = threading.Event()

    def finish(key, rec) -> None:
        with lock:
            got.setdefault(key, []).append(rec)
            st["answered"] += 1
            if st["answered"] == burst:
                burst_done.set()

    def on_accept(cfd: int, ip: str, port: int) -> None:
        t_acc = time.monotonic_ns()
        key = (st["burst"], port)
        live = [True]

        def abort(why: str) -> None:
            live[0] = False
            lp.remove(cfd)
            vtl.close(cfd)
            faults.append(f"{ip}:{port}: {why}")
            finish(key, None)

        def rearm() -> None:
            if live[0] and lp.registered(cfd):
                lp.modify(cfd, vtl.EV_READ)

        def on_ev(fd: int, ev: int) -> None:
            if ev & vtl.EV_ERROR:
                abort("socket error before the hello")
                return
            try:
                data = vtl.recv_peek(cfd, MAX_HELLO)
            except OSError as e:
                abort(f"peek: {e!r}")
                return
            if data is None:
                return  # spurious wakeup
            if not data:
                abort("EOF before the hello")
                return
            sni, complete = parse_client_hello_sni(data)
            if not complete:
                # MSG_PEEK leaves the fd readable: park interest and
                # look again shortly, as the LB's accept path does
                st["rearms"] += 1
                lp.modify(cfd, 0)
                lp.delay(20, rearm)
                return
            live[0] = False
            lp.remove(cfd)
            if not sni:
                vtl.close(cfd)
                faults.append(f"{ip}:{port}: no SNI in a complete hello")
                finish(key, None)
                return
            src = parse_ip(ip)
            t_sub = time.monotonic_ns()

            def cb(verdict: int, pick: int, _payload) -> None:
                on_loop = threading.current_thread() is th
                t = time.monotonic_ns()
                vtl.close(cfd)
                finish(key, (sni, src, verdict, pick, on_loop,
                             (t - t_acc) / 1e3, (t_sub - t_acc) / 1e3,
                             (t - t_sub) / 1e3))

            svc.submit_classify_pick(pair, Hint.of_host(sni), src, port,
                                     cb, loop=lp)

        lp.add(cfd, vtl.EV_READ, on_ev)

    srv = lp.call_sync(lambda: ServerSock(lp, LOOPBACK, 0, on_accept,
                                          backlog=4096))
    n = bursts * burst
    lat, rows, reused = [], [], 0
    # the clients' thread pool runs in a process of its own, so that its
    # threads do not share the loop's interpreter lock
    clients = ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"))
    try:
        clients.submit(_client_burst, srv.port, [], concurrency).result(
            timeout=120)  # started and warm before the first burst
        FC.fused_classify_pick_cuda.launches = 0
        d0, q0 = svc.stats.dispatches, svc.stats.device_queries
        t0 = time.monotonic()
        for k, (hosts, hellos) in enumerate(plan):
            st["burst"] = k
            st["answered"] = 0
            burst_done.clear()
            cports = clients.submit(_client_burst, srv.port, hellos,
                                    concurrency).result(timeout=180)
            check(burst_done.wait(120),
                  f"loop burst {k}: {st['answered']} of {burst} answered "
                  f"after 120 s; faults {faults[:3]}")
            reused += sum(len(v) - 1 for kk, v in got.items() if kk[0] == k)
            for i, cport in enumerate(cports):
                # this client's answer: the record from its port with
                # its SNI (two such records would have equal answers)
                recs = got.get((k, cport), [])
                rec = next((r for r in recs
                            if r is not None and r[0] == hosts[i]), None)
                check(rec is not None, f"loop burst {k} row {i}: no "
                      f"answer for {hosts[i]!r} ({faults[:3]})")
                recs.remove(rec)
                sni, src, v, p, on_loop = rec[:5]
                check(on_loop, f"loop burst {k} row {i}: callback off "
                      f"the loop thread")
                want = (hm.index_snap(hsnap, Hint.of_host(hosts[i])),
                        M.pick(tab, src, cport))
                check((v, p) == want, f"loop burst {k} row {i}: "
                      f"{(v, p)} != host {want}")
                rows.append((hosts[i], src, cport, v, p))
                if v >= 0:
                    check(p == c_pick(src, cport),
                          f"loop burst {k} row {i}: pick {p} != the C "
                          f"lookup {c_pick(src, cport)}")
                lat.append(rec[5:])
        wall_s = time.monotonic() - t0
        launches = FC.fused_classify_pick_cuda.launches
        batches = svc.stats.dispatches - d0
        stats = svc.stats
        check(not faults, f"accept faults: {faults[:5]}")
        check(not any(got.values()),
              f"answers no client claimed: {[r for r in got.values() if r]}")
        check(stats.failovers == 0, f"{stats.failovers} device failovers")
        check(stats.device_queries - q0 == n and stats.oracle_queries == 0,
              f"device answered {stats.device_queries - q0} of {n}")
        if device.type == "cuda":  # the plain tier serves CPU tensors
            check(launches == batches, f"B1 launches {launches} != "
                  f"classify+pick batches {batches}")
        for i in range(4):  # the wrapper itself on the same table
            src, cport = parse_ip(LOOPBACK), 40000 + i
            check(vtl.maglev_pick(tab, src, cport) == c_pick(src, cport),
                  "vtl.maglev_pick != its C symbol")

        def pct(col: int, q: int) -> float:
            xs = sorted(t[col] for t in lat)
            return xs[min(len(xs) - 1, len(xs) * q // 100)]

        out = {"connections": n, "bursts": bursts, "burst": burst,
               "concurrency": concurrency,
               "matched": sum(1 for r in rows if r[3] >= 0),
               "batches": batches, "b1_launches": launches,
               "mean_batch": n / max(batches, 1),
               "max_batch": stats.max_batch,
               "hello_rearms": st["rearms"], "client_ports_reused": reused,
               "accept_to_delivery_p50_us": pct(0, 50),
               "accept_to_delivery_p99_us": pct(0, 99),
               "accept_to_submit_p50_us": pct(1, 50),
               "accept_to_submit_p99_us": pct(1, 99),
               "submit_to_delivery_p50_us": pct(2, 50),
               "submit_to_delivery_p99_us": pct(2, 99),
               "classify_latency": stats.latency_percentiles(),
               "wall_s": wall_s, "provider": vtl.PROVIDER,
               "libvtl": os.path.relpath(vtl.LIB_PATH,
                                         os.path.dirname(os.path.abspath(
                                             __file__))),
               "nofile": nofile}
    finally:
        clients.shutdown()
        try:
            lp.call_sync(srv.close)
        finally:
            lp.close()
            svc.close()
    return out, rows


def call_ms(fn, iters: int, reps: int = 5) -> float:
    """Mean ms per call over `iters` back-to-back calls, CUDA events
    around the run: what a caller pays, host launch overhead included.
    The least of `reps` runs: the one the shared host disturbed least."""
    for _ in range(3):
        fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / iters)
    return best


def device_ms(fn, iters: int, only: str = "", launches: int = 0) -> float:
    """Mean device ms per call: the CUDA kernels' own time, summed over
    every kernel one call launches whose name holds `only` (all when
    empty) (torch.profiler / CUPTI). 0.0 when the profiler saw no such
    device activity. With `launches` > 0 the profiler must have seen
    iters x launches such kernels: a run that lost events would read
    low, so it is run again (CUPTI on the H100 host drops its
    records now and then), and the phase fails after five."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for ev in prof.key_averages():
            if only in ev.key:
                us += getattr(ev, "self_device_time_total",
                              getattr(ev, "self_cuda_time_total", 0.0))
                n += ev.count
        if not launches or n == iters * launches:
            return us / iters / 1e3
        log(f"profiler saw {n} of {iters * launches} {only} kernels "
            f"({us / max(n, 1):.3f} us each); timing again")
    raise RuntimeError(f"chip smoke failed: the profiler lost {only} "
                       f"kernels in five runs")


def work(ht, q, mtab, slots):
    """(bytes, int ops) this batch needs: every query input read once,
    the output written once, and each table row the batch's data
    touches counted once — slot + key rows of valid probes, bucket
    items of live buckets, meta + byte rows of live candidates, the
    wildcard lists, the Maglev entries. Ops: byte compares (probe keys,
    candidate rows) plus ~24 integer ops per live candidate."""
    from vproxy_tpu_torch.ops import fused as F
    from vproxy_tpu_torch.ops.hashmatch import _items
    nbytes = sum(v.numel() * v.element_size() for v in q.values())
    nbytes += slots.numel() * 8 + slots.numel() * 2 * 4
    ops = 0
    fams = [("h", q["hp_slot1"], q["hp_len"]), ("h", q["hp_slot2"], q["hp_len"])]
    if "pk_uslot" in ht:
        fams += [("u", q["up_slot1"], q["up_len"]),
                 ("u", q["up_slot2"], q["up_len"])]
    cands = []
    for fam, sl, pl in fams:
        pslot, pkey, items, iota, qb = (
            (ht["pk_hslot"], ht["pk_hkey"], ht["hb_items"], ht["bh_iota"],
             q["hostb"]) if fam == "h" else
            (ht["pk_uslot"], ht["pk_ukey"], ht["ub_items"], ht["bu_iota"],
             q["urib"]))
        valid = sl >= 0
        rows = torch.unique(sl[valid])
        nbytes += rows.numel() * (16 + pkey.shape[1])
        ops += int(pl[valid].clamp(min=0).sum())
        ch = F._packed_probe(sl, pl, pslot, pkey, qb, iota)
        nbytes += torch.unique(ch[ch >= 0]).numel() * 4
        cands.append(_items(items, ch).reshape(sl.shape[0], -1))
    wild = [ht["wh_idx"]] + ([ht["wu_idx"]] if "pk_uslot" in ht else [])
    for w in wild:
        nbytes += w.numel() * 4
        cands.append(w[None].expand(sl.shape[0], -1))
    cand = torch.cat(cands, dim=1)
    live = cand >= 0
    nbytes += torch.unique(cand[live]).numel() * (
        32 + ht["pk_bytes"].shape[1])
    ops += int(live.sum()) * (ht["pk_bytes"].shape[1] + 24)
    nbytes += torch.unique(slots).numel() * 4
    return nbytes, ops


def phase_times(device, keep):
    from vproxy_tpu_torch.ops import fused as F
    from vproxy_tpu_torch.ops import fused_cuda as FC
    rules, tab, ht, mtab = keep
    rows = []
    saved = FC.fused_classify_pick_cuda.launches
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    b = max(TIME_BATCHES)
    q, slots = encode(tab, mk_queries(rules, b, 499), device, seed=499)
    t0 = time.monotonic()
    while time.monotonic() - t0 < 0.5:  # bring the clocks up first
        FC.fused_classify_pick_cuda(ht, q, mtab, slots)
    torch.cuda.synchronize()
    for b in TIME_BATCHES:
        q, slots = encode(tab, mk_queries(rules, b, 500 + b), device,
                          seed=500 + b)
        kern = lambda: FC.fused_classify_pick_cuda(ht, q, mtab, slots)
        plain = lambda: F.fused_classify_pick(ht, q, mtab, slots)
        raw = dict(ht)  # a plain dict: the table is checked every call
        kern_raw = lambda: FC.fused_classify_pick_cuda(raw, q, mtab, slots)
        # 256 MB written between launches evicts the 50 MB L2
        cold = lambda: (flush.zero_(), kern())
        check(torch.equal(kern(), plain()), f"kernel != plain at B={b}")
        # alternate plain, kernel, kernel, plain within this call
        p1 = device_ms(plain, 10)
        k1 = device_ms(kern, 200, KERNEL, 1)
        k2 = device_ms(kern, 200, KERNEL, 1)
        p2 = device_ms(plain, 10)
        c1 = device_ms(cold, 50, KERNEL, 1)
        check(min(p1, p2, k1, k2, c1) > 0, "profiler saw no device time")
        # dict, published, published, dict within this call
        kr1, kc1, kc2, kr2 = (call_ms(kern_raw, 200), call_ms(kern, 200),
                              call_ms(kern, 200), call_ms(kern_raw, 200))
        kc, kr = min(kc1, kc2), min(kr1, kr2)
        pc = call_ms(plain, 10, reps=3)
        nbytes, ops = work(ht, q, mtab, slots)
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ops = ops / INT_OPS_PER_S * 1e3
        row = {"batch": b, "ms": min(k1, k2), "ms_runs": [k1, k2],
               "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
               "cold_ms": c1, "call_ms": kc, "dict_call_ms": kr,
               "plain_call_ms": pc,
               "bound_ms": max(b_bytes, b_ops),
               "bound_by": "bytes" if b_bytes >= b_ops else "operations",
               "bytes": nbytes, "int_ops": ops}
        rows.append(row)
        log("times " + json.dumps(row))
    sweep = []
    for b in sorted(SWEEP_BATCHES + TIME_BATCHES[1:]):
        q, slots = encode(tab, mk_queries(rules, b, 500 + b), device,
                          seed=500 + b)
        kern = lambda: FC.fused_classify_pick_cuda(ht, q, mtab, slots)
        check(torch.equal(kern(), F.fused_classify_pick(ht, q, mtab, slots)),
              f"kernel != plain at B={b}")
        runs = [device_ms(kern, 200, KERNEL, 1) for _ in range(2)]
        sweep.append({"batch": b, "ms": min(runs), "ms_runs": runs})
        log("sweep " + json.dumps(sweep[-1]))
    FC.fused_classify_pick_cuda.launches = saved
    del flush
    log("clocks " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return rows, sweep


# ------------------------------------------------------------ CIDR half

def cidr_tables(device):
    """The 50k-route CidrMatcher and a SecurityGroup holding the 5k TCP
    ACL, published on the card. -> (route matcher, group, the group's
    TCP matcher, the ACL rules)."""
    from vproxy_tpu_torch.components.secgroup import SecurityGroup
    from vproxy_tpu_torch.ops import cidr_cuda as CC
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules.ir import Proto
    t0 = time.monotonic()
    nets = route_nets(N_ROUTES, ROUTE_SEED)
    acl = acl_rules(N_ACL, ACL_SEED)
    t1 = time.monotonic()
    routes = E.CidrMatcher(nets, device=device)
    t2 = time.monotonic()
    group = SecurityGroup("acl-5k", default_allow=False)
    group.extend_rules(acl)
    am = group._tables[Proto.TCP][0]
    for m in (routes, am):
        check(m.device.type == "cuda" and
              isinstance(m.snapshot()[6], CC.PackedCidrTable),
              "a CidrMatcher on the card published no prepared packed "
              "table")
    log(f"cidr: rules generated in {t1 - t0:.1f} s, routes built in "
        f"{t2 - t1:.1f} s, ACL in {time.monotonic() - t2:.1f} s; caps "
        f"routes {routes._caps}, ACL {am._caps}; "
        f"{routes.published_table_bytes()} + {am.published_table_bytes()}"
        f" unfused bytes, {routes.fused_stat()['packed_bytes']} + "
        f"{am.fused_stat()['packed_bytes']} packed")
    return routes, group, am, acl


def cidr_batch(queries, b, device):
    """Query tensors of b rows for B4: `queries` ((addr, port) pairs,
    port None throughout for no port gate), then pad rows (family -1).
    -> (a16, fam, port or None)."""
    from vproxy_tpu_torch.rules.engine import _cidr_q
    from vproxy_tpu_torch.utils.torchenv import tables_from_reference
    ports = None if queries[0][1] is None else [p for _, p in queries]
    a16, fam, p = _cidr_q([a for a, _ in queries], ports, b)
    q = {"a16": a16, "fam": fam}
    if p is not None:
        q["port"] = p
    q = tables_from_reference(q, device)
    return q["a16"], q["fam"], q.get("port")


def packed_cidr(nets, acl, device):
    """-> the prepared packed cidr table of `nets` (+ `acl`)."""
    from vproxy_tpu_torch.ops import cidr_cuda as CC
    from vproxy_tpu_torch.ops import fused as F
    from vproxy_tpu_torch.ops import hashmatch as H
    from vproxy_tpu_torch.utils.torchenv import tables_from_reference
    return CC.prepare_table(tables_from_reference(
        F.pack_cidr_table(H.compile_cidr_hash(nets, acl=acl).arrays),
        device))


def small_cidr_cases():
    """The CPU parity sets of tests/test_torch_cidr.py. -> (name, nets,
    acl or None, [(addr, port)])."""
    nets, addrs = hashmatch_route_case()
    yield "route_200", nets, None, [(a, None) for a in addrs]
    acl, q = acl_port_buckets()
    yield "acl_port_buckets", [r.network for r in acl], acl, q
    yield ("acl_port_buckets port=None", [r.network for r in acl], acl,
           [(a, None) for a, _ in q])
    nets, addrs = mixed_families()
    yield "mixed_families", nets, None, [(a, None) for a in addrs]
    nets, addrs = v6_many_masks()
    yield "v6_many_masks", nets, None, [(a, None) for a in addrs]
    acl, q = acl_deep_buckets()
    yield "acl_deep_buckets", [r.network for r in acl], acl, q
    nets = route_nets(2000, 5)
    yield ("routes_2k", nets, None,
           [(a, None) for a, _ in cidr_queries(nets, 600, 6)])
    acl = acl_rules(500, 7)
    q = acl_queries(acl, 600, 8)
    yield "acl_500", [r.network for r in acl], acl, q
    yield ("acl_500 port=None", [r.network for r in acl], acl,
           [(a, None) for a, _ in q])


def cidr_kernel_cases(routes, am, acl, device):
    """-> (name, prepared packed table, a16, fam, port) of each
    B4-vs-plain case: the 50k routes and the 5k ACL (with its ports
    and without) at every timed B, an eighth of each batch pad rows;
    the CPU parity sets; the clamp cuts of routes_2k and acl_500."""
    from vproxy_tpu_torch.ops import cidr_cuda as CC
    rct, act = routes.snapshot()[6], am.snapshot()[6]
    rnets = routes.snapshot()[1]
    for b in TIME_BATCHES:
        real = b - b // 8
        rq = [(a, None) for a, _ in cidr_queries(rnets, real, 600 + b)]
        yield f"routes 50k B={b}", rct, *cidr_batch(rq, b, device)
        aq = acl_queries(acl, real, 700 + b)
        yield f"ACL 5k B={b}", act, *cidr_batch(aq, b, device)
        yield (f"ACL 5k B={b} port=None", act,
               *cidr_batch([(a, None) for a, _ in aq], b, device))
    for name, nets, acl_, q in small_cidr_cases():
        ct = packed_cidr(nets, acl_, device)
        yield name, ct, *cidr_batch(q, len(q) + 8, device)
        if name in CUT_CASES:
            for how in CUTS:
                yield (f"{name} cut {how}",
                       CC.prepare_table(cut_table(dict(ct), how)),
                       *cidr_batch(q, len(q) + 8, device))


def phase_cidr_vs_plain(device, keep, routes, am, acl):
    """B4 against _cidr_first_packed on every cidr_kernel_cases() case,
    and B1's [B, 3] form against the 3-column plain tier, int32-exact.
    -> (B4 max |kernel - plain|, B1 route column max |kernel - plain|)."""
    from vproxy_tpu_torch.ops import cidr_cuda as CC
    from vproxy_tpu_torch.ops import fused as F
    from vproxy_tpu_torch.ops import fused_cuda as FC
    b4_err = 0
    for name, ct, a16, fam, port in cidr_kernel_cases(routes, am, acl,
                                                      device):
        got = CC.cidr_first_cuda(ct, a16, fam, port)
        ref = F._cidr_first_packed(ct, a16, fam, port)
        torch.cuda.synchronize()
        d = int((got.long() - ref.long()).abs().max())
        b4_err = max(b4_err, d)
        design = cidr_design(ct, a16, fam)
        log(f"B4 vs plain [{name}]: b {got.shape[0]} g {ct.ints['g']} ct "
            f"{ct.ints['ct']} cb {ct.ints['cb']} bk {ct.ints['bk']} r_cap "
            f"{ct.ints['r_cap']} port={port is not None} matched "
            f"{int((ref >= 0).sum())}/{int((fam >= 0).sum())} "
            f"max_abs_err {d}; design {json.dumps(design)}")
        check(torch.equal(got, ref), f"B4 != plain tier [{name}]")
        # the cases that take the routine past one round of each loop
        if name == "v6_many_masks":
            check(design["max_probe_rounds"] > 1,
                  "v6_many_masks took one probe round")
        if name == "acl_deep_buckets":
            check(design["max_entry_windows"] > 1,
                  "acl_deep_buckets took one entry window")
    rules, tab, ht, mtab = keep
    rct, act = routes.snapshot()[6], am.snapshot()[6]
    rnets = routes.snapshot()[1]
    rc_err = 0
    for name, b, ct, acl_ in (
            ("100k hints + 50k routes", SERVICE_BATCH, rct, None),
            ("100k hints + 5k ACL, ports", SERVICE_BATCH, act, acl),
            ("100k hints + 50k routes", max(TIME_BATCHES), rct, None)):
        real = b - b // 8  # the rest pad rows of the address batch
        queries = acl_queries(acl_, real, 801) if acl_ else \
            [(a, None) for a, _ in cidr_queries(rnets, real, 800)]
        q, slots = encode(tab, mk_queries(rules, b, 803), device)
        a16, fam, port = cidr_batch(queries, b, device)
        got = FC.fused_classify_pick_cuda(ht, q, mtab, slots, ct, a16, fam,
                                          port)
        ref = F.fused_classify_pick(ht, q, mtab, slots, ct, a16, fam, port)
        two = FC.fused_classify_pick_cuda(ht, q, mtab, slots)
        torch.cuda.synchronize()
        d = int((got.long() - ref.long()).abs().max())
        rc_err = max(rc_err, d)
        log(f"B1 route column vs plain [{name}, B={b}]: matched "
            f"{int((ref[:, 0] >= 0).sum())} verdicts, "
            f"{int((ref[:, 2] >= 0).sum())} routes; max_abs_err {d}")
        check(got.shape == (b, 3) and torch.equal(got, ref),
              f"B1 [B, 3] != plain tier [{name}, B={b}]")
        check(torch.equal(two, got[:, :2]),
              f"B1 [B, 2] != the first columns of [B, 3] [{name}]")
    return b4_err, rc_err


_ORACLE = None  # an oracle worker's host-backend CidrMatcher


def _oracle_init(nets, acl) -> None:
    global _ORACLE
    from vproxy_tpu_torch.rules.engine import CidrMatcher
    _ORACLE = CidrMatcher(nets, acl=acl, backend="host")


def _oracle_one(q):
    return _ORACLE.oracle_snap(_ORACLE.snapshot(), *q)


def oracle_answers(pool, queries):
    """Start the linear oracle_snap of every (addr, port) on `pool`
    (oracle_pool): -> an AsyncResult of the answers, in order."""
    return pool.map_async(_oracle_one, queries, chunksize=16)


def oracle_pool(snap):
    """A pool of worker processes (spawned: this process has threads),
    one per core, each holding a host-backend CidrMatcher over the
    snapshot's rule lists: the linear scan of the reference's lists
    takes ~30 ms a query over 50k routes, too long for one core."""
    import multiprocessing
    return multiprocessing.get_context("spawn").Pool(
        min(8, os.cpu_count() or 1), initializer=_oracle_init,
        initargs=(snap[1], snap[2]))


def phase_cidr_service(routes, group, am, acl):
    """The CIDR main path: the SecurityGroup's allow_async and a route
    CidrMatcher's submit_cidr through ClassifyService, every answer
    equal to the CidrIndex lookup and the linear oracle (worker
    processes, which run while the bursts are served). -> launches of
    the CIDR kernel during the run."""
    from vproxy_tpu_torch.ops import cidr_cuda as CC
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules.ir import Proto
    from vproxy_tpu_torch.rules.service import ClassifyService
    n = SERVICE_BATCH * BURSTS
    asnap, rsnap = am.snapshot(), routes.snapshot()
    sub = am.snap_payload(asnap)
    aqs = [acl_queries(acl, SERVICE_BATCH, 900 + k) for k in range(BURSTS)]
    rqs = [[(a, 1024 + i if k == 1 and i % 2 else None) for i, (a, _) in
            enumerate(cidr_queries(rsnap[1], SERVICE_BATCH, 1000 + k))]
           for k in range(BURSTS)]
    with oracle_pool(asnap) as apool, oracle_pool(rsnap) as rpool:
        a_orc = oracle_answers(apool, [q for b in aqs for q in b])
        r_orc = oracle_answers(rpool, [q for b in rqs for q in b])
        ClassifyService.reset()
        svc = ClassifyService.get()  # the one allow_async submits to
        svc.mode = "device"
        try:
            CC.cidr_first_cuda.launches = 0
            l0 = E.dispatch_launches_total()
            t0 = time.monotonic()
            a_got = [_answers(svc, lambda a, p, cb: group.allow_async(
                Proto.TCP, a, p, lambda ok: cb(ok, None)), q) for q in aqs]
            acl_s = time.monotonic() - t0
            acl_batches = svc.stats.dispatches
            t0 = time.monotonic()
            r_got = [_answers(svc, lambda a, p, cb: svc.submit_cidr(
                routes, a, p, cb), q) for q in rqs]
            route_s = time.monotonic() - t0
            launches = CC.cidr_first_cuda.launches
            st = svc.stats
            check(st.failovers == 0, f"{st.failovers} device failovers")
            check(st.device_queries == 2 * n and st.oracle_queries == 0,
                  f"device answered {st.device_queries} of {2 * n}")
            check(launches == st.dispatches ==
                  E.dispatch_launches_total() - l0,
                  f"B4 launches {launches}, cidr batches {st.dispatches}, "
                  f"engine launches {E.dispatch_launches_total() - l0}")
            log(f"cidr service: {n} ACL allow_async in {acl_batches} "
                f"batches ({acl_s:.2f} s), {n} route lookups in "
                f"{st.dispatches - acl_batches} batches ({route_s:.2f} s); "
                f"failovers {st.failovers} device_queries "
                f"{st.device_queries} max_batch {st.max_batch}; B4 "
                f"launches {launches}")
        finally:
            ClassifyService.reset()
        t0 = time.monotonic()
        a_orc, r_orc = a_orc.get(600), r_orc.get(600)
    log(f"cidr service: the linear oracle finished "
        f"{time.monotonic() - t0:.1f} s after the bursts")
    for k in range(BURSTS):
        for i, (a, p) in enumerate(aqs[k]):
            j = am.index_snap(asnap, a, p)
            check(j == a_orc[k * SERVICE_BATCH + i],
                  f"ACL burst {k} row {i}: CidrIndex {j} != oracle")
            want = sub[j].allow if j >= 0 else group.default_allow
            check(a_got[k][i] == (want,), f"ACL burst {k} row {i}: "
                  f"{a_got[k][i]} != {want} (rule {j})")
        for i, (a, p) in enumerate(rqs[k]):
            j = routes.index_snap(rsnap, a, p)
            check(j == r_orc[k * SERVICE_BATCH + i],
                  f"route burst {k} row {i}: CidrIndex {j} != oracle")
            check(r_got[k][i] == (j,), f"route burst {k} row {i}: "
                  f"{r_got[k][i]} != {j}")
    return launches


def phase_route_column(pair, routes):
    """fused_dispatch_all: verdict, pick and route of a batch in one B1
    launch, BURSTS batches of SERVICE_BATCH, every column equal to the
    host index. -> launches of B1's route column during the run."""
    from vproxy_tpu_torch.ops import fused_cuda as FC
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules import maglev as M
    from vproxy_tpu_torch.utils.torchenv import to_host
    hm, mm = pair.hm, pair.mm
    hsnap, msnap, csnap = hm.snapshot(), mm.snapshot(), routes.snapshot()
    k_fn = FC.fused_classify_pick_cuda
    k_fn.launches = k_fn.route_launches = 0
    l0 = E.dispatch_launches_total()
    t0 = time.monotonic()
    for k in range(BURSTS):
        hints = mk_queries(hsnap[2], SERVICE_BATCH, seed=1100 + k)
        addrs = [a for a, _ in cidr_queries(csnap[1], SERVICE_BATCH,
                                            1200 + k)]
        ips = mk_ips(SERVICE_BATCH, seed=1300 + k)
        ports = [None if i % 3 == 0 else 1024 + i
                 for i in range(SERVICE_BATCH)]
        out = to_host(E.fused_dispatch_all(
            hm, hsnap, routes, csnap, mm, msnap, hints, addrs, ips, ports,
            pad_to=SERVICE_BATCH))
        for i in range(SERVICE_BATCH):
            want = (hm.index_snap(hsnap, hints[i]),
                    M.pick(msnap[0], ips[i], ports[i]),
                    routes.index_snap(csnap, addrs[i]))
            check(tuple(int(x) for x in out[i]) == want,
                  f"fused_dispatch_all batch {k} row {i}: "
                  f"{tuple(out[i])} != host {want}")
    launches = k_fn.route_launches
    check(launches == k_fn.launches == BURSTS ==
          E.dispatch_launches_total() - l0,
          f"route-column launches {launches}, B1 launches "
          f"{k_fn.launches}, engine launches "
          f"{E.dispatch_launches_total() - l0}, batches {BURSTS}")
    log(f"route column: {BURSTS} fused_dispatch_all batches of "
        f"{SERVICE_BATCH} ({time.monotonic() - t0:.2f} s), B1 launches "
        f"{launches}")
    return launches


def cidr_work(ct, a16, fam, port):
    """(bytes, int ops) one B4 launch needs for this batch: every
    query's address, family and port (when gated) read once and its
    answer written once, the g_* rows once, and each table row the
    batch's data touches counted once — the slot record and key of
    every live probe (a group of the query's family, per salt), the
    bucket entries of matching probes, the meta rows of the rules they
    list. Ops: 16 FNV rounds (xor, multiply) and ~8 more per live
    probe, ~6 per bucket entry."""
    from vproxy_tpu_torch.ops.hashmatch import _cidr_slots
    b = a16.shape[0]
    g = ct["g_fam"].shape[0]
    nbytes = b * (16 + 4 + 4) + (0 if port is None else b * 4)
    nbytes += g * (4 + 16 + 4 + 4 + 4 + 4)
    n_ct, cb = ct["pk_cslot"].shape[0], ct["cb_items"].shape[0]
    masked, gok, slots = _cidr_slots(ct, a16, fam)
    live = torch.cat([s[gok] for s in slots]).clamp(0, n_ct - 1)
    nbytes += torch.unique(live).numel() * 32
    ops = live.numel() * 40
    pos = []
    for s in slots:
        sc = s.clamp(0, n_ct - 1).long()
        srec, key = ct["pk_cslot"][sc], ct["s_key"][sc]
        ok = gok & (srec[..., 0] > 0) & (key == masked).all(dim=-1)
        j = ct["bk_iota"][None, None, :]
        p = torch.where(ok[..., None] & (j < srec[..., 2:3]),
                        srec[..., 1:2] + j, -1)
        pos.append(p[p >= 0])
    pos = torch.cat(pos).clamp(0, cb - 1)
    nbytes += torch.unique(pos).numel() * 4
    ops += pos.numel() * 6
    items = ct["cb_items"][pos.long()]
    nbytes += torch.unique(items[items >= 0]).numel() * 16
    return nbytes, ops


def cidr_design(ct, a16, fam) -> dict:
    """What the CIDR routine's design depends on, for one batch, from the
    table and the batch with torch ops on their device (cidr_first.cuh:
    a lane takes PROBES live pairs per round, a warp lists LIST = 32 x
    ENTRIES bucket entries per window): the most, over the batch's
    queries, of the live (group, salt) pairs, of the entries of matching
    buckets, and of the probe rounds and entry-list windows the routine
    takes for one query."""
    from vproxy_tpu_torch.ops import fused_cuda as FC
    from vproxy_tpu_torch.ops.hashmatch import _cidr_slots
    with open(FC.CIDR_HEADER) as f:
        src = f.read()
    probes, entries = (int(re.search(rf"constexpr int {k} = (\d+);",
                                     src).group(1))
                       for k in ("PROBES", "ENTRIES"))
    per_round, per_window = 32 * probes, 32 * entries
    n_ct, bk = ct["pk_cslot"].shape[0], ct["bk_iota"].shape[0]
    masked, gok, slots = _cidr_slots(ct, a16, fam)
    rank = gok.long().cumsum(dim=1) - 1  # a group's place in its family
    pairs = 2 * gok.long().sum(dim=1)
    rounds = (pairs + per_round - 1) // per_round
    ent = torch.zeros(a16.shape[0], max(int(rounds.max()), 1),
                      dtype=torch.int64, device=a16.device)
    for s, slot in enumerate(slots):  # pair 2 x rank + salt
        sc = slot.clamp(0, n_ct - 1).long()
        srec, key = ct["pk_cslot"][sc], ct["s_key"][sc]
        ok = gok & (srec[..., 0] > 0) & (key == masked).all(dim=-1)
        cnt = torch.where(ok, srec[..., 2].clamp(0, bk), 0).long()
        ent.scatter_add_(1, ((2 * rank + s) // per_round).clamp(min=0), cnt)
    windows = ((ent + per_window - 1) // per_window).sum(dim=1)
    return {"max_pairs": int(pairs.max()),
            "max_entries": int(ent.sum(dim=1).max()),
            "max_probe_rounds": int(rounds.max()),
            "max_entry_windows": int(windows.max())}


def time_row(b, kern, plain, name, flush, work_):
    """One timing row: device ms per launch of `kern` (kernel `name`)
    L2-warm and after a 256 MB write (cold), its plain tier's, wall ms
    per call back to back, and the bound from work_ = (bytes, ops)."""
    check(torch.equal(kern(), plain()), f"{name} != plain at B={b}")
    p1 = device_ms(plain, 10)
    k1 = device_ms(kern, 200, name, 1)
    k2 = device_ms(kern, 200, name, 1)
    p2 = device_ms(plain, 10)
    c1 = device_ms(lambda: (flush.zero_(), kern()), 50, name, 1)
    check(min(p1, p2, k1, k2, c1) > 0, "profiler saw no device time")
    kc = min(call_ms(kern, 200), call_ms(kern, 200))
    pc = call_ms(plain, 10, reps=3)
    nbytes, ops = work_
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = ops / INT_OPS_PER_S * 1e3
    return {"batch": b, "ms": min(k1, k2), "ms_runs": [k1, k2],
            "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
            "cold_ms": c1, "call_ms": kc, "plain_call_ms": pc,
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "bytes": nbytes, "int_ops": ops}


def host_ms(fn, iters: int = 20) -> float:
    """Mean host wall ms per call of fn (which ends in a sync), the
    least of 3 runs."""
    fn()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    return best


def cidr_breakdown(m, queries, device) -> dict:
    """Where one cidr batch of SERVICE_BATCH queries spends its time, on
    the host's clock: the address encode (engine._cidr_q), the upload
    of its arrays (tables_from_reference, synced), the wrapper call
    with the kernel (synced), and the whole CidrMatcher.match round
    trip (encode, upload, launch, pull)."""
    from vproxy_tpu_torch.ops import cidr_cuda as CC
    from vproxy_tpu_torch.rules.engine import _cidr_q
    from vproxy_tpu_torch.utils.torchenv import tables_from_reference
    snap = m.snapshot()
    addrs = [a for a, _ in queries]
    ports = None if snap[2] is None else [p for _, p in queries]
    b = len(addrs)
    a16, fam, p = _cidr_q(addrs, ports, b)
    arrs = {"a16": a16, "fam": fam} | ({} if p is None else {"port": p})

    def upload():
        q = tables_from_reference(arrs, device)
        torch.cuda.synchronize()
        return q
    q = upload()

    def launch():
        CC.cidr_first_cuda(snap[6], q["a16"], q["fam"], q.get("port"))
        torch.cuda.synchronize()
    return {"batch": b, "encode_ms": host_ms(lambda: _cidr_q(addrs, ports,
                                                              b)),
            "upload_ms": host_ms(upload), "launch_sync_ms": host_ms(launch),
            "match_ms": host_ms(lambda: m.match(addrs, ports))}


def phase_cidr_times(device, keep, routes, am, acl):
    """B4 on the route table and on the ACL (with ports), and B1 with
    its route column on the 100k hint + 50k route tables, at every
    TIME_BATCHES, then cidr_breakdown() of both matchers. -> {"B4
    routes": rows, "B4 ACL": rows, "B1 route column": rows, "breakdown
    routes": {...}, "breakdown ACL": {...}}."""
    from vproxy_tpu_torch.ops import cidr_cuda as CC
    from vproxy_tpu_torch.ops import fused as F
    from vproxy_tpu_torch.ops import fused_cuda as FC
    rules, tab, ht, mtab = keep
    rct, act = routes.snapshot()[6], am.snapshot()[6]
    rnets = routes.snapshot()[1]
    saved = (CC.cidr_first_cuda.launches, FC.fused_classify_pick_cuda.launches,
             FC.fused_classify_pick_cuda.route_launches)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    out = {"B4 routes": [], "B4 ACL": [], "B1 route column": []}
    for b in TIME_BATCHES:
        for label, ct, queries in (
                ("B4 routes", rct, [(a, None) for a, _ in
                                    cidr_queries(rnets, b, 1400 + b)]),
                ("B4 ACL", act, acl_queries(acl, b, 1500 + b))):
            a16, fam, port = cidr_batch(queries, b, device)
            row = time_row(
                b, lambda: CC.cidr_first_cuda(ct, a16, fam, port),
                lambda: F._cidr_first_packed(ct, a16, fam, port),
                KERNEL_B4, flush, cidr_work(ct, a16, fam, port))
            row["design"] = cidr_design(ct, a16, fam)
            out[label].append(row)
            log(f"times {label} " + json.dumps(row))
        q, slots = encode(tab, mk_queries(rules, b, 1600 + b), device,
                          seed=1600 + b)
        a16, fam, _ = cidr_batch([(a, None) for a, _ in
                                  cidr_queries(rnets, b, 1700 + b)], b,
                                 device)
        nb, ops = work(ht, q, mtab, slots)
        cb_, cops = cidr_work(rct, a16, fam, None)
        row = time_row(
            b, lambda: FC.fused_classify_pick_cuda(ht, q, mtab, slots, rct,
                                                   a16, fam, None),
            lambda: F.fused_classify_pick(ht, q, mtab, slots, rct, a16, fam,
                                          None),
            KERNEL, flush, (nb + cb_, ops + cops))
        row["design"] = cidr_design(rct, a16, fam)
        out["B1 route column"].append(row)
        log("times B1 route column " + json.dumps(row))
    for label, m, queries in (
            ("routes", routes, [(a, None) for a, _ in
                                cidr_queries(rnets, SERVICE_BATCH, 1800)]),
            ("ACL", am, acl_queries(acl, SERVICE_BATCH, 1900))):
        out[f"breakdown {label}"] = cidr_breakdown(m, queries, device)
        log(f"breakdown {label} " + json.dumps(out[f"breakdown {label}"]))
    (CC.cidr_first_cuda.launches, FC.fused_classify_pick_cuda.launches,
     FC.fused_classify_pick_cuda.route_launches) = saved
    del flush
    return out


def main() -> int:
    smi = phase_env()
    # the native FD provider, built from this checkout: a build or load
    # failure raises instead of falling back to the Python pump
    os.environ["VPROXY_TPU_FD_PROVIDER"] = "native"
    os.environ.pop("VPROXY_TPU_VTL_SO", None)
    from vproxy_tpu_torch.rules import engine as E
    device = torch.device("cuda")
    builds = phase_build()
    err, keep = phase_kernel_vs_plain(device)
    launches, pair = phase_service(device, keep[0])
    loop, _ = phase_loop(device, pair, keep[0])
    log(json.dumps({"loop": {**loop, "card": smi}}))
    routes, group, am, acl = cidr_tables(device)
    b4_err, rc_err = phase_cidr_vs_plain(device, keep, routes, am, acl)
    b4_launches = phase_cidr_service(routes, group, am, acl)
    rc_launches = phase_route_column(pair, routes)
    rows, sweep = phase_times(device, keep)
    crows = phase_cidr_times(device, keep, routes, am, acl)
    log("clocks " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    check(E.fused_kernel_name() == "cuda", "fused kernel tier changed")

    def at(rows_, key="ms"):
        return next(r for r in rows_ if r["batch"] == SERVICE_BATCH)[key]

    def entry(name, source, replaces, n, e, rows_, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n, "max_abs_err": float(e),
                "ms": at(rows_), "cold_ms": at(rows_, "cold_ms"),
                "plain_ms": at(rows_, "plain_ms"),
                "bound_ms": at(rows_, "bound_ms"),
                "bound_by": at(rows_, "bound_by"), "library_ms": None,
                "batch": SERVICE_BATCH, "card": smi, **extra}

    log(json.dumps({"kernels": [
        entry("fused_classify_pick", SOURCE, REPLACES,
              launches + loop["b1_launches"], err, rows,
              launches_by_path={"service": launches,
                                "loop": loop["b1_launches"]},
              build_s=builds["fused"]["build_s"],
              instances=builds["fused"]["instances"], by_batch=rows,
              sweep=sweep),
        entry("fused_classify_pick route column", SOURCE, REPLACES_ROUTE,
              rc_launches, rc_err, crows["B1 route column"],
              by_batch=crows["B1 route column"]),
        entry("cidr_first", SOURCE_B4, REPLACES_B4, b4_launches, b4_err,
              crows["B4 ACL"], table="ACL 5k, ports",
              build_s=builds["cidr"]["build_s"],
              instances=builds["cidr"]["instances"],
              by_batch={"acl": crows["B4 ACL"],
                        "routes": crows["B4 routes"]},
              host_breakdown={"acl": crows["breakdown ACL"],
                              "routes": crows["breakdown routes"]})]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
