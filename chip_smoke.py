"""Chip smoke test: the torch port's classify serving paths on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout's sources (the fused
classify+pick kernel B1, with its route column and its verdict-only
mode B3, and the CIDR kernel B4), holds them bit for bit against their
plain torch tiers, serves hint and classify+pick bursts through
ClassifyService over a 100k-rule Host/SNI/URI table and a 65,537-slot
Maglev table over 256 weighted backends, and again for TLS connections
accepted on the port's own event loop, drives the port's TcpLB end to
end (BASELINE config #2 as far as its build budget allows, behind
config #4's ACL), ACL checks through a SecurityGroup of 5,000 TCP rules
and route lookups against a 50,000-route table (BASELINE config #4, not
cut), then the same tables on the packed-fingerprint backend
("torch-fp": B6 for hint batches, B7 for cidr batches), times the
kernels, and prints one JSON line per result. Phases, in order:

1. environment: a CUDA device, or exit 1; the card's name and power
   limit as nvidia-smi reports them;
2. build: nvcc of csrc/fused_classify_pick.cu, csrc/cidr_first.cu,
   csrc/fp_hint.cu and csrc/fp_cidr.cu, and g++ of the port's
   native/vtl.cpp (the host FD layer; it must
   load as the native provider, from vproxy_tpu_torch/_build/), all
   started together, with their seconds, and per kernel instance (B1:
   uri or uri-free, compare word; B4, B6, B7: one) ptxas's registers and
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
   rules; and B3 (the same kernel with no Maglev column: rule index and
   level, hashmatch.hint_hash_match) in each of these cases against
   both plain versions (hint_hash_match over the unpacked arrays,
   fused._hint_verdict_packed over the packed table), at the 100k uri
   table with B = 16 / 512 / 4096 (an eighth pad rows), and on that
   table and wide_buckets cut short where JAX clamps (cut_hint_table:
   no bucket entries, or bucket items past a fifth of the array; the
   plain versions read the cut table grown back, clamp_grown);
4. service: 4 bursts of 512 submit_classify_pick requests through a
   FusedPair and 4 of 512 submit_hint requests, every answer equal to
   the host index (HintIndex + maglev.pick), no failover, every query
   answered by the device, one B1 launch per classify+pick batch and
   one B3 launch per hint batch, never B1's cpick form for a hint
   batch;
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
5b. the TcpLB (the `tcplb` line): 256 loopback HTTP id-servers in a
   spawned process (each answers `<id> <Host>`), an Upstream of up to
   10,000 server groups, each with one Host rule (seeded: exact
   domains, their subdomains by suffix, a sixteenth with a uri), group i
   on backend i mod 256, added one by one until 10,000 or 60 s of build
   (never under 256), behind a SecurityGroup of config #4's 5,000 TCP
   ACL rules (default allow; the clients' address checked on CidrIndex
   to pass); an http-splice LB serves 4 bursts of 512 concurrent
   connections and an http (L7 http1) LB one burst of 64 keep-alive
   connections x 4 requests, clients in a spawned process, the
   service in "device" mode; every answer's backend equal to the
   group the port's host index gives (any backend where no rule
   matches), B3 launched once per hint batch, B4 once per cidr batch,
   B1 and B3's torch tier never, no failover, the native provider;
   prints the build, connect->first byte p50/p99, the accept-stage
   histograms, batches per kind and launches per kernel;
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
7b. the fingerprint backend (fp_tables: the 100k hint rules, the 50k
   routes and the 5k ACL on "torch-fp"; phase_fp_kernels): B6
   int32-exact against fphash.hint_fp_match on the 100k table (uri
   rules) and a 100k host-only table at B = 16 / 512 / 4096, an eighth
   pad rows, and on the CPU parity sets (um_* batches and untrimmed
   ones both); B7 against fphash.cidr_fp_match on the routes (trie +
   V6 groups) and the ACL (groups: its trie passes the build's touch
   limit; ports and port=None) at every B, and on the CPU sets (a trie
   ACL, routes without the trie, a wide route first, an ACL past 128
   stacked rules, v6 only, mixed families); classify_fp_all's [B, 3]
   (B6, then B7 twice into one output) against the plain tier;
7c. fp service (the `fp_service` line): 4 x 512 submit_hint on the
   torch-fp HintMatcher, 4 x 512 submit_classify_pick on a FusedPair
   over it (B6 plus the Maglev take: the backend fuses nothing), 4 x
   512 SecurityGroup allow_async on the ACL and 4 x 512 submit_cidr on
   the routes (phase 7's queries), "device" mode; every answer equal to
   the host index (and phase 7's linear oracle for CIDR), one B6 launch
   per hint or cpick batch, one B7 launch per cidr batch, B1 / B3 / B4
   never, no failover;
7d. tcplb_fp (the `tcplb_fp` line): phase 5b's http-splice LB with
   VPROXY_TPU_MATCHER=jax-fp, 256 groups, one burst of 512 connections
   (and the keep-alive burst): every backend equal to the host index's
   group, B6 and B7 launched once per batch of their kind, B1, B3, B4
   never;
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
   show where it stops being set by one query's chain of loads; B3's
   rows the same way against hashmatch.hint_hash_match, its bound
   without the Maglev slots and entries;
9. the same times for B4 (route table, ACL) and for B1 with its route
   column, each row with its batch's cidr_design, and where one cidr
   batch of 512 spends its host time
   (address encode, upload, wrapper call with the kernel, the whole
   CidrMatcher.match round trip); and for B6 (100k table), B7 (routes,
   ACL) and classify_fp_all (its 3 launches summed), with their plain
   tiers and bounds (the 155.7 MB slot table is three times the L2: a
   warm time there is not an all-L2 time);
10. the `phase_s` line (wall seconds per phase), the {"kernels": [...]}
   line (B1, B1 with the route column, B4, B3, B6, B7),
   then the card's line, then the device line.

Any failed phase raises, and the script exits non-zero.
"""
from __future__ import annotations

import contextlib
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
# B3 is B1's kernel in its verdict-only mode (a null Maglev column)
REPLACES_B3 = "vproxy_tpu/ops/hashmatch.py:516"
# the packed-fingerprint backend: B6 (hint) and B7 (routes / ACL)
REPLACES_B6 = "vproxy_tpu/ops/fphash.py:555"
REPLACES_B7 = "vproxy_tpu/ops/fphash.py:1176"
KERNEL_B6, KERNEL_B7 = "fp_hint_kernel", "fp_cidr_kernel"
SOURCE_B6 = "vproxy_tpu_torch/csrc/fp_hint.cu"
SOURCE_B7 = "vproxy_tpu_torch/csrc/fp_cidr.cu"


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


def cut_hint_table(t: dict, how: str) -> dict:
    """A hint table (its unpacked arrays or its packed dict: both carry
    the same bucket item and iota arrays) cut short where the
    reference's gathers clamp: "bucket" (a bucket cap of no entry, where
    buckets list some: only the wildcard lists answer) or "items"
    (bucket entries past the first fifth of hb_items / ub_items). The
    kernel must clamp where JAX does."""
    out = dict(t)
    keys = ("bh_iota", "bu_iota") if how == "bucket" else ("hb_items",
                                                          "ub_items")
    for k in keys:
        if k in t:
            out[k] = t[k][:0] if how == "bucket" else \
                t[k][: max(1, t[k].shape[0] // 5)]
    return out


def clamp_grown(cut: dict, full: dict) -> dict:
    """`cut` with each item array cut short grown back to its length in
    `full` by repeating its last entry: a gather from it at an index
    `full` holds equals a gather from `cut` with the index clamped, as
    JAX gathers. The hint plain tiers index with no upper clamp, so they
    are held to a cut table through this."""
    out = dict(cut)
    for k, v in cut.items():
        n = full[k].shape[0] - v.shape[0]
        if n > 0 and k.endswith("_items"):
            out[k] = (np.concatenate([v, np.repeat(v[-1:], n)])
                      if isinstance(v, np.ndarray)
                      else torch.cat([v, v[-1:].expand(n)]))
    return out


HINT_CUTS = ("bucket", "items")


# The fingerprint backend's parity sets (tests/test_torch_fphash.py;
# tier-1 holds these copies equal to those).

def fp_member_overflow():
    """One host shared by many (uri, port) variants: hM grows past the
    default. -> (rules, hints)."""
    from vproxy_tpu_torch.rules.ir import Hint, HintRule
    rules = [HintRule(host="big.io", uri=f"/p{i}") for i in range(9)]
    rules += [HintRule(host="big.io", port=1000 + i) for i in range(5)]
    return rules, [Hint(host="big.io", uri="/p7/x"),
                   Hint(host="big.io", port=1003),
                   Hint(host="big.io", uri="/nope")]


def fp_uri_untrimmed():
    """Rule uris of 4 distinct lengths (lset_cap 4) and queries long
    enough to live-probe all 4: the encoder keeps the untrimmed up_*
    arrays and emits no um_* copies. -> (rules, hints)."""
    from vproxy_tpu_torch.rules.ir import Hint, HintRule
    rules = [HintRule(uri="/a"), HintRule(uri="/ab", port=443),
             HintRule(host="x.io", uri="/abc"), HintRule(uri="/abcd"),
             HintRule(host="*", uri="/ab"), HintRule(host="y.io")]
    return rules, [Hint(uri="/abcdef"), Hint(host="x.io", uri="/abcd"),
                   Hint(host="q.x.io", uri="/abcz", port=443),
                   Hint(host="y.io", uri="/abcde"), Hint(uri="/abcd")]


def fp_trie_first_match():
    """A wide route before narrower ones (first match is not the longest
    prefix), both orders. -> (nets, [addr])."""
    from vproxy_tpu_torch.utils.ip import Network, mask_bytes, parse_ip
    nets = [Network(parse_ip("10.0.0.0"), mask_bytes(8)),
            Network(parse_ip("10.1.0.0"), mask_bytes(16)),
            Network(parse_ip("10.1.2.0"), mask_bytes(24))]
    addrs = [bytes([10, 1, 2, 3]), bytes([10, 1, 9, 9]),
             bytes([10, 9, 9, 9]), bytes([11, 0, 0, 1]),
             b"\x00" * 10 + b"\xff\xff" + bytes([10, 1, 2, 3])]
    return nets + nets[::-1], addrs


def fp_trie_acl_overlap(seed: int = 7):
    """An ACL small enough for the trie (overlapping networks /0-/32,
    interleaved port ranges). -> (acl, [(addr, port)])."""
    import numpy as np
    from vproxy_tpu_torch.rules.ir import AclRule, Proto
    from vproxy_tpu_torch.utils.ip import Network, mask_bytes
    rnd = random.Random(seed)
    acl = []
    for i in range(60):
        ml = rnd.choice([0, 8, 16, 20, 24, 28, 32])
        ip = bytes([10, rnd.randint(0, 3), rnd.randint(0, 255),
                    rnd.randint(0, 255)])
        m = mask_bytes(ml)
        net = Network(bytes(np.frombuffer(ip, np.uint8) &
                            np.frombuffer(m, np.uint8)), m)
        lo = rnd.randint(0, 60000)
        hi = min(65535, lo + rnd.choice([0, 10, 5000, 65535]))
        r = AclRule(f"x{i}", net, Proto.TCP, lo, hi, bool(i & 1))
        if not any(q.network == r.network and q.min_port == r.min_port
                   and q.max_port == r.max_port for q in acl):
            acl.append(r)
    q = [(bytes([10, rnd.randint(0, 4), rnd.randint(0, 255),
                 rnd.randint(0, 255)]), rnd.randint(0, 65535))
         for _ in range(300)]
    return acl, q


def fp_acl_stacked(n: int = 130):
    """n rules on one network with disjoint port ranges: a trie cell
    lists all n (pruning keeps them), past 128, so the build starts again
    without the trie. -> (acl, [(addr, port)])."""
    from vproxy_tpu_torch.rules.ir import AclRule, Proto
    from vproxy_tpu_torch.utils.ip import Network, mask_bytes, parse_ip
    net = Network(parse_ip("10.0.0.0"), mask_bytes(8))
    acl = [AclRule(f"s{i}", net, Proto.TCP, 10 * i, 10 * i + 5, bool(i & 1))
           for i in range(n)]
    acl.append(AclRule("v6", Network(parse_ip("fd00::"), mask_bytes(8)),
                       Proto.TCP, 0, 65535, True))
    q = [(bytes([10, i % 7, 1, 2]), 10 * (i % (n + 3)) + (i % 9))
         for i in range(200)]
    return acl, q + [(parse_ip("fd00::5"), 80), (bytes([11, 0, 0, 1]), 5)]


def fp_v6_only(seed: int = 9):
    """Only v6 routes (no V4-family pattern: the build skips the trie).
    -> (nets, [addr])."""
    import numpy as np
    from vproxy_tpu_torch.utils.ip import Network, mask_bytes
    rng = np.random.default_rng(seed)
    nets = []
    for _ in range(40):
        ml = int(rng.choice([40, 48, 64, 96, 128]))
        m = mask_bytes(ml)
        raw = b"\xfd" + bytes([int(rng.integers(0, 4))]) + rng.bytes(14)
        nets.append(Network(bytes(a & b for a, b in zip(raw, m)), m))
    addrs = [n.ip[:15] + bytes([i]) for i, n in enumerate(nets)]
    return nets, addrs + [bytes([10, 0, 0, 1]), b"\xfe" + bytes(15)]


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
    fused_kernel<URI, W, PICK> (B1), "B3 uri W=16" for its verdict-only
    instances (PICK false), "B4" for the CIDR kernel, "B6" and "B7" for
    the fingerprint kernels."""
    for kernel, name in ((KERNEL_B4, "B4"), (KERNEL_B6, "B6"),
                         (KERNEL_B7, "B7")):
        if kernel in mangled:
            return name
    m = re.search(r"fused_kernelILb([01])ELi(\d+)ELb([01])E", mangled)
    if not m:
        return mangled
    return (f"{'' if m.group(3) == '1' else 'B3 '}"
            f"{'uri' if m.group(1) == '1' else 'uri-free'} W={m.group(2)}")


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
    """Every kernel library, one nvcc each, and the port's libvtl (g++),
    started together. -> {library: {"build_s": seconds, "instances":
    _ptxas()}}."""
    from vproxy_tpu_torch.ops import cidr_cuda as CC
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    from vproxy_tpu_torch.ops import fused_cuda as FC

    def timed(fn):
        t0 = time.monotonic()
        return fn(), time.monotonic() - t0

    with ThreadPoolExecutor(5) as ex:
        futs = {"fused": ex.submit(timed, FC.build),
                "cidr": ex.submit(timed, CC.build),
                "fp_hint": ex.submit(timed, FPC.build_hint),
                "fp_cidr": ex.submit(timed, FPC.build_cidr),
                "vtl": ex.submit(timed, native_vtl)}
        built = {k: f.result() for k, f in futs.items()}
    vtl, secs = built.pop("vtl")
    log(f"build: libvtl (g++) {secs:.2f} s -> "
        f"{os.path.relpath(vtl.LIB_PATH, os.path.dirname(vtl.BUILD_DIR))}"
        f" from {os.path.relpath(vtl.SOURCE, os.path.dirname(vtl.BUILD_DIR))}"
        f", provider {vtl.PROVIDER}")
    out = {"vtl": {"build_s": secs}}
    for lib_name, want in (("fused", 16), ("cidr", 1), ("fp_hint", 1),
                           ("fp_cidr", 1)):
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


def b3_vs_plain(name, tab, ht, q, device, unpacked=None,
                plain_ht=None) -> int:
    """B3's kernel (B1's verdict-only mode) on the packed table `ht`
    against both plain versions, hashmatch.hint_hash_match over the
    unpacked arrays and fused._hint_verdict_packed over the packed table
    (`plain_ht`, default `ht`: a cut table's plain versions read it
    grown back, clamp_grown): int32 equality in index and level, the
    level 0 where the index is -1. -> max |kernel - plain| over both
    columns."""
    from vproxy_tpu_torch.ops import fused as F
    from vproxy_tpu_torch.ops import fused_cuda as FC
    from vproxy_tpu_torch.ops import hashmatch as H
    from vproxy_tpu_torch.utils.torchenv import tables_from_reference
    if unpacked is None:
        unpacked = tables_from_reference(tab.arrays, device)
    gi, gl = FC.hint_match_cuda(ht, q)
    ri, rl = H.hint_hash_match(unpacked, q)
    pi, pl = F._hint_verdict_packed(ht if plain_ht is None else plain_ht, q)
    torch.cuda.synchronize()
    d = max(int((gi.long() - ri.long()).abs().max()),
            int((gl.long() - rl.long()).abs().max()))
    log(f"B3 vs plain [{name}]: b {gi.shape[0]} r_cap "
        f"{ht['pk_meta'].shape[0]} uri={ht.uri} word {ht.word} matched "
        f"{int((ri >= 0).sum())} max_abs_err {d}")
    for what, a, b_ in (("index, unpacked", gi, ri), ("level, unpacked", gl,
                                                       rl),
                        ("index, packed", gi, pi), ("level, packed", gl,
                                                    pl)):
        check(torch.equal(a, b_), f"B3 != plain ({what}) [{name}]")
    check(bool((gl[gi < 0] == 0).all()), f"B3 level of a miss [{name}]")
    return d


def encode_padded(tab, hints, b: int, device) -> dict:
    """Query tensors for `hints` padded to `b` rows the way the engine
    pads a batch (pad rows: invalid probes, no match)."""
    from vproxy_tpu_torch.ops import hashmatch as H
    from vproxy_tpu_torch.rules.engine import _PAD_CUCKOO, _pad_hint_q
    from vproxy_tpu_torch.utils.torchenv import tables_from_reference
    q = _pad_hint_q(H.encode_hint_queries(hints, tab, pad_to=b), b,
                    _PAD_CUCKOO)
    return tables_from_reference(q, device)


def phase_kernel_vs_plain(device):
    """Every kernel_cases() case, int32-exact, for B1 and for B3 (its
    verdict-only mode) on the same tables; B3 also at the 100k uri table
    with B = 16 / 512 / 4096 (an eighth pad rows) and on that table and
    wide_buckets cut short where JAX clamps (cut_hint_table, against
    the plain tiers on clamp_grown). -> (B1 max |kernel - plain|, B3's,
    the 100k uri table pieces reused by the timing phase)."""
    from vproxy_tpu_torch.ops import fused as F
    from vproxy_tpu_torch.ops import fused_cuda as FC
    from vproxy_tpu_torch.ops.hashmatch import _PACK_I32_MAX
    from vproxy_tpu_torch.utils.torchenv import tables_from_reference
    err = b3_err = 0
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
        unpacked = tables_from_reference(tab.arrays, device)
        b3_err = max(b3_err, b3_vs_plain(name, tab, ht, q, device,
                                         unpacked))
        if name in ("100k uri", "wide_buckets"):
            qp = encode_padded(tab, hints, len(hints) + 8, device)
            for how in HINT_CUTS:
                cut = cut_hint_table(dict(ht), how)
                b3_err = max(b3_err, b3_vs_plain(
                    f"{name} cut {how}", tab, FC.prepare_table(cut), qp,
                    device, clamp_grown(cut_hint_table(unpacked, how),
                                        unpacked), clamp_grown(cut, ht)))
        if name == "100k uri":
            for b in TIME_BATCHES:
                qb = encode_padded(tab, mk_queries(rules, b - b // 8,
                                                   seed=900 + b), b, device)
                b3_err = max(b3_err, b3_vs_plain(
                    f"100k uri B={b}, {b // 8} pad rows", tab, ht, qb,
                    device, unpacked))
        if keep is None:
            keep = (rules, tab, ht, mtab)
    check(len(words) == 8, f"cases ran {len(words)} of the 8 kernel "
          f"instances: {sorted(words)}")
    return err, b3_err, keep


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
        FC.hint_match_cuda.launches = 0
        h0 = svc.stats.by_kind.get("hint", [0])[0]
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
        hint_batches = st.by_kind.get("hint", [0])[0] - h0
        check(FC.fused_classify_pick_cuda.launches == launches,
              "hint bursts launched B1's cpick form")
        check(FC.hint_match_cuda.launches == hint_batches > 0,
              f"B3 launches {FC.hint_match_cuda.launches} != hint "
              f"batches {hint_batches}")
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
            f"{st.max_batch}; fused kernel launches {launches}, B3 "
            f"launches {FC.hint_match_cuda.launches} for {hint_batches} "
            f"hint batches")
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


# -------------------------------------------------------- the TcpLB path
# The port's load balancer end to end: a TcpLB accepts loopback HTTP
# connections, ACL-checks each against a 5k-rule SecurityGroup (B4,
# ClassifyService's cidr kind), classifies its head against an
# Upstream's Host/URI rules (B3, the hint kind), picks the group's
# backend and splices the connection to it through the native pump;
# a second LB runs the L7 http1 engine, which routes every request of a
# keep-alive connection on its own.

TCPLB_MAX_RULES = 10_000  # BASELINE config #2's target
TCPLB_MIN_RULES = 256
TCPLB_BUILD_S = 60.0      # the Upstream build's budget: every add publishes
TCPLB_BACKENDS = 256
B3_PATH_BATCHES = 32  # batches a bucket below the largest (b3_on_path)
TCPLB_RULE_SEED, TCPLB_REQ_SEED = 61, 62
KEEPALIVE_CONNS, KEEPALIVE_REQS = 64, 4


def tcplb_rules(n: int, seed: int) -> list:
    """BASELINE config #2's Host rules, one per server group (an Upstream
    holds one rule per group), from a seeded numpy generator: distinct
    domains under ~1,000 tenants (a request names one exactly, or a
    subdomain of it: the suffix match), one in sixteen with a uri
    prefix. No host "*" rule: it would match every host and leave
    nothing to the WRR fallback, which this phase drives too."""
    from vproxy_tpu_torch.rules.ir import HintRule
    rng = np.random.default_rng(seed)
    tenants = rng.integers(0, 997, n)
    with_uri = rng.integers(0, 16, n) == 0
    return [HintRule(host=f"s{i}.t{tenants[i]}.example.com",
                     uri=f"/v{i % 7}" if with_uri[i] else None)
            for i in range(n)]


def tcplb_requests(rules, n: int, seed: int) -> list:
    """(host, path) per request, seeded: a rule's exact host, a
    subdomain of it, a host+uri rule's path, and one in five a host no
    rule names (the WRR fallback answers it)."""
    rng = np.random.default_rng(seed)
    js = rng.integers(0, len(rules), n)
    sub = rng.integers(0, 3, n) == 0
    out = []
    for k in range(n):
        r = rules[int(js[k])]
        if k % 5 == 4:
            out.append((f"miss{js[k]}.nowhere.test", "/"))
        elif r.uri is not None:
            out.append((r.host, f"{r.uri}/items/{k}"))
        elif sub[k]:
            out.append((f"x{k}.{r.host}", "/"))
        else:
            out.append((r.host, f"/p{k}"))
    return out


def http_request(host: str, path: str, close: bool) -> bytes:
    return (f"GET {path} HTTP/1.1\r\nhost: {host}\r\n" +
            ("connection: close\r\n" if close else "") + "\r\n").encode()


def _backend_main(n: int, conn) -> None:
    """Runs in the backend process: n loopback HTTP id-servers (asyncio,
    one thread). Each answers every request with `<id> <Host it saw>`
    and keeps the connection unless the request asked to close. Sends
    the ports down `conn`, serves until `conn` says stop."""
    import asyncio
    import functools
    raise_nofile()

    async def handle(reader, writer, bid):
        try:
            while True:
                head = await reader.readuntil(b"\r\n\r\n")
                host = b"?"
                for line in head.split(b"\r\n")[1:]:
                    k, _, v = line.partition(b":")
                    if k.strip().lower() == b"host":
                        host = v.strip()
                body = b"%d %s" % (bid, host)
                close = b"connection: close" in head.lower()
                writer.write(b"HTTP/1.1 200 OK\r\ncontent-length: %d\r\n%s"
                             b"\r\n%s" % (len(body), b"connection: close\r\n"
                                          if close else b"", body))
                await writer.drain()
                if close:
                    break
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            writer.close()

    async def main():
        servers = [await asyncio.start_server(
            functools.partial(handle, bid=i), LOOPBACK, 0, backlog=1024)
            for i in range(n)]
        conn.send([s.sockets[0].getsockname()[1] for s in servers])
        await asyncio.get_running_loop().run_in_executor(None, conn.recv)
        for s in servers:
            s.close()

    asyncio.run(main())


def _read_response(s, buf: bytes):
    """One HTTP response off socket s (bytes already read in `buf`). ->
    (body, the bytes after it)."""
    while b"\r\n\r\n" not in buf:
        d = s.recv(65536)
        if not d:
            raise ConnectionError(f"EOF inside a response head: {buf!r}")
        buf += d
    head, _, rest = buf.partition(b"\r\n\r\n")
    n = next(int(line.split(b":")[1]) for line in head.split(b"\r\n")
             if line.lower().startswith(b"content-length:"))
    while len(rest) < n:
        d = s.recv(65536)
        if not d:
            raise ConnectionError("EOF inside a response body")
        rest += d
    return rest[:n].decode(), rest[n:]


def _splice_client(port: int, host: str, path: str) -> tuple:
    """One connection, one request that asks to close. -> (client port,
    connect->first byte seconds, response body)."""
    import socket
    t0 = time.monotonic()
    s = socket.create_connection((LOOPBACK, port), timeout=60)
    try:
        cport = s.getsockname()[1]
        s.sendall(http_request(host, path, close=True))
        first = s.recv(65536)
        t1 = time.monotonic()
        body, _ = _read_response(s, first)
        return cport, t1 - t0, body
    finally:
        s.close()


def _keepalive_client(port: int, reqs: list) -> list:
    """One keep-alive connection carrying `reqs` one after another. ->
    the response bodies."""
    import socket
    s = socket.create_connection((LOOPBACK, port), timeout=60)
    out, buf = [], b""
    try:
        for host, path in reqs:
            s.sendall(http_request(host, path, close=False))
            body, buf = _read_response(s, buf)
            out.append(body)
        return out
    finally:
        s.close()


_HTTP_CLIENTS = None  # the client process's thread pool


def _http_burst(port: int, kind: str, items: list, concurrency: int) -> list:
    """Runs in the client process: items through `kind` ("splice": one
    (host, path) per connection; "keepalive": a list of them per
    connection), at most `concurrency` connections at once."""
    global _HTTP_CLIENTS
    if _HTTP_CLIENTS is None:
        _HTTP_CLIENTS = ThreadPoolExecutor(concurrency)
    if kind == "splice":
        return list(_HTTP_CLIENTS.map(
            lambda it: _splice_client(port, *it), items))
    return list(_HTTP_CLIENTS.map(
        lambda reqs: _keepalive_client(port, reqs), items))


def b3_on_path(m, reqs, max_batch: int, device) -> dict:
    """B3 held on the TcpLB path's own table and batch buckets: the
    Upstream matcher `m`'s published snapshot, and the phase's requests
    parsed as the LB parses them, encoded into every pad_batch bucket
    from the smallest up to that of the largest hint batch the path ran
    (`max_batch`), an eighth of each batch pad rows (one at least), at
    most B3_PATH_BATCHES batches a bucket and every request at the
    largest. The kernel (on the card; the packed plain tier on CPU
    tensors) against both plain versions, int32-equal in index and
    level, and its index against the rule the host index gives each
    request: -1 on every miss and every pad row, level 0 there. -> the
    check's numbers."""
    from vproxy_tpu_torch.ops import fused as F
    from vproxy_tpu_torch.ops import fused_cuda as FC
    from vproxy_tpu_torch.ops import hashmatch as H
    from vproxy_tpu_torch.processors.http1 import HeadParser
    from vproxy_tpu_torch.rules.service import PAD_LO, pad_batch
    from vproxy_tpu_torch.utils.torchenv import tables_from_reference
    snap = m.snapshot()
    tab, ht = snap[0], snap[5]
    hints = []
    for host, path in reqs:
        p = HeadParser()
        p.feed(http_request(host, path, close=True))
        hints.append(p.hint())
    want = torch.tensor([m.index_snap(snap, h) for h in hints],
                        dtype=torch.int32)
    unpacked = tables_from_reference(tab.arrays, device)
    on_card = device.type == "cuda"
    top = pad_batch(max_batch, lo=PAD_LO)
    b, buckets, n_batches, err = pad_batch(1, lo=PAD_LO), [], 0, 0
    while b <= top:
        buckets.append(b)
        rows = max(1, b - max(1, b // 8))
        starts = list(range(0, len(hints), rows))
        for s in starts if b == top else starts[:B3_PATH_BATCHES]:
            hs = hints[s:s + rows]
            q = encode_padded(tab, hs, b, device)
            ri, rl = H.hint_hash_match(unpacked, q)
            pi, pl = F._hint_verdict_packed(ht, q)
            gi, gl = FC.hint_match_cuda(ht, q) if on_card else (pi, pl)
            where = f"tcplb table, b {b}, requests {s}+{len(hs)}"
            for what, x, y in (("index, unpacked", gi, ri),
                               ("level, unpacked", gl, rl),
                               ("index, packed", gi, pi),
                               ("level, packed", gl, pl)):
                check(torch.equal(x, y), f"B3 != plain ({what}) [{where}]")
                err = max(err, int((x.long() - y.long()).abs().max()))
            exp = torch.full((b,), -1, dtype=torch.int32)
            exp[:len(hs)] = want[s:s + len(hs)]
            check(torch.equal(gi.cpu(), exp),
                  f"B3 != the host index's rule [{where}]")
            check(bool((gl[gi < 0] == 0).all()), f"B3 level of a miss "
                  f"[{where}]")
            n_batches += 1
        b *= 2
    misses = int((want < 0).sum())
    check(0 < misses < len(hints), f"{misses} of {len(hints)} requests "
          f"match no rule")
    out = {"r_cap": int(ht["pk_meta"].shape[0]), "buckets": buckets,
           "batches": n_batches, "requests": len(hints), "misses": misses,
           "max_abs_err": err}
    log(f"B3 on the tcplb path: {out}")
    return out


def build_upstream(rules, elg, bports) -> tuple:
    """Server group i (one server: backend i mod 256, health check
    "none") joins an Upstream with rule i as its annotation, one add at
    a time as an operator adds them, until every rule is in or the
    build has taken TCPLB_BUILD_S (never fewer than TCPLB_MIN_RULES
    groups): every add publishes a new generation of the whole table,
    so the build is quadratic. -> (upstream, groups, seconds)."""
    from vproxy_tpu_torch.components.servergroup import (HealthCheckConfig,
                                                         ServerGroup)
    from vproxy_tpu_torch.components.upstream import Upstream
    ups = Upstream("u-config2")
    hc = HealthCheckConfig(protocol="none", period_ms=600_000, up=1)
    groups = []
    t0 = time.monotonic()
    for i, rule in enumerate(rules):
        g = ServerGroup(f"g{i}", elg, hc, "wrr")
        g.add("s", LOOPBACK, bports[i % len(bports)])
        groups.append(g)
        ups.add(g, annotations=rule)
        if len(groups) >= TCPLB_MIN_RULES and \
                time.monotonic() - t0 > TCPLB_BUILD_S:
            break
    return ups, groups, time.monotonic() - t0


def phase_tcplb(device, max_rules=TCPLB_MAX_RULES, bursts=BURSTS,
                burst=SERVICE_BATCH, keepalive=KEEPALIVE_CONNS,
                n_acl=N_ACL, matcher=None) -> dict:
    """The port's TcpLB main path (BASELINE config #2 as far as one
    Upstream holds it, config #4's ACL): `bursts` bursts of `burst`
    concurrent http-splice connections and one burst of `keepalive`
    keep-alive connections x 4 requests through the L7 http engine,
    every answer checked against the group the port's host index gives;
    on the card, B3 and B4 launched once per device batch of their kind,
    B1 and B3's torch tier never; then B3 held on the path's own table
    and batch buckets (b3_on_path), misses included. The LBs reach ClassifyService through
    its process-wide instance, run here in "device" mode, as the
    reference's benchmarks run it: in "auto" mode the inline lane
    answers a query from the host index whenever none is queued for its
    matcher, and a query is queued only behind another, so none ever
    reaches the device. With matcher="jax-fp" (VPROXY_TPU_MATCHER, as
    an operator sets it, for the phase) the Upstream and the ACL serve
    on the fingerprint backend: B6 and B7 launch once per device batch
    of their kind, B1, B3 and B4 never, and b3_on_path is not run (the
    fingerprint table has no packed cuckoo half). -> the phase's
    numbers."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from vproxy_tpu_torch.components.elgroup import EventLoopGroup
    from vproxy_tpu_torch.components.secgroup import SecurityGroup
    from vproxy_tpu_torch.components.tcplb import TcpLB
    from vproxy_tpu_torch.ops import cidr_cuda as CC
    from vproxy_tpu_torch.ops import fphash as FP
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    from vproxy_tpu_torch.ops import fused_cuda as FC
    from vproxy_tpu_torch.ops import hashmatch as H
    from vproxy_tpu_torch.processors.http1 import HeadParser
    from vproxy_tpu_torch.rules.index import CidrIndex
    from vproxy_tpu_torch.rules.service import ClassifyService
    from vproxy_tpu_torch.utils.ip import parse_ip
    from vproxy_tpu_torch.utils.metrics import GlobalInspection
    fp = matcher == "jax-fp"
    env_matcher = os.environ.get("VPROXY_TPU_MATCHER")
    if matcher is not None:
        os.environ["VPROXY_TPU_MATCHER"] = matcher
    vtl = native_vtl()
    nofile = raise_nofile()
    check(nofile >= NOFILE_MIN, f"RLIMIT_NOFILE {nofile} < {NOFILE_MIN}")
    mode = os.environ.get("VPROXY_TPU_CLASSIFY")
    os.environ["VPROXY_TPU_CLASSIFY"] = "device"
    ClassifyService.reset()
    ctx = mp.get_context("spawn")
    pipe, child = ctx.Pipe()
    backends = ctx.Process(target=_backend_main,
                           args=(TCPLB_BACKENDS, child), daemon=True)
    backends.start()
    clients = ProcessPoolExecutor(1, mp_context=ctx)
    elg = EventLoopGroup("tcplb", 2)
    groups, lbs = [], []
    try:
        check(pipe.poll(120), "the backend process sent no ports")
        bports = pipe.recv()
        acl = acl_rules(n_acl, ACL_SEED)
        t0 = time.monotonic()
        sg = SecurityGroup("acl-5k-allow", default_allow=True)
        sg.extend_rules(acl)
        acl_s = time.monotonic() - t0
        rules = tcplb_rules(max_rules, TCPLB_RULE_SEED)
        ups, groups, build_s = build_upstream(rules, elg, bports)
        want_be = "torch-fp" if fp else "torch"
        check(ups._matcher.backend == want_be and all(
            m.backend == want_be for m, _ in sg._tables.values()),
            f"the tcplb matchers do not serve on {want_be!r}")
        n = len(groups)
        rules = rules[:n]
        log(f"tcplb: {n} rules on {n} groups built in {build_s:.1f} s "
            f"(target {max_rules}), ACL of {len(acl)} in "
            f"{acl_s:.1f} s")
        deadline = time.monotonic() + 60
        while not all(s.healthy for g in groups for s in g.servers):
            check(time.monotonic() < deadline, "backends never healthy")
            time.sleep(0.05)
        splice = TcpLB("lb-splice", elg, elg, LOOPBACK, 0, ups,
                       protocol="http-splice", security_group=sg, lanes=0)
        l7 = TcpLB("lb-http", elg, elg, LOOPBACK, 0, ups, protocol="http",
                   security_group=sg, lanes=0)
        for lb in (splice, l7):
            lbs.append(lb)
            lb.start()
        # the clients' address passes the ACL: no rule's network holds
        # it at the LBs' ports, so the default (allow) answers
        index = CidrIndex([r.network for r in acl], acl=acl)
        lo = parse_ip(LOOPBACK)
        check(all(index.lookup(lo, p) == -1 for p in
                  (splice.bind_port, l7.bind_port, 0, 80, 443, 65535)),
              "an ACL rule matches the clients' loopback address")

        def want_backend(host: str, path: str):
            """The backend the port's host index gives this request, or
            None when no rule matches (any group's backend then)."""
            p = HeadParser()
            p.feed(http_request(host, path, close=True))
            g = ups.search_for_group(p.hint())
            return None if g is None else int(g.alias[1:]) % TCPLB_BACKENDS

        def check_body(body: str, host: str, path: str, what: str) -> bool:
            bid, _, seen = body.partition(" ")
            check(seen == host, f"{what}: backend saw Host {seen!r}, "
                  f"sent {host!r}")
            want = want_backend(host, path)
            check(want is None or int(bid) == want,
                  f"{what}: {host}{path} reached backend {bid}, the host "
                  f"index gives {want}")
            return want is not None

        plan = [tcplb_requests(rules, burst, TCPLB_REQ_SEED + k)
                for k in range(bursts)]
        ka_reqs = tcplb_requests(rules, keepalive * KEEPALIVE_REQS, 700)
        ka_plan = [ka_reqs[c * KEEPALIVE_REQS:(c + 1) * KEEPALIVE_REQS]
                   for c in range(keepalive)]
        clients.submit(_http_burst, splice.bind_port, "splice", [],
                       max(burst, keepalive)).result(timeout=120)
        svc = ClassifyService.get()
        st = svc.stats
        kinds0 = {k: list(v) for k, v in st.by_kind.items()}
        f0 = st.failovers
        stage_h = {s: GlobalInspection.get().get_histogram(
            "vproxy_accept_stage_us", stage=s)
            for s in ("acl", "classify", "backend_pick")}
        stage0 = {s: h.state() for s, h in stage_h.items()}
        # the main path's counts, read just after it
        FC.hint_match_cuda.launches = 0
        CC.cidr_first_cuda.launches = 0
        FC.fused_classify_pick_cuda.launches = 0
        FPC.hint_fp_cuda.launches = FPC.cidr_fp_cuda.launches = 0
        H.hint_hash_match.cuda_calls = FP.hint_fp_match.cuda_calls = 0
        t0 = time.monotonic()
        lat, matched = [], 0
        for k, reqs in enumerate(plan):
            got = clients.submit(_http_burst, splice.bind_port, "splice",
                                 reqs, burst).result(timeout=300)
            for i, ((host, path), (_, secs, body)) in enumerate(zip(reqs,
                                                                    got)):
                matched += check_body(body, host, path,
                                      f"http-splice burst {k} row {i}")
                lat.append(secs * 1e6)
        splice_s = time.monotonic() - t0
        t0 = time.monotonic()
        ka = clients.submit(_http_burst, l7.bind_port, "keepalive",
                            ka_plan, keepalive).result(timeout=300)
        ka_matched = 0
        for c, (reqs, bodies) in enumerate(zip(ka_plan, ka)):
            check(len(bodies) == len(reqs), f"keep-alive conn {c}: "
                  f"{len(bodies)} of {len(reqs)} answers")
            for j, ((host, path), body) in enumerate(zip(reqs, bodies)):
                ka_matched += check_body(body, host, path,
                                         f"http conn {c} request {j}")
        ka_s = time.monotonic() - t0
        launches = {"hint_match": FC.hint_match_cuda.launches,
                    "cidr_first": CC.cidr_first_cuda.launches,
                    "fused_classify_pick": FC.fused_classify_pick_cuda.launches}
        fp_launches = {"hint_fp": FPC.hint_fp_cuda.launches,
                       "cidr_fp": FPC.cidr_fp_cuda.launches}
        torch_tier_cuda = H.hint_hash_match.cuda_calls + \
            FP.hint_fp_match.cuda_calls
        path_b3 = None if fp else b3_on_path(
            ups._matcher, [r for reqs in plan for r in reqs] + ka_reqs,
            st.by_kind.get("hint", [0, 0, 1])[2], device)

        def kind(k: str) -> dict:
            b, q, mx = st.by_kind.get(k, [0, 0, 0])
            b0, q0 = kinds0.get(k, [0, 0, 0])[:2]
            return {"batches": b - b0, "queries": q - q0,
                    "mean": (q - q0) / max(b - b0, 1), "max": mx}

        batches = {k: kind(k) for k in ("hint", "cidr", "cpick")}
        on_card = device.type == "cuda"  # CPU tensors: the plain tiers
        # the kernels that serve each kind on this backend, and the rest
        hint_k, cidr_k, idle = (
            ("hint_fp", "cidr_fp", ("hint_match", "cidr_first"))
            if fp else ("hint_match", "cidr_first", ("hint_fp", "cidr_fp")))
        counts = {**launches, **fp_launches}
        for k, kind in ((hint_k, "hint"), (cidr_k, "cidr")):
            check(counts[k] == (batches[kind]["batches"] if on_card else 0)
                  and batches[kind]["batches"] > 0,
                  f"{k} launches {counts[k]} != {kind} batches "
                  f"{batches[kind]['batches']} (or none)")
        check(all(counts[k] == 0 for k in idle), f"the {want_be} path "
              f"launched another backend's kernels: {counts}")
        check(launches["fused_classify_pick"] == 0,
              "the TcpLB path launched B1's cpick form")
        check(torch_tier_cuda == 0, f"a torch tier ran on CUDA "
              f"tensors {torch_tier_cuda} times")
        check(st.failovers == f0, f"{st.failovers - f0} device failovers")
        check(svc.error is None, f"the classify service closed: "
              f"{svc.error!r}")

        def pct(xs, q):
            xs = sorted(xs)
            return xs[min(len(xs) - 1, len(xs) * q // 100)]

        stages = {}
        for s, h in stage_h.items():
            c1, s1, b1 = h.state()
            c0, s0_, b0 = stage0[s]
            d = bucket_percentile(b1, b0)
            stages[s] = {"n": c1 - c0, "mean_us": (s1 - s0_) / max(c1 - c0,
                                                                    1),
                         "p50_us": d(50), "p99_us": d(99)}
        out = {"rules": n, "rules_target": TCPLB_MAX_RULES,
               "build_s": build_s, "acl_rules": len(acl),
               "backends": TCPLB_BACKENDS,
               "splice_connections": len(lat), "splice_matched": matched,
               "splice_wall_s": splice_s,
               "connect_to_first_byte_p50_us": pct(lat, 50),
               "connect_to_first_byte_p99_us": pct(lat, 99),
               "keepalive_requests": keepalive * KEEPALIVE_REQS,
               "keepalive_matched": ka_matched, "keepalive_wall_s": ka_s,
               "accept_stage_us": stages,
               "classify_latency": st.latency_percentiles(),
               "batches": batches,
               "launches": launches, "fp_launches": fp_launches,
               "backend": want_be, "failovers": st.failovers - f0,
               "b3_torch_tier_cuda_calls": torch_tier_cuda,
               "b3_on_path": path_b3,
               "provider": vtl.PROVIDER,
               "libvtl": os.path.relpath(vtl.LIB_PATH, os.path.dirname(
                   os.path.abspath(__file__)))}
    finally:
        for lb in lbs:
            lb.stop()
        for g in groups:
            g.close()
        clients.shutdown()
        elg.close()
        try:
            pipe.send("stop")
        except OSError:
            pass
        backends.join(10)
        if backends.is_alive():
            backends.terminate()
            backends.join(5)
        ClassifyService.reset()
        for k, v in (("VPROXY_TPU_CLASSIFY", mode),
                     ("VPROXY_TPU_MATCHER", env_matcher)):
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def bucket_percentile(b1, b0):
    """Percentile (us) of the log2-bucket delta b1 - b0 of a metrics
    Histogram: the upper bound of the bucket that holds it (the +Inf
    bucket reads 2**27)."""
    d = [x - y for x, y in zip(b1, b0)]
    total = sum(d)

    def at(q: int) -> float:
        if total <= 0:
            return 0.0
        want, cum = total * q / 100, 0
        for i, n in enumerate(d):
            cum += n
            if cum >= want:
                return float(1 << i)
        return float(1 << len(d))
    return at


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


def work(ht, q, mtab=None, slots=None):
    """(bytes, int ops) this batch needs: every query input read once,
    the output written once, and each table row the batch's data
    touches counted once — slot + key rows of valid probes, bucket
    items of live buckets, meta + byte rows of live candidates, the
    wildcard lists, the Maglev slots and entries (B1; none for B3,
    mtab=None). Ops: byte compares (probe keys, candidate rows) plus ~24
    integer ops per live candidate."""
    from vproxy_tpu_torch.ops import fused as F
    from vproxy_tpu_torch.ops.hashmatch import _items
    nbytes = sum(v.numel() * v.element_size() for v in q.values())
    nbytes += q["hostb"].shape[0] * 2 * 4  # the [B, 2] output
    if mtab is not None:
        nbytes += slots.numel() * 8
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
    if mtab is not None:
        nbytes += torch.unique(slots).numel() * 4
    return nbytes, ops


def phase_times(device, keep):
    """B1's rows, B3's rows (its verdict-only mode against
    hashmatch.hint_hash_match, the torch tier it replaces) and B1's
    sweep, on the 100k uri table. -> (B1 rows, B3 rows, sweep)."""
    from vproxy_tpu_torch.ops import fused as F
    from vproxy_tpu_torch.ops import fused_cuda as FC
    from vproxy_tpu_torch.ops import hashmatch as H
    from vproxy_tpu_torch.utils.torchenv import tables_from_reference
    rules, tab, ht, mtab = keep
    unpacked = tables_from_reference(tab.arrays, device)
    rows, b3_rows = [], []
    saved = (FC.fused_classify_pick_cuda.launches,
             FC.hint_match_cuda.launches)
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
        row = time_row(b, lambda: FC.hint_match_cuda(ht, q),
                       lambda: H.hint_hash_match(unpacked, q), KERNEL, flush,
                       work(ht, q))
        b3_rows.append(row)
        log("times B3 " + json.dumps(row))
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
    FC.fused_classify_pick_cuda.launches, FC.hint_match_cuda.launches = saved
    del flush
    log("clocks " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return rows, b3_rows, sweep


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


def _oracle_init(path: str) -> None:
    global _ORACLE
    import pickle
    from vproxy_tpu_torch.rules.engine import CidrMatcher
    with open(path, "rb") as f:
        nets, acl = pickle.load(f)
    _ORACLE = CidrMatcher(nets, acl=acl, backend="host")


def _oracle_one(q):
    return _ORACLE.oracle_snap(_ORACLE.snapshot(), *q)


def oracle_answers(pool, queries):
    """Start the linear oracle_snap of every (addr, port) on `pool`
    (oracle_pool): -> an AsyncResult of the answers, in order."""
    return pool.map_async(_oracle_one, queries, chunksize=16)


@contextlib.contextmanager
def oracle_pool(snap):
    """A pool of worker processes (spawned: this process has threads),
    one per core, each holding a host-backend CidrMatcher over the
    snapshot's rule lists: the linear scan of the reference's lists
    takes ~30 ms a query over 50k routes, too long for one core. The
    lists reach the workers through a temporary file: a spawned
    worker's start-up arguments go through a pipe, and 50k routes there
    make the parent wait for each worker's interpreter start in turn
    (~2 s a worker)."""
    import multiprocessing
    import pickle
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".pkl") as f:
        pickle.dump((snap[1], snap[2]), f)
        f.flush()
        with multiprocessing.get_context("spawn").Pool(
                min(8, os.cpu_count() or 1), initializer=_oracle_init,
                initargs=(f.name,)) as pool:
            yield pool


def phase_cidr_service(routes, group, am, acl):
    """The CIDR main path: the SecurityGroup's allow_async and a route
    CidrMatcher's submit_cidr through ClassifyService, every answer
    equal to the CidrIndex lookup and the linear oracle (worker
    processes, which run while the bursts are served). -> (launches of
    the CIDR kernel during the run, {"acl": (rules, queries, oracle
    answers), "routes": (networks, queries, oracle answers)}: the
    fingerprint phase holds its answers to the same oracle)."""
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
    return launches, {"acl": (asnap[2], aqs, a_orc),
                      "routes": (rsnap[1], rqs, r_orc)}


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


def same(a, b) -> bool:
    """torch.equal over a tensor or over the tensors of two tuples."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return len(a) == len(b) and all(map(torch.equal, a, b))


def time_row(b, kern, plain, name, flush, work_, launches=1):
    """One timing row: device ms per call of `kern` (the `launches`
    kernels of it whose name holds `name`) L2-warm and after a 256 MB
    write (cold), its plain tier's, wall ms per call back to back, and
    the bound from work_ = (bytes, ops)."""
    check(same(kern(), plain()), f"{name} != plain at B={b}")
    p1 = device_ms(plain, 10)
    k1 = device_ms(kern, 200, name, launches)
    k2 = device_ms(kern, 200, name, launches)
    p2 = device_ms(plain, 10)
    c1 = device_ms(lambda: (flush.zero_(), kern()), 50, name, launches)
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


# ---------------------------------------------- the fingerprint backend
# The port's "torch-fp" backend (VPROXY_TPU_MATCHER=jax-fp): hint
# batches launch B6 (csrc/fp_hint.cu), cidr batches B7
# (csrc/fp_cidr.cu). On CPU tensors (the tests run these phases small)
# the kernels' places are taken by the plain tier and no launch is
# expected.


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def fp_tables(device, n_rules=N_RULES, n_routes=N_ROUTES, n_acl=N_ACL):
    """The fingerprint backend's serving objects, published on `device`:
    a HintMatcher of n_rules rules (mk_rules) and a FusedPair with the
    Maglev table over it, a route CidrMatcher of n_routes routes and a
    SecurityGroup of the n_acl-rule TCP ACL (BASELINE config #4, not
    cut), all on "torch-fp". -> dict of them (and the rule lists)."""
    from vproxy_tpu_torch.components.secgroup import SecurityGroup
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules import maglev as M
    from vproxy_tpu_torch.rules.ir import Proto
    t0 = time.monotonic()
    rules = mk_rules(n_rules)
    hm = E.HintMatcher(rules, backend="torch-fp", device=device)
    t1 = time.monotonic()
    mm = M.MaglevMatcher(backends(), m=MAGLEV_M, device=device)
    nets = route_nets(n_routes, ROUTE_SEED)
    routes = E.CidrMatcher(nets, backend="torch-fp", device=device)
    t2 = time.monotonic()
    acl = acl_rules(n_acl, ACL_SEED)
    group = SecurityGroup("acl-fp", default_allow=False, backend="torch-fp")
    group.extend_rules(acl)
    am = group._tables[Proto.TCP][0]
    log(f"fp tables: {n_rules} hint rules in {t1 - t0:.1f} s, {n_routes} "
        f"routes in {t2 - t1:.1f} s, ACL of {n_acl} in "
        f"{time.monotonic() - t2:.1f} s; caps hint {hm._caps}, routes "
        f"{routes._caps}, ACL {am._caps}; bytes "
        f"{hm.published_table_bytes()} + {routes.published_table_bytes()}"
        f" + {am.published_table_bytes()}")
    return {"rules": rules, "hm": hm, "mm": mm, "pair": M.FusedPair(hm, mm),
            "nets": nets, "routes": routes, "acl": acl, "group": group,
            "am": am}


def fp_hint_batch(tab, hints, b: int, device) -> dict:
    """`hints` encoded for the fingerprint table and padded to b rows as
    the engine pads a batch (zero fill: no live probe)."""
    from vproxy_tpu_torch.ops import fphash as FP
    from vproxy_tpu_torch.rules.engine import _pad_hint_q
    from vproxy_tpu_torch.utils.torchenv import tables_from_reference
    q = FP.encode_hint_queries_fp(hints, tab)
    if b > len(hints):
        q = _pad_hint_q(q, b, {})
    return tables_from_reference(q, device)


def b6_vs_plain(name, t, q, device) -> int:
    """B6 against fphash.hint_fp_match on the same tensors, int32-equal
    in index and level (on CPU tensors the plain tier against itself).
    -> max |kernel - plain|."""
    from vproxy_tpu_torch.ops import fphash as FP
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    ri, rl = FP.hint_fp_match(t, q)
    gi, gl = FPC.hint_fp_cuda(t, q) if device.type == "cuda" else (ri, rl)
    _sync(device)
    d = max(int((gi.long() - ri.long()).abs().max()),
            int((gl.long() - rl.long()).abs().max()))
    log(f"B6 vs plain [{name}]: b {gi.shape[0]} P {q['hp_slot'].shape[1]} "
        f"U {q['up_slot'].shape[1]} um={'um_fp1' in q} E x M "
        f"{tuple(t['h_em'].shape)} / {tuple(t['u_em'].shape)} matched "
        f"{int((ri >= 0).sum())} max_abs_err {d}")
    check(torch.equal(gi, ri) and torch.equal(gl, rl),
          f"B6 != plain [{name}]")
    return d


def b7_vs_plain(name, t, a16, fam, port, device) -> int:
    """B7 against fphash.cidr_fp_match, int32-equal. -> max |kernel -
    plain|."""
    from vproxy_tpu_torch.ops import fphash as FP
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    ref = FP.cidr_fp_match(t, a16, fam, port)
    got = FPC.cidr_fp_cuda(t, a16, fam, port) if device.type == "cuda" \
        else ref
    _sync(device)
    d = int((got.long() - ref.long()).abs().max())
    log(f"B7 vs plain [{name}]: b {got.shape[0]} G {t['g_fam'].shape[0]} "
        f"E {t['e_m'].shape[0]} trie={'t_l0' in t} acl={'mrows' in t} "
        f"port={port is not None} matched {int((ref >= 0).sum())}/"
        f"{int((fam >= 0).sum())} max_abs_err {d}")
    check(torch.equal(got, ref), f"B7 != plain [{name}]")
    check(bool((got[fam < 0] == -1).all()), f"B7 pad row matched [{name}]")
    return d


def fp_prepared(arrays: dict, device, hint: bool):
    """A compiled table's arrays as tensors on `device`, prepared for its
    kernel on the card."""
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    from vproxy_tpu_torch.utils.torchenv import tables_from_reference
    t = tables_from_reference(arrays, device)
    if device.type != "cuda":
        return t
    return FPC.prepare_hint_table(t) if hint else FPC.prepare_cidr_table(t)


def fp_hint_cases():
    """-> (name, rules, hints) of each B6 parity set (besides the 100k
    tables): the cuckoo kernels' CPU sets and the fingerprint ones."""
    rules = rand_rules(300, 11)
    yield "random_300_b600", rules, rand_hints(rules, 600, 11)
    for name, gen in (("shared_keys", shared_keys),
                      ("long_hosts", long_hosts),
                      ("wide_buckets", wide_buckets),
                      ("member_overflow", fp_member_overflow),
                      ("uri_untrimmed", fp_uri_untrimmed)):
        yield (name, *gen())
    for name in BOUNDARY_CASES:
        rules, hints, _ = boundary(name)
        yield name, rules, hints


def fp_cidr_cases():
    """-> (name, nets, acl or None, [(addr, port or None)], caps) of each
    B7 parity set besides config #4's tables: the CPU sets of the CIDR
    kernel (a trie ACL among them), routes without the trie, the
    fingerprint sets (a wide route first, an ACL trie of overlaps, an
    ACL past 128 stacked rules, v6 only)."""
    for name, nets, acl, q in small_cidr_cases():
        yield name, nets, acl, q, None
    nets = route_nets(2000, 5)
    yield ("routes_2k no_trie", nets, None,
           [(a, None) for a, _ in cidr_queries(nets, 600, 6)],
           {"no_trie": 1})
    nets, addrs = fp_trie_first_match()
    yield "trie_first_match", nets, None, [(a, None) for a in addrs], None
    for name, (acl, q) in (("trie_acl_overlap", fp_trie_acl_overlap()),
                           ("acl_stacked", fp_acl_stacked())):
        yield name, [r.network for r in acl], acl, q, None
        yield (f"{name} port=None", [r.network for r in acl], acl,
               [(a, None) for a, _ in q], None)
    nets, addrs = fp_v6_only()
    yield "v6_only", nets, None, [(a, None) for a in addrs], None


def phase_fp_kernels(device, tabs, batches=TIME_BATCHES, n_host=N_RULES):
    """B6 and B7 int32-exact against their plain versions: B6 on the
    published 100k table (uri rules) and a 100k host-only table at every
    B of `batches`, an eighth of each batch pad rows, and on
    fp_hint_cases (+8 pad rows); B7 on config #4's routes (trie + V6
    groups) and ACL (the touch limit: V4 and V6 groups; ports and None)
    at every B (v4, ::v4, ::ffff:v4, v6 and pad rows), and on
    fp_cidr_cases; classify_fp_all's [B, 3] (B6, then B7 twice into one
    output) against the plain tier at the largest B. Launch counts are
    restored after. -> {"b6": err, "b7": err, "all": err, "layouts":
    ...}."""
    from vproxy_tpu_torch.ops import fphash as FP
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    saved = (FPC.hint_fp_cuda.launches, FPC.cidr_fp_cuda.launches)
    hm, routes, am = tabs["hm"], tabs["routes"], tabs["am"]
    hsnap = hm.snapshot()
    b6 = b7 = 0
    um_seen = set()
    host_rules = mk_host_rules(n_host)
    host_tab = FP.compile_hint_fp(host_rules)
    host_t = fp_prepared(host_tab.arrays, device, True)
    for name, tab, t, rules in (("100k uri", hsnap[0], hsnap[1],
                                 tabs["rules"]),
                                ("100k host-only", host_tab, host_t,
                                 host_rules)):
        for b in batches:
            q = fp_hint_batch(tab, mk_queries(rules, b - b // 8,
                                              seed=900 + b), b, device)
            um_seen.add("um_fp1" in q)
            b6 = max(b6, b6_vs_plain(f"{name} B={b}, {b // 8} pad rows", t,
                                     q, device))
    for name, rules, hints in fp_hint_cases():
        tab = FP.compile_hint_fp(rules)
        q = fp_hint_batch(tab, hints, len(hints) + 8, device)
        um_seen.add("um_fp1" in q)
        b6 = max(b6, b6_vs_plain(name, fp_prepared(tab.arrays, device, True),
                                 q, device))
    check(um_seen == {True, False}, f"B6 ran um_* batches {um_seen} only")
    rt, at = routes.snapshot()[0], am.snapshot()[0]
    layouts = {"routes": ("t_l0" in rt, int((rt["g_fam"] == 1).sum())),
               "acl": ("t_l0" in at, int((at["g_fam"] >= 0).sum()))}
    check(layouts["routes"][0] and layouts["routes"][1] > 0 and
          not layouts["acl"][0] and layouts["acl"][1] > 0,
          f"config #4's fp layouts are not trie + V6 groups (routes) and "
          f"groups (ACL): {layouts}")
    for b in batches:
        real = b - b // 8
        rq = [(a, None) for a, _ in cidr_queries(tabs["nets"], real,
                                                  600 + b)]
        b7 = max(b7, b7_vs_plain(f"routes 50k B={b}", rt,
                                 *cidr_batch(rq, b, device), device))
        aq = acl_queries(tabs["acl"], real, 700 + b)
        b7 = max(b7, b7_vs_plain(f"ACL 5k B={b}", at,
                                 *cidr_batch(aq, b, device), device))
        b7 = max(b7, b7_vs_plain(
            f"ACL 5k B={b} port=None", at,
            *cidr_batch([(a, None) for a, _ in aq], b, device), device))
    kinds = set()
    for name, nets, acl, q, caps in fp_cidr_cases():
        t = fp_prepared(FP.compile_cidr_fp(nets, acl=acl, caps=caps).arrays,
                        device, False)
        kinds.add(("t_l0" in t, "mrows" in t))
        b7 = max(b7, b7_vs_plain(name, t, *cidr_batch(q, len(q) + 8,
                                                      device), device))
    check(len(kinds) == 4, f"B7 cases covered layouts {sorted(kinds)} (trie"
          f" / groups x routes / ACL)")
    b = max(batches)
    real = b - b // 8
    hq = fp_hint_batch(hsnap[0], mk_queries(tabs["rules"], b, seed=950),
                       b, device)
    aq = acl_queries(tabs["acl"], real // 2, 951)
    addrs = [(a, p) for a, p in aq] + [
        (a, 1024 + i) for i, (a, _) in enumerate(
            cidr_queries(tabs["nets"], real - len(aq), 952))]
    a16, fam, port = cidr_batch(addrs, b, device)
    ref = FP.classify_fp_all(hsnap[1], rt, at, hq, a16, fam, port)
    n0 = (FPC.hint_fp_cuda.launches, FPC.cidr_fp_cuda.launches)
    got = FPC.classify_fp_all(hsnap[1], rt, at, hq, a16, fam, port)
    _sync(device)
    n1 = (FPC.hint_fp_cuda.launches, FPC.cidr_fp_cuda.launches)
    on_card = device.type == "cuda"
    check(n1[0] - n0[0] == (1 if on_card else 0) and
          n1[1] - n0[1] == (2 if on_card else 0),
          f"classify_fp_all launched B6 {n1[0] - n0[0]}, B7 "
          f"{n1[1] - n0[1]} times")
    err_all = int((got.long() - ref.long()).abs().max())
    log(f"classify_fp_all vs plain [100k + config #4, B={b}]: matched "
        f"{[int((ref[:, k] >= 0).sum()) for k in range(3)]} max_abs_err "
        f"{err_all}")
    check(got.shape == (b, 3) and torch.equal(got, ref),
          "classify_fp_all != plain")
    FPC.hint_fp_cuda.launches, FPC.cidr_fp_cuda.launches = saved
    return {"b6": b6, "b7": b7, "all": err_all, "layouts": layouts}


def phase_fp_service(device, tabs, bursts=BURSTS, burst=SERVICE_BATCH,
                     cidr_oracle=None):
    """The fingerprint backend's main path through ClassifyService in
    "device" mode: bursts x burst submit_hint on the torch-fp
    HintMatcher, as many submit_classify_pick on the FusedPair over it
    (B6 plus the Maglev take: the backend fuses nothing), SecurityGroup
    allow_async on config #4's ACL and submit_cidr on the 50k routes.
    Every answer equal to the host index (CidrIndex and the linear
    oracle_snap for CIDR, in worker processes); one B6 launch per hint
    or cpick batch, one B7 launch per cidr batch, B1 / B3 / B4 never, no
    failover. The CIDR queries and their linear-oracle answers are
    phase 7's (`cidr_oracle`, from phase_cidr_service, over the same rule
    lists; the scan of 50k routes takes minutes of CPU); without it the
    oracle runs here (small tables). -> the phase's numbers."""
    from vproxy_tpu_torch.ops import cidr_cuda as CC
    from vproxy_tpu_torch.ops import fphash as FP
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    from vproxy_tpu_torch.ops import fused_cuda as FC
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules import maglev as M
    from vproxy_tpu_torch.rules import oracle
    from vproxy_tpu_torch.rules.ir import Proto
    from vproxy_tpu_torch.rules.service import ClassifyService
    hm, pair, routes, group, am, acl = (tabs[k] for k in (
        "hm", "pair", "routes", "group", "am", "acl"))
    n = bursts * burst
    hsnap, msnap = hm.snapshot(), pair.mm.snapshot()
    asnap, rsnap = am.snapshot(), routes.snapshot()
    sub = am.snap_payload(asnap)
    if cidr_oracle is None:
        aqs = [acl_queries(acl, burst, 2000 + k) for k in range(bursts)]
        rqs = [[(a, None) for a, _ in cidr_queries(rsnap[1], burst,
                                                   2100 + k)]
               for k in range(bursts)]
        a_orc = [am.oracle_snap(asnap, *q) for b in aqs for q in b]
        r_orc = [routes.oracle_snap(rsnap, *q) for b in rqs for q in b]
    else:
        (acl_o, aqs, a_orc), (nets_o, rqs, r_orc) = (
            cidr_oracle["acl"], cidr_oracle["routes"])
        check(list(map(repr, acl_o)) == list(map(repr, acl)) and
              list(map(repr, nets_o)) == list(map(repr, rsnap[1])) and
              len(aqs) == len(rqs) == bursts and
              all(len(q) == burst for q in aqs + rqs),
              "phase 7's oracle is not over these rules and bursts")
    others = (FC.fused_classify_pick_cuda, FC.hint_match_cuda,
              CC.cidr_first_cuda)
    other0 = [f.launches for f in others]
    ClassifyService.reset()
    svc = ClassifyService.get()  # the one allow_async submits to
    svc.mode = "device"
    try:
        # the main path's counts, read just after it
        FPC.hint_fp_cuda.launches = FPC.cidr_fp_cuda.launches = 0
        FP.hint_fp_match.cuda_calls = 0
        f0, l0 = E.fused_dispatches_total(), E.dispatch_launches_total()
        t0 = time.monotonic()
        for k in range(bursts):
            hints = mk_queries(tabs["rules"], burst, seed=2200 + k)
            got = _answers(svc, lambda h, cb: svc.submit_hint(hm, h, cb),
                           [(h,) for h in hints])
            for i, h in enumerate(hints):
                check(got[i] == (hm.index_snap(hsnap, h),),
                      f"fp hint burst {k} row {i}")
        hint_s = time.monotonic() - t0
        t0 = time.monotonic()
        for k in range(bursts):
            hints = mk_queries(tabs["rules"], burst, seed=2300 + k)
            ips = mk_ips(burst, seed=2400 + k)
            ports = [None if i % 3 == 0 else 1024 + i
                     for i in range(burst)]
            got = _answers(
                svc, lambda h, ip, port, cb: svc.submit_classify_pick(
                    pair, h, ip, port, cb), list(zip(hints, ips, ports)))
            for i in range(burst):
                want = (hm.index_snap(hsnap, hints[i]),
                        M.pick(msnap[0], ips[i], ports[i]))
                check(got[i] == want, f"fp cpick burst {k} row {i}: "
                      f"{got[i]} != host {want}")
        cpick_s = time.monotonic() - t0
        t0 = time.monotonic()
        a_got = [_answers(svc, lambda a, p, cb: group.allow_async(
            Proto.TCP, a, p, lambda ok: cb(ok, None)), q) for q in aqs]
        r_got = [_answers(svc, lambda a, p, cb: svc.submit_cidr(
            routes, a, p, cb), q) for q in rqs]
        cidr_s = time.monotonic() - t0
        launches = {"hint_fp": FPC.hint_fp_cuda.launches,
                    "cidr_fp": FPC.cidr_fp_cuda.launches}
        st = svc.stats
        batches = {k: st.by_kind.get(k, [0])[0] for k in
                   ("hint", "cpick", "cidr")}
        on_card = device.type == "cuda"
        check(st.failovers == 0, f"{st.failovers} device failovers")
        check(st.device_queries == 4 * n and st.oracle_queries == 0,
              f"device answered {st.device_queries} of {4 * n}")
        check(launches["hint_fp"] == (batches["hint"] + batches["cpick"]
                                      if on_card else 0)
              and batches["hint"] > 0 and batches["cpick"] > 0,
              f"B6 launches {launches['hint_fp']} != hint + cpick "
              f"batches {batches}")
        check(launches["cidr_fp"] == (batches["cidr"] if on_card else 0)
              and batches["cidr"] > 0,
              f"B7 launches {launches['cidr_fp']} != cidr batches "
              f"{batches}")
        check(E.fused_dispatches_total() == f0,
              "an fp cpick batch took the fused dispatch")
        check(E.dispatch_launches_total() - l0 == batches["hint"] +
              2 * batches["cpick"] + batches["cidr"],
              "engine launches != hint + 2 x cpick + cidr batches")
        check([f.launches for f in others] == other0,
              "the fp path launched B1, B3 or B4")
        check(FP.hint_fp_match.cuda_calls == 0,
              "B6's plain tier ran on CUDA tensors")
        out = {"queries": 4 * n, "batches": batches,
               "launches": launches, "failovers": st.failovers,
               "max_batch": st.max_batch, "hint_wall_s": hint_s,
               "cpick_wall_s": cpick_s, "cidr_wall_s": cidr_s,
               "classify_latency": st.latency_percentiles()}
        log(f"fp service: {json.dumps(out)}")
    finally:
        ClassifyService.reset()
    for k in range(bursts):
        for i, (a, p) in enumerate(aqs[k]):
            j = am.index_snap(asnap, a, p)
            check(j == a_orc[k * burst + i],
                  f"fp ACL burst {k} row {i}: CidrIndex {j} != oracle")
            want = sub[j].allow if j >= 0 else group.default_allow
            check(a_got[k][i] == (want,), f"fp ACL burst {k} row {i}: "
                  f"{a_got[k][i]} != {want} (rule {j})")
        for i, (a, p) in enumerate(rqs[k]):
            j = routes.index_snap(rsnap, a, p)
            check(j == r_orc[k * burst + i] and r_got[k][i] == (j,),
                  f"fp route burst {k} row {i}: {r_got[k][i]}, CidrIndex "
                  f"{j}, oracle {r_orc[k * burst + i]}")
    for h in mk_queries(tabs["rules"], 32, seed=2500):
        check(hm.index_snap(hsnap, h) == oracle.search(tabs["rules"], h),
              f"host index != linear oracle for {h}")
    return out


def fp_hint_work(t, q):
    """(bytes, int ops) one B6 launch needs for this batch: every query
    array read once and two int32 written per query, the wildcard lists
    once, and per distinct live probe row its E fingerprint pairs, per
    distinct matched entry its M member records. Ops: 2 per entry
    compare, ~30 per member scored (the wildcard members every query)."""
    b = q["hp_slot"].shape[0]
    nbytes = sum(v.numel() * v.element_size() for v in q.values()) + b * 8
    nbytes += (t["wh_rec"].numel() + t["wu_rec"].numel()) * 4
    ops = b * (t["wh_rec"].shape[0] + t["wu_rec"].shape[0]) * 30
    for pre, live, em in (("hp", q["hp_level"] > 0, t["h_em"]),
                          ("up", q["up_score"] > 0, t["u_em"])):
        e, m = em.shape
        s = q[f"{pre}_slot"][live].long()
        nbytes += torch.unique(s).numel() * e * 8
        ents = t["rec"][s][:, : e * (2 + 4 * m)].reshape(-1, e, 2 + 4 * m)
        ok = (ents[..., 0] == q[f"{pre}_fp1"][live][:, None]) & \
            (ents[..., 1] == q[f"{pre}_fp2"][live][:, None])
        hit = ok.any(dim=1)
        entry = s[hit] * e + ok.int().argmax(dim=1)[hit]
        nbytes += torch.unique(entry).numel() * m * 16
        ops += s.numel() * 2 * e + int(hit.sum()) * m * 30
    return nbytes, ops


def fp_cidr_work(t, a16, fam, port):
    """(bytes, int ops) one B7 launch needs for this batch: every
    query's address, family (and port, for an ACL) read once and its
    answer written once, the group arrays once; per V4 query of a trie
    table the distinct cells it walks (and, for an ACL, its member row);
    per (query, group of its family) the distinct slot rows of E x 12
    bytes and, for an ACL, the matched entries' member rows. Ops: ~50
    per group probe (3 hashes of 4 FNV rounds + fmix32, the mask and the
    entry compares), ~6 per trie level, ~4 per member."""
    from vproxy_tpu_torch.ops import fphash as FP
    b, g = a16.shape[0], t["g_fam"].shape[0]
    acl = "mrows" in t
    mk2 = t["mrows"].shape[1] if acl else 0
    nbytes = b * (16 + 4 + 4) + (b * 4 if acl and port is not None else 0)
    nbytes += g * 40
    ops = 0
    mrows = []
    trie = (fam == 0) if "t_l0" in t else torch.zeros_like(fam,
                                                           dtype=torch.bool)
    if bool(trie.any()):
        a = a16[trie].long()
        i0 = a[:, 12] * 256 + a[:, 13]
        v = t["t_l0"][i0].long()
        deeper = v < 0
        i1 = (-v[deeper] - 1) * 256 + a[deeper, 14]
        v[deeper] = t["t_l1"][i1].long()
        deeper = v < 0
        i2 = (-v[deeper] - 1) * 256 + a[deeper, 15]
        nbytes += 4 * sum(torch.unique(i).numel() for i in (i0, i1, i2))
        ops += 6 * (i0.numel() + i1.numel() + i2.numel())
        if acl:
            mrows.append(FP._trie4_lookup(t, a16[trie]))
    grp = (fam >= 0) & ~trie
    if bool(grp.any()):
        e = t["e_m"].shape[0]
        aw = FP._pack_words16_dev(a16[grp])
        masked = aw[:, None, :] & t["g_mask4"].to(torch.int64)[None]
        hs = FP._fnv32_words_dev(masked, t["g_salt_s"])
        slot = (t["g_off"].long()[None] + (hs & t["g_capmask"].long()[None])
                ).clamp(0, t["rec"].shape[0] - 1)
        gok = t["g_fam"][None] == fam[grp][:, None]
        nbytes += torch.unique(slot[gok]).numel() * e * 12
        ops += int(gok.sum()) * 50
        if acl:
            f1 = FP._u32_as_i32(FP._fnv32_words_dev(masked,
                                                    t["g_salt_f1"]))
            f2 = FP._u32_as_i32(FP._fnv32_words_dev(masked,
                                                    t["g_salt_f2"]))
            ents = t["rec"][slot].reshape(slot.shape[0], g, e, 3)
            ok = (ents[..., 0] == f1[..., None]) & \
                (ents[..., 1] == f2[..., None]) & gok[..., None]
            mrows.append(ents[..., 2][ok].long())
    if mrows:
        rows = torch.cat(mrows)
        rows = torch.unique(rows[rows > 0])
        nbytes += rows.numel() * mk2 * 4
        ops += rows.numel() * mk2 * 2
    return nbytes, ops


def phase_fp_times(device, tabs):
    """B6 on the published 100k table (uri rules), B7 on config #4's
    routes and ACL (with ports), and classify_fp_all (B6 + B7 twice) at
    every TIME_BATCHES, with time_row: warm and cold device time, the
    plain tier's, the wall time per call and the bound. The 100k slot
    table is 155.7 MB, three times the 50 MB L2: a warm row is the time
    with what the previous launch of the same batch left in L2, not an
    all-L2 time. -> {"B6": rows, "B7 routes": rows, "B7 ACL": rows,
    "classify_fp_all": rows}."""
    from vproxy_tpu_torch.ops import fphash as FP
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    hsnap = tabs["hm"].snapshot()
    rt, at = tabs["routes"].snapshot()[0], tabs["am"].snapshot()[0]
    saved = (FPC.hint_fp_cuda.launches, FPC.cidr_fp_cuda.launches)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    out = {"B6": [], "B7 routes": [], "B7 ACL": [], "classify_fp_all": []}
    for b in TIME_BATCHES:
        q = fp_hint_batch(hsnap[0], mk_queries(tabs["rules"], b, 2600 + b),
                          b, device)
        row = time_row(b, lambda: FPC.hint_fp_cuda(hsnap[1], q),
                       lambda: FP.hint_fp_match(hsnap[1], q), KERNEL_B6,
                       flush, fp_hint_work(hsnap[1], q))
        out["B6"].append(row)
        log("times B6 " + json.dumps(row))
        for label, t, queries in (
                ("B7 routes", rt, [(a, None) for a, _ in cidr_queries(
                    tabs["nets"], b, 2700 + b)]),
                ("B7 ACL", at, acl_queries(tabs["acl"], b, 2800 + b))):
            a16, fam, port = cidr_batch(queries, b, device)
            row = time_row(b, lambda: FPC.cidr_fp_cuda(t, a16, fam, port),
                           lambda: FP.cidr_fp_match(t, a16, fam, port),
                           KERNEL_B7, flush, fp_cidr_work(t, a16, fam, port))
            out[label].append(row)
            log(f"times {label} " + json.dumps(row))
        aq = acl_queries(tabs["acl"], b, 2900 + b)
        a16, fam, port = cidr_batch(aq, b, device)
        works = [fp_hint_work(hsnap[1], q), fp_cidr_work(rt, a16, fam, None),
                 fp_cidr_work(at, a16, fam, port)]
        row = time_row(
            b, lambda: FPC.classify_fp_all(hsnap[1], rt, at, q, a16, fam,
                                           port),
            lambda: FP.classify_fp_all(hsnap[1], rt, at, q, a16, fam, port),
            "fp_", flush,
            # one [B, 3] answer, the address batch read once
            (sum(w[0] for w in works) - b * 4 - b * 20,
             sum(w[1] for w in works)), launches=3)
        out["classify_fp_all"].append(row)
        log("times classify_fp_all " + json.dumps(row))
    FPC.hint_fp_cuda.launches, FPC.cidr_fp_cuda.launches = saved
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
    phase_s = {}

    def run(name, fn, *args, **kwargs):
        """fn(*args, **kwargs), its wall seconds kept in phase_s."""
        t0 = time.monotonic()
        out = fn(*args, **kwargs)
        phase_s[name] = time.monotonic() - t0
        return out

    builds = run("build", phase_build)
    err, b3_err, keep = run("kernels", phase_kernel_vs_plain, device)
    launches, pair = run("service", phase_service, device, keep[0])
    loop, _ = run("loop", phase_loop, device, pair, keep[0])
    log(json.dumps({"loop": {**loop, "card": smi}}))
    tcplb = run("tcplb", phase_tcplb, device)
    log(json.dumps({"tcplb": {**tcplb, "card": smi}}))
    routes, group, am, acl = run("cidr tables", cidr_tables, device)
    b4_err, rc_err = run("cidr kernels", phase_cidr_vs_plain, device, keep,
                         routes, am, acl)
    b4_launches, oracle = run("cidr service", phase_cidr_service, routes,
                              group, am, acl)
    rc_launches = run("route column", phase_route_column, pair, routes)
    fp = run("fp tables", fp_tables, device)
    fp_err = run("fp kernels", phase_fp_kernels, device, fp)
    fp_svc = run("fp service", phase_fp_service, device, fp,
                 cidr_oracle=oracle)
    log(json.dumps({"fp_service": {**fp_svc, "card": smi}}))
    tcplb_fp = run("tcplb_fp", phase_tcplb, device,
                   max_rules=TCPLB_MIN_RULES, bursts=1, matcher="jax-fp")
    log(json.dumps({"tcplb_fp": {**tcplb_fp, "card": smi}}))
    rows, b3_rows, sweep = run("times", phase_times, device, keep)
    crows = run("cidr times", phase_cidr_times, device, keep, routes, am,
                acl)
    fp_rows = run("fp times", phase_fp_times, device, fp)
    log(json.dumps({"phase_s": phase_s}))
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
        entry("cidr_first", SOURCE_B4, REPLACES_B4,
              b4_launches + tcplb["launches"]["cidr_first"], b4_err,
              crows["B4 ACL"], table="ACL 5k, ports",
              launches_by_path={"cidr service": b4_launches,
                                "tcplb": tcplb["launches"]["cidr_first"]},
              build_s=builds["cidr"]["build_s"],
              instances=builds["cidr"]["instances"],
              by_batch={"acl": crows["B4 ACL"],
                        "routes": crows["B4 routes"]},
              host_breakdown={"acl": crows["breakdown ACL"],
                              "routes": crows["breakdown routes"]}),
        entry("hint_match", SOURCE, REPLACES_B3,
              tcplb["launches"]["hint_match"], b3_err, b3_rows,
              mode="B1's kernel, verdict-only (null Maglev column)",
              plain="hashmatch.hint_hash_match",
              launches_by_path={"tcplb": tcplb["launches"]["hint_match"]},
              by_batch=b3_rows),
        entry("hint_fp_match", SOURCE_B6, REPLACES_B6,
              fp_svc["launches"]["hint_fp"] +
              tcplb_fp["fp_launches"]["hint_fp"], fp_err["b6"], fp_rows["B6"],
              launches_by_path={
                  "fp service": fp_svc["launches"]["hint_fp"],
                  "tcplb_fp": tcplb_fp["fp_launches"]["hint_fp"]},
              build_s=builds["fp_hint"]["build_s"],
              instances=builds["fp_hint"]["instances"],
              by_batch=fp_rows["B6"],
              classify_fp_all={"max_abs_err": fp_err["all"],
                               "by_batch": fp_rows["classify_fp_all"]}),
        entry("cidr_fp_match", SOURCE_B7, REPLACES_B7,
              fp_svc["launches"]["cidr_fp"] +
              tcplb_fp["fp_launches"]["cidr_fp"], fp_err["b7"],
              fp_rows["B7 ACL"], table="ACL 5k, ports",
              launches_by_path={
                  "fp service": fp_svc["launches"]["cidr_fp"],
                  "tcplb_fp": tcplb_fp["fp_launches"]["cidr_fp"]},
              build_s=builds["fp_cidr"]["build_s"],
              instances=builds["fp_cidr"]["instances"],
              layouts=fp_err["layouts"],
              by_batch={"acl": fp_rows["B7 ACL"],
                        "routes": fp_rows["B7 routes"]})]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
