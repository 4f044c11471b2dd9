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
("torch-fp": B6 for hint batches, B7 for cidr batches) and on the
dense backend ("torch-dense": B9 for hint and cidr batches; both
unfused backends take the Maglev column with B5), boots the port
as an operator runs it (`python -m vproxy_tpu_torch`, one config built
by command, DNS-as-LB, Socks5 and the TcpLB served from it), replays
config #4's traffic through the port's virtual switch (routes and ACL
on B4, then on B7), runs the helloworld, kcptun and WebSocks apps as
child processes and the docker network plugin (its VPCs' routes on
B4), runs the sharded backends ("torch-sharded",
"torch-fp-sharded": B8 over 4 rule shards stacked on the card, and
over 1) and the cluster plane (two `python -m vproxy_tpu_torch` nodes
stepping on the card), times the kernels, and prints one JSON line per
result. Phases, in order:

1. environment: a CUDA device, or exit 1; the card's name and power
   limit as nvidia-smi reports them;
2. build: nvcc of csrc/fused_classify_pick.cu, csrc/cidr_first.cu,
   csrc/fp_hint.cu, csrc/fp_cidr.cu, csrc/dense_match.cu,
   csrc/maglev_take.cu and csrc/sharded_match.cu (B8: cuckoo instances
   uri or uri-free by compare word and column set, the fingerprint
   ones and the cross-rank finish pass; B6, B8 and B9's hint each with
   instances of its Maglev column, B9 with its 64-bit key's), and g++
   of the port's
   native/vtl.cpp (the host FD layer; it must
   load as the native provider, from vproxy_tpu_torch/_build/), all
   started together, with their seconds, and per kernel instance (B1:
   uri or uri-free, compare word; B9: hint and cidr; B4, B5, B6, B7:
   one) ptxas's registers and
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
   on backend i mod 256, added one by one until 10,000 or 15 s of build
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
   stacked rules, v6 only, mixed families, 129 v6 groups, last-entry
   matches, a V4 ACL without the trie past one member window), on
   tables cut where the reference clamps or with rows twice as wide
   (fp_table_variant) and on batches cut where B6 clamps a member's
   index (cut_fp_query); classify_fp_all's [B, 3] (B6, then B7 twice
   into one output) against the plain tier; the `fp_design` line: per
   case, the lane rounds, list windows, chain of dependent global-load
   steps and last-entry matches of the kernels' designs
   (fp_hint_design, fp_cidr_design); the phase fails unless both
   kernels' cases take a second round and a second window and match a
   last entry;
7c. fp service (the `fp_service` line): 4 x 512 submit_hint on the
   torch-fp HintMatcher, 4 x 512 submit_classify_pick on a FusedPair
   over it (B6 with its Maglev column: one launch), 4 x 512
   SecurityGroup allow_async on the ACL and 4 x 512 submit_cidr on the
   routes (phase 7's queries), "device" mode; every answer equal to the
   host index (and phase 7's linear oracle for CIDR), one B6 launch per
   hint or cpick batch, no Maglev take (B5), one B7 launch per cidr
   batch, B1 / B3 / B4 never, no failover;
7d. tcplb_fp (the `tcplb_fp` line): phase 5b's http-splice LB with
   VPROXY_TPU_MATCHER=jax-fp, 256 groups, one burst of 512 connections
   (and the keep-alive burst): every backend equal to the host index's
   group, B6 and B7 launched once per batch of their kind, B1, B3, B4
   never;
7d2. the dense backend (dense_tables: the 100k hint rules, a Maglev
   table of 65,537 slots, the 50k routes and the 5k ACL, built with
   VPROXY_TPU_MATCHER=jax-dense; the `dense_kernels` line): B9 int32-
   exact against the plain tier (matchers.hint_match_chunked /
   cidr_first_match_chunked) on the 100k table (uri rules) and a 100k
   host-only table at B = 16 / 512 / 4096 (an eighth pad rows), on
   config #4's routes and ACL (ports and port=None) at every B, on the
   CPU parity sets (dense_hint_cases: a cross-chunk tie, the max-length
   host suffix and an over-long host query, the boundary sets;
   dense_cidr_cases: mixed families, v4-mapped v6 among them);
   classify_all's five outputs (B9 three times) against the plain
   tier; B6 and B9's hint with their Maglev column against their plain
   versions at every B (maglev_column: slots past both ends); a
   "torch-dense" table whose live rules lie past 2^20 (dense_wide_check:
   the 64-bit key) against the plain version and the host index; B5
   against torch indexing and maglev.pick with slots past both ends, at
   every B;
7d3. dense service (the `dense_service` line): 4 x 512 each of
   submit_hint, submit_classify_pick (a FusedPair: B9 with its Maglev
   column), SecurityGroup allow_async and submit_cidr on the dense
   tables, "device" mode; every answer equal to the host index (and
   phase 7's linear oracle for CIDR); one B9 launch per batch, no B5,
   B1 / B3 / B4 / B6 / B7 never, no fused dispatch, no failover, B9's
   plain tier never on the card; then (the `maglev` line) standalone
   Maglev batches, B5's main path: one B5 launch each;
7e. control (the `control` line): the port as an operator runs it.
   `python -m vproxy_tpu_torch` boots in a child process (temporary
   VPROXY_TPU_HOME, "device" classify mode) with a resp-controller, an
   http-controller and the inspection server; one operator config is
   built by command only (RESP, the frontends over HTTP): an Upstream
   of phase 5b's Host rules, one server group each on a loopback
   address of its own at id-server i mod 256, until 10,000 groups or
   20 s (never under 256), one security group with config #4's ACL as
   TCP rules and as UDP rules (each until 5,000 or 20 s, never under
   256), a dns-server, a socks5-server and an http-splice tcp-lb on
   them; 4 x 4,096 DNS queries (512 in flight), 2 x 512 Socks5 domain
   CONNECTs with an HTTP request each, 2 x 512 http-splice connections
   from a spawned client process; every answer the group the port's
   host index gives (or the DNS server's own answer where no rule
   holds the name); from the child's /metrics: launches == device
   batches, no fused (B1) dispatch, no failover, every query answered
   by the device; SIGTERM: exit 0, no config written. `control_fp`:
   the same on VPROXY_TPU_MATCHER=jax-fp (B6, B7) at 256 groups, an
   ACL of 128 rules of each protocol, one burst of each kind;
7f. switch (the `switch` line): BASELINE config #4 on the port's
   virtual switch. The port's Application builds it in process by
   Command.execute: a security group, `add switch`, vpc 1 and vpc 2
   (10.0.0.0/8), a remote-switch link to a loopback receiver, then
   UDP ACL rules and routes one command each until 10 s (never under
   256 of each), the rest of the 5,000 rules and 50,000 routes in bulk
   (bench_switch.py's build_world); 16,384 VXLAN datagrams from 64
   loopback senders (an eighth in deny /24s, an eighth in allow /24s),
   destinations over every route and a sixteenth under none, replayed
   in 1,024-datagram bursts (a) on the object path (B4 once per ACL
   batch and once per route batch), (b) through the switch's UDP
   socket on the default data plane (the numpy fast path and the
   native flow cache, twice: its device launches are recorded, 0
   expected) and (c) on the object path of a second switch built with
   VPROXY_TPU_MATCHER=jax-fp (B7 once per batch); every outcome the
   host indexes' (CidrIndex: the ACL at the switch's port, then the
   routes), the egress bytes of every run identical, the drop
   counters equal to the prediction; prints packets/s per run, the
   `CidrMatcher.match` round trip's p50/p99 and encode share, launches
   per kernel and the build's counts and seconds;
7f2. apps (the `apps` line): `python -m vproxy_tpu_torch helloworld 0`
   as a child, its TCP and UDP echo checked; a kcptun server and a
   kcptun client, each a child, carry 64 concurrent TCP streams of a
   seeded 256 KiB each over one KCP session on loopback to an echo
   server, every byte echoed equal; wall seconds and MB/s; every
   child exits 0 on SIGTERM;
7f3. websocks (the `websocks` line): a `websocks server` child (TCP
   and KCP) and two `websocks agent` children (the TCP transport with
   an HTTP CONNECT front, and the KCP transport), proxying only the
   echo server's port; 256 concurrent SOCKS5 CONNECTs (128 a
   transport) each echoing a seeded 64 KiB, then 16 HTTP CONNECTs;
   with the server stopped, a direct-rule host still echoes through
   the agent and a proxied CONNECT is refused; connect -> first byte
   p50 / p99 and MB/s per transport; the TLS front and shadowsocks are
   not run (the app serves neither; the CPU tests run them in process);
7f4. docker (the `docker` line): in process, `add
   docker-network-plugin-controller` on a unix socket, Plugin.Activate
   and GetCapabilities, 8 CreateNetwork calls (/24 pools of
   172.28.0.0/16 with their gateways: 8 VPCs on the card), 56 routes
   by command (each VPC to the 7 others' pools), one route_lookup_batch
   of 512 seeded addresses a VPC (the small-table cut set to 0):
   B4 launches == the 8 batches, every answer the host CidrIndex's;
   current_config holds the controller line and its replay into a
   fresh Application rebuilds the 8 VPCs; no tap device is made;
7g. sharded (the `sharded_kernels`, `sharded_service` and `cluster`
   lines): configurations (a) and (b) compiled by
   compile_*_hash_sharded and compile_*_fp_sharded at S = 4
   (make_mesh(8, batch=2)) and S = 1, uncut (spawned workers compile
   them from the start of the run, sharded_start); B8 against its plain
   version and the host index, int32-exact, at every pad_batch bucket
   to 4096 (an eighth pad rows), on the cuckoo and fingerprint hint,
   route and ACL tables, one launch a batch; B8 timed at S = 4 (B = 16
   / 512 / 4096) and S = 1 (B = 512), warm and cold, its bound the
   distinct bytes (b8_work: the batch's queries and answers once, each
   shard's table rows as work() / cidr_work() / fp_hint_work() /
   fp_cidr_work() count them), beside B3 / B4 / B6 / B7 on the same
   rules (the `kernels` line's unsharded_at_512); ClassifyService in
   "device" mode on both sharded backends at S = 4 on the same
   configurations (a) and (b), full size (the matchers take the
   workers' compiles: worker_compiles), 4 x 512 of each of
   hint, cpick and cidr (routes, and the ACL with ports), every answer
   the host index's, one B8 launch a batch (a cpick batch's with its
   Maglev column), no B5 and no other kernel, each matcher's checksum
   the unsharded one's; B8 with its Maglev column checked at every
   bucket in every layout and on the keys path; then (the `cpick`
   line) one classify+pick batch of 512 on each unfused backend both
   ways, one launch and the parent's two-dispatch chain: equal, and
   each one's device time (kernels, copies, memsets counted) and wall
   ms; then
   two cluster nodes (phase_cluster): the leader builds upstream u0 by
   command (config #2's rules until 10 s), the follower converges to
   its generation and checksum and refuses a mutation, each node's
   step loop serves 1,024 queries on the card (B1 through the
   FusedPair), every answer the host index's, not degraded; then the
   scenario and load tools (phase_tools, the `tools` line; device
   mode, the small-table cut at 0): the storm suite at full scale
   (hard gates; B1 / B3 / B4 launches == the engine's dispatches by
   kind, per scenario), chaos at tests/test_chaos.py's floor with the
   card's KernelError contract in its phase 4, one replay round trip
   with its fidelity gates and schedule hash, and 3 s of the port's
   hostbench client through a TcpLB with one Host rule (0 errors; B3 a
   hint batch);
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
   tiers, bounds and designs (the 155.7 MB slot table is three times
   the L2: a warm time there is not an all-L2 time), B6 with its Maglev
   column beside it, and the Maglev take (B5) of a standalone Maglev
   batch (the `b5_take` line: the kernel alone, with its slots'
   host-to-device copy, and torch indexing, its plain version and
   library yardstick); and for B9 on the 100k hint table (and with its
   Maglev column), the routes, the ACL and classify_all (its 3 launches
   summed) with their plain tiers, bounds (dense_hint_work /
   dense_cidr_work) and the count step's GEMM alone (dense_library_ms);
10. the `phase_s` line (wall seconds per phase), the {"kernels": [...]}
   line (B1, B1 with the route column, B4, B3, B6, B7, B5, B9, B8;
   B1's launches include the cluster step loops', B1's, B3's and
   B4's the `tools` phase's, B4's and B7's the `switch` phase's, B4's
   the `docker` phase's, B6's, B9's and B8's the cpick batches' (with
   their Maglev column), B5's the standalone Maglev batches'),
   then the card's line, then the device line.

Any failed phase raises, and the script exits non-zero.

    python3 chip_smoke.py --ab DIR [OUT [PARTS]]

times B6, B7, classify_fp_all, B9 (hint, routes, ACL) and B8 (S = 4 and
S = 1, every kind and column) of this checkout against a parent commit
unpacked in DIR (`git archive <parent> | tar -x -C DIR`: its kernel
sources, packers and wrappers, each with its own argument structs), in
one process on
the same tables and batches, in turns (parent, change, change, parent),
warm and cold, after holding both to the plain tier (the `ab` line;
every row also to the JSON file OUT).
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
# the dense backend: B9 (hint, routes / ACL) and the Maglev take B5
REPLACES_B9 = "vproxy_tpu/ops/matchers.py:33"
KERNEL_B9_HINT, KERNEL_B9_CIDR = "dense_hint_kernel", "dense_cidr_kernel"
SOURCE_B9 = "vproxy_tpu_torch/csrc/dense_match.cu"
REPLACES_B5 = "vproxy_tpu/rules/maglev.py:235"
KERNEL_B5 = "maglev_take_kernel"
SOURCE_B5 = "vproxy_tpu_torch/csrc/maglev_take.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke failed: {what}")


def lat_ms(xs) -> dict:
    """submit -> delivery seconds -> {"n", "p50_ms", "p99_ms"}."""
    if not xs:
        return {"n": 0}
    return {"n": len(xs), "p50_ms": pct(xs, 50) * 1e3,
            "p99_ms": pct(xs, 99) * 1e3}


def pct(xs, q):
    """The q-th percentile of xs (nearest rank), None for no values."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, len(xs) * q // 100)] if xs else None


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


def fp_table_variant(t: dict, how: str) -> dict:
    """A fingerprint table's arrays changed where the kernels take a
    path no compiled table of the cases reaches. Cut short where the
    reference's gathers clamp: "rec" (slot rows past the first third),
    "mrows" (ACL member rows past the first third), "trie" (t_l1 and
    t_l2 past their first subtable); or "wide" (CIDR rows of twice E
    entries, every entry moved into the second half, where B7 loads
    them in a second step). The kernels must answer as the plain tier."""
    out = dict(t)
    if how == "trie":
        out["t_l1"], out["t_l2"] = t["t_l1"][:256], t["t_l2"][:256]
    elif how == "wide":
        rec = t["rec"]
        out["rec"] = np.concatenate([np.zeros_like(rec), rec], axis=1)
        out["e_m"] = np.zeros((2 * t["e_m"].shape[0], 1), np.int32)
    else:
        assert how in ("rec", "mrows")
        out[how] = t[how][: max(1, t[how].shape[0] // 3)]
    return out


def cut_fp_query(q: dict, how: str) -> dict:
    """An encoded hint batch cut short where B6 clamps a member's index
    into the query's arrays, with the other path to the same rules shut
    so the clamped read decides the answer: "um" (the uri-side
    fingerprints cut to 2 lset positions, the second the query's longest
    live prefix; the uri probes dead) or "hmeta" (the rolling host
    fingerprints cut to 5 host lengths, the fifth the whole host; the
    host probes dead)."""
    out = dict(q)
    rows = torch.arange(q["hlen"].shape[0], device=q["hlen"].device)
    if how == "um":
        um = [q.get(f"um_{k}", q[f"up_{k}"]) for k in ("fp1", "fp2", "score")]
        last = ((um[2] > 0).sum(dim=1) - 1).clamp(min=0)
        for k, v in zip(("fp1", "fp2", "score"), um):
            out[f"um_{k}"] = torch.stack([v[:, 0], v[rows, last]], dim=1)
        out["up_score"] = torch.zeros_like(q["up_score"])
    else:
        assert how == "hmeta"
        hm = q["q_hmeta"]
        at = q["hlen"].clamp(max=hm.shape[1] - 1).long()
        out["q_hmeta"] = torch.cat([hm[:, :4], hm[rows, at][:, None]], dim=1)
        out["hp_level"] = torch.zeros_like(q["hp_level"])
    return out


FP_VARIANTS = {"routes_2k": ("rec", "trie", "wide"),
               "acl_500": ("rec", "mrows", "trie", "wide"),
               "acl_deep_buckets no_trie": ("rec", "mrows", "wide")}
FP_QUERY_CUTS = {"random_300_b600": ("um", "hmeta"),
                 "boundary": ("um", "hmeta")}


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


def fp_v6_all_masks(seed: int = 19):
    """A v6 route at every prefix length /0-/128 over one address, in
    random order: 129 groups of one family (B7's lanes take them in
    three rounds); 200 addresses under it at every depth, every 8th
    random. -> (nets, [addr])."""
    import numpy as np
    from vproxy_tpu_torch.utils.ip import Network, mask_bytes
    rng = np.random.default_rng(seed)
    base = b"\xfd" + rng.bytes(15)

    def net(ml):
        m = mask_bytes(ml)
        return Network(bytes(a & b for a, b in zip(base, m)) +
                       bytes(16 - len(m)), m)

    def under(ml):
        keep = ((1 << ml) - 1) << (128 - ml)
        r = int.from_bytes(rng.bytes(16), "big") & ~keep
        return ((int.from_bytes(base, "big") & keep) | r).to_bytes(16, "big")
    nets = [net(int(ml)) for ml in rng.permutation(129)]
    addrs = [b"\xfd" + rng.bytes(15) if i % 8 == 7 else
             under(int(rng.integers(129))) for i in range(200)]
    return nets, addrs


def fp_last_entry_routes(n: int = 400, seed: int = 17):
    """n random v6 /48 routes (one group, rows of several entries) and
    an address under each: every key is matched, the last of a full
    slot row among them. -> (nets, [addr])."""
    import numpy as np
    from vproxy_tpu_torch.utils.ip import Network, mask_bytes
    rng = np.random.default_rng(seed)
    nets = [Network(b"\xfd" + rng.bytes(5) + bytes(10), mask_bytes(48))
            for _ in range(n)]
    return nets, [nt.ip[:15] + bytes([i % 256]) for i, nt in enumerate(nets)]


def fp_last_entry(n: int = 300):
    """n host rules and n uri rules, each queried by its own key: the
    last entry of a full slot row is matched, on both sides (rows of 3
    entries, not a power of two). -> (rules, hints)."""
    from vproxy_tpu_torch.rules.ir import Hint, HintRule
    rules = [HintRule(host=f"n{i}.last.io") for i in range(n)]
    rules += [HintRule(uri=f"/last/{i}") for i in range(n)]
    return rules, [Hint(host=f"n{i}.last.io", uri=f"/last/{i}")
                   for i in range(n)]


def fp_probe_rounds(seed: int = 13):
    """1,500 host rules of up to 28 one-letter labels (a 64-byte host
    window) and queries 30 labels deeper: 33 host probes x hE entries,
    more (probe, entry) pairs than B6's lanes take in one round, the uri
    probes' pairs past it; every 4th query matches only a uri rule. ->
    (rules, hints)."""
    from vproxy_tpu_torch.rules.ir import Hint, HintRule
    rnd = random.Random(seed)
    labels = "abcdefgh"
    rules = [HintRule(host=".".join(rnd.choice(labels) for _ in range(
        rnd.randint(1, 27))) + f".t{i % 40}.io",
        uri=rnd.choice([None, "/api", "/v2/x"])) for i in range(1500)]
    rules += [HintRule(uri="/only"), HintRule(uri="/only/deeper")]
    hints = []
    for i in range(64):
        r = rules[rnd.randrange(1500)]
        pre = ".".join(rnd.choice(labels) for _ in range(30))
        if i % 4 == 3:  # no host rule: only the uri probes answer
            hints.append(Hint(host=f"{pre}.none.io", uri="/only/deeper/x"))
        else:
            hints.append(Hint(host=f"{pre}.{r.host}",
                              uri=rnd.choice(["/api/x", "/v2/xyz", None])))
    return rules, hints


def fp_wildcards():
    """48 host="*" rules (distinct uris and ports) and 48 uri="*" rules
    (distinct ports): 128 wildcard members, so every query's members
    pass one list window of B6. -> (rules, hints)."""
    from vproxy_tpu_torch.rules.ir import Hint, HintRule
    rules = [HintRule(host="*", uri=f"/w{i}", port=i % 3) for i in range(48)]
    rules += [HintRule(host=f"h{i}.io", uri="*", port=1000 + i)
              for i in range(48)]
    rules += [HintRule(host=f"h{i}.io", uri=f"/w{i}") for i in range(0, 48, 3)]
    hints = [Hint(host=f"h{i % 60}.io", uri=f"/w{(7 * i) % 60}/q",
                  port=(i % 3, 1000 + i % 50)[i % 2]) for i in range(60)]
    return rules, hints + [Hint(host="*", uri="*"), Hint(uri="/w5"),
                           Hint(host="x.h3.io")]


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
    instances (PICK false), "B4" for the CIDR kernel, "B6" / "B6 pick"
    and "B7" for the fingerprint kernels, "B9 hint Q=2", "B9 hint Q=2
    wide pick" and "B9 cidr Q=4" and the like for the dense ones, "B5"
    for the Maglev take, "B8 uri W=16 hint+cidr" and the like for
    sharded_hash_kernel<URI, W, HINT, CIDR> ("B8 uri W=16 hint pick" for
    sharded_hash_kernel_pick<URI, W>), "B8 fp hint" and the like for
    sharded_fp_kernel<HINT, CIDR> ("B8 fp hint pick" for
    sharded_fp_kernel_pick) and "B8 finish" for B8's last pass ("pick":
    the Maglev column)."""
    cols = {"10": " hint", "01": " cidr", "11": " hint+cidr"}
    m = re.search(r"sharded_fp_kernelILb([01])ELb([01])E", mangled)
    if m:
        return "B8 fp" + cols[m.group(1) + m.group(2)]
    if "sharded_fp_kernel_pick" in mangled:
        return "B8 fp hint pick"
    if "fp_hint_kernel_pick" in mangled:
        return "B6 pick"
    m = re.search(r"dense_hint_kernel(_pick)?ILi(\d)ELb([01])E", mangled)
    if m:
        return (f"B9 hint Q={m.group(2)}"
                f"{' wide' if m.group(3) == '1' else ''}"
                f"{' pick' if m.group(1) else ''}")
    m = re.search(r"dense_hint_kernelILi(\d)E", mangled)  # a parent's
    if m:
        return f"B9 hint Q={m.group(1)}"
    m = re.search(r"dense_cidr_kernelILi(\d)E", mangled)
    if m:
        return f"B9 cidr Q={m.group(1)}"
    for kernel, name in ((KERNEL_B4, "B4"), (KERNEL_B6, "B6"),
                         (KERNEL_B7, "B7"), (KERNEL_B9_HINT, "B9 hint"),
                         (KERNEL_B9_CIDR, "B9 cidr"), (KERNEL_B5, "B5"),
                         ("sharded_finish_kernel", "B8 finish")):
        if kernel in mangled:
            return name
    m = re.search(r"sharded_hash_kernel(_pick)?ILb([01])ELi(\d+)E"
                  r"(?:Lb([01])ELb([01])E)?", mangled)
    if m:
        return (f"B8 {'uri' if m.group(2) == '1' else 'uri-free'} "
                f"W={m.group(3)}"
                f"{' hint pick' if m.group(1) else cols[m.group(4) + m.group(5)]}")
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
    from vproxy_tpu_torch.ops import dense_cuda as DC
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    from vproxy_tpu_torch.ops import fused_cuda as FC
    from vproxy_tpu_torch.ops import sharded_cuda as SC
    from vproxy_tpu_torch.ops import take_cuda as TC

    def timed(fn):
        t0 = time.monotonic()
        return fn(), time.monotonic() - t0

    with ThreadPoolExecutor(8) as ex:
        futs = {"fused": ex.submit(timed, FC.build),
                "cidr": ex.submit(timed, CC.build),
                "fp_hint": ex.submit(timed, FPC.build_hint),
                "fp_cidr": ex.submit(timed, FPC.build_cidr),
                "dense": ex.submit(timed, DC.build),
                "take": ex.submit(timed, TC.build),
                "sharded": ex.submit(timed, SC.build),
                "vtl": ex.submit(timed, native_vtl)}
        built = {k: f.result() for k, f in futs.items()}
    vtl, secs = built.pop("vtl")
    log(f"build: libvtl (g++) {secs:.2f} s -> "
        f"{os.path.relpath(vtl.LIB_PATH, os.path.dirname(vtl.BUILD_DIR))}"
        f" from {os.path.relpath(vtl.SOURCE, os.path.dirname(vtl.BUILD_DIR))}"
        f", provider {vtl.PROVIDER}")
    out = {"vtl": {"build_s": secs}}
    # fp_hint: B6 and its Maglev column's instance; dense: hint Q = 1, 2
    # x (32-bit, wide key) x (verdict, pick) + cidr Q = 1, 4; sharded:
    # (uri, uri-free) x 4 words x (hint, hint + pick, hint + cidr) + cidr
    # alone, 4 fingerprint column sets (hint + pick among them), the
    # finish pass
    for lib_name, want in (("fused", 16), ("cidr", 1), ("fp_hint", 2),
                           ("fp_cidr", 1), ("dense", 10), ("take", 1),
                           ("sharded", 30)):
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


def _answers(svc, submit, payloads, lat=None):
    """Submit one burst and wait for every callback. -> results list.
    `lat`: a list that gets each row's submit -> delivery seconds."""
    out = [None] * len(payloads)
    done = threading.Event()
    left = [len(payloads)]
    lock = threading.Lock()
    t_sub = [0.0] * len(payloads)

    def cb_for(i):
        def cb(*res):
            out[i] = res[:-1]
            if lat is not None:
                lat.append(time.monotonic() - t_sub[i])
            with lock:
                left[0] -= 1
                if left[0] == 0:
                    done.set()
        return cb

    for i, p in enumerate(payloads):
        t_sub[i] = time.monotonic()
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
# keep-alive connection on its own. Two more terminate TLS over the same
# Upstream and ACL with one certificate minted at run time: a `tcp` LB
# (its SNI the classify hint, on the native OpenSSL pump and on the
# Python MemoryBIO plane in turn) and an `http` one (the L7 engine
# inside TLS).

TCPLB_MAX_RULES = 10_000  # BASELINE config #2's target
TCPLB_MIN_RULES = 256
TCPLB_BUILD_S = 15.0      # the Upstream build's budget: every add publishes
# (the `control` phase builds the same Upstream for CONTROL_BUILD_S)
TCPLB_BACKENDS = 256
B3_PATH_BATCHES = 32  # batches a bucket below the largest (b3_on_path)
TCPLB_RULE_SEED, TCPLB_REQ_SEED = 61, 62
KEEPALIVE_CONNS, KEEPALIVE_REQS = 64, 4
HTTPS_CONNS = 128  # lb-https: one request a connection, the L7 engine
TLS_REQ_SEED, HTTPS_REQ_SEED = 163, 800


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


def _backend_main(n: int, conn, host: str = LOOPBACK) -> None:
    """Runs in the backend process: n HTTP id-servers on `host` (asyncio,
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
            functools.partial(handle, bid=i), host, 0, backlog=1024)
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


def mint_cert(d: str) -> tuple:
    """One self-signed EC P-256 certificate for example.com and
    *.example.com (config #2's tenants), minted with `cryptography`
    into directory d. -> (cert path, key path)."""
    import datetime
    try:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID
    except ImportError as e:
        check(False, f"cannot mint the TLS LBs' certificate: {e}")
    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                         "example.com")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder().subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(hours=1))
            .not_valid_after(now + datetime.timedelta(days=2))
            .add_extension(x509.SubjectAlternativeName(
                [x509.DNSName("example.com"), x509.DNSName("*.example.com")]),
                critical=False)
            .sign(key, hashes.SHA256()))
    cert_path, key_path = os.path.join(d, "lb.crt"), os.path.join(d, "lb.key")
    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    with open(key_path, "wb") as f:
        f.write(key.private_bytes(serialization.Encoding.PEM,
                                  serialization.PrivateFormat.PKCS8,
                                  serialization.NoEncryption()))
    return cert_path, key_path


_TLS_CLIENT = None  # the client process's TLS context (no verification)


def _tls_client(port: int, host: str, path: str) -> tuple:
    """One TLS connection with SNI `host` (the certificate is not
    verified), one request that asks to close. -> (client port,
    connect->first byte seconds, response body)."""
    import socket
    import ssl
    global _TLS_CLIENT
    if _TLS_CLIENT is None:
        _TLS_CLIENT = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        _TLS_CLIENT.check_hostname = False
        _TLS_CLIENT.verify_mode = ssl.CERT_NONE
    t0 = time.monotonic()
    s = socket.create_connection((LOOPBACK, port), timeout=60)
    try:
        cport = s.getsockname()[1]
        s = _TLS_CLIENT.wrap_socket(s, server_hostname=host)  # owns the fd
        s.sendall(http_request(host, path, close=True))
        first = s.recv(65536)
        t1 = time.monotonic()
        body, _ = _read_response(s, first)
        return cport, t1 - t0, body
    finally:
        s.close()


_HTTP_CLIENTS = None  # the client process's thread pool


def _http_burst(port: int, kind: str, items: list, concurrency: int) -> list:
    """Runs in the client process: items through `kind` ("splice": one
    (host, path) per connection; "tls": the same in TLS, SNI the host;
    "keepalive": a list of them per connection), at most `concurrency`
    connections at once."""
    global _HTTP_CLIENTS
    if _HTTP_CLIENTS is None:
        _HTTP_CLIENTS = ThreadPoolExecutor(concurrency)
    if kind in ("splice", "tls"):
        one = _splice_client if kind == "splice" else _tls_client
        return list(_HTTP_CLIENTS.map(lambda it: one(port, *it), items))
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
                n_acl=N_ACL, matcher=None, tls_bursts=None,
                https=HTTPS_CONNS) -> dict:
    """The port's TcpLB main path (BASELINE config #2 as far as one
    Upstream holds it, config #4's ACL): `bursts` bursts of `burst`
    concurrent http-splice connections and one burst of `keepalive`
    keep-alive connections x 4 requests through the L7 http engine,
    every answer checked against the group the port's host index gives;
    then the TLS-terminating LBs over the same Upstream and ACL:
    `tls_bursts` (default `bursts`) bursts of `burst` TLS connections
    into `lb-tls` (protocol tcp, the SNI alone the classify hint) on the
    native OpenSSL pump, the same bursts with VPROXY_TPU_NATIVE_TLS=0 on
    the Python MemoryBIO plane, and `https` connections into `lb-https`
    (the L7 http engine inside TLS, picks from the host index), every
    `lb-tls` answer the group that the host index and the linear oracle
    give the SNI-only hint; each plane's handshakes, queries, batches
    and launches counted; on the card, B3 and B4 launched once per
    device batch of their kind over all of it, B1 and B3's torch tier
    never; then B3 held on the path's own table
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
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    from vproxy_tpu_torch.components.certkey import CertKey
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
    from vproxy_tpu_torch.rules.ir import Hint
    from vproxy_tpu_torch.rules.service import ClassifyService
    from vproxy_tpu_torch.utils.ip import parse_ip
    from vproxy_tpu_torch.utils.metrics import GlobalInspection
    fp = matcher == "jax-fp"
    tls_bursts = bursts if tls_bursts is None else tls_bursts
    env_matcher = os.environ.get("VPROXY_TPU_MATCHER")
    env_tls = os.environ.get("VPROXY_TPU_NATIVE_TLS")
    if matcher is not None:
        os.environ["VPROXY_TPU_MATCHER"] = matcher
    vtl = native_vtl()
    check(vtl.tls_available(), "the native TLS plane cannot run: "
          "vtl_tls_init found no libssl.so.3 (nor libssl.so) with its "
          "symbols on this host")
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
    certdir = tempfile.mkdtemp(prefix="chip-smoke-tls-")
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
        ck = CertKey("ck-tls", *mint_cert(certdir))
        tls = TcpLB("lb-tls", elg, elg, LOOPBACK, 0, ups, protocol="tcp",
                    security_group=sg, lanes=0, cert_keys=[ck])
        l7s = TcpLB("lb-https", elg, elg, LOOPBACK, 0, ups,
                    protocol="http", security_group=sg, lanes=0,
                    cert_keys=[ck])
        for lb in (splice, l7, tls, l7s):
            lbs.append(lb)
            lb.start()
        # the clients' address passes the ACL: no rule's network holds
        # it at the LBs' ports, so the default (allow) answers
        index = CidrIndex([r.network for r in acl], acl=acl)
        lo = parse_ip(LOOPBACK)
        check(all(index.lookup(lo, p) == -1 for p in
                  [lb.bind_port for lb in lbs] + [0, 80, 443, 65535]),
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

        m = ups._matcher

        def check_sni(body: str, host: str, path: str, what: str) -> bool:
            """lb-tls classifies by the SNI alone: the backend must be
            that of the group the host index gives Hint.of_host(host),
            which must be the linear oracle's (so a host+uri rule
            answers as the host-only hint does)."""
            bid, _, seen = body.partition(" ")
            check(seen == host, f"{what}: backend saw Host {seen!r}, "
                  f"sent {host!r}")
            h = Hint.of_host(host)
            i = m.index_snap(m.snapshot(), h)
            check(i == m.oracle_one(h), f"{what}: the host index gives "
                  f"rule {i} for SNI {host!r}, the oracle "
                  f"{m.oracle_one(h)}")
            g = ups.search_for_group(h)
            want = None if g is None else int(g.alias[1:]) % TCPLB_BACKENDS
            check(want is None or int(bid) == want,
                  f"{what}: SNI {host} reached backend {bid}, the host "
                  f"index gives {want}")
            return want is not None

        def metric(name: str) -> int:
            """An unlabelled family's value, as /metrics shows it."""
            text = GlobalInspection.get().prometheus_string()
            got = re.search(rf"^{name} (\S+)$", text, re.M)
            check(got is not None, f"/metrics has no {name}")
            return int(float(got.group(1)))

        def launch_counts() -> dict:
            return {"hint_match": FC.hint_match_cuda.launches,
                    "cidr_first": CC.cidr_first_cuda.launches,
                    "hint_fp": FPC.hint_fp_cuda.launches,
                    "cidr_fp": FPC.cidr_fp_cuda.launches}

        def tls_plane(lb, plan, check_fn, native: bool) -> dict:
            """plan's bursts into the TLS LB lb, every answer held by
            check_fn. -> the plane's connections, handshakes (the
            native pump's counter: every connection on the native
            plane, none on the MemoryBIO one), queries, batches and
            launches by kind over its bursts, and connect -> first
            byte percentiles."""
            by0 = {k: list(v) for k, v in st.by_kind.items()}
            hs0 = metric("vproxy_pump_tls_handshakes_total")
            dq0 = metric("vproxy_classify_device_queries")
            l0 = launch_counts()
            lat, matched, t0 = [], 0, time.monotonic()
            for k, reqs in enumerate(plan):
                got = clients.submit(_http_burst, lb.bind_port, "tls", reqs,
                                     len(reqs)).result(timeout=300)
                for i, ((host, path), (_, secs, body)) in enumerate(
                        zip(reqs, got)):
                    matched += check_fn(body, host, path,
                                        f"{lb.alias} burst {k} row {i}")
                    lat.append(secs * 1e6)
            conns = len(lat)
            d = {k: [a - b for a, b in zip(st.by_kind.get(k, [0, 0]),
                                           by0.get(k, [0, 0]))]
                 for k in ("hint", "cidr")}
            queries = {k: v[1] for k, v in d.items()}
            out = {"connections": conns, "matched": matched,
                   "wall_s": time.monotonic() - t0,
                   "handshakes": metric("vproxy_pump_tls_handshakes_total")
                   - hs0,
                   "device_queries": metric(
                       "vproxy_classify_device_queries") - dq0,
                   "queries": queries,
                   "batches": {k: v[0] for k, v in d.items()},
                   "launches": {k: v - l0[k]
                                for k, v in launch_counts().items()},
                   "connect_to_first_byte_p50_us": pct(lat, 50),
                   "connect_to_first_byte_p99_us": pct(lat, 99)}
            check(out["handshakes"] == (conns if native else 0),
                  f"{lb.alias}: {out['handshakes']} native handshakes for "
                  f"{conns} connections (native plane: {native})")
            # every accept asks the ACL; the native plane classifies
            # every SNI on the device, the MemoryBIO relay and the L7
            # engine pick from the host index
            check(queries == {"hint": conns if native else 0,
                              "cidr": conns},
                  f"{lb.alias}: queries {queries} for {conns} connections")
            check(out["device_queries"] == sum(queries.values()),
                  f"{lb.alias}: {out['device_queries']} device queries, "
                  f"{sum(queries.values())} reached the service")
            return out

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
        tls_plan = [tcplb_requests(rules, burst, TLS_REQ_SEED + k)
                    for k in range(tls_bursts)]
        tls_out = {}
        os.environ.pop("VPROXY_TPU_NATIVE_TLS", None)
        tls_out["native"] = tls_plane(tls, tls_plan, check_sni, True)
        os.environ["VPROXY_TPU_NATIVE_TLS"] = "0"  # read at each accept
        tls_out["memorybio"] = tls_plane(tls, tls_plan, check_sni, False)
        tls_out["https"] = tls_plane(
            l7s, [tcplb_requests(rules, https, HTTPS_REQ_SEED)],
            check_body, False)
        counts = launch_counts()
        launches = {k: counts[k] for k in ("hint_match", "cidr_first")}
        launches["fused_classify_pick"] = FC.fused_classify_pick_cuda.launches
        fp_launches = {k: counts[k] for k in ("hint_fp", "cidr_fp")}
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
               "tls": tls_out,
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
        shutil.rmtree(certdir, ignore_errors=True)
        for k, v in (("VPROXY_TPU_CLASSIFY", mode),
                     ("VPROXY_TPU_MATCHER", env_matcher),
                     ("VPROXY_TPU_NATIVE_TLS", env_tls)):
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


# ------------------------------------------------------------- control
# The port's process entry and control plane, driven as an operator
# drives them: `python -m vproxy_tpu_torch` in a child process, one
# operator config built by command over RESP (and a few over HTTP): an
# Upstream of Host rules (BASELINE config #3's DNS-as-LB records as far
# as the build allows) and one SecurityGroup holding config #4's ACL as
# TCP and as UDP rules, then a dns-server, a socks5-server and a tcp-lb
# on them; DNS, Socks5 and http-splice traffic from a spawned client
# process, every answer checked against the port's host index, the
# kernels' launches read from the child's /metrics scrape.

CONTROL_MAX_GROUPS = 10_000  # records built against config #3's 100k
CONTROL_MIN_GROUPS = 256
# the build budgets, 20 s each, keep the whole run inside its limit
CONTROL_BUILD_S = 20.0       # the Upstream's budget: every add publishes
CONTROL_MIN_ACL = 256        # rules of each protocol, at least
CONTROL_ACL_BUILD_S = 20.0   # each protocol's budget: every add compiles
CONTROL_FP_ACL = 128  # the fp run's ACL: each add recompiles the fp table
CONTROL_WORKERS = 4
CONTROL_QUERY_SEED = 81
DNS_BURSTS, DNS_BURST, DNS_INFLIGHT = 4, 4096, 512
S5_BURSTS, LB_BURSTS = 2, 2
RESP_PASSWORD = "chip-smoke"


def group_addr(i: int) -> str:
    """Group i's one server: a loopback address of its own (never
    127.0.0.1, the clients' address), so a DNS answer names its group."""
    return f"127.{1 + i // 62_500}.{1 + i // 250 % 250}.{1 + i % 250}"


class Resp:
    """A redis-protocol client of the port's resp-controller: one
    command line per call, -> its reply (str or list); an error reply
    raises."""

    def __init__(self, port: int, password: str):
        import socket
        self.s = socket.create_connection((LOOPBACK, port), timeout=60)
        self.buf = b""
        check(self.cmd(f"AUTH {password}") == "OK", "RESP AUTH refused")

    def cmd(self, line: str):
        parts = [p.encode() for p in line.split()]
        self.s.sendall(b"*%d\r\n" % len(parts) + b"".join(
            b"$%d\r\n%s\r\n" % (len(p), p) for p in parts))
        return self._read(line)

    def _line(self) -> bytes:
        while b"\r\n" not in self.buf:
            d = self.s.recv(65536)
            check(bool(d), "the resp-controller closed the connection")
            self.buf += d
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def _read(self, what: str):
        line = self._line()
        t, rest = line[:1], line[1:].decode()
        if t == b"-":
            raise RuntimeError(f"chip smoke failed: `{what}`: {rest}")
        if t in (b"+", b":"):
            return rest
        if t == b"$":
            n = int(rest)
            while len(self.buf) < n + 2:
                d = self.s.recv(65536)
                check(bool(d), "the resp-controller closed the connection")
                self.buf += d
            out, self.buf = self.buf[:n].decode(), self.buf[n + 2:]
            return out
        if t == b"*":
            return [self._read(what) for _ in range(int(rest))]
        raise RuntimeError(f"chip smoke failed: RESP reply {line!r}")

    def close(self) -> None:
        self.s.close()


def http_json(port: int, path: str, body=None):
    """GET (or POST `body` as JSON) on the child's http-controller."""
    import urllib.request
    req = urllib.request.Request(
        f"http://{LOOPBACK}:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def scrape(port: int) -> dict:
    """The child's inspection server /metrics -> {series: value}."""
    import urllib.request
    with urllib.request.urlopen(f"http://{LOOPBACK}:{port}/metrics",
                                timeout=60) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            k, _, v = line.rpartition(" ")
            out[k] = float(v)
    return out


def dns_plan(rules, n: int, seed: int) -> list:
    """(qname, qtype) per query, seeded: A and SRV for record names with
    Zipf popularity (exact names, and subdomains under the suffix
    rules), a sixteenth IP literals and who.am.i.vproxy.local, a
    sixteenth names no rule holds."""
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(1.2, n), len(rules)) - 1
    perm = rng.permutation(len(rules))
    kind = rng.integers(0, 16, n)
    sub = rng.integers(0, 4, n) == 0
    srv = rng.integers(0, 3, n) == 0
    out = []
    for k in range(n):
        if kind[k] == 0:
            out.append((f"{10 + k % 200}.{k % 250}.{k // 250 % 250}.9."
                        if k % 2 else "who.am.i.vproxy.local.", "A"))
        elif kind[k] == 1:
            out.append((f"n{k}.nowhere{k % 13}.test.", "A"))
        else:
            host = rules[int(perm[ranks[k]])].host
            out.append(((f"x{k % 97}.{host}." if sub[k] else f"{host}."),
                        "SRV" if srv[k] else "A"))
    return out


DNS_RESEND_S, DNS_TRIES = 1.0, 5


def udp_rcvbuf_errors() -> int:
    """The kernel's count of UDP datagrams dropped on a full socket
    receive buffer (/proc/net/snmp), or -1 where it cannot be read."""
    try:
        with open("/proc/net/snmp") as f:
            rows = [ln.split() for ln in f if ln.startswith("Udp:")]
        return int(rows[1][rows[0].index("RcvbufErrors")])
    except (OSError, IndexError, ValueError):
        return -1


def _dns_burst(port: int, packets: list, inflight: int) -> list:
    """Runs in the client process: every query datagram to the DNS
    server, at most `inflight` unanswered at once, each resent after
    DNS_RESEND_S without an answer (DNS_TRIES tries: UDP may drop, and a
    DNS client resends). -> (response, seconds from the first send,
    tries) per query."""
    import select
    import socket
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
    s.setblocking(False)
    by_id = {int.from_bytes(p[:2], "big"): i for i, p in enumerate(packets)}
    out = [None] * len(packets)
    pending = {}  # id -> [t first sent, t last sent, tries]
    nxt = 0
    try:
        while nxt < len(packets) or pending:
            now = time.monotonic()
            while nxt < len(packets) and len(pending) < inflight:
                s.sendto(packets[nxt], (LOOPBACK, port))
                pending[int.from_bytes(packets[nxt][:2], "big")] = \
                    [now, now, 1]
                nxt += 1
            if select.select([s], [], [], 0.05)[0]:
                while True:
                    try:
                        data = s.recv(65536)
                    except BlockingIOError:
                        break
                    qid = int.from_bytes(data[:2], "big")
                    ent = pending.pop(qid, None)
                    if ent is not None:
                        out[by_id[qid]] = (data, time.monotonic() - ent[0],
                                           ent[2])
            now = time.monotonic()
            for qid, ent in list(pending.items()):
                if now - ent[1] > DNS_RESEND_S:
                    if ent[2] >= DNS_TRIES:
                        raise RuntimeError(f"DNS query {qid}: no answer "
                                           f"in {DNS_TRIES} tries")
                    s.sendto(packets[by_id[qid]], (LOOPBACK, port))
                    ent[1], ent[2] = now, ent[2] + 1
    finally:
        s.close()
    return out


def _socks5_client(port: int, host: str, path: str) -> tuple:
    """One Socks5 CONNECT to host:80, then one HTTP request that asks to
    close. -> (reply code, connect->first byte seconds, response body)."""
    import socket
    t0 = time.monotonic()
    s = socket.create_connection((LOOPBACK, port), timeout=60)
    try:
        s.sendall(b"\x05\x01\x00")
        greet = b""
        while len(greet) < 2:
            d = s.recv(2 - len(greet))
            if not d:
                raise ConnectionError("EOF in the Socks5 greeting")
            greet += d
        if greet != b"\x05\x00":
            raise ConnectionError(f"Socks5 greeting {greet!r}")
        h = host.encode()
        s.sendall(b"\x05\x01\x00\x03" + bytes([len(h)]) + h + b"\x00\x50")
        rep = b""
        while len(rep) < 10:
            d = s.recv(10 - len(rep))
            if not d:
                break
            rep += d
        if len(rep) < 2 or rep[1] != 0:
            return (rep[1] if len(rep) > 1 else -1), None, None
        s.sendall(http_request(host, path, close=True))
        first = s.recv(65536)
        t1 = time.monotonic()
        body, _ = _read_response(s, first)
        return 0, t1 - t0, body
    finally:
        s.close()


def _socks5_burst(port: int, items: list, concurrency: int) -> list:
    """Runs in the client process: one Socks5 session per (host, path)."""
    global _HTTP_CLIENTS
    if _HTTP_CLIENTS is None:
        _HTTP_CLIENTS = ThreadPoolExecutor(concurrency)
    return list(_HTTP_CLIENTS.map(lambda it: _socks5_client(port, *it),
                                  items))


def _boot_child(args: list, env: dict, err_path: str,
                want=("resp-controller", "http-controller",
                      "global-inspection"),
                entry=("-m", "vproxy_tpu_torch")):
    """Start `python -m vproxy_tpu_torch args` (or `python <entry>
    args`) and read the addresses it prints. -> (process,
    {"resp-controller": port, ...})."""
    import select
    with open(err_path, "w") as err:
        p = subprocess.Popen([sys.executable, *entry, *args], env=env,
                             stdout=subprocess.PIPE, stderr=err,
                             cwd=env["PYTHONPATH"])
    ports, buf = {}, b""
    deadline = time.monotonic() + 180
    while len(ports) < len(want):
        if p.poll() is not None or time.monotonic() > deadline:
            with open(err_path) as f:
                tail = f.read()[-3000:]
            raise RuntimeError(f"chip smoke failed: the port did not boot "
                               f"(rc {p.poll()}): {tail}")
        if select.select([p.stdout], [], [], 0.5)[0]:
            buf += os.read(p.stdout.fileno(), 4096)
            *lines, buf = buf.split(b"\n")
            for line in lines:
                for w in want:
                    if line.decode().startswith(w + " on "):
                        ports[w] = int(line.rsplit(b":", 1)[1])
    return p, ports


def phase_control(device, max_groups=CONTROL_MAX_GROUPS,
                  dns_bursts=DNS_BURSTS, s5_bursts=S5_BURSTS,
                  lb_bursts=LB_BURSTS, min_acl=CONTROL_MIN_ACL,
                  max_acl=N_ACL, matcher=None, dns_burst=DNS_BURST,
                  conn_burst=SERVICE_BATCH) -> dict:
    """The port as an operator runs it. Boots `python -m vproxy_tpu_torch
    noLoadLast noSave noStdIOController` with a resp-controller, an
    http-controller and the inspection server in a child process (a
    temporary VPROXY_TPU_HOME; the checkout on PYTHONPATH; the card
    host has no jax, so the boot itself shows the entry imports none;
    VPROXY_TPU_CLASSIFY=device: in the default "auto" mode the inline
    lane answers every lone query from the host index and nothing
    reaches the card, PERF.md §7), builds one operator config by command
    only: an event-loop group, then server groups, each with one server
    on its own loopback address (group_addr) at id-server i mod 256 and
    health check "none", added with one Host rule each (tcplb_rules:
    exact domains, suffix rules for wildcard records, a sixteenth with a
    uri) to one Upstream until `max_groups` or CONTROL_BUILD_S (never
    under CONTROL_MIN_GROUPS); one security group (default allow) with
    config #4's ACL (acl_rules, seed 42) as TCP rules and again as UDP
    rules, each until `max_acl` or CONTROL_ACL_BUILD_S (never under
    `min_acl`); a dns-server, a socks5-server and an http-splice tcp-lb
    on them (over HTTP). Then, from one spawned client process:
    `dns_bursts` x `dns_burst` UDP queries (DNS_INFLIGHT in flight,
    dns_plan), `s5_bursts` x `conn_burst` Socks5 domain CONNECTs with
    an HTTP request each, `lb_bursts` x `conn_burst` http-splice
    connections. Every DNS
    answer is the address (A) or the server (SRV) of the group the
    port's host index (HintIndex over the published rules) gives the
    name, or the DNS server's own answer where no rule holds it (IP
    literals echoed, who.am.i answered, NXDOMAIN otherwise: a dns-server
    built by command has no recursive resolver); every Socks5 and TcpLB
    answer comes from that group's id-server (a Socks5 CONNECT no rule
    holds is refused, a TcpLB request no rule holds takes the WRR
    fallback). From the child's /metrics (it is a real process: no
    in-process hook reaches it): launches == device batches, no fused
    (B1) dispatch, no failover, every query answered by the device.
    The scrape has no per-kind batch count (the reference's families
    carry none), so the phase infers B3 and B4 from it: each batch was
    one launch and none a fused one, and on this backend (`list-detail
    upstream`: `backend torch`, fused tier `cuda`) a hint batch's one
    launch is B3 and a cidr batch's B4 (with matcher="jax-fp": `backend
    torch-fp`, B6 and B7). SIGTERM at the end: the child exits 0 and
    writes no config (noSave). With a CPU `device` (the tier-1
    rehearsal) the child's matchers run on the CPU too
    (VPROXY_TPU_TORCH_DEVICE=cpu): the plain tiers, no kernel. -> the
    phase's numbers."""
    import multiprocessing as mp
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    from vproxy_tpu_torch.dns import packet as P
    from vproxy_tpu_torch.processors.http1 import HeadParser
    from vproxy_tpu_torch.rules.engine import HintMatcher
    from vproxy_tpu_torch.rules.index import CidrIndex, HintIndex
    from vproxy_tpu_torch.rules.ir import Hint, Proto
    from vproxy_tpu_torch.utils.ip import is_ip_literal, parse_ip
    fp = matcher == "jax-fp"
    root = os.path.dirname(os.path.abspath(__file__))
    check(raise_nofile() >= NOFILE_MIN, "RLIMIT_NOFILE too low")
    home = tempfile.mkdtemp(prefix="vproxy-home-")
    env = {k: v for k, v in os.environ.items()
           if k not in ("VPROXY_TPU_TORCH_DEVICE", "VPROXY_TPU_MATCHER")}
    env.update(PYTHONPATH=root, VPROXY_TPU_HOME=home,
               VPROXY_TPU_CLASSIFY="device", VPROXY_TPU_FD_PROVIDER="native")
    if matcher is not None:
        env["VPROXY_TPU_MATCHER"] = matcher
    if device.type == "cpu":
        env["VPROXY_TPU_TORCH_DEVICE"] = "cpu"
    ctx = mp.get_context("spawn")
    pipe, child_end = ctx.Pipe()
    backends = ctx.Process(target=_backend_main,
                           args=(TCPLB_BACKENDS, child_end, "0.0.0.0"),
                           daemon=True)
    backends.start()
    clients = ProcessPoolExecutor(1, mp_context=ctx)
    child = None
    try:
        check(pipe.poll(120), "the backend process sent no ports")
        bports = pipe.recv()
        t0 = time.monotonic()
        child, ports = _boot_child(
            ["noLoadLast", "noSave", "noStdIOController", "workers",
             str(CONTROL_WORKERS), "resp-controller", f"{LOOPBACK}:0",
             RESP_PASSWORD, "http-controller", f"{LOOPBACK}:0",
             "globalInspection", f"{LOOPBACK}:0"], env,
            os.path.join(home, "stderr.log"))
        boot_s = time.monotonic() - t0
        resp = Resp(ports["resp-controller"], RESP_PASSWORD)
        hport, iport = ports["http-controller"], ports["global-inspection"]
        clients.submit(_http_burst, hport, "splice", [],
                       conn_burst).result(timeout=120)  # the pool starts

        # ---- the operator config, by command
        n_cmds, t0 = 0, time.monotonic()
        for line in ("add event-loop-group elg-hc",
                     "add event-loop hc0 to event-loop-group elg-hc",
                     "add upstream u0"):
            check(resp.cmd(line) == "OK", line)
            n_cmds += 1
        rules = tcplb_rules(max_groups, TCPLB_RULE_SEED)
        n = 0
        for i, r in enumerate(rules):
            anno = {"vproxy/hint-host": r.host}
            if r.uri is not None:
                anno["vproxy/hint-uri"] = r.uri
            for line in (
                    f"add server-group g{i} timeout 1000 period 600000 up 1 "
                    "down 1 protocol none event-loop-group elg-hc",
                    f"add server s to server-group g{i} address "
                    f"{group_addr(i)}:{bports[i % len(bports)]} weight 10",
                    f"add server-group g{i} to upstream u0 weight 10 "
                    f"annotations {json.dumps(anno, separators=(',', ':'))}"):
                check(resp.cmd(line) == "OK", line)
                n_cmds += 1
            n = i + 1
            if n >= CONTROL_MIN_GROUPS and \
                    time.monotonic() - t0 > CONTROL_BUILD_S:
                break
        rules = rules[:n]
        groups_s = time.monotonic() - t0
        check(resp.cmd("add security-group acl default allow") == "OK",
              "add security-group")
        n_cmds += 1
        acl = acl_rules(max_acl, ACL_SEED)
        acl_n, acl_s = {}, {}
        for proto in ("tcp", "udp"):
            t1 = time.monotonic()
            k = 0
            for k, r in enumerate(acl, 1):
                line = (f"add security-group-rule {proto}{k} to "
                        f"security-group acl network {r.network} protocol "
                        f"{proto} port-range {r.min_port},{r.max_port} "
                        f"default {'allow' if r.allow else 'deny'}")
                check(resp.cmd(line) == "OK", line)
                n_cmds += 1
                if k >= min_acl and time.monotonic() - t1 > \
                        CONTROL_ACL_BUILD_S:
                    break
            acl_n[proto], acl_s[proto] = k, time.monotonic() - t1
        for body in (
                {"command": "add dns-server d0 address 127.0.0.1:0 "
                            "upstream u0 security-group acl"},
                {"command": "add socks5-server s5 address 127.0.0.1:0 "
                            "upstream u0 security-group acl"},
                {"command": "add tcp-lb lb0 address 127.0.0.1:0 upstream u0 "
                            "protocol http-splice security-group acl "
                            "lanes 0"}):
            check(http_json(hport, "/api/v1/command", body)["result"] ==
                  "OK", body["command"])
            n_cmds += 1
        build_s = time.monotonic() - t0

        def addr_of(module: str) -> int:
            return int(http_json(hport, f"/api/v1/module/{module}")[0][
                "address"].rsplit(":", 1)[1])
        dns_port, s5_port, lb_port = (addr_of(m) for m in (
            "dns-server", "socks5-server", "tcp-lb"))
        ups = resp.cmd("list-detail upstream")[0]
        want_be = "torch-fp" if fp else "torch"
        log(f"control: {n} groups in {groups_s:.1f} s, ACL {acl_n} in "
            f"{acl_s}, {n_cmds} commands in {build_s:.1f} s; {ups}")
        check(f" backend {want_be} rules {n} " in ups,
              f"the upstream does not serve {n} rules on {want_be}: {ups}")
        check(fp or device.type != "cuda" or "fused on(cuda," in ups,
              f"the fused tier is not the CUDA kernel: {ups}")
        # the child published exactly these rules: the port's checksum of
        # the same list (independent of the backend) equals its own
        local = HintMatcher(rules, backend="host")
        check(f"checksum {local.checksum():#010x}" in ups,
              f"the child's rules differ from the phase's: {ups}")
        index = HintIndex(rules)
        lo = parse_ip(LOOPBACK)
        for proto, pr in (("tcp", Proto.TCP), ("udp", Proto.UDP)):
            sub = acl[:acl_n[proto]]
            ci = CidrIndex([r.network for r in sub], acl=sub)
            check(all(ci.lookup(lo, p) == -1 for p in
                      (dns_port, s5_port, lb_port)),
                  f"a {proto} ACL rule matches the clients' address")

        # ---- traffic
        m0 = scrape(iport)
        dns_q0 = http_json(hport, "/api/v1/module/dns-server")[0]["queries"]
        rng_seed = CONTROL_QUERY_SEED
        dns_lat, first_lat, answers, tries, dns_wall = [], [], 0, 0, 0.0
        drops0 = udp_rcvbuf_errors()

        def dns_want(qname: str, qtype: str):
            """(rcode, [(rtype, rdata)]) the DNS server owes this query."""
            d = qname.rstrip(".")
            g = index.lookup(Hint.of_host(d))
            if g >= 0:
                if qtype == "SRV":
                    return 0, [(P.SRV, (0, 10, bports[g % len(bports)],
                                        group_addr(g) + "."))]
                return 0, [(P.A, parse_ip(group_addr(g)))]
            if is_ip_literal(d):
                return 0, [(P.A, parse_ip(d))]
            if d == "who.am.i.vproxy.local":
                return 0, [(P.A, lo)]
            return 3, []

        for b in range(dns_bursts):
            plan = dns_plan(rules, dns_burst, rng_seed + b)
            pkts = [P.Packet(id=i, rd=True, questions=[
                P.Question(q, getattr(P, t))]).encode()
                for i, (q, t) in enumerate(plan)]
            t1 = time.monotonic()
            got = clients.submit(_dns_burst, dns_port, pkts,
                                 DNS_INFLIGHT).result(timeout=600)
            dns_wall += time.monotonic() - t1
            for i, ((q, t), (data, secs, n_try)) in enumerate(zip(plan,
                                                                 got)):
                resp_p = P.parse(data)
                rc, want = dns_want(q, t)
                have = [(a.rtype, a.rdata) for a in resp_p.answers]
                check(resp_p.id == i and resp_p.rcode == rc and have == want,
                      f"DNS burst {b} query {i} {q} {t}: rcode "
                      f"{resp_p.rcode} {have}, the host index gives {rc} "
                      f"{want}")
                answers += bool(have)
                dns_lat.append(secs * 1e6)
                if n_try == 1:
                    first_lat.append(secs * 1e6)
                tries += n_try - 1
        rcvbuf_drops = udp_rcvbuf_errors() - drops0

        def s5_items(k: int) -> list:
            rng = np.random.default_rng(rng_seed + 100 + k)
            out = []
            for j in range(conn_burst):
                r = rules[int(rng.integers(len(rules)))]
                host = (f"miss{j}.nowhere.test" if j % 10 == 9 else
                        f"y{j}.{r.host}" if j % 3 == 0 else r.host)
                out.append((host, f"/s5/{j}"))
            return out

        s5_lat, s5_refused = [], 0
        t1 = time.monotonic()
        for k in range(s5_bursts):
            items = s5_items(k)
            got = clients.submit(_socks5_burst, s5_port, items,
                                 conn_burst).result(timeout=300)
            for j, ((host, path), (rep, secs, body)) in enumerate(
                    zip(items, got)):
                g = index.lookup(Hint.of_host_port(host, 80))
                if g < 0:
                    check(rep == 2, f"Socks5 {host}: reply {rep}, no rule "
                          f"holds it (want 2)")
                    s5_refused += 1
                    continue
                bid, _, seen = (body or "").partition(" ")
                check(rep == 0 and seen == host and
                      int(bid) == g % TCPLB_BACKENDS,
                      f"Socks5 burst {k} row {j} {host}: reply {rep}, "
                      f"body {body!r}, the host index gives group {g}")
                s5_lat.append(secs * 1e6)
        s5_wall = time.monotonic() - t1

        lb_lat, lb_matched = [], 0
        t1 = time.monotonic()
        for k in range(lb_bursts):
            reqs = tcplb_requests(rules, conn_burst, rng_seed + 200 + k)
            got = clients.submit(_http_burst, lb_port, "splice", reqs,
                                 conn_burst).result(timeout=300)
            for j, ((host, path), (_, secs, body)) in enumerate(zip(reqs,
                                                                    got)):
                p = HeadParser()
                p.feed(http_request(host, path, close=True))
                g = index.lookup(p.hint())
                bid, _, seen = body.partition(" ")
                check(seen == host and (g < 0 or
                                        int(bid) == g % TCPLB_BACKENDS),
                      f"tcp-lb burst {k} row {j} {host}{path}: body "
                      f"{body!r}, the host index gives group {g}")
                lb_matched += g >= 0
                lb_lat.append(secs * 1e6)
        lb_wall = time.monotonic() - t1

        # ---- the child's own counts
        m1 = scrape(iport)

        def d(k: str) -> float:
            return m1.get(k, 0.0) - m0.get(k, 0.0)
        dns_q = http_json(hport, "/api/v1/module/dns-server")[0][
            "queries"] - dns_q0
        accepted = {kind: int(resp.cmd(f"list accepted-conn-count in "
                                       f"{kind}")[0])
                    for kind in ("socks5-server s5", "tcp-lb lb0")}
        launches, batches = d("vproxy_engine_dispatch_launches_total"), \
            d("vproxy_classify_dispatches")
        queries, dev_q = d("vproxy_classify_queries"), \
            d("vproxy_classify_device_queries")
        cidr_q = dns_q + sum(accepted.values())
        check(launches == batches > 0, f"{launches} launches for {batches} "
              f"device batches")
        check(d("vproxy_engine_fused_dispatches_total") == 0,
              "a fused (B1) dispatch ran on the control path")
        check(d("vproxy_classify_failovers") == 0, "device failovers")
        check(d("vproxy_classify_oracle_queries") == 0 and dev_q == queries,
              f"{queries - dev_q} queries not answered by the device")
        check(dev_q > cidr_q > 0, f"{dev_q} device queries, {cidr_q} ACL "
              f"checks")

        hint_k, cidr_k = (("hint_fp_match (B6)", "cidr_fp_match (B7)") if fp
                          else ("hint_match (B3)", "cidr_first (B4)"))
        out = {"backend": want_be, "boot_s": boot_s,
               "groups": n, "groups_target": max_groups,
               "groups_build_s": groups_s, "acl_rules": acl_n,
               "acl_target": max_acl, "acl_build_s": acl_s,
               "commands": n_cmds, "build_s": build_s,
               "commands_per_s": n_cmds / build_s,
               "dns_queries": len(dns_lat), "dns_answered": answers,
               "dns_resends": tries, "udp_rcvbuf_drops": rcvbuf_drops,
               "dns_p50_us": pct(dns_lat, 50), "dns_p99_us": pct(dns_lat, 99),
               "dns_first_try_p50_us": pct(first_lat, 50),
               "dns_first_try_p99_us": pct(first_lat, 99),
               "dns_answers_per_s": len(dns_lat) / max(dns_wall, 1e-9),
               "socks5_sessions": len(s5_lat), "socks5_refused": s5_refused,
               "socks5_p50_us": pct(s5_lat, 50),
               "socks5_p99_us": pct(s5_lat, 99), "socks5_wall_s": s5_wall,
               "tcplb_connections": len(lb_lat), "tcplb_matched": lb_matched,
               "tcplb_p50_us": pct(lb_lat, 50),
               "tcplb_p99_us": pct(lb_lat, 99), "tcplb_wall_s": lb_wall,
               "queries": {"total": queries, "device": dev_q,
                           "cidr (datagrams + accepts)": cidr_q,
                           "hint (the rest)": dev_q - cidr_q},
               "batches": {"hint + cidr": batches,
                           "mean": dev_q / max(batches, 1),
                           "max": m1.get("vproxy_classify_max_batch")},
               "launches": {f"{hint_k} + {cidr_k}": launches,
                            "fused (B1)": d(
                                "vproxy_engine_fused_dispatches_total")},
               "failovers": d("vproxy_classify_failovers")}

        # ---- SIGTERM: a clean exit that writes no config
        resp.close()
        child.send_signal(15)
        rc = child.wait(120)
        check(rc == 0, f"the port exited {rc} on SIGTERM")
        check(not os.path.exists(os.path.join(home, "vproxy.last")),
              "the port saved a config though started with noSave")
        out["exit"] = rc
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait(10)
        clients.shutdown()
        try:
            pipe.send("stop")
        except OSError:
            pass
        backends.join(10)
        if backends.is_alive():
            backends.terminate()
            backends.join(5)
        shutil.rmtree(home, ignore_errors=True)
    return out


# ------------------------------------------------------------ switch
# BASELINE config #4 on the port's virtual switch, as bench_switch.py's
# build_world lays it out: vpc 1 and vpc 2 (both 10.0.0.0/8), 50,000
# /24 routes in vpc 1 into vni 2, a bare-VXLAN ACL of 5,000 UDP /24
# rules (even rules allow, odd deny, every port; default allow), the
# gateway 10.0.0.1 in vpc 1 and a source address in vpc 2.

SWITCH_PACKETS = 16_384
SWITCH_BUILD_S = 10.0   # each command build's budget: every add republishes
SWITCH_MIN_CMD = 256    # rules of each command build, at least
SWITCH_SEED = 404
SWITCH_SENDERS = 64     # outer senders: 8 in deny /24s, 8 in allow, 48 out
SWITCH_CHUNK = 256      # datagrams in flight on the loopback run
SWITCH_DST_MACS = 16
SWITCH_GW = "10.0.0.1"
SWITCH_SRC2 = "10.255.255.254"


def switch_acl(n: int) -> list:
    """bench_switch.build_world's bare ACL: rule i is UDP, every port,
    allow when i is even, over the /24 the bench gives it with 127 for
    its first byte 172 (127.16-35.x.0/24 at 5,000 rules), so that a
    loopback sender can sit inside a rule's network."""
    from vproxy_tpu_torch.rules.ir import AclRule, Proto
    from vproxy_tpu_torch.utils.ip import Network
    return [AclRule(f"a{i}", Network.parse(
        f"127.{16 + (i >> 8) % 220}.{i & 255}.0/24"), Proto.UDP, 0, 65535,
        (i & 1) == 0) for i in range(n)]


def switch_routes(n: int) -> list:
    """bench_switch.build_world's routes: 10.a.b.0/24 -> vni 2, a = 1 +
    (i >> 8) mod 200, b = i mod 256 (a <= 196 at 50,000 routes)."""
    from vproxy_tpu_torch.rules.ir import RouteRule
    from vproxy_tpu_torch.utils.ip import Network
    return [RouteRule(f"r{i}", Network.parse(
        f"10.{1 + (i >> 8) % 200}.{i & 255}.0/24"), to_vni=2)
        for i in range(n)]


def switch_senders(acl: list, seed: int) -> list:
    """SWITCH_SENDERS outer sender addresses on loopback: the first
    eighth inside the /24s of random deny rules, the next eighth inside
    random allow rules, the rest (127.250.0.k) outside every rule."""
    rng = random.Random(seed)
    eighth = SWITCH_SENDERS // 8
    deny = [j for j in range(len(acl)) if not acl[j].allow]
    allow = [j for j in range(len(acl)) if acl[j].allow]
    out = []
    for k in range(SWITCH_SENDERS):
        if k < 2 * eighth:
            j = rng.choice(deny if k < eighth else allow)
            net = str(acl[j].network).split("/")[0].rsplit(".", 1)[0]
            out.append(f"{net}.{2 + k}")
        else:
            out.append(f"127.250.0.{k}")
    return out


def switch_traffic(routes: list, n: int, seed: int) -> list:
    """n VXLAN datagrams into vni 1, packet i from sender i mod
    SWITCH_SENDERS (its own inner mac and address): inner IPv4 UDP to
    the gateway's mac, to an address under a random route (a sixteenth
    of them under no route: 10.200-254.x.y), the packet's index in the
    first 4 payload bytes. -> [(datagram, sender index, dst)]."""
    from vproxy_tpu_torch.utils.ip import parse_ip
    from vproxy_tpu_torch.vswitch.packets import Ethernet, Ipv4, Vxlan
    from vproxy_tpu_torch.vswitch.switch import synthetic_mac
    rng = random.Random(seed)
    gw_mac = synthetic_mac(1, parse_ip(SWITCH_GW))
    misses = set(rng.sample(range(n), n // 16))
    out = []
    for i in range(n):
        k = i % SWITCH_SENDERS
        if i in misses:
            dst = bytes([10, rng.randrange(200, 255), rng.randrange(256),
                         rng.randrange(1, 255)])
        else:
            net = routes[rng.randrange(len(routes))].rule.ip
            dst = net[:3] + bytes([rng.randrange(1, 255)])
        ip = Ipv4(src=bytes([10, 0, 1, 1 + k]), dst=dst, proto=17,
                  payload=i.to_bytes(4, "big") + b"x" * 14, ttl=64)
        eth = Ethernet(gw_mac, bytes([2, 0xaa, 0, 0, 0, k]), 0x0800, b"",
                       packet=ip)
        out.append((Vxlan(1, eth).to_bytes(), k, dst))
    return out


def switch_dst_mac(dst: bytes) -> bytes:
    return bytes([2, 0xfe, 0, 0, 0, dst[3] % SWITCH_DST_MACS])


class _Receiver:
    """A loopback UDP socket the switch egresses to (a remote-switch
    link), drained by a thread of its own: datagram bytes in arrival
    order."""

    def __init__(self, vtl):
        self.vtl = vtl
        self.fd = vtl.udp_bind(LOOPBACK, 0)
        vtl.set_rcvbuf(self.fd, 8 << 20)
        self.port = vtl.sock_name(self.fd)[1]
        self.got: list = []
        self._stop = False
        self._th = threading.Thread(target=self._run, daemon=True)
        self._th.start()

    def _run(self) -> None:
        while not self._stop:
            if self.vtl.wait_readable(self.fd, 50) <= 0:
                continue
            while True:
                r = self.vtl.recvmmsg(self.fd)
                if not r:
                    break
                self.got.extend(d for d, _, _ in r)

    def wait(self, n: int, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while len(self.got) < n:
            check(time.monotonic() < deadline,
                  f"switch egress: {len(self.got)} of {n} datagrams "
                  f"arrived (UDP receive-buffer drops "
                  f"{udp_rcvbuf_errors()})")
            time.sleep(0.001)

    def take(self) -> list:
        out, self.got = self.got, []
        return out

    def close(self) -> None:
        self._stop = True
        self._th.join(5)
        self.vtl.close(self.fd)


def _switch_counts() -> dict:
    """The switch's drop counters by reason (swmetrics), its rx total,
    and the native flow table's drops by reason."""
    from vproxy_tpu_torch.net import vtl
    from vproxy_tpu_torch.vswitch import swmetrics as SM
    out = {r: SM._ctr("vproxy_switch_drops_total", reason=r).value()
           for r in SM.DROP_REASONS}
    out["rx"] = SM._ctr("vproxy_switch_rx_total").value()
    fc = vtl.flowcache_counters()
    for j, r in enumerate(vtl.FLOW_DROP_REASONS):
        out[f"native {r}"] = fc[5 + j]
    out["native hits"] = fc[0]
    return out


def _kernel_counters():
    from vproxy_tpu_torch.ops import cidr_cuda as CC
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    from vproxy_tpu_torch.ops import fused_cuda as FC
    return {"cidr_first": CC.cidr_first_cuda,
            "cidr_fp_match": FPC.cidr_fp_cuda,
            "hint_fp_match": FPC.hint_fp_cuda,
            "fused_classify_pick": FC.fused_classify_pick_cuda,
            "hint_match": FC.hint_match_cuda}


@contextlib.contextmanager
def _match_timer(acl_m, route_m, calls: list):
    """Times every CidrMatcher.match round trip (and its address encode,
    engine._cidr_q) while the block runs: calls gets (which, rows,
    round trip ns, encode ns) per call."""
    from vproxy_tpu_torch.rules import engine as E
    match, cidr_q = E.CidrMatcher.match, E._cidr_q
    enc = [0]

    def timed_q(*a, **kw):
        t0 = time.perf_counter_ns()
        try:
            return cidr_q(*a, **kw)
        finally:
            enc[0] += time.perf_counter_ns() - t0

    def timed(self, addrs, ports=None):
        enc[0] = 0
        t0 = time.perf_counter_ns()
        out = match(self, addrs, ports)
        which = ("acl" if self is acl_m else
                 "routes" if self is route_m else "other")
        calls.append((which, len(addrs), time.perf_counter_ns() - t0,
                      enc[0]))
        return out

    E.CidrMatcher.match, E._cidr_q = timed, timed_q
    try:
        yield
    finally:
        E.CidrMatcher.match, E._cidr_q = match, cidr_q


def phase_switch(device, n_routes=N_ROUTES, n_acl=N_ACL,
                 n_packets=SWITCH_PACKETS, build_s=SWITCH_BUILD_S,
                 min_cmd=SWITCH_MIN_CMD) -> dict:
    """BASELINE config #4 through the port's virtual switch. The port's
    Application builds it in process with Command.execute: a security
    group (default allow), `add switch` on it, vpc 1 and vpc 2, their
    gateway and source addresses, a remote-switch link to a loopback
    receiver, then `add security-group-rule` (UDP) and `add route` one
    by one until all are in or `build_s` passes (never under `min_cmd`
    each: every add republishes its whole table), and the rest of the
    5,000 rules and 50,000 routes in bulk as bench_switch.py's
    build_world does (SecurityGroup.extend_rules, one _sync_routes).
    The vpc 2 arp and mac entries of every destination are recorded as
    build_world records them. Traffic: `n_packets` datagrams
    (switch_traffic), replayed three times in RECV_BURST bursts:

    (a) the object path (the switch's fast path detached, which is what
        VPROXY_TPU_SWITCH_FASTPATH=0 builds): Switch._input_batch on the
        loop thread per burst, as bench_switch.replay does; one B4
        launch per burst for the ACL (allow_batch) and one per burst
        for the routes (route_lookup_batch), the CidrMatcher round trip
        of each timed;
    (b) the default data plane (the numpy fast path and the native flow
        cache) through the switch's own UDP socket: the datagrams sent
        from their senders' loopback addresses, SWITCH_CHUNK in flight,
        twice (the second pass meets the flow entries of the first);
        its device launches are recorded, not checked;
    (c) (a) on a second switch and security group built with
        VPROXY_TPU_MATCHER=jax-fp (the config in bulk): one B7 launch
        per ACL and per route batch.

    Every datagram's outcome equals what the host indexes predict
    (CidrIndex over the ACL at the switch's port, then over the routes):
    dropped as acl_deny or route_miss, or delivered into vni 2 with its
    destination's mac, the vpc 2 source's synthetic mac, TTL 63 and a
    valid header checksum; the egress bytes of (a), both passes of (b)
    and (c) are identical; the drop counters (swmetrics, plus the native
    table's in (b)) equal the predicted counts, and no other reason
    counts. On the CPU (the tier-1 rehearsal) the matchers run the plain
    tiers: the engine's dispatches are checked, and no kernel launches.
    -> the phase's numbers."""
    from vproxy_tpu_torch.control.app import Application
    from vproxy_tpu_torch.control.command import Command
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules.index import CidrIndex
    from vproxy_tpu_torch.rules.ir import Proto
    from vproxy_tpu_torch.utils.ip import parse_ip
    from vproxy_tpu_torch.vswitch import packets as P
    from vproxy_tpu_torch.vswitch import swmetrics as SM
    from vproxy_tpu_torch.vswitch.switch import synthetic_mac
    vtl = native_vtl()
    on_card = device.type == "cuda"
    saved_env = {k: os.environ.get(k) for k in (
        "VPROXY_TPU_MATCHER", "VPROXY_TPU_SWITCH_FASTPATH",
        "VPROXY_TPU_INSTALL_PACE")}
    # batch loads with no serving beside them: unpaced installs
    os.environ["VPROXY_TPU_INSTALL_PACE"] = "0"
    for k in ("VPROXY_TPU_MATCHER", "VPROXY_TPU_SWITCH_FASTPATH"):
        os.environ.pop(k, None)
    acl, routes = switch_acl(n_acl), switch_routes(n_routes)
    senders = switch_senders(acl, SWITCH_SEED)
    traffic = switch_traffic(routes, n_packets, SWITCH_SEED + 1)
    rx = _Receiver(vtl)
    socks = []
    app = Application.create(workers=1)
    run = Command.execute
    try:
        for ip in senders:
            fd = vtl.udp_bind(ip, 0)
            socks.append((fd, (ip, vtl.sock_name(fd)[1])))

        def world(sw_name, sg_name, by_command):
            t0 = time.monotonic()
            for line in (
                    f"add security-group {sg_name} default allow",
                    f"add switch {sw_name} address {LOOPBACK}:0 "
                    f"security-group {sg_name}",
                    f"add vpc 1 to switch {sw_name} v4network 10.0.0.0/8",
                    f"add vpc 2 to switch {sw_name} v4network 10.0.0.0/8",
                    f"add ip {SWITCH_GW} to vpc 1 in switch {sw_name}",
                    f"add ip {SWITCH_SRC2} to vpc 2 in switch {sw_name}",
                    f"add switch out to switch {sw_name} address "
                    f"{LOOPBACK}:{rx.port}"):
                check(run(app, line) == "OK", line)
            sw, sg = app.switches[sw_name], app.security_groups[sg_name]
            n1, n2 = sw.networks[1], sw.networks[2]
            acl_n = route_n = 0
            t1 = time.monotonic()
            if by_command:
                for r in acl:
                    check(run(app, (
                        f"add security-group-rule {r.alias} to "
                        f"security-group {sg_name} network {r.network} "
                        f"protocol udp port-range 0,65535 default "
                        f"{'allow' if r.allow else 'deny'}")) == "OK",
                        r.alias)
                    acl_n += 1
                    if acl_n >= min_cmd and time.monotonic() - t1 > build_s:
                        break
            acl_s = time.monotonic() - t1
            t1 = time.monotonic()
            if by_command:
                for r in routes:
                    check(run(app, (
                        f"add route {r.alias} to vpc 1 in switch {sw_name} "
                        f"network {r.rule} vni 2")) == "OK", r.alias)
                    route_n += 1
                    if route_n >= min_cmd and \
                            time.monotonic() - t1 > build_s:
                        break
            route_s = time.monotonic() - t1
            t1 = time.monotonic()
            if acl_n < len(acl):
                sg.extend_rules(acl[acl_n:])
            if route_n < len(routes):
                n1.routes.rules_v4.extend(routes[route_n:])
                n1._sync_routes()
            bulk_s = time.monotonic() - t1
            out_if = sw.ifaces[("remote", "out")][0]
            for _, _, dst in traffic:
                n2.arps.record(dst, switch_dst_mac(dst))
            for m in range(SWITCH_DST_MACS):
                n2.macs.record(bytes([2, 0xfe, 0, 0, 0, m]), out_if)
            check([r.alias for r in n1.routes.rules_v4] ==
                  [r.alias for r in routes], "route table order")
            check([r.alias for r in sg.rules] == [r.alias for r in acl],
                  "ACL order")
            return sw, sg, {
                "acl_by_command": acl_n, "acl_command_s": acl_s,
                "routes_by_command": route_n, "routes_command_s": route_s,
                "bulk_s": bulk_s, "build_s": time.monotonic() - t0}

        sw, sg, build = world("sw0", "swacl", True)
        n1 = sw.networks[1]
        acl_m, route_m = sg._tables[Proto.UDP][0], n1._matcher_v4
        want_be = "torch"
        check(acl_m.backend == route_m.backend == want_be,
              f"the switch's matchers serve on {acl_m.backend!r} / "
              f"{route_m.backend!r}, not {want_be!r}")
        log(f"switch: ACL {build['acl_by_command']} by command in "
            f"{build['acl_command_s']:.1f} s, routes "
            f"{build['routes_by_command']} by command in "
            f"{build['routes_command_s']:.1f} s, the rest in bulk in "
            f"{build['bulk_s']:.1f} s (of {len(acl)} and {len(routes)})")

        # ---- the host indexes' prediction
        acl_idx = CidrIndex([r.network for r in acl], acl=acl)
        route_idx = CidrIndex([r.rule for r in routes])

        def allowed(k, port):
            j = acl_idx.lookup(parse_ip(senders[k]), port)
            return acl[j].allow if j >= 0 else True

        def predict(port):
            ok = [allowed(k, port) for k in range(SWITCH_SENDERS)]
            outcome = []
            for _, k, dst in traffic:
                outcome.append("acl_deny" if not ok[k] else
                               "route_miss" if route_idx.lookup(dst) < 0
                               else "fwd")
            return outcome

        outcome = predict(sw.bind_port)
        want = {r: outcome.count(r) for r in ("acl_deny", "route_miss")}
        fwd = outcome.count("fwd")
        check(min(want.values()) > 0 and fwd > 0,
              f"the traffic holds every outcome: {want}, {fwd} delivered")
        src2_mac = synthetic_mac(2, parse_ip(SWITCH_SRC2))

        def verify(datagrams, what):
            """-> {packet index: egress bytes}, each checked against its
            packet's prediction."""
            got = {}
            for d in datagrams:
                vx = P.Vxlan.parse(d)
                e = vx.ether
                ip = e.packet
                check(vx.vni == 2 and e.ether_type == 0x0800 and
                      isinstance(ip, P.Ipv4), f"{what}: not IPv4 in vni 2")
                i = int.from_bytes(bytes(ip.payload[:4]), "big")
                check(0 <= i < len(traffic) and i not in got,
                      f"{what}: egress of packet {i} twice or unknown")
                _, k, dst = traffic[i]
                check(outcome[i] == "fwd",
                      f"{what}: packet {i} egressed, predicted "
                      f"{outcome[i]}")
                check(e.dst == switch_dst_mac(dst) and e.src == src2_mac,
                      f"{what}: packet {i} macs")
                check(ip.dst == dst and ip.src == bytes([10, 0, 1, 1 + k])
                      and ip.ttl == 63 and ip.proto == 17 and
                      bytes(ip.payload) == i.to_bytes(4, "big") + b"x" * 14,
                      f"{what}: packet {i} header or payload")
                check(P.checksum(d[22:42]) == 0,
                      f"{what}: packet {i} header checksum")
                got[i] = d
            check(len(got) == fwd,
                  f"{what}: {len(got)} delivered, predicted {fwd}")
            return got

        def drops(c0, c1, what, native=False):
            d = {r: c1[r] - c0[r] for r in c1}
            seen = {r: d[r] + (d.get(f"native {r}", 0) if native else 0)
                    for r in SM.DROP_REASONS}
            if native:
                seen["other"] = d["native other"]
            check(seen == {**{r: 0 for r in seen}, **want},
                  f"{what}: drops {seen}, predicted {want}")
            return seen

        bursts = [traffic[i:i + sw.RECV_BURST]
                  for i in range(0, len(traffic), sw.RECV_BURST)]
        burst_outcomes = [outcome[i:i + sw.RECV_BURST]
                          for i in range(0, len(traffic), sw.RECV_BURST)]
        route_batches = sum(any(o != "acl_deny" for o in b)
                            for b in burst_outcomes)

        def replay(sw_, acl_m_, route_m_, what):
            """One object-path run: -> (egress, numbers)."""
            kern = _kernel_counters()
            for f in kern.values():
                f.launches = 0
            disp0 = E.dispatch_launches_total()
            c0 = _switch_counts()
            calls, busy = [], 0.0
            with _match_timer(acl_m_, route_m_, calls):
                n_out = 0
                for b, outs in zip(bursts, burst_outcomes):
                    dg = [(d, socks[k][1][0], socks[k][1][1])
                          for d, k, _ in b]
                    t0 = time.perf_counter()
                    sw_.loop.call_sync(lambda: sw_._input_batch(dg),
                                       timeout=600)
                    busy += time.perf_counter() - t0
                    n_out += outs.count("fwd")
                    rx.wait(n_out)
            launches = {k: f.launches for k, f in kern.items()}
            disp = E.dispatch_launches_total() - disp0
            seen = drops(c0, _switch_counts(), what)
            egress = verify(rx.take(), what)
            acl_calls = [c for c in calls if c[0] == "acl"]
            route_calls = [c for c in calls if c[0] == "routes"]
            check(len(acl_calls) == len(bursts) and
                  len(route_calls) == route_batches and
                  len(calls) == len(acl_calls) + len(route_calls),
                  f"{what}: {len(acl_calls)} ACL and {len(route_calls)} "
                  f"route batches, predicted {len(bursts)} and "
                  f"{route_batches}")
            check(disp == len(calls), f"{what}: {disp} engine dispatches "
                  f"for {len(calls)} batches")
            rtt = [c[2] / 1e3 for c in calls]
            share = [c[3] / c[2] for c in calls]
            return egress, {
                "packets": len(traffic), "bursts": len(bursts),
                "pps": len(traffic) / busy, "busy_s": busy,
                "acl_batches": len(acl_calls),
                "route_batches": len(route_calls),
                "launches": launches, "engine_dispatches": disp,
                "drops": seen,
                "match_rtt_us": {"p50": pct(rtt, 50), "p99": pct(rtt, 99),
                                 "encode_share_p50": pct(share, 50),
                                 "acl_p50": pct([c[2] / 1e3 for c in
                                                  acl_calls], 50),
                                 "routes_p50": pct([c[2] / 1e3 for c in
                                                     route_calls], 50)}}

        # ---- (a) the object path on "torch"
        fastpath, sw.fastpath = sw.fastpath, None
        try:
            ego_a, run_a = replay(sw, acl_m, route_m, "object path")
        finally:
            sw.fastpath = fastpath
        b4 = run_a["launches"]["cidr_first"]
        if on_card:
            check(b4 == run_a["acl_batches"] + run_a["route_batches"],
                  f"B4 launches {b4} != ACL + route batches")
            check(sum(run_a["launches"].values()) == b4,
                  f"other kernels launched: {run_a['launches']}")
        log(f"switch (a): {run_a['pps']:.0f} packets/s, B4 {b4}, match "
            f"p50 {run_a['match_rtt_us']['p50']:.0f} us")

        # ---- (b) the default data plane over the switch's UDP socket
        check(sw.fastpath is not None, "the switch has no fast path")
        check(sw.flow_handle() is not None or not vtl.flowcache_supported(),
              "the native flow cache is off")
        kern = _kernel_counters()
        for f in kern.values():
            f.launches = 0
        disp0 = E.dispatch_launches_total()
        passes = []
        for p in range(2):
            c0 = _switch_counts()
            t0 = time.perf_counter()
            n_out = sent = 0
            for i in range(0, len(traffic), SWITCH_CHUNK):
                for d, k, _ in traffic[i:i + SWITCH_CHUNK]:
                    vtl.sendto(socks[k][0], d, LOOPBACK, sw.bind_port)
                sent += len(traffic[i:i + SWITCH_CHUNK])
                n_out += outcome[i:i + SWITCH_CHUNK].count("fwd")
                rx.wait(n_out)
            deadline = time.monotonic() + 30
            while _switch_counts()["rx"] - c0["rx"] < sent:
                check(time.monotonic() < deadline,
                      "the switch did not take every datagram "
                      f"(UDP receive-buffer drops {udp_rcvbuf_errors()})")
                time.sleep(0.001)
            wall = time.perf_counter() - t0
            c1 = _switch_counts()
            seen = drops(c0, c1, f"default plane, pass {p + 1}",
                         native=True)
            egress = verify(rx.take(), f"default plane, pass {p + 1}")
            check(egress == ego_a, f"default plane, pass {p + 1}: egress "
                  "bytes differ from the object path's")
            passes.append({"pps": len(traffic) / wall, "wall_s": wall,
                           "flow_hits": c1["native hits"] -
                           c0["native hits"], "drops": seen})
        run_b = {"chunk": SWITCH_CHUNK, "passes": passes,
                 "launches": {k: f.launches for k, f in kern.items()},
                 "engine_dispatches": E.dispatch_launches_total() - disp0,
                 "flowcache": sw.flowcache_info()}
        log(f"switch (b): {passes[0]['pps']:.0f} / {passes[1]['pps']:.0f} "
            f"packets/s, device launches {run_b['launches']}, engine "
            f"dispatches {run_b['engine_dispatches']}")

        # ---- (c) the object path on "torch-fp"
        os.environ["VPROXY_TPU_MATCHER"] = "jax-fp"
        os.environ["VPROXY_TPU_SWITCH_FASTPATH"] = "0"
        try:
            sw_fp, sg_fp, build_fp = world("sw1", "swacl-fp", False)
        finally:
            os.environ.pop("VPROXY_TPU_MATCHER", None)
            os.environ.pop("VPROXY_TPU_SWITCH_FASTPATH", None)
        check(sw_fp.fastpath is None, "the fp switch has a fast path")
        acl_fp = sg_fp._tables[Proto.UDP][0]
        route_fp = sw_fp.networks[1]._matcher_v4
        check(acl_fp.backend == route_fp.backend == "torch-fp",
              "the fp switch's matchers do not serve on 'torch-fp'")
        check(predict(sw_fp.bind_port) == outcome,
              "the fp switch's port changes the prediction")
        ego_c, run_c = replay(sw_fp, acl_fp, route_fp, "object path, fp")
        check(ego_c == ego_a, "fp object path: egress bytes differ")
        b7 = run_c["launches"]["cidr_fp_match"]
        if on_card:
            check(b7 == run_c["acl_batches"] + run_c["route_batches"],
                  f"B7 launches {b7} != ACL + route batches")
            check(sum(run_c["launches"].values()) == b7,
                  f"other kernels launched: {run_c['launches']}")
        log(f"switch (c): {run_c['pps']:.0f} packets/s, B7 {b7}")
        return {"routes": len(routes), "acl_rules": len(acl),
                "build": {**build, "acl_target": len(acl),
                          "routes_target": len(routes),
                          "min_by_command": min_cmd,
                          "command_budget_s": build_s},
                "build_fp_bulk_s": build_fp["bulk_s"],
                "packets": len(traffic), "senders": SWITCH_SENDERS,
                "outcomes": {"delivered": fwd, **want},
                "object_torch": run_a, "default_plane": run_b,
                "object_fp": run_c,
                "launches": {"cidr_first": b4, "cidr_fp_match": b7}}
    finally:
        app.close()
        rx.close()
        for fd, _ in socks:
            vtl.close(fd)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------- host apps
# The deployable apps, WebSocks and the docker network plugin: host
# subsystems, but the plugin's VPCs route on the card through B4.

APPS_STREAMS = 64              # concurrent TCP streams over one KCP session
APPS_STREAM_BYTES = 256 * 1024
APPS_SEED = 505
WS_TCP = 128                   # SOCKS5 CONNECTs over the TCP transport
WS_KCP = 128                   # ... and over KCP
WS_BYTES = 64 * 1024           # echoed per CONNECT
WS_HTTP_CONNECTS = 16
WS_USER = "smoke:chip-smoke"
WS_SEED = 606
DOCKER_NETWORKS = 8
DOCKER_BATCH = 512
DOCKER_SEED = 707


def _app_env(device) -> dict:
    """The environment of an app child: this checkout on the path,
    unbuffered output, and the CPU asked for when the phase runs there
    (the tier-1 rehearsal)."""
    env = dict(os.environ)
    env.update(PYTHONPATH=os.path.dirname(os.path.abspath(__file__)),
               PYTHONUNBUFFERED="1")
    if device.type != "cuda":
        env["VPROXY_TPU_TORCH_DEVICE"] = "cpu"
    return env


class _AppChild:
    """`python -m vproxy_tpu_torch <args>`, its stdout read on a thread;
    expect() waits for a line matching a pattern."""

    def __init__(self, name: str, args: list, env: dict, err_dir: str):
        import queue
        self.name = name
        self.err_path = os.path.join(err_dir, name.replace(" ", "_") + ".err")
        with open(self.err_path, "w") as err:
            self.p = subprocess.Popen(
                [sys.executable, "-m", "vproxy_tpu_torch", *args], env=env,
                cwd=env["PYTHONPATH"], stdout=subprocess.PIPE, stderr=err,
                text=True)
        self.lines = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.p.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def expect(self, pattern: str, timeout: float = 120.0):
        import queue
        deadline, seen = time.monotonic() + timeout, []
        while True:
            try:
                line = self.lines.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                line = None
            if line is None:
                with open(self.err_path) as f:
                    tail = f.read()[-2000:]
                raise RuntimeError(
                    f"chip smoke failed: {self.name} printed no "
                    f"{pattern!r} (rc {self.p.poll()}): {seen} {tail}")
            seen.append(line.rstrip())
            m = re.search(pattern, line)
            if m:
                return m

    def stop(self) -> int:
        """SIGTERM, then its exit code (-9 when it had to be killed)."""
        import signal
        if self.p.poll() is None:
            self.p.send_signal(signal.SIGTERM)
        try:
            return self.p.wait(30)
        except subprocess.TimeoutExpired:
            self.kill()
            return -9

    def kill(self) -> None:
        if self.p.poll() is None:
            self.p.kill()
            self.p.wait(10)


class _EchoServer:
    """A loopback TCP echo server, one thread per connection."""

    def __init__(self):
        import socket
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((LOOPBACK, 0))
        self.sock.listen(1024)
        self.port = self.sock.getsockname()[1]
        self.accepted = 0
        self.conns = []
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self) -> None:
        while True:
            try:
                c, _ = self.sock.accept()
            except OSError:
                return
            self.accepted += 1
            self.conns.append(c)
            threading.Thread(target=self._echo, args=(c,), daemon=True).start()

    @staticmethod
    def _echo(c) -> None:
        try:
            while True:
                d = c.recv(262144)
                if not d:
                    break
                c.sendall(d)
        except OSError:
            pass
        finally:
            c.close()

    def close(self) -> None:
        import socket
        try:
            self.sock.shutdown(socket.SHUT_RDWR)  # wakes the accept
        except OSError:
            pass
        self.sock.close()
        for c in self.conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def _recv_n(c, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        d = c.recv(n - len(buf))
        if not d:
            break
        buf += d
    return buf


def _socks5_to(target_port: int):
    """A SOCKS5 CONNECT handshake to 127.0.0.1:target_port."""
    import socket
    import struct

    def hs(c) -> bytes:
        c.sendall(b"\x05\x01\x00")
        check(_recv_n(c, 2) == b"\x05\x00", "socks5 method reply")
        c.sendall(b"\x05\x01\x00\x01" + socket.inet_aton(LOOPBACK) +
                  struct.pack(">H", target_port))
        rep = _recv_n(c, 10)
        if rep[:2] != b"\x05\x00":
            raise ConnectionRefusedError(f"socks5 reply {rep!r}")
        return b""
    return hs


def _http_connect_to(target_port: int):
    """An HTTP CONNECT handshake; -> the tunnel bytes read past it."""
    def hs(c) -> bytes:
        c.sendall(f"CONNECT {LOOPBACK}:{target_port} HTTP/1.1\r\n"
                  f"host: {LOOPBACK}\r\n\r\n".encode())
        head = b""
        while b"\r\n\r\n" not in head:
            d = c.recv(4096)
            check(bool(d), f"HTTP CONNECT: no reply head: {head!r}")
            head += d
        head, _, rest = head.partition(b"\r\n\r\n")
        check(b" 200 " in head.split(b"\r\n", 1)[0],
              f"HTTP CONNECT refused: {head!r}")
        return rest
    return hs


def _echo_stream(port: int, payload: bytes, handshake=None,
                 timeout: float = 120.0) -> dict:
    """One connection to 127.0.0.1:port (after `handshake`): payload
    written on a thread while its echo is read back. -> {"ok",
    "first_s": connect -> first echoed byte, "done_s"}."""
    import socket
    t0 = time.perf_counter()
    c = socket.create_connection((LOOPBACK, port), timeout=timeout)
    try:
        c.settimeout(timeout)
        got = bytearray(handshake(c) if handshake else b"")
        first = time.perf_counter() - t0 if got else None
        err = []

        def write():
            try:
                c.sendall(payload)
            except OSError as e:
                err.append(e)
        w = threading.Thread(target=write, daemon=True)
        w.start()
        while len(got) < len(payload):
            d = c.recv(262144)
            if not d:
                break
            if first is None:
                first = time.perf_counter() - t0
            got += d
        w.join(timeout)
        return {"ok": bytes(got) == payload and not err, "first_s": first,
                "done_s": time.perf_counter() - t0}
    finally:
        c.close()


def await_tunnel(port: int, target_port: int, what: str,
                 timeout: float = 60.0) -> None:
    """Retry a SOCKS5 CONNECT through the agent at `port` to the echo
    server at `target_port` until a probe echoes: a websocks agent
    refuses until its health check has passed (its default period is
    5 s)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            if _echo_stream(port, b"probe", _socks5_to(target_port),
                            timeout=10)["ok"]:
                return
        except OSError:  # ConnectionRefusedError: the agent's refusal
            pass
        check(time.monotonic() < deadline, f"{what} never tunnelled a probe")
        time.sleep(0.2)


def _echo_burst(port: int, payloads: list, handshake=None) -> tuple:
    """Every payload on a connection of its own, all at once. ->
    (results, wall seconds)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(payloads)) as ex:
        res = list(ex.map(lambda p: _echo_stream(port, p, handshake),
                          payloads))
    return res, time.perf_counter() - t0


def _seeded_payloads(n: int, size: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            for _ in range(n)]


def phase_apps(device=torch.device("cpu"), streams=APPS_STREAMS,
               stream_bytes=APPS_STREAM_BYTES) -> dict:
    """The helloworld and kcptun apps as an operator runs them, each a
    `python -m vproxy_tpu_torch` child: helloworld's TCP and UDP echo
    (its greeting, then the bytes sent); a kcptun server in front of a
    loopback echo server and a kcptun client dialling it, then
    `streams` concurrent TCP connections through the client, each
    writing a seeded `stream_bytes` while reading its echo back, all
    over the one KCP session. Every byte equal; every child exits 0 on
    SIGTERM. -> wall seconds and MB/s (payload bytes one way over the
    burst's wall time)."""
    import shutil
    import socket
    import tempfile
    from vproxy_tpu_torch.apps.helloworld import GREETING
    env = _app_env(device)
    payloads = _seeded_payloads(streams, stream_bytes, APPS_SEED)
    echo = _EchoServer()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-apps-")
    kids = []
    try:
        t0 = time.perf_counter()
        hw = _AppChild("helloworld", ["helloworld", "0"], env, tmp)
        kids.append(hw)
        ks = _AppChild("kcptun server", ["kcptun", "server", "0",
                                         f"{LOOPBACK}:{echo.port}"], env, tmp)
        kids.append(ks)
        uport = int(ks.expect(r"udp (\d+) ->")[1])
        kc = _AppChild("kcptun client", ["kcptun", "client", "0",
                                         f"{LOOPBACK}:{uport}"], env, tmp)
        kids.append(kc)
        hport = int(hw.expect(r"echo on tcp/udp 0\.0\.0\.0:(\d+)")[1])
        tport = int(kc.expect(r"tcp (\d+) ->")[1])
        boot_s = time.perf_counter() - t0
        c = socket.create_connection((LOOPBACK, hport), timeout=10)
        c.sendall(b"ping")
        tcp_ok = _recv_n(c, len(GREETING) + 4) == GREETING + b"ping"
        c.close()
        u = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        u.settimeout(10)
        u.sendto(b"uping", (LOOPBACK, hport))
        udp_ok = u.recvfrom(4096)[0] == GREETING + b"uping"
        u.close()
        check(tcp_ok and udp_ok, f"helloworld echo: tcp {tcp_ok}, udp "
              f"{udp_ok}")
        res, wall = _echo_burst(tport, payloads)
        bad = sum(not r["ok"] for r in res)
        check(bad == 0, f"kcptun: {bad} of {streams} streams did not echo "
              "every byte")
        check(echo.accepted == streams, f"kcptun: the backend accepted "
              f"{echo.accepted} connections, not {streams}")
        codes = {k.name: k.stop() for k in kids}
        check(all(v == 0 for v in codes.values()),
              f"an app did not exit 0 on SIGTERM: {codes}")
        total = streams * stream_bytes
        out = {"helloworld": {"tcp": tcp_ok, "udp": udp_ok},
               "kcptun": {"streams": streams, "stream_bytes": stream_bytes,
                          "bytes_echoed": total, "wall_s": wall,
                          "mb_s": total / wall / 1e6,
                          "first_byte": lat_ms([r["first_s"] for r in res])},
               "boot_s": boot_s, "exit_codes": codes}
        log(f"apps: kcptun {streams} x {stream_bytes} B echoed in "
            f"{wall:.2f} s ({out['kcptun']['mb_s']:.2f} MB/s)")
        return out
    finally:
        for k in kids:
            k.kill()
        echo.close()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_websocks(device=torch.device("cpu"), n_tcp=WS_TCP, n_kcp=WS_KCP,
                   nbytes=WS_BYTES, n_http=WS_HTTP_CONNECTS) -> dict:
    """The WebSocks server and agents as an operator runs them, each a
    `python -m vproxy_tpu_torch websocks ...` child: a server taking TCP
    and KCP, an agent on its TCP transport (with an HTTP CONNECT front)
    and one on its KCP transport, both proxying only the echo server's
    port (`rule=:<port>`). Once each agent's health check passes:
    n_tcp + n_kcp concurrent SOCKS5 CONNECTs to the echo server, each
    echoing a seeded `nbytes`, then n_http concurrent HTTP CONNECTs;
    then the server is stopped and a CONNECT to a second echo server
    (not under the rule) still echoes through the agent, directly,
    while one to the proxied port is refused. Every byte equal; every
    child exits 0 on SIGTERM. The TLS front and shadowsocks are not run:
    the app serves neither (they are library classes, run in process by
    tests/test_torch_websocks.py). -> connect -> first byte p50 / p99
    and MB/s per transport."""
    import shutil
    import tempfile
    env = _app_env(device)
    echo, direct = _EchoServer(), _EchoServer()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-websocks-")
    kids = []
    rule = f"rule=:{echo.port}"
    try:
        t0 = time.perf_counter()
        srv = _AppChild("server", ["websocks", "server", "0", WS_USER,
                                   "kcp"], env, tmp)
        kids.append(srv)
        sport = int(srv.expect(r"websocks server on :(\d+) \(tcp\+kcp\)")[1])
        at = _AppChild("agent tcp", ["websocks", "agent", "0",
                                     f"{LOOPBACK}:{sport}", WS_USER, rule,
                                     "connect=0"], env, tmp)
        ak = _AppChild("agent kcp", ["websocks", "agent", "0",
                                     f"{LOOPBACK}:{sport}", WS_USER, rule,
                                     "kcp"], env, tmp)
        kids += [at, ak]
        m = at.expect(r"socks5 on 127\.0\.0\.1:(\d+), http-connect (\d+)")
        tcp_port, http_port = int(m[1]), int(m[2])
        kcp_port = int(ak.expect(r"socks5 on 127\.0\.0\.1:(\d+)")[1])
        boot_s = time.perf_counter() - t0
        ready = {}
        for name, port in (("tcp", tcp_port), ("kcp", kcp_port)):
            await_tunnel(port, echo.port, f"the {name} agent")
            ready[name] = time.perf_counter() - t0
        payloads = _seeded_payloads(n_tcp + n_kcp + n_http, nbytes, WS_SEED)
        socks = [(tcp_port, p) for p in payloads[:n_tcp]] + \
            [(kcp_port, p) for p in payloads[n_tcp:n_tcp + n_kcp]]
        t1 = time.perf_counter()
        with ThreadPoolExecutor(len(socks)) as ex:
            res = list(ex.map(lambda a: _echo_stream(
                a[0], a[1], _socks5_to(echo.port)), socks))
        wall = time.perf_counter() - t1
        bad = sum(not r["ok"] for r in res)
        check(bad == 0, f"websocks: {bad} of {len(socks)} SOCKS5 CONNECTs "
              "did not echo every byte")
        http, _ = _echo_burst(http_port, payloads[n_tcp + n_kcp:],
                              _http_connect_to(echo.port))
        check(all(r["ok"] for r in http), "websocks: an HTTP CONNECT did "
              "not echo every byte")
        codes = {"server": srv.stop()}
        refused = False
        try:
            refused = not _echo_stream(tcp_port, b"x", _socks5_to(echo.port),
                                       timeout=10)["ok"]
        except OSError:
            refused = True
        check(refused, "a proxied CONNECT succeeded with the server down")
        d = _echo_stream(tcp_port, payloads[0], _socks5_to(direct.port))
        check(d["ok"] and direct.accepted == 1, "the direct-rule host did "
              "not echo through the agent with the server down")
        codes.update({k.name: k.stop() for k in (at, ak)})
        check(all(v == 0 for v in codes.values()),
              f"a websocks child did not exit 0 on SIGTERM: {codes}")

        def side(rs):
            # its own wall time: the burst's start to its last echo
            w = max(r["done_s"] for r in rs)
            return {"connects": len(rs), "bytes_echoed": len(rs) * nbytes,
                    "first_byte": lat_ms([r["first_s"] for r in rs]),
                    "wall_s": w, "mb_s": len(rs) * nbytes / w / 1e6}
        by_t = {"tcp": side(res[:n_tcp]), "kcp": side(res[n_tcp:])}
        out = {"socks5": {"wall_s": wall, "mb_s": len(res) * nbytes / wall
                          / 1e6, "first_byte": lat_ms(
                              [r["first_s"] for r in res]), **by_t},
               "http_connect": side(http),
               "direct_rule": {"echoed": True, "server_down_refused": True},
               "bytes_each": nbytes, "boot_s": boot_s, "ready_s": ready,
               "exit_codes": codes,
               "not_run": "the TLS front and shadowsocks: the websocks "
                          "app serves neither (nor does the reference's); "
                          "tests/test_torch_websocks.py runs both in "
                          "process"}
        log(f"websocks: {len(res)} SOCKS5 CONNECTs x {nbytes} B in "
            f"{wall:.2f} s ({out['socks5']['mb_s']:.2f} MB/s), p50/p99 "
            f"{out['socks5']['first_byte'].get('p50_ms', 0):.1f}/"
            f"{out['socks5']['first_byte'].get('p99_ms', 0):.1f} ms")
        return out
    finally:
        for k in kids:
            k.kill()
        echo.close()
        direct.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _uds_post(path: str, route: str, body: dict) -> dict:
    """One libnetwork call over the plugin's unix socket."""
    import socket
    payload = json.dumps(body).encode()
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(30)
    c.connect(path)
    c.sendall(b"POST " + route.encode() + b" HTTP/1.1\r\nhost: plugin\r\n"
              b"content-type: application/json\r\ncontent-length: " +
              str(len(payload)).encode() + b"\r\nconnection: close\r\n\r\n"
              + payload)
    buf = b""
    while True:
        d = c.recv(65536)
        if not d:
            break
        buf += d
    c.close()
    head, _, rest = buf.partition(b"\r\n\r\n")
    check(head.split(b" ", 2)[1:2] == [b"200"], f"{route}: {head!r}")
    return json.loads(rest)


def docker_addrs(pools: list, b: int, seed: int) -> list:
    """b seeded IPv4 addresses: uniform over the pools' hosts, and one
    in nine outside every pool (172.29/16 and 10/8)."""
    from vproxy_tpu_torch.utils.ip import parse_ip
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        k = int(rng.integers(0, len(pools) + 1))
        host = int(rng.integers(1, 255))
        if k == len(pools):
            out.append(parse_ip(f"{int(rng.choice([10, 172]))}."
                                f"{int(rng.integers(29, 255))}."
                                f"{int(rng.integers(0, 256))}.{host}"))
        else:
            out.append(parse_ip(pools[k].rsplit(".", 1)[0] + f".{host}"))
    return out


def phase_docker(device=torch.device("cpu"), networks=DOCKER_NETWORKS,
                 batch=DOCKER_BATCH) -> dict:
    """The docker network plugin, in process: the port's Application
    takes `add docker-network-plugin-controller` on a unix socket in a
    temporary directory; Plugin.Activate and GetCapabilities over it;
    `networks` NetworkDriver.CreateNetwork calls, each a /24 pool of
    172.28.0.0/16 and its gateway (each a VPC of the plugin's switch,
    its route table a CidrMatcher on the switch's backend: "torch" on
    the card); on each VPC one `add route` by command to every other
    pool via its vni; then per VPC one route_lookup_batch of `batch`
    seeded addresses (docker_addrs). The phase sets the engine's small-
    table cut to 0 (what VPROXY_TPU_SMALL_TABLE=0 does) so that each
    batch reaches the matcher: a VPC of 7 routes is under the default
    cut of 128, and route_lookup_batch would scan it on the host. One
    B4 launch per batch on the card (none on the CPU, where the plain
    tier serves), one engine dispatch per batch, every answer the route
    the host CidrIndex finds over the VPC's routes. current_config holds
    the controller's line; replayed into a fresh Application it rebuilds
    every VPC, annotations and routes, and the replayed plugin answers.
    The endpoint calls (a tap device each) are not made: they would
    create a network device on the host; tests/test_torch_docker.py
    runs them on the CPU. -> seconds, batches, launches."""
    import shutil
    import tempfile
    from vproxy_tpu_torch.control import persist
    from vproxy_tpu_torch.control.app import Application
    from vproxy_tpu_torch.control.command import Command
    from vproxy_tpu_torch.control.docker import ANNO_NETWORK_ID, SWITCH_NAME
    from vproxy_tpu_torch.ops import cidr_cuda as CC
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules.index import CidrIndex
    on_card = device.type == "cuda"
    tmp = tempfile.mkdtemp(prefix="chip-smoke-docker-")
    keys = ("VPROXY_TPU_DOCKER_SCRIPTS", "VPROXY_TPU_DOCKER_SWITCH_ADDR")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ["VPROXY_TPU_DOCKER_SCRIPTS"] = os.path.join(tmp, "scripts")
    os.environ["VPROXY_TPU_DOCKER_SWITCH_ADDR"] = f"{LOOPBACK}:0"
    small = E.SMALL_TABLE
    E.SMALL_TABLE = 0
    apps = [Application.create(workers=1)]
    run = Command.execute
    try:
        app = apps[0]
        sock = os.path.join(tmp, "plugin.sock")
        t0 = time.perf_counter()
        check(run(app, "add docker-network-plugin-controller dk0 path "
                       f"{sock}") == "OK", "add docker controller")
        check(_uds_post(sock, "/Plugin.Activate", {}) ==
              {"Implements": ["NetworkDriver"]}, "Plugin.Activate")
        check(_uds_post(sock, "/NetworkDriver.GetCapabilities", {}) ==
              {"Scope": "local", "ConnectivityScope": "local"},
              "GetCapabilities")
        pools = [f"172.28.{i}.0/24" for i in range(networks)]
        ids = [f"chipsmoke{i:02d}" + "0" * 53 for i in range(networks)]
        for nid, pool in zip(ids, pools):
            r = _uds_post(sock, "/NetworkDriver.CreateNetwork", {
                "NetworkID": nid, "IPv4Data": [{
                    "AddressSpace": "", "Pool": pool,
                    "Gateway": pool.replace(".0/24", ".1/24")}],
                "IPv6Data": []})
            check(r == {}, f"CreateNetwork {pool}: {r}")
        create_s = time.perf_counter() - t0
        sw = app.switches[SWITCH_NAME]
        by_id = {n.annotations.get(ANNO_NETWORK_ID): n
                 for n in sw.networks.values()}
        nets = [by_id[nid] for nid in ids]
        t1 = time.perf_counter()
        for i, net in enumerate(nets):
            for k, other in enumerate(nets):
                if k != i:
                    check(run(app, f"add route to{k} to vpc {net.vni} in "
                                   f"switch {SWITCH_NAME} network {pools[k]}"
                                   f" vni {other.vni}") == "OK",
                          f"add route to{k} in vpc {net.vni}")
        routes_s = time.perf_counter() - t1
        n_routes = sum(len(n.routes.rules_v4) for n in nets)
        check(n_routes == networks * (networks - 1), f"{n_routes} routes")
        for net in nets:
            m = net._matcher_v4
            check(m.backend == "torch", f"vpc {net.vni} serves on "
                  f"{m.backend!r}, not the switch's default 'torch'")
            check(on_card == (m.device.type == "cuda"),
                  f"vpc {net.vni}'s matcher is on {m.device}")
        kern = CC.cidr_first_cuda
        b4_0, disp0 = kern.launches, E.dispatch_launches_total()
        answers = misses = 0
        lookup_ms = []
        for i, net in enumerate(nets):
            addrs = docker_addrs(pools, batch, DOCKER_SEED + i)
            t = time.perf_counter()
            got = net.route_lookup_batch(addrs)
            lookup_ms.append((time.perf_counter() - t) * 1e3)
            rules = net.routes.rules_v4
            idx = CidrIndex([r.rule for r in rules])
            for a, g in zip(addrs, got):
                j = idx.lookup(a)
                want = rules[j] if j >= 0 else None
                check(g is want, f"vpc {net.vni}: {a.hex()} -> "
                      f"{g} != the host index's {want}")
                answers += 1
                misses += want is None
        b4 = kern.launches - b4_0
        disp = E.dispatch_launches_total() - disp0
        check(disp == networks, f"{disp} engine dispatches for "
              f"{networks} route batches")
        check(b4 == (networks if on_card else 0),
              f"B4 launches {b4} for {networks} route batches")
        cfg = persist.current_config(app)
        check(f"add docker-network-plugin-controller dk0 path {sock}" in cfg,
              "current_config lacks the controller's line")
        path = os.path.join(tmp, "saved.cfg")
        with open(path, "w") as f:
            f.write(cfg)
        app.close()
        apps.append(Application.create(workers=1))
        app2 = apps[-1]
        persist.load(app2, path)
        sw2 = app2.switches[SWITCH_NAME]
        got_ids = sorted(n.annotations.get(ANNO_NETWORK_ID)
                         for n in sw2.networks.values())
        check(got_ids == sorted(ids), "the replay lost a VPC")
        check(sum(len(n.routes.rules_v4) for n in sw2.networks.values())
              == n_routes, "the replay lost a route")
        check(set(app2.docker_controllers) == {"dk0"} and _uds_post(
            sock, "/Plugin.Activate", {}) == {
                "Implements": ["NetworkDriver"]},
            "the replayed plugin does not answer")
        out = {"networks": networks, "routes": n_routes, "batch": batch,
               "batches": networks, "answers": answers, "misses": misses,
               "engine_dispatches": disp, "launches": {"cidr_first": b4},
               "create_networks_s": create_s, "routes_by_command_s": routes_s,
               "lookup_ms": {"per_batch": lookup_ms,
                             "p50": pct(lookup_ms, 50)},
               "small_table_cut": 0, "replayed_vpcs": len(sw2.networks),
               "endpoint_lifecycle": "not run: a tap device would change "
               "the host's network devices (tests/test_torch_docker.py "
               "runs it on the CPU)"}
        log(f"docker: {networks} networks in {create_s:.2f} s, {n_routes} "
            f"routes by command in {routes_s:.2f} s, {networks} batches "
            f"of {batch}, B4 {b4}")
        return out
    finally:
        E.SMALL_TABLE = small
        for a in apps:
            a.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


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


# Kernels the profiler saw and the launches it was expected to see,
# summed over every device_ms call with `launches` (a row reads its own
# part with profiled_since).
PROFILED = {"seen": 0, "expected": 0}


def profiled_since(mark: dict) -> dict:
    """The kernels the profiler saw, and the launches it was expected to
    see, since `mark` (a copy of PROFILED): a timing row's keys."""
    return {"kernels_seen": PROFILED["seen"] - mark["seen"],
            "kernels_expected": PROFILED["expected"] - mark["expected"]}


def device_ms(fn, iters: int, only: str = "", launches: int = 0,
              exclude: str = "") -> float:
    """Device ms per call: the CUDA kernels' own time over every kernel
    one call launches whose name holds `only` (all when empty) and not
    `exclude` (torch.profiler / CUPTI). 0.0 when the profiler saw no
    such device activity. Without `launches`, the mean per call. With
    `launches` > 0 the profiler must have seen at least 90% of the
    iters x launches such kernels: CUPTI on the H100 host drops its
    records now and then (one in twenty to a hundred, run after run, in
    a process that profiled much before), so a run that saw fewer is
    run again, and the phase fails after five. Of one launch a call the
    time is the median of the launches it saw: a run that lost records
    has read a mean down to half the kernels' time (PERF.md §6), which
    the median is proof against; of more, the mean of those it saw,
    times `launches`."""
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
            if only in ev.key and not (exclude and exclude in ev.key):
                us += getattr(ev, "self_device_time_total",
                              getattr(ev, "self_cuda_time_total", 0.0))
                n += ev.count
        if not launches:
            return us / iters / 1e3
        if iters * launches >= n >= 0.9 * iters * launches:
            PROFILED["seen"] += n
            PROFILED["expected"] += iters * launches
            if launches == 1:
                each = sorted(
                    e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and only in e.name
                    and not (exclude and exclude in e.name))
                if each:
                    return each[len(each) // 2] / 1e3
            return us / n * launches / 1e3  # the mean of those it saw
        log(f"profiler saw {n} of {iters * launches} {only} kernels "
            f"({us / max(n, 1):.3f} us each); timing again")
    raise RuntimeError(f"chip smoke failed: the profiler lost {only} "
                       f"kernels in five runs")


def device_activities(fn, want: str, calls: int = 10) -> list:
    """The names of the device activities (kernels, memsets, copies) of
    `calls` calls of fn profiled together, in start order
    (torch.profiler), holding at least one kernel whose name holds
    `want`: CUPTI drops its records now and then (a profile of one call
    often lost its one kernel record), so a profile without one is run
    again, and the phase fails after five."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        if any(want in e.name for e in evs):
            return [e.name for e in evs]
    raise RuntimeError(f"chip smoke failed: the profiler saw no {want} "
                       f"kernel in five profiles of {calls} calls")


# aten ops (the name between "aten." and the overload) that fill memory
FILL_OPS = frozenset({"fill", "fill_", "zero", "zero_", "zeros",
                      "zeros_like", "new_zeros", "full", "full_like",
                      "new_full"})


def aten_fills(fn) -> list:
    """The aten ops of one call of fn that fill memory (fill, zero,
    full: what torch.zeros and its kin dispatch), by name, in order:
    the dispatcher's own view (a TorchDispatchMode), which no lost
    profiler record can hide."""
    from torch.utils._python_dispatch import TorchDispatchMode
    seen = []

    class Fills(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if str(func).split(".")[1] in FILL_OPS:
                seen.append(str(func))
            return func(*args, **(kwargs or {}))

    with Fills():
        fn()
    return seen


def work(ht, q, mtab=None, slots=None, io=True):
    """(bytes, int ops) this batch needs: every query input read once,
    the output written once, and each table row the batch's data
    touches counted once — slot + key rows of valid probes, bucket
    items of live buckets, meta + byte rows of live candidates, the
    wildcard lists, the Maglev slots and entries (B1; none for B3,
    mtab=None). Ops: byte compares (probe keys, candidate rows) plus ~24
    integer ops per live candidate. io=False: the table's part alone
    (no query or output bytes; b8_work counts those once a batch)."""
    from vproxy_tpu_torch.ops import fused as F
    from vproxy_tpu_torch.ops.hashmatch import _items
    nbytes = 0
    if io:
        nbytes += sum(v.numel() * v.element_size() for v in q.values())
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
        mark = dict(PROFILED)
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
               "bytes": nbytes, "int_ops": ops, **profiled_since(mark)}
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


def cidr_work(ct, a16, fam, port, io=True):
    """(bytes, int ops) one B4 launch needs for this batch: every
    query's address, family and port (when gated) read once and its
    answer written once, the g_* rows once, and each table row the
    batch's data touches counted once — the slot record and key of
    every live probe (a group of the query's family, per salt), the
    bucket entries of matching probes, the meta rows of the rules they
    list. Ops: 16 FNV rounds (xor, multiply) and ~8 more per live
    probe, ~6 per bucket entry. io=False: the table's part alone."""
    from vproxy_tpu_torch.ops.hashmatch import _cidr_slots
    b = a16.shape[0]
    g = ct["g_fam"].shape[0]
    nbytes = cidr_io_bytes(b, port) if io else 0
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


def cidr_io_bytes(b: int, port) -> int:
    """A CIDR batch's query bytes (address, family, port when gated)
    and its int32 answers."""
    return b * (16 + 4 + 4) + (0 if port is None else b * 4)


def _cu_ints(source: str, *names: str) -> list:
    """The values of `constexpr int NAME = n;` in a kernel source (a
    path in the repo, or an absolute one)."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           source)) as f:
        src = f.read()
    return [int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in names]


def _ceil(x, d):
    return (x + d - 1) // d


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
    probes, entries = _cu_ints(FC.CIDR_HEADER, "PROBES", "ENTRIES")
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


def time_row(b, kern, plain, name, flush, work_, launches=1, iters=200,
             cold_iters=50, plain_iters=10):
    """One timing row: device ms per call of `kern` (the `launches`
    kernels of it whose name holds `name`) L2-warm and after a 256 MB
    write (cold), its plain tier's, wall ms per call back to back, and
    the bound from work_ = (bytes, ops). `iters`, `cold_iters` and
    `plain_iters` are the calls each timing averages over."""
    check(same(kern(), plain()), f"{name} != plain at B={b}")
    mark = dict(PROFILED)
    p1 = device_ms(plain, plain_iters)
    k1 = device_ms(kern, iters, name, launches)
    k2 = device_ms(kern, iters, name, launches)
    p2 = device_ms(plain, plain_iters)
    c1 = device_ms(lambda: (flush.zero_(), kern()), cold_iters, name,
                   launches)
    check(min(p1, p2, k1, k2, c1) > 0, "profiler saw no device time")
    kc = min(call_ms(kern, iters), call_ms(kern, iters))
    pc = call_ms(plain, plain_iters, reps=3)
    nbytes, ops = work_
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = ops / INT_OPS_PER_S * 1e3
    return {"batch": b, "ms": min(k1, k2), "ms_runs": [k1, k2],
            "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
            "cold_ms": c1, "call_ms": kc, "plain_call_ms": pc,
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "bytes": nbytes, "int_ops": ops, **profiled_since(mark)}


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


def maglev_column(b: int, device, seed: int, pad: int = 0) -> tuple:
    """A Maglev column for a kernel's check: the MAGLEV_M-slot table of
    BACKENDS backends on `device` and b int64 flow slots
    (maglev.flow_slots of seeded flows, every third without a port:
    source affinity, the rest with), one in sixteen past each end of
    the table (the clamp), the last `pad` rows slot 0 as the engine
    pads them. -> (mtab int32 [M], slots int64 [b])."""
    from vproxy_tpu_torch.rules import maglev as M
    key = (str(device), MAGLEV_M)
    if key not in _MAGLEV:
        _MAGLEV[key] = torch.from_numpy(M.build_table(
            backends(), MAGLEV_M)).to(device)
    mtab = _MAGLEV[key]
    real = b - pad
    slots = M.flow_slots(MAGLEV_M, mk_ips(real, seed=seed), [
        None if i % 3 == 0 else 1024 + i for i in range(real)])
    rng = np.random.default_rng(seed)
    k = max(1, real // 16)
    at = rng.choice(real, size=min(real, 2 * k), replace=False)
    slots[at[:k]] = -rng.integers(1, 1 << 40, size=at[:k].size)
    slots[at[k:]] = MAGLEV_M + rng.integers(0, 1 << 40, size=at[k:].size)
    slots = np.concatenate([slots, np.zeros(pad, np.int64)])
    return mtab, torch.from_numpy(slots).to(device)


_MAGLEV: dict = {}  # maglev_column's tables, one a device


def pick_vs_plain(what: str, got, ref, verdict, mcol) -> int:
    """A folded kernel's (verdict, pick) rows against its plain version
    (int32-exact), its verdict column against the verdict-only launch's
    answers, and its pick column against the host table clipped (the
    one slot-hash contract's take). -> max |kernel - plain|."""
    mtab, slots = mcol
    check(got.dtype == ref.dtype == torch.int32 and got.shape == ref.shape
          == (slots.shape[0], 2), f"{what}: (verdict, pick) dtype or shape "
          f"{got.dtype} {tuple(got.shape)}")
    d = int((got.long() - ref.long()).abs().max())
    clip = mtab.cpu().numpy()[np.clip(slots.cpu().numpy(), 0,
                                      mtab.shape[0] - 1)]
    check(torch.equal(got, ref) and torch.equal(got[:, 0], verdict.to(
        torch.int32)) and np.array_equal(got[:, 1].cpu().numpy(), clip),
          f"{what}: the Maglev column's rows != plain, the verdict-only "
          f"launch or the host table (max_abs_err {d})")
    return d


def b6_vs_plain(name, t, q, device, mcol=None) -> int:
    """B6 against fphash.hint_fp_match on the same tensors, int32-equal
    in index and level (on CPU tensors the plain tier against itself);
    with `mcol` (maglev_column) also B6 with its Maglev column against
    its plain version (hint_fp_pick_plain). -> max |kernel - plain|."""
    from vproxy_tpu_torch.ops import fphash as FP
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    ri, rl = FP.hint_fp_match(t, q)
    gi, gl = FPC.hint_fp_cuda(t, q) if device.type == "cuda" else (ri, rl)
    _sync(device)
    d = max(int((gi.long() - ri.long()).abs().max()),
            int((gl.long() - rl.long()).abs().max()))
    if mcol is not None:
        ref = FPC.hint_fp_pick_plain(t, q, *mcol)
        got = FPC.hint_fp_cuda(t, q, mtab=mcol[0], slots=mcol[1]) \
            if device.type == "cuda" else ref
        _sync(device)
        d = max(d, pick_vs_plain(f"B6 pick [{name}]", got, ref, ri, mcol))
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


def _fp_probe_hits(t, q) -> list:
    """Per probe side of a B6 batch, host then uri: (E, M, the live
    probes [B, X], their slots clamped to the table [B, X], which of the
    slot row's E entries match the probe's fingerprints [B, X, E])."""
    out = []
    for pre, live, em in (("hp", q["hp_level"] > 0, t["h_em"]),
                          ("up", q["up_score"] > 0, t["u_em"])):
        e, m = em.shape
        s = q[f"{pre}_slot"].clamp(0, t["rec"].shape[0] - 1).long()
        ents = t["rec"][s][..., : e * (2 + 4 * m)].reshape(
            *s.shape, e, 2 + 4 * m)
        ok = (ents[..., 0] == q[f"{pre}_fp1"][..., None]) & \
            (ents[..., 1] == q[f"{pre}_fp2"][..., None]) & live[..., None]
        out.append((e, m, live, s, ok))
    return out


def fp_hint_design(t, q) -> dict:
    """What B6's design depends on, for one batch, from the table and
    the batch with torch ops on their device (csrc/fp_hint.cu: a probe
    takes 2^s (probe, entry) slots, 2^s >= max(hE, uE), a lane PAIRS
    slots per round, a warp lists 32 x MEMBERS members per window, the
    wildcard members in round 0): the (probe, entry) pairs and slots and
    the lane rounds, the most members and list windows of one query, its
    longest chain of dependent global-load steps as the header counts
    them (the staged query, then per round the pairs and each window of
    members), and the live probes matched on the last entry of their
    row."""
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    pairs_, members_ = _cu_ints(FPC.HEADER_HINT, "PAIRS", "MEMBERS")
    per_round, per_window = 32 * pairs_, 32 * members_
    b, p = q["hp_slot"].shape
    (he, hm), (ue, um) = t["h_em"].shape, t["u_em"].shape
    u = q["up_slot"].shape[1]
    ep = 1 << (max(he, ue) - 1).bit_length()  # entry slots per probe
    rounds = max(1, _ceil((p + u) * ep, per_round))
    mem = torch.zeros(b, rounds, dtype=torch.int64, device=q["hp_slot"].device)
    mem[:, 0] = t["wh_rec"].shape[0] + t["wu_rec"].shape[0]
    last = 0
    for p0, (e, m, _, _, ok) in zip((0, p), _fp_probe_hits(t, q)):
        dev = ok.device
        x = (p0 + torch.arange(ok.shape[1], device=dev))[:, None] * ep + \
            torch.arange(e, device=dev)[None]
        mem.scatter_add_(1, (x.reshape(-1) // per_round)[None].expand(b, -1),
                         ok.reshape(b, -1).long() * m)
        last += int(ok[..., e - 1].sum()) if e > 1 else 0
    windows = _ceil(mem, per_window)
    return {"pairs": p * he + u * ue, "slots": (p + u) * ep,
            "rounds": rounds,
            "max_members": int(mem.sum(dim=1).max()),
            "max_windows": int(windows.sum(dim=1).max()),
            "max_chain": int((1 + rounds + windows.sum(dim=1)).max()),
            "last_entry_matches": last}


def _fp_group_hits(t, a16, fam) -> tuple:
    """For a B7 batch: the queries that walk the trie [B], the (query,
    group) pairs B7 probes (the query's family, off the trie) [B, G],
    their slots clamped to the table [B, G], the slot rows' entries [B,
    G, E, 3] and which of them match the pair's fingerprints [B, G,
    E]."""
    from vproxy_tpu_torch.ops import fphash as FP
    b, e = a16.shape[0], t["e_m"].shape[0]
    trie = (fam == 0) & ("t_l0" in t)
    gok = (t["g_fam"][None] >= 0) & (t["g_fam"][None] == fam[:, None]) & \
        ~trie[:, None]
    masked = FP._pack_words16_dev(a16)[:, None, :] & \
        t["g_mask4"].to(torch.int64)[None]
    slot = (t["g_off"].long()[None] + (
        FP._fnv32_words_dev(masked, t["g_salt_s"]) &
        t["g_capmask"].long()[None])).clamp(0, t["rec"].shape[0] - 1)
    ents = t["rec"][slot].reshape(b, -1, e, 3)
    f1, f2 = (FP._u32_as_i32(FP._fnv32_words_dev(masked, t[k]))
              for k in ("g_salt_f1", "g_salt_f2"))
    ok = (ents[..., 0] == f1[..., None]) & (ents[..., 1] == f2[..., None]) \
        & gok[..., None]
    return trie, gok, slot, ents, ok


def fp_cidr_design(t, a16, fam) -> dict:
    """What B7's design depends on, for one batch (csrc/fp_cidr.cu: a
    lane takes GROUPS live groups per round and ENTRIES entries of a
    row per load, a warp deals 32 x PAIRS member pairs per window): over
    the batch's queries, the most live groups and lane rounds, member
    rows, member pairs and list windows of one query (ACL), its longest
    chain of dependent global-load steps as the header counts them, and
    the (query, group) matches on the last entry of a slot row."""
    from vproxy_tpu_torch.ops import fphash as FP
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    groups_, entries_, pairs_ = _cu_ints(FPC.HEADER_CIDR, "GROUPS", "ENTRIES",
                                         "PAIRS")
    e = t["e_m"].shape[0]
    acl, has_trie = "mrows" in t, "t_l0" in t
    trie, gok, _, ents, ok = _fp_group_hits(t, a16, fam)
    ng = gok.long().sum(dim=1)
    rounds = _ceil(ng, 32 * groups_)
    last = int(ok[..., e - 1].sum()) if e > 1 else 0
    steps = torch.where(trie, 1, 1 + rounds * _ceil(e, entries_))
    if has_trie:  # the walk: t_l0, then t_l1 / t_l2 when the cell says
        a = a16.long()
        v = t["t_l0"][a[:, 12] * 256 + a[:, 13]].long()
        levels = 1 + (v < 0).long()
        i1 = ((-v - 1).clamp(min=0) * 256 + a[:, 14]).clamp(
            max=t["t_l1"].shape[0] - 1)
        v = torch.where(v < 0, t["t_l1"][i1].long(), v)
        levels += (v < 0).long()
        steps = torch.where(trie, steps + levels, steps)
    rows = torch.zeros_like(ng)
    if acl:
        nm, mk = t["mrows"].shape[0], t["mrows"].shape[1] // 2
        mrow = torch.where(ok, ents[..., 2], 0).amax(dim=2).clamp(0, nm - 1)
        rows = (mrow != 0).long().sum(dim=1)
        if has_trie:
            cell = FP._trie4_lookup(t, a16).clamp(0, nm - 1)
            rows = torch.where(trie, (cell != 0).long(), rows)
        windows = _ceil(rows * mk, 32 * pairs_)
    else:
        mk, windows = 0, torch.zeros_like(ng)
    steps = torch.where(fam >= 0, steps + windows, 1)
    return {"max_groups": int(ng.max()), "max_rounds": int(rounds.max()),
            "max_rows": int(rows.max()), "max_pairs": int(rows.max()) * mk,
            "max_windows": int(windows.max()),
            "max_chain": int(steps.max()), "last_entry_matches": last}


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
    tables): the cuckoo kernels' CPU sets and the fingerprint ones (past
    one round of (probe, entry) pairs, a last-entry match on both sides,
    128 wildcard members)."""
    rules = rand_rules(300, 11)
    yield "random_300_b600", rules, rand_hints(rules, 600, 11)
    for name, gen in (("shared_keys", shared_keys),
                      ("long_hosts", long_hosts),
                      ("wide_buckets", wide_buckets),
                      ("member_overflow", fp_member_overflow),
                      ("uri_untrimmed", fp_uri_untrimmed),
                      ("probe_rounds", fp_probe_rounds),
                      ("last_entry", fp_last_entry),
                      ("wildcards", fp_wildcards)):
        yield (name, *gen())
    for name in BOUNDARY_CASES:
        rules, hints, _ = boundary(name)
        yield name, rules, hints


def fp_cidr_cases():
    """-> (name, nets, acl or None, [(addr, port or None)], caps) of each
    B7 parity set besides config #4's tables: the CPU sets of the CIDR
    kernel (a trie ACL among them), routes without the trie, the
    fingerprint sets (a wide route first, an ACL trie of overlaps, an
    ACL past 128 stacked rules, v6 only, 129 v6 groups in three lane
    rounds, a last-entry match, a V4 ACL without the trie whose queries
    match several member rows, past one list window)."""
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
    for name, gen in (("v6_all_masks", fp_v6_all_masks),
                      ("last_entry_routes", fp_last_entry_routes)):
        nets, addrs = gen()
        yield name, nets, None, [(a, None) for a in addrs], None
    acl, q = acl_deep_buckets()
    yield ("acl_deep_buckets no_trie", [r.network for r in acl], acl, q,
           {"no_trie": 1})


def phase_fp_kernels(device, tabs, batches=TIME_BATCHES, n_host=N_RULES):
    """B6 and B7 int32-exact against their plain versions: B6 on the
    published 100k table (uri rules) and a 100k host-only table at every
    B of `batches`, an eighth of each batch pad rows, with and without
    its Maglev column (maglev_column: slots past both ends), and on
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
    design = {"b6": {}, "b7": {}}
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
            b6 = max(b6, b6_vs_plain(
                f"{name} B={b}, {b // 8} pad rows", t, q, device,
                maglev_column(b, device, 960 + b, b // 8)))
            design["b6"][f"{name} B={b}"] = fp_hint_design(t, q)
    for name, rules, hints in fp_hint_cases():
        tab = FP.compile_hint_fp(rules)
        q = fp_hint_batch(tab, hints, len(hints) + 8, device)
        um_seen.add("um_fp1" in q)
        t = fp_prepared(tab.arrays, device, True)
        b6 = max(b6, b6_vs_plain(name, t, q, device))
        design["b6"][name] = fp_hint_design(t, q)
        b6 = max(b6, b6_vs_plain(f"{name} rec cut", fp_prepared(
            fp_table_variant(tab.arrays, "rec"), device, True), q, device))
        for how in FP_QUERY_CUTS.get(name, ()):
            b6 = max(b6, b6_vs_plain(f"{name} {how} cut", t,
                                     cut_fp_query(q, how), device))
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
        ab = cidr_batch(acl_queries(tabs["acl"], real, 700 + b), b, device)
        for name, t, batch in (
                (f"routes 50k B={b}", rt, cidr_batch(rq, b, device)),
                (f"ACL 5k B={b}", at, ab)):
            b7 = max(b7, b7_vs_plain(name, t, *batch, device))
            design["b7"][name] = fp_cidr_design(t, *batch[:2])
        b7 = max(b7, b7_vs_plain(f"ACL 5k B={b} port=None", at, *ab[:2],
                                 None, device))
    kinds = set()
    for name, nets, acl, q, caps in fp_cidr_cases():
        arrays = FP.compile_cidr_fp(nets, acl=acl, caps=caps).arrays
        t = fp_prepared(arrays, device, False)
        kinds.add(("t_l0" in t, "mrows" in t))
        batch = cidr_batch(q, len(q) + 8, device)
        b7 = max(b7, b7_vs_plain(name, t, *batch, device))
        design["b7"][name] = fp_cidr_design(t, *batch[:2])
        for how in FP_VARIANTS.get(name, ()):
            b7 = max(b7, b7_vs_plain(f"{name} {how}", fp_prepared(
                fp_table_variant(arrays, how), device, False), *batch,
                device))
    check(len(kinds) == 4, f"B7 cases covered layouts {sorted(kinds)} (trie"
          f" / groups x routes / ACL)")
    log(json.dumps({"fp_design": design}))
    for k, rounds in (("b6", "rounds"), ("b7", "max_rounds")):
        d = design[k].values()
        check(max(x[rounds] for x in d) > 1 and
              max(x["max_windows"] for x in d) > 1 and
              sum(x["last_entry_matches"] for x in d) > 0,
              f"{k.upper()}'s cases take no second lane round, no second "
              f"list window or no last-entry match (fp_design)")
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
    return {"b6": b6, "b7": b7, "all": err_all, "layouts": layouts,
            "design": design}


def phase_fp_service(device, tabs, bursts=BURSTS, burst=SERVICE_BATCH,
                     cidr_oracle=None):
    """The fingerprint backend's main path through ClassifyService in
    "device" mode: bursts x burst submit_hint on the torch-fp
    HintMatcher, as many submit_classify_pick on the FusedPair over it
    (B6 with its Maglev column: one launch a batch), SecurityGroup
    allow_async on config #4's ACL and submit_cidr on the 50k routes.
    Every answer equal to the host index (CidrIndex and the linear
    oracle_snap for CIDR, in worker processes); one B6 launch per hint
    or cpick batch (the cpick ones with the Maglev column), no Maglev
    take (B5) and no `_device_take` call, one B7 launch per cidr batch,
    B1 / B3 / B4 never, no failover. The CIDR
    queries and their linear-oracle answers are
    phase 7's (`cidr_oracle`, from phase_cidr_service, over the same rule
    lists; the scan of 50k routes takes minutes of CPU); without it the
    oracle runs here (small tables). -> the phase's numbers."""
    from vproxy_tpu_torch.ops import cidr_cuda as CC
    from vproxy_tpu_torch.ops import fphash as FP
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    from vproxy_tpu_torch.ops import fused_cuda as FC
    from vproxy_tpu_torch.ops import take_cuda as TC
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
        FPC.hint_fp_cuda.pick_launches = 0
        FP.hint_fp_match.cuda_calls = M._device_take.calls = 0
        TC.maglev_take_cuda.launches = 0
        lat = []
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
                    pair, h, ip, port, cb), list(zip(hints, ips, ports)),
                lat)
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
                    "hint_fp_pick": FPC.hint_fp_cuda.pick_launches,
                    "cidr_fp": FPC.cidr_fp_cuda.launches}
        takes = M._device_take.calls
        b5 = TC.maglev_take_cuda.launches
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
        check(launches["hint_fp_pick"] == (batches["cpick"] if on_card
                                           else 0),
              f"B6 launches with the Maglev column "
              f"{launches['hint_fp_pick']} != cpick batches {batches}")
        check(takes == 0 and b5 == 0, f"a cpick batch took the Maglev "
              f"take: {takes} _device_take calls, {b5} B5 launches")
        check(launches["cidr_fp"] == (batches["cidr"] if on_card else 0)
              and batches["cidr"] > 0,
              f"B7 launches {launches['cidr_fp']} != cidr batches "
              f"{batches}")
        check(E.fused_dispatches_total() == f0,
              "an fp cpick batch took the fused dispatch")
        check(E.dispatch_launches_total() - l0 == batches["hint"] +
              batches["cpick"] + batches["cidr"],
              "engine launches != hint + cpick + cidr batches")
        check([f.launches for f in others] == other0,
              "the fp path launched B1, B3 or B4")
        check(FP.hint_fp_match.cuda_calls == 0,
              "B6's plain tier ran on CUDA tensors")
        out = {"queries": 4 * n, "batches": batches,
               "launches": launches, "maglev_takes": takes,
               "maglev_take_launches": b5, "failovers": st.failovers,
               "max_batch": st.max_batch, "hint_wall_s": hint_s,
               "cpick_wall_s": cpick_s, "cidr_wall_s": cidr_s,
               "cpick_latency": lat_ms(lat),
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


def fp_hint_work(t, q, io=True):
    """(bytes, int ops) one B6 launch needs for this batch: every query
    array read once and two int32 written per query, the wildcard lists
    once, and per distinct live probe row its E fingerprint pairs, per
    distinct matched entry its M member records. Ops: 2 per entry
    compare, ~30 per member scored (the wildcard members every query).
    io=False: the table's part alone."""
    b = q["hp_slot"].shape[0]
    nbytes = 0
    if io:
        nbytes += sum(v.numel() * v.element_size() for v in q.values())
        nbytes += b * 8
    nbytes += (t["wh_rec"].numel() + t["wu_rec"].numel()) * 4
    ops = b * (t["wh_rec"].shape[0] + t["wu_rec"].shape[0]) * 30
    for e, m, live, s, ok in _fp_probe_hits(t, q):
        s, ok = s[live], ok[live]
        nbytes += torch.unique(s).numel() * e * 8
        hit = ok.any(dim=1)
        entry = s[hit] * e + ok.int().argmax(dim=1)[hit]
        nbytes += torch.unique(entry).numel() * m * 16
        ops += s.numel() * 2 * e + int(hit.sum()) * m * 30
    return nbytes, ops


def fp_cidr_work(t, a16, fam, port, io=True):
    """(bytes, int ops) one B7 launch needs for this batch: every
    query's address, family (and port, for an ACL) read once and its
    answer written once, the group arrays once; per V4 query of a trie
    table the distinct cells it walks (and, for an ACL, its member row);
    per (query, group of its family) the distinct slot rows of E x 12
    bytes and, for an ACL, the matched entries' member rows. Ops: ~50
    per group probe (3 hashes of 4 FNV rounds + fmix32, the mask and the
    entry compares), ~6 per trie level, ~4 per member. io=False: the
    table's part alone."""
    from vproxy_tpu_torch.ops import fphash as FP
    b, g = a16.shape[0], t["g_fam"].shape[0]
    acl = "mrows" in t
    mk2 = t["mrows"].shape[1] if acl else 0
    nbytes = 0 if not io else cidr_io_bytes(b, port if acl else None)
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
    _, gok, slot, ents, ok = _fp_group_hits(t, a16, fam)
    nbytes += torch.unique(slot[gok]).numel() * t["e_m"].shape[0] * 12
    ops += int(gok.sum()) * 50
    if acl:
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
    all-L2 time. Each B6 / B7 row carries its batch's design
    (fp_hint_design / fp_cidr_design); b5_row times the Maglev take
    beside them, and B6 with its Maglev column beside B6 (maglev_column;
    its bound adds pick_bytes). -> {"B6": rows, "B6 pick": rows, "B7
    routes": rows, "B7 ACL": rows, "classify_fp_all": rows, "B5":
    rows}."""
    from vproxy_tpu_torch.ops import fphash as FP
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    hsnap = tabs["hm"].snapshot()
    rt, at = tabs["routes"].snapshot()[0], tabs["am"].snapshot()[0]
    saved = (FPC.hint_fp_cuda.launches, FPC.cidr_fp_cuda.launches)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    out = {"B6": [], "B6 pick": [], "B7 routes": [], "B7 ACL": [],
           "classify_fp_all": [], "B5": []}
    for b in TIME_BATCHES:
        q = fp_hint_batch(hsnap[0], mk_queries(tabs["rules"], b, 2600 + b),
                          b, device)
        row = time_row(b, lambda: FPC.hint_fp_cuda(hsnap[1], q),
                       lambda: FP.hint_fp_match(hsnap[1], q), KERNEL_B6,
                       flush, fp_hint_work(hsnap[1], q))
        row["design"] = fp_hint_design(hsnap[1], q)
        out["B6"].append(row)
        log("times B6 " + json.dumps(row))
        mcol = maglev_column(b, device, 2650 + b)
        w = fp_hint_work(hsnap[1], q)
        row = time_row(b, lambda: FPC.hint_fp_cuda(hsnap[1], q, mtab=mcol[0],
                                                   slots=mcol[1]),
                       lambda: FPC.hint_fp_pick_plain(hsnap[1], q, *mcol),
                       KERNEL_B6, flush,
                       (w[0] + pick_bytes(b, mcol[1]), w[1]))
        out["B6 pick"].append(row)
        log("times B6 pick " + json.dumps(row))
        for label, t, queries in (
                ("B7 routes", rt, [(a, None) for a, _ in cidr_queries(
                    tabs["nets"], b, 2700 + b)]),
                ("B7 ACL", at, acl_queries(tabs["acl"], b, 2800 + b))):
            a16, fam, port = cidr_batch(queries, b, device)
            row = time_row(b, lambda: FPC.cidr_fp_cuda(t, a16, fam, port),
                           lambda: FP.cidr_fp_match(t, a16, fam, port),
                           KERNEL_B7, flush, fp_cidr_work(t, a16, fam, port))
            row["design"] = fp_cidr_design(t, a16, fam)
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
        row = b5_row(b, tabs["pair"].mm, flush)
        out["B5"].append(row)
        log("times B5 " + json.dumps(row))
    FPC.hint_fp_cuda.launches, FPC.cidr_fp_cuda.launches = saved
    del flush
    return out


def b5_row(b, mm, flush) -> dict:
    """The Maglev take (B5, csrc/maglev_take.cu) that every unfused cpick
    batch runs (on "torch-fp" and "torch-dense"): for b flows, the
    kernel's device time alone (the slots already on the card) L2-warm
    and after a 256 MB write (cold); the device time of the kernel with
    its slots' host-to-device copy (rules/maglev.py _device_take, what a
    batch pays: the copy timed apart from the kernel); torch indexing
    on the same device slots (mtab[slots.clamp(0, M - 1)], the plain
    version and the library yardstick, one PyTorch indexing call with
    its clamp); wall ms per call back to back; and the bound: b slots
    read, b column entries gathered, b picks written (16 bytes a flow)
    over the HBM rate."""
    from vproxy_tpu_torch.ops import take_cuda as TC
    from vproxy_tpu_torch.rules import maglev as M
    tab, dev = mm.snapshot()[:2]
    ips = mk_ips(b, seed=3000 + b)
    slots = M.flow_slots(len(tab), ips, [1024 + i for i in range(b)])
    s = torch.from_numpy(slots).to(dev.device)
    saved = (M._device_take.calls, TC.maglev_take_cuda.launches)
    kern = lambda: TC.maglev_take_cuda(dev, s)  # noqa: E731
    plain = lambda: TC.take_plain(dev, s)  # noqa: E731
    with_copy = lambda: M._device_take(dev, slots)  # noqa: E731
    check(same(kern(), plain()) and np.array_equal(
        with_copy().cpu().numpy(), tab[np.clip(slots, 0, len(tab) - 1)]),
        f"B5 take != the host table at B={b}")
    mark = dict(PROFILED)
    w1 = device_ms(kern, 200, KERNEL_B5, 1)
    w2 = device_ms(kern, 200, KERNEL_B5, 1)
    c1 = device_ms(lambda: (flush.zero_(), kern()), 50, KERNEL_B5, 1)
    cp = min(device_ms(with_copy, 200), device_ms(with_copy, 200))
    p1 = min(device_ms(plain, 200), device_ms(plain, 200))
    check(min(w1, w2, c1, cp, p1) > 0, "profiler saw no B5 device time")
    row = {"batch": b, "ms": min(w1, w2), "ms_runs": [w1, w2],
           "cold_ms": c1, "with_copy_ms": cp, "copy_ms": cp - min(w1, w2),
           "plain_ms": p1, "library_ms": p1, "call_ms": call_ms(kern, 200),
           "with_copy_call_ms": call_ms(with_copy, 200),
           "bound_ms": b * 16 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           **profiled_since(mark)}
    # timing calls are no main-path takes
    M._device_take.calls, TC.maglev_take_cuda.launches = saved
    return row


def _parent_csrc(parent_dir: str) -> str:
    return os.path.join(parent_dir, "vproxy_tpu_torch", "csrc")


def phase_fp_ab(device, tabs, parent_dir: str) -> list:
    """B6 and B7 of this checkout against the parent commit's (its
    fphash_cuda.py, fp_hint.cu and fp_cidr.cu in parent_dir, with their
    own argument structs) on the same tables and batches as
    phase_fp_times, in turns (parent, change, change, parent), warm and
    cold (256 MB written before each launch), at every TIME_BATCHES;
    both held int32-equal to the plain tier first. -> rows."""
    from vproxy_tpu_torch.ops import fphash as FP
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    P = parent_module(parent_dir, "fphash_cuda")
    hsnap = tabs["hm"].snapshot()
    rt, at = tabs["routes"].snapshot()[0], tabs["am"].snapshot()[0]
    old_t = {"hint": P.prepare_hint_table(dict(hsnap[1])),
             "routes": P.prepare_cidr_table(dict(rt)),
             "acl": P.prepare_cidr_table(dict(at))}
    saved = (FPC.hint_fp_cuda.launches, FPC.cidr_fp_cuda.launches)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    rows = []
    for b in TIME_BATCHES:
        q = fp_hint_batch(hsnap[0], mk_queries(tabs["rules"], b, 2600 + b),
                          b, device)
        rq = cidr_batch([(a, None) for a, _ in cidr_queries(
            tabs["nets"], b, 2700 + b)], b, device)
        aq = cidr_batch(acl_queries(tabs["acl"], b, 2800 + b), b, device)
        cases = (
            ("B6", KERNEL_B6, 1,
             lambda: FPC.hint_fp_cuda(hsnap[1], q),
             lambda: P.hint_fp_cuda(old_t["hint"], q),
             lambda: FP.hint_fp_match(hsnap[1], q)),
            ("B7 routes", KERNEL_B7, 1,
             lambda: FPC.cidr_fp_cuda(rt, *rq),
             lambda: P.cidr_fp_cuda(old_t["routes"], *rq),
             lambda: FP.cidr_fp_match(rt, *rq)),
            ("B7 ACL", KERNEL_B7, 1,
             lambda: FPC.cidr_fp_cuda(at, *aq),
             lambda: P.cidr_fp_cuda(old_t["acl"], *aq),
             lambda: FP.cidr_fp_match(at, *aq)),
            ("classify_fp_all", "fp_", 3,
             lambda: FPC.classify_fp_all(hsnap[1], rt, at, q, *aq),
             lambda: P.classify_fp_all(old_t["hint"], old_t["routes"],
                                       old_t["acl"], q, *aq),
             lambda: FP.classify_fp_all(hsnap[1], rt, at, q, *aq)))
        for label, name, n, kern, old, plain in cases:
            ref = plain()
            check(same(kern(), ref) and same(old(), ref),
                  f"{label} (this checkout or the parent) != plain at B={b}")
            mark = dict(PROFILED)
            warm = [device_ms(f, 200, name, n) for f in (old, kern, kern,
                                                         old)]
            cold = [device_ms(lambda f=f: (flush.zero_(), f()), 50, name, n)
                    for f in (old, kern, kern, old)]
            row = {"batch": b, "kernel": label,
                   "parent_ms": [warm[0], warm[3]], "ms": warm[1:3],
                   "parent_cold_ms": [cold[0], cold[3]],
                   "cold_ms": cold[1:3],
                   "warm_speedup": min(warm[0], warm[3]) / min(warm[1:3]),
                   "cold_speedup": min(cold[0], cold[3]) / min(cold[1:3]),
                   **profiled_since(mark)}
            rows.append(row)
            log("ab " + json.dumps(row))
    FPC.hint_fp_cuda.launches, FPC.cidr_fp_cuda.launches = saved
    del flush
    return rows


def _parent_load(parent_dir: str, name: str):
    """The parent checkout's vproxy_tpu_torch/ops/<name>.py executed as
    vproxy_tpu_torch.ops._parent_<name>, every kernel source and header
    path of it (SOURCE*, HEADER*, HEADERS) pointed at the parent's csrc;
    nothing built."""
    import importlib.util
    csrc = _parent_csrc(parent_dir)
    spec = importlib.util.spec_from_file_location(
        f"vproxy_tpu_torch.ops._parent_{name}",
        os.path.join(parent_dir, "vproxy_tpu_torch", "ops", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in list(vars(mod).items()):
        if k.startswith(("SOURCE", "HEADER")) and isinstance(v, str):
            setattr(mod, k, os.path.join(csrc, os.path.basename(v)))
    if hasattr(mod, "HEADERS"):
        mod.HEADERS = tuple(os.path.join(csrc, os.path.basename(h))
                            for h in mod.HEADERS)
    return mod


def parent_module(parent_dir: str, name: str, deps=()):
    """The parent checkout's vproxy_tpu_torch/ops/<name>.py loaded beside
    this checkout's (_parent_load), then built: its relative imports
    take this checkout's other modules but `deps`, which take the
    parent's own copies while it loads (a module whose ctypes mirrors
    embed another's argument struct must embed the parent's); its
    launch counters are its own."""
    import sys
    pkg = sys.modules["vproxy_tpu_torch.ops"]
    own = {d: sys.modules[f"vproxy_tpu_torch.ops.{d}"] for d in deps}
    try:
        for d in deps:
            m = _parent_load(parent_dir, d)
            sys.modules[f"vproxy_tpu_torch.ops.{d}"] = m
            setattr(pkg, d, m)
        mod = _parent_load(parent_dir, name)
    finally:
        for d, m in own.items():
            sys.modules[f"vproxy_tpu_torch.ops.{d}"] = m
            setattr(pkg, d, m)
    for build in ("build", "build_hint", "build_cidr"):
        if hasattr(mod, build):
            path = getattr(mod, build)()
            for name_, inst in _ptxas(path).items():
                log(f"  ptxas: parent {name_}: {inst}")
    return mod


def ab_row(label: str, b: int, kern, old, plain, name: str, flush,
           iters: int, cold_iters: int) -> dict:
    """This checkout's `kern` against the parent's `old`: both held
    int32-equal to `plain` first, then device time per launch (the
    kernels whose name holds `name`) in turns, parent / change / change
    / parent, warm and after a 256 MB write (cold)."""
    ref = plain()
    check(same(kern(), ref) and same(old(), ref),
          f"{label} (this checkout or the parent) != plain at B={b}")
    mark = dict(PROFILED)
    warm = [device_ms(f, iters, name, 1)
            for f in (old, kern, kern, old)]
    cold = [device_ms(lambda f=f: (flush.zero_(), f()), cold_iters, name,
                      1) for f in (old, kern, kern, old)]
    row = {"batch": b, "kernel": label,
           "parent_ms": [warm[0], warm[3]], "ms": warm[1:3],
           "parent_cold_ms": [cold[0], cold[3]], "cold_ms": cold[1:3],
           "warm_speedup": min(warm[0], warm[3]) / min(warm[1:3]),
           "cold_speedup": min(cold[0], cold[3]) / min(cold[1:3]),
           **profiled_since(mark)}
    log("ab " + json.dumps(row))
    return row


def phase_dense_ab(device, parent_dir: str) -> list:
    """B9 of this checkout against the parent's (its dense_cuda.py and
    dense_match.cu) on the tables and batches of phase_dense_times:
    configuration (a)'s 100k hint table, (b)'s routes and ACL, both
    layouts packed from the same compiled arrays. -> rows."""
    from vproxy_tpu_torch.ops import dense_cuda as DC
    from vproxy_tpu_torch.ops import matchers as MT
    from vproxy_tpu_torch.ops import tables as T
    from vproxy_tpu_torch.rules.ir import Proto
    from vproxy_tpu_torch.utils.torchenv import tables_from_reference
    P = parent_module(parent_dir, "dense_cuda")
    saved = (DC.hint_dense_cuda.launches, DC.cidr_dense_cuda.launches)
    rules, nets = mk_rules(N_RULES), route_nets(N_ROUTES, ROUTE_SEED)
    acl = acl_rules(N_ACL, ACL_SEED)
    tabs = {}
    for key, hint, arrays in (
            ("hint", True, MT.table_arrays(T.compile_hint_rules(rules))),
            ("routes", False, MT.table_arrays(T.compile_cidr_rules(nets))),
            ("acl", False, MT.table_arrays(T.compile_acl(acl, Proto.TCP)))):
        t = dense_prepared(arrays, device, hint)
        old = DC.DenseTable(t)
        pack = P.pack_dense_hint_table if hint else P.pack_dense_cidr_table
        prep = P.prepare_hint if hint else P.prepare_cidr
        old.packed = prep(tables_from_reference(pack(arrays), device))
        tabs[key] = (t, old)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    rows = []
    for b in TIME_BATCHES:
        q = dense_hint_batch(mk_queries(rules, b, 2600 + b), b, device)
        t, old = tabs["hint"]
        rows.append(ab_row("B9 hint", b, lambda: DC.hint_dense_cuda(t, q),
                           lambda: P.hint_dense_cuda(old, q),
                           lambda: _dense_plain_hint(t, q), KERNEL_B9_HINT,
                           flush, 20, 10))
        for label, key, queries in (
                ("B9 routes", "routes", [(a, None) for a, _ in cidr_queries(
                    nets, b, 2700 + b)]),
                ("B9 ACL", "acl", acl_queries(acl, b, 2800 + b))):
            t, old = tabs[key]
            cq = cidr_batch(queries, b, device)
            rows.append(ab_row(
                label, b, lambda: DC.cidr_dense_cuda(t, *cq),
                lambda: P.cidr_dense_cuda(old, *cq),
                lambda: MT.cidr_first_match_chunked(t, *cq), KERNEL_B9_CIDR,
                flush, 20, 10))
    DC.hint_dense_cuda.launches, DC.cidr_dense_cuda.launches = saved
    del flush, tabs
    return rows


def phase_sharded_ab(device, tabs, parent_dir: str) -> list:
    """B8 of this checkout against the parent's (its sharded_cuda.py and
    sharded_match.cu with its routine headers) on sharded_tables' stacks
    (configurations (a) and (b)): every kind and column at S = 4 and
    S = 1, B = 16 / 512 / 4096; the parent's tables are the same stacked
    tensors prepared by its own module. -> rows."""
    from vproxy_tpu_torch.ops import sharded_cuda as SC
    # its B6 / B7 argument structs are the parent's (fphash_cuda)
    P = parent_module(parent_dir, "sharded_cuda", deps=("fphash_cuda",))
    prep = {"hint": P.prepare_hint, "cidr": P.prepare_cidr,
            "fp_hint": P.prepare_fp_hint, "fp_cidr": P.prepare_fp_cidr}
    for (kind, s), t in [(k, v) for k, v in tabs.items()
                         if isinstance(k, tuple)]:
        for part in ("hint", "routes", "acl"):
            if part in t:
                t[part]["parent"] = prep[kind](dict(t[part]["kern"]))
    saved = SC.sharded_cuda.launches
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    rows = []
    for kind, s, part in b8_cases(tabs):
        for b in TIME_BATCHES:
            kern, plain, _, _, name = b8_case(tabs, kind, s, b, 3500 + b,
                                              part)
            old, _, _, _, _ = b8_case(tabs, kind, s, b, 3500 + b, part,
                                      mod=P, key="parent")
            # 50 cold launches: a profile of 30 lost the same 4 records
            # five times running in one `--ab` process
            rows.append(ab_row(f"B8 {name}", b, kern, old, plain, KERNEL_B8,
                               flush, 100, 50))
    SC.sharded_cuda.launches = saved
    del flush
    return rows


def phase_sharded_layouts(device, tabs, batches=(512, 1024, 2048, 4096)):
    """B8's two layouts and the launcher's choice ("auto") timed side by
    side (warm device ms, split / interleaved / auto / interleaved /
    split) on every column that has both at the widest S (the
    fingerprint hint column is split in both), where the choice turns
    from split to interleaved (csrc/sharded_match.cu `HINT_WAVES`,
    `CIDR_WAVES`). -> rows."""
    from vproxy_tpu_torch.ops import sharded_cuda as SC
    saved = SC.sharded_cuda.launches
    s = max(SHARD_MESH)
    rows = []
    for kind, s_, part in b8_cases(tabs):
        if s_ != s or kind == "fp_hint":
            continue
        for b in batches:
            fns = {lay: b8_case(tabs, kind, s, b, 3500 + b, part,
                                layout=lay)
                   for lay in ("split", "interleaved", "auto")}
            ref = fns["auto"][1]()
            check(all(same(f[0](), ref) for f in fns.values()),
                  f"B8 {fns['auto'][4]} B={b}: a layout != plain")
            mark = dict(PROFILED)
            t = {lay: [device_ms(fns[lay][0], 100, KERNEL_B8, 1)]
                 for lay in ("split", "interleaved", "auto")}
            for lay in ("interleaved", "split"):
                t[lay].append(device_ms(fns[lay][0], 100, KERNEL_B8, 1))
            row = {"kernel": f"B8 {fns['auto'][4]}", "batch": b,
                   **{f"{lay}_ms": min(v) for lay, v in t.items()},
                   "runs": t, **profiled_since(mark)}
            rows.append(row)
            log("layouts " + json.dumps(row))
    SC.sharded_cuda.launches = saved
    return rows


def main_ab(parent_dir: str, out: str = "",
            parts: str = "fp,dense,sharded") -> int:
    """`chip_smoke.py --ab DIR [OUT [PARTS]]`: build this checkout's
    kernels (the sharded compiles start in worker processes at once),
    then time them against the parent's in DIR, the PARTS named (comma
    separated; all by default): "fp", B6 / B7 on the fingerprint tables
    (phase_fp_ab); "dense", B9 (phase_dense_ab); "sharded", B8
    (phase_sharded_ab), then B8's two layouts side by side
    (phase_sharded_layouts). A process that profiled much loses CUPTI
    records more often (PERF.md), so the parts may run in processes of
    their own. Prints the `ab` line (every row also to the file `out`,
    when given), the card's line and the device line."""
    parts = set(parts.split(","))
    check(parts <= {"fp", "dense", "sharded"} and parts,
          f"--ab parts {sorted(parts)}: want fp, dense and / or sharded")
    smi = phase_env()
    device = torch.device("cuda")
    pool, futs = sharded_start() if "sharded" in parts else (None, None)
    phase_build()
    rows = []
    if "fp" in parts:
        rows += phase_fp_ab(device, fp_tables(device), parent_dir)
    if "dense" in parts:
        rows += phase_dense_ab(device, parent_dir)
    if "sharded" in parts:
        stabs = sharded_tables(device, pool, futs)
        rows += phase_sharded_ab(device, stabs, parent_dir)
        rows += phase_sharded_layouts(device, stabs)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"ab": rows, "card": smi}, f, indent=1)
    log(json.dumps({"ab": [{k: r[k] for k in ("kernel", "batch",
                                              "parent_ms", "ms",
                                              "warm_speedup")}
                           for r in rows if "parent_ms" in r],
                    "layouts": [r for r in rows if "split_ms" in r],
                    "card": smi}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ------------------------------------------------- the dense backend (B9)
# "torch-dense" (the reference's "jax-dense"): every query against every
# rule, B9 (csrc/dense_match.cu) on the card over a packed word layout
# published beside the reference's bit-plane arrays; its classify+pick
# is B9 plus the Maglev take (B5, csrc/maglev_take.cu).


def dense_cross_chunk_tie():
    """A 9,000-rule table (two MATCH_CHUNK chunks of the plain tier, many
    rule ranges of the kernel) whose best answers tie across them: the
    same host at rules 5 and 8,500, the same suffix parent at 100 and
    8,800, and a port-gated copy first. -> (rules, hints)."""
    from vproxy_tpu_torch.rules.ir import Hint, HintRule
    rules = [HintRule(host=f"h{i}.io") for i in range(9000)]
    rules[5] = rules[8500] = HintRule(host="dup.example.com")
    rules[100] = rules[8800] = HintRule(host="example.net")
    rules[2] = HintRule(host="dup.example.com", port=443)
    rules[8999] = HintRule(host="h8999.io", uri="/x")
    return rules, [
        Hint.of_host("dup.example.com"), Hint.of_host_port(
            "dup.example.com", 443), Hint.of_host("a.example.net"),
        Hint.of_host("h8999.io"), Hint(host="h8999.io", uri="/x/y"),
        Hint.of_host("h8998.io"), Hint.of_host("nope.org")]


def dense_max_host_suffix():
    """test_matchers.py's max-length suffix and over-long query cases: a
    64-byte rule host matched by suffix and exactly, and a query host
    past MAX_HOST that must not exact-match a 64-byte rule but still
    suffix-matches a short one. -> (rules, hints)."""
    from vproxy_tpu_torch.rules.ir import Hint, HintRule
    h64 = ("a" * 62) + ".b"
    rules = [HintRule(host=h64), HintRule(host="x" * 64),
             HintRule(host="corp.example.com")]
    return rules, [Hint.of_host("sub." + h64), Hint.of_host(h64),
                   Hint.of_host("a" * 80 + ".corp.example.com"),
                   Hint.of_host("x" * 64), Hint.of_host("x" * 65),
                   Hint.of_host("y" + "x" * 64)]


def dense_v4_mapped():
    """v4 networks and v6 networks over ::ffff:v4 and ::v4, queried in
    all three forms. -> (nets, addrs)."""
    from vproxy_tpu_torch.utils.ip import Network, mask_bytes, parse_ip
    nets = [Network(parse_ip("10.1.0.0"), mask_bytes(16)),
            Network(parse_ip("::ffff:10.2.0.0"), mask_bytes(112)),
            Network(parse_ip("::10.3.0.0"), mask_bytes(112)),
            Network(parse_ip("10.0.0.0"), mask_bytes(8))]
    addrs = []
    for a in ("10.1.2.3", "10.2.2.3", "10.3.2.3", "10.9.9.9", "11.0.0.1"):
        addrs += [parse_ip(a), parse_ip("::ffff:" + a), parse_ip("::" + a)]
    return nets, addrs


def dense_hint_cases():
    """-> (name, rules, hints) of each B9 hint parity set besides the
    100k tables: the cuckoo kernels' CPU sets, a cross-chunk tie, the
    max-length host suffix and over-long host query, and the boundary
    sets."""
    rules = rand_rules(300, 11)
    yield "random_300_b600", rules, rand_hints(rules, 600, 11)
    for name, gen in (("shared_keys", shared_keys),
                      ("long_hosts", long_hosts),
                      ("wide_buckets", wide_buckets),
                      ("cross_chunk_tie", dense_cross_chunk_tie),
                      ("max_host_suffix", dense_max_host_suffix)):
        yield (name, *gen())
    for name in BOUNDARY_CASES:
        rules, hints, _ = boundary(name)
        yield name, rules, hints


def dense_cidr_cases():
    """-> (name, nets, acl or None, [(addr, port or None)]) of each B9
    cidr parity set besides config #4's tables: the CPU sets of the CIDR
    kernels (mixed families among them) and v4-mapped v6."""
    yield from small_cidr_cases()
    nets, addrs = dense_v4_mapped()
    yield "v4_mapped_v6", nets, None, [(a, None) for a in addrs]


def dense_prepared(arrays: dict, device, hint: bool):
    """A compiled dense table's arrays published on `device` as a
    "torch-dense" matcher publishes them, with the kernel's packed
    layout on the card."""
    from vproxy_tpu_torch.ops import dense_cuda as DC
    from vproxy_tpu_torch.rules.engine import _dense_table
    from vproxy_tpu_torch.utils.torchenv import tables_from_reference
    t = _dense_table(arrays, device)
    if device.type == "cuda":
        pack = DC.pack_dense_hint_table if hint else DC.pack_dense_cidr_table
        prep = DC.prepare_hint if hint else DC.prepare_cidr
        t.packed = prep(tables_from_reference(pack(arrays), device))
    return t


def dense_tables(device, n_rules=N_RULES, n_routes=N_ROUTES, n_acl=N_ACL):
    """The dense backend's serving objects, built as VPROXY_TPU_MATCHER=
    jax-dense builds them (no backend named): a HintMatcher of n_rules
    rules (mk_rules) and a FusedPair with a Maglev table of MAGLEV_M
    slots over BACKENDS backends, a route CidrMatcher of n_routes
    routes and a SecurityGroup of the n_acl-rule TCP ACL (BASELINE
    config #4, not cut). -> dict of them (and the rule lists)."""
    from vproxy_tpu_torch.components.secgroup import SecurityGroup
    from vproxy_tpu_torch.ops import dense_cuda as DC
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules import maglev as M
    from vproxy_tpu_torch.rules.ir import Proto
    saved = os.environ.get("VPROXY_TPU_MATCHER")
    os.environ["VPROXY_TPU_MATCHER"] = "jax-dense"
    # the packers' share of each publish (host work: the grouping sort)
    packers, pack_s = (DC.pack_dense_hint_table,
                       DC.pack_dense_cidr_table), []

    def timed(fn):
        def run(arrays):
            t = time.monotonic()
            out = fn(arrays)
            pack_s.append(round(time.monotonic() - t, 3))
            return out
        return run
    DC.pack_dense_hint_table, DC.pack_dense_cidr_table = map(timed, packers)
    try:
        t0 = time.monotonic()
        rules = mk_rules(n_rules)
        hm = E.HintMatcher(rules, device=device)
        t1 = time.monotonic()
        mm = M.MaglevMatcher(backends(), m=MAGLEV_M, device=device)
        nets = route_nets(n_routes, ROUTE_SEED)
        routes = E.CidrMatcher(nets, device=device)
        t2 = time.monotonic()
        acl = acl_rules(n_acl, ACL_SEED)
        group = SecurityGroup("acl-dense", default_allow=False)
        group.extend_rules(acl)
        am = group._tables[Proto.TCP][0]
    finally:
        DC.pack_dense_hint_table, DC.pack_dense_cidr_table = packers
        if saved is None:
            os.environ.pop("VPROXY_TPU_MATCHER", None)
        else:
            os.environ["VPROXY_TPU_MATCHER"] = saved
    for m in (hm, routes, am):
        dev = m.snapshot()[1 if m is hm else 0]
        check(m.backend == "torch-dense" and isinstance(dev, DC.DenseTable)
              and (dev.packed is not None) == (device.type == "cuda"),
              f"VPROXY_TPU_MATCHER=jax-dense built {m.backend}, not a "
              f"published dense table")
    packed = [m.snapshot()[1 if m is hm else 0].packed for m in
              (hm, routes, am)]
    log(f"dense tables: {n_rules} hint rules in {t1 - t0:.1f} s, "
        f"{n_routes} routes in {t2 - t1:.1f} s, ACL of {n_acl} in "
        f"{time.monotonic() - t2:.1f} s; published bytes "
        f"{hm.published_table_bytes()} + {routes.published_table_bytes()}"
        f" + {am.published_table_bytes()}, packed bytes "
        f"{[sum(v.numel() * v.element_size() for v in p.values()) if p else 0 for p in packed]}"
        f"; packing (s, each publish) {pack_s}")
    return {"rules": rules, "hm": hm, "mm": mm, "pair": M.FusedPair(hm, mm),
            "nets": nets, "routes": routes, "acl": acl, "group": group,
            "am": am}


def dense_hint_batch(hints, b: int, device) -> dict:
    """`hints` encoded as the dense engine encodes a batch (ops/tables
    encode_hints), padded to b rows with empty Hint()s."""
    from vproxy_tpu_torch.ops import tables as T
    from vproxy_tpu_torch.rules.ir import Hint
    from vproxy_tpu_torch.utils.torchenv import tables_from_reference
    hints = list(hints) + [Hint()] * (b - len(hints))
    return tables_from_reference(T.encode_hints(hints), device)


def _dense_plain_hint(t, q):
    from vproxy_tpu_torch.ops import matchers as MT
    return MT.hint_match_chunked(t, q["host"], q["has_host"],
                                 MT.unpack_bits(q["uri"]), q["has_uri"],
                                 q["port"])


def b9_vs_plain(name, t, q=None, device=None, a16=None, fam=None,
                port=None, host=None, mcol=None) -> int:
    """B9 (hint when `q` is given, else cidr) against its plain tier
    (matchers.hint_match_chunked / cidr_first_match_chunked) on the same
    tensors, int32-equal (on CPU tensors the plain tier against itself),
    and its first len(host) answers equal to `host` (the host index's)
    when given; with `mcol` (maglev_column) also B9's hint with its
    Maglev column against its plain version (hint_dense_pick_plain).
    -> max |kernel - plain|."""
    from vproxy_tpu_torch.ops import dense_cuda as DC
    from vproxy_tpu_torch.ops import matchers as MT
    on_card = device.type == "cuda"
    if q is not None:
        ref = _dense_plain_hint(t, q)
        got = DC.hint_dense_cuda(t, q) if on_card else ref
        b, what = q["host"].shape[0], "hint"
    else:
        ref = (MT.cidr_first_match_chunked(t, a16, fam, port),)
        got = (DC.cidr_dense_cuda(t, a16, fam, port),) if on_card else ref
        b, what = a16.shape[0], "cidr"
    _sync(device)
    d = max(int((g.long() - r.long()).abs().max()) for g, r in zip(got, ref))
    log(f"B9 {what} vs plain [{name}]: b {b} grid "
        f"{DC.grid(b, t.packed) if on_card else None} matched "
        f"{int((ref[0] >= 0).sum())} max_abs_err {d}")
    check(all(torch.equal(g, r) for g, r in zip(got, ref)),
          f"B9 {what} != plain [{name}]")
    if host is not None:
        check(got[0][:len(host)].tolist() == list(host),
              f"B9 {what} != the host index [{name}]")
    if fam is not None:
        check(bool((got[0][fam < 0] == -1).all()),
              f"B9 pad row matched [{name}]")
    if mcol is not None:
        ref2 = MT.hint_dense_pick_plain(t, q, *mcol)
        got2 = DC.hint_dense_cuda(t, q, mtab=mcol[0], slots=mcol[1]) \
            if on_card else ref2
        _sync(device)
        d = max(d, pick_vs_plain(f"B9 hint pick [{name}]", got2, ref2,
                                 ref[0], mcol))
    return d


WIDE_LIVE = 600                   # live rules of the wide table
WIDE_SLOTS = (1 << 20) + (1 << 16)  # its rule slots, inactive but those


def wide_rules(n_live=WIDE_LIVE, slots=WIDE_SLOTS, seed=31) -> tuple:
    """A rule list of `slots` slots whose n_live live rules (mk_rules)
    lie at seeded indices, half of them past 2^20, every other slot an
    inactive (empty) rule; the first live rule past 2^20 repeats the
    last one below it (equal levels across the boundary: the earlier
    must win). -> (rules, the live rules)."""
    from vproxy_tpu_torch.rules.ir import HintRule
    rng = np.random.default_rng(seed)
    live = mk_rules(n_live, seed=seed)
    lo = np.sort(rng.choice(1 << 20, size=n_live // 2, replace=False))
    hi = (1 << 20) + np.sort(rng.choice(slots - (1 << 20),
                                        size=n_live - n_live // 2,
                                        replace=False))
    rules = [HintRule()] * slots
    for i, r in zip(np.concatenate([lo, hi]).tolist(), live):
        rules[i] = r
    rules[int(hi[0])] = rules[int(lo[-1])]
    return rules, live


def dense_wide_check(device, b=SERVICE_BATCH) -> dict:
    """ROADMAP Queue C 3 on the card: a "torch-dense" HintMatcher whose
    live rules lie past index 2^20 (wide_rules) publishes its packed
    layout with the 64-bit key, and B9's hint answers a batch of b rows
    (an eighth pad rows) int32-equal to the plain version and to the
    host index (the linear oracle on 16 rows too), with and without its
    Maglev column: one launch each. -> the check's numbers."""
    from vproxy_tpu_torch.ops import dense_cuda as DC
    from vproxy_tpu_torch.rules import engine as E
    rules, live = wide_rules()
    t0 = time.monotonic()
    hm = E.HintMatcher(rules, backend="torch-dense", device=device)
    publish_s = time.monotonic() - t0
    snap = hm.snapshot()
    t = snap[1]
    on_card = device.type == "cuda"
    check(not on_card or (t.packed is not None and t.packed.wide),
          "a table past 2^20 rules did not publish the 64-bit key's layout")
    hints = mk_queries(live, b - b // 8, seed=33)
    q = dense_hint_batch(hints, b, device)
    host = [hm.index_snap(snap, h) for h in hints]
    check(host[:16] == [hm.oracle_snap(snap, h) for h in hints[:16]],
          "the wide table's host index != the linear oracle")
    n0 = DC.hint_dense_cuda.launches
    d = b9_vs_plain(f"{len(rules)} rule slots, live past 2^20", t, q,
                    device, host=host,
                    mcol=maglev_column(b, device, 34, b // 8))
    check(DC.hint_dense_cuda.launches - n0 == (2 if on_card else 0),
          "the wide table's checks made no two B9 launches")
    past = sum(x >= 1 << 20 for x in host)
    check(past > 0, "no answer of the wide batch lies past 2^20")
    out = {"rule_slots": len(rules), "live_rules": len(live),
           "publish_s": publish_s, "wide": bool(on_card and t.packed.wide),
           "answers_past_2_20": past, "max_abs_err": d}
    log(f"B9 wide table: {json.dumps(out)}")
    del hm, snap, t, q
    if on_card:
        torch.cuda.empty_cache()
    return out


def b5_vs_plain(mm, b: int, device) -> int:
    """B5 against torch indexing (take_plain) and maglev.pick on the host
    table, for b flows whose slots run past both ends of the table every
    few rows (the clip). -> max |kernel - plain|."""
    from vproxy_tpu_torch.ops import take_cuda as TC
    from vproxy_tpu_torch.rules import maglev as M
    tab, dev = mm.snapshot()[:2]
    ips = mk_ips(b, seed=3100 + b)
    ports = [None if i % 3 == 0 else 2048 + i for i in range(b)]
    slots = M.flow_slots(len(tab), ips, ports)
    slots[::5] = -1 - np.arange(len(slots[::5]))
    slots[2::7] = len(tab) + np.arange(len(slots[2::7]))
    s = torch.from_numpy(slots).to(device)
    ref = TC.take_plain(dev, s)
    got = TC.maglev_take_cuda(dev, s) if device.type == "cuda" else ref
    _sync(device)
    d = int((got.long() - ref.long()).abs().max())
    host = [M.pick(tab, ips[i], ports[i]) for i in range(b)]
    clip = tab[np.clip(slots, 0, len(tab) - 1)]
    log(f"B5 vs plain [B={b}, {len(slots[::5]) + len(slots[2::7])} slots "
        f"past the ends]: max_abs_err {d}")
    check(torch.equal(got, ref), f"B5 != torch indexing at B={b}")
    check(np.array_equal(got.cpu().numpy(), clip), f"B5 != the host table "
          f"at B={b}")
    keep = np.ones(b, bool)
    keep[::5] = keep[2::7] = False
    check(all(int(got[i]) == host[i] for i in np.flatnonzero(keep)),
          f"B5 != maglev.pick at B={b}")
    return d


def phase_dense_kernels(device, tabs, batches=TIME_BATCHES, n_host=N_RULES):
    """B9 int32-exact against its plain tier: hint on the published 100k
    table (uri rules; and against the host index) and a 100k host-only
    table at every B of `batches`, an eighth of each batch pad rows,
    with and without its Maglev column (maglev_column), a table whose
    live rules lie past 2^20 (dense_wide_check), and
    on dense_hint_cases
    (+8 pad rows); cidr on config #4's routes and ACL (ports and None;
    the first two against CidrIndex too) at every B (v4, ::v4,
    ::ffff:v4, v6 and pad rows) and on
    dense_cidr_cases; classify_all's five outputs (B9 three times, the
    allow gather) against the plain tier at the largest B; B5 against
    torch indexing and maglev.pick at every B. Launch counts are
    restored after. -> {"b9": err, "all": err, "b5": err}."""
    from vproxy_tpu_torch.ops import dense_cuda as DC
    from vproxy_tpu_torch.ops import matchers as MT
    from vproxy_tpu_torch.ops import tables as T
    from vproxy_tpu_torch.ops import take_cuda as TC
    counters = (DC.hint_dense_cuda, DC.cidr_dense_cuda, TC.maglev_take_cuda)
    saved = [f.launches for f in counters]
    hsnap = tabs["hm"].snapshot()
    b9 = 0
    host_rules = mk_host_rules(n_host)
    host_t = dense_prepared(MT.table_arrays(T.compile_hint_rules(
        host_rules)), device, True)
    for name, t, rules in (("100k uri", hsnap[1], tabs["rules"]),
                           ("100k host-only", host_t, host_rules)):
        for b in batches:
            hints = mk_queries(rules, b - b // 8, seed=900 + b)
            q = dense_hint_batch(hints, b, device)
            b9 = max(b9, b9_vs_plain(
                f"{name} B={b}, {b // 8} pad rows", t, q, device,
                host=[tabs["hm"].index_snap(hsnap, h) for h in hints]
                if t is hsnap[1] else None,
                mcol=maglev_column(b, device, 960 + b, b // 8)))
    del host_t
    wide = dense_wide_check(device, b=min(SERVICE_BATCH, max(batches)))
    for name, rules, hints in dense_hint_cases():
        t = dense_prepared(MT.table_arrays(T.compile_hint_rules(rules)),
                           device, True)
        b9 = max(b9, b9_vs_plain(name, t, dense_hint_batch(
            hints, len(hints) + 8, device), device))
    rsnap, asnap = tabs["routes"].snapshot(), tabs["am"].snapshot()
    rt, at = rsnap[0], asnap[0]
    for b in batches:
        real = b - b // 8
        rq = [(a, None) for a, _ in cidr_queries(tabs["nets"], real,
                                                  600 + b)]
        aq = acl_queries(tabs["acl"], real, 700 + b)
        a16, fam, port = cidr_batch(aq, b, device)
        for name, t, batch, host in (
                (f"routes 50k B={b}", rt, cidr_batch(rq, b, device),
                 [tabs["routes"].index_snap(rsnap, a) for a, _ in rq]),
                (f"ACL 5k B={b}", at, (a16, fam, port),
                 [tabs["am"].index_snap(asnap, a, p) for a, p in aq]),
                (f"ACL 5k B={b} port=None", at, (a16, fam, None), None)):
            b9 = max(b9, b9_vs_plain(name, t, None, device, *batch,
                                     host=host))
    for name, nets, acl, q in dense_cidr_cases():
        t = dense_prepared(MT.table_arrays(T.compile_cidr_rules(
            nets, acl=acl)), device, False)
        b9 = max(b9, b9_vs_plain(name, t, None, device,
                                 *cidr_batch(q, len(q) + 8, device)))
    b = max(batches)
    real = b - b // 8
    hq = dense_hint_batch(mk_queries(tabs["rules"], real, seed=950), b,
                          device)
    rq = dict(zip(("addr", "family"), cidr_batch(
        [(a, None) for a, _ in cidr_queries(tabs["nets"], real, 952)], b,
        device)[:2]))
    aq = dict(zip(("addr", "family", "port"), cidr_batch(
        acl_queries(tabs["acl"], real, 951), b, device)))
    ref = MT.classify_all(hsnap[1], rt, at, hq, rq, aq)
    n0 = [f.launches for f in counters]
    got = MT.classify_dense(hsnap[1], rt, at, hq, rq, aq)
    _sync(device)
    n1 = [f.launches for f in counters]
    on_card = device.type == "cuda"
    check(n1[0] - n0[0] == (1 if on_card else 0) and
          n1[1] - n0[1] == (2 if on_card else 0),
          f"classify_dense launched B9 hint {n1[0] - n0[0]}, cidr "
          f"{n1[1] - n0[1]} times")
    err_all = max(int((g.long() - r.long()).abs().max())
                  for g, r in zip(got, ref))
    log(f"classify_all vs plain [100k + config #4, B={b}]: matched "
        f"{[int((r >= 0).sum()) for r in ref[:4]]} allowed "
        f"{int(ref[4].sum())} max_abs_err {err_all}")
    check(len(got) == 5 and all(torch.equal(g, r) for g, r in
                                zip(got, ref)), "classify_dense != plain")
    b5 = max(b5_vs_plain(tabs["mm"], b, device) for b in batches)
    for f, n in zip(counters, saved):
        f.launches = n
    return {"b9": max(b9, wide["max_abs_err"]), "all": err_all, "b5": b5,
            "wide": wide}


def phase_dense_service(device, tabs, bursts=BURSTS, burst=SERVICE_BATCH,
                        cidr_oracle=None):
    """The dense backend's main path through ClassifyService in "device"
    mode: bursts x burst submit_hint on the torch-dense HintMatcher, as
    many submit_classify_pick on the FusedPair over it (B9 with its
    Maglev column: one launch a batch), SecurityGroup allow_async on
    config #4's ACL and submit_cidr on the 50k routes. Every answer
    equal to the host index (HintIndex + maglev.pick; CidrIndex and
    phase 7's linear oracle for CIDR, `cidr_oracle`, or oracle_snap here
    without it); one B9 launch per hint, cpick (with the Maglev column)
    or cidr batch, no B5 launch and no `_device_take` call, B1 / B3 /
    B4 / B6 / B7 never, no failover, every query answered by the
    device. -> the phase's numbers."""
    from vproxy_tpu_torch.ops import cidr_cuda as CC
    from vproxy_tpu_torch.ops import dense_cuda as DC
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    from vproxy_tpu_torch.ops import fused_cuda as FC
    from vproxy_tpu_torch.ops import matchers as MT
    from vproxy_tpu_torch.ops import take_cuda as TC
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
              CC.cidr_first_cuda, FPC.hint_fp_cuda, FPC.cidr_fp_cuda)
    other0 = [f.launches for f in others]
    ClassifyService.reset()
    svc = ClassifyService.get()  # the one allow_async submits to
    svc.mode = "device"
    try:
        # the main path's counts, read just after it
        DC.hint_dense_cuda.launches = DC.cidr_dense_cuda.launches = 0
        DC.hint_dense_cuda.pick_launches = 0
        TC.maglev_take_cuda.launches = M._device_take.calls = 0
        MT.hint_match_chunked.cuda_calls = 0
        lat = []
        MT.cidr_first_match_chunked.cuda_calls = 0
        f0, l0 = E.fused_dispatches_total(), E.dispatch_launches_total()
        t0 = time.monotonic()
        for k in range(bursts):
            hints = mk_queries(tabs["rules"], burst, seed=2200 + k)
            got = _answers(svc, lambda h, cb: svc.submit_hint(hm, h, cb),
                           [(h,) for h in hints])
            for i, h in enumerate(hints):
                check(got[i] == (hm.index_snap(hsnap, h),),
                      f"dense hint burst {k} row {i}")
        hint_s = time.monotonic() - t0
        t0 = time.monotonic()
        for k in range(bursts):
            hints = mk_queries(tabs["rules"], burst, seed=2300 + k)
            ips = mk_ips(burst, seed=2400 + k)
            ports = [None if i % 3 == 0 else 1024 + i
                     for i in range(burst)]
            got = _answers(
                svc, lambda h, ip, port, cb: svc.submit_classify_pick(
                    pair, h, ip, port, cb), list(zip(hints, ips, ports)),
                lat)
            for i in range(burst):
                want = (hm.index_snap(hsnap, hints[i]),
                        M.pick(msnap[0], ips[i], ports[i]))
                check(got[i] == want, f"dense cpick burst {k} row {i}: "
                      f"{got[i]} != host {want}")
        cpick_s = time.monotonic() - t0
        t0 = time.monotonic()
        a_got = [_answers(svc, lambda a, p, cb: group.allow_async(
            Proto.TCP, a, p, lambda ok: cb(ok, None)), q) for q in aqs]
        r_got = [_answers(svc, lambda a, p, cb: svc.submit_cidr(
            routes, a, p, cb), q) for q in rqs]
        cidr_s = time.monotonic() - t0
        launches = {"hint_dense": DC.hint_dense_cuda.launches,
                    "hint_dense_pick": DC.hint_dense_cuda.pick_launches,
                    "cidr_dense": DC.cidr_dense_cuda.launches,
                    "maglev_take": TC.maglev_take_cuda.launches}
        takes = M._device_take.calls
        st = svc.stats
        batches = {k: st.by_kind.get(k, [0])[0] for k in
                   ("hint", "cpick", "cidr")}
        on_card = device.type == "cuda"
        check(st.failovers == 0, f"{st.failovers} device failovers")
        check(st.device_queries == 4 * n and st.oracle_queries == 0,
              f"device answered {st.device_queries} of {4 * n}")
        check(all(v > 0 for v in batches.values()),
              f"a kind formed no batch: {batches}")
        check(launches["hint_dense"] == (batches["hint"] + batches["cpick"]
                                         if on_card else 0),
              f"B9 hint launches {launches['hint_dense']} != hint + cpick "
              f"batches {batches}")
        check(launches["hint_dense_pick"] == (batches["cpick"] if on_card
                                              else 0),
              f"B9 launches with the Maglev column "
              f"{launches['hint_dense_pick']} != cpick batches {batches}")
        check(takes == 0 and launches["maglev_take"] == 0,
              f"a cpick batch took the Maglev take: {takes} _device_take "
              f"calls, {launches['maglev_take']} B5 launches")
        check(launches["cidr_dense"] == (batches["cidr"] if on_card else 0),
              f"B9 cidr launches {launches['cidr_dense']} != cidr batches "
              f"{batches}")
        check(E.fused_dispatches_total() == f0,
              "a dense cpick batch took the fused dispatch")
        check(E.dispatch_launches_total() - l0 == batches["hint"] +
              batches["cpick"] + batches["cidr"],
              "engine launches != hint + cpick + cidr batches")
        check([f.launches for f in others] == other0,
              "the dense path launched B1, B3, B4, B6 or B7")
        check(MT.hint_match_chunked.cuda_calls ==
              MT.cidr_first_match_chunked.cuda_calls == 0,
              "B9's plain tier ran on CUDA tensors")
        out = {"backend": hm.backend, "queries": 4 * n, "batches": batches,
               "launches": launches, "maglev_takes": takes,
               "failovers": st.failovers, "max_batch": st.max_batch,
               "hint_wall_s": hint_s, "cpick_wall_s": cpick_s,
               "cidr_wall_s": cidr_s, "cpick_latency": lat_ms(lat),
               "classify_latency": st.latency_percentiles()}
        log(f"dense service: {json.dumps(out)}")
    finally:
        ClassifyService.reset()
    for k in range(bursts):
        for i, (a, p) in enumerate(aqs[k]):
            j = am.index_snap(asnap, a, p)
            check(j == a_orc[k * burst + i],
                  f"dense ACL burst {k} row {i}: CidrIndex {j} != oracle")
            want = sub[j].allow if j >= 0 else group.default_allow
            check(a_got[k][i] == (want,), f"dense ACL burst {k} row {i}: "
                  f"{a_got[k][i]} != {want} (rule {j})")
        for i, (a, p) in enumerate(rqs[k]):
            j = routes.index_snap(rsnap, a, p)
            check(j == r_orc[k * burst + i] and r_got[k][i] == (j,),
                  f"dense route burst {k} row {i}: {r_got[k][i]}, "
                  f"CidrIndex {j}, oracle {r_orc[k * burst + i]}")
    for h in mk_queries(tabs["rules"], 32, seed=2500):
        check(hm.index_snap(hsnap, h) == oracle.search(tabs["rules"], h),
              f"host index != linear oracle for {h}")
    return out


def _port_gated(w, rport, qport):
    """int64 [n] per rule, int32 [n] rule ports, int32 [B] query ports
    -> int64 [B]: per query, the sum of w over the rules its port gate
    admits (query port 0, rule port 0, or the two equal)."""
    if w.numel() == 0:
        return torch.zeros(qport.shape[0], dtype=torch.int64,
                           device=qport.device)
    ports, inv = torch.unique(rport.long(), return_inverse=True)
    per = torch.zeros(ports.numel(), dtype=torch.int64,
                      device=w.device).index_add_(0, inv, w)
    qp = qport.long()
    pos = torch.searchsorted(ports, qp).clamp(max=ports.numel() - 1)
    own = torch.where((ports[pos] == qp) & (qp != 0), per[pos], 0)
    return torch.where(qp == 0, w.sum(), per[ports == 0].sum() + own)


def dense_hint_work(t, q):
    """(bytes, int ops) one B9 hint launch needs for this batch: the
    query arrays read once and two int32 written per query; per active
    rule its meta row (16 B) and, of each pattern it holds, the mask and
    value (8 B) of every word with a mask bit (dense_cuda
    .hint_pattern_words), read once. Ops: a query with a host compares
    the host words, one with a uri the uri words, of every active rule
    its port gate admits, 2 int ops a word (the (q ^ v) & m and the OR
    into the pattern's mismatch); a pad row compares nothing."""
    from vproxy_tpu_torch.ops import dense_cuda as DC
    w = DC.hint_pattern_words(DC.packed_of(t, hint=True))
    b = q["host"].shape[0]
    nbytes = sum(v.numel() * v.element_size() for v in q.values()) + b * 8
    nbytes += int(w["active"].sum()) * 16 + \
        int((w["host"] + w["uri"]).sum()) * 8
    ops = sum(int((_port_gated(w[k], w["port"], q["port"]) *
                   q[has].long()).sum()) * 2
              for k, has in (("host", "has_host"), ("uri", "has_uri")))
    return nbytes, ops


def dense_cidr_work(t, a16, fam, port):
    """(bytes, int ops) one B9 cidr launch needs for this batch: every
    query's address, family (and port) read once and its answer written
    once; per query, the rules up to its first match (all live rules
    without one) whose port gate holds, and of each the valid slots of
    the query's family: 2 ops a mask word with a bit (dense_cuda
    .cidr_slot_words: one for an IPv4 slot, up to four for a v6 one);
    per family, the rows up to the last rule a query of it reaches, read
    once (16 B of meta, 8 B a compared word). Pad rows (family -1) need
    nothing."""
    from vproxy_tpu_torch.ops import dense_cuda as DC
    from vproxy_tpu_torch.ops import matchers as MT
    w = DC.cidr_slot_words(DC.packed_of(t, hint=False))
    b, n = a16.shape[0], w["words"].shape[0]
    nbytes = b * (16 + 4 + 4) + (b * 4 if port is not None else 0)
    first = MT.cidr_first_match_chunked(t, a16, fam, port)
    stop = torch.where(first >= 0, first.long() + 1, n)
    ops = rows = words = 0
    for f in (0, 1):
        sel = fam == f
        if n == 0 or not bool(sel.any()):
            continue
        cnt = w["words"][:, f]  # [n]
        st = stop[sel]
        if port is None:
            ops += int(torch.cat([cnt.new_zeros(1), cnt.cumsum(0)])[st]
                       .sum()) * 2
        else:
            qp = port[sel].long()[:, None]
            ok = (w["min_port"][None] <= qp) & (qp <= w["max_port"][None])
            ok &= torch.arange(n, device=ok.device)[None] < st[:, None]
            ops += int((ok.long() * cnt[None]).sum()) * 2
        reach = int(st.max())
        rows, words = max(rows, reach), words + int(cnt[:reach].sum())
    return nbytes + rows * 16 + words * 8, ops


def dense_library_ms(t, q=None, a16=None) -> float:
    """The library yardstick of B9: the count step alone, the reference's
    float32 mismatch GEMM as torch.matmul (TF32 allowed, as
    bitmatch.mismatch_counts runs it) at this batch's shapes: host
    [B, 528] x [528, 2 cap] and uri [B, 1024] x [1024, cap] for a hint
    batch, [B, 128] x [128, 3 cap] for a cidr one, into preallocated
    outputs; no bias, compare, level or reduction. Device ms per call."""
    from vproxy_tpu_torch.ops.bitmatch import unpack_bits
    if q is not None:
        pairs = [(unpack_bits(q["host"]), t["host_w"].float()),
                 (unpack_bits(q["uri"]), t["uri_w"].float())]
    else:
        pairs = [(unpack_bits(a16), t["w"].float())]
    outs = [torch.empty((a.shape[0], w.shape[1]), dtype=torch.float32,
                        device=a.device) for a, w in pairs]

    def gemm():
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            for (a, w), o in zip(pairs, outs):
                torch.matmul(a, w, out=o)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    # two runs that saw device time (the profiler drops its records now
    # and then, and cuBLAS's kernel count per call is not ours to check)
    ms = []
    for _ in range(5):
        t = device_ms(gemm, 5)
        ms += [t] if t > 0 else []
        if len(ms) == 2:
            break
    check(len(ms) == 2, "the profiler saw no GEMM device time in five runs")
    del pairs, outs
    return min(ms)


def phase_dense_times(device, tabs):
    """B9 on the published 100k hint table (uri rules), config #4's
    routes and ACL (with ports), and classify_all (B9 three times, its
    launches summed) at every TIME_BATCHES, with time_row at fewer
    iterations (the kernel takes milliseconds, its plain tier tens to
    hundreds): warm and cold device time, the plain tier's, the wall
    time per call and the bound (dense_hint_work / dense_cidr_work: the
    larger of the needed packed words' bytes over the HBM rate and the
    compared words' int ops over INT_OPS_PER_S); beside each row the
    count step's GEMM alone (dense_library_ms) and the launch grid; B9's
    hint with its Maglev column beside it (maglev_column; its bound adds
    pick_bytes). -> {"B9 hint": rows, "B9 hint pick": rows, "B9 routes":
    rows, "B9 ACL": rows, "classify_all": rows}."""
    from vproxy_tpu_torch.ops import dense_cuda as DC
    from vproxy_tpu_torch.ops import matchers as MT
    saved = (DC.hint_dense_cuda.launches, DC.cidr_dense_cuda.launches)
    ht = tabs["hm"].snapshot()[1]
    rt, at = tabs["routes"].snapshot()[0], tabs["am"].snapshot()[0]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    out = {"B9 hint": [], "B9 hint pick": [], "B9 routes": [], "B9 ACL": [],
           "classify_all": []}
    iters = {"iters": 20, "cold_iters": 10, "plain_iters": 2}
    for b in TIME_BATCHES:
        q = dense_hint_batch(mk_queries(tabs["rules"], b, 2600 + b), b,
                             device)
        row = time_row(b, lambda: DC.hint_dense_cuda(ht, q),
                       lambda: _dense_plain_hint(ht, q), KERNEL_B9_HINT,
                       flush, dense_hint_work(ht, q), **iters)
        row["library_ms"] = dense_library_ms(ht, q=q)
        row["grid"] = DC.grid(b, ht.packed)
        out["B9 hint"].append(row)
        log("times B9 hint " + json.dumps(row))
        mcol = maglev_column(b, device, 2650 + b)
        w = dense_hint_work(ht, q)
        row = time_row(b, lambda: DC.hint_dense_cuda(ht, q, mtab=mcol[0],
                                                     slots=mcol[1]),
                       lambda: MT.hint_dense_pick_plain(ht, q, *mcol),
                       KERNEL_B9_HINT, flush,
                       (w[0] + pick_bytes(b, mcol[1]), w[1]), **iters)
        out["B9 hint pick"].append(row)
        log("times B9 hint pick " + json.dumps(row))
        for label, t, queries in (
                ("B9 routes", rt, [(a, None) for a, _ in cidr_queries(
                    tabs["nets"], b, 2700 + b)]),
                ("B9 ACL", at, acl_queries(tabs["acl"], b, 2800 + b))):
            a16, fam, port = cidr_batch(queries, b, device)
            row = time_row(
                b, lambda: DC.cidr_dense_cuda(t, a16, fam, port),
                lambda: MT.cidr_first_match_chunked(t, a16, fam, port),
                KERNEL_B9_CIDR, flush, dense_cidr_work(t, a16, fam, port),
                **iters)
            row["library_ms"] = dense_library_ms(t, a16=a16)
            row["grid"] = DC.grid(b, t.packed)
            out[label].append(row)
            log(f"times {label} " + json.dumps(row))
        aq = cidr_batch(acl_queries(tabs["acl"], b, 2900 + b), b, device)
        rq, acq = {"addr": aq[0], "family": aq[1]}, dict(zip(
            ("addr", "family", "port"), aq))
        works = [dense_hint_work(ht, q), dense_cidr_work(rt, *aq[:2], None),
                 dense_cidr_work(at, *aq)]
        row = time_row(
            b, lambda: MT.classify_dense(ht, rt, at, q, rq, acq),
            lambda: MT.classify_all(ht, rt, at, q, rq, acq), "dense_",
            flush, (sum(w[0] for w in works) - b * 24,  # one address batch
                    sum(w[1] for w in works)), launches=3, **iters)
        out["classify_all"].append(row)
        log("times classify_all " + json.dumps(row))
    DC.hint_dense_cuda.launches, DC.cidr_dense_cuda.launches = saved
    del flush
    return out


# ------------------------------------------- B8: the sharded backends
#
# "torch-sharded" and "torch-fp-sharded" (ROADMAP Queue A item 8):
# configurations (a) and (b) compiled by compile_*_hash_sharded and
# compile_*_fp_sharded at S = 4 (make_mesh(8, batch=2), the reference's
# production layout: four rule shards stacked on the card) and S = 1
# (make_mesh(2, batch=2)), uncut. The compiles are host work (~2 min on
# one core at S = 4 and S = 1 together), so spawned worker processes
# start them with the script (`sharded_start`) and the phase collects
# them; B8 is then held against its plain version and the host index at
# every pad_batch bucket up to 4096 and timed beside B3 / B4 / B6 / B7
# on the same rules.

REPLACES_B8 = "vproxy_tpu/parallel/mesh.py:364"
KERNEL_B8 = "sharded_"  # sharded_hash_kernel<...> / sharded_fp_kernel
SOURCE_B8 = "vproxy_tpu_torch/csrc/sharded_match.cu"
SHARD_MESH = {4: 8, 1: 2}  # S -> n of make_mesh(n, batch=2)
SHARD_KINDS = ("hint", "fp_hint", "cidr", "fp_cidr")
SHARDED_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
SHARDED_WORKERS = 3


def sharded_tie_case(n: int = 37):
    """Hint rules whose best level ties across shards (one host in
    every shard: the least global index must win; a port-gated twin
    of it), wildcard-host, pure-uri and host+uri rules, with hints
    that reach them and hints every shard answers at level 0 (an
    empty hint, a host no rule holds, a port the gate refuses). n = 37
    is divided by no S in 2..4. -> (rules, hints)."""
    from vproxy_tpu_torch.rules.ir import Hint, HintRule
    rules = []
    for i in range(n):
        k = i % 6
        rules.append(
            HintRule(host="tie.example.com") if k == 0 else
            HintRule(host="tie.example.com", port=8443) if k == 1 else
            HintRule(host="*", uri="/w") if k == 2 else
            HintRule(uri=f"/p{i % 4}") if k == 3 else
            HintRule(host=f"h{i}.tie.example.com") if k == 4 else
            HintRule(host="example.com", uri="/p1"))
    hints = [Hint.of_host("tie.example.com"),
             Hint.of_host_port("tie.example.com", 8443),
             Hint.of_host_port("tie.example.com", 80),
             Hint.of_host("x.tie.example.com"), Hint(), Hint(uri="/w"),
             Hint.of_host_uri("a.tie.example.com", "/w/x"),
             Hint(uri="/p1/z"), Hint.of_host_uri("x.example.com", "/p1"),
             Hint.of_host("h4.tie.example.com"),
             Hint.of_host_port("h10.tie.example.com", 1),
             Hint.of_host("nohost.invalid")]
    return rules, hints


def sharded_late_wildcard_case():
    """Wildcard rules (host "*", uri "*") that only the later shards of
    S = 2..4 hold (rules 28-30 of 37), each the best answer of a hint,
    beside exact hosts in every shard: a kernel that read shard 0's
    wildcard lists for every shard misses them. -> (rules, hints)."""
    from vproxy_tpu_torch.rules.ir import Hint, HintRule
    rules = ([HintRule(host=f"h{i}.x.com") for i in range(28)] +
             [HintRule(host="*", uri="/zz"), HintRule(host="*"),
              HintRule(host="late.x.com", uri="*")] +
             [HintRule(host=f"g{i}.x.com") for i in range(6)])
    hints = [Hint(uri="/zz/a"), Hint.of_host("q.y.com"),
             Hint.of_host_uri("late.x.com", "/p"), Hint.of_host("h3.x.com"),
             Hint.of_host("g5.x.com"), Hint()]
    return rules, hints


def sharded_case_checks(device) -> int:
    """sharded_tie_case and sharded_late_wildcard_case at S = 4, 3, 2, 1
    on both sharded forms (cuckoo, fingerprint), through hint_sharded (B8
    on the card, its plain version on the CPU): every answer the linear
    oracle's, -1 on the pad rows. -> the batches checked."""
    from vproxy_tpu_torch.ops import fphash as FP
    from vproxy_tpu_torch.ops import hashmatch as H
    from vproxy_tpu_torch.ops import sharded_cuda as SC
    from vproxy_tpu_torch.parallel import mesh as M
    from vproxy_tpu_torch.rules import oracle
    n = 0
    for rules, hints in (sharded_tie_case(), sharded_late_wildcard_case()):
        want = [oracle.search(rules, h) for h in hints]
        for s in (4, 3, 2, 1):
            for fp in (False, True):
                stab = (FP.compile_hint_fp_sharded if fp else
                        H.compile_hint_hash_sharded)(rules, s)
                raw, kern = sharded_device(stab, "fp_hint" if fp else
                                           "hint", device)
                q = sharded_hint_batch(stab, hints, 16, M.make_mesh(
                    2 * s, batch=2, device=device), fp)
                got = SC.hint_sharded(kern, q, stab.shard_size,
                                      fp=fp).tolist()
                check(got == want + [-1] * (16 - len(hints)),
                      f"B8 {'fp ' if fp else ''}hint S={s}: {got} != the "
                      f"oracle's {want}")
                n += 1
    return n


def sharded_compile(kind: str, s: int, n_rules: int, n_routes: int,
                    n_acl: int):
    """One sharded compile (run in a spawned worker): kind "hint" /
    "fp_hint" -> the ShardedHashTable of mk_rules(n_rules); "cidr" /
    "fp_cidr" -> (routes, ACL) tables of route_nets(n_routes) and
    acl_rules(n_acl)."""
    from vproxy_tpu_torch.ops import fphash as FP
    from vproxy_tpu_torch.ops import hashmatch as H
    if kind in ("hint", "fp_hint"):
        comp = H.compile_hint_hash_sharded if kind == "hint" \
            else FP.compile_hint_fp_sharded
        return comp(mk_rules(n_rules), s)
    comp = H.compile_cidr_hash_sharded if kind == "cidr" \
        else FP.compile_cidr_fp_sharded
    acl = acl_rules(n_acl, ACL_SEED)
    return (comp(route_nets(n_routes, ROUTE_SEED), s),
            comp([r.network for r in acl], s, acl=acl))


def sharded_start(n_rules=N_RULES, n_routes=N_ROUTES, n_acl=N_ACL,
                  shards=tuple(SHARD_MESH), workers=SHARDED_WORKERS):
    """Start every sharded compile in spawned worker processes, the
    longest first. -> (pool, {(kind, S): future}); sharded_tables
    collects them and shuts the pool down."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    order = sorted(((k, s) for s in shards for k in SHARD_KINDS),
                   key=lambda ks: (ks[0] not in ("cidr", "fp_cidr"),
                                   -ks[1], ks[0]))
    return pool, {ks: pool.submit(sharded_compile, *ks, n_rules, n_routes,
                                  n_acl) for ks in order}


def sharded_device(stab, kind: str, device):
    """A stacked table on `device`: -> (raw arrays, B8's table). On the
    card B8 reads the packed cuckoo stack (pack_*_sharded) or the
    fingerprint arrays, prepared; on the CPU both are the raw arrays."""
    from vproxy_tpu_torch.ops import sharded_cuda as SC
    from vproxy_tpu_torch.utils.torchenv import tables_from_reference
    raw = tables_from_reference(stab.arrays, device)
    if device.type != "cuda":
        return raw, raw
    if kind in ("hint", "cidr"):
        pack = SC.pack_hint_sharded if kind == "hint" else \
            SC.pack_cidr_sharded
        prep = SC.prepare_hint if kind == "hint" else SC.prepare_cidr
        return raw, prep(tables_from_reference(pack(stab.arrays), device))
    prep = SC.prepare_fp_hint if kind == "fp_hint" else SC.prepare_fp_cidr
    return raw, prep(raw)


def sharded_tables(device, pool, futs, n_rules=N_RULES, n_routes=N_ROUTES,
                   n_acl=N_ACL) -> dict:
    """Collect the compiles and put them on `device`, with the rule lists
    and their host indexes. -> {"rules", "nets", "acl", "hidx", "ridx",
    "aidx", (kind, S): table dict}; a CIDR kind holds "routes" and
    "acl" tables."""
    from vproxy_tpu_torch.parallel import mesh as M
    from vproxy_tpu_torch.rules.index import CidrIndex, HintIndex
    t0 = time.monotonic()
    out = {"rules": mk_rules(n_rules), "nets": route_nets(n_routes,
                                                          ROUTE_SEED),
           "acl": acl_rules(n_acl, ACL_SEED)}
    out["hidx"] = HintIndex(out["rules"])
    out["ridx"] = CidrIndex(out["nets"])
    out["aidx"] = CidrIndex([r.network for r in out["acl"]], acl=out["acl"])
    t1 = time.monotonic()
    try:
        for (kind, s), fut in futs.items():
            got = fut.result(timeout=900)
            t = {"mesh": M.make_mesh(SHARD_MESH.get(s, 2 * s), batch=2,
                                     device=device)}
            parts = {"hint": got} if kind in ("hint", "fp_hint") else \
                {"routes": got[0], "acl": got[1]}
            for name, stab in parts.items():
                raw, kern = sharded_device(stab, kind, device)
                t[name] = {"stab": stab, "raw": raw, "kern": kern,
                           "size": stab.shard_size}
            out[(kind, s)] = t
    finally:
        pool.shutdown()
    caps = {k: v["hint" if k[0] in ("hint", "fp_hint") else "routes"][
        "stab"].shards[0].caps for k, v in out.items()
        if isinstance(k, tuple)}
    log(f"sharded tables: host indexes {t1 - t0:.1f} s, compiles waited "
        f"on {time.monotonic() - t1:.1f} s; caps "
        f"{ {f'{k} S={s}': c for (k, s), c in caps.items()} }")
    return out


def sharded_hint_batch(stab, hints, b: int, mesh, fp: bool):
    """A hint batch of b rows (pad rows past `hints`) for every shard of
    `stab`: the engine's encode, then mesh.shard_hint_queries_sharded."""
    from vproxy_tpu_torch.ops import fphash as FP
    from vproxy_tpu_torch.ops import hashmatch as H
    from vproxy_tpu_torch.parallel import mesh as M
    from vproxy_tpu_torch.rules.ir import Hint
    if fp:
        q = FP.encode_hint_queries_fp_sharded(
            list(hints) + [Hint()] * (b - len(hints)), stab)
    else:
        q = H.encode_hint_queries_sharded(hints, stab, pad_to=b)
    return M.shard_hint_queries_sharded(q, mesh)


def b8_case(tabs, kind: str, s: int, b: int, seed: int, part=None,
            mod=None, key: str = "kern", layout: str = "auto"):
    """One B8 batch of b rows (an eighth of them pad rows) at S shards.
    -> (kern(), plain(), host answers of the real rows, work(), name):
    kern and plain compute the same int32 [b]. kern launches `mod`'s
    entry (ops/sharded_cuda.py by default) on the table under `key`;
    with a `layout` other than "auto", B8 in that layout
    (sharded_cuda.LAYOUTS)."""
    from vproxy_tpu_torch.ops import sharded_cuda as SC
    mod = mod or SC
    t = tabs[(kind, s)]
    n = b - b // 8
    fp = kind.startswith("fp_")
    if kind in ("hint", "fp_hint"):
        tt = t["hint"]
        hints = mk_queries(tabs["rules"], n, seed)
        q = sharded_hint_batch(tt["stab"], hints, b, t["mesh"], fp)
        host = [tabs["hidx"].lookup(h) for h in hints]

        def kern():
            if layout != "auto":
                return mod.sharded_cuda((tt[key], q, tt["size"]),
                                        layout=layout)[:, 0]
            return mod.hint_sharded(tt[key], q, tt["size"], fp=fp)

        def plain():
            return SC.finish_plain(SC.hint_keys_plain(tt["raw"], q,
                                                      tt["size"], fp=fp))

        def shard(j):
            qj = SC.shard_view(q, j, q.stacked)
            return fp_hint_work(SC.shard_view(tt["raw"], j), qj, io=False) \
                if fp else work(SC.shard_view(tt["kern"], j), qj, io=False)
        io = sum(v.numel() * v.element_size() for v in q.values()) + b * 4
        return kern, plain, host, lambda: b8_work(shard, s, io), \
            f"{kind} S={s}"
    tt = t[part]
    if part == "routes":
        qs = [(a, None) for a, _ in cidr_queries(tabs["nets"], n, seed)]
        host = [tabs["ridx"].lookup(a, None) for a, _ in qs]
    else:
        qs = acl_queries(tabs["acl"], n, seed)
        host = [tabs["aidx"].lookup(a, p) for a, p in qs]
    a16, fam, port = cidr_batch(qs, b, t["mesh"].device)

    def kern():
        if layout != "auto":
            return mod.sharded_cuda(cidr=[(tt[key], a16, fam, port,
                                           tt["size"])], layout=layout)[:, 0]
        return mod.cidr_sharded(tt[key], a16, fam, port, tt["size"], fp=fp)

    def plain():
        return SC.finish_plain(SC.cidr_keys_plain(tt["raw"], a16, fam, port,
                                                  tt["size"], fp=fp))

    def shard(j):
        return fp_cidr_work(SC.shard_view(tt["raw"], j), a16, fam, port,
                            io=False) if fp else \
            cidr_work(SC.shard_view(tt["kern"], j), a16, fam, port, io=False)
    return kern, plain, host, lambda: b8_work(shard, s, cidr_io_bytes(
        b, port)), f"{kind} {part} S={s}"


def pick_bytes(b: int, slots) -> int:
    """The bytes a Maglev column adds to a folded kernel's bound: b
    int64 slots read and b int32 picks written (12 a flow), and each
    distinct table entry the clipped slots gather (4 each)."""
    return b * 12 + 4 * int(torch.unique(slots.clamp(0, MAGLEV_M - 1))
                            .numel())


def b8_pick_fns(tabs, kind: str, s: int, b: int, seed: int) -> tuple:
    """B8 with its Maglev column (kind "hint" or "fp_hint") on one batch
    of b rows (an eighth of them pad rows) at S shards. -> (kern(),
    plain(), host verdicts [b], mcol, work(), q): kern the entry
    (sharded_cuda.hint_pick_sharded), plain its plain version; both
    int32 [b, 2]."""
    from vproxy_tpu_torch.ops import sharded_cuda as SC
    t = tabs[(kind, s)]
    tt = t["hint"]
    fp = kind == "fp_hint"
    n = b - b // 8
    hints = mk_queries(tabs["rules"], n, seed)
    q = sharded_hint_batch(tt["stab"], hints, b, t["mesh"], fp)
    host = torch.tensor([tabs["hidx"].lookup(h) for h in hints] +
                        [-1] * (b - n), dtype=torch.int32)
    mcol = maglev_column(b, t["mesh"].device, seed + 1, b // 8)

    def kern():
        return SC.hint_pick_sharded(tt["kern"], q, tt["size"], *mcol, fp=fp)

    def plain():
        return SC.hint_pick_plain(tt["raw"], q, tt["size"], *mcol, fp=fp)

    def work_():
        w = b8_case(tabs, kind, s, b, seed)[3]()
        return w[0] + pick_bytes(b, mcol[1]), w[1]
    return kern, plain, host, mcol, work_, q


def b8_pick_case(tabs, kind: str, s: int, b: int, seed: int,
                 device) -> int:
    """B8 with its Maglev column (b8_pick_fns) int32-exact against its
    plain version, its verdict column against the host index and its
    pick column against the host table: the launcher's layout, and on
    the card each forced layout and the keys path (finish=False, the
    picks written rank-locally, then finish_cuda into the same rows).
    -> the checks made."""
    from vproxy_tpu_torch.ops import sharded_cuda as SC
    kern, plain, host, mcol, _, q = b8_pick_fns(tabs, kind, s, b, seed)
    tt = tabs[(kind, s)]["hint"]
    ref = plain().cpu()
    cpu_col = (mcol[0].cpu(), mcol[1].cpu())
    if device.type != "cuda":
        pick_vs_plain(f"B8 {kind} pick S={s} B={b}", ref, ref, host,
                      cpu_col)
        return 1
    runs = [("auto", kern)]
    runs += [(lay, lambda lay=lay: SC.sharded_cuda(
        (tt["kern"], q, tt["size"]), layout=lay, pick=mcol))
        for lay in ("split", "interleaved")]

    def keys_path():
        out = torch.empty((b, 2), dtype=torch.int32, device=device)
        keys = SC.sharded_cuda((tt["kern"], q, tt["size"]), finish=False,
                               pick=mcol, out=out)
        return SC.finish_cuda(keys, out)
    runs.append(("keys + finish", keys_path))
    for label, fn in runs:
        got = fn().cpu()
        pick_vs_plain(f"B8 {kind} pick S={s} B={b} {label}", got, ref,
                      host, cpu_col)
    return len(runs)


def b8_work(shard, s: int, io: int) -> tuple:
    """B8's (bytes, ops) for one batch: the distinct bytes, so the
    batch's query arrays and its int32 answers once (`io`: a query
    array every shard shares is read once, a per-shard one once per
    shard), then each of the s shards' table rows and ops (shard(j),
    which counts no query or answer bytes)."""
    nbytes, ops = io, 0
    for j in range(s):
        w = shard(j)
        nbytes, ops = nbytes + w[0], ops + w[1]
    return nbytes, ops


def b8_cases(tabs):
    """-> every (kind, S, part) the sharded kernels phase checks."""
    for kind in SHARD_KINDS:
        for s in sorted({k[1] for k in tabs if isinstance(k, tuple) and
                         k[0] == kind}, reverse=True):
            for part in ((None,) if kind in ("hint", "fp_hint")
                         else ("routes", "acl")):
                yield kind, s, part


def phase_sharded_kernels(device, tabs, buckets=SHARDED_BUCKETS,
                          time_batches=TIME_BATCHES, timed=True) -> dict:
    """B8 against its plain version and the host index at every bucket
    (int32-exact; -1 on each pad row and miss), at S = 4 and S = 1, on
    the cuckoo and fingerprint tables of configurations (a) and (b),
    and the tie and late-wildcard cases against the linear oracle
    (sharded_case_checks), and on the card each batch again in both
    forced layouts; the hint kinds with their Maglev column
    (b8_pick_case) at the time_batches among the buckets and the
    largest; then timed at S = 4 (time_batches) and S = 1 (B = 512),
    warm and cold, with the bound summed over the shards, the hint kinds
    also with their Maglev column. -> {"max_abs_err", "checks",
    "case_checks", "layout_checks", "pick_checks", "rows": {case:
    rows}}."""
    from vproxy_tpu_torch.ops import sharded_cuda as SC
    on_card = device.type == "cuda"
    saved = (SC.sharded_cuda.launches, SC.sharded_cuda.pick_launches,
             SC.finish_cuda.launches)
    err, checks, layout_checks, pick_checks = 0, 0, 0, 0
    for kind, s, part in b8_cases(tabs):
        for b in buckets:
            # the Maglev column at the timed batch sizes (within the
            # buckets given)
            if kind in ("hint", "fp_hint") and (
                    b in time_batches or b == max(buckets)):
                pick_checks += b8_pick_case(tabs, kind, s, b, 3200 + b,
                                            device)
            kern, plain, host, _, name = b8_case(tabs, kind, s, b,
                                                 seed=3000 + b, part=part)
            n0 = SC.sharded_cuda.launches
            k = kern()
            check(SC.sharded_cuda.launches - n0 == (1 if on_card else 0),
                  f"B8 {name} B={b}: not one launch")
            p = plain()
            check(k.dtype == p.dtype == torch.int32 and k.shape == (b,),
                  f"B8 {name} B={b}: dtype or shape")
            kh, ph = k.cpu(), p.cpu()
            e = int((kh.long() - ph.long()).abs().max())
            n = len(host)
            hv = torch.tensor(host + [-1] * (b - n), dtype=torch.int32)
            e = max(e, int((kh.long() - hv.long()).abs().max()))
            check(e == 0, f"B8 {name} B={b}: max |kernel - plain, host| "
                  f"= {e}")
            err, checks = max(err, e), checks + 1
            for layout in (("split", "interleaved") if on_card else ()):
                kl = b8_case(tabs, kind, s, b, seed=3000 + b, part=part,
                             layout=layout)[0]().cpu()
                check(torch.equal(kl, kh), f"B8 {name} B={b}: the {layout} "
                      f"layout != the plain version")
                layout_checks += 1
    log(f"sharded kernels: {checks} batches int32-exact against the plain "
        f"version and the host index; {layout_checks} more in a forced "
        f"layout (split, interleaved); {pick_checks} with the Maglev "
        f"column (every layout, and the keys path with its finish pass)")
    cases = sharded_case_checks(device)
    log(f"sharded kernels: the tie and late-wildcard cases, {cases} "
        f"batches, equal to the linear oracle")
    rows = {}
    if on_card and timed:
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
        for kind, s, part in b8_cases(tabs):
            for b in (time_batches if s == max(SHARD_MESH) else
                      (SERVICE_BATCH,)):
                kern, plain, _, work_, name = b8_case(tabs, kind, s, b,
                                                      seed=3500 + b,
                                                      part=part)
                rows.setdefault(name, []).append(time_row(
                    b, kern, plain, KERNEL_B8, flush, work_(), iters=100,
                    cold_iters=30, plain_iters=5))
                log(f"  B8 {name} B={b}: {json.dumps(rows[name][-1])}")
                if kind in ("hint", "fp_hint"):  # with its Maglev column
                    kern, plain, _, _, work_, _ = b8_pick_fns(
                        tabs, kind, s, b, 3500 + b)
                    rows.setdefault(f"{name} pick", []).append(time_row(
                        b, kern, plain, KERNEL_B8, flush, work_(),
                        iters=100, cold_iters=30, plain_iters=5))
                    log(f"  B8 {name} pick B={b}: "
                        f"{json.dumps(rows[name + ' pick'][-1])}")
    # the checks are not the main path
    (SC.sharded_cuda.launches, SC.sharded_cuda.pick_launches,
     SC.finish_cuda.launches) = saved
    return {"max_abs_err": err, "checks": checks, "case_checks": cases,
            "layout_checks": layout_checks, "pick_checks": pick_checks,
            "rows": rows}


@contextlib.contextmanager
def worker_compiles(tabs: dict, s: int):
    """While open, the four compile_*_sharded functions answer the calls
    the spawned workers already made (sharded_compile: tabs' rules,
    routes or ACL, S = s, no caps) with the workers' tables, and compile
    any other call. -> the list of (function, rule count) it answered;
    the matchers upload, pack and prepare these tables as their own."""
    from vproxy_tpu_torch.ops import fphash as FP
    from vproxy_tpu_torch.ops import hashmatch as H
    nets, acl = tabs["nets"], tabs["acl"]
    made = {}
    for kind, mod, part in (("hint", H, "hint"), ("fp_hint", FP, "hint"),
                            ("cidr", H, "cidr"), ("fp_cidr", FP, "cidr")):
        name = f"compile_{part}_{'fp' if mod is FP else 'hash'}_sharded"
        t = tabs[(kind, s)]
        made[(mod, name)] = [(tabs["rules"], None, t["hint"]["stab"])] \
            if part == "hint" else [
                (nets, None, t["routes"]["stab"]),
                ([r.network for r in acl], acl, t["acl"]["stab"])]
    used = []

    def wrap(real, name, entries):
        def compile_(items, n_shards, acl=None, caps=None):
            for want, want_acl, stab in entries:
                if n_shards == s and caps is None and acl == want_acl and \
                        list(items) == want:
                    used.append((name, len(want)))
                    return stab
            return real(items, n_shards, **({} if acl is None else
                                            {"acl": acl}), caps=caps)
        return compile_
    real = {k: getattr(*k) for k in made}
    try:
        for (mod, name), entries in made.items():
            setattr(mod, name, wrap(real[(mod, name)], name, entries))
        yield used
    finally:
        for (mod, name), f in real.items():
            setattr(mod, name, f)


def sharded_service_tables(device, tabs: dict, unsharded=None,
                           n=8) -> dict:
    """The sharded_service phase's matchers on make_mesh(n, batch=2) (S
    = n / 2), on sharded_tables' rules at their full size: per backend a
    HintMatcher, a FusedPair over it and a Maglev table, a route
    CidrMatcher and an ACL CidrMatcher, each taking the workers'
    compile of its rules (worker_compiles); the rule lists; and the
    unsharded "torch" matchers whose checksums they must equal
    (`unsharded`: {"hint", "routes"} matchers an earlier phase built on
    the same rules, else built here)."""
    from vproxy_tpu_torch.parallel import mesh as M
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules import maglev as MG
    t0 = time.monotonic()
    rules, nets, acl = tabs["rules"], tabs["nets"], tabs["acl"]
    mesh = M.make_mesh(n, batch=2, device=device)
    mm = MG.MaglevMatcher(backends(), m=MAGLEV_M, device=device)
    un = dict(unsharded or {})
    if "hint" not in un:
        un["hint"] = E.HintMatcher(rules, backend="torch", device=device)
    if "routes" not in un:
        un["routes"] = E.CidrMatcher(nets, backend="torch", device=device)
    un["acl"] = E.CidrMatcher([r.network for r in acl], acl=acl,
                              backend="torch", device=device)
    check(un["hint"].rules == rules and un["routes"].snapshot()[1] == nets,
          "the unsharded matchers hold other rules")
    out = {"rules": rules, "nets": nets, "acl": acl, "mesh": mesh,
           "mm": mm, "unsharded": un}
    with worker_compiles(tabs, n // 2) as used:
        for be in E.SHARDED_BACKENDS:
            hm = E.HintMatcher(rules, backend=be, mesh=mesh)
            out[be] = {"hm": hm, "pair": MG.FusedPair(hm, mm),
                       "routes": E.CidrMatcher(nets, backend=be, mesh=mesh),
                       "acl": E.CidrMatcher([r.network for r in acl],
                                            acl=acl, backend=be, mesh=mesh)}
    check(len(used) == 3 * len(E.SHARDED_BACKENDS),
          f"the sharded matchers compiled in process: took only {used}")
    log(f"sharded service tables: {time.monotonic() - t0:.1f} s "
        f"({len(rules)} rules, {len(nets)} routes, {len(acl)} ACL rules, "
        f"S = {mesh.shape['rules']}; the workers' compiles: {used})")
    return out


def phase_sharded_service(device, tabs, bursts=BURSTS,
                          burst=SERVICE_BATCH) -> dict:
    """The sharded backends' main path through ClassifyService in
    "device" mode, at S = 4: per backend bursts x burst submit_hint,
    submit_classify_pick on the FusedPair (B8 with its Maglev column:
    one launch a batch) and submit_cidr on the routes and on the ACL
    with ports. Every answer equal to the host index (HintIndex +
    maglev.pick, CidrIndex); one B8 launch per hint, cpick or cidr
    batch (the cpick ones with the Maglev column), no B5 launch and no
    `_device_take` call, no other kernel, the plain versions never on
    CUDA tensors, no failover; on the card, a hint, a cpick and a cidr
    dispatch each make one B8 launch and no fill or memset before it
    (the profiler); each matcher's checksum() equal to the unsharded
    matcher's on the same rules. -> the phase's numbers."""
    from vproxy_tpu_torch.ops import cidr_cuda as CC
    from vproxy_tpu_torch.ops import dense_cuda as DC
    from vproxy_tpu_torch.ops import fphash as FP
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    from vproxy_tpu_torch.ops import fused_cuda as FC
    from vproxy_tpu_torch.ops import hashmatch as H
    from vproxy_tpu_torch.ops import sharded_cuda as SC
    from vproxy_tpu_torch.ops import take_cuda as TC
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules import maglev as MG
    from vproxy_tpu_torch.rules.service import ClassifyService
    on_card = device.type == "cuda"
    mm = tabs["mm"]
    msnap = mm.snapshot()
    un = tabs["unsharded"]
    others = (FC.fused_classify_pick_cuda, FC.hint_match_cuda,
              CC.cidr_first_cuda, FPC.hint_fp_cuda, FPC.cidr_fp_cuda,
              DC.hint_dense_cuda, DC.cidr_dense_cuda)
    out = {}
    for be in E.SHARDED_BACKENDS:
        t = tabs[be]
        hm, pair, routes, am = t["hm"], t["pair"], t["routes"], t["acl"]
        for name, m, u in (("hint", hm, un["hint"]),
                           ("routes", routes, un["routes"]),
                           ("acl", am, un["acl"])):
            check(m.checksum() == u.checksum() and m.backend == be,
                  f"{be} {name} checksum {m.checksum():#x} != unsharded "
                  f"{u.checksum():#x}")
            check(m._mesh.shape["rules"] == tabs["mesh"].shape["rules"],
                  f"{be} {name}: not on the phase's mesh")
        hsnap, rsnap, asnap = hm.snapshot(), routes.snapshot(), am.snapshot()
        other0 = [f.launches for f in others]
        ClassifyService.reset()
        svc = ClassifyService.get()
        svc.mode = "device"
        try:
            # the main path's counts, read just after it
            SC.sharded_cuda.launches = SC.finish_cuda.launches = 0
            SC.sharded_cuda.pick_launches = 0
            TC.maglev_take_cuda.launches = MG._device_take.calls = 0
            H.hint_hash_match.cuda_calls = FP.hint_fp_match.cuda_calls = 0
            l0 = E.dispatch_launches_total()
            walls, lat = {}, []
            t0 = time.monotonic()
            for k in range(bursts):
                hints = mk_queries(tabs["rules"], burst, seed=4200 + k)
                got = _answers(svc, lambda h, cb: svc.submit_hint(hm, h, cb),
                               [(h,) for h in hints])
                for i, h in enumerate(hints):
                    check(got[i] == (hm.index_snap(hsnap, h),),
                          f"{be} hint burst {k} row {i}")
            walls["hint_s"] = time.monotonic() - t0
            t0 = time.monotonic()
            for k in range(bursts):
                hints = mk_queries(tabs["rules"], burst, seed=4300 + k)
                ips = mk_ips(burst, seed=4400 + k)
                ports = [None if i % 3 == 0 else 1024 + i
                         for i in range(burst)]
                got = _answers(
                    svc, lambda h, ip, port, cb: svc.submit_classify_pick(
                        pair, h, ip, port, cb),
                    list(zip(hints, ips, ports)), lat)
                for i in range(burst):
                    want = (hm.index_snap(hsnap, hints[i]),
                            MG.pick(msnap[0], ips[i], ports[i]))
                    check(got[i] == want, f"{be} cpick burst {k} row {i}: "
                          f"{got[i]} != host {want}")
            walls["cpick_s"] = time.monotonic() - t0
            t0 = time.monotonic()
            for k in range(bursts):
                rq = [(a, None) for a, _ in
                      cidr_queries(tabs["nets"], burst, 4500 + k)]
                got = _answers(svc, lambda a, p, cb: svc.submit_cidr(
                    routes, a, p, cb), rq)
                for i, (a, _) in enumerate(rq):
                    check(got[i] == (routes.index_snap(rsnap, a, None),),
                          f"{be} route burst {k} row {i}")
                aq = acl_queries(tabs["acl"], burst, 4600 + k)
                got = _answers(svc, lambda a, p, cb: svc.submit_cidr(
                    am, a, p, cb), aq)
                for i, (a, p) in enumerate(aq):
                    check(got[i] == (am.index_snap(asnap, a, p),),
                          f"{be} ACL burst {k} row {i}")
            walls["cidr_s"] = time.monotonic() - t0
            st = svc.stats
            batches = {k: st.by_kind.get(k, [0])[0] for k in
                       ("hint", "cpick", "cidr")}
            n = bursts * burst
            launches = {"sharded_match": SC.sharded_cuda.launches,
                        "sharded_match_pick": SC.sharded_cuda.pick_launches,
                        "sharded_finish": SC.finish_cuda.launches,
                        "maglev_take": TC.maglev_take_cuda.launches}
            check(st.failovers == 0, f"{be}: {st.failovers} failovers")
            check(st.device_queries == 4 * n and st.oracle_queries == 0,
                  f"{be}: device answered {st.device_queries} of {4 * n}")
            check(all(v > 0 for v in batches.values()),
                  f"{be}: a kind formed no batch: {batches}")
            check(launches["sharded_match"] == (sum(batches.values())
                                                if on_card else 0),
                  f"{be}: B8 launches {launches['sharded_match']} != "
                  f"batches {batches}")
            check(launches["sharded_finish"] == 0,
                  f"{be}: a one-process mesh reduced across ranks")
            check(launches["sharded_match_pick"] == (batches["cpick"]
                                                     if on_card else 0),
                  f"{be}: B8 launches with the Maglev column "
                  f"{launches['sharded_match_pick']} != cpick batches "
                  f"{batches}")
            check(MG._device_take.calls == 0 and
                  launches["maglev_take"] == 0,
                  f"{be}: a cpick batch took the Maglev take: "
                  f"{MG._device_take.calls} _device_take calls, "
                  f"{launches['maglev_take']} B5 launches")
            check(E.dispatch_launches_total() - l0 == batches["hint"] +
                  batches["cpick"] + batches["cidr"],
                  f"{be}: engine launches != hint + cpick + cidr")
            check([f.launches for f in others] == other0,
                  f"{be}: the sharded path launched another kernel")
            check(not on_card or H.hint_hash_match.cuda_calls ==
                  FP.hint_fp_match.cuda_calls == 0,
                  f"{be}: a plain tier ran on CUDA tensors")
            if on_card:  # B8 with its output: no fill kernel before it
                hints = mk_queries(tabs["rules"], burst, seed=4700)
                addrs = [a for a, _ in cidr_queries(tabs["nets"], burst,
                                                    4701)]
                rows = list(zip(hints, mk_ips(burst, seed=4702),
                                [None] * burst))
                psnap = pair.snapshot()
                for what, call in (
                        ("hint", lambda: hm.dispatch_snap(hsnap, hints)),
                        ("cpick", lambda: pair.dispatch_snap(psnap, rows)),
                        ("cidr", lambda: routes.dispatch_snap(rsnap, addrs,
                                                              None))):
                    fills = aten_fills(call)
                    check(not fills, f"{be} {what}: a fill in the batch's "
                          f"call: {fills}")
                    seq = device_activities(call, KERNEL_B8)
                    check(sum(KERNEL_B8 in n for n in seq) <= 10 and
                          not any("fill" in n.lower() or
                                  "memset" in n.lower() for n in seq),
                          f"{be} {what}: a fill or memset on the card, or "
                          f"more than one B8 a call: {seq}")
            out[be] = {"queries": 4 * n, "batches": batches,
                       "launches": launches,
                       "maglev_takes": MG._device_take.calls,
                       "failovers": st.failovers, "max_batch": st.max_batch,
                       "checksums": {"hint": hm.checksum(),
                                     "routes": routes.checksum(),
                                     "acl": am.checksum()},
                       "table_bytes": {"hint": hm.published_table_bytes(),
                                       "routes":
                                           routes.published_table_bytes(),
                                       "acl": am.published_table_bytes()},
                       **walls, "cpick_latency": lat_ms(lat),
                       "classify_latency": st.latency_percentiles()}
            log(f"sharded service {be}: {json.dumps(out[be])}")
        finally:
            ClassifyService.reset()
    return out


# --------------------------------------------- classify+pick batches
#
# Since B5's take is the Maglev column of B6, B8 and B9, a classify+pick
# batch of an unfused backend is ONE launch of its hint kernel; the
# parent served it with the two-dispatch chain (the verdict-only
# dispatch, then MaglevMatcher.dispatch_snap: the slots' own copy and
# B5, then both pulled), which FusedPair keeps for the "host" backend
# and which MaglevMatcher.dispatch_snap still is for a standalone pick.


def cpick_window(fn, calls: int = 20) -> dict:
    """Every device activity of `calls` calls of fn profiled together
    (torch.profiler): per call, the device us of all of them (kernels,
    copies and memsets summed) and how many of each there were, with
    the names seen. CUPTI drops records now and then, so a profile that
    saw fewer than one kernel a call is run again, up to five times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kinds = {"kernels": 0, "h2d": 0, "d2h": 0, "memsets": 0}
        us, names = 0.0, {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            k = ("h2d" if "HtoD" in e.name else "d2h" if "DtoH" in e.name
                 else "memsets" if "Memset" in e.name else "kernels")
            kinds[k] += 1
            us += e.time_range.elapsed_us()
            names[e.name] = names.get(e.name, 0) + 1
        if kinds["kernels"] >= calls:
            return {"device_us": us / calls,
                    **{k: v / calls for k, v in kinds.items()},
                    "names": names}
        log(f"profiler saw {kinds['kernels']} kernels in {calls} cpick "
            f"batches; profiling again")
    raise RuntimeError("chip smoke failed: the profiler lost the cpick "
                       "batches' kernels in five runs")


def wall_ms(fn, calls: int = 50, reps: int = 3) -> float:
    """Host ms per call of fn over `calls` calls back to back (each ends
    on the host: a pull), the least of `reps` runs."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e3)
    return best


def phase_cpick(device, pairs: dict, b=SERVICE_BATCH, calls=10,
                timed=True) -> list:
    """A classify+pick batch of b rows (every third source affinity) on
    each unfused backend (`pairs`: backend -> (FusedPair, its rules)),
    as FusedPair.dispatch_snap serves it (one launch) against the
    two-dispatch chain the parent served it with, each pulled to the
    host: both held equal to the host index + maglev.pick, one engine
    launch against two; then per path, in turns (chain, one, one,
    chain), the device time a batch from one profiler window of `calls`
    batches (kernels, copies and memsets summed, and counted), the wall
    ms a batch back to back with its pull (host clock), and the wall ms
    of the dispatch call alone (CUDA events; a sharded batch pulls
    inside it); timed=False: the checks alone. Launch counts are
    restored after. -> rows."""
    from vproxy_tpu_torch.ops import dense_cuda as DC
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    from vproxy_tpu_torch.ops import sharded_cuda as SC
    from vproxy_tpu_torch.ops import take_cuda as TC
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules import maglev as M
    from vproxy_tpu_torch.utils.torchenv import to_host
    counters = [(f, a) for f in (FPC.hint_fp_cuda, DC.hint_dense_cuda,
                                 SC.sharded_cuda)
                for a in ("launches", "pick_launches")] + [
        (TC.maglev_take_cuda, "launches"), (M._device_take, "calls")]
    saved = [getattr(f, a) for f, a in counters]
    rows = []
    for be, (pair, rules) in pairs.items():
        hm, mm = pair.hm, pair.mm
        hints = mk_queries(rules, b, seed=5100)
        ips = mk_ips(b, seed=5101)
        ports = [None if i % 3 == 0 else 1024 + i for i in range(b)]
        payloads = list(zip(hints, ips, ports))
        snap = pair.snapshot()
        hsnap, msnap = snap
        sync = be in E.SHARDED_BACKENDS

        def one_call():
            return pair.dispatch_snap(snap, payloads, pad_to=b, sync=sync)

        def chain_call():
            v = hm.dispatch_snap(hsnap, hints, pad_to=b, sync=sync)
            return M._LazyPairRows(v, mm.dispatch_snap(msnap, ips, ports),
                                   b)

        def one():
            return to_host(one_call())[:b]

        def chain():
            return np.asarray(chain_call())
        want = np.array([[hm.index_snap(hsnap, h), M.pick(msnap[0], ip, p)]
                         for h, ip, p in payloads], np.int32)
        l0 = E.dispatch_launches_total()
        got = one()
        l1 = E.dispatch_launches_total()
        old = chain()
        l2 = E.dispatch_launches_total()
        check(np.array_equal(got, want) and np.array_equal(old, want),
              f"{be}: a cpick batch (one launch or the chain) != host")
        check(l1 - l0 == 1 and l2 - l1 == 2, f"{be}: engine launches "
              f"{l1 - l0} (one launch) and {l2 - l1} (the chain)")
        if not timed:
            rows.append({"backend": be, "batch": b})
            continue
        w = [cpick_window(f, calls) for f in (chain, one, one, chain)]
        row = {"backend": be, "batch": b,
               "one": {"device_us": [w[1]["device_us"], w[2]["device_us"]],
                       **{k: w[1][k] for k in ("kernels", "h2d", "d2h",
                                               "memsets", "names")}},
               "chain": {"device_us": [w[0]["device_us"],
                                       w[3]["device_us"]],
                         **{k: w[0][k] for k in ("kernels", "h2d", "d2h",
                                                 "memsets", "names")}},
               "wall_ms": {"chain": wall_ms(chain, 20), "one": wall_ms(one, 20)},
               "dispatch_call_ms": {"chain": call_ms(chain_call, 20, 3),
                                    "one": call_ms(one_call, 20, 3)}}
        row["wall_ms"]["one_again"] = wall_ms(one, 20)
        row["wall_ms"]["chain_again"] = wall_ms(chain, 20)
        row["device_saved_us"] = min(row["chain"]["device_us"]) - min(
            row["one"]["device_us"])
        rows.append(row)
        log("cpick " + json.dumps(row))
    for (f, a), n in zip(counters, saved):
        setattr(f, a, n)
    return rows


def phase_maglev(device, mm, bursts=BURSTS, b=SERVICE_BATCH) -> dict:
    """B5's main path since the classify+pick batches fold it into their
    hint kernels: standalone Maglev batches through MaglevMatcher.match
    (the entry a pick-only caller uses: the flow slots' own copy, then
    B5), bursts x b flows (every third source affinity), every pick
    equal to maglev.pick on the host table; one B5 launch and one
    `_device_take` call a batch. -> the phase's numbers."""
    from vproxy_tpu_torch.ops import take_cuda as TC
    from vproxy_tpu_torch.rules import maglev as M
    tab = mm.snapshot()[0]
    TC.maglev_take_cuda.launches = M._device_take.calls = 0
    t0 = time.monotonic()
    for k in range(bursts):
        ips = mk_ips(b, seed=5200 + k)
        ports = [None if i % 3 == 0 else 1024 + i for i in range(b)]
        got = mm.match(ips, ports)
        check([int(x) for x in got] == [M.pick(tab, ip, p) for ip, p in
                                        zip(ips, ports)],
              f"standalone Maglev batch {k} != maglev.pick")
    wall = time.monotonic() - t0
    out = {"batches": bursts, "launches": TC.maglev_take_cuda.launches,
           "takes": M._device_take.calls, "wall_s": wall}
    check(out["takes"] == bursts and out["launches"] == (
        bursts if device.type == "cuda" else 0),
          f"standalone Maglev batches: {out}")
    log(f"maglev: {json.dumps(out)}")
    return out


# ------------------------------------------------------ the cluster plane
#
# Two nodes of `python -m vproxy_tpu_torch` on loopback, both on the
# card, VPROXY_TPU_CLUSTER_PEERS naming both: the leader builds a config
# by command, the follower converges to its generation and checksum and
# refuses a mutation, then each node's step loop serves queries on the
# card. Nothing in the process entry attaches a step loop (the
# reference's ClusterNode.attach_submit is a library call, as in its
# tools/storm.py and tools/chaos.py), so each child runs the entry
# module with runpy beside a driver thread (CLUSTER_CHILD): when the
# parent writes the go file, the thread attaches the node's StepLoop
# over upstream u0's matcher with a Maglev plane, serves its queries
# (submit, and the fused submit_pick through the FusedPair) and writes
# what it saw.

CLUSTER_BUILD_S = 10.0      # the leader's build budget: every add publishes
CLUSTER_MIN_GROUPS = 64
CLUSTER_MAX_GROUPS = TCPLB_MAX_RULES  # config #2's 10k rules
CLUSTER_QUERIES = 1024      # a node's queries, half of them submit_pick
CLUSTER_BATCH = 64          # the step loop's rows a step
CLUSTER_STEP_MS = 5
CLUSTER_TIMEOUT_MS = 5000   # the barrier and dispatch deadline
CLUSTER_SEED = 91

CLUSTER_CHILD = r"""
import json, os, runpy, sys, threading, time, traceback


def run(cfg):
    import chip_smoke as CS
    from vproxy_tpu_torch.cluster import ClusterNode
    from vproxy_tpu_torch.cluster.submit import StepLoop
    from vproxy_tpu_torch.ops import fused_cuda as FC
    from vproxy_tpu_torch.rules import maglev as MG
    node = ClusterNode._instance
    m = node.app.upstreams["u0"]._matcher
    mm = MG.MaglevMatcher(CS.backends(), m=CS.MAGLEV_M, device=m.device)
    hsnap, msnap = m.snapshot(), mm.snapshot()
    n, seed = cfg["queries"], cfg["seed"] + node.self_id
    hints = CS.mk_queries(m.rules, n, seed)
    ips = CS.mk_ips(n, seed)
    ports = [None if i % 3 == 0 else 1024 + i for i in range(n)]
    FC.fused_classify_pick_cuda.launches = FC.hint_match_cuda.launches = 0
    # every device dispatch: (the step that made it, 0 for the warm-up;
    # the B1 launches it made)
    disp, real = [], StepLoop._device_dispatch

    def counted(self, items):
        n0 = FC.fused_classify_pick_cuda.launches
        try:
            return real(self, items)
        finally:
            disp.append((self.steps_total,
                         FC.fused_classify_pick_cuda.launches - n0))
    StepLoop._device_dispatch = counted
    loop = node.attach_submit(m, maglev=mm, step_ms=cfg["step_ms"],
                              batch_cap=cfg["batch"],
                              timeout_ms=cfg["timeout_ms"])
    got, left, lock = [None] * n, [n], threading.Lock()
    done = threading.Event()

    def fin(i, v):
        got[i] = v
        with lock:
            left[0] -= 1
            if not left[0]:
                done.set()

    steps0, t0 = loop.steps_total, time.monotonic()
    for i in range(n):
        if i % 2:
            loop.submit_pick(hints[i], ips[i], ports[i],
                             lambda v, p, pl, i=i: fin(i, [v, p]))
        else:
            loop.submit(hints[i], lambda v, pl, i=i: fin(i, [v]))
    done.wait(120)
    wall = time.monotonic() - t0
    bad = 0
    for i in range(n):
        want = [m.index_snap(hsnap, hints[i])]
        if i % 2:
            want.append(MG.pick(msnap[0], ips[i], ports[i]))
        bad += got[i] != want
    st = loop.status()
    steps_read = loop.steps_total
    seen = list(disp)
    out = {"node": node.self_id, "answered": n - left[0], "mismatches": bad,
           "wall_s": wall, "steps_total": steps_read,
           "steps_serving": steps_read - steps0,
           "degraded": loop.degraded, "barrier_stalls": loop.barrier_stalls,
           "fused": st["fused"], "epoch": st["epoch"],
           "device": str(m.device), "backend": m.backend,
           "rules": len(m.rules),
           "launches": {"fused_classify_pick":
                        FC.fused_classify_pick_cuda.launches,
                        "hint_match": FC.hint_match_cuda.launches},
           "dispatches": len(seen),
           "dispatch_steps": [d[0] for d in seen] == list(range(len(seen)))
           and seen[-1][0] >= steps_read - 1,
           "b1_per_dispatch": sorted({d[1] for d in seen})}
    # the loop steps on until SIGTERM: a stopped loop still advertises
    # stepping, so a peer still serving would wait for it at the
    # barrier until its deadline degrades it
    return out


def drive():
    go, out = os.environ["SMOKE_CLUSTER_GO"], os.environ["SMOKE_CLUSTER_OUT"]
    while not os.path.exists(go):
        time.sleep(0.02)
    try:
        with open(go) as f:
            res = run(json.load(f))
    except BaseException:
        res = {"error": traceback.format_exc()}
    with open(out + ".tmp", "w") as f:
        json.dump(res, f)
    os.replace(out + ".tmp", out)


threading.Thread(target=drive, daemon=True, name="smoke-driver").start()
sys.argv = ["vproxy_tpu_torch"] + sys.argv[1:]
runpy.run_module("vproxy_tpu_torch", run_name="__main__", alter_sys=True)
"""


def _free_ports(kinds) -> list:
    """One free loopback port of each socket kind, all held open until
    every one is picked, so no two are the same port (the nodes bind
    theirs with SO_REUSEADDR: two of them on one UDP port would both
    succeed and never hear each other)."""
    import socket
    socks = [socket.socket(socket.AF_INET, k) for k in kinds]
    try:
        for s in socks:
            s.bind((LOOPBACK, 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def phase_cluster(device, max_groups=CLUSTER_MAX_GROUPS,
                  min_groups=CLUSTER_MIN_GROUPS, build_s=CLUSTER_BUILD_S,
                  queries=CLUSTER_QUERIES) -> dict:
    """The cluster plane on the card: two nodes of `python -m
    vproxy_tpu_torch` (CLUSTER_CHILD: the entry module under a driver
    thread) on loopback, VPROXY_TPU_CLUSTER_PEERS naming both, each
    with its own VPROXY_TPU_HOME, resp- and http-controller. Both see
    each other UP and agree node 0 leads; the leader builds upstream
    u0 by command, server groups with one Host rule each (tcplb_rules,
    config #2's) until `max_groups` or `build_s` (never under
    `min_groups`: every add republishes); the follower converges to the
    leader's generation and cluster checksum (GET /cluster), with u0's
    matcher checksum equal, and refuses a mutation; then both nodes'
    step loops serve `queries` each (half submit, half the fused
    submit_pick), every answer the host index's (HintIndex +
    maglev.pick), steps_total > 0, not degraded, no barrier stall, one
    B1 launch per device dispatch on the card (the Maglev plane makes
    every step the FusedPair's one launch) and one dispatch for the
    warm-up and each step, in order, none left out (CLUSTER_CHILD
    counts them). SIGTERM: both exit 0. ->
    the phase's numbers."""
    import shutil
    import socket
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="vproxy-cluster-")
    kids, ports = [], []
    try:
        t0 = time.monotonic()
        for attempt in range(3):
            # the peers' ports must be known before either node binds
            # them: picked free here, and a node that loses one to
            # another process fails its boot, so the pair boots again
            # on fresh ports
            free = _free_ports([socket.SOCK_DGRAM, socket.SOCK_STREAM] * 2)
            spec = ",".join(f"{LOOPBACK}:{free[2 * i]}/{free[2 * i + 1]}"
                            for i in range(2))
            try:
                for i in range(2):
                    home = os.path.join(work, f"a{attempt}node{i}")
                    os.makedirs(home)
                    env = {k: v for k, v in os.environ.items()
                           if k not in ("VPROXY_TPU_TORCH_DEVICE",
                                        "VPROXY_TPU_MATCHER")}
                    env.update(PYTHONPATH=root, VPROXY_TPU_HOME=home,
                               VPROXY_TPU_CLUSTER_PEERS=spec,
                               VPROXY_TPU_CLUSTER_SELF=str(i),
                               VPROXY_TPU_CLUSTER_HB_MS="50",
                               VPROXY_TPU_CLUSTER_POLL_MS="100",
                               SMOKE_CLUSTER_GO=os.path.join(work,
                                                             "go.json"),
                               SMOKE_CLUSTER_OUT=os.path.join(
                                   work, f"out{i}.json"))
                    if device.type == "cpu":
                        env["VPROXY_TPU_TORCH_DEVICE"] = "cpu"
                    p, pp = _boot_child(
                        ["noLoadLast", "noSave", "noStdIOController",
                         "resp-controller", f"{LOOPBACK}:0", RESP_PASSWORD,
                         "http-controller", f"{LOOPBACK}:0"], env,
                        os.path.join(home, "stderr.log"),
                        want=("resp-controller", "http-controller"),
                        entry=("-c", CLUSTER_CHILD))
                    kids.append(p)
                    ports.append(pp)
                break
            except RuntimeError:
                for p in kids:
                    p.kill()
                    p.wait(30)
                kids, ports = [], []
                if attempt == 2:
                    raise
        boot_s = time.monotonic() - t0

        def status(i):
            return http_json(ports[i]["http-controller"], "/cluster")

        def wait(pred, what, timeout=60.0):
            deadline = time.monotonic() + timeout
            while not pred():
                check(time.monotonic() < deadline, what)
                time.sleep(0.05)

        wait(lambda: all(sum(p["up"] for p in status(i)["peers"]) == 2
                         for i in range(2)), "the nodes never saw both UP")
        st = [status(i) for i in range(2)]
        check(st[0]["is_leader"] and not st[1]["is_leader"] and
              st[0]["leader"] == st[1]["leader"] == 0,
              f"leadership: {st[0]['leader']} / {st[1]['leader']}")
        leader = Resp(ports[0]["resp-controller"], RESP_PASSWORD)
        follower = Resp(ports[1]["resp-controller"], RESP_PASSWORD)
        n_cmds, t0 = 1, time.monotonic()
        check(leader.cmd("add upstream u0") == "OK", "add upstream")
        rules = tcplb_rules(max_groups, TCPLB_RULE_SEED)
        n = 0
        for i, r in enumerate(rules):
            anno = {"vproxy/hint-host": r.host}
            if r.uri is not None:
                anno["vproxy/hint-uri"] = r.uri
            for line in (
                    f"add server-group g{i} timeout 1000 period 600000 up 1 "
                    "down 1 protocol none",
                    f"add server-group g{i} to upstream u0 weight 10 "
                    f"annotations {json.dumps(anno, separators=(',', ':'))}"):
                check(leader.cmd(line) == "OK", line)
                n_cmds += 1
            n = i + 1
            if n >= min_groups and time.monotonic() - t0 > build_s:
                break
        build_wall = time.monotonic() - t0
        gen = status(0)["generation"]
        check(gen == n_cmds, f"leader generation {gen} != {n_cmds} "
              "replicated commands")
        t1 = time.monotonic()
        wait(lambda: status(1)["generation"] == gen,
             f"the follower never reached generation {gen}", 180.0)
        converge_s = time.monotonic() - t1
        st = [status(i) for i in range(2)]
        check(st[0]["checksum"] == st[1]["checksum"] and
              st[1]["generation_lag"] == 0,
              f"checksums {st[0]['checksum']:#x} / {st[1]['checksum']:#x}")
        ups = [Resp(ports[i]["resp-controller"], RESP_PASSWORD).cmd(
            "list-detail upstream") for i in range(2)]
        try:
            follower.cmd("add upstream u-nope")
            refused = None
        except RuntimeError as e:
            refused = str(e)
        check(refused is not None and "follower" in refused,
              f"the follower accepted a mutation: {refused}")
        check(status(1)["generation"] == gen, "the refusal moved a generation")
        with open(os.path.join(work, "go.json"), "w") as f:
            json.dump({"queries": queries, "seed": CLUSTER_SEED,
                       "step_ms": CLUSTER_STEP_MS, "batch": CLUSTER_BATCH,
                       "timeout_ms": CLUSTER_TIMEOUT_MS}, f)
        outs = []
        for i in range(2):
            path = os.path.join(work, f"out{i}.json")
            wait(lambda: os.path.exists(path),
                 f"node {i}'s driver wrote nothing", 240.0)
            with open(path) as f:
                outs.append(json.load(f))
        on_card = device.type == "cuda"
        for i, o in enumerate(outs):
            check("error" not in o, f"node {i}: {o.get('error')}")
            check(o["answered"] == queries and o["mismatches"] == 0,
                  f"node {i}: {o['answered']} answered, {o['mismatches']} "
                  "differ from the host index")
            check(o["steps_total"] > 0 and not o["degraded"] and
                  o["barrier_stalls"] == 0 and o["fused"],
                  f"node {i}: steps {o['steps_total']}, degraded "
                  f"{o['degraded']}, stalls {o['barrier_stalls']}")
            check(o["device"].startswith(device.type) and
                  o["backend"] == "torch" and o["rules"] == n,
                  f"node {i}: {o['device']} {o['backend']} {o['rules']}")
            check(o["dispatch_steps"] and o["b1_per_dispatch"] ==
                  [1 if on_card else 0] and
                  o["launches"]["fused_classify_pick"] >=
                  (o["dispatches"] if on_card else 0),
                  f"node {i}: {o['dispatches']} dispatches (each step's "
                  f"in order: {o['dispatch_steps']}), B1 launches a "
                  f"dispatch {o['b1_per_dispatch']}, launches "
                  f"{o['launches']}")
            check(o["launches"]["hint_match"] == 0,
                  f"node {i}: a step took the unfused chain")
        leader.close()
        follower.close()
        for p in kids:
            p.send_signal(15)
        codes = [p.wait(60) for p in kids]
        check(codes == [0, 0], f"the nodes exited {codes}")
        out = {"nodes": 2, "groups": n, "commands": n_cmds,
               "generation": gen, "checksum": st[0]["checksum"],
               "boot_s": boot_s, "build_s": build_wall,
               "converge_s": converge_s, "build_cut": n < max_groups,
               "follower_refused": refused.split(": ", 1)[-1][:120],
               "list_detail_equal": ups[0] == ups[1], "step": outs}
        check(out["list_detail_equal"],
              "the nodes list upstream u0 differently")
        log(f"cluster: {json.dumps(out)}")
        return out
    finally:
        for p in kids:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(work, ignore_errors=True)


TOOLS_SEED = 1
TOOLS_SCALE = 1.0           # storm at the reference's full scale
TOOLS_CHAOS_REQUESTS = 120  # tests/test_chaos.py's floor run
TOOLS_REPLAY_ARRIVALS = 100
TOOLS_HOST_SECS = 3.0
# the storm gates that fail the phase: hard failures, failed or wrong
# answers, convergence and the rejected torn generation. The rest
# (latency, shed and delivery ratios, differentials) are printed with
# their values; one that fails on the card is a finding, not a failed
# run. Row gates are "<row>.<gate>".
STORM_HARD = {
    "flash_crowd": ("static.hard_failures", "adaptive.hard_failures"),
    "adversarial_crowd": ("on.hard_failures", "off.hard_failures"),
    "replay_flash_crowd": ("recorded_mix_clean", "hard_failures",
                           "schedule_deterministic"),
    "slowloris": ("legit_success",),
    "dns_storm": ("failed_queries",),
    "elephant_mice": ("native_drops",),
    "rolling_upgrade": ("failed_queries", "rejected_generation_seen",
                        "healed_after_reject", "fleet_converged"),
}


def storm_gates(out: dict) -> dict:
    """A storm scenario's gates by name, its rows' as "<row>.<gate>"."""
    gates = dict(out.get("slo", {}))
    for row, r in out.get("rows", {}).items():
        for name, g in r.get("slo", r.get("legit_slo", {})).items():
            gates[f"{row}.{name}"] = g
    return gates


def launches_want(batches: dict, on_card: bool) -> dict:
    """The CUDA launches a run's engine dispatches (by kind) make on
    "torch": B1 for fused classify+pick ("cpick", "all"), B3 for hint,
    B4 for cidr; none on the CPU, where the plain tiers serve."""
    n = int(on_card)
    return {"B1": n * (batches.get("cpick", 0) + batches.get("all", 0)),
            "B3": n * batches.get("hint", 0),
            "B4": n * batches.get("cidr", 0)}


def phase_tools(device, scale=TOOLS_SCALE,
                replay_arrivals=TOOLS_REPLAY_ARRIVALS,
                host_secs=TOOLS_HOST_SECS) -> dict:
    """The port's scenario and load tools (vproxy_tpu_torch/tools/), in
    process, with ClassifyService in device mode (VPROXY_TPU_CLASSIFY=
    device, the service rebuilt) and the engine's small-table cut at 0
    (every storm table is under the default 128), both restored after:

    * storm.run_all(seed=1, scale): every scenario runs (none skipped,
      none raised), its STORM_HARD gates pass, and its B1 / B3 / B4
      launches equal its engine dispatches by kind (launches_want);
      rolling_upgrade's steps launch B1, slowloris' and dns_storm's
      hint batches B3, on the card. The other gates are printed;
    * chaos.run at tests/test_chaos.py's floor, phase 4 under the card's
      contract (a KernelError closes the phase's own service, every
      held callback gets -1, no failover, a later submit raises);
    * one replay round trip: a seeded Zipf mix recorded through a
      ReplayWorld, replayed at 1x with the fidelity gates (the tier-1
      rate band), its report's schedule_hash that of build_schedule for
      the same model and seed;
    * hostbench built from the port's copy, `client` for host_secs
      through a port TcpLB (http-splice, one Host rule) to two
      `hostbench server`s: 0 errors, B3 == the hint batches (> 0 on the
      card). Its req/s is a smoke reading, no claim.
    -> the phase's numbers."""
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules.service import ClassifyService
    from vproxy_tpu_torch.tools import chaos, hostbench, replay, storm
    from vproxy_tpu_torch.utils import sketch, workload
    on_card = device.type == "cuda"
    keys = ("VPROXY_TPU_CLASSIFY", "VPROXY_TPU_FAILPOINT_SEED")
    saved = {k: os.environ.get(k) for k in keys}
    small = E.SMALL_TABLE
    os.environ["VPROXY_TPU_CLASSIFY"] = "device"
    E.SMALL_TABLE = 0
    ClassifyService.reset()
    secs = {}
    try:
        t0 = time.monotonic()
        rep = storm.run_all(seed=TOOLS_SEED, scale=scale)
        secs["storm"] = time.monotonic() - t0
        check(rep["device"] == device.type, f"storm ran on {rep['device']}")
        scenarios, soft_failed = {}, []
        for name, out in rep["scenarios"].items():
            check("error" not in out and not out.get("skipped"),
                  f"storm {name}: {out.get('error') or out.get('reason')}")
            gates = storm_gates(out)
            for g in STORM_HARD[name]:
                check(gates[g]["pass"], f"storm {name} gate {g}: "
                      f"{gates[g]}")
            soft_failed += [f"{name}.{g}" for g, v in gates.items()
                            if not v["pass"] and g not in STORM_HARD[name]]
            dev = out["device"]
            check(dev["launches"] == launches_want(dev["batches"], on_card),
                  f"storm {name}: launches {dev['launches']} for engine "
                  f"dispatches {dev['batches']}")
            scenarios[name] = {
                "s": out["elapsed_s"], "pass": out["pass"],
                "batches": dev["batches"], "launches": dev["launches"],
                "gates": {g: [v["value"], v["pass"]]
                          for g, v in gates.items()}}
        if on_card:
            ru, ds, sl = (rep["scenarios"][n]["device"]["launches"] for n in
                          ("rolling_upgrade", "dns_storm", "slowloris"))
            check(ru["B1"] > 0 and ds["B3"] > 0 and sl["B3"] > 0,
                  f"no kernel launched: rolling_upgrade {ru}, dns_storm "
                  f"{ds}, slowloris {sl}")

        t0 = time.monotonic()
        c0 = storm.device_counts()
        ch = chaos.run(clients=4, requests=TOOLS_CHAOS_REQUESTS,
                       payload_len=4096,
                       eject_base_s=0.5, drain_s=10.0)
        ch_dev = storm.counts_since(c0)
        secs["chaos"] = time.monotonic() - t0
        cls = ch["classify"]
        check(ch["success_rate"] >= 0.99 and ch["warmup"]["fail"] == 0,
              f"chaos success rate {ch['success_rate']}")
        check(ch["ejected"] and ch["eject_latency_s"] is not None and
              ch["eject_latency_s"] < 5.0 and ch["readmitted"] and
              ch["victim_served_after_readmit"],
              f"chaos eject / readmit: {ch['eject_latency_s']}")
        check(ch["drain_sheds_new_accepts"] and ch["drain_inflight_alive"]
              and ch["drain_clean"] and ch["drain_elapsed_s"] < 10.0,
              "chaos drain")
        check(cls["delivered"] and cls["on_card"] == on_card, f"chaos "
              f"phase 4: {cls}")
        if on_card:
            check(cls["error"] == "KernelError" and cls["failovers"] == 0
                  and cls["answers"] and set(cls["answers"]) == {-1} and
                  len(cls["answers"]) + len(cls["refused"]) == 2 and
                  set(cls["refused"]) <= {"KernelError"} and
                  cls["later_submit_raised"] == "KernelError",
                  f"chaos phase 4, the card's contract: {cls}")
        else:
            check(cls["failovers"] >= 1 and cls["answers"] == [-1, 0],
                  f"chaos phase 4 on the CPU: {cls}")
        check(ch_dev["launches"] == launches_want(ch_dev["batches"],
                                                  on_card),
              f"chaos: launches {ch_dev}")

        t0 = time.monotonic()
        sketch.reset()
        workload.reset()
        w = replay.ReplayWorld(alias="smoke-replay-src")
        try:
            workload.capture_start()
            mix = replay.drive_zipf_mix(w.lb.bind_port, seed=11, n=120,
                                        clients=6, pace_s=0.015)
            workload.capture_stop()
            model = workload.WorkloadModel.fit(seed=11)
        finally:
            w.close()
        rp = replay.run_replay(model, seed=11, speed=1.0,
                               max_arrivals=replay_arrivals,
                               fidelity_gate=True, rate_band=(0.75, 1.3))
        secs["replay"] = time.monotonic() - t0
        want_hash = replay.schedule_hash(replay.build_schedule(
            model, 11, max_arrivals=replay_arrivals))
        check(mix["fail"] == 0 and rp["results"]["fail"] == 0,
              f"replay failures: mix {mix['fail']}, replay "
              f"{rp['results']['fail']}")
        check(rp["schedule_hash"] == want_hash,
              f"replay hash {rp['schedule_hash']} != {want_hash}")
        check(rp["pass"] and rp["fidelity"]["pass"],
              f"replay gates: {rp['slo']} {rp['fidelity']['gates']}")

        t0 = time.monotonic()
        c0 = storm.device_counts()
        hb = hostbench.serve_through_lb(secs=host_secs, conns=16,
                                        pipeline=4)
        hb_dev = storm.counts_since(c0)
        secs["hostbench"] = time.monotonic() - t0
        check(hb["errors"] == 0 and hb["reqs"] > 0,
              f"hostbench: {hb['reqs']} served, {hb['errors']} errors")
        check(hb_dev["launches"] == launches_want(hb_dev["batches"], on_card)
              and (hb_dev["launches"]["B3"] > 0 or not on_card),
              f"hostbench: {hb_dev}")
        launches = {k: sum(sc["launches"][k] for sc in scenarios.values())
                    + ch_dev["launches"][k] + hb_dev["launches"][k]
                    for k in ("B1", "B3", "B4")}
        out = {"seed": TOOLS_SEED, "scale": scale, "seconds": secs,
               "classify_mode": "device", "small_table_cut": 0,
               "storm": scenarios, "soft_gates_failed": soft_failed,
               "chaos": {"success_rate": ch["success_rate"],
                         "sessions": ch["total_sessions"],
                         "eject_latency_s": ch["eject_latency_s"],
                         "drain_elapsed_s": ch["drain_elapsed_s"],
                         "classify": cls, "device": ch_dev},
               "replay": {"arrivals": rp["arrivals"],
                          "schedule_hash": rp["schedule_hash"],
                          "p50_ms": rp["p50_ms"], "p99_ms": rp["p99_ms"],
                          "fidelity": {g: [v["value"], v["pass"]] for g, v
                                       in rp["fidelity"]["gates"].items()},
                          "results": {k: rp["results"][k]
                                      for k in ("ok", "fail", "shed")}},
               "hostbench": {**{k: hb[k] for k in ("reqs", "secs", "rps",
                                                   "errors", "conns",
                                                   "pipeline")},
                             "backends": hb["backends"], "device": hb_dev},
               "launches": launches}
        log(f"tools: storm {secs['storm']:.1f} s, chaos "
            f"{secs['chaos']:.1f} s, replay {secs['replay']:.1f} s, "
            f"hostbench {hb['rps']:.0f} req/s, launches {launches}, soft "
            f"gates failed {soft_failed}")
        return out
    finally:
        E.SMALL_TABLE = small
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        ClassifyService.reset()


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
    # the sharded compiles are host work: spawned workers run them while
    # the phases below use the card
    shard_pool, shard_futs = sharded_start()
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
    dense = run("dense tables", dense_tables, device)
    dense_err = run("dense kernels", phase_dense_kernels, device, dense)
    log(json.dumps({"dense_kernels": {**dense_err, "card": smi}}))
    dense_svc = run("dense service", phase_dense_service, device, dense,
                    cidr_oracle=oracle)
    log(json.dumps({"dense_service": {**dense_svc, "card": smi}}))
    maglev = run("maglev", phase_maglev, device, dense["mm"])
    tcplb_fp = run("tcplb_fp", phase_tcplb, device,
                   max_rules=TCPLB_MIN_RULES, bursts=1, matcher="jax-fp")
    log(json.dumps({"tcplb_fp": {**tcplb_fp, "card": smi}}))
    control = run("control", phase_control, device)
    log(json.dumps({"control": {**control, "card": smi}}))
    control_fp = run("control_fp", phase_control, device,
                     max_groups=CONTROL_MIN_GROUPS, dns_bursts=1,
                     s5_bursts=1, lb_bursts=1, min_acl=CONTROL_FP_ACL,
                     max_acl=CONTROL_FP_ACL, matcher="jax-fp")
    log(json.dumps({"control_fp": {**control_fp, "card": smi}}))
    switch = run("switch", phase_switch, device)
    log(json.dumps({"switch": {**switch, "card": smi}}))
    apps = run("apps", phase_apps, device)
    log(json.dumps({"apps": {**apps, "card": smi}}))
    websocks = run("websocks", phase_websocks, device)
    log(json.dumps({"websocks": {**websocks, "card": smi}}))
    docker = run("docker", phase_docker, device)
    log(json.dumps({"docker": {**docker, "card": smi}}))
    rows, b3_rows, sweep = run("times", phase_times, device, keep)
    crows = run("cidr times", phase_cidr_times, device, keep, routes, am,
                acl)
    fp_rows = run("fp times", phase_fp_times, device, fp)
    dense_rows = run("dense times", phase_dense_times, device, dense)
    # the sharded backends and the cluster plane after every timing of
    # the unsharded kernels: their rows keep the conditions of the runs
    # PERF.md compares them with
    sharded = run("sharded tables", sharded_tables, device, shard_pool,
                  shard_futs)
    b8 = run("sharded kernels", phase_sharded_kernels, device, sharded)
    log(json.dumps({"sharded_kernels": {
        "max_abs_err": b8["max_abs_err"], "checks": b8["checks"],
        "shards": sorted({k[1] for k in sharded if isinstance(k, tuple)}),
        "buckets": SHARDED_BUCKETS, "card": smi}}))
    svc_tabs = run("sharded service tables", sharded_service_tables, device,
                   sharded, {"hint": pair.hm, "routes": routes})
    del sharded
    b8_svc = run("sharded service", phase_sharded_service, device, svc_tabs)
    log(json.dumps({"sharded_service": {**b8_svc, "card": smi}}))
    cpick = run("cpick", phase_cpick, device, {
        "torch-fp": (fp["pair"], fp["rules"]),
        "torch-dense": (dense["pair"], dense["rules"]),
        **{be: (svc_tabs[be]["pair"], svc_tabs["rules"])
           for be in E.SHARDED_BACKENDS}})
    log(json.dumps({"cpick": {"rows": cpick, "card": smi}}))
    del svc_tabs
    cluster = run("cluster", phase_cluster, device)
    log(json.dumps({"cluster": {**cluster, "card": smi}}))
    tools = run("tools", phase_tools, device)
    log(json.dumps({"tools": {**tools, "card": smi}}))
    # B5's launches: the standalone Maglev batches; the cpick batches of
    # the three services take none (their hint kernels' Maglev column)
    b5_launches = {"standalone Maglev batches": maglev["launches"],
                   "fp service cpick": fp_svc["maglev_take_launches"],
                   "dense service cpick":
                       dense_svc["launches"]["maglev_take"],
                   "sharded service cpick": sum(
                       v["launches"]["maglev_take"]
                       for v in b8_svc.values())}
    cpick_takes = fp_svc["maglev_takes"] + dense_svc["maglev_takes"] + sum(
        v["maglev_takes"] for v in b8_svc.values())
    check(cpick_takes == 0 and sum(b5_launches.values()) ==
          maglev["launches"] > 0, f"B5 ran for a cpick batch, or not for "
          f"the standalone ones: {b5_launches}, {cpick_takes} takes")
    log(json.dumps({"b5_take": {
        "replaces": REPLACES_B5, "source": SOURCE_B5,
        "max_abs_err": dense_err["b5"], "launches": b5_launches,
        "cpick_maglev_takes": cpick_takes,
        "by_batch": fp_rows["B5"], "card": smi}}))
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
                "batch": SERVICE_BATCH, "card": smi,
                "kernels_seen": at(rows_, "kernels_seen"),
                "kernels_expected": at(rows_, "kernels_expected"), **extra}

    b1_cluster = sum(o["launches"]["fused_classify_pick"]
                     for o in cluster["step"])
    b8_launches = {be: v["launches"]["sharded_match"]
                   for be, v in b8_svc.items()}
    b8_at = f"hint S={max(SHARD_MESH)}"

    def unsharded(rows_, what):
        return {"kernel": what, "ms": at(rows_), "cold_ms":
                at(rows_, "cold_ms")}

    log(json.dumps({"kernels": [
        entry("fused_classify_pick", SOURCE, REPLACES,
              launches + loop["b1_launches"] + b1_cluster +
              tools["launches"]["B1"], err, rows,
              launches_by_path={"service": launches,
                                "loop": loop["b1_launches"],
                                "cluster step loops": b1_cluster,
                                "tools": tools["launches"]["B1"]},
              build_s=builds["fused"]["build_s"],
              instances=builds["fused"]["instances"], by_batch=rows,
              sweep=sweep),
        entry("fused_classify_pick route column", SOURCE, REPLACES_ROUTE,
              rc_launches, rc_err, crows["B1 route column"],
              by_batch=crows["B1 route column"]),
        entry("cidr_first", SOURCE_B4, REPLACES_B4,
              b4_launches + tcplb["launches"]["cidr_first"] +
              switch["launches"]["cidr_first"] +
              docker["launches"]["cidr_first"] + tools["launches"]["B4"],
              b4_err, crows["B4 ACL"], table="ACL 5k, ports",
              launches_by_path={"cidr service": b4_launches,
                                "tcplb": tcplb["launches"]["cidr_first"],
                                "switch": switch["launches"]["cidr_first"],
                                "docker": docker["launches"]["cidr_first"],
                                "tools": tools["launches"]["B4"]},
              build_s=builds["cidr"]["build_s"],
              instances=builds["cidr"]["instances"],
              by_batch={"acl": crows["B4 ACL"],
                        "routes": crows["B4 routes"]},
              host_breakdown={"acl": crows["breakdown ACL"],
                              "routes": crows["breakdown routes"]}),
        entry("hint_match", SOURCE, REPLACES_B3,
              tcplb["launches"]["hint_match"] + tools["launches"]["B3"],
              b3_err, b3_rows,
              mode="B1's kernel, verdict-only (null Maglev column)",
              plain="hashmatch.hint_hash_match",
              launches_by_path={"tcplb": tcplb["launches"]["hint_match"],
                                "tools": tools["launches"]["B3"]},
              by_batch=b3_rows),
        entry("hint_fp_match", SOURCE_B6, REPLACES_B6,
              fp_svc["launches"]["hint_fp"] +
              tcplb_fp["fp_launches"]["hint_fp"], fp_err["b6"], fp_rows["B6"],
              launches_by_path={
                  "fp service hint + cpick": fp_svc["launches"]["hint_fp"],
                  "of which cpick (Maglev column)":
                      fp_svc["launches"]["hint_fp_pick"],
                  "tcplb_fp": tcplb_fp["fp_launches"]["hint_fp"]},
              build_s=builds["fp_hint"]["build_s"],
              instances=builds["fp_hint"]["instances"],
              by_batch=fp_rows["B6"], pick_by_batch=fp_rows["B6 pick"],
              classify_fp_all={"max_abs_err": fp_err["all"],
                               "by_batch": fp_rows["classify_fp_all"]}),
        entry("cidr_fp_match", SOURCE_B7, REPLACES_B7,
              fp_svc["launches"]["cidr_fp"] +
              tcplb_fp["fp_launches"]["cidr_fp"] +
              switch["launches"]["cidr_fp_match"], fp_err["b7"],
              fp_rows["B7 ACL"], table="ACL 5k, ports",
              launches_by_path={
                  "fp service": fp_svc["launches"]["cidr_fp"],
                  "tcplb_fp": tcplb_fp["fp_launches"]["cidr_fp"],
                  "switch": switch["launches"]["cidr_fp_match"]},
              build_s=builds["fp_cidr"]["build_s"],
              instances=builds["fp_cidr"]["instances"],
              layouts=fp_err["layouts"],
              by_batch={"acl": fp_rows["B7 ACL"],
                        "routes": fp_rows["B7 routes"]}),
        entry("maglev_take", SOURCE_B5, REPLACES_B5,
              sum(b5_launches.values()), dense_err["b5"], fp_rows["B5"],
              library_ms=at(fp_rows["B5"], "library_ms"),
              library_what="torch indexing, mtab[slots.clamp(0, M - 1)] "
              "(the plain version)",
              with_copy_ms=at(fp_rows["B5"], "with_copy_ms"),
              launches_by_path=b5_launches,
              build_s=builds["take"]["build_s"],
              instances=builds["take"]["instances"],
              by_batch=fp_rows["B5"]),
        entry("dense_match", SOURCE_B9, REPLACES_B9,
              dense_svc["launches"]["hint_dense"] +
              dense_svc["launches"]["cidr_dense"],
              max(dense_err["b9"], dense_err["all"]), dense_rows["B9 hint"],
              table="100k hint rules (mk_rules), uri rules",
              library_ms=at(dense_rows["B9 hint"], "library_ms"),
              library_what="the count step only: the float32 mismatch "
              "GEMMs as torch.matmul (TF32 allowed), no bias, compare, "
              "level or reduction",
              launches_by_path={
                  "dense service hint + cpick":
                      dense_svc["launches"]["hint_dense"],
                  "of which cpick (Maglev column)":
                      dense_svc["launches"]["hint_dense_pick"],
                  "dense service cidr": dense_svc["launches"]["cidr_dense"]},
              build_s=builds["dense"]["build_s"],
              instances=builds["dense"]["instances"],
              wide_table=dense_err["wide"], by_batch=dense_rows),
        entry("sharded_match", SOURCE_B8, REPLACES_B8,
              sum(b8_launches.values()), b8["max_abs_err"],
              b8["rows"][b8_at],
              table=f"100k hint rules (mk_rules), cuckoo, S = "
              f"{max(SHARD_MESH)} (make_mesh(8, batch=2))",
              launches_by_path={
                  **{f"sharded service {be}": n_
                     for be, n_ in b8_launches.items()},
                  **{f"of which cpick (Maglev column) {be}":
                     v["launches"]["sharded_match_pick"]
                     for be, v in b8_svc.items()}},
              pick_by_batch={k: v for k, v in b8["rows"].items()
                             if k.endswith(" pick")},
              finish_launches=sum(v["launches"]["sharded_finish"]
                                  for v in b8_svc.values()),
              build_s=builds["sharded"]["build_s"],
              instances=builds["sharded"]["instances"],
              unsharded_at_512={
                  "hint": unsharded(b3_rows, "B3"),
                  "fp_hint": unsharded(fp_rows["B6"], "B6"),
                  "cidr routes": unsharded(crows["B4 routes"], "B4"),
                  "cidr acl": unsharded(crows["B4 ACL"], "B4"),
                  "fp_cidr routes": unsharded(fp_rows["B7 routes"], "B7"),
                  "fp_cidr acl": unsharded(fp_rows["B7 ACL"], "B7")},
              by_case=b8["rows"])]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab"]:
        sys.exit(main_ab(*sys.argv[2:5]))
    sys.exit(main())
