"""Chip smoke test: the torch port's classify+pick serving path on one GPU.

    python3 chip_smoke.py

Builds the fused CUDA kernel from the checkout's sources, holds it bit
for bit against the plain torch tier, serves hint and classify+pick
bursts through ClassifyService over a 100k-rule Host/SNI/URI table and a
65,537-slot Maglev table over 256 weighted backends, times the kernel,
and prints one JSON line per result. Phases, in order:

1. environment: a CUDA device, or exit 1; the card's name and power
   limit as nvidia-smi reports them;
2. build: nvcc of csrc/fused_classify_pick.cu, with its seconds, and
   per kernel instance (uri or uri-free, compare word) ptxas's
   registers and spills (any spill fails) and its global loads in the
   SASS (cuobjdump, kept beside the library as <lib>.sass);
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
5. times at B = 16, 512, 4096: the kernel's and the plain tier's device
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
6. the {"kernels": [...]} line, then the device line.

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
    """fused_kernel<URI, W>'s mangled name -> "uri W=16" and the like."""
    m = re.search(r"fused_kernelILb([01])ELi(\d+)E", mangled)
    return (f"{'uri' if m.group(1) == '1' else 'uri-free'} W={m.group(2)}"
            if m else mangled)


def phase_build() -> tuple:
    """-> (build seconds, {instance: {registers, spill_stores,
    spill_loads, ldg}})."""
    from vproxy_tpu_torch.ops import fused_cuda as FC
    t0 = time.monotonic()
    lib = FC.build()
    secs = time.monotonic() - t0
    log(f"build: {secs:.2f} s -> {os.path.basename(lib)}")
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
    for name in sorted(kern):
        k = kern[name]
        log(f"  ptxas: fused_kernel {name}: {k.get('registers')} registers,"
            f" {k.get('spill_stores')} B spill stores, "
            f"{k.get('spill_loads')} B spill loads; SASS {k.get('ldg')} "
            f"LDG")
    check(len(kern) == 8 and all(k.get("registers") for k in
                                 kern.values()),
          f"ptxas reported {len(kern)} kernel instances, want 8")
    check(all(k.get("spill_stores") == k.get("spill_loads") == 0
              for k in kern.values()), "a kernel instance spills")
    return secs, kern


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
    """The main path: ClassifyService over a FusedPair. -> launches of
    the fused kernel during the run."""
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
    return launches


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
    low, so it is run again, and the phase fails after three."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
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
                       f"kernels in three runs")


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


def main() -> int:
    smi = phase_env()
    from vproxy_tpu_torch.rules import engine as E
    device = torch.device("cuda")
    build_s, instances = phase_build()
    err, keep = phase_kernel_vs_plain(device)
    launches = phase_service(device, keep[0])
    rows, sweep = phase_times(device, keep)
    main_row = next(r for r in rows if r["batch"] == SERVICE_BATCH)
    check(E.fused_kernel_name() == "cuda", "fused kernel tier changed")
    log(json.dumps({"kernels": [{
        "name": "fused_classify_pick", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": float(err), "ms": main_row["ms"],
        "cold_ms": main_row["cold_ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"], "library_ms": None,
        "batch": SERVICE_BATCH, "build_s": build_s, "card": smi,
        "instances": instances,
        "by_batch": rows, "sweep": sweep}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
