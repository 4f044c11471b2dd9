"""Torch port, the CIDR half: compilers, torch tiers, matcher, service, ACL.

The same seeded inputs (numpy generators below, copied into
chip_smoke.py, which holds the CUDA kernels to the plain tiers on them)
go through vproxy_tpu on the JAX CPU backend and through the port on
torch's CPU (VPROXY_TPU_TORCH_DEVICE=cpu); every comparison is exact:

* compile_cidr_hash arrays and caps, byte for byte (the route, ACL port
  bucket and mixed-family cases of tests/test_hashmatch.py, random
  route and ACL sets, v6 routes at most prefix lengths, an ACL of
  deep buckets, a caps-reusing update and a growth), and
  pack_cidr_table;
* cidr_hash_match, _cidr_first_packed (the plain version of the CUDA
  kernels' CIDR routine), classify_hash_all and the 3-column
  fused_classify_pick, int32;
* encode_ips, CidrIndex.lookup and the copied _prune_acl_members;
* CidrMatcher (match, match_one, index_snap, dispatch_snap, checksum,
  installs), fused_dispatch_all, ClassifyService's cidr kind (the
  mixed port/portless case of tests/test_service.py included) and
  SecurityGroup's whole surface, against the reference's;
* the CUDA entries never substitute a plain tier for a tensor off the
  CPU, a CUDA CidrMatcher stops its publish when the kernel cannot
  build, a KernelError closes the service, and the CidrArgs mirror
  matches the source.
"""
import ctypes
import functools
import random
import re
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_fused import mk_ips, mk_queries, mk_rules
from vproxy_tpu.components.secgroup import SecurityGroup as RefGroup
from vproxy_tpu.ops import fphash as RFP_
from vproxy_tpu.ops import fused as RF
from vproxy_tpu.ops import hashmatch as RH
from vproxy_tpu.ops import tables as RT
from vproxy_tpu.rules import engine as RE
from vproxy_tpu.rules import index as RI
from vproxy_tpu.rules import ir as RIR
from vproxy_tpu.rules import maglev as RM
from vproxy_tpu.rules.service import ClassifyService as RefService
from vproxy_tpu.utils import failpoint as RFP
from vproxy_tpu.utils import ip as RIP
from vproxy_tpu_torch.components.secgroup import SecurityGroup
from vproxy_tpu_torch.ops import cidr_cuda as CC
from vproxy_tpu_torch.ops import fused as F
from vproxy_tpu_torch.ops import fused_cuda as FC
from vproxy_tpu_torch.ops import hashmatch as H
from vproxy_tpu_torch.ops import tables as T
from vproxy_tpu_torch.rules import engine as E
from vproxy_tpu_torch.rules import maglev as M
from vproxy_tpu_torch.rules.index import CidrIndex
from vproxy_tpu_torch.rules.ir import AclRule, Proto
from vproxy_tpu_torch.rules.service import ClassifyService
from vproxy_tpu_torch.utils import events, failpoint
from vproxy_tpu_torch.utils.ip import Network, mask_bytes, parse_ip
from vproxy_tpu_torch.utils.torchenv import tables_from_reference as up

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_and_clean(monkeypatch):
    monkeypatch.setenv("VPROXY_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("VPROXY_TPU_INSTALL_PACE", "0")
    failpoint.clear()
    RFP.clear()
    yield
    failpoint.clear()
    RFP.clear()


# ------------------------------------------------------------ generators
# Copied into chip_smoke.py (test_torch_kernels.py
# test_chip_smoke_carries_the_parity_cases holds the copies equal).

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


@functools.lru_cache(maxsize=None)
def cidr_case(name):
    """-> (nets, acl or None, addrs, ports or None) of one case."""
    if name == "route_200":
        nets, addrs = hashmatch_route_case()
        return nets, None, addrs, None
    if name == "acl_port_buckets":
        acl, q = acl_port_buckets()
        return [r.network for r in acl], acl, [a for a, _ in q], \
            [p for _, p in q]
    if name == "mixed_families":
        nets, addrs = mixed_families()
        return nets, None, addrs, None
    if name == "v6_many_masks":
        nets, addrs = v6_many_masks()
        return nets, None, addrs, None
    if name == "acl_deep_buckets":
        acl, q = acl_deep_buckets()
        return [r.network for r in acl], acl, [a for a, _ in q], \
            [p for _, p in q]
    if name.startswith("routes_"):
        nets = route_nets(int(name[7:-1]) * 1000, 5)
        return nets, None, [a for a, _ in cidr_queries(nets, 600, 6)], None
    if name.startswith("acl_500"):
        acl = acl_rules(500, 7)
        q = acl_queries(acl, 600, 8)
        return [r.network for r in acl], acl, [a for a, _ in q], \
            None if name.endswith("portless") else [p for _, p in q]
    assert name == "empty"
    return [], None, [parse_ip("10.0.0.1")], None


CASES = ("route_200", "acl_port_buckets", "mixed_families", "routes_2k",
         "acl_500", "acl_500_portless", "empty", "v6_many_masks",
         "acl_deep_buckets")


def ref_net(n):
    return RIP.Network(n.ip, n.mask)


def ref_acl(acl):
    return None if acl is None else [
        RIR.AclRule(r.alias, ref_net(r.network), RIR.Proto(r.protocol.value),
                    r.min_port, r.max_port, r.allow) for r in acl]


@functools.lru_cache(maxsize=None)
def compiled(name):
    """-> (port table, reference table, case) for one case."""
    nets, acl, addrs, ports = cidr_case(name)
    tab = H.compile_cidr_hash(nets, acl=acl)
    rtab = RH.compile_cidr_hash([ref_net(n) for n in nets],
                                acl=ref_acl(acl))
    return tab, rtab, (nets, acl, addrs, ports)


def same_arrays(ref: dict, got: dict):
    assert sorted(ref) == sorted(got)
    for k in ref:
        r, g = np.asarray(ref[k]), np.asarray(got[k])
        assert r.dtype == g.dtype and r.shape == g.shape, k
        assert r.tobytes() == g.tobytes(), k


def encoded(addrs, ports):
    a16, fam = T.encode_ips(addrs)
    p = None if ports is None else np.asarray(ports, np.int32)
    return a16, fam, p


def tq(a16, fam, p):
    """numpy query arrays -> CPU tensors."""
    return (torch.from_numpy(a16), torch.from_numpy(fam),
            None if p is None else torch.from_numpy(p))


# ------------------------------------------------------------ host half


@pytest.mark.parametrize("name", CASES)
def test_compile_cidr_hash_byte_identical(name):
    tab, rtab, _ = compiled(name)
    assert (tab.n, tab.r_cap, tab.caps) == (rtab.n, rtab.r_cap, rtab.caps)
    same_arrays(rtab.arrays, tab.arrays)


@pytest.mark.parametrize("step", ["reuse", "growth"])
def test_compile_cidr_hash_caps_reuse_and_growth(step):
    """An update compiled with the previous caps keeps every shape that
    still fits (reuse), and a bigger one grows them (growth); both
    byte-identical to the reference given the same caps."""
    first, _, _ = compiled("routes_2k")
    nets = route_nets(300, 9) if step == "reuse" else route_nets(2600, 9)
    tab = H.compile_cidr_hash(nets, caps=first.caps)
    rtab = RH.compile_cidr_hash([ref_net(n) for n in nets],
                                caps=first.caps)
    assert tab.caps == rtab.caps
    same_arrays(rtab.arrays, tab.arrays)
    grew = {k for k in tab.caps if tab.caps[k] != first.caps[k]}
    assert (grew == set()) == (step == "reuse")


@pytest.mark.parametrize("name", CASES)
def test_pack_cidr_table_byte_identical(name):
    tab, rtab, _ = compiled(name)
    same_arrays(RF.pack_cidr_table(rtab.arrays),
                F.pack_cidr_table(tab.arrays))


def test_encode_ips_identical():
    nets, addrs = mixed_families()
    for batch in (addrs, [a for a in addrs if len(a) == 4],
                  [a for a, _ in cidr_queries(route_nets(200, 3), 64, 4)],
                  []):
        for got, want in zip(T.encode_ips(batch), RT.encode_ips(batch)):
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_prune_acl_members_identical():
    acl = acl_rules(400, 11)
    rng = np.random.default_rng(12)
    for _ in range(50):
        items = [int(x) for x in rng.choice(400, size=12, replace=False)]
        assert H._prune_acl_members(items, acl) == \
            RFP_._prune_acl_members(items, acl)
    acl, _ = acl_port_buckets()
    assert H._prune_acl_members([2, 0, 1], acl) == [0, 1, 2]
    assert H._prune_acl_members([0, 2, 1], [acl[2], acl[0], acl[1]]) == [0]


@pytest.mark.parametrize("name", ["route_200", "acl_port_buckets",
                                  "routes_2k", "acl_500"])
def test_cidr_index_matches_reference_and_oracle(name):
    nets, acl, addrs, ports = cidr_case(name)
    idx = CidrIndex(nets, acl=acl)
    ref = RI.CidrIndex([ref_net(n) for n in nets], acl=ref_acl(acl))
    ports = ports or [None] * len(addrs)
    for a, p in zip(addrs, ports):
        want = next((j for j, n in enumerate(nets) if n.contains_ip(a) and (
            p is None or acl is None or
            acl[j].min_port <= p <= acl[j].max_port)), -1)
        assert idx.lookup(a, p) == ref.lookup(a, p) == want


# ------------------------------------------------------------ torch tiers


@pytest.mark.parametrize("name", CASES)
def test_cidr_hash_match_vs_jax(name):
    tab, rtab, (_, _, addrs, ports) = compiled(name)
    a16, fam, p = encoded(addrs, ports)
    want = np.asarray(RH.cidr_hash_jit(rtab.arrays, a16, fam, p))
    got = H.cidr_hash_match(up(tab.arrays, "cpu"), *tq(a16, fam, p))
    assert got.dtype == torch.int32 and np.array_equal(want, got.numpy())


@pytest.mark.parametrize("name", CASES)
def test_cidr_first_packed_vs_jax(name):
    """The plain version of the CUDA kernels' CIDR routine: equal to
    the reference's packed form and to the unpacked torch tier."""
    tab, rtab, (_, _, addrs, ports) = compiled(name)
    a16, fam, p = encoded(addrs, ports)
    want = np.asarray(RF._cidr_first_packed(RF.pack_cidr_table(rtab.arrays),
                                            a16, fam, p))
    got = F._cidr_first_packed(up(F.pack_cidr_table(tab.arrays), "cpu"),
                               *tq(a16, fam, p))
    assert np.array_equal(want, got.numpy())
    unpacked = H.cidr_hash_match(up(tab.arrays, "cpu"), *tq(a16, fam, p))
    assert torch.equal(got, unpacked)


@pytest.mark.parametrize("how", CUTS)
@pytest.mark.parametrize("name", ["routes_2k", "acl_500", "acl_deep_buckets"])
def test_cidr_first_packed_clamps_like_jax(name, how):
    """On a table cut short (cut_table) the plain tier clamps where the
    reference's gathers clamp: the cases chip_smoke.py holds the CUDA
    kernels' clamps to."""
    tab, rtab, (_, _, addrs, ports) = compiled(name)
    a16, fam, p = encoded(addrs, ports)
    rct = {k: jnp.asarray(v) for k, v in
           cut_table(RF.pack_cidr_table(rtab.arrays), how).items()}
    want = np.asarray(RF._cidr_first_packed(rct, a16, fam, p))
    got = F._cidr_first_packed(
        cut_table(up(F.pack_cidr_table(tab.arrays), "cpu"), how),
        *tq(a16, fam, p))
    assert np.array_equal(want, got.numpy())
    full = F._cidr_first_packed(up(F.pack_cidr_table(tab.arrays), "cpu"),
                                *tq(a16, fam, p))
    # deep buckets: every cut shows on acl_500; acl_deep_buckets uses
    # fewer slots than the cut keeps, so its other three cuts show
    if name == "acl_500" or (name == "acl_deep_buckets" and how != "slots"):
        assert not torch.equal(got, full)


def test_cidr_pad_rows_never_match():
    """Family -1 (the engine's pad rows, zero addresses) matches no
    group, not even a /0 route that the zero v4 address matches."""
    nets = route_nets(500, 13) + [Network(bytes(4), mask_bytes(0))]
    tab = H.compile_cidr_hash(nets)
    addrs = [a for a, _ in cidr_queries(nets, 4, 14)] + [bytes(4)]
    a16, fam, _ = E._cidr_q(addrs, None, 8)
    assert (fam[5:] == -1).all() and not a16[5:].any()
    got = H.cidr_hash_match(up(tab.arrays, "cpu"), *tq(a16, fam, None))
    assert (got[:5] >= 0).all() and (got[5:] == -1).all()
    assert int(got[4]) == next(j for j, n in enumerate(nets)
                               if n.contains_ip(bytes(4)))
    got2 = F._cidr_first_packed(up(F.pack_cidr_table(tab.arrays), "cpu"),
                                *tq(a16, fam, None))
    assert torch.equal(got, got2)


def _hint_side(b):
    rules = mk_rules(300)
    htab = H.compile_hint_hash(rules)
    hq = H.encode_hint_queries(mk_queries(rules, b), htab)
    return htab, hq


def test_classify_hash_all_vs_jax():
    b = 96
    htab, hq = _hint_side(b)
    nets = route_nets(800, 15)
    acl = acl_rules(300, 16)
    rt, at = H.compile_cidr_hash(nets), \
        H.compile_cidr_hash([r.network for r in acl], acl=acl)
    q = acl_queries(acl, b, 17)
    a16, fam, p = encoded([a for a, _ in q], [x for _, x in q])
    want = np.asarray(RH.classify_hash_jit(htab.arrays, rt.arrays,
                                           at.arrays, hq, a16, fam, p))
    got = H.classify_hash_all(up(htab.arrays, "cpu"), up(rt.arrays, "cpu"),
                              up(at.arrays, "cpu"), up(hq, "cpu"),
                              *tq(a16, fam, p))
    assert got.shape == (b, 3) and np.array_equal(want, got.numpy())
    assert (want[:, 1] >= 0).sum() > b // 2 and (want[:, 2] >= 0).any()


@pytest.mark.parametrize("table", ["routes", "acl_ports", "acl_portless"])
def test_fused_classify_pick_three_columns_vs_jax(table):
    b = 80
    htab, hq = _hint_side(b)
    ht = RF.pack_hint_table(htab.arrays)
    mtab = RM.build_table([(f"b{i}", 1 + i % 3) for i in range(9)], 4099)
    slots = RM.flow_slots(4099, mk_ips(b), [None] * b)
    if table == "routes":
        nets, acl = route_nets(1000, 18), None
        addrs = [a for a, _ in cidr_queries(nets, b, 19)]
        ports = None
    else:
        acl = acl_rules(400, 20)
        nets = [r.network for r in acl]
        q = acl_queries(acl, b, 21)
        addrs = [a for a, _ in q]
        ports = [x for _, x in q] if table == "acl_ports" else None
    ct = F.pack_cidr_table(H.compile_cidr_hash(nets, acl=acl).arrays)
    a16, fam, p = encoded(addrs, ports)
    want = np.asarray(RF.fused_jit(ht, hq, mtab, slots, ct, a16, fam, p))
    got = F.fused_classify_pick(up(ht, "cpu"), up(hq, "cpu"),
                                torch.from_numpy(mtab),
                                torch.from_numpy(slots), up(ct, "cpu"),
                                *tq(a16, fam, p))
    assert got.shape == (b, 3) and np.array_equal(want, got.numpy())
    two = F.fused_classify_pick(up(ht, "cpu"), up(hq, "cpu"),
                                torch.from_numpy(mtab),
                                torch.from_numpy(slots))
    assert torch.equal(two, got[:, :2])


# ------------------------------------------------------------ engine


def matchers(name, backend="torch"):
    nets, acl, addrs, ports = cidr_case(name)
    m = E.CidrMatcher(nets, acl=acl, backend=backend, payload="pl")
    rm = RE.CidrMatcher([ref_net(n) for n in nets], acl=ref_acl(acl),
                        backend="jax", payload="pl")
    return m, rm, (nets, acl, addrs, ports)


@pytest.mark.parametrize("backend", ["torch", "host"])
@pytest.mark.parametrize("name", ["routes_1k", "acl_500", "mixed_families"])
def test_cidr_matcher_vs_reference(name, backend):
    m, rm, (nets, acl, addrs, ports) = matchers(name, backend)
    want = np.asarray(rm.match(addrs, ports))
    assert np.array_equal(m.match(addrs, ports), want)
    if ports is not None:  # the port gate off: another answer set
        assert np.array_equal(m.match(addrs), np.asarray(rm.match(addrs)))
    ps = ports or [None] * len(addrs)
    snap, rsnap = m.snapshot(), rm.snapshot()
    for a, p in list(zip(addrs, ps))[:40]:
        assert m.match_one(a, p) == rm.match_one(a, p)
        assert m.index_snap(snap, a, p) == rm.index_snap(rsnap, a, p) == \
            m.oracle_snap(snap, a, p) == rm.oracle_snap(rsnap, a, p)
    assert m.checksum() == rm.checksum()
    assert m.size() == rm.size() == len(nets)
    assert m.snap_payload(snap) == "pl"
    if backend == "torch":
        assert m.fused_stat()["available"] and \
            m.fused_stat()["kernel"] == "torch"
        assert m.published_table_bytes() > 0


@pytest.mark.parametrize("pad_to", [None, 1024])
def test_cidr_dispatch_snap_one_launch_vs_reference(pad_to):
    m, rm, (_, _, addrs, ports) = matchers("acl_500")
    l0 = E.dispatch_launches_total()
    got = m.dispatch_snap(m.snapshot(), addrs, ports, pad_to=pad_to)
    assert E.dispatch_launches_total() - l0 == 1
    assert isinstance(got, torch.Tensor) and got.shape[0] == (pad_to or 600)
    want = np.asarray(rm.dispatch_snap(rm.snapshot(), addrs, ports,
                                       pad_to=pad_to))
    assert np.array_equal(got.numpy(), want)
    if pad_to:
        assert (got[600:] == -1).all()


def test_cidr_matcher_installs_like_reference():
    """set_networks through the TableInstaller: caps reuse on a smaller
    update, growth on a bigger one, the ACL swapped with its networks,
    and every generation's answers, caps and checksum equal to the
    reference's after the same installs."""
    m, rm, (nets, acl, addrs, ports) = matchers("acl_500")
    for nets2, acl2 in ((nets[:100], acl[:100]), (None, None)):
        if nets2 is None:
            acl2 = acl_rules(3000, 22)
            nets2 = [r.network for r in acl2]
        g0 = m.generation
        m.set_networks(nets2, acl=acl2, payload="g2")
        rm.set_networks([ref_net(n) for n in nets2], acl=ref_acl(acl2),
                        payload="g2")
        assert m.generation == g0 + 1 and m._caps == rm._caps
        assert np.array_equal(m.match(addrs, ports),
                              np.asarray(rm.match(addrs, ports)))
        assert m.checksum() == rm.checksum()
        assert m.snap_payload(m.snapshot()) == "g2"
    assert E.table_bytes_total("cidr") >= m.published_table_bytes() > 0
    from vproxy_tpu_torch.utils.metrics import GlobalInspection
    text = GlobalInspection.get().prometheus_string()
    assert 'vproxy_engine_table_bytes{matcher="cidr"}' in text


def test_cidr_matcher_refuses_unported_backends():
    for b in ("jax", "jax-fp", "jax-sharded", "jax-dense"):
        with pytest.raises(ValueError, match="unknown backend"):
            E.CidrMatcher(route_nets(10, 1), backend=b)


def test_fused_dispatch_all_vs_reference():
    b = 64
    rules = mk_rules(500)
    backends = [(f"10.9.{i}.1:80", 1 + i % 4) for i in range(7)]
    nets = route_nets(1000, 23)
    hm, mm, cm = E.HintMatcher(rules), M.MaglevMatcher(backends, m=251), \
        E.CidrMatcher(nets)
    rhm, rmm, rcm = RE.HintMatcher(rules, backend="jax"), \
        RM.MaglevMatcher(backends, m=251), \
        RE.CidrMatcher([ref_net(n) for n in nets], backend="jax")
    hints, ips = mk_queries(rules, b), mk_ips(b)
    addrs = [a for a, _ in cidr_queries(nets, b, 24)]
    ports = [None if i % 3 else 1024 + i for i in range(b)]
    l0, f0 = E.dispatch_launches_total(), E.fused_dispatches_total()
    got = E.fused_dispatch_all(hm, hm.snapshot(), cm, cm.snapshot(), mm,
                               mm.snapshot(), hints, addrs, ips, ports,
                               pad_to=128)
    assert E.dispatch_launches_total() - l0 == 1
    assert E.fused_dispatches_total() - f0 == 1
    want = np.asarray(RE.fused_dispatch_all(
        rhm, rhm.snapshot(), rcm, rcm.snapshot(), rmm, rmm.snapshot(),
        hints, addrs, ips, ports, pad_to=128))
    assert got.shape == (128, 3) and np.array_equal(got.numpy(), want)
    assert np.array_equal(got[:b, 2].numpy(), cm.match(addrs))
    assert (got[b:, 0] == -1).all() and (got[b:, 2] == -1).all()


def test_fused_dispatch_all_needs_both_packed_tables(monkeypatch):
    monkeypatch.setenv("VPROXY_TPU_FUSED", "0")
    rules, nets = mk_rules(64), route_nets(300, 25)
    hm, cm = E.HintMatcher(rules), E.CidrMatcher(nets)
    mm = M.MaglevMatcher([("a:1", 1)], m=251)
    assert cm.fused_stat() == {"available": False}
    assert E.fused_dispatch_all(hm, hm.snapshot(), cm, cm.snapshot(), mm,
                                mm.snapshot(), mk_queries(rules, 4),
                                [bytes(4)] * 4, mk_ips(4)) is None


# ------------------------------------------------------------ service


def run_cidr(svc, m, queries):
    """submit_cidr every (addr, port) concurrently; -> answers in order."""
    got = [None] * len(queries)
    evs = [threading.Event() for _ in queries]
    for i, (a, p) in enumerate(queries):
        svc.submit_cidr(m, a, p, lambda idx, pl, i=i: (
            got.__setitem__(i, (idx, pl)), evs[i].set()))
    for ev in evs:
        assert ev.wait(30)
    return got


@pytest.mark.parametrize("name", ["routes_1k", "acl_500"])
@pytest.mark.parametrize("fault", [False, True])
def test_service_submit_cidr_vs_reference_service(name, fault):
    """Device-mode batches, port-carrying and portless queries mixed
    (and, with the fault armed, the host-index failover of the batch
    that hit it): the answers the reference service gives."""
    m, rm, (nets, acl, addrs, ports) = matchers(name)
    n = 96
    queries = [(addrs[i], None if (ports is None or i % 3 == 0)
                else ports[i]) for i in range(n)]
    if fault:
        failpoint.arm("device.dispatch.error", count=1)
        RFP.arm("device.dispatch.error", count=1)
    svc, rsvc = ClassifyService(mode="device"), RefService(mode="device")
    try:
        l0 = E.dispatch_launches_total()
        got = run_cidr(svc, m, queries)
        want = run_cidr(rsvc, rm, queries)
        assert got == want
        st = svc.stats
        assert st.queries == n and st.device_queries + st.oracle_queries == n
        assert (st.failovers >= 1) == fault
        if not fault:
            assert st.device_queries == n
            assert E.dispatch_launches_total() - l0 == st.dispatches >= 1
        snap = m.snapshot()
        for (a, p), (idx, pl) in zip(queries, got):
            assert idx == m.index_snap(snap, a, p) and pl == "pl"
    finally:
        svc.close()
        rsvc.close()


def test_mixed_port_and_portless_cidr_queries_keep_semantics():
    """tests/test_service.py's case: port=None means 'ignore port
    ranges' — it must not be coerced to port 0 when sharing a flush
    with port-carrying queries."""
    acls = [AclRule(f"r{i}", Network(bytes([10, i, 0, 0]), mask_bytes(16)),
                    Proto.TCP, 1000, 2000, True) for i in range(20)]
    m = E.CidrMatcher([a.network for a in acls], acl=acls)
    svc = ClassifyService(mode="device")
    try:
        queries = [(bytes([10, i % 20, 1, 2]), 1500 if i % 2 == 0 else None)
                   for i in range(40)]
        got = run_cidr(svc, m, queries)
        for i, (a, p) in enumerate(queries):
            assert got[i][0] == m.oracle_one(a, p) == i % 20, i
        assert svc.stats.dispatches >= 2  # the two halves never share one
    finally:
        svc.close()


def test_split_uniform_separates_portless():
    R = type("R", (), {})
    reqs = []
    for p in (80, None, 443, None):
        r = R()
        r.payload = (b"\x0a\x00\x00\x01", p)
        reqs.append(r)
    parts = ClassifyService._split_uniform("cidr", reqs)
    assert [[r.payload[1] for r in part] for part in parts] == \
        [[80, 443], [None, None]]
    assert ClassifyService._split_uniform("cidr", reqs[:1]) == [reqs[:1]]
    assert ClassifyService._split_uniform("hint", reqs) == [reqs]


def test_service_cidr_inline_lone_query():
    m, _, (nets, acl, addrs, ports) = matchers("acl_500")
    svc = ClassifyService(mode="auto")
    try:
        res = []
        svc.submit_cidr(m, addrs[3], ports[3],
                        lambda i, pl: res.append((i, pl)))
        assert res == [(m.oracle_one(addrs[3], ports[3]), "pl")]
        assert svc.stats.inline_fast == 1 and svc.stats.dispatches == 0
    finally:
        svc.close()


def test_service_cidr_kernel_error_closes_instead_of_failover(monkeypatch):
    """A KernelError from a cidr batch closes the service: the batch is
    answered -1, nothing is served from the host, submits raise. The
    torch tier is stubbed to raise what the CUDA wrapper raises when
    its kernel cannot launch."""
    m, _, (nets, acl, addrs, ports) = matchers("acl_500")
    submitted = threading.Event()

    def refused(*a):
        submitted.wait(10)
        raise FC.KernelError("cidr kernel launch failed: CUDA error 209")
    monkeypatch.setattr(H, "cidr_hash_match", refused)
    svc = ClassifyService(mode="device")
    try:
        n = 24
        got, evs = [None] * n, [threading.Event() for _ in range(n)]
        for i in range(n):
            svc.submit_cidr(m, addrs[i], ports[i], lambda idx, pl, i=i: (
                got.__setitem__(i, idx), evs[i].set()))
        submitted.set()
        assert all(ev.wait(30) for ev in evs)
        assert got == [-1] * n
        assert isinstance(svc.error, FC.KernelError)
        st = svc.stats
        assert st.failovers == 0 and st.oracle_queries == 0
        with pytest.raises(FC.KernelError, match="CUDA error 209"):
            svc.submit_cidr(m, addrs[0], ports[0], lambda *r: None)
        evs_ = [e for e in events.FlightRecorder.get().snapshot()
                if e["kind"] == "classify_kernel_error"]
        assert evs_ and evs_[-1]["classify_kind"] == "cidr"
    finally:
        svc.close()


# ------------------------------------------------------------ SecurityGroup


def group_pair(default_allow, acl):
    sg, rg = SecurityGroup("g", default_allow=default_allow), \
        RefGroup("g", default_allow=default_allow)
    if acl:
        sg.extend_rules(acl)
        rg.extend_rules(ref_acl(acl))
    return sg, rg


@pytest.mark.parametrize("default_allow", [True, False])
def test_security_group_vs_reference(default_allow):
    acl = acl_rules(300, 26)
    udp = [AclRule("u0", Network(parse_ip("10.0.0.0"), mask_bytes(8)),
                   Proto.UDP, 53, 53, not default_allow)]
    sg, rg = group_pair(default_allow, acl + udp)
    fired = []
    sg.add_listener(lambda: fired.append(1))
    q = acl_queries(acl, 200, 27)
    addrs, ports = [a for a, _ in q], [p for _, p in q]
    for proto in (Proto.TCP, Proto.UDP):
        rp = RIR.Proto(proto.value)
        assert sg.trivial_allow(proto) == rg.trivial_allow(rp)
        assert sg.allow_batch(proto, addrs, ports) == \
            rg.allow_batch(rp, addrs, ports)
        assert [sg.allow(proto, a, p) for a, p in q[:60]] == \
            [rg.allow(rp, a, p) for a, p in q[:60]]
    # mutations: add, remove, the refusals, listeners
    extra = AclRule("x", Network(parse_ip("44.0.0.0"), mask_bytes(8)),
                    Proto.TCP, 0, 65535, not default_allow)
    sg.add_rule(extra)
    rg.add_rule(ref_acl([extra])[0])
    for bad in (extra, AclRule("y", extra.network, Proto.TCP, 0, 65535,
                               default_allow)):
        with pytest.raises(ValueError):
            sg.add_rule(bad)
    sg.remove_rule("acl3")
    rg.remove_rule("acl3")
    with pytest.raises(KeyError):
        sg.remove_rule("nope")
    assert len(fired) == 2
    assert [r.alias for r in sg.rules] == [r.alias for r in rg.rules]
    assert sg.allow_batch(Proto.TCP, addrs, ports) == \
        rg.allow_batch(RIR.Proto.TCP, addrs, ports)
    sg.remove_rule("u0")
    rg.remove_rule("u0")
    assert sg.trivial_allow(Proto.UDP) == rg.trivial_allow(RIR.Proto.UDP)
    with pytest.raises(ValueError):
        sg.extend_rules([acl[0]])


def test_security_group_allow_async_rides_submit_cidr(monkeypatch):
    """allow_async answers through ClassifyService.submit_cidr (a batch
    of 48 in device mode), each answer the reference group's allow();
    an empty proto answers at once with the default."""
    monkeypatch.setenv("VPROXY_TPU_CLASSIFY", "device")
    ClassifyService.reset()
    acl = acl_rules(400, 28)
    sg, rg = group_pair(False, acl)
    q = acl_queries(acl, 48, 29)
    got = [None] * len(q)
    evs = [threading.Event() for _ in q]
    try:
        for i, (a, p) in enumerate(q):
            sg.allow_async(Proto.TCP, a, p, lambda ok, i=i: (
                got.__setitem__(i, ok), evs[i].set()))
        assert all(ev.wait(30) for ev in evs)
        assert got == [rg.allow(RIR.Proto.TCP, a, p) for a, p in q]
        st = ClassifyService.get().stats
        assert st.device_queries == len(q) and st.dispatches >= 1
        res = []
        sg.allow_async(Proto.UDP, q[0][0], 53, res.append)
        assert res == [False]
    finally:
        ClassifyService.reset()


def test_security_group_allow_all():
    sg = SecurityGroup.allow_all()
    assert sg.alias == SecurityGroup.DEFAULT_NAME and sg.default_allow
    assert sg.trivial_allow(Proto.TCP) and sg.allow(Proto.TCP, bytes(4), 1)


# --------------------------------------------- the CUDA entries: no fallback


def _cidr_inputs(device):
    nets = route_nets(300, 30)
    ct = up(F.pack_cidr_table(H.compile_cidr_hash(nets).arrays), "cpu")
    a16, fam, p = tq(*encoded([a for a, _ in cidr_queries(nets, 8, 31)],
                              None))
    if device != "cpu":
        ct = {k: v.to(device) for k, v in ct.items()}
        a16, fam = a16.to(device), fam.to(device)
    return ct, a16, fam


def test_cidr_entry_serves_cpu_tensors_with_plain_tier():
    ct, a16, fam = _cidr_inputs("cpu")
    n0 = CC.cidr_first_cuda.launches
    out = CC.cidr_first(ct, a16, fam)
    assert torch.equal(out, F._cidr_first_packed(ct, a16, fam, None))
    assert CC.cidr_first_cuda.launches == n0


def test_cidr_entries_raise_on_non_cpu_tensor(monkeypatch):
    """A tensor off the CPU goes to the kernel or raises, for B4 and for
    the fused kernel's route column: no plain tier is substituted
    (meta tensors stand in for CUDA ones on this CPU-only build)."""
    called = []
    monkeypatch.setattr(F, "_cidr_first_packed",
                        lambda *a: called.append(a))
    monkeypatch.setattr(F, "fused_classify_pick",
                        lambda *a: called.append(a))
    ct, a16, fam = _cidr_inputs("meta")
    n0 = CC.cidr_first_cuda.launches
    with pytest.raises(FC.KernelError):
        CC.cidr_first(ct, a16, fam)
    rules = mk_rules(64)
    htab = H.compile_hint_hash(rules)
    ht = {k: v.to("meta") for k, v in
          up(F.pack_hint_table(htab.arrays), "cpu").items()}
    q = {k: v.to("meta") for k, v in up(H.encode_hint_queries(
        mk_queries(rules, 8), htab), "cpu").items()}
    with pytest.raises(FC.KernelError):
        FC.fused_classify_pick(ht, q, torch.zeros(5, dtype=torch.int32,
                                                  device="meta"),
                               torch.zeros(8, dtype=torch.int64,
                                           device="meta"),
                               ct, a16, fam, None)
    assert not called and CC.cidr_first_cuda.launches == n0


def test_cidr_matcher_off_cpu_refuses_to_publish_without_kernel(
        monkeypatch):
    """A CidrMatcher off the CPU builds the CIDR kernel when it
    publishes, whatever VPROXY_TPU_FUSED says: a build failure stops
    construction."""
    def no_lib():
        raise FC.KernelError("nvcc failed (1)")
    monkeypatch.setattr(CC, "_lib", no_lib)
    for fused in ("1", "0"):
        monkeypatch.setenv("VPROXY_TPU_FUSED", fused)
        with pytest.raises(FC.KernelError):
            E.CidrMatcher(route_nets(64, 32), device="meta")


def test_cidr_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(FC, "CUDA_DEFAULT", str(tmp_path / "cuda"))
    monkeypatch.setattr(FC, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(FC.KernelError, match="nvcc"):
        CC.build()
    assert not (tmp_path / "build").exists()


def test_cidr_kernel_abi_mirror_matches_source():
    """The ctypes CidrArgs mirror has the C struct's fields, in order,
    and the packed-table pointers of both kernels' structs follow
    TABLE_DTYPES (the .cu files compile only on the GPU host)."""
    with open(CC.SOURCE) as f:
        src = f.read()
    body = re.search(r"struct CidrArgs \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    ptrs = re.findall(r"\*\s*(\w+);", body)
    ints = [x.strip() for decl in re.findall(r"int32_t ([\w ,]+);", body)
            for x in decl.split(",")]
    assert tuple(ptrs) == CC._PTRS and tuple(ints) == CC._INTS
    assert ctypes.sizeof(CC._CidrArgs) == 8 * len(ptrs) + 4 * len(ints) + (
        4 if len(ints) % 2 else 0)
    table = tuple(CC.TABLE_DTYPES)
    i = FC._PTRS.index(table[0])
    assert FC._PTRS[i: i + len(table)] == table
    with open(FC.CIDR_HEADER) as f:
        hdr = re.search(r"struct Table \{(.*?)\};", f.read(), re.S).group(1)
    assert tuple(re.findall(r"\*\s*(\w+);", re.sub(r"//[^\n]*", "",
                                                       hdr))) == table
