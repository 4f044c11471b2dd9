"""Torch port, the packed-fingerprint backend ("torch-fp", the reference's
"jax-fp"): compilers, plain tier, matchers, service, the CUDA entries.

The same seeded inputs go through vproxy_tpu on the JAX CPU backend and
through the port on torch's CPU (VPROXY_TPU_TORCH_DEVICE=cpu); every
comparison is exact:

* compile_hint_fp / compile_cidr_fp, byte for byte with every cap, salt,
  lset, window, n4 and S1/S2: the hint sets of tests/test_torch_kernels
  and the fingerprint-specific ones below, the CIDR sets of
  tests/test_torch_cidr, routes with and without the trie (by caps and
  by VPROXY_TPU_NO_TRIE), a trie ACL, the touch-limit fallback, the
  mk > 128 rebuild, a v6-only table, caps reuse, and FpBuildError /
  CapsExceeded where the reference raises them;
* encode_hint_queries_fp dicts, with and without the um_* copies;
* hint_fp_match (index and level), cidr_fp_match (routes, ACL with ports
  and with None, pad rows of family -1) and classify_fp_all, int32,
  against each of the reference's three member modes;
* the 15 cases of tests/test_fphash.py, ported onto this package and
  its oracle;
* HintMatcher / CidrMatcher(backend="torch-fp") against the reference's
  "jax-fp" matchers across caps-reusing and caps-outgrowing updates,
  ClassifyService's hint, cpick and cidr kinds against the reference
  service, and VPROXY_TPU_MATCHER=jax-fp selecting "torch-fp";
* the CUDA entries (ops/fphash_cuda.py) serve CPU tensors with the plain
  tier and never substitute it for a tensor off the CPU, a CUDA matcher
  stops its publish when a kernel cannot build, and the ctypes mirrors
  match the C structs (the .cu files compile only on the GPU host).
"""
import ctypes
import functools
import inspect
import random
import re

import numpy as np
import pytest
import torch

import chip_smoke as CS
from test_fused import mk_ips, mk_queries, mk_rules
from test_torch_cidr import (acl_queries, acl_rules, cidr_case,
                             cidr_queries, ref_acl, ref_net, route_nets,
                             run_cidr, same_arrays)
from test_torch_engine import ports_of, run_service
from test_torch_kernels import case as hint_case_of
from vproxy_tpu.ops import fphash as RFP
from vproxy_tpu.ops import hashmatch as RH
from vproxy_tpu.ops import tables as RT
from vproxy_tpu.rules import engine as RE
from vproxy_tpu.rules import maglev as RM
from vproxy_tpu.rules.service import ClassifyService as RefService
from vproxy_tpu.utils import failpoint as RFPT
from vproxy_tpu_torch.ops import fphash as F
from vproxy_tpu_torch.ops import fphash_cuda as FPC
from vproxy_tpu_torch.ops import fused_cuda as FC
from vproxy_tpu_torch.ops import hashmatch as H
from vproxy_tpu_torch.ops import tables as T
from vproxy_tpu_torch.rules import engine as E
from vproxy_tpu_torch.rules import maglev as M
from vproxy_tpu_torch.rules import oracle
from vproxy_tpu_torch.rules.engine import _pad_hint_q
from vproxy_tpu_torch.rules.ir import (AclRule, Hint, HintRule, Proto,
                                       RouteRule, RouteTable)
from vproxy_tpu_torch.rules.service import ClassifyService
from vproxy_tpu_torch.utils import failpoint
from vproxy_tpu_torch.utils.ip import Network, mask_bytes, parse_ip
from vproxy_tpu_torch.utils.torchenv import tables_from_reference as up

torch.set_num_threads(1)

MODES = ("gather", "selgather", "reduce")


@pytest.fixture(autouse=True)
def cpu_and_clean(monkeypatch):
    monkeypatch.setenv("VPROXY_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("VPROXY_TPU_INSTALL_PACE", "0")
    monkeypatch.delenv("VPROXY_TPU_NO_TRIE", raising=False)
    monkeypatch.delenv("VPROXY_TPU_FP_MEMBER", raising=False)
    monkeypatch.delenv("VPROXY_TPU_MATCHER", raising=False)
    failpoint.clear()
    RFPT.clear()
    yield
    failpoint.clear()
    RFPT.clear()


# ------------------------------------------------------------ generators
# Copied into chip_smoke.py, which holds the CUDA kernels to the plain
# tier on them (test_chip_smoke_carries_the_fp_cases holds the copies
# equal).

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


# ------------------------------------------------------------- the cases

# the boundary sets with their uri rules (their host-only variants add
# no fingerprint layout host_only_b96 and long_hosts do not cover)
HINT_CASES = tuple(c for c in CS.BOUNDARY_CASES
                   if not c.endswith("_hosts")) + (
    "host_only_b96", "long_hosts", "mk_rules_5k_b512", "random_300_b600",
    "shared_keys", "wide_buckets", "member_overflow", "uri_untrimmed",
    "no_host_rules", "probe_rounds", "last_entry", "wildcards")


def hint_case(name):
    """-> (rules, hints) of one hint case."""
    if name == "member_overflow":
        return fp_member_overflow()
    if name == "uri_untrimmed":
        return fp_uri_untrimmed()
    if name in ("probe_rounds", "last_entry", "wildcards"):
        return globals()[f"fp_{name}"]()
    if name == "no_host_rules":
        return ([HintRule(port=443), HintRule(uri="/a"),
                 HintRule(host="h.io")],
                [Hint(port=443), Hint(host="h.io", port=443),
                 Hint(uri="/a/b"), Hint(host="x.h.io", uri="/a")])
    rules, hints, _ = hint_case_of(name)
    return rules, hints


@functools.lru_cache(maxsize=None)
def hint_compiled(name):
    rules, hints = hint_case(name)
    return rules, hints, RFP.compile_hint_fp(rules), F.compile_hint_fp(rules)


def same_hint_tables(r, p):
    same_arrays(r.arrays, p.arrays)
    for k in ("n", "r_cap", "host_cap", "host_salts", "uri_cap", "uri_salts",
              "lset", "hw", "uw", "caps"):
        assert getattr(r, k) == getattr(p, k), k


def same_cidr_tables(r, p):
    same_arrays(r.arrays, p.arrays)
    for k in ("n", "r_cap", "n4", "caps"):
        assert getattr(r, k) == getattr(p, k), k
    same_arrays(r.arrays_v4, p.arrays_v4)


def padded(q: dict, k: int = 8) -> dict:
    """The engine's array-level batch padding: k zero-filled pad rows."""
    return _pad_hint_q(q, next(iter(q.values())).shape[0] + k, {})


@pytest.mark.parametrize("name", HINT_CASES)
def test_compile_hint_fp_byte_identical(name):
    _, _, rt, pt = hint_compiled(name)
    same_hint_tables(rt, pt)


def test_compile_hint_fp_mk_rules_2k_byte_identical():
    rules = mk_rules(2000)
    rt, pt = RFP.compile_hint_fp(rules), F.compile_hint_fp(rules)
    same_hint_tables(rt, pt)
    hints = mk_queries(rules, 300)
    same_arrays(RFP.encode_hint_queries_fp(hints, rt),
                F.encode_hint_queries_fp(hints, pt))


@pytest.mark.parametrize("name", HINT_CASES)
def test_encode_hint_queries_fp_identical(name):
    _, hints, rt, pt = hint_compiled(name)
    same_arrays(RFP.encode_hint_queries_fp(hints, rt),
                F.encode_hint_queries_fp(hints, pt))


def test_encode_trims_and_keeps_um_copies():
    """uri_untrimmed keeps up_* whole; a batch of short uris trims them
    and carries um_* (both encoders alike, by the test above)."""
    rules, hints = fp_uri_untrimmed()
    tab = F.compile_hint_fp(rules)
    assert "um_fp1" not in F.encode_hint_queries_fp(hints, tab)
    q = F.encode_hint_queries_fp([Hint(uri="/ab"), Hint(host="x.io")], tab)
    assert "um_fp1" in q and q["up_slot"].shape[1] < q["um_fp1"].shape[1]
    same_arrays(RFP.encode_hint_queries_fp([Hint(uri="/ab"),
                                            Hint(host="x.io")],
                                           RFP.compile_hint_fp(rules)), q)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", HINT_CASES)
def test_hint_fp_match_vs_jax(name, mode):
    """The plain tier against the reference in each member mode, on the
    case's batch plus 8 pad rows (zero-filled: no live probe)."""
    _, hints, rt, pt = hint_compiled(name)
    q = padded(F.encode_hint_queries_fp(hints, pt))
    ri, rl = RFP.hint_fp_jit(rt.arrays, q, mode=mode)
    gi, gl = F.hint_fp_match(up(pt.arrays, "cpu"), up(q, "cpu"), mode=mode)
    assert gi.dtype == gl.dtype == torch.int32
    assert np.array_equal(np.asarray(ri), gi.numpy())
    assert np.array_equal(np.asarray(rl), gl.numpy())
    assert (gi[len(hints):] == -1).all() and (gl[len(hints):] == 0).all()


def test_fp_hash_helpers_bit_identical():
    """The u32 arithmetic in int64: fmix32, the 4-word FNV and the word
    packing against the numpy forms, on values with the top bit set."""
    rng = np.random.default_rng(3)
    w = rng.integers(0, 2**32, (64, 5, 4), dtype=np.uint64).astype(np.uint32)
    w[0] = 0xFFFFFFFF
    salt = rng.integers(0, 2**32, 5, dtype=np.uint64).astype(np.uint32)
    got = F._fnv32_words_dev(torch.from_numpy(w.astype(np.int64)),
                             torch.from_numpy(salt))
    want = np.stack([RFP.fnv32_words_np(w[:, g], salt[g])
                     for g in range(5)], axis=1)
    assert (want >= 2**31).any() and np.array_equal(got.numpy(), want)
    h = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(F._fmix32_dev(torch.from_numpy(
        h.astype(np.int64))).numpy(), RFP._fmix32_np(h))
    b16 = rng.integers(0, 256, (32, 16), dtype=np.uint8)
    assert np.array_equal(F._pack_words16_dev(torch.from_numpy(b16)).numpy(),
                          RFP._pack_words16(b16))


def test_default_member_mode_like_reference(monkeypatch):
    assert F.MEMBER_MODES == RFP.MEMBER_MODES
    for mode in MODES:
        monkeypatch.setenv("VPROXY_TPU_FP_MEMBER", mode)
        assert F.default_member_mode() == RFP.default_member_mode() == mode
    monkeypatch.setenv("VPROXY_TPU_FP_MEMBER", "einsum")
    for mod in (F, RFP):
        with pytest.raises(ValueError, match="VPROXY_TPU_FP_MEMBER"):
            mod.default_member_mode()
    rules, hints = fp_member_overflow()
    tab = F.compile_hint_fp(rules)
    with pytest.raises(ValueError, match="unknown member mode"):
        F.hint_fp_match(up(tab.arrays, "cpu"), up(
            F.encode_hint_queries_fp(hints, tab), "cpu"), mode="einsum")


# ------------------------------------------------------------- cidr side

CIDR_CASES = ("route_200", "acl_port_buckets", "mixed_families",
              "routes_2k", "acl_500", "acl_500_portless", "empty",
              "v6_many_masks", "acl_deep_buckets", "routes_2k_no_trie",
              "routes_2k_env_no_trie", "trie_first_match",
              "trie_acl_overlap", "acl_stacked", "v6_only", "acl_5k",
              "v6_all_masks", "last_entry_routes", "acl_deep_buckets_no_trie")


@functools.lru_cache(maxsize=None)
def fp_cidr_case(name):
    """-> (nets, acl or None, addrs, ports or None, caps, env no_trie)."""
    if name == "acl_deep_buckets_no_trie":
        return (*cidr_case("acl_deep_buckets"), {"no_trie": 1}, False)
    if name in ("v6_all_masks", "last_entry_routes"):
        nets, addrs = globals()[f"fp_{name}"]()
        return nets, None, addrs, None, None, False
    if name.endswith("no_trie"):
        nets, acl, addrs, ports = cidr_case("routes_2k")
        return nets, acl, addrs, ports, \
            None if "env" in name else {"no_trie": 1}, "env" in name
    if name == "trie_first_match":
        nets, addrs = fp_trie_first_match()
        return nets, None, addrs, None, None, False
    if name in ("trie_acl_overlap", "acl_stacked", "acl_5k"):
        acl, q = fp_trie_acl_overlap() if name == "trie_acl_overlap" else \
            fp_acl_stacked() if name == "acl_stacked" else (
                acl_rules(5000, 42), None)
        if q is None:
            q = acl_queries(acl, 400, 43)
        return [r.network for r in acl], acl, [a for a, _ in q], \
            [p for _, p in q], None, False
    if name == "v6_only":
        nets, addrs = fp_v6_only()
        return nets, None, addrs, None, None, False
    return (*cidr_case(name), None, False)


@functools.lru_cache(maxsize=None)
def cidr_compiled(name):
    nets, acl, addrs, ports, caps, env = fp_cidr_case(name)
    mp = pytest.MonkeyPatch()
    if env:
        mp.setenv("VPROXY_TPU_NO_TRIE", "1")
    try:
        rt = RFP.compile_cidr_fp([ref_net(n) for n in nets],
                                 acl=ref_acl(acl), caps=caps)
        pt = F.compile_cidr_fp(nets, acl=acl, caps=caps)
    finally:
        mp.undo()
    return rt, pt, (nets, acl, addrs, ports)


@pytest.mark.parametrize("name", CIDR_CASES)
def test_compile_cidr_fp_byte_identical(name):
    rt, pt, _ = cidr_compiled(name)
    same_cidr_tables(rt, pt)


def test_compile_cidr_fp_layouts():
    """Each layout the cases are there for is the one they get."""
    def arrays(name):
        return cidr_compiled(name)[1].arrays
    assert "t_l0" in arrays("routes_2k") and "t_l0" in arrays("acl_500")
    for name in ("routes_2k_no_trie", "routes_2k_env_no_trie", "v6_only",
                 "acl_stacked", "acl_5k"):
        assert "t_l0" not in arrays(name), name
    assert cidr_compiled("acl_5k")[1].caps.get("no_trie") == 1  # touch limit
    assert cidr_compiled("acl_stacked")[1].caps["Mk"] > 128  # the rebuild
    assert "mrows" in arrays("trie_acl_overlap") and \
        "t_l0" in arrays("trie_acl_overlap")


def cidr_batch(addrs, ports, k: int = 8):
    """Encoded addresses + k pad rows (family -1) as CPU tensors."""
    a16, fam = T.encode_ips(addrs)
    a16 = np.concatenate([a16, np.zeros((k, 16), np.uint8)])
    fam = np.concatenate([fam, np.full(k, -1, np.int32)])
    p = None if ports is None else np.concatenate(
        [np.asarray(ports, np.int32), np.zeros(k, np.int32)])
    return a16, fam, p


@pytest.mark.parametrize("gate", ["ports", "none"])
@pytest.mark.parametrize("name", CIDR_CASES)
def test_cidr_fp_match_vs_jax(name, gate):
    rt, pt, (nets, acl, addrs, ports) = cidr_compiled(name)
    a16, fam, p = cidr_batch(addrs, ports if gate == "ports" else None)
    want = np.asarray(RFP.cidr_fp_jit(rt.arrays, a16, fam, p))
    got = F.cidr_fp_match(up(pt.arrays, "cpu"), torch.from_numpy(a16),
                          torch.from_numpy(fam),
                          None if p is None else torch.from_numpy(p))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert (got[len(addrs):] == -1).all()


FP_VARIANTS = tuple((n, h) for n, hows in CS.FP_VARIANTS.items()
                    for h in hows)


@pytest.mark.parametrize("name,how", FP_VARIANTS)
def test_cidr_fp_match_variant_vs_jax(name, how):
    """The plain tier against the reference on chip_smoke's table
    variants, which take B7's other paths: cut short where the reference
    clamps (slot rows, member rows, trie subtables), or rows twice as
    wide with every entry in the second half."""
    rt, pt, (nets, acl, addrs, ports) = cidr_compiled(name.replace(" ", "_"))
    rv, pv = (CS.fp_table_variant(t.arrays, how) for t in (rt, pt))
    same_arrays(rv, pv)
    a16, fam, p = cidr_batch(addrs, ports)
    want = np.asarray(RFP.cidr_fp_jit(rv, a16, fam, p))
    got = F.cidr_fp_match(up(pv, "cpu"), torch.from_numpy(a16),
                          torch.from_numpy(fam),
                          None if p is None else torch.from_numpy(p))
    assert np.array_equal(got.numpy(), want)
    assert (got[: len(addrs)] >= 0).any()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["random_300_b600", "wildcards"])
def test_hint_fp_match_rec_cut_vs_jax(name, mode):
    """The plain tier against the reference on a slot table cut short
    where the reference clamps a probe's slot (chip_smoke's "rec"
    variant)."""
    _, hints, rt, pt = hint_compiled(name)
    q = padded(F.encode_hint_queries_fp(hints, pt))
    rv, pv = (CS.fp_table_variant(t.arrays, "rec") for t in (rt, pt))
    ri, rl = RFP.hint_fp_jit(rv, q, mode=mode)
    gi, gl = F.hint_fp_match(up(pv, "cpu"), up(q, "cpu"), mode=mode)
    assert np.array_equal(np.asarray(ri), gi.numpy())
    assert np.array_equal(np.asarray(rl), gl.numpy())


@pytest.mark.parametrize("mode", MODES)
def test_classify_fp_all_vs_jax(mode, monkeypatch):
    monkeypatch.setenv("VPROXY_TPU_FP_MEMBER", mode)
    rules = mk_rules(600)
    hints = mk_queries(rules, 96)
    rnets, racl = route_nets(1000, 23), acl_rules(300, 24)
    aq = acl_queries(racl, 96, 25)
    addrs = [a for a, _ in aq[:48]] + [a for a, _ in
                                       cidr_queries(rnets, 48, 26)]
    ports = [p for _, p in aq]
    ht, rt, at = (RFP.compile_hint_fp(rules),
                  RFP.compile_cidr_fp([ref_net(n) for n in rnets]),
                  RFP.compile_cidr_fp([ref_net(r.network) for r in racl],
                                      acl=ref_acl(racl)))
    q = padded(RFP.encode_hint_queries_fp(hints, ht))
    a16, fam, p = cidr_batch(addrs, ports)
    # a fresh jit: the member mode is read when the function traces
    import jax
    want = np.asarray(jax.jit(RFP.classify_fp_all)(
        ht.arrays, rt.arrays, at.arrays, q, a16, fam, p))
    got = FPC.classify_fp_all(
        up(F.compile_hint_fp(rules).arrays, "cpu"),
        up(F.compile_cidr_fp(rnets).arrays, "cpu"),
        up(F.compile_cidr_fp([r.network for r in racl], acl=racl).arrays,
           "cpu"), up(q, "cpu"), torch.from_numpy(a16),
        torch.from_numpy(fam), torch.from_numpy(p))
    assert got.shape == (104, 3) and np.array_equal(got.numpy(), want)
    assert (got[:, 0] >= 0).any() and (got[:, 1] >= 0).any() and \
        (got[:, 2] >= 0).any()


@pytest.mark.parametrize("step", ["reuse", "growth"])
def test_compile_fp_caps_reuse_and_growth(step):
    """An update compiled with the published caps: the same shapes when
    it fits (and the same bytes as the reference's), CapsExceeded in
    both packages when it outgrows them under strict, and the grown
    caps without strict."""
    r1 = mk_rules(300)
    r2 = mk_rules(280, seed=5) if step == "reuse" else mk_rules(3000, seed=5)
    n1, n2 = route_nets(300, 31), route_nets(250 if step == "reuse" else
                                             3000, 32)
    for comp, a, b in ((F.compile_hint_fp, r1, r2), (
            F.compile_cidr_fp, n1, n2)):
        rcomp = getattr(RFP, comp.__name__)
        conv = (lambda x: x) if comp is F.compile_hint_fp else \
            (lambda x: [ref_net(n) for n in x])
        caps = comp(a).caps
        assert rcomp(conv(a)).caps == caps
        if step == "reuse":
            got, want = comp(b, caps=caps), rcomp(conv(b), caps=caps)
            assert got.caps == want.caps == {**caps, **got.caps}
            same_arrays(want.arrays, got.arrays)
            if comp is F.compile_hint_fp:  # the plain tier on the reuse
                q = padded(F.encode_hint_queries_fp(
                    mk_queries(b, 64, seed=9), got))
                gi, gl = F.hint_fp_match(up(got.arrays, "cpu"),
                                         up(q, "cpu"))
                for mode in MODES:
                    ri, rl = RFP.hint_fp_jit(want.arrays, q, mode=mode)
                    assert np.array_equal(np.asarray(ri), gi.numpy())
                    assert np.array_equal(np.asarray(rl), gl.numpy())
        else:
            for c in (comp, rcomp):
                with pytest.raises(Exception) as ei:
                    c(b if c is comp else conv(b), caps=caps)
                assert type(ei.value).__name__ == "CapsExceeded"
            with pytest.raises(H.CapsExceeded):
                comp(b, caps=caps)
            same_arrays(rcomp(conv(b), caps=caps, strict=False).arrays,
                        comp(b, caps=caps, strict=False).arrays)


def test_fp_build_errors_like_reference():
    """Salting that never separates two keys (a hasher whose pairs are
    all (0, 0)): both packages give up with FpBuildError after the same
    attempts; a host past MAX_HOST is a ValueError in both."""
    seen = {F: [], RFP: []}
    for mod in (F, RFP):
        def hasher(k, s, mod=mod):
            seen[mod].append(s)
            return 0
        with pytest.raises(mod.FpBuildError):
            mod._place_fp([b"a", b"b"], hasher, 16, 3)
    assert seen[F] == seen[RFP] and len(seen[F]) == 16 * 3
    long_ = [HintRule(host="a" * 65)]
    for c in (F.compile_hint_fp, RFP.compile_hint_fp):
        with pytest.raises(ValueError, match="host rule longer"):
            c(long_)


def test_chip_smoke_carries_the_fp_cases():
    """chip_smoke.py holds B6 and B7 to the plain tier on copies of this
    file's generators: the same source."""
    for fn in ("fp_member_overflow", "fp_uri_untrimmed",
               "fp_trie_first_match", "fp_trie_acl_overlap",
               "fp_acl_stacked", "fp_v6_only", "fp_v6_all_masks",
               "fp_last_entry_routes", "fp_last_entry", "fp_probe_rounds",
               "fp_wildcards"):
        assert inspect.getsource(getattr(CS, fn)) == \
            inspect.getsource(globals()[fn]), fn


# ----------------------------------- tests/test_fphash.py, on the port

def _rand_domain(rnd):
    return ".".join(rnd.choice(CS.WORDS) for _ in range(rnd.randint(1, 3))) \
        + "." + rnd.choice(CS.TLDS)


def _rand_uri(rnd):
    return "/" + "/".join(rnd.choice(CS.WORDS)
                          for _ in range(rnd.randint(1, 4)))


def _rand_hint_rule(rnd):
    host = uri = None
    port = 0
    while host is None and uri is None and port == 0:
        if rnd.random() < 0.7:
            host = "*" if rnd.random() < 0.1 else _rand_domain(rnd)
        if rnd.random() < 0.5:
            uri = "*" if rnd.random() < 0.1 else _rand_uri(rnd)
        if rnd.random() < 0.3:
            port = rnd.choice([80, 443, 8080])
    return HintRule(host=host, port=port, uri=uri)


def _rand_hint(rnd):
    host = _rand_domain(rnd) if rnd.random() < 0.8 else None
    if host and rnd.random() < 0.5:
        host = rnd.choice(CS.WORDS) + "." + host
    uri = _rand_uri(rnd) if rnd.random() < 0.6 else None
    return Hint(host=host, port=rnd.choice([0, 80, 443, 8080]), uri=uri)


def _match(tab, hints):
    idx, level = F.hint_fp_match(up(tab.arrays, "cpu"), up(
        F.encode_hint_queries_fp(hints, tab), "cpu"))
    return idx.numpy(), level.numpy()


def check_hints(rules, hints):
    idx, level = _match(F.compile_hint_fp(rules), hints)
    for i, h in enumerate(hints):
        want = oracle.search(rules, h)
        assert idx[i] == want, (i, h, int(idx[i]), want)
        if want >= 0:
            assert level[i] == oracle.match_level(h, rules[want])


def _cidr(tab, addrs, ports=None, arrays=None):
    a16, fam = T.encode_ips(addrs)
    return F.cidr_fp_match(
        up(arrays or tab.arrays, "cpu"), torch.from_numpy(a16),
        torch.from_numpy(fam),
        None if ports is None else torch.tensor(ports, dtype=torch.int32)
    ).numpy()


def test_port_hint_fp_parity_random():
    rnd = random.Random(4321)
    rules = [_rand_hint_rule(rnd) for _ in range(300)]
    hints = [_rand_hint(rnd) for _ in range(600)]
    for i in range(0, 200, 3):
        r = rules[i % len(rules)]
        if r.host and r.host != "*":
            hints[i] = Hint(host=r.host, port=r.port or 0, uri=r.uri)
    check_hints(rules, hints)


def test_port_hint_fp_shared_keys_and_tiebreak():
    check_hints(*hint_case("shared_keys"))


def test_port_hint_fp_no_host_rules_and_empty():
    check_hints(*hint_case("no_host_rules"))


def test_port_hint_fp_long_host_boundaries():
    check_hints(*hint_case("long_hosts"))


def test_port_hint_fp_member_overflow_growth():
    check_hints(*fp_member_overflow())


def test_port_cidr_fp_route_parity():
    rnd = random.Random(4321)
    rt = RouteTable()
    for i in range(200):
        ml = rnd.choice([0, 8, 12, 16, 24, 32])
        ip = bytes([10 + i % 5, rnd.randint(0, 255), rnd.randint(0, 255), 0])
        m = mask_bytes(ml)
        net = Network(bytes(np.frombuffer(ip, np.uint8) &
                            np.frombuffer(m, np.uint8)), m)
        try:
            rt.add(RouteRule(f"r{i}", net))
        except ValueError:
            continue
    nets = [r.rule for r in rt.rules]
    tab = F.compile_cidr_fp(nets)
    addrs = [bytes([10 + rnd.randint(0, 6), rnd.randint(0, 255),
                    rnd.randint(0, 255), rnd.randint(0, 255)])
             for _ in range(400)]
    got, got4 = _cidr(tab, addrs), _cidr(tab, addrs, arrays=tab.arrays_v4)
    for i, a in enumerate(addrs):
        want = next((j for j, n in enumerate(nets) if n.contains_ip(a)), -1)
        assert got[i] == want and got4[i] == want, (i, a.hex())


def test_port_cidr_fp_acl_port_buckets():
    net = Network(parse_ip("10.1.0.0"), mask_bytes(16))
    acl = [AclRule("a", net, Proto.TCP, 80, 80, False),
           AclRule("b", net, Proto.TCP, 0, 1000, True),
           AclRule("c", net, Proto.TCP, 0, 65535, False),
           AclRule("d", Network(parse_ip("0.0.0.0"), mask_bytes(0)),
                   Proto.TCP, 0, 65535, True)]
    tab = F.compile_cidr_fp([r.network for r in acl], acl=acl)
    addrs = [parse_ip("10.1.2.3")] * 4 + [parse_ip("9.9.9.9")]
    ports = [80, 443, 2000, 65535, 80]
    got = _cidr(tab, addrs, ports)
    for i in range(len(addrs)):
        assert got[i] == oracle.acl_first_match(acl, Proto.TCP, addrs[i],
                                                ports[i])


def test_port_cidr_fp_acl_pruning_keeps_first_match():
    net = Network(parse_ip("10.2.0.0"), mask_bytes(16))
    acl = [AclRule("a", net, Proto.TCP, 0, 9000, True),
           AclRule("b", net, Proto.TCP, 100, 200, False),
           AclRule("c", net, Proto.TCP, 9500, 9600, False)]
    tab = F.compile_cidr_fp([r.network for r in acl], acl=acl)
    assert list(_cidr(tab, [parse_ip("10.2.3.4")] * 3,
                      [150, 9550, 9999])) == [0, 2, -1]


def test_port_cidr_fp_mixed_families():
    nets = [Network(parse_ip("192.168.0.0"), mask_bytes(16)),
            Network(parse_ip("fd00::"), mask_bytes(8))]
    addrs = [parse_ip("192.168.3.4"), parse_ip("::192.168.3.4"),
             parse_ip("::ffff:192.168.3.4"), parse_ip("fd00::1"),
             parse_ip("192.169.0.1")]
    got = _cidr(F.compile_cidr_fp(nets), addrs)
    for i, a in enumerate(addrs):
        assert got[i] == next((j for j, n in enumerate(nets)
                               if n.contains_ip(a)), -1)


def test_port_fp_vs_hashmatch_cross_check():
    rnd = random.Random(99)
    rules = [_rand_hint_rule(rnd) for _ in range(150)]
    hints = [_rand_hint(rnd) for _ in range(300)]
    ht = H.compile_hint_hash(rules)
    a = H.hint_hash_match(up(ht.arrays, "cpu"), up(
        H.encode_hint_queries(hints, ht), "cpu"))[0].numpy()
    assert np.array_equal(a, _match(F.compile_hint_fp(rules), hints)[0])


def test_port_engine_fp_backend_update_and_growth():
    m = E.HintMatcher([HintRule(host="a.com")], backend="torch-fp")
    assert m.match([Hint(host="a.com")])[0] == 0
    caps0 = dict(m._caps)
    m.set_rules([HintRule(host="b.com"), HintRule(host="a.com")])
    assert m.match([Hint(host="a.com")])[0] == 1
    assert m._caps["r_cap"] == caps0["r_cap"]
    m.set_rules([HintRule(host=f"h{i}.x.io") for i in range(600)])
    got = m.match([Hint(host="h123.x.io"), Hint(host="sub.h7.x.io")])
    assert got[0] == 123 and got[1] == 7


def test_port_engine_fp_vs_host_cross_check():
    rnd = random.Random(5)
    rules = [_rand_hint_rule(rnd) for _ in range(64)]
    hints = [_rand_hint(rnd) for _ in range(128)]
    assert np.array_equal(E.HintMatcher(rules, backend="torch-fp").match(hints),
                          E.HintMatcher(rules, backend="host").match(hints))
    m = E.CidrMatcher([Network(parse_ip("10.0.0.0"), mask_bytes(8)),
                       Network(parse_ip("10.1.0.0"), mask_bytes(16))],
                      backend="torch-fp")
    assert m.match([parse_ip("10.1.2.3")])[0] == 0
    assert m.match([parse_ip("11.0.0.1")])[0] == -1


def test_port_cidr_fp_trie_first_match_not_lpm():
    nets, addrs = fp_trie_first_match()
    tab = F.compile_cidr_fp(nets[:3])
    assert "t_l0" in tab.arrays
    assert _cidr(tab, addrs[:4]).tolist() == [0, 0, 0, -1]
    assert _cidr(F.compile_cidr_fp(nets[3:]), addrs[:4]).tolist() == \
        [0, 1, 2, -1]
    assert _cidr(tab, addrs[4:]).tolist() == [0]


def test_port_cidr_fp_trie_acl_overlap_stack():
    acl, q = fp_trie_acl_overlap()
    tab = F.compile_cidr_fp([r.network for r in acl], acl=acl)
    got = _cidr(tab, [a for a, _ in q], [p for _, p in q])
    for i, (a, p) in enumerate(q):
        want = next((j for j, r in enumerate(acl)
                     if r.network.contains_ip(a)
                     and r.min_port <= p <= r.max_port), -1)
        assert got[i] == want, (i, a.hex(), p)


def test_port_cidr_fp_trie_fallback_no_trie_cap():
    nets = [Network(parse_ip(f"10.{i}.0.0"), mask_bytes(16))
            for i in range(20)]
    t1, t2 = F.compile_cidr_fp(nets), F.compile_cidr_fp(nets,
                                                        caps={"no_trie": 1})
    assert "t_l0" in t1.arrays and "t_l0" not in t2.arrays
    addrs = [bytes([10, i, 1, 1]) for i in range(22)]
    assert _cidr(t1, addrs).tolist() == _cidr(t2, addrs).tolist()


# ------------------------------------------------------ matchers, service

def test_default_backend_reads_the_reference_names(monkeypatch):
    for env, want in (("jax-fp", "torch-fp"), ("host", "host"),
                      ("jax", "torch"), ("", "torch"),
                      ("jax-dense", "torch-dense")):
        monkeypatch.setenv("VPROXY_TPU_MATCHER", env)
        assert E.default_backend() == want, env
    # the reference backends not ported yet are refused with their
    # ROADMAP item, never served by "torch"
    for env, item in (("jax-sharded", 8), ("jax-fp-sharded", 8)):
        monkeypatch.setenv("VPROXY_TPU_MATCHER", env)
        with pytest.raises(ValueError,
                           match=f"ROADMAP Queue A item {item}"):
            E.default_backend()
        with pytest.raises(ValueError, match="not ported yet"):
            E.CidrMatcher(route_nets(20, 3))
    monkeypatch.delenv("VPROXY_TPU_MATCHER")
    assert E.default_backend() == "torch"
    monkeypatch.setenv("VPROXY_TPU_MATCHER", "jax-fp")
    assert E.HintMatcher(mk_rules(40)).backend == "torch-fp"
    assert E.CidrMatcher(route_nets(20, 3)).backend == "torch-fp"
    for b in ("jax-fp", "fp"):
        with pytest.raises(ValueError, match="unknown backend"):
            E.HintMatcher([], backend=b)


def ref_hint(rules):
    return RE.HintMatcher(rules, backend="jax-fp", payload="pl")


@pytest.mark.parametrize("pad_to", [None, 256])
def test_hint_matcher_torch_fp_vs_reference_across_updates(pad_to):
    """Published caps reused by an update that fits, a fresh build for
    one that outgrows them (CapsExceeded), the answers the reference's
    jax-fp matcher gives after each; dispatch_snap pads like the
    reference (pad rows never match)."""
    r0, hints = mk_rules(300), None
    m, rm = E.HintMatcher(r0, backend="torch-fp", payload="pl"), ref_hint(r0)
    for step, rules in enumerate((r0, r0[:260], mk_rules(2500, seed=4))):
        if step:
            caps = dict(m._caps)
            m.set_rules(rules, payload="pl")
            rm.set_rules(rules, payload="pl")
            assert m._caps == rm._caps
            assert (m._caps == caps) == (step == 1)
        hints = mk_queries(rules, 150, seed=step)
        assert np.array_equal(m.match(hints), np.asarray(rm.match(hints)))
        got = m.dispatch_snap(m.snapshot(), hints, pad_to=pad_to)
        want = np.asarray(RE.HintMatcher.dispatch_snap(
            rm, rm.snapshot(), hints, pad_to=pad_to))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert m.fused_stat() == {"available": False}
    assert m.published_table_bytes() > 0
    assert m.checksum() == rm.checksum()


@pytest.mark.parametrize("name", ["routes_2k", "acl_500", "mixed_families",
                                  "v6_only"])
def test_cidr_matcher_torch_fp_vs_reference_across_updates(name):
    nets, acl, addrs, ports, _, _ = fp_cidr_case(name)
    m = E.CidrMatcher(nets, acl=acl, backend="torch-fp", payload="pl")
    rm = RE.CidrMatcher([ref_net(n) for n in nets], acl=ref_acl(acl),
                        backend="jax-fp", payload="pl")
    for step in range(3):
        if step:  # a shorter list (caps reused), then a longer one
            k = len(nets) * 3 // 4 if step == 1 else len(nets)
            sub = nets[:k] + (route_nets(400, 77) if step == 2 else [])
            sacl = None if acl is None else (acl[:k] + (acl_rules(
                100, 78) if step == 2 else []))
            if sacl is not None:
                sub = [r.network for r in sacl]
            m.set_networks(sub, acl=sacl, payload="pl")
            rm.set_networks([ref_net(n) for n in sub], acl=ref_acl(sacl),
                            payload="pl")
        assert m._caps == rm._caps
        assert np.array_equal(m.match(addrs, ports),
                              np.asarray(rm.match(addrs, ports)))
    # the service's padded batch (pad rows: family -1) on the last one
    got = m.dispatch_snap(m.snapshot(), addrs, ports, pad_to=1024)
    want = np.asarray(rm.dispatch_snap(rm.snapshot(), addrs, ports,
                                       pad_to=1024))
    assert np.array_equal(got.numpy(), want)
    assert (got[len(addrs):] == -1).all()
    assert m.checksum() == rm.checksum()


def pair_of(rules, m=251):
    backends = [(f"10.9.{i}.1:80", 1 + i % 4) for i in range(7)]
    pair = M.FusedPair(E.HintMatcher(rules, backend="torch-fp",
                                     payload="hp"),
                       M.MaglevMatcher(backends, m=m, payload="mp"))
    ref = RM.FusedPair(RE.HintMatcher(rules, backend="jax-fp", payload="hp"),
                       RM.MaglevMatcher(backends, m=m, payload="mp"))
    return pair, ref


@pytest.mark.parametrize("kind", ["hint", "cpick", "cidr"])
def test_service_torch_fp_vs_reference_service(kind):
    """Device-mode batches over torch-fp matchers answer what the
    reference service answers over jax-fp; a cpick batch is B6 plus the
    Maglev take (fused_dispatch declines an fp matcher: one hint launch
    and no fused dispatch per batch)."""
    rules = mk_rules(600)
    pair, ref = pair_of(rules)
    b = 64
    if kind == "cidr":
        nets, acl, addrs, ports, _, _ = fp_cidr_case("acl_500")
        target = E.CidrMatcher(nets, acl=acl, backend="torch-fp",
                               payload="pl")
        rtarget = RE.CidrMatcher([ref_net(n) for n in nets],
                                 acl=ref_acl(acl), backend="jax-fp",
                                 payload="pl")
        payloads = [(addrs[i], None if i % 3 == 0 else ports[i])
                    for i in range(b)]
    elif kind == "cpick":
        payloads = list(zip(mk_queries(rules, b), mk_ips(b), ports_of(b)))
        target, rtarget = pair, ref
    else:
        payloads, target, rtarget = mk_queries(rules, b), pair.hm, ref.hm
    svc, rsvc = ClassifyService(mode="device"), RefService(mode="device")
    try:
        l0, f0 = E.dispatch_launches_total(), E.fused_dispatches_total()
        if kind == "cidr":
            got, want = (run_cidr(s, m, payloads) for s, m in
                         ((svc, target), (rsvc, rtarget)))
        else:
            got, want = (run_service(s, kind, m, payloads) for s, m in
                         ((svc, target), (rsvc, rtarget)))
        assert got == want
        st = svc.stats
        assert st.device_queries == b and st.failovers == 0
        assert E.fused_dispatches_total() == f0
        per_batch = 2 if kind == "cpick" else 1  # B6 + the Maglev take
        assert E.dispatch_launches_total() - l0 == \
            per_batch * st.dispatches >= 1
    finally:
        svc.close()
        rsvc.close()


def test_fused_dispatch_declines_torch_fp():
    rules = mk_rules(200)
    pair, _ = pair_of(rules)
    hm, mm = pair.hm, pair.mm
    hints, ips = mk_queries(rules, 16), mk_ips(16)
    assert E.fused_dispatch(hm, hm.snapshot(), mm, mm.snapshot(), hints,
                            ips) is None
    cm = E.CidrMatcher(route_nets(100, 3), backend="torch-fp")
    assert E.fused_dispatch_all(hm, hm.snapshot(), cm, cm.snapshot(), mm,
                                mm.snapshot(), hints, [bytes(4)] * 16,
                                ips) is None
    v, p, hp, mp = M.classify_and_pick(hm, mm, hints, ips)
    assert list(v) == [hm.index_snap(hm.snapshot(), h) for h in hints]
    assert list(p) == [M.pick(mm.snapshot()[0], ip, None) for ip in ips]
    assert (hp, mp) == ("hp", "mp")


# ------------------------------------------------------- the CUDA entries

def _fp_inputs(device):
    rules, hints = fp_member_overflow()
    tab = F.compile_hint_fp(rules)
    t = up(tab.arrays, "cpu")
    q = up(F.encode_hint_queries_fp(hints, tab), "cpu")
    acl, aq = fp_trie_acl_overlap()
    ct = up(F.compile_cidr_fp([r.network for r in acl], acl=acl).arrays,
            "cpu")
    a16, fam, p = (torch.from_numpy(x) for x in cidr_batch(
        [a for a, _ in aq[:16]], [x for _, x in aq[:16]]))
    mv = (lambda d: {k: v.to(device) for k, v in d.items()})
    return mv(t), mv(q), mv(ct), a16.to(device), fam.to(device), \
        p.to(device)


def test_fp_entries_serve_cpu_tensors_with_plain_tier():
    t, q, ct, a16, fam, p = _fp_inputs("cpu")
    n = (FPC.hint_fp_cuda.launches, FPC.cidr_fp_cuda.launches)
    gi, gl = FPC.hint_fp(t, q)
    ri, rl = F.hint_fp_match(t, q)
    assert torch.equal(gi, ri) and torch.equal(gl, rl)
    assert torch.equal(FPC.cidr_fp(ct, a16, fam, p),
                       F.cidr_fp_match(ct, a16, fam, p))
    assert (FPC.hint_fp_cuda.launches, FPC.cidr_fp_cuda.launches) == n


def test_fp_entries_raise_on_non_cpu_tensor(monkeypatch):
    """A tensor off the CPU goes to the kernels or raises, for B6, B7
    and classify_fp_all: no plain tier is substituted (meta tensors
    stand in for CUDA ones on this CPU-only build)."""
    called = []
    for name in ("hint_fp_match", "cidr_fp_match", "classify_fp_all"):
        monkeypatch.setattr(F, name, lambda *a, **k: called.append(a))
    monkeypatch.setattr(FPC, "_load", lambda kind: (_ for _ in ()).throw(
        FC.KernelError("nvcc failed (1)")))
    t, q, ct, a16, fam, p = _fp_inputs("meta")
    n = (FPC.hint_fp_cuda.launches, FPC.cidr_fp_cuda.launches)
    for call in (lambda: FPC.hint_fp(t, q),
                 lambda: FPC.cidr_fp(ct, a16, fam, p),
                 lambda: FPC.classify_fp_all(t, ct, ct, q, a16, fam, p)):
        with pytest.raises(FC.KernelError):
            call()
    assert not called
    assert (FPC.hint_fp_cuda.launches, FPC.cidr_fp_cuda.launches) == n


def test_fp_prepare_refuses_cpu_and_bad_tables(monkeypatch):
    monkeypatch.setattr(FPC, "_load", lambda kind: None)
    t, q, ct, *_ = _fp_inputs("cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        FPC.prepare_hint_table(t)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        FPC.prepare_cidr_table(ct)
    t, q, ct, *_ = _fp_inputs("meta")
    assert FPC.prepare_hint_table(t).ints["hm"] == t["h_em"].shape[1]
    p = FPC.prepare_cidr_table(ct)
    assert p.ints["nm"] == ct["mrows"].shape[0] and p.ints["s1"] > 0
    bad = dict(ct)
    bad["rec"] = bad["rec"].to(torch.int64)
    with pytest.raises(ValueError, match="rec must be"):
        FPC.prepare_cidr_table(bad)
    bad = dict(t)
    del bad["wu_rec"]
    with pytest.raises(ValueError, match="missing 'wu_rec'"):
        FPC.prepare_hint_table(bad)


@pytest.mark.parametrize("kind", ["hint", "cidr"])
def test_torch_fp_matcher_off_cpu_refuses_to_publish_without_kernel(
        kind, monkeypatch):
    def no_lib(k):
        raise FC.KernelError("nvcc failed (1)")
    monkeypatch.setattr(FPC, "_load", no_lib)
    with pytest.raises(FC.KernelError):
        if kind == "hint":
            E.HintMatcher(mk_rules(40), backend="torch-fp", device="meta")
        else:
            E.CidrMatcher(route_nets(64, 32), backend="torch-fp",
                          device="meta")


def test_fp_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(FC, "CUDA_DEFAULT", str(tmp_path / "cuda"))
    monkeypatch.setattr(FC, "BUILD_DIR", str(tmp_path / "build"))
    for build in (FPC.build_hint, FPC.build_cidr):
        with pytest.raises(FC.KernelError, match="nvcc"):
            build()
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("kind", ["hint", "cidr"])
def test_fp_kernel_abi_mirror_matches_source(kind):
    """The ctypes mirrors have the C structs' fields, in order."""
    src_path, struct, cls = (
        (FPC.SOURCE_HINT, "FpHintArgs", FPC._FpHintArgs) if kind == "hint"
        else (FPC.SOURCE_CIDR, "FpCidrArgs", FPC._FpCidrArgs))
    with open(src_path) as f:
        body = re.search(rf"struct {struct} \{{(.*?)\}};", f.read(),
                         re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    ptrs = re.findall(r"\*\s*(\w+);", body)
    ints = [x.strip() for decl in re.findall(r"int32_t ([\w ,\n]+);", body)
            for x in decl.replace("\n", " ").split(",")]
    assert [n for n, _ in cls._fields_] == ptrs + ints
    assert all(t is ctypes.c_void_p for _, t in cls._fields_[:len(ptrs)])
    assert ctypes.sizeof(cls) == 8 * len(ptrs) + 4 * len(ints) + (
        4 if len(ints) % 2 else 0)


# ------------------------------------------------- chip_smoke.py, small

def test_chip_smoke_fp_phases_on_cpu():
    """chip_smoke.py's fingerprint phases at a small size on the CPU
    (config #4's 5k ACL kept: its trie passes the touch limit, so the
    ACL takes the group path as on the card): the parity sets, the
    service bursts against the host index and the linear oracle, and
    the bound's byte and op counts (the plain tiers here: no kernel
    launches)."""
    dev = torch.device("cpu")
    tabs = CS.fp_tables(dev, n_rules=300, n_routes=400, n_acl=5000)
    err = CS.phase_fp_kernels(dev, tabs, batches=(16, 64), n_host=300)
    assert (err["b6"], err["b7"], err["all"]) == (0, 0, 0)
    assert err["layouts"]["routes"][0] and not err["layouts"]["acl"][0]
    out = CS.phase_fp_service(dev, tabs, bursts=2, burst=24)
    assert out["queries"] == 4 * 48 and out["failovers"] == 0
    assert out["launches"] == {"hint_fp": 0, "cidr_fp": 0}
    assert all(v > 0 for v in out["batches"].values())
    hsnap = tabs["hm"].snapshot()
    q = CS.fp_hint_batch(hsnap[0], mk_queries(tabs["rules"], 48), 64, dev)
    nb, ops = CS.fp_hint_work(hsnap[1], q)
    assert nb > sum(v.numel() * v.element_size() for v in q.values()) and \
        ops > 0
    for m, ports in ((tabs["routes"], False), (tabs["am"], True)):
        qs = CS.acl_queries(tabs["acl"], 48, 5)
        a16, fam, port = CS.cidr_batch(
            [(a, p if ports else None) for a, p in qs], 64, dev)
        nb, ops = CS.fp_cidr_work(m.snapshot()[0], a16, fam, port)
        assert nb > 64 * 24 and ops > 0


def test_chip_smoke_tcplb_fp_phase_on_cpu():
    """The TcpLB phase with VPROXY_TPU_MATCHER=jax-fp: the Upstream and
    the ACL serve on "torch-fp", every answer the host index's group."""
    dev = torch.device("cpu")
    out = CS.phase_tcplb(dev, max_rules=64, bursts=1, burst=24,
                         keepalive=4, n_acl=200, matcher="jax-fp")
    assert out["backend"] == "torch-fp" and out["b3_on_path"] is None
    assert out["splice_connections"] == 24 and out["failovers"] == 0
    assert out["fp_launches"] == {"hint_fp": 0, "cidr_fp": 0}
    assert out["batches"]["hint"]["batches"] > 0
    assert out["batches"]["cidr"]["batches"] > 0
    assert "VPROXY_TPU_MATCHER" not in __import__("os").environ
