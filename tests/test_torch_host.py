"""Torch port, host half: the compilers are byte-identical to vproxy_tpu's.

The same rules and queries (seeded `random`) go through the reference's
numpy compilers and the port's copies; every array must match in key,
dtype, shape and bytes. Covers compile_hint_hash, both query encoders
(per-hint below SMALL_ENCODE, vectorized above), pack_hint_table with
and without uri rules, Maglev build_table/flow_slots, the cuckoo hashes,
HintIndex, _expand_patterns and the upload that carries reference
tables over (tables_from_reference). Plus the replication checksums:
HintMatcher.checksum and MaglevMatcher.checksum equal the reference's
on the same rules and backends, across a republish, and GROUP_M reads
the reference's knob with its default.
"""
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_fused import mk_ips, mk_queries, mk_rules
from vproxy_tpu.ops import cuckoo as RCK
from vproxy_tpu.ops import fused as RF
from vproxy_tpu.ops import hashmatch as RH
from vproxy_tpu.rules import engine as RE
from vproxy_tpu.rules import index as RI
from vproxy_tpu.rules import maglev as RM
from vproxy_tpu.rules import oracle as RO
from vproxy_tpu.utils import failpoint as RFP
from vproxy_tpu_torch.ops import cuckoo as CK
from vproxy_tpu_torch.ops import fused as F
from vproxy_tpu_torch.ops import hashmatch as H
from vproxy_tpu_torch.rules import engine as E
from vproxy_tpu_torch.rules import index as I
from vproxy_tpu_torch.rules import maglev as M
from vproxy_tpu_torch.rules import oracle as O
from vproxy_tpu_torch.rules.ir import Hint, HintRule
from vproxy_tpu_torch.utils import failpoint as FP
from vproxy_tpu_torch.utils.ip import Network, mask_bytes, parse_ip
from vproxy_tpu_torch.utils.torchenv import tables_from_reference, to_host

torch.set_num_threads(1)

WORDS = ["a", "bb", "ccc", "x", "api", "web", "cdn", "img", "v2", "svc"]
TLDS = ["com", "net", "io", "local"]


def rand_rules(n, seed):
    """The reference hashmatch tests' rule mix: hosts, wildcards, uri
    prefixes, ports, shared keys."""
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


SHARED = [HintRule(host="a.com", uri="/x"), HintRule(host="a.com", uri="/xy"),
          HintRule(host="a.com"), HintRule(host="a.com", port=443),
          HintRule(host="a.com", uri="/xy"), HintRule(host="com"),
          HintRule(host="*", uri="/x"), HintRule(uri="/xy"),
          HintRule(uri="*")]
H64 = "a" * 31 + "." + "b" * 32
LONG = [HintRule(host=H64), HintRule(host="b" * 32)]

RULESETS = {
    "mk_rules_2k": lambda: mk_rules(2000),
    "mk_rules_20k": lambda: mk_rules(20_000),
    "random_300": lambda: rand_rules(300, 1),
    "random_1500": lambda: rand_rules(1500, 2),
    "shared_keys": lambda: SHARED,
    "long_hosts": lambda: LONG,
    "host_only": lambda: [HintRule(host=f"s{i}.example.com",
                                   port=443 if i % 5 == 0 else 0)
                          for i in range(3000)] + [HintRule(host="*")],
    "empty": lambda: [],
}


def same_arrays(ref: dict, got: dict):
    assert set(ref) == set(got)
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("name", sorted(RULESETS))
def test_compile_hint_hash_byte_identical(name):
    rules = RULESETS[name]()
    ref, got = RH.compile_hint_hash(rules), H.compile_hint_hash(rules)
    same_arrays(ref.arrays, got.arrays)
    for f in ("n", "r_cap", "host_cap", "host_salts", "uri_cap",
              "uri_salts", "lset", "hw", "uw", "caps"):
        assert getattr(ref, f) == getattr(got, f), f
    # caps reuse (the update path) compiles the same shapes too
    more = rules + [HintRule(host="new.example.com")]
    same_arrays(RH.compile_hint_hash(more, caps=ref.caps).arrays,
                H.compile_hint_hash(more, caps=got.caps).arrays)


@pytest.mark.parametrize("b,pad_to", [(1, 0), (8, 16), (28, 0), (29, 0),
                                      (200, 256), (600, 0)])
def test_encode_hint_queries_byte_identical(b, pad_to):
    """Both encoders: per-hint python at b <= SMALL_ENCODE (28), the
    vectorized rolling-FNV pass above it."""
    rules = rand_rules(400, 3) + mk_rules(600)
    hints = rand_hints(rules, b, seed=b) + [Hint(), Hint(host=H64 + ".x")]
    ref_t, tab = RH.compile_hint_hash(rules), H.compile_hint_hash(rules)
    same_arrays(RH.encode_hint_queries(hints, ref_t, pad_to=pad_to),
                H.encode_hint_queries(hints, tab, pad_to=pad_to))


@pytest.mark.parametrize("name", ["mk_rules_2k", "host_only", "shared_keys",
                                  "empty"])
def test_pack_hint_table_byte_identical(name):
    rules = RULESETS[name]()
    tab = H.compile_hint_hash(rules)
    ref, got = RF.pack_hint_table(tab.arrays), F.pack_hint_table(tab.arrays)
    same_arrays(ref, got)
    has_uri = any(r.uri is not None for r in rules)
    assert ("pk_uslot" in got) == has_uri  # the uri-free specialization


@pytest.mark.parametrize("entries,m", [
    ([(f"b{i}", 1) for i in range(11)], 4099),
    ([(f"10.9.{i // 250}.{i % 250}:80", 1 + i % 4) for i in range(256)],
     65537),
    ([("a", 3), ("b", 1000), ("c", 7)], 251),     # turn-order renorm
    ([(f"n{i}", 1 + i) for i in range(90)], 251),  # total past the cap
    ([], 251),
])
def test_maglev_build_table_byte_identical(entries, m):
    same_arrays({"t": RM.build_table(entries, m)},
                {"t": M.build_table(entries, m)})
    assert RM._turns([w for _, w in entries]) == \
        M._turns([w for _, w in entries])


@pytest.mark.parametrize("ports", ["none", "mixed"])
def test_maglev_flow_slots_and_pick_identical(ports):
    ips = mk_ips(300) + [parse_ip("2001:db8::7"), parse_ip("::1")]
    pl = None if ports == "none" else \
        [None if i % 3 == 0 else 1024 + i for i in range(len(ips))]
    same_arrays({"s": RM.flow_slots(65537, ips, pl)},
                {"s": M.flow_slots(65537, ips, pl)})
    tab = M.build_table([(f"b{i}", 1) for i in range(7)], 4099)
    for i, ip in enumerate(ips):
        p = None if pl is None else pl[i]
        assert M.pick(tab, ip, p) == RM.pick(tab, ip, p)


def test_cuckoo_hashes_identical():
    rnd = np.random.default_rng(3)
    qb = rnd.integers(0, 256, (64, 33), dtype=np.uint8)
    for salt in (0, 1, 131, 2**40 + 7):
        assert np.array_equal(CK.rolling_fnv64(qb, salt),
                              RCK.rolling_fnv64(qb, salt))
        assert CK.fnv64(b"key.example.com", salt) == \
            RCK.fnv64(b"key.example.com", salt)
    k16 = rnd.integers(0, 256, (40, 16), dtype=np.uint8)
    assert np.array_equal(CK.fnv32_masked(k16, 5), RCK.fnv32_masked(k16, 5))


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_hint_index_matches_reference_and_oracle(seed):
    rules = rand_rules(500, seed)
    hints = rand_hints(rules, 400, seed) + [Hint(), Hint(uri="*")]
    ref, got = RI.HintIndex(rules), I.HintIndex(rules)
    for h in hints:
        want = RO.search(rules, h)
        assert got.lookup(h) == ref.lookup(h) == want == O.search(rules, h)
        if want >= 0:
            assert O.match_level(h, rules[want]) == \
                RO.match_level(h, rules[want])


def test_expand_patterns_identical():
    nets = [Network(parse_ip("10.1.0.0"), mask_bytes(16)),
            Network(parse_ip("0.0.0.0"), mask_bytes(0)),
            Network(parse_ip("2001:db8::"), mask_bytes(32)),
            Network(parse_ip("::ffff:10.0.0.0"), mask_bytes(104)),
            Network(parse_ip("::"), mask_bytes(96))]
    for n in nets:
        assert H._expand_patterns(n) == RH._expand_patterns(n)


def test_failpoint_sites_identical():
    assert FP.SITES == RFP.SITES


@pytest.mark.parametrize("what", ["arrays", "packed", "maglev", "queries"])
def test_tables_from_reference_keeps_keys_and_dtypes(what):
    rules = mk_rules(500)
    tab = RH.compile_hint_hash(rules)
    src = {"arrays": lambda: tab.arrays,
           "packed": lambda: RF.pack_hint_table(tab.arrays),
           "maglev": lambda: {"table": RM.build_table([("a", 1)], 251)},
           "queries": lambda: {**RH.encode_hint_queries(
               mk_queries(rules, 40), tab),
               "slots": RM.flow_slots(251, mk_ips(40))}}[what]()
    got = tables_from_reference(src, "cpu")
    assert set(got) == set(src)
    for k, v in src.items():
        assert isinstance(got[k], torch.Tensor) and got[k].device.type == "cpu"
        back = to_host(got[k])
        assert back.dtype == v.dtype and np.array_equal(back, v), k


# ------------------------------------------------------ checksums

@pytest.mark.parametrize("name", sorted(RULESETS))
def test_hint_matcher_checksum_matches_reference(name, monkeypatch):
    """crc32 of the published rule reprs, the same number in both
    packages, cached per generation and moved by a republish."""
    monkeypatch.setenv("VPROXY_TPU_INSTALL_PACE", "0")
    rules = list(RULESETS[name]())
    got, ref = E.HintMatcher(rules, backend="host"), \
        RE.HintMatcher(rules, backend="host")
    c0 = got.checksum()
    assert c0 == ref.checksum() == got.checksum()
    more = rules + [HintRule(host="new.example.com", port=8443)]
    got.set_rules(more)
    ref.set_rules(more)
    assert got.checksum() == ref.checksum() != c0
    got.set_rules(rules)
    assert got.checksum() == c0


@pytest.mark.parametrize("entries", [
    [(f"b{i}", 1) for i in range(11)],
    [(f"10.9.{i // 250}.{i % 250}:80", 1 + i % 4) for i in range(256)],
    [],
])
def test_maglev_matcher_checksum_matches_reference(entries, monkeypatch):
    monkeypatch.setenv("VPROXY_TPU_INSTALL_PACE", "0")
    got = M.MaglevMatcher(entries, m=251, device="cpu")
    ref = RM.MaglevMatcher(entries, m=251)
    c0 = got.checksum()
    assert c0 == ref.checksum()
    more = entries + [("added:80", 3)]
    got.set_backends(more)
    ref.set_backends(more)
    assert got.checksum() == ref.checksum() != c0


def test_group_m_reads_the_reference_knob():
    assert M.GROUP_M == RM.GROUP_M
    if "VPROXY_TPU_MAGLEV_GROUP_M" not in os.environ:
        assert M.GROUP_M == 4099
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c",
         "from vproxy_tpu_torch.rules import maglev as M\n"
         "from vproxy_tpu.rules import maglev as RM\n"
         "print(M.GROUP_M, RM.GROUP_M)\n"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": root, "JAX_PLATFORMS": "cpu",
             "VPROXY_TPU_MAGLEV_GROUP_M": "251"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["251", "251"]
