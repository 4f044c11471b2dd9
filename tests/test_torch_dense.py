"""Torch port, the dense backend ("torch-dense", the reference's
"jax-dense"): compilers, plain tier, packed layout, matchers, service,
the Maglev take, the CUDA entries.

The same seeded inputs go through vproxy_tpu on the JAX CPU backend and
through the port on torch's CPU (VPROXY_TPU_TORCH_DEVICE=cpu); every
comparison is exact:

* compile_hint_rules / compile_cidr_rules / compile_acl / encode_hints,
  byte for byte, with the cap reused, grown past MATCH_CHUNK, and the
  ValueError of an over-long host or uri rule;
* hint_match / hint_match_chunked (index and level), cidr_first_match /
  cidr_first_match_chunked (routes, ACL with ports and with None, pad
  rows of family -1) and classify_all, int32, against the reference's
  jitted functions;
* the 10 cases of tests/test_matchers.py, each run on both packages,
  and test_hashmatch.py's hash / dense / host cross-check on this one;
* pack_dense_hint_table / pack_dense_cidr_table: a torch form of the
  kernel's masked word compare over the packed layout (its word order,
  live word counts and flags) answers what the reference's matchers
  answer, so a layout fault shows before the card;
* HintMatcher / CidrMatcher / FusedPair / ClassifyService on
  "torch-dense" against the reference's "jax-dense" across updates that
  reuse and outgrow the cap, with published_table_bytes and generation;
* the Maglev take's plain version against the reference's, clip
  included;
* the CUDA entries (ops/matchers.py hint_dense / cidr_dense /
  classify_dense, ops/take_cuda.py take) serve CPU tensors with the
  plain versions and never substitute them for a tensor off the CPU, a
  CUDA matcher stops its publish when B9 cannot build, and the ctypes
  mirrors match the C structs (the .cu files compile only on the GPU
  host).
"""
import ctypes
import random
import re

import numpy as np
import pytest
import torch

import chip_smoke as CS
from test_fused import mk_ips, mk_queries, mk_rules
from test_torch_cidr import (acl_rules, ref_acl, ref_net, route_nets,
                             run_cidr, same_arrays)
from test_torch_engine import ports_of, run_service
from vproxy_tpu.ops import matchers as RMT
from vproxy_tpu.ops import tables as RT
from vproxy_tpu.ops.bitmatch import unpack_bits as r_unpack
from vproxy_tpu.rules import engine as RE
from vproxy_tpu.rules import maglev as RM
from vproxy_tpu.rules import oracle as RO
from vproxy_tpu.rules import ir as RIR
from vproxy_tpu.rules.service import ClassifyService as RefService
from vproxy_tpu.utils import ip as RIP
from vproxy_tpu_torch.ops import dense_cuda as DC
from vproxy_tpu_torch.ops import fused_cuda as FC
from vproxy_tpu_torch.ops import matchers as MT
from vproxy_tpu_torch.ops import tables as T
from vproxy_tpu_torch.ops import take_cuda as TC
from vproxy_tpu_torch.ops.bitmatch import unpack_bits
from vproxy_tpu_torch.rules import engine as E
from vproxy_tpu_torch.rules import ir as IR
from vproxy_tpu_torch.rules import maglev as M
from vproxy_tpu_torch.rules import oracle
from vproxy_tpu_torch.rules.service import ClassifyService
from vproxy_tpu_torch.utils import ip as IP

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setenv("VPROXY_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("VPROXY_TPU_INSTALL_PACE", "0")


def tt(d: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in d.items()}


# ----------------------------------------------------------- generators
# test_matchers.py's, with the random stream and the package passed in


WORDS = ["a", "bb", "ccc", "x", "api", "web", "cdn", "img", "v2", "svc"]
TLDS = ["com", "net", "io", "local"]


def rand_domain(rnd):
    n = rnd.randint(1, 3)
    return ".".join(rnd.choice(WORDS) for _ in range(n)) + "." + \
        rnd.choice(TLDS)


def rand_uri(rnd):
    n = rnd.randint(1, 4)
    return "/" + "/".join(rnd.choice(WORDS) for _ in range(n))


def rand_hint_rule(rnd, ir=IR):
    host = uri = None
    port = 0
    while host is None and uri is None and port == 0:
        if rnd.random() < 0.7:
            host = "*" if rnd.random() < 0.1 else rand_domain(rnd)
        if rnd.random() < 0.5:
            uri = "*" if rnd.random() < 0.1 else rand_uri(rnd)
        if rnd.random() < 0.3:
            port = rnd.choice([80, 443, 8080])
    return ir.HintRule(host=host, port=port, uri=uri)


def rand_hint(rnd, ir=IR):
    host = rand_domain(rnd) if rnd.random() < 0.8 else None
    if host and rnd.random() < 0.5:
        host = rnd.choice(WORDS) + "." + host
    uri = rand_uri(rnd) if rnd.random() < 0.6 else None
    port = rnd.choice([0, 80, 443, 8080])
    return ir.Hint(host=host, port=port, uri=uri)


def normalize_net(ip: bytes, masklen: int, X) -> object:
    mb = X.ip.mask_bytes(masklen) if masklen > 0 else b"\x00" * 4
    out = bytearray(len(ip))
    for i in range(len(ip)):
        out[i] = ip[i] & (mb[i] if i < len(mb) else 0)
    return X.ip.Network(bytes(out), mb)


def rand_v4net(rnd, X):
    ml = rnd.randint(0, 32)
    return normalize_net(bytes(rnd.randint(0, 255) for _ in range(4)), ml, X)


def rand_v6net(rnd, X):
    ml = rnd.randint(0, 128)
    style = rnd.random()
    if style < 0.3:
        ip = b"\x00" * 12 + bytes(rnd.randint(0, 255) for _ in range(4))
    elif style < 0.5:
        ip = b"\x00" * 10 + b"\xff\xff" + bytes(
            rnd.randint(0, 255) for _ in range(4))
    else:
        ip = bytes(rnd.randint(0, 255) for _ in range(16))
    return normalize_net(ip, ml, X)


def rand_addr(rnd):
    if rnd.random() < 0.5:
        return bytes(rnd.randint(0, 255) for _ in range(4))
    style = rnd.random()
    if style < 0.3:
        return b"\x00" * 12 + bytes(rnd.randint(0, 255) for _ in range(4))
    if style < 0.5:
        return b"\x00" * 10 + b"\xff\xff" + bytes(
            rnd.randint(0, 255) for _ in range(4))
    return bytes(rnd.randint(0, 255) for _ in range(16))


def rand_nets(rnd, n, X):
    nets, seen = [], set()
    while len(nets) < n:
        net = rand_v4net(rnd, X) if rnd.random() < 0.5 else \
            rand_v6net(rnd, X)
        if (net.ip, net.mask) not in seen:
            seen.add((net.ip, net.mask))
            nets.append(net)
    return nets


def rand_acl(rnd, n, X):
    out = []
    for i in range(n):
        net = rand_v4net(rnd, X) if rnd.random() < 0.6 else \
            rand_v6net(rnd, X)
        lo = rnd.randint(0, 65000)
        hi = rnd.randint(lo, 65535)
        out.append(X.ir.AclRule(f"r{i}", net, rnd.choice(
            [X.ir.Proto.TCP, X.ir.Proto.UDP]), lo, hi, rnd.random() < 0.5))
    return out


# ------------------------------------------------------ the two packages

class _Pkg:
    """One package's surface for the ported test_matchers.py cases: its
    rule IR, ip helpers, compilers and oracle, and its matchers taking
    numpy batches and answering numpy arrays."""

    def __init__(self, name, tables, ir, ip, orc):
        self.name, self.tables, self.ir, self.ip = name, tables, ir, ip
        self.oracle = orc

    def _t(self, t):
        return RMT.table_arrays(t) if self.name == "jax" else \
            tt(MT.table_arrays(t))

    def hint(self, t, q, chunk=None):
        if self.name == "jax":
            args = (RMT.table_arrays(t), q["host"], q["has_host"],
                    r_unpack(q["uri"]), q["has_uri"], q["port"])
            out = RMT.hint_match(*args) if chunk is None else \
                RMT.hint_match_chunked(*args, chunk=chunk)
        else:
            qd = tt(q)
            args = (self._t(t), qd["host"], qd["has_host"],
                    unpack_bits(qd["uri"]), qd["has_uri"], qd["port"])
            out = MT.hint_match(*args) if chunk is None else \
                MT.hint_match_chunked(*args, chunk=chunk)
        return tuple(np.asarray(x) for x in out)

    def cidr(self, t, a16, fam, port=None, chunk=None):
        if self.name == "jax":
            args = (RMT.table_arrays(t), a16, fam, port)
            out = RMT.cidr_first_match(*args) if chunk is None else \
                RMT.cidr_first_match_chunked(*args, chunk=chunk)
            return np.asarray(out)
        args = (self._t(t), torch.from_numpy(a16), torch.from_numpy(fam),
                None if port is None else torch.from_numpy(port))
        out = MT.cidr_first_match(*args) if chunk is None else \
            MT.cidr_first_match_chunked(*args, chunk=chunk)
        return out.numpy()


PKGS = {"jax": _Pkg("jax", RT, RIR, RIP, RO),
        "torch": _Pkg("torch", T, IR, IP, oracle)}


@pytest.fixture(params=list(PKGS))
def X(request):
    return PKGS[request.param]


# ---------------------------------------- test_matchers.py, both packages

def test_hint_match_parity(X):
    rnd = random.Random(42)
    rules = [rand_hint_rule(rnd, X.ir) for _ in range(200)]
    hints = [rand_hint(rnd, X.ir) for _ in range(500)]
    for i in range(0, 100, 3):
        r = rules[i % len(rules)]
        if r.host and r.host != "*":
            hints[i] = X.ir.Hint(host=r.host, port=r.port or 0, uri=r.uri)
    idx, level = X.hint(X.tables.compile_hint_rules(rules),
                        X.tables.encode_hints(hints))
    for i, h in enumerate(hints):
        want = X.oracle.search(rules, h)
        assert idx[i] == want, (i, h)
        if want >= 0:
            assert level[i] == X.oracle.match_level(h, rules[want])


def test_hint_scoring_cases(X):
    H, R = X.ir.Hint, X.ir.HintRule
    rules = [R(host="example.com"), R(host="*"), R(host="a.example.com"),
             R(host="example.com", uri="/api"), R(uri="/api/v2"),
             R(uri="*"), R(host="example.com", port=443)]
    cases = [H.of_host("example.com"), H.of_host("x.example.com"),
             H.of_host("a.example.com"), H.of_host("other.org"),
             H.of_host_uri("example.com", "/api"),
             H.of_host_uri("example.com", "/api/v2"),
             H.of_uri("/api/v2/things"), H.of_host_port("example.com", 443),
             H.of_host_port("example.com", 80),
             H(host=None, uri=None, port=9999)]
    idx, _ = X.hint(X.tables.compile_hint_rules(rules),
                    X.tables.encode_hints(cases))
    for i, h in enumerate(cases):
        assert idx[i] == X.oracle.search(rules, h), (i, h, idx[i])


def test_cidr_route_parity(X):
    rnd = random.Random(43)
    nets = rand_nets(rnd, 150, X)
    addrs = [rand_addr(rnd) for _ in range(400)]
    for i in range(0, 200, 2):
        addrs[i] = nets[i % len(nets)].ip
    a16, fam = X.tables.encode_ips(addrs)
    got = X.cidr(X.tables.compile_cidr_rules(nets), a16, fam)
    for i, a in enumerate(addrs):
        want = next((j for j, n in enumerate(nets) if n.contains_ip(a)), -1)
        assert got[i] == want, (i, a.hex())


def test_route_table_insert_order(X):
    rt = X.ir.RouteTable()
    N, pi = X.ip.Network.parse, X.ip.parse_ip
    for alias, net, vni in (("default", "192.168.0.0/16", 1),
                            ("narrow", "192.168.1.0/24", 2),
                            ("narrower", "192.168.1.128/25", 3),
                            ("other", "10.0.0.0/8", 4)):
        rt.add(X.ir.RouteRule(alias, N(net), to_vni=vni))
    assert rt.lookup(pi("192.168.1.200")).alias == "narrower"
    assert rt.lookup(pi("8.8.8.8")) is None
    a16, fam = X.tables.encode_ips([pi(x) for x in (
        "192.168.1.200", "192.168.1.5", "192.168.2.1", "10.1.2.3",
        "8.8.8.8")])
    got = X.cidr(X.tables.compile_route_table(rt.rules_v4), a16, fam)
    assert [rt.rules_v4[i].alias if i >= 0 else None for i in got] == \
        ["narrower", "narrow", "default", "other", None]


def test_acl_parity(X):
    rnd = random.Random(44)
    rules = rand_acl(rnd, 60, X)
    addrs = [rand_addr(rnd) for _ in range(300)]
    ports = [rnd.randint(0, 65535) for _ in range(300)]
    for proto in (X.ir.Proto.TCP, X.ir.Proto.UDP):
        sub = [r for r in rules if r.protocol == proto]
        t = X.tables.compile_acl(rules, proto)
        a16, fam = X.tables.encode_ips(addrs)
        idx = X.cidr(t, a16, fam, np.array(ports, np.int32))
        for i in range(len(addrs)):
            want = X.oracle.acl_first_match(rules, proto, addrs[i], ports[i])
            assert idx[i] == want, (proto, i)
            got_allow = bool(t.allow[idx[i]]) if idx[i] >= 0 else True
            if sub:
                assert got_allow == X.oracle.acl_allow(rules, True, proto,
                                                       addrs[i], ports[i])


def test_mask_match_mixed_families(X):
    N, pi = X.ip.Network.parse, X.ip.parse_ip
    n4 = N("127.0.0.0/8")
    assert n4.contains_ip(pi("127.6.6.6"))
    assert n4.contains_ip(pi("::7f00:1"))
    assert n4.contains_ip(pi("::ffff:127.0.0.1"))
    assert not n4.contains_ip(pi("1::7f00:1"))
    assert N("::ffff:7f00:0/112").contains_ip(pi("127.0.0.1"))
    n6b = N("fe80::/10")
    assert not n6b.contains_ip(pi("127.0.0.1"))
    assert n6b.contains_ip(pi("fe80::1"))
    assert not N("fe00::/8").contains_ip(pi("254.0.0.1"))
    # and the tables agree with contains_ip on each of these
    nets = [n4, N("::ffff:7f00:0/112"), n6b, N("fe00::/8")]
    addrs = [pi(x) for x in ("127.6.6.6", "::7f00:1", "::ffff:127.0.0.1",
                             "1::7f00:1", "127.0.0.1", "fe80::1",
                             "254.0.0.1")]
    a16, fam = X.tables.encode_ips(addrs)
    got = X.cidr(X.tables.compile_cidr_rules(nets), a16, fam)
    assert list(got) == [next((j for j, n in enumerate(nets)
                               if n.contains_ip(a)), -1) for a in addrs]


def test_overlong_host_query_no_false_exact(X):
    R, H = X.ir.HintRule, X.ir.Hint
    rules = [R(host="x" * X.tables.MAX_HOST), R(host="corp.example.com")]
    idx, level = X.hint(X.tables.compile_hint_rules(rules),
                        X.tables.encode_hints([
                            H.of_host("a" * 80 + ".corp.example.com"),
                            H.of_host("x" * X.tables.MAX_HOST)]))
    assert list(idx) == [1, 0]
    assert list(level) == [2 << 10, 3 << 10]
    with pytest.raises(ValueError):
        X.tables.compile_hint_rules(
            [R(host="y" * (X.tables.MAX_HOST + 1))])


def test_format_host_www_and_port(X):
    fh = X.ir.format_host
    assert fh("www.example.com") == "www.example.com"
    assert fh("") == "" and fh("::1") == "::1"
    assert fh("www.example.com:80") == "example.com"
    assert fh("example.com:443") == "example.com"
    assert fh("www.:80") is None
    R, H = X.ir.HintRule, X.ir.Hint
    rules = [R(host="www.example.com"), R(host="example.com")]
    assert X.oracle.search(rules, H.of_host("www.example.com")) == 0
    idx, _ = X.hint(X.tables.compile_hint_rules(rules),
                    X.tables.encode_hints([H.of_host("www.example.com"),
                                           H.of_host("www.example.com:8080")]))
    assert list(idx) == [0, 1]


def test_max_length_host_suffix_match(X):
    h64 = ("a" * 62) + ".b"
    assert len(h64) == 64
    H = X.ir.Hint
    idx, level = X.hint(
        X.tables.compile_hint_rules([X.ir.HintRule(host=h64)]),
        X.tables.encode_hints([H.of_host("sub." + h64), H.of_host(h64)]))
    assert list(idx) == [0, 0]
    assert list(level) == [2 << 10, 3 << 10]


def test_chunked_matchers_parity_and_cross_chunk_ties(X):
    R, H = X.ir.HintRule, X.ir.Hint
    rules = [R(host=f"h{i}.io") for i in range(700)]
    rules[5] = rules[600] = R(host="dup.example.com")
    hints = [H.of_host("dup.example.com"), H.of_host("h650.io"),
             H.of_host("sub.h3.io"), H.of_host("nope.org")]
    t = X.tables.compile_hint_rules(rules, cap=768)
    q = X.tables.encode_hints(hints)
    direct, chunked = X.hint(t, q), X.hint(t, q, chunk=256)
    assert list(chunked[0]) == list(direct[0]) == [5, 650, 3, -1]
    assert list(chunked[1]) == list(direct[1])
    nets = [normalize_net(bytes([10, i % 256, (i // 256) % 256, 0]), 24, X)
            for i in range(700)]
    nets[650] = normalize_net(bytes([10, 0, 0, 0]), 8, X)
    pi = X.ip.parse_ip
    addrs = [pi("10.0.0.1"), pi("10.44.0.9"), pi("9.9.9.9")]
    t = X.tables.compile_cidr_rules(nets, cap=768)
    a16, fam = X.tables.encode_ips(addrs)
    d, c = X.cidr(t, a16, fam), X.cidr(t, a16, fam, chunk=256)
    want = [next((j for j, n in enumerate(nets) if n.contains_ip(a)), -1)
            for a in addrs]
    assert list(d) == list(c) == want


# ------------------------------------------- compilers, byte for byte

def _ref_rules(rules):
    return [RIR.HintRule(host=r.host, port=r.port, uri=r.uri)
            for r in rules]


def hint_set(seed=5, n=300):
    rnd = random.Random(seed)
    rules = [rand_hint_rule(rnd) for _ in range(n)]
    rules[7] = IR.HintRule(host="z" * T.MAX_HOST, uri="/" + "u" * 127)
    rules[8] = IR.HintRule()  # empty: inactive
    hints = [rand_hint(rnd) for _ in range(200)]
    hints += [IR.Hint.of_host("a" * 70 + ".x.io"), IR.Hint(),
              IR.Hint.of_host_uri("q." + "z" * T.MAX_HOST,
                                  "/" + "u" * 200)]
    return rules, hints


@pytest.mark.parametrize("cap", [None, 512, 1024])
def test_compile_hint_rules_byte_identical(cap):
    rules, hints = hint_set()
    t = T.compile_hint_rules(rules, cap=cap)
    r = RT.compile_hint_rules(_ref_rules(rules), cap=cap)
    assert (t.n, t.cap) == (r.n, r.cap)
    same_arrays(RMT.table_arrays(r), MT.table_arrays(t))
    same_arrays(RT.encode_hints(hints), T.encode_hints(hints))
    for h in (None, "a.b", "x" * 90):
        assert T.encode_host(h).tobytes() == RT.encode_host(h).tobytes()
    for u in (None, "/a", "/" + "u" * 200):
        a, b = T.encode_uri(u), RT.encode_uri(u)
        assert a[0].tobytes() == b[0].tobytes() and a[1] == b[1]


def test_compile_cidr_acl_byte_identical():
    rnd = random.Random(6)
    nets = rand_nets(rnd, 200, PKGS["torch"])
    acl = rand_acl(rnd, 80, PKGS["torch"])
    for cap in (None, 256, 512):
        same_arrays(RMT.table_arrays(RT.compile_cidr_rules(
            [ref_net(n) for n in nets], cap=cap)),
            MT.table_arrays(T.compile_cidr_rules(nets, cap=cap)))
    for proto in (IR.Proto.TCP, IR.Proto.UDP):
        t = T.compile_acl(acl, proto)
        r = RT.compile_acl(ref_acl(acl), RIR.Proto(proto.value))
        assert (t.n, t.cap) == (r.n, r.cap)
        same_arrays(RMT.table_arrays(r), MT.table_arrays(t))
    rt = IR.RouteTable()
    for i, n in enumerate(nets[:40]):
        rt.add(IR.RouteRule(f"r{i}", n, to_vni=i))
    rrt = RIR.RouteTable()
    for rr in rt.rules_v4 + rt.rules_v6:
        rrt.add(RIR.RouteRule(rr.alias, ref_net(rr.rule), to_vni=rr.to_vni))
    same_arrays(RMT.table_arrays(RT.compile_route_table(rrt.rules_v6)),
                MT.table_arrays(T.compile_route_table(rt.rules_v6)))


def test_caps_grow_past_match_chunk_like_reference():
    for n in (0, 1, 256, 257, 8192, 8193, 16385):
        assert T._pad_cap(n) == RT._pad_cap(n), n
    nets = [IP.Network(bytes([10, i >> 8, i & 255, 0]), IP.mask_bytes(24))
            for i in range(T.MATCH_CHUNK + 1)]
    t = T.compile_cidr_rules(nets)
    r = RT.compile_cidr_rules([ref_net(n) for n in nets])
    assert t.cap == r.cap == 2 * T.MATCH_CHUNK
    same_arrays(RMT.table_arrays(r), MT.table_arrays(t))


def test_overlong_rules_raise_like_reference():
    for bad in (dict(host="h" * (T.MAX_HOST + 1)),
                dict(uri="/" + "u" * T.MAX_URI)):
        with pytest.raises(ValueError, match="longer than"):
            T.compile_hint_rules([IR.HintRule(**bad)])
        with pytest.raises(ValueError, match="longer than"):
            RT.compile_hint_rules([RIR.HintRule(**bad)])


# ---------------------------------------------- plain tier vs reference

def _hint_both(t, r, q, chunk):
    rq = q
    ra = RMT.table_arrays(r)
    want = RMT.hint_match_chunked(ra, rq["host"], rq["has_host"],
                                  r_unpack(rq["uri"]), rq["has_uri"],
                                  rq["port"], chunk=chunk)
    qd = tt(q)
    got = MT.hint_match_chunked(tt(MT.table_arrays(t)), qd["host"],
                                qd["has_host"], unpack_bits(qd["uri"]),
                                qd["has_uri"], qd["port"], chunk=chunk)
    return got, want


@pytest.mark.parametrize("chunk", [256, 8192])
def test_hint_match_vs_jax(chunk):
    rules, hints = hint_set()
    t = T.compile_hint_rules(rules, cap=1024)
    r = RT.compile_hint_rules(_ref_rules(rules), cap=1024)
    got, want = _hint_both(t, r, T.encode_hints(hints), chunk)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int((got[0] >= 0).sum()) > 50


def _cidr_set(seed=7):
    rnd = random.Random(seed)
    nets = rand_nets(rnd, 300, PKGS["torch"])
    addrs = [rand_addr(rnd) for _ in range(240)]
    for i in range(0, 160, 2):
        addrs[i] = nets[(i * 7) % len(nets)].ip
    return nets, addrs


@pytest.mark.parametrize("gate", ["routes", "ports", "none"])
@pytest.mark.parametrize("chunk", [256, 8192])
def test_cidr_first_match_vs_jax(gate, chunk):
    nets, addrs = _cidr_set()
    rnd = random.Random(8)
    acl = None if gate == "routes" else [
        IR.AclRule(f"r{i}", n, IR.Proto.TCP, lo, lo + rnd.randint(0, 9000),
                   i % 2 == 0)
        for i, (n, lo) in enumerate((n, rnd.randint(0, 60000))
                                    for n in nets)]
    t = T.compile_cidr_rules(nets, cap=768, acl=acl)
    r = RT.compile_cidr_rules([ref_net(n) for n in nets], cap=768,
                              acl=ref_acl(acl))
    a16, fam = T.encode_ips(addrs)
    # pad rows of family -1 at the end, as the engine pads
    a16 = np.concatenate([a16, np.zeros((16, 16), np.uint8)])
    fam = np.concatenate([fam, np.full(16, -1, np.int32)])
    port = None if gate != "ports" else np.array(
        [rnd.randint(0, 65535) for _ in range(len(fam))], np.int32)
    want = np.asarray(RMT.cidr_first_match_chunked(
        RMT.table_arrays(r), a16, fam, port, chunk=chunk))
    got = MT.cidr_first_match_chunked(
        tt(MT.table_arrays(t)), torch.from_numpy(a16),
        torch.from_numpy(fam),
        None if port is None else torch.from_numpy(port), chunk=chunk)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (want[-16:] == -1).all() and (want >= 0).sum() > 40


def test_classify_all_vs_jax():
    rules, hints = hint_set(seed=9, n=200)
    nets, addrs = _cidr_set(seed=10)
    acl = acl_rules(300, 4)
    h = T.compile_hint_rules(rules)
    ro = T.compile_cidr_rules(nets)
    ac = T.compile_acl(acl, IR.Proto.TCP)
    rh = RT.compile_hint_rules(_ref_rules(rules))
    rro = RT.compile_cidr_rules([ref_net(n) for n in nets])
    rac = RT.compile_acl(ref_acl(acl), RIR.Proto.TCP)
    b = 160
    hq = T.encode_hints(hints[:b])
    a16, fam = T.encode_ips((addrs * 2)[:b])
    aq = CS.acl_queries(acl, b, 3)
    aa16, afam = T.encode_ips([a for a, _ in aq])
    port = np.array([p for _, p in aq], np.int32)
    want = RMT.classify_all(
        RMT.table_arrays(rh), RMT.table_arrays(rro), RMT.table_arrays(rac),
        hq, {"addr": a16, "family": fam},
        {"addr": aa16, "family": afam, "port": port})
    got = MT.classify_all(
        tt(MT.table_arrays(h)), tt(MT.table_arrays(ro)),
        tt(MT.table_arrays(ac)), tt(hq), tt({"addr": a16, "family": fam}),
        tt({"addr": aa16, "family": afam, "port": port}))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int((got[3] >= 0).sum()) > 20


# ------------------------------------------- the packed layout (B9's)

def packed_hint_torch(p: dict, q: dict):
    """The kernel's masked word compare, as torch ops over the packed
    layout (csrc/dense_match.cu `dense_hint_kernel`, query by query):
    the query's host bytes padded to 68 and read as little-endian words
    in HOST_ORDER, its uri as 32 words; per rule the host words below
    max(exact count, suffix count) and the uri words below its count,
    the flags, score and port of its meta row. -> (idx, level)."""
    b = q["host"].shape[0]
    host = np.zeros((b, 4 * DC.HOST_WORDS), np.uint8)
    host[:, :T.HOST_SLOT] = q["host"]
    qh = torch.from_numpy(host.view("<i4")[:, DC.HOST_ORDER].copy())
    qu = torch.from_numpy(np.ascontiguousarray(q["uri"]).view("<i4").copy())
    hrows, urows, meta = (torch.from_numpy(p[k]) for k in
                          ("hrows", "urows", "meta"))
    n = meta.shape[0]
    if n == 0:
        return np.full(b, -1, np.int32), np.zeros(b, np.int32)
    flags = meta[:, 0] & 0xFF
    ne, ns, nu = ((meta[:, 0] >> s) & 0xFF for s in (8, 16, 24))
    nw = torch.maximum(ne, ns)
    hl_ = torch.arange(DC.HOST_WORDS)[None] < nw[:, None]   # [n, 17]
    ul_ = torch.arange(DC.URI_WORDS)[None] < nu[:, None]    # [n, 32]

    def miss(qw, m, v, live):  # [b, W], [n, W] x2, [n, W] -> [b, n]
        return ((((qw[:, None] ^ v[None]) & m[None]) != 0) &
                live[None]).any(-1)
    de = miss(qh, hrows[..., 0], hrows[..., 1], hl_)
    ds = miss(qh, hrows[..., 2], hrows[..., 3], hl_)
    um = torch.stack([urows[..., 0], urows[..., 2]], -1).reshape(n, -1)
    uv = torch.stack([urows[..., 1], urows[..., 3]], -1).reshape(n, -1)
    du = miss(qu, um, uv, ul_)
    f = lambda bit: ((flags & bit) != 0)[None]  # noqa: E731
    hl = torch.where(f(DC.F_EXACT) & ~de, 3,
                     torch.where(f(DC.F_SUFFIX) & ~ds, 2, 0))
    hl = torch.maximum(hl, f(DC.F_HWILD).int())
    ul = torch.where(f(DC.F_URI) & ~du, meta[:, 1][None], 0)
    ul = torch.maximum(ul, f(DC.F_UWILD).int())
    hl = torch.where(torch.from_numpy(q["has_host"])[:, None], hl, 0)
    ul = torch.where(torch.from_numpy(q["has_uri"])[:, None], ul, 0)
    level = (hl << 10) + ul
    qp = torch.from_numpy(q["port"])[:, None]
    rp = meta[:, 2][None]
    ok = ((qp == 0) | (rp == 0) | (qp == rp)) & f(DC.F_ACTIVE)
    level = torch.where(ok, level, 0)
    key = level.long() * n + (n - 1 - torch.arange(n))[None]
    idx = key.argmax(1)
    best = level.gather(1, idx[:, None])[:, 0]
    return (torch.where(best > 0, idx, -1).int().numpy(),
            best.int().numpy())


def packed_cidr_torch(p: dict, a16, fam, port=None):
    """The same for `dense_cidr_kernel`: per rule the valid slots of the
    query's family, 4 mask and 4 value words each, the port gate from
    the meta row; the first rule that matches. -> int32 [B]."""
    rows, meta = torch.from_numpy(p["rows"]), torch.from_numpy(p["meta"])
    n, b = meta.shape[0], a16.shape[0]
    if n == 0:
        return np.full(b, -1, np.int32)
    q = torch.from_numpy(np.ascontiguousarray(a16).view("<i4").copy())
    fm = torch.from_numpy(fam)[:, None]
    hit = torch.zeros(b, n, dtype=torch.bool)
    for s in range(3):
        m, v = rows[:, 2 * s], rows[:, 2 * s + 1]           # [n, 4]
        ok = (((q[:, None] ^ v[None]) & m[None]) == 0).all(-1)
        valid = ((meta[:, 0] >> s) & 1) == 1
        sfam = (meta[:, 0] >> (3 + s)) & 1
        hit |= ok & valid[None] & (sfam[None] == fm)
    if port is not None:
        qp = torch.from_numpy(port)[:, None]
        hit &= (meta[:, 1][None] <= qp) & (qp <= meta[:, 2][None])
    first = torch.where(hit, torch.arange(n)[None], n).min(1).values
    return torch.where(first < n, first, -1).int().numpy()


@pytest.mark.parametrize("case", ["random", "long", "uri_only", "empty"])
def test_packed_hint_layout_answers_like_reference(case):
    rules, hints = hint_set(seed=11)
    if case == "long":  # hosts differing only past the first words
        rules = [IR.HintRule(host=f"{i:03d}" + "q" * 44 + ".io")
                 for i in range(50)] + [IR.HintRule(host="z" * 64)]
        hints = [IR.Hint.of_host(r.host) for r in rules] + [
            IR.Hint.of_host("p." + r.host) for r in rules] + [
            IR.Hint.of_host("y" + "z" * 63), IR.Hint.of_host("z" * 65)]
    elif case == "uri_only":
        rules = [IR.HintRule(uri="/" + "a" * i) for i in range(1, 120, 7)]
        hints = [IR.Hint.of_uri("/" + "a" * i + "b") for i in range(130)]
    elif case == "empty":
        rules = [IR.HintRule()] * 5
    t = T.compile_hint_rules(rules)
    p = DC.pack_dense_hint_table(MT.table_arrays(t))
    n = next((i + 1 for i in range(len(rules) - 1, -1, -1)
              if not rules[i].is_empty()), 0)
    assert p["meta"].shape == (n, 4) and p["hrows"].shape == (n, 17, 4)
    assert p["urows"].shape == (n, 16, 4)
    q = T.encode_hints(hints)
    r = RT.compile_hint_rules(_ref_rules(rules))
    want = RMT.hint_match_chunked(RMT.table_arrays(r), q["host"],
                                  q["has_host"], r_unpack(q["uri"]),
                                  q["has_uri"], q["port"])
    got = packed_hint_torch(p, q)
    assert np.array_equal(got[0], np.asarray(want[0]))
    assert np.array_equal(got[1], np.asarray(want[1]))
    w = DC.hint_pattern_words(tt(p))
    if case == "long":  # the counts cut every pattern to its live words
        ne = (p["meta"][:, 0] >> 8) & 0xFF
        ns = (p["meta"][:, 0] >> 16) & 0xFF
        assert ne[0] == 1 + -(-50 // 4) and ns[0] == 2 + 50 // 4
        assert ne[-1] == 17 and ns[-1] == 17
        # the words a query compares: the suffix's length-byte word has
        # no mask bit unless the host reaches byte 64
        assert w["host"][0] == ne[0] + ns[0] - 1
        assert w["host"][-1] == 34 and int(w["uri"].sum()) == 0
    if case == "uri_only":  # "/" + i a's: ceil((i + 1) / 4) words
        assert w["uri"].tolist() == [-(-(i + 1) // 4)
                                     for i in range(1, 120, 7)]
        assert int(w["host"].sum()) == 0
    if case == "empty":
        assert w["host"].numel() == 0 and w["uri"].numel() == 0


@pytest.mark.parametrize("gate", ["routes", "ports", "none"])
def test_packed_cidr_layout_answers_like_reference(gate):
    nets, addrs = _cidr_set(seed=12)
    acl = None if gate == "routes" else acl_rules(400, 6)
    if acl is not None:
        nets = [r.network for r in acl]
        addrs = [a for a, _ in CS.acl_queries(acl, 240, 7)]
    t = T.compile_cidr_rules(nets, acl=acl)
    p = DC.pack_dense_cidr_table(MT.table_arrays(t))
    assert p["rows"].shape == (len(nets), 6, 4)
    a16, fam = T.encode_ips(addrs)
    a16 = np.concatenate([a16, np.zeros((8, 16), np.uint8)])
    fam = np.concatenate([fam, np.full(8, -1, np.int32)])
    port = None if gate != "ports" else np.array(
        [(443, 22, 0, 65535, 8080)[i % 5] for i in range(len(fam))],
        np.int32)
    r = RT.compile_cidr_rules([ref_net(n) for n in nets],
                              acl=ref_acl(acl))
    want = np.asarray(RMT.cidr_first_match_chunked(RMT.table_arrays(r), a16,
                                                   fam, port))
    assert np.array_equal(packed_cidr_torch(p, a16, fam, port), want)
    assert (want >= 0).sum() > 40


def test_packed_cidr_layout_empty_and_trailing_pad():
    nets = [IP.Network.parse("10.0.0.0/8")]
    t = T.compile_cidr_rules(nets)
    p = DC.pack_dense_cidr_table(MT.table_arrays(t))
    assert p["meta"].shape == (1, 4) and p["meta"][0, 0] == 0b110111
    w = DC.cidr_slot_words(tt(p))
    assert w["v6"].tolist() == [[False, True, True]]
    assert w["words"].tolist() == [[1, 4, 4]]  # 10/8; the two /104s
    six = DC.cidr_slot_words(tt(DC.pack_dense_cidr_table(MT.table_arrays(
        T.compile_cidr_rules([IP.Network.parse("2001:db8::/48"),
                              IP.Network.parse("::/0")])))))
    assert six["words"].tolist() == [[2, 0, 0], [0, 0, 0]]
    p0 = DC.pack_dense_cidr_table(MT.table_arrays(T.compile_cidr_rules([])))
    assert p0["rows"].shape == (0, 6, 4)


# ---------------------------------------------- matchers and service

def ref_hint(rules, payload="pl"):
    return RE.HintMatcher(rules, backend="jax-dense", payload=payload)


def test_default_backend_maps_jax_dense(monkeypatch):
    monkeypatch.setenv("VPROXY_TPU_MATCHER", "jax-dense")
    assert E.default_backend() == "torch-dense"
    assert E.HintMatcher(mk_rules(40)).backend == "torch-dense"
    assert E.CidrMatcher(route_nets(20, 3)).backend == "torch-dense"
    with pytest.raises(ValueError, match="unknown backend"):
        E.HintMatcher([], backend="jax-dense")


@pytest.mark.parametrize("pad_to", [None, 256])
def test_hint_matcher_torch_dense_vs_reference_across_updates(pad_to):
    """The cap reused by an update that fits (the same shapes), a new
    bucket for one that outgrows it; answers, generation and table
    bytes equal to the reference's jax-dense matcher."""
    rules = mk_rules(200)
    hints = mk_queries(rules, 120)
    m = E.HintMatcher(rules, backend="torch-dense", payload="pl")
    rm = ref_hint(rules)
    for step, new in enumerate((mk_rules(250, seed=3), mk_rules(700))):
        snap, rsnap = m.snapshot(), rm.snapshot()
        got = E.to_host(m.dispatch_snap(snap, hints, pad_to=pad_to))
        want = np.asarray(rm.dispatch_snap(rsnap, hints, pad_to=pad_to))
        assert got.tolist()[:len(hints)] == want.tolist()[:len(hints)]
        assert got.tolist()[:len(hints)] == [
            m.index_snap(snap, h) for h in hints]
        assert m.published_table_bytes() == rm.published_table_bytes()
        assert m.generation == rm.generation
        assert m.checksum() == rm.checksum()
        cap = snap[1]["active"].shape[0]
        m.set_rules(new, payload="p2")
        rm.set_rules(new, payload="p2")
        assert (m.snapshot()[1]["active"].shape[0] == cap) == (step == 0)
        assert isinstance(m.snapshot()[1], DC.DenseTable)
        assert m.snapshot()[1].packed is None  # CPU: the plain tier
    assert list(m.match(hints)) == list(np.asarray(rm.match(hints)))
    assert m.fused_stat() == {"available": False}


@pytest.mark.parametrize("name", ["routes", "acl"])
def test_cidr_matcher_torch_dense_vs_reference_across_updates(name):
    if name == "routes":
        nets, acl = route_nets(300, 5), None
        qs = [(a, None) for a, _ in CS.cidr_queries(nets, 150, 6)]
    else:
        acl = acl_rules(300, 7)
        nets = [r.network for r in acl]
        qs = CS.acl_queries(acl, 150, 8)
    m = E.CidrMatcher(nets, acl=acl, backend="torch-dense", payload="pl")
    rm = RE.CidrMatcher([ref_net(n) for n in nets], acl=ref_acl(acl),
                        backend="jax-dense", payload="pl")
    addrs, ports = [a for a, _ in qs], [p for _, p in qs]
    for k in (300, 200, 600):  # the first fits, the second outgrows
        got = E.to_host(m.dispatch_snap(m.snapshot(), addrs,
                                        None if acl is None else ports,
                                        pad_to=256))
        want = np.asarray(rm.dispatch_snap(rm.snapshot(), addrs,
                                           None if acl is None else ports,
                                           pad_to=256))
        assert got.tolist() == want.tolist()
        assert got[:len(addrs)].tolist() == [
            m.index_snap(m.snapshot(), a, p) for a, p in qs]
        assert m.published_table_bytes() == rm.published_table_bytes()
        assert m.generation == rm.generation and \
            m.checksum() == rm.checksum()
        if name == "routes":
            nets2 = route_nets(k, 9)
            m.set_networks(nets2)
            rm.set_networks([ref_net(n) for n in nets2])
        else:
            acl2 = acl_rules(k, 10)
            m.set_networks([r.network for r in acl2], acl=acl2)
            rm.set_networks([ref_net(r.network) for r in acl2],
                            acl=ref_acl(acl2))


def test_hash_vs_dense_vs_host_cross_check():
    """test_hashmatch.py's cross check on this package: "torch",
    "torch-dense" and "host" answer alike."""
    rnd = random.Random(12)
    rules = [rand_hint_rule(rnd) for _ in range(64)]
    hints = [rand_hint(rnd) for _ in range(128)]
    got = {be: E.HintMatcher(rules, backend=be).match(hints)
           for be in ("torch", "torch-dense", "host")}
    np.testing.assert_array_equal(got["torch"], got["host"])
    np.testing.assert_array_equal(got["torch-dense"], got["host"])


def pair_of(rules, m=251):
    backends = [(f"10.9.{i}.1:80", 1 + i % 4) for i in range(7)]
    pair = M.FusedPair(E.HintMatcher(rules, backend="torch-dense",
                                     payload="hp"),
                       M.MaglevMatcher(backends, m=m, payload="mp"))
    ref = RM.FusedPair(RE.HintMatcher(rules, backend="jax-dense",
                                      payload="hp"),
                       RM.MaglevMatcher(backends, m=m, payload="mp"))
    return pair, ref


@pytest.mark.parametrize("kind", ["hint", "cpick", "cidr"])
def test_service_torch_dense_vs_reference_service(kind):
    """Device-mode batches over torch-dense matchers answer what the
    reference service answers over jax-dense; a cpick batch is B9 plus
    the Maglev take (fused_dispatch declines a dense matcher: two
    launches and no fused dispatch per batch)."""
    rules = mk_rules(600)
    pair, ref = pair_of(rules)
    b = 64
    if kind == "cidr":
        acl = acl_rules(300, 11)
        qs = CS.acl_queries(acl, b, 12)
        target = E.CidrMatcher([r.network for r in acl], acl=acl,
                               backend="torch-dense", payload="pl")
        rtarget = RE.CidrMatcher([ref_net(r.network) for r in acl],
                                 acl=ref_acl(acl), backend="jax-dense",
                                 payload="pl")
        payloads = [(a, None if i % 3 == 0 else p)
                    for i, (a, p) in enumerate(qs)]
    elif kind == "cpick":
        payloads = list(zip(mk_queries(rules, b), mk_ips(b), ports_of(b)))
        target, rtarget = pair, ref
    else:
        payloads, target, rtarget = mk_queries(rules, b), pair.hm, ref.hm
    svc, rsvc = ClassifyService(mode="device"), RefService(mode="device")
    try:
        l0, f0 = E.dispatch_launches_total(), E.fused_dispatches_total()
        t0 = M._device_take.calls
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
        per_batch = 2 if kind == "cpick" else 1  # B9 + the Maglev take
        assert E.dispatch_launches_total() - l0 == \
            per_batch * st.dispatches >= 1
        assert M._device_take.calls - t0 == (
            st.dispatches if kind == "cpick" else 0)
    finally:
        svc.close()
        rsvc.close()


def test_fused_dispatch_declines_torch_dense():
    rules = mk_rules(200)
    pair, _ = pair_of(rules)
    hm, mm = pair.hm, pair.mm
    hints, ips = mk_queries(rules, 16), mk_ips(16)
    assert E.fused_dispatch(hm, hm.snapshot(), mm, mm.snapshot(), hints,
                            ips) is None
    cm = E.CidrMatcher(route_nets(100, 3), backend="torch-dense")
    assert E.fused_dispatch_all(hm, hm.snapshot(), cm, cm.snapshot(), mm,
                                mm.snapshot(), hints, [bytes(4)] * 16,
                                ips) is None
    v, p, hp, mp = M.classify_and_pick(hm, mm, hints, ips)
    assert list(v) == [hm.index_snap(hm.snapshot(), h) for h in hints]
    assert list(p) == [M.pick(mm.snapshot()[0], ip, None) for ip in ips]
    assert (hp, mp) == ("hp", "mp")


def test_secgroup_on_torch_dense(monkeypatch):
    from vproxy_tpu_torch.components.secgroup import SecurityGroup
    monkeypatch.setenv("VPROXY_TPU_MATCHER", "jax-dense")
    acl = acl_rules(200, 13)
    g = SecurityGroup("sg", default_allow=False)
    g.extend_rules(acl)
    am = g._tables[IR.Proto.TCP][0]
    assert am.backend == "torch-dense"
    for a, p in CS.acl_queries(acl, 64, 14):
        j = oracle.acl_first_match(acl, IR.Proto.TCP, a, p)
        assert am.match([a], [p])[0] == j
        assert g.allow(IR.Proto.TCP, a, p) == (acl[j].allow if j >= 0
                                              else False)


# ------------------------------------------------ B5, the Maglev take

def test_maglev_take_plain_vs_reference_with_clip():
    tab = RM.build_table([(f"b{i}", 1 + i % 3) for i in range(9)], 251)
    slots = np.array([0, 5, 250, 251, 10**9, -1, -(10**9), 17], np.int64)
    want = np.asarray(RM._device_take(tab, slots))
    n = M._device_take.calls
    got = M._device_take(torch.from_numpy(tab), slots)
    assert M._device_take.calls == n + 1
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()
    assert got.tolist() == TC.take_plain(
        torch.from_numpy(tab), torch.from_numpy(slots)).tolist()
    assert got.tolist() == [int(tab[min(max(s, 0), 250)]) for s in slots]


# -------------------------------------------------- the CUDA entries

def _dense_inputs(device):
    rules, hints = hint_set(seed=15, n=100)
    ht = DC.DenseTable({k: v.to(device) for k, v in
                        tt(MT.table_arrays(T.compile_hint_rules(rules))
                           ).items()})
    q = {k: v.to(device) for k, v in tt(T.encode_hints(hints[:32])).items()}
    acl = acl_rules(100, 16)
    ct = DC.DenseTable({k: v.to(device) for k, v in tt(MT.table_arrays(
        T.compile_acl(acl, IR.Proto.TCP))).items()})
    qs = CS.acl_queries(acl, 32, 17)
    a16, fam = T.encode_ips([a for a, _ in qs])
    p = np.array([x for _, x in qs], np.int32)
    return ht, q, ct, *(torch.from_numpy(x).to(device) for x in (a16, fam, p))


def test_dense_entries_serve_cpu_tensors_with_plain_tier():
    ht, q, ct, a16, fam, p = _dense_inputs("cpu")
    n = (DC.hint_dense_cuda.launches, DC.cidr_dense_cuda.launches)
    gi, gl = MT.hint_dense(ht, q)
    ri, rl = MT.hint_match_chunked(ht, q["host"], q["has_host"],
                                   unpack_bits(q["uri"]), q["has_uri"],
                                   q["port"])
    assert torch.equal(gi, ri) and torch.equal(gl, rl)
    assert torch.equal(MT.cidr_dense(ct, a16, fam, p),
                       MT.cidr_first_match_chunked(ct, a16, fam, p))
    rq, aq = {"addr": a16, "family": fam}, {"addr": a16, "family": fam,
                                             "port": p}
    for g, w in zip(MT.classify_dense(ht, ct, ct, q, rq, aq),
                    MT.classify_all(ht, ct, ct, q, rq, aq)):
        assert torch.equal(g, w)
    assert (DC.hint_dense_cuda.launches, DC.cidr_dense_cuda.launches) == n
    assert TC.take(torch.arange(5, dtype=torch.int32),
                   torch.tensor([-3, 9])).tolist() == [0, 4]


def test_dense_entries_raise_on_non_cpu_tensor(monkeypatch):
    """A tensor off the CPU goes to the kernels or raises, for B9's hint,
    cidr and classify entries and B5: no plain version is substituted
    (meta tensors stand in for CUDA ones on this CPU-only build)."""
    called = []
    for name in ("hint_match_chunked", "cidr_first_match_chunked",
                 "classify_all"):
        monkeypatch.setattr(MT, name, lambda *a, **k: called.append(a))
    monkeypatch.setattr(TC, "take_plain", lambda *a: called.append(a))

    def no_lib():
        raise FC.KernelError("nvcc failed (1)")
    monkeypatch.setattr(DC, "_lib", no_lib)
    monkeypatch.setattr(TC, "_lib", no_lib)
    ht, q, ct, a16, fam, p = _dense_inputs("meta")
    rq, aq = {"addr": a16, "family": fam}, {"addr": a16, "family": fam,
                                             "port": p}
    n = (DC.hint_dense_cuda.launches, DC.cidr_dense_cuda.launches,
         TC.maglev_take_cuda.launches)
    for call in (lambda: MT.hint_dense(ht, q),
                 lambda: MT.cidr_dense(ct, a16, fam, p),
                 lambda: MT.classify_dense(ht, ct, ct, q, rq, aq),
                 lambda: TC.take(torch.zeros(5, dtype=torch.int32,
                                             device="meta"),
                                 torch.zeros(3, dtype=torch.int64,
                                             device="meta"))):
        with pytest.raises(FC.KernelError):
            call()
    # a packed layout not prepared (prepare_hint) is refused, and a
    # prepared one with still no library: KernelError
    layout = {k: torch.from_numpy(v).to("meta") for k, v in
              DC.pack_dense_hint_table(
                  {k: v.cpu().numpy() for k, v in
                   tt(MT.table_arrays(T.compile_hint_rules(
                       mk_rules(30)))).items()}).items()}
    ht.packed = layout
    with pytest.raises(FC.KernelError, match="no prepared packed layout"):
        MT.hint_dense(ht, q)
    ht.packed = DC.PreparedDense(layout)
    ht.packed.device, ht.packed.n = torch.device("meta"), 30
    with pytest.raises(FC.KernelError, match="nvcc"):
        MT.hint_dense(ht, q)
    assert not called
    assert (DC.hint_dense_cuda.launches, DC.cidr_dense_cuda.launches,
            TC.maglev_take_cuda.launches) == n


def test_dense_prepare_refuses_cpu_and_bad_layouts(monkeypatch):
    monkeypatch.setattr(DC, "_lib", lambda: None)
    arrays = MT.table_arrays(T.compile_hint_rules(mk_rules(50)))
    p = tt(DC.pack_dense_hint_table(arrays))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        DC.prepare_hint(p)
    meta = {k: v.to("meta") for k, v in p.items()}
    prep = DC.prepare_hint(meta)
    assert prep.n == 50 and DC.prepare_hint(prep) is prep
    bad = dict(meta)
    bad["hrows"] = bad["hrows"][:, :16]
    with pytest.raises(ValueError, match="hrows must be"):
        DC.prepare_hint(bad)
    bad = dict(meta)
    del bad["urows"]
    with pytest.raises(ValueError, match="missing 'urows'"):
        DC.prepare_hint(bad)
    c = {k: v.to("meta") for k, v in tt(DC.pack_dense_cidr_table(
        MT.table_arrays(T.compile_cidr_rules(route_nets(40, 1))))).items()}
    assert DC.prepare_cidr(c).n == 40
    c["meta"] = c["meta"].to(torch.int64)
    with pytest.raises(ValueError, match="meta must be"):
        DC.prepare_cidr(c)


def test_dense_grid_fills_the_card_and_covers_every_rule():
    for b, n in ((16, 100_000), (512, 100_000), (4096, 100_000),
                 (512, 5_000), (1, 0), (100, 63)):
        threads, tiles, split = DC.grid(b, n)
        assert threads % 32 == 0 and 32 <= threads <= DC.MAX_THREADS
        assert tiles * threads >= b > (tiles - 1) * threads
        ys = -(-n // split) if n else 1
        assert ys * split >= n and split >= 1
        if n >= DC.MIN_SPLIT * DC.TARGET_BLOCKS:
            assert tiles * ys >= DC.TARGET_BLOCKS * 0.9


@pytest.mark.parametrize("kind", ["hint", "cidr"])
def test_torch_dense_matcher_off_cpu_refuses_to_publish_without_kernel(
        kind, monkeypatch):
    def no_lib():
        raise FC.KernelError("nvcc failed (1)")
    monkeypatch.setattr(DC, "_lib", no_lib)
    with pytest.raises(FC.KernelError):
        if kind == "hint":
            E.HintMatcher(mk_rules(40), backend="torch-dense",
                          device="meta")
        else:
            E.CidrMatcher(route_nets(64, 32), backend="torch-dense",
                          device="meta")


def test_maglev_matcher_off_cpu_refuses_to_publish_without_kernel(
        monkeypatch):
    def no_lib():
        raise FC.KernelError("nvcc failed (1)")
    monkeypatch.setattr(TC, "_lib", no_lib)
    with pytest.raises(FC.KernelError):
        M.MaglevMatcher([("a", 1)], m=251, device="meta")


def test_dense_and_take_builds_without_nvcc_raise(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(FC, "CUDA_DEFAULT", str(tmp_path / "cuda"))
    monkeypatch.setattr(FC, "BUILD_DIR", str(tmp_path / "build"))
    for build in (DC.build, TC.build):
        with pytest.raises(FC.KernelError, match="nvcc"):
            build()
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("kind", ["hint", "cidr"])
def test_dense_kernel_abi_mirror_matches_source(kind):
    """The ctypes mirrors have the C structs' fields, in order, and the
    take's argument list has the C function's."""
    struct, cls = (("DenseHintArgs", DC._DenseHintArgs) if kind == "hint"
                   else ("DenseCidrArgs", DC._DenseCidrArgs))
    with open(DC.SOURCE) as f:
        body = re.search(rf"struct {struct} \{{(.*?)\}};", f.read(),
                         re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    ptrs = re.findall(r"\*\s*(\w+);", body)
    ints = [x.strip() for decl in re.findall(r"int32_t ([\w ,\n]+);", body)
            for x in decl.replace("\n", " ").split(",")]
    assert [n for n, _ in cls._fields_] == ptrs + ints
    assert all(t is ctypes.c_void_p for _, t in cls._fields_[:len(ptrs)])
    assert ctypes.sizeof(cls) == 8 * len(ptrs) + 4 * len(ints)
    with open(TC.SOURCE) as f:
        sig = re.search(r"int vproxy_maglev_take\((.*?)\)", f.read(),
                        re.S).group(1)
    assert [a.split()[-1].lstrip("*") for a in sig.split(",")] == [
        "mtab", "m", "slots", "b", "out", "device", "stream"]


# ------------------------------------------------- chip_smoke.py, small

def test_dense_work_counts_each_needed_word_once():
    """chip_smoke.py's B9 bound counts, against a loop over every query
    and rule: a query compares its host (uri) against the host (uri)
    words with a mask bit of every active rule its port gate admits; a
    cidr query the words with a mask bit of its family's valid slots of
    each rule up to its first match whose port range holds."""
    dev = torch.device("cpu")
    rules = mk_rules(120, seed=3) + [IR.HintRule(host="x.io", port=80)]
    arrays = MT.table_arrays(T.compile_hint_rules(rules))
    t = E._dense_table(arrays, dev)
    hints = mk_queries(rules, 40, seed=4)
    hints = [IR.Hint(host=h.host, uri=h.uri, port=(0, 443, 80, 8)[i % 4])
             for i, h in enumerate(hints)]
    q = CS.dense_hint_batch(hints, 48, dev)
    p = DC.pack_dense_hint_table(arrays)
    flags = p["meta"][:, 0] & 0xFF
    nz = lambda m: (m != 0).sum(-1)  # noqa: E731
    hw = np.where(flags & DC.F_EXACT, nz(p["hrows"][..., 0]), 0) + \
        np.where(flags & DC.F_SUFFIX, nz(p["hrows"][..., 2]), 0)
    uw = np.where(flags & DC.F_URI, nz(p["urows"][..., 0]) +
                  nz(p["urows"][..., 2]), 0)
    ops = 0
    for i in range(48):
        qp = int(q["port"][i])
        for r in range(p["meta"].shape[0]):
            rp = int(p["meta"][r, 2])
            if flags[r] & DC.F_ACTIVE and (qp == 0 or rp == 0 or qp == rp):
                ops += 2 * (int(q["has_host"][i]) * int(hw[r]) +
                            int(q["has_uri"][i]) * int(uw[r]))
    qbytes = sum(v.numel() * v.element_size() for v in q.values())
    assert CS.dense_hint_work(t, q) == (
        qbytes + 48 * 8 + 16 * int((flags & DC.F_ACTIVE != 0).sum()) +
        8 * int((hw + uw)[(flags & DC.F_ACTIVE) != 0].sum()), ops)
    assert ops > 0

    acl = acl_rules(90, 6)
    arrays = MT.table_arrays(T.compile_cidr_rules([r.network for r in acl],
                                                  acl=acl))
    t = E._dense_table(arrays, dev)
    c = DC.pack_dense_cidr_table(arrays)
    for ports in (True, False):
        qs = CS.acl_queries(acl, 56, 8)
        if not ports:
            qs = [(a, None) for a, _ in qs]
        a16, fam, port = CS.cidr_batch(qs, 64, dev)
        first = MT.cidr_first_match_chunked(t, a16, fam, port)
        ops, reach = 0, {0: 0, 1: 0}
        for i in range(64):
            f = int(fam[i])
            if f < 0:
                continue
            stop = int(first[i]) + 1 if first[i] >= 0 else len(c["meta"])
            reach[f] = max(reach[f], stop)
            for r in range(stop):
                mt = c["meta"][r]
                if port is not None and not (
                        mt[1] <= int(port[i]) <= mt[2]):
                    continue
                for s in range(3):
                    if (mt[0] >> s) & 1 and (mt[0] >> (3 + s)) & 1 == f:
                        ops += 2 * int(nz(c["rows"][r, 2 * s]))
        words = sum(int(nz(c["rows"][r, 2 * s]))
                    for f in (0, 1) for r in range(reach[f])
                    for s in range(3) if (c["meta"][r, 0] >> s) & 1 and
                    (c["meta"][r, 0] >> (3 + s)) & 1 == f)
        nbytes = 64 * 24 + (64 * 4 if ports else 0) + \
            16 * max(reach.values()) + 8 * words
        assert CS.dense_cidr_work(t, a16, fam, port) == (nbytes, ops)
        assert ops > 0


def test_chip_smoke_dense_phases_on_cpu():
    """chip_smoke.py's dense phases at a small size on the CPU: the
    parity sets against the plain tier (here the plain tier against
    itself, and the packed layout's torch form against it), the
    service bursts against the host index, and the bound's byte and op
    counts (the plain tiers here: no kernel launches)."""
    dev = torch.device("cpu")
    tabs = CS.dense_tables(dev, n_rules=300, n_routes=400, n_acl=300)
    err = CS.phase_dense_kernels(dev, tabs, batches=(16, 64), n_host=300)
    assert err == {"b9": 0, "all": 0, "b5": 0}
    out = CS.phase_dense_service(dev, tabs, bursts=2, burst=24)
    assert out["queries"] == 4 * 48 and out["failovers"] == 0
    assert out["launches"] == {"hint_dense": 0, "cidr_dense": 0,
                               "maglev_take": 0}
    assert out["maglev_takes"] == out["batches"]["cpick"] > 0
    assert all(v > 0 for v in out["batches"].values())
    hsnap = tabs["hm"].snapshot()
    q = CS.dense_hint_batch(mk_queries(tabs["rules"], 48), 64, dev)
    nb, ops = CS.dense_hint_work(hsnap[1], q)
    assert nb > 0 and ops > 0
    a16, fam, port = CS.cidr_batch(CS.acl_queries(tabs["acl"], 48, 5), 64,
                                   dev)
    nb, ops = CS.dense_cidr_work(tabs["am"].snapshot()[0], a16, fam, port)
    assert nb > 64 * 24 and ops > 0
