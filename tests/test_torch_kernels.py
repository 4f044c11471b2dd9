"""Torch port, device programs: the torch tiers against the JAX programs.

Each case compiles one rule set, encodes one query batch (seeded
`random`), uploads the SAME numpy arrays to both packages
(tables_from_reference on the port's side) and requires bit-identical
int32 results:

* hint_hash_match (the unfused tier) vs hashmatch.hint_hash_jit;
* fused_classify_pick (the plain tier of the CUDA kernel) vs
  fused.fused_jit, with and without uri rules, and vs the Pallas kernel
  in interpret mode, on chip_smoke.py's boundary sets too (the inputs
  the card's kernel is held to there);
* both _reduce_best branches (i32 pack, and two passes past r_cap
  524,286);
* pad rows never match.

The CUDA kernel itself runs only on the GPU (chip_smoke.py holds it
against the plain tier there); here the tests prove the fused entry
never substitutes the plain tier for a non-CPU tensor, that the
kernel's compare word suits every window width the compiler gives, and
that chip_smoke.py's copies of these cases' generators (and of the
CIDR generators of tests/test_torch_cidr.py) give the same rules and
queries.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

import chip_smoke as CS
from test_fused import mk_ips, mk_queries, mk_rules
from test_torch_host import LONG, SHARED, rand_hints, rand_rules
from vproxy_tpu_torch.ops.tables import MAX_HOST, MAX_URI
from vproxy_tpu.ops import fused as RF
from vproxy_tpu.ops import hashmatch as RH
from vproxy_tpu.rules import maglev as RM
from vproxy_tpu_torch.ops import fused as F
from vproxy_tpu_torch.ops import fused_cuda as FC
from vproxy_tpu_torch.ops import hashmatch as H
from vproxy_tpu_torch.rules import maglev as M
from vproxy_tpu_torch.rules.engine import _PAD_CUCKOO, _pad_hint_q
from vproxy_tpu_torch.rules.ir import Hint, HintRule
from vproxy_tpu_torch.utils.torchenv import tables_from_reference as up

torch.set_num_threads(1)


def host_only(n=3000):
    return [HintRule(host=f"svc{i}.ns{i % 97}.example.com",
                     port=443 if i % 5 == 0 else 0) for i in range(n)] + \
        [HintRule(host="*"), HintRule(host="w.example.com", port=443)]


def host_only_hints(b):
    return [Hint.of_host(f"a.svc{i}.ns{i % 97}.example.com")
            for i in range(b - 3)] + \
        [Hint(host="w.example.com", uri="/x", port=443),
         Hint(uri="/only-uri"), Hint()]


def case(name):
    """-> (rules, hints, caps) of one parity case."""
    if name == "mk_rules_5k_b512":
        r = mk_rules(5000)
        return r, mk_queries(r, 512), None
    if name == "random_300_b600":
        r = rand_rules(300, 11)
        return r, rand_hints(r, 600, 11), None
    if name == "shared_keys":
        return SHARED, [
            Hint(host="a.com", uri="/xyz"), Hint(host="a.com", uri="/xy"),
            Hint(host="a.com"), Hint(host="a.com", port=443),
            Hint(host="a.com", port=8080), Hint(host="b.a.com", uri="/x"),
            Hint(host="z.com"), Hint(uri="/xyq"), Hint(uri="/zzz"),
            Hint(host="*"), Hint(host="q.*"), Hint(uri="*")], None
    if name == "long_hosts":
        h = LONG[0].host
        return LONG, [Hint(host=h), Hint(host="x." + h),
                      Hint(host="q" + h)], None
    if name == "host_only_b96":
        return host_only(), host_only_hints(96), None
    if name in CS.BOUNDARY_CASES:
        return CS.boundary(name)
    if name == "wide_buckets":
        return (*CS.wide_buckets(), None)
    assert name == "two_pass_r_cap_600k"
    r = mk_rules(300)
    return r, mk_queries(r, 64), {"r_cap": 600_000}


CASES = CS.BOUNDARY_CASES + (
    "host_only_b96", "long_hosts", "mk_rules_5k_b512", "random_300_b600",
    "shared_keys", "two_pass_r_cap_600k", "wide_buckets")


def compile_case(name):
    rules, hints, caps = case(name)
    tab = RH.compile_hint_hash(rules, caps=caps)
    q = RH.encode_hint_queries(hints, tab)
    return rules, hints, tab, q


@pytest.mark.parametrize("name", CASES)
def test_hint_hash_match_vs_jax(name):
    rules, hints, tab, q = compile_case(name)
    ref_i, ref_l = RH.hint_hash_jit(tab.arrays, q)
    got_i, got_l = H.hint_hash_match(up(tab.arrays, "cpu"), up(q, "cpu"))
    assert got_i.dtype == got_l.dtype == torch.int32
    assert np.array_equal(np.asarray(ref_i), got_i.numpy())
    assert np.array_equal(np.asarray(ref_l), got_l.numpy())
    if name == "two_pass_r_cap_600k":
        assert tab.r_cap > H._PACK_I32_MAX


@pytest.mark.parametrize("name", CASES)
def test_fused_classify_pick_vs_jax(name):
    rules, hints, tab, q = compile_case(name)
    ht = RF.pack_hint_table(tab.arrays)
    mtab = RM.build_table([(f"b{i}", 1 + i % 3) for i in range(9)], 4099)
    ips = mk_ips(len(hints))
    slots = RM.flow_slots(4099, ips, [None if i % 3 else 1024 + i
                                      for i in range(len(ips))])
    ref = np.asarray(RF.fused_jit(ht, q, mtab, slots))
    got = F.fused_classify_pick(up(ht, "cpu"), up(q, "cpu"),
                                torch.from_numpy(mtab),
                                torch.from_numpy(slots))
    assert got.dtype == torch.int32 and np.array_equal(ref, got.numpy())
    assert ("pk_uslot" in ht) == (name not in ("host_only_b96",
                                               "long_hosts") and
                                  not name.endswith("_hosts"))


@pytest.mark.parametrize("r_cap", [4096, 600_000])
def test_reduce_best_branches_vs_jax(r_cap):
    """Both branches on the same synthetic (level, index) pairs: ties at
    the max level keep the smallest index, level 0 is no match."""
    from vproxy_tpu.ops.hashmatch import _reduce_best as ref_reduce
    rnd = np.random.default_rng(r_cap)
    level = rnd.choice([0, 1, 2, 1024, 1025, 3 << 10, (3 << 10) + 1023],
                       size=(64, 40)).astype(np.int32)
    level[:4] = 0
    c = rnd.integers(0, min(r_cap, 4096), size=(64, 40)).astype(np.int32)
    ri, rl = ref_reduce(level, c, r_cap)
    gi, gl = H._reduce_best(torch.from_numpy(level), torch.from_numpy(c),
                            r_cap)
    assert np.array_equal(np.asarray(ri), gi.numpy())
    assert np.array_equal(np.asarray(rl), gl.numpy())
    assert (gi[:4] == -1).all()


@pytest.mark.parametrize("b,pad_to", [(3, 16), (40, 64)])
def test_fused_pad_rows_never_match(b, pad_to):
    rules = mk_rules(300)
    tab = H.compile_hint_hash(rules)
    q = _pad_hint_q(H.encode_hint_queries(mk_queries(rules, b), tab,
                                          pad_to=pad_to), pad_to,
                    _PAD_CUCKOO)
    assert q["hostb"].shape[0] == pad_to
    slots = np.zeros(pad_to, np.int64)
    ht = F.pack_hint_table(tab.arrays)
    mtab = M.build_table([("b0", 1)], 251)
    got = F.fused_classify_pick(up(ht, "cpu"), up(q, "cpu"),
                                torch.from_numpy(mtab),
                                torch.from_numpy(slots)).numpy()
    ref = np.asarray(RF.fused_jit(ht, q, mtab, slots))
    assert np.array_equal(ref, got)
    assert (got[b:, 0] == -1).all()
    v, _ = H.hint_hash_match(up(tab.arrays, "cpu"), up(q, "cpu"))
    assert (v[b:] == -1).all()


@pytest.mark.parametrize("name", ("mk_rules_400_b16",) +
                         CS.BOUNDARY_CASES)
def test_fused_vs_pallas_interpret(name):
    """The TPU kernel itself, in the Pallas interpreter, against the
    port's plain tier on the same inputs: 400 rules at B = 16, and each
    boundary set of chip_smoke.py (the masked-compare edges at every
    compare word)."""
    from vproxy_tpu.ops import fused_pallas as RFP
    if name == "mk_rules_400_b16":
        rules = mk_rules(400)
        hints, caps = mk_queries(rules, 16), None
    else:
        rules, hints, caps = CS.boundary(name)
    tab = RH.compile_hint_hash(rules, caps=caps)
    q = RH.encode_hint_queries(hints, tab)
    ht = RF.pack_hint_table(tab.arrays)
    mtab = RM.build_table([(f"b{i}", 1) for i in range(6)], 251)
    slots = np.array([RM.flow_hash(ip) % 251 for ip in mk_ips(len(hints))],
                     np.int64)
    ref = np.asarray(RFP.fused_classify_pick_pallas(ht, q, mtab, slots,
                                                    interpret=True))
    got = F.fused_classify_pick(up(ht, "cpu"), up(q, "cpu"),
                                torch.from_numpy(mtab),
                                torch.from_numpy(slots))
    assert np.array_equal(ref, got.numpy())


# ------------------------------------------------- the kernel's compare word

# the longest host / uri that gives each window the compiler makes
# without caps: hw = pow2(longest host + 1 boundary byte) from 8, at
# most MAX_HOST + 1; uw = pow2(longest uri) from 8, at most MAX_URI; a
# table with no uri rule packs uri-free and launches with uw 0
HW_HOST = {8: 7, 16: 15, 32: 31, 64: 63, MAX_HOST + 1: MAX_HOST}
UW_URI = {0: None, 8: 8, 16: 16, 32: 32, 64: 64, MAX_URI: MAX_URI}


@pytest.mark.parametrize("uw", sorted(UW_URI))
@pytest.mark.parametrize("hw", sorted(HW_HOST))
def test_word_bytes_every_compiled_width(hw, uw):
    """Every (hw, uw) compile_hint_hash can give: the word divides both
    windows and the packed row, and is the widest that does."""
    rules = [HintRule(host="h" * (HW_HOST[hw] - 4) + ".com")]
    if UW_URI[uw]:
        rules.append(HintRule(uri="/" + "u" * (UW_URI[uw] - 1)))
    tab = H.compile_hint_hash(rules)
    pk = F.pack_hint_table(tab.arrays)
    kuw = pk["pk_ukey"].shape[1] if "pk_ukey" in pk else 0
    assert (tab.hw, kuw) == (hw, uw)
    w = FC.word_bytes(hw, kuw)
    assert w == (1 if hw == MAX_HOST + 1 else min(16, hw, uw or 16))
    assert hw % w == 0 and kuw % w == 0 and pk["pk_bytes"].shape[1] % w == 0


def test_word_bytes_divides_widths_and_addresses():
    """Any width a caps-reusing compile could give, and base addresses
    off the allocator's alignment: the word divides every value given,
    and no wider word of the kernel does."""
    for hw in range(1, MAX_HOST + 2):
        for uw in range(0, MAX_URI + 1):
            w = FC.word_bytes(hw, uw)
            assert hw % w == 0 and uw % w == 0
            assert not any(hw % x == 0 and uw % x == 0
                           for x in FC.WORDS if x > w)
    assert FC.word_bytes(32, 16, 0x7f0000001000) == 16
    assert FC.word_bytes(32, 16, 0x7f0000001000, 0x7f0000001008) == 8
    assert FC.word_bytes(32, 16, 0x7f0000001004) == 4
    assert FC.word_bytes(64, 128, 0x7f0000001001) == 1


def test_chip_smoke_carries_the_parity_cases():
    """chip_smoke.py holds the kernels to the plain tiers on copies of
    these cases' generators (tests/ is not importable there): the
    copies give the same rules and queries — the hint sets of this file
    and tests/test_torch_host.py, and the CIDR generators of
    tests/test_torch_cidr.py, whose copies are also the same source."""
    import inspect

    import test_torch_cidr as TC
    rules = rand_rules(300, 11)
    assert CS.rand_rules(300, 11) == rules
    assert CS.rand_hints(rules, 600, 11) == rand_hints(rules, 600, 11)
    assert CS.shared_keys() == (SHARED, case("shared_keys")[1])
    assert CS.long_hosts() == (LONG, case("long_hosts")[1])
    for fn in ("_rand_net", "_mapped_net", "route_nets", "acl_rules",
               "cidr_queries", "acl_queries", "hashmatch_route_case",
               "acl_port_buckets", "mixed_families", "_prefix_net",
               "_under", "_v4_form", "v6_many_masks", "acl_deep_buckets",
               "cut_table"):
        assert inspect.getsource(getattr(CS, fn)) == \
            inspect.getsource(getattr(TC, fn)), fn
    for k in ("CIDR_POOL", "V6_MASKS", "ACL_PORTS", "CUTS"):
        assert getattr(CS, k) == getattr(TC, k), k
    nets = TC.route_nets(400, 5)
    assert CS.route_nets(400, 5) == nets
    assert CS.cidr_queries(nets, 64, 6) == TC.cidr_queries(nets, 64, 6)
    acl = TC.acl_rules(200, 7)
    assert CS.acl_rules(200, 7) == acl
    assert CS.acl_queries(acl, 64, 8) == TC.acl_queries(acl, 64, 8)
    assert CS.hashmatch_route_case() == TC.hashmatch_route_case()
    assert CS.acl_port_buckets() == TC.acl_port_buckets()
    assert CS.mixed_families() == TC.mixed_families()
    assert CS.v6_many_masks() == TC.v6_many_masks()
    assert CS.acl_deep_buckets() == TC.acl_deep_buckets()
    ct = F.pack_cidr_table(H.compile_cidr_hash(nets).arrays)
    for how in TC.CUTS:
        a, b = CS.cut_table(ct, how), TC.cut_table(ct, how)
        assert sorted(a) == sorted(b) and all(
            np.array_equal(a[k], b[k]) for k in a)


def test_device_take_clamps_like_take_clip():
    tab = torch.from_numpy(M.build_table([("a", 1), ("b", 2)], 251))
    s = np.array([-5, 0, 17, 250, 251, 10_000], np.int64)
    ref = np.take(tab.numpy(), s, mode="clip")
    assert np.array_equal(M._device_take(tab, s).numpy(), ref)


# ------------------------------------------- the fused entry: no fallback


def _fused_inputs(device):
    rules = mk_rules(300)
    tab = H.compile_hint_hash(rules)
    q = H.encode_hint_queries(mk_queries(rules, 8), tab)
    ht = up(F.pack_hint_table(tab.arrays), "cpu")
    qd = up(q, "cpu")
    mtab = torch.from_numpy(M.build_table([("a", 1)], 251))
    slots = torch.zeros(8, dtype=torch.int64)
    if device != "cpu":
        ht = {k: v.to(device) for k, v in ht.items()}
        qd = {k: v.to(device) for k, v in qd.items()}
        mtab, slots = mtab.to(device), slots.to(device)
    return ht, qd, mtab, slots


def test_fused_entry_serves_cpu_tensors_with_plain_tier():
    ht, q, mtab, slots = _fused_inputs("cpu")
    n0 = FC.fused_classify_pick_cuda.launches
    out = FC.fused_classify_pick(ht, q, mtab, slots)
    assert torch.equal(out, F.fused_classify_pick(ht, q, mtab, slots))
    assert FC.fused_classify_pick_cuda.launches == n0  # no kernel launch


def test_fused_entry_raises_on_non_cpu_tensor(monkeypatch):
    """A tensor off the CPU goes to the kernel or raises — the plain
    tier is never substituted (meta tensors stand in for CUDA ones on
    this CPU-only build; the plain tier would accept them)."""
    called = []
    monkeypatch.setattr(F, "fused_classify_pick",
                        lambda *a: called.append(a))
    ht, q, mtab, slots = _fused_inputs("meta")
    n0 = FC.fused_classify_pick_cuda.launches
    with pytest.raises(FC.KernelError):
        FC.fused_classify_pick(ht, q, mtab, slots)
    assert not called and FC.fused_classify_pick_cuda.launches == n0


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(FC, "CUDA_DEFAULT", str(tmp_path / "cuda"))
    monkeypatch.setattr(FC, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(FC.KernelError, match="nvcc"):
        FC.build()
    assert not (tmp_path / "build").exists()


def test_kernel_abi_mirror_matches_source():
    """The ctypes FusedArgs mirror has the C struct's fields, in order,
    with the C types' sizes (the .cu compiles only on the GPU host)."""
    with open(FC.SOURCE) as f:
        src = f.read()
    body = re.search(r"struct FusedArgs \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    ptrs = re.findall(r"\*\s*(\w+);", body)
    ints = [x.strip() for decl in re.findall(r"int32_t ([\w ,]+);", body)
            for x in decl.split(",")]
    assert tuple(ptrs) == FC._PTRS
    assert tuple(ints) == FC._INTS
    assert ctypes.sizeof(FC._FusedArgs) == 8 * len(ptrs) + 4 * len(
        FC._INTS) + (4 if len(FC._INTS) % 2 else 0)


# --------------------------------------------- B3's entry (hint_match)

@pytest.mark.parametrize("name", CASES)
def test_hint_match_entry_vs_jax(name):
    """B3's entry on CPU tensors is the plain tier: (index, level) equal
    to hint_hash_jit, on every parity case (both _reduce_best branches,
    the uri-free tables, the boundary sets)."""
    rules, hints, tab, q = compile_case(name)
    ref_i, ref_l = RH.hint_hash_jit(tab.arrays, q)
    n0 = FC.hint_match_cuda.launches
    got_i, got_l = FC.hint_match(up(RF.pack_hint_table(tab.arrays), "cpu"),
                                 up(q, "cpu"))
    assert FC.hint_match_cuda.launches == n0  # no kernel launch
    assert got_i.dtype == got_l.dtype == torch.int32
    assert np.array_equal(np.asarray(ref_i), got_i.numpy())
    assert np.array_equal(np.asarray(ref_l), got_l.numpy())
    assert (got_l.numpy()[got_i.numpy() < 0] == 0).all()


@pytest.mark.parametrize("how", CS.HINT_CUTS)
@pytest.mark.parametrize("name", ["mk_rules_5k_b512", "wide_buckets"])
def test_hint_cut_tables_vs_jax(name, how):
    """chip_smoke.py holds B3's kernel on a cut table against the plain
    tiers on the same table grown back with its last entries
    (clamp_grown): that equals JAX's clamped gathers on the cut table,
    for the unpacked and the packed tier alike."""
    rules, hints, tab, q = compile_case(name)
    cut = CS.cut_hint_table(tab.arrays, how)
    ref_i, ref_l = RH.hint_hash_jit(cut, q)
    grown = CS.clamp_grown(cut, tab.arrays)
    got_i, got_l = H.hint_hash_match(up(grown, "cpu"), up(q, "cpu"))
    assert np.array_equal(np.asarray(ref_i), got_i.numpy())
    assert np.array_equal(np.asarray(ref_l), got_l.numpy())
    pk = RF.pack_hint_table(tab.arrays)
    pk_grown = CS.clamp_grown(CS.cut_hint_table(pk, how), pk)
    pi, pl = F._hint_verdict_packed(up(pk_grown, "cpu"), up(q, "cpu"))
    assert torch.equal(pi, got_i) and torch.equal(pl, got_l)
    full_i, _ = RH.hint_hash_jit(tab.arrays, q)
    assert not np.array_equal(np.asarray(full_i), got_i.numpy())


def test_hint_match_entry_raises_on_non_cpu_tensor(monkeypatch):
    """A tensor off the CPU goes to the kernel or raises: the plain tier
    is never substituted (meta tensors stand in for CUDA ones)."""
    called = []
    monkeypatch.setattr(F, "_hint_verdict_packed",
                        lambda *a: called.append(a))
    ht, q, _, _ = _fused_inputs("meta")
    n0 = FC.hint_match_cuda.launches
    with pytest.raises(FC.KernelError):
        FC.hint_match(ht, q)
    assert not called and FC.hint_match_cuda.launches == n0


@pytest.mark.parametrize("fault", ["bad_batch", "no_card_memory"])
@pytest.mark.parametrize("entry", ["hint_match_cuda",
                                   "fused_classify_pick_cuda"])
def test_kernel_wrapper_fault_on_card_is_kernel_error(monkeypatch, entry,
                                                      fault):
    """Whatever keeps a kernel wrapper from serving tensors off the CPU
    raises KernelError, which no serving layer fails over to the host: a
    query batch the table cannot take (a ValueError inside) and the
    card out of memory for the output (torch's OutOfMemoryError). Meta
    tensors stand in for CUDA ones, the library stands in as built; no
    launch is counted."""
    monkeypatch.setattr(FC, "_lib", lambda: None)
    ht, q, mtab, slots = _fused_inputs("meta")
    if fault == "bad_batch":
        q["hostb"] = q["hostb"][:, :-1].contiguous()
        cause = ValueError
    else:
        def no_card_memory(*a, **kw):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        monkeypatch.setattr(torch, "empty", no_card_memory)
        cause = torch.cuda.OutOfMemoryError
    fn = getattr(FC, entry)
    args = (ht, q) if entry == "hint_match_cuda" else (ht, q, mtab, slots)
    n0 = fn.launches
    with pytest.raises(FC.KernelError) as err:
        fn(*args)
    assert isinstance(err.value.__cause__, cause)
    assert fn.launches == n0


def test_hint_matcher_cpu_dispatch_keeps_torch_tier(monkeypatch):
    """On the CPU, HintMatcher.dispatch_snap answers with
    hashmatch.hint_hash_match and never reaches B3's entry."""
    from vproxy_tpu_torch.rules import engine as E
    monkeypatch.setattr(FC, "hint_match", lambda *a: 1 / 0)
    rules = mk_rules(300)
    m = E.HintMatcher(rules, backend="torch", device="cpu")
    hints = mk_queries(rules, 40)
    got = E.to_host(m.dispatch_snap(m.snapshot(), hints, pad_to=64))
    want = [m.index_snap(m.snapshot(), h) for h in hints]
    assert got[:40].tolist() == want and (got[40:] == -1).all()


@pytest.mark.parametrize("fault", ["encode", "launch"])
def test_hint_matcher_card_dispatch_raises_kernel_error(monkeypatch, fault):
    """Off the CPU (meta tensors stand in for CUDA ones, the library
    stands in as built), HintMatcher.dispatch_snap launches B3 or raises
    KernelError: a batch that fails to encode or upload, and a launch
    that fails, alike; the torch tier is never called."""
    from vproxy_tpu_torch.rules import engine as E
    monkeypatch.setattr(FC, "_lib", lambda: None)
    rules = mk_rules(300)
    m = E.HintMatcher(rules, backend="torch", device="meta")
    monkeypatch.setattr(H, "hint_hash_match", lambda *a: 1 / 0)
    if fault == "encode":
        def bad_encode(*a):
            raise ValueError("host window too narrow")
        monkeypatch.setattr(E, "_fused_hint_q", bad_encode)
    n0 = FC.hint_match_cuda.launches
    with pytest.raises(FC.KernelError):
        m.dispatch_snap(m.snapshot(), mk_queries(rules, 8), pad_to=8)
    assert FC.hint_match_cuda.launches == n0
