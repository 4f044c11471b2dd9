"""Torch port on the card: the CIDR kernels, B3, the fingerprint
kernels (B6, B7), the dense kernels (B9), the Maglev take (B5) and the
sharded winner reduction (B8) against their plain tiers, the Maglev
column of B6, B8 and B9 (B5's take folded in: a classify+pick batch is
one launch), B9 on a table past 2^20 rules, and the control plane's DNS
server and Socks5 answered through B3 and B4.

Every test here is marked `cuda` and asks the `cuda` fixture for the
card, which skips without one (the CPU tier-1 run skips them all). On a
machine with an H100:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports nothing of JAX (its cases come from chip_smoke.py's
copies of the CPU parity generators), so it runs where JAX is not
installed. chip_smoke.py holds the same kernels at full size.
"""
import pytest
import torch

import chip_smoke as CS
from vproxy_tpu_torch.ops import cidr_cuda as CC
from vproxy_tpu_torch.ops import fused as F
from vproxy_tpu_torch.ops import fused_cuda as FC

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_cidr_kernel_matches_plain_tier(cuda):
    """B4 == _cidr_first_packed, int32, on the CPU parity sets (pad rows
    included) and on the clamp cuts."""
    for name, nets, acl, q in CS.small_cidr_cases():
        ct = CS.packed_cidr(nets, acl, cuda)
        tables = [(name, ct)]
        if name in CS.CUT_CASES:
            tables += [(f"{name} cut {h}",
                        CC.prepare_table(CS.cut_table(dict(ct), h)))
                       for h in CS.CUTS]
        a16, fam, port = CS.cidr_batch(q, len(q) + 8, cuda)
        for n, t in tables:
            got = CC.cidr_first_cuda(t, a16, fam, port)
            assert torch.equal(got, F._cidr_first_packed(t, a16, fam, port)), n


@pytest.mark.parametrize("b", [16, 512])
def test_route_column_matches_plain_tier(cuda, b):
    """B1's [B, 3] form == the 3-column plain tier, and its first two
    columns == the [B, 2] launch."""
    _route_column_case(cuda, b, CS.route_nets(2000, 5))


def test_route_column_past_one_probe_round(cuda):
    """The same on v6_many_masks, whose 16-byte queries take the route
    blocks' probe loop past one round."""
    _route_column_case(cuda, 512, CS.v6_many_masks()[0])


def _route_column_case(cuda, b, nets):
    rules = CS.mk_rules(3000)
    tab, ht, mtab = CS.packed_case(rules, cuda)
    ct = CS.packed_cidr(nets, None, cuda)
    q, slots = CS.encode(tab, CS.mk_queries(rules, b, 9), cuda)
    a16, fam, _ = CS.cidr_batch(
        [(a, None) for a, _ in CS.cidr_queries(nets, b - b // 8, 10)], b,
        cuda)
    got = FC.fused_classify_pick_cuda(ht, q, mtab, slots, ct, a16, fam)
    assert torch.equal(got, F.fused_classify_pick(ht, q, mtab, slots, ct,
                                                  a16, fam))
    assert torch.equal(FC.fused_classify_pick_cuda(ht, q, mtab, slots),
                       got[:, :2])


def test_cidr_matcher_serves_from_the_kernel(cuda):
    """A CidrMatcher on the card answers batches with one B4 launch
    each, equal to its host index."""
    from vproxy_tpu_torch.rules import engine as E
    acl = CS.acl_rules(500, 7)
    m = E.CidrMatcher([r.network for r in acl], acl=acl, device=cuda)
    assert isinstance(m.snapshot()[6], CC.PackedCidrTable)
    q = CS.acl_queries(acl, 300, 8)
    n0 = CC.cidr_first_cuda.launches
    got = m.match([a for a, _ in q], [p for _, p in q])
    assert CC.cidr_first_cuda.launches == n0 + 1
    snap = m.snapshot()
    assert list(got) == [m.index_snap(snap, a, p) for a, p in q]


@pytest.mark.parametrize("name", ["random_300_b600", "wide_buckets",
                                  "boundary", "boundary_w16_hosts"])
def test_hint_kernel_matches_plain_tiers(cuda, name):
    """B3 (B1's verdict-only mode) == hashmatch.hint_hash_match and
    fused._hint_verdict_packed, index and level, pad rows included, and
    on the clamp cuts of wide_buckets."""
    from vproxy_tpu_torch.ops import hashmatch as H
    from vproxy_tpu_torch.utils.torchenv import tables_from_reference
    if name == "random_300_b600":
        rules = CS.rand_rules(300, 11)
        hints, caps = CS.rand_hints(rules, 600, 11), None
    elif name == "wide_buckets":
        rules, hints = CS.wide_buckets()
        caps = None
    else:
        rules, hints, caps = CS.boundary(name)
    tab, ht, _ = CS.packed_case(rules, cuda, caps)
    q = CS.encode_padded(tab, hints, len(hints) + 8, cuda)
    unpacked = tables_from_reference(tab.arrays, cuda)
    assert CS.b3_vs_plain(name, tab, ht, q, cuda, unpacked) == 0
    if name == "wide_buckets":
        for how in CS.HINT_CUTS:
            cut = CS.cut_hint_table(dict(ht), how)
            assert CS.b3_vs_plain(
                f"{name} cut {how}", tab, FC.prepare_table(cut), q, cuda,
                CS.clamp_grown(CS.cut_hint_table(unpacked, how), unpacked),
                CS.clamp_grown(cut, ht)) == 0


def test_hint_matcher_serves_from_the_kernel(cuda):
    """A HintMatcher on the card answers a batch with one B3 launch,
    equal to its host index, and never calls the torch tier."""
    from vproxy_tpu_torch.ops import hashmatch as H
    from vproxy_tpu_torch.rules import engine as E
    rules = CS.mk_rules(3000)
    m = E.HintMatcher(rules, backend="torch", device=cuda)
    hints = CS.mk_queries(rules, 200, 5)
    n0, c0 = FC.hint_match_cuda.launches, H.hint_hash_match.cuda_calls
    got = E.to_host(m.dispatch_snap(m.snapshot(), hints, pad_to=256))
    assert FC.hint_match_cuda.launches == n0 + 1
    assert H.hint_hash_match.cuda_calls == c0
    snap = m.snapshot()
    assert got[:200].tolist() == [m.index_snap(snap, h) for h in hints]
    assert (got[200:] == -1).all()



@pytest.mark.parametrize("entry", ["hint_match_cuda",
                                   "fused_classify_pick_cuda"])
def test_kernel_wrapper_bad_batch_is_kernel_error(cuda, entry):
    """A CUDA query batch the table cannot take (a host window narrower
    than the table's) raises KernelError, never a ValueError a serving
    layer could fail over to the host, and launches nothing."""
    rules = CS.mk_rules(300)
    tab, ht, mtab = CS.packed_case(rules, cuda)
    q = CS.encode_padded(tab, CS.mk_queries(rules, 8, 5), 8, cuda)
    q["hostb"] = q["hostb"][:, :-1].contiguous()
    fn = getattr(FC, entry)
    args = (ht, q) if entry == "hint_match_cuda" else (
        ht, q, mtab, torch.zeros(8, dtype=torch.int64, device=cuda))
    n0 = fn.launches
    with pytest.raises(FC.KernelError) as err:
        fn(*args)
    assert isinstance(err.value.__cause__, ValueError)
    assert fn.launches == n0


# ---------------------------------------------- the fingerprint kernels

def test_fp_hint_kernel_matches_plain_tier(cuda):
    """B6 == fphash.hint_fp_match, int32 in index and level, on the
    fingerprint parity sets (8 pad rows each), um_* batches and
    untrimmed ones both, each also on its slot table cut short, and on
    the batches cut where a member's index into them is clamped."""
    from vproxy_tpu_torch.ops import fphash as FP
    seen = set()
    for name, rules, hints in CS.fp_hint_cases():
        tab = FP.compile_hint_fp(rules)
        q = CS.fp_hint_batch(tab, hints, len(hints) + 8, cuda)
        seen.add("um_fp1" in q)
        t = CS.fp_prepared(tab.arrays, cuda, True)
        assert CS.b6_vs_plain(name, t, q, cuda) == 0, name
        assert CS.b6_vs_plain(name, CS.fp_prepared(CS.fp_table_variant(
            tab.arrays, "rec"), cuda, True), q, cuda) == 0, name
        for how in CS.FP_QUERY_CUTS.get(name, ()):
            assert CS.b6_vs_plain(name, t, CS.cut_fp_query(q, how),
                                  cuda) == 0, (name, how)
    assert seen == {True, False}


def test_fp_cidr_kernel_matches_plain_tier(cuda):
    """B7 == fphash.cidr_fp_match on every layout (trie or groups, route
    or ACL, with ports and without), pad rows included, and on the table
    variants (cut where the reference clamps, rows twice as wide)."""
    from vproxy_tpu_torch.ops import fphash as FP
    for name, nets, acl, q, caps in CS.fp_cidr_cases():
        arrays = FP.compile_cidr_fp(nets, acl=acl, caps=caps).arrays
        batch = CS.cidr_batch(q, len(q) + 8, cuda)
        for how in (None, *CS.FP_VARIANTS.get(name, ())):
            t = CS.fp_prepared(arrays if how is None else
                               CS.fp_table_variant(arrays, how), cuda, False)
            assert CS.b7_vs_plain(name, t, *batch, cuda) == 0, (name, how)


def test_fp_matchers_serve_from_the_kernels(cuda):
    """torch-fp matchers on the card answer through B6 and B7 (one
    launch a batch) what the host index answers, and classify_fp_all
    is one B6 and two B7 launches."""
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    tabs = CS.fp_tables(cuda, n_rules=3000, n_routes=2000, n_acl=500)
    hm, routes, am = tabs["hm"], tabs["routes"], tabs["am"]
    hints = CS.mk_queries(tabs["rules"], 200)
    n0 = (FPC.hint_fp_cuda.launches, FPC.cidr_fp_cuda.launches)
    got = hm.match(hints)
    assert list(got) == [hm.index_snap(hm.snapshot(), h) for h in hints]
    addrs = [a for a, _ in CS.cidr_queries(tabs["nets"], 200, 3)]
    got = routes.match(addrs)
    assert list(got) == [routes.index_snap(routes.snapshot(), a)
                         for a in addrs]
    assert (FPC.hint_fp_cuda.launches - n0[0],
            FPC.cidr_fp_cuda.launches - n0[1]) == (1, 1)
    snap = hm.snapshot()
    q = CS.fp_hint_batch(snap[0], hints, 256, cuda)
    a16, fam, port = CS.cidr_batch(CS.acl_queries(tabs["acl"], 200, 4), 256,
                                   cuda)
    rt, at = routes.snapshot()[0], am.snapshot()[0]
    from vproxy_tpu_torch.ops import fphash as FP
    got = FPC.classify_fp_all(snap[1], rt, at, q, a16, fam, port)
    assert torch.equal(got, FP.classify_fp_all(snap[1], rt, at, q, a16,
                                               fam, port))
    assert (FPC.hint_fp_cuda.launches - n0[0],
            FPC.cidr_fp_cuda.launches - n0[1]) == (2, 3)


@pytest.mark.parametrize("entry", ["hint", "cidr"])
def test_fp_kernel_bad_batch_is_kernel_error(cuda, entry):
    from vproxy_tpu_torch.ops import fphash as FP
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    rules, hints = CS.fp_member_overflow()
    tab = FP.compile_hint_fp(rules)
    if entry == "hint":
        q = CS.fp_hint_batch(tab, hints, 8, cuda)
        q["hlen"] = q["hlen"][:4]
        with pytest.raises(FC.KernelError):
            FPC.hint_fp_cuda(CS.fp_prepared(tab.arrays, cuda, True), q)
    else:
        nets, addrs = CS.fp_trie_first_match()
        t = CS.fp_prepared(FP.compile_cidr_fp(nets).arrays, cuda, False)
        a16, fam, _ = CS.cidr_batch([(a, None) for a in addrs], 8, cuda)
        with pytest.raises(FC.KernelError):
            FPC.cidr_fp_cuda(t, a16, fam[:4])


# --------------------------------- the dense kernels (B9) and B5

def test_dense_hint_kernel_matches_plain_tier(cuda):
    """B9 hint == matchers.hint_match_chunked, int32 in index and level,
    on the dense parity sets (8 pad rows each): a cross-chunk tie, the
    max-length host suffix and over-long host query, the boundary
    sets."""
    from vproxy_tpu_torch.ops import matchers as MT
    from vproxy_tpu_torch.ops import tables as T
    for name, rules, hints in CS.dense_hint_cases():
        t = CS.dense_prepared(MT.table_arrays(T.compile_hint_rules(rules)),
                              cuda, True)
        q = CS.dense_hint_batch(hints, len(hints) + 8, cuda)
        assert CS.b9_vs_plain(name, t, q, cuda) == 0, name


def test_dense_cidr_kernel_matches_plain_tier(cuda):
    """B9 cidr == matchers.cidr_first_match_chunked on the CPU parity
    sets (routes, ACL with ports and without, mixed families, v4-mapped
    v6), pad rows included."""
    from vproxy_tpu_torch.ops import matchers as MT
    from vproxy_tpu_torch.ops import tables as T
    for name, nets, acl, q in CS.dense_cidr_cases():
        t = CS.dense_prepared(MT.table_arrays(T.compile_cidr_rules(
            nets, acl=acl)), cuda, False)
        batch = CS.cidr_batch(q, len(q) + 8, cuda)
        assert CS.b9_vs_plain(name, t, None, cuda, *batch) == 0, name


def test_dense_matchers_serve_from_the_kernels(cuda):
    """VPROXY_TPU_MATCHER=jax-dense matchers on the card answer through
    B9 (one launch a batch) what the host index answers; a cpick is one
    B9 launch with its Maglev column and no B5 launch; classify_dense is
    one hint and two cidr launches, equal to classify_all."""
    from vproxy_tpu_torch.ops import dense_cuda as DC
    from vproxy_tpu_torch.ops import matchers as MT
    from vproxy_tpu_torch.ops import take_cuda as TC
    from vproxy_tpu_torch.rules import maglev as M
    tabs = CS.dense_tables(cuda, n_rules=3000, n_routes=2000, n_acl=500)
    hm, routes, am = tabs["hm"], tabs["routes"], tabs["am"]
    hints = CS.mk_queries(tabs["rules"], 200)
    n0 = (DC.hint_dense_cuda.launches, DC.cidr_dense_cuda.launches,
          TC.maglev_take_cuda.launches)
    assert list(hm.match(hints)) == [hm.index_snap(hm.snapshot(), h)
                                     for h in hints]
    addrs = [a for a, _ in CS.cidr_queries(tabs["nets"], 200, 3)]
    assert list(routes.match(addrs)) == [
        routes.index_snap(routes.snapshot(), a) for a in addrs]
    ips = CS.mk_ips(200)
    v, p, _, _ = M.classify_and_pick(hm, tabs["mm"], hints, ips)
    assert list(v) == [hm.index_snap(hm.snapshot(), h) for h in hints]
    assert list(p) == [M.pick(tabs["mm"].snapshot()[0], ip) for ip in ips]
    assert (DC.hint_dense_cuda.launches - n0[0],
            DC.cidr_dense_cuda.launches - n0[1],
            TC.maglev_take_cuda.launches - n0[2]) == (2, 1, 0)
    q = CS.dense_hint_batch(hints, 256, cuda)
    aq = dict(zip(("addr", "family", "port"), CS.cidr_batch(
        CS.acl_queries(tabs["acl"], 200, 4), 256, cuda)))
    rq = {"addr": aq["addr"], "family": aq["family"]}
    ht, rt, at = hm.snapshot()[1], routes.snapshot()[0], am.snapshot()[0]
    got = MT.classify_dense(ht, rt, at, q, rq, aq)
    for g, w in zip(got, MT.classify_all(ht, rt, at, q, rq, aq)):
        assert torch.equal(g, w)
    assert (DC.hint_dense_cuda.launches - n0[0],
            DC.cidr_dense_cuda.launches - n0[1]) == (3, 3)


@pytest.mark.parametrize("b", [16, 512, 4096])
def test_maglev_take_kernel_matches_plain_and_pick(cuda, b):
    """B5 == torch indexing and maglev.pick, slots past both ends
    clipped."""
    from vproxy_tpu_torch.rules import maglev as M
    mm = M.MaglevMatcher(CS.backends(), m=CS.MAGLEV_M, device=cuda)
    assert CS.b5_vs_plain(mm, b, cuda) == 0


@pytest.mark.parametrize("entry", ["hint", "cidr", "take"])
def test_dense_and_take_bad_batch_is_kernel_error(cuda, entry):
    from vproxy_tpu_torch.ops import dense_cuda as DC
    from vproxy_tpu_torch.ops import matchers as MT
    from vproxy_tpu_torch.ops import tables as T
    from vproxy_tpu_torch.ops import take_cuda as TC
    if entry == "hint":
        rules, hints = CS.dense_max_host_suffix()
        t = CS.dense_prepared(MT.table_arrays(T.compile_hint_rules(rules)),
                              cuda, True)
        q = CS.dense_hint_batch(hints, 8, cuda)
        q["port"] = q["port"][:4]
        with pytest.raises(FC.KernelError):
            DC.hint_dense_cuda(t, q)
    elif entry == "cidr":
        nets, addrs = CS.dense_v4_mapped()
        t = CS.dense_prepared(MT.table_arrays(T.compile_cidr_rules(nets)),
                              cuda, False)
        a16, fam, _ = CS.cidr_batch([(a, None) for a in addrs], 16, cuda)
        with pytest.raises(FC.KernelError):
            DC.cidr_dense_cuda(t, a16, fam[:4])
    else:
        with pytest.raises(FC.KernelError):
            TC.maglev_take_cuda(torch.zeros(0, dtype=torch.int32,
                                            device=cuda),
                                torch.zeros(4, dtype=torch.int64,
                                            device=cuda))


def test_dns_and_socks5_answered_by_b3_gated_by_b4(cuda, monkeypatch,
                                                   tmp_path):
    """The port's control plane on the card: an operator config built by
    command (an Upstream with one Host rule, a security group with TCP
    and UDP rules, a dns-server and a socks5-server on them), the
    service in "device" mode. One DNS query is gated by B4 (the UDP
    ACL) and answered by B3 (the rrsets lookup); one Socks5 CONNECT by
    domain is gated by B4 (the TCP ACL) and routed by B3 to the group's
    backend. B1's cpick form never runs."""
    import socket
    import threading

    from vproxy_tpu_torch.control.app import Application
    from vproxy_tpu_torch.control.command import Command
    from vproxy_tpu_torch.dns import packet as P
    from vproxy_tpu_torch.rules.service import ClassifyService

    monkeypatch.setenv("VPROXY_TPU_CLASSIFY", "device")
    monkeypatch.setenv("VPROXY_TPU_HOME", str(tmp_path))
    ClassifyService.reset()
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)

    def serve():
        try:
            c, _ = srv.accept()
            c.sendall(b"S5B")
            c.close()
        except OSError:
            pass
    threading.Thread(target=serve, daemon=True).start()
    app = Application.create(workers=1)
    try:
        for line in (
                "add upstream u0",
                "add server-group g0 timeout 500 period 60000 up 1 down 1 "
                "protocol none",
                f"add server s0 to server-group g0 address "
                f"127.0.0.1:{srv.getsockname()[1]}",
                'add server-group g0 to upstream u0 annotations '
                '{"vproxy/hint-host":"svc.example.com"}',
                "add security-group acl default allow",
                "add security-group-rule t0 to security-group acl network "
                "10.0.0.0/8 protocol tcp port-range 0,65535 default deny",
                "add security-group-rule u0 to security-group acl network "
                "10.0.0.0/8 protocol udp port-range 0,65535 default deny",
                "add dns-server d0 address 127.0.0.1:0 upstream u0 "
                "security-group acl",
                "add socks5-server s5 address 127.0.0.1:0 upstream u0 "
                "security-group acl"):
            assert Command.execute(app, line) == "OK", line
        assert "backend torch " in Command.execute(
            app, "list-detail upstream")[0]
        counts = (FC.hint_match_cuda, CC.cidr_first_cuda,
                  FC.fused_classify_pick_cuda)
        for k in counts:
            k.launches = 0
        u = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        u.settimeout(10)
        u.sendto(P.Packet(id=5, rd=True, questions=[
            P.Question("svc.example.com.", P.A)]).encode(),
            ("127.0.0.1", app.dns_servers["d0"].bind_port))
        resp = P.parse(u.recvfrom(4096)[0])
        u.close()
        assert resp.id == 5 and [a.rdata for a in resp.answers] == \
            [bytes([127, 0, 0, 1])]
        assert [k.launches for k in counts] == [1, 1, 0]
        c = socket.create_connection(
            ("127.0.0.1", app.socks5_servers["s5"].bind_port), timeout=10)
        c.sendall(b"\x05\x01\x00")
        assert c.recv(2) == b"\x05\x00"
        c.sendall(b"\x05\x01\x00\x03\x0fsvc.example.com\x00\x50")
        rep = c.recv(10)
        assert rep[:2] == b"\x05\x00"
        assert c.recv(10) == b"S5B"
        c.close()
        assert [k.launches for k in counts] == [2, 2, 0]
        svc = ClassifyService.get()
        assert svc.stats.failovers == 0 and svc.error is None
    finally:
        app.close()
        srv.close()
        ClassifyService.reset()


# --------------------------------------------- B8: the sharded backends

_SHARDED = {}


def _sharded_tabs(cuda):
    """Small sharded tables at S = 1..4 (3000 hint rules, 2000 routes,
    500 ACL rules: compiled in spawned workers as chip_smoke.py does),
    built once for the module."""
    if "tabs" not in _SHARDED:
        pool, futs = CS.sharded_start(3000, 2000, 500, shards=(4, 3, 2, 1),
                                      workers=2)
        _SHARDED["tabs"] = CS.sharded_tables(cuda, pool, futs, 3000, 2000,
                                             500)
    return _SHARDED["tabs"]


def test_sharded_kernel_matches_plain_and_index(cuda):
    """B8 == its plain version == the host index, int32, at S = 1..4 on
    the cuckoo and fingerprint tables (hint, routes, ACL with ports),
    one launch a batch, an eighth of each batch pad rows."""
    out = CS.phase_sharded_kernels(cuda, _sharded_tabs(cuda),
                                   buckets=(16, 64, 512), timed=False)
    assert out["max_abs_err"] == 0 and out["checks"] == 4 * 6 * 3


@pytest.mark.parametrize("layout", ["split", "interleaved"])
@pytest.mark.parametrize("s", [4, 3, 1])
def test_sharded_layouts_on_the_card(cuda, s, layout):
    """B8 forced into each layout (csrc/sharded_match.cu `Layout`) on
    every kind and column at S shards: int32-equal to the plain version
    and to the host index at B = 16, 512 and 4096 (an eighth of each
    batch pad rows)."""
    tabs = _sharded_tabs(cuda)
    for kind, s_, part in CS.b8_cases(tabs):
        if s_ != s:
            continue
        for b in (16, 512, 4096):
            kern, plain, host, _, name = CS.b8_case(
                tabs, kind, s, b, 3000 + b, part, layout=layout)
            got = kern()
            assert torch.equal(got, plain()), f"{name} B={b}"
            assert got.tolist() == host + [-1] * (b - len(host)), name


def test_sharded_keys_then_finish_pass(cuda):
    """The cross-rank form: B8 writing keys only, then the finish pass,
    answers what the one-launch form answers."""
    from vproxy_tpu_torch.ops import sharded_cuda as SC
    tabs = _sharded_tabs(cuda)
    for kind, part in (("hint", None), ("fp_hint", None), ("cidr", "acl"),
                       ("fp_cidr", "routes")):
        name = f"{kind} {part}"
        t = tabs[(kind, 3)]
        n0 = SC.finish_cuda.launches
        if part is None:
            q = CS.sharded_hint_batch(t["hint"]["stab"],
                                      CS.mk_queries(tabs["rules"], 400, 17),
                                      512, t["mesh"], kind == "fp_hint")
            keys = SC.sharded_cuda((t["hint"]["kern"], q, t["hint"]["size"]),
                                   finish=False)
            want = SC.hint_sharded(t["hint"]["kern"], q, t["hint"]["size"])
        else:
            tt = t[part]
            qs = CS.acl_queries(tabs["acl"], 400, 17) if part == "acl" else \
                [(a, None) for a, _ in CS.cidr_queries(tabs["nets"], 400, 17)]
            a16, fam, port = CS.cidr_batch(qs, 512, cuda)
            col = [(tt["kern"], a16, fam, port, tt["size"])]
            keys = SC.sharded_cuda(cidr=col, finish=False)
            want = SC.cidr_sharded(tt["kern"], a16, fam, port, tt["size"])
        assert keys.dtype == torch.int64 and keys.shape == (512, 1), name
        assert torch.equal(SC.finish_cuda(keys)[:, 0], want), name
        assert torch.equal(SC.finish_plain(keys)[:, 0], want), name
        assert SC.finish_cuda.launches == n0 + 1


@pytest.mark.parametrize("s", [1, 2, 3, 4])
@pytest.mark.parametrize("backend", ["torch-sharded", "torch-fp-sharded"])
def test_sharded_tie_case_on_the_card(cuda, s, backend):
    """The brute-force case: ties across shards, level-0 shards, a rule
    count no S divides; every answer the linear oracle's."""
    from vproxy_tpu_torch.ops import sharded_cuda as SC
    from vproxy_tpu_torch.parallel import mesh as M
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules import oracle
    rules, hints = CS.sharded_tie_case()
    m = E.HintMatcher(rules, backend=backend,
                      mesh=M.make_mesh(2 * s, batch=2, device=cuda))
    n0 = SC.sharded_cuda.launches
    got = m.match(hints)
    assert SC.sharded_cuda.launches == n0 + 1
    assert list(got) == [oracle.search(rules, h) for h in hints]


def test_sharded_service_on_the_card(cuda):
    """ClassifyService in "device" mode over both sharded backends at
    S = 4: one B8 launch a hint, cpick (with its Maglev column) or cidr
    batch, no B5 launch, every answer the host index's, checksums the
    unsharded matcher's."""
    out = CS.phase_sharded_service(
        cuda, CS.sharded_service_tables(cuda, _sharded_tabs(cuda)), bursts=1,
        burst=128)
    assert set(out) == {"torch-sharded", "torch-fp-sharded"}


@pytest.mark.parametrize("s", [4, 3, 1])
def test_sharded_classify_three_columns_on_the_card(cuda, s):
    """The classify form: hint, routes and ACL answered by ONE launch of
    B8 (three columns) == each column's plain version, int32 [B, 3],
    and the same keys without the output, then the finish pass."""
    from vproxy_tpu_torch.ops import sharded_cuda as SC
    tabs = _sharded_tabs(cuda)
    ht, ct = tabs[("hint", s)], tabs[("cidr", s)]
    h, r, a = ht["hint"], ct["routes"], ct["acl"]
    q = CS.sharded_hint_batch(h["stab"], CS.mk_queries(tabs["rules"], 180, 5),
                              200, ht["mesh"], False)
    a16, fam, port = CS.cidr_batch(CS.acl_queries(tabs["acl"], 180, 6), 200,
                                   cuda)
    sizes = (h["size"], r["size"], a["size"])
    want = SC.finish_plain(torch.stack([
        SC.hint_keys_plain(h["raw"], q, sizes[0]),
        SC.cidr_keys_plain(r["raw"], a16, fam, None, sizes[1]),
        SC.cidr_keys_plain(a["raw"], a16, fam, port, sizes[2])], dim=1))
    n0 = SC.sharded_cuda.launches
    got = SC.classify_sharded(h["kern"], r["kern"], a["kern"], q, a16, fam,
                              port, sizes)
    assert SC.sharded_cuda.launches == n0 + 1
    assert got.shape == (200, 3) and torch.equal(got, want)
    assert int((want >= 0).sum()) > 200
    cols = [(r["kern"], a16, fam, None, sizes[1]),
            (a["kern"], a16, fam, port, sizes[2])]
    keys = SC.sharded_cuda((h["kern"], q, sizes[0]), cols, finish=False)
    assert torch.equal(SC.finish_cuda(keys), want)


def test_sharded_kernel_refuses_unprepared_tables(cuda):
    """A raw (unprepared) stack or a short batch is a KernelError."""
    from vproxy_tpu_torch.ops import sharded_cuda as SC
    tabs = _sharded_tabs(cuda)
    t = tabs[("cidr", 2)]["routes"]
    a16, fam, _ = CS.cidr_batch(
        [(a, None) for a, _ in CS.cidr_queries(tabs["nets"], 8, 3)], 16,
        cuda)
    with pytest.raises(FC.KernelError):
        SC.sharded_cuda(cidr=[(dict(t["raw"]), a16, fam, None, t["size"])])
    with pytest.raises(FC.KernelError):
        SC.sharded_cuda(cidr=[(t["kern"], a16, fam[:4], None, t["size"])])


# ------------------ the Maglev column of B6, B8 and B9 (B5 folded in)

def test_folded_pick_kernels_match_plain(cuda):
    """B6 and B9's hint with their Maglev column == their plain versions
    (int32 [B, 2]: the verdict-only launch's answers, the host table's
    picks clipped) at B = 16 / 512 / 4096, an eighth of each batch pad
    rows and slots past both ends of the table; one launch each."""
    from vproxy_tpu_torch.ops import dense_cuda as DC
    from vproxy_tpu_torch.ops import fphash_cuda as FPC
    fp = CS.fp_tables(cuda, n_rules=3000, n_routes=2000, n_acl=500)
    dense = CS.dense_tables(cuda, n_rules=3000, n_routes=2000, n_acl=500)
    fsnap, dsnap = fp["hm"].snapshot(), dense["hm"].snapshot()
    for b in (16, 512, 4096):
        hints = CS.mk_queries(fp["rules"], b - b // 8, seed=70 + b)
        mcol = CS.maglev_column(b, cuda, 80 + b, b // 8)
        n0 = FPC.hint_fp_cuda.pick_launches
        assert CS.b6_vs_plain(f"B={b}", fsnap[1], CS.fp_hint_batch(
            fsnap[0], hints, b, cuda), cuda, mcol) == 0
        assert FPC.hint_fp_cuda.pick_launches == n0 + 1
        n0 = DC.hint_dense_cuda.pick_launches
        assert CS.b9_vs_plain(f"B={b}", dsnap[1], CS.dense_hint_batch(
            hints, b, cuda), cuda, mcol=mcol) == 0
        assert DC.hint_dense_cuda.pick_launches == n0 + 1


def test_dense_wide_table_on_the_card(cuda):
    """A table whose live rules lie past index 2^20 publishes on
    "torch-dense" with the 64-bit key's layout, and B9 answers it as its
    plain version and the host index, with and without its Maglev
    column."""
    out = CS.dense_wide_check(cuda, b=512)
    assert out["wide"] and out["max_abs_err"] == 0
    assert out["answers_past_2_20"] > 0


def test_sharded_pick_matches_plain(cuda):
    """B8 with its Maglev column == its plain version (verdicts the host
    index's, picks the host table's clipped) on the cuckoo and
    fingerprint hint tables at S = 4, 3 and 1, B = 16 / 512 / 4096: the
    launcher's layout, each forced layout, and the keys path with its
    finish pass writing into the picks' rows."""
    tabs = _sharded_tabs(cuda)
    n = 0
    for kind in ("hint", "fp_hint"):
        for s in (4, 3, 1):
            for b in (16, 512, 4096):
                n += CS.b8_pick_case(tabs, kind, s, b, 3300 + b, cuda)
    assert n == 2 * 3 * 3 * 4


def test_cpick_batches_on_the_card(cuda):
    """FusedPair.dispatch_snap on "torch-fp", "torch-dense" and both
    sharded backends: one engine launch a classify+pick batch, equal to
    the two-dispatch chain and to the host; in the profiler's window a
    batch makes no B5 launch where the chain makes one, and one
    device-to-host copy fewer (one pull)."""
    from vproxy_tpu_torch.parallel import mesh as PM
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules import maglev as M
    fp = CS.fp_tables(cuda, n_rules=3000, n_routes=2000, n_acl=500)
    dense = CS.dense_tables(cuda, n_rules=3000, n_routes=2000, n_acl=500)
    pairs = {"torch-fp": (fp["pair"], fp["rules"]),
             "torch-dense": (dense["pair"], dense["rules"])}
    for be in ("torch-sharded", "torch-fp-sharded"):
        hm = E.HintMatcher(fp["rules"], backend=be,
                           mesh=PM.make_mesh(8, batch=2, device=cuda))
        pairs[be] = (M.FusedPair(hm, fp["pair"].mm), fp["rules"])
    rows = CS.phase_cpick(cuda, pairs, b=512, calls=5)
    for r in rows:
        take = [any(CS.KERNEL_B5 in n for n in r[k]["names"])
                for k in ("one", "chain")]
        assert take == [False, True], r
        assert r["chain"]["kernels"] >= r["one"]["kernels"] + 1, r
        assert r["chain"]["d2h"] == r["one"]["d2h"] + 1, r
