"""Torch port on the card: the CIDR kernels, B3, the fingerprint
kernels (B6, B7), the dense kernels (B9) and the Maglev take (B5)
against their plain tiers, and the control plane's DNS server and
Socks5 answered through B3 and B4.

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
    B9 (one launch a batch) what the host index answers; a cpick is B9
    plus one B5 launch; classify_dense is one hint and two cidr
    launches, equal to classify_all."""
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
            TC.maglev_take_cuda.launches - n0[2]) == (2, 1, 1)
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
