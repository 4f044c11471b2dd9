"""Torch port, serving path: engine, Maglev and ClassifyService.

The same rules, backends and queries go through vproxy_tpu's engine on
the JAX CPU backend and through the port on torch's CPU
(VPROXY_TPU_TORCH_DEVICE=cpu); verdicts and picks must be identical,
batch by batch and answer by answer: classify_and_pick, FusedPair, the
unfused hint dispatch, ClassifyService hint and classify+pick batches,
its inline lone-query lane, and device-fault failover through the
existing `device.dispatch.error` site. Plus the engine contracts the
reference tests: one launch per fused batch, atomic generation swaps,
the VPROXY_TPU_FUSED / VPROXY_TPU_FUSED_KERNEL knobs, and the rule that
a kernel that cannot serve (KernelError) is never failed over to the
host.
"""
import threading
import time

import numpy as np
import pytest
import torch

from test_fused import mk_ips, mk_queries, mk_rules
from test_torch_kernels import host_only, host_only_hints
from vproxy_tpu.rules import engine as RE
from vproxy_tpu.rules import maglev as RM
from vproxy_tpu.rules.service import ClassifyService as RefService
from vproxy_tpu.utils import failpoint as RFP
from vproxy_tpu_torch.ops import fused_cuda as FC
from vproxy_tpu_torch.rules import engine as E
from vproxy_tpu_torch.rules import maglev as M
from vproxy_tpu_torch.rules import oracle
from vproxy_tpu_torch.rules.ir import Hint, HintRule
from vproxy_tpu_torch.rules.service import ClassifyService
from vproxy_tpu_torch.utils import events, failpoint

torch.set_num_threads(1)

BACKENDS = [(f"10.9.{i // 250}.{i % 250}:80", 1 + i % 4) for i in range(11)]


@pytest.fixture(autouse=True)
def cpu_and_clean(monkeypatch):
    monkeypatch.setenv("VPROXY_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("VPROXY_TPU_INSTALL_PACE", "0")
    failpoint.clear()
    RFP.clear()
    yield
    failpoint.clear()
    RFP.clear()


def pair_of(rules, m=4099, backends=BACKENDS):
    """-> (port pair, reference pair) over the same rules/backends."""
    hm, mm = E.HintMatcher(rules), M.MaglevMatcher(backends, m=m)
    rhm, rmm = RE.HintMatcher(rules, backend="jax"), \
        RM.MaglevMatcher(backends, m=m)
    return M.FusedPair(hm, mm), RM.FusedPair(rhm, rmm)


def ports_of(b):
    return [None if i % 3 == 0 else 1024 + i for i in range(b)]


@pytest.mark.parametrize("kind", ["uri_rules", "host_only"])
def test_classify_and_pick_vs_reference(kind):
    if kind == "uri_rules":
        rules = mk_rules(3000)
        hints = mk_queries(rules, 200)
    else:
        rules = host_only(2000)
        hints = host_only_hints(120)
    pair, ref = pair_of(rules)
    ips, ports = mk_ips(len(hints)), ports_of(len(hints))
    v, p, hp, mp = M.classify_and_pick(pair.hm, pair.mm, hints, ips, ports)
    rv, rp, _, _ = RM.classify_and_pick(ref.hm, ref.mm, hints, ips, ports)
    assert np.array_equal(v, np.asarray(rv))
    assert np.array_equal(p, np.asarray(rp))
    assert ("pk_uslot" in pair.hm.snapshot()[5]) == (kind == "uri_rules")
    # and the host planes agree with the device answers
    hsnap, msnap = pair.hm.snapshot(), pair.mm.snapshot()
    for i in range(len(hints)):
        assert (int(v[i]), int(p[i])) == pair.index_snap(
            (hsnap, msnap), (hints[i], ips[i], ports[i]))


@pytest.mark.parametrize("b,pad_to", [(7, 16), (64, 64), (100, 128)])
def test_fused_pair_dispatch_vs_reference(b, pad_to):
    rules = mk_rules(1500)
    pair, ref = pair_of(rules)
    hints, ips, ports = mk_queries(rules, b), mk_ips(b), ports_of(b)
    payloads = list(zip(hints, ips, ports))
    got = pair.dispatch_snap(pair.snapshot(), payloads, pad_to=pad_to)
    want = np.asarray(ref.dispatch_snap(ref.snapshot(), payloads,
                                        pad_to=pad_to))
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == (pad_to, 2)
    assert np.array_equal(got.numpy(), want)
    assert (got[b:, 0] == -1).all()


@pytest.mark.parametrize("backend", ["torch", "host"])
def test_hint_matcher_match_vs_reference(backend):
    rules = mk_rules(1000)
    hints = mk_queries(rules, 150) + [Hint(), Hint(host="*")]
    hm = E.HintMatcher(rules, backend=backend)
    want = np.asarray(RE.HintMatcher(rules, backend="jax").match(hints))
    assert np.array_equal(hm.match(hints), want)
    assert [hm.match_one(h) for h in hints[:20]] == \
        [oracle.search(rules, h) for h in hints[:20]]


def test_fused_one_launch_per_batch_counter():
    rules = mk_rules(400)
    pair, _ = pair_of(rules, m=251)
    hints, ips = mk_queries(rules, 32), mk_ips(32)
    l0, f0 = E.dispatch_launches_total(), E.fused_dispatches_total()
    M.classify_and_pick(pair.hm, pair.mm, hints, ips)
    assert E.dispatch_launches_total() - l0 == 1
    assert E.fused_dispatches_total() - f0 == 1
    v = pair.hm.dispatch_snap(pair.hm.snapshot(), hints)
    p = pair.mm.dispatch_snap(pair.mm.snapshot(), ips)
    assert E.dispatch_launches_total() - l0 == 3  # +2 for the chain
    assert E.fused_dispatches_total() - f0 == 1
    assert v.shape[0] == p.shape[0] == 32
    from vproxy_tpu_torch.utils.metrics import GlobalInspection
    text = GlobalInspection.get().prometheus_string()
    for fam in ("vproxy_engine_dispatch_launches_total",
                "vproxy_engine_fused_dispatches_total",
                "vproxy_engine_generation", "vproxy_engine_swap_ms",
                "vproxy_maglev_build_ms", "vproxy_classify_dispatches"):
        assert fam in text, fam


def test_fused_disabled_by_knob_falls_back_to_the_chain(monkeypatch):
    monkeypatch.setenv("VPROXY_TPU_FUSED", "0")
    rules = mk_rules(300)
    pair, ref = pair_of(rules, m=251)
    assert pair.hm.fused_stat() == {"available": False}
    hints, ips = mk_queries(rules, 20), mk_ips(20)
    assert E.fused_dispatch(pair.hm, pair.hm.snapshot(), pair.mm,
                            pair.mm.snapshot(), hints, ips) is None
    v, p, _, _ = M.classify_and_pick(pair.hm, pair.mm, hints, ips)
    rv, rp, _, _ = RM.classify_and_pick(ref.hm, ref.mm, hints, ips)
    assert np.array_equal(v, rv) and np.array_equal(p, rp)
    rows = np.asarray(pair.dispatch_snap(pair.snapshot(),
                                         list(zip(hints, ips, [None] * 20))))
    assert np.array_equal(rows[:, 0], rv) and np.array_equal(rows[:, 1], rp)
    monkeypatch.delenv("VPROXY_TPU_FUSED")
    pair.hm.set_rules(rules)  # the next generation packs again
    assert pair.hm.fused_stat()["available"]


def test_fused_entry_ignores_kernel_knob(monkeypatch):
    """One fused tier per device: whatever VPROXY_TPU_FUSED_KERNEL says
    (its values pick the reference's jit/Pallas tiers), the engine
    dispatches through the fused entry (kernel on CUDA tensors, plain
    tier on CPU ones) and reports the tier from the device alone."""
    rules = mk_rules(64)
    hm, mm = E.HintMatcher(rules), M.MaglevMatcher(BACKENDS, m=251)
    hints, ips = mk_queries(rules, 8), mk_ips(8)
    entry, calls = FC.fused_classify_pick, []
    monkeypatch.setattr(FC, "fused_classify_pick",
                        lambda *a: calls.append(1) or entry(*a))
    for knob in (None, "jit", "pallas", "auto"):
        if knob is None:
            monkeypatch.delenv("VPROXY_TPU_FUSED_KERNEL", raising=False)
        else:
            monkeypatch.setenv("VPROXY_TPU_FUSED_KERNEL", knob)
        n = len(calls)
        M.classify_and_pick(hm, mm, hints, ips)
        assert len(calls) == n + 1, knob
        assert E.fused_kernel_name() == "torch"  # CPU tensors
        assert E.fused_kernel_name("meta") == "torch"
    st = hm.fused_stat()
    assert st["available"] and st["kernel"] == "torch" and \
        st["packed_bytes"] > 0


@pytest.mark.parametrize("why", ["build", "fused_off"])
def test_matcher_off_cpu_refuses_to_publish_without_kernel(monkeypatch,
                                                           why):
    """A matcher off the CPU (meta tensors stand in for CUDA ones) has
    its packed table checked and the kernel built when it publishes: a
    build failure stops construction, and VPROXY_TPU_FUSED=0 (the
    unfused chain, CPU only) is refused rather than served."""
    def no_lib():
        raise FC.KernelError("nvcc failed (1)")
    monkeypatch.setattr(FC, "_lib", no_lib)
    if why == "fused_off":
        monkeypatch.setenv("VPROXY_TPU_FUSED", "0")
    with pytest.raises(FC.KernelError if why == "build" else ValueError):
        E.HintMatcher(mk_rules(64), device="meta")


def test_install_under_fused_load_atomic_swap(monkeypatch):
    """engine.swap.stall: while the standby install is held, fused
    dispatches answer the OLD generation; after the atomic swap, the
    NEW one. Every (verdict, pick) comes from one snapshot pair."""
    monkeypatch.setenv("VPROXY_TPU_SWAP_STALL_S", "0.3")
    old = [HintRule(host=f"svc{i}.example.com") for i in range(300)]
    new = [HintRule(host=f"svc{i}.example.org") for i in range(300)]
    hm = E.HintMatcher(old)
    mm = M.MaglevMatcher([(f"b{i}", 1) for i in range(4)], m=251)
    h_old, h_new = Hint.of_host("svc7.example.com"), \
        Hint.of_host("svc7.example.org")
    ip = bytes([10, 0, 0, 7])
    want_pick = mm.pick_one(ip)
    failpoint.arm("engine.swap.stall", count=1)
    gen0 = hm.generation
    th = threading.Thread(target=lambda: hm.set_rules(new), daemon=True)
    th.start()
    seen = set()
    deadline = time.monotonic() + 10
    while hm.generation == gen0 and time.monotonic() < deadline:
        g = hm.generation
        v, p, _, _ = M.classify_and_pick(hm, mm, [h_old, h_new], [ip, ip])
        if g == gen0 and hm.generation == gen0:
            assert (int(v[0]), int(v[1])) == (7, -1)
            seen.add(g)
        assert int(p[0]) == int(p[1]) == want_pick
    th.join(timeout=10)
    assert not th.is_alive() and hm.generation == gen0 + 1
    assert seen == {gen0}
    v, p, _, _ = M.classify_and_pick(hm, mm, [h_old, h_new], [ip, ip])
    assert (int(v[0]), int(v[1])) == (-1, 7)


def test_maglev_install_swaps_pick_atomically():
    hm = E.HintMatcher(mk_rules(64))
    mm = M.MaglevMatcher([("only:1", 1)], m=251)
    ips = mk_ips(16)
    _, p, _, _ = M.classify_and_pick(hm, mm, mk_queries(hm.rules, 16), ips)
    assert (p == 0).all()
    mm.set_backends([("only:1", 1), ("second:2", 1)])
    _, p, _, _ = M.classify_and_pick(hm, mm, mk_queries(hm.rules, 16), ips)
    msnap = mm.snapshot()
    assert [int(x) for x in p] == [mm.pick_snap(msnap, ip) for ip in ips]
    assert np.array_equal(mm.match(ips), RM.MaglevMatcher(
        [("only:1", 1), ("second:2", 1)], m=251).match(ips))


# ------------------------------------------------------------- service


def run_service(svc, kind, target, payloads):
    """Submit every payload concurrently; -> answers in order."""
    got = [None] * len(payloads)
    evs = [threading.Event() for _ in payloads]

    def cb_for(i):
        def cb(*res):
            got[i] = tuple(res[:-1])
            evs[i].set()
        return cb

    for i, p in enumerate(payloads):
        if kind == "cpick":
            svc.submit_classify_pick(target, *p, cb_for(i))
        else:
            svc.submit_hint(target, p, cb_for(i))
    for ev in evs:
        assert ev.wait(30)
    return got


@pytest.mark.parametrize("kind", ["hint", "cpick"])
@pytest.mark.parametrize("fault", [False, True])
def test_service_batches_vs_reference_service(kind, fault):
    """Device-mode batches (and, with the fault armed, the host-index
    failover of the batch that hit it) answer exactly what the
    reference service answers for the same submissions."""
    rules = mk_rules(600)
    pair, ref = pair_of(rules, m=251)
    b = 48
    hints, ips, ports = mk_queries(rules, b), mk_ips(b), ports_of(b)
    if kind == "cpick":
        payloads = list(zip(hints, ips, ports))
        target, rtarget = pair, ref
    else:
        payloads, target, rtarget = hints, pair.hm, ref.hm
    if fault:
        failpoint.arm("device.dispatch.error", count=1)
        RFP.arm("device.dispatch.error", count=1)
    svc, rsvc = ClassifyService(mode="device"), RefService(mode="device")
    try:
        got = run_service(svc, kind, target, payloads)
        want = run_service(rsvc, kind, rtarget, payloads)
        assert got == want
        st = svc.stats
        assert st.queries == b and st.device_queries + st.oracle_queries == b
        assert (st.failovers >= 1) == fault
        if fault:  # the fired site and the failover both left a record
            kinds = {e["kind"] for e in events.FlightRecorder.get().snapshot()}
            assert {"fault_injected", "classify_failover"} <= kinds
        if not fault:
            assert st.device_queries == b and st.dispatches >= 1
    finally:
        svc.close()
        rsvc.close()


def test_service_cpick_launches_fused_once_per_batch():
    rules = mk_rules(300)
    pair, _ = pair_of(rules, m=251)
    svc = ClassifyService(mode="device")
    try:
        f0 = E.fused_dispatches_total()
        b = 40
        got = run_service(svc, "cpick", pair,
                          list(zip(mk_queries(rules, b), mk_ips(b),
                                   [None] * b)))
        assert len(got) == b
        assert E.fused_dispatches_total() - f0 == svc.stats.dispatches >= 1
    finally:
        svc.close()


@pytest.mark.parametrize("kind", ["hint", "cpick"])
def test_service_inline_lone_query(kind):
    """auto mode: a lone query against a big table is answered inline
    from the host index (no dispatch), same answer as the oracle."""
    rules = mk_rules(400)
    pair, _ = pair_of(rules, m=251)
    h, ip = mk_queries(rules, 4)[1], mk_ips(1)[0]
    svc = ClassifyService(mode="auto")
    try:
        res = []
        if kind == "cpick":
            svc.submit_classify_pick(pair, h, ip, None,
                                     lambda v, p, pl: res.append((v, p)))
            want = (oracle.search(rules, h), pair.mm.pick_one(ip))
        else:
            svc.submit_hint(pair.hm, h, lambda i, pl: res.append((i,)))
            want = (oracle.search(rules, h),)
        assert res == [want]  # answered synchronously
        assert svc.stats.inline_fast == 1 and svc.stats.dispatches == 0
    finally:
        svc.close()


@pytest.mark.parametrize("where", ["batch", "probe"])
def test_service_kernel_error_closes_instead_of_failover(monkeypatch,
                                                         where):
    """A KernelError (the fused kernel cannot build, load or launch) is
    never answered from the host: the service records it, answers the
    batch it held with -1, closes, and every later submit raises it.
    The entry is stubbed to raise what the kernel wrapper raises on a
    CUDA build whose kernel cannot launch."""
    rules = mk_rules(300)
    pair, _ = pair_of(rules, m=251)
    submitted = threading.Event()

    def refused(*a):
        submitted.wait(10)  # every submit lands before the service closes
        raise FC.KernelError("fused kernel launch failed: CUDA error 209")
    monkeypatch.setattr(FC, "fused_classify_pick", refused)
    svc = ClassifyService(mode="device")
    b = 24
    payloads = list(zip(mk_queries(rules, b), mk_ips(b), [None] * b))
    try:
        if where == "batch":
            got, evs = [None] * b, [threading.Event() for _ in payloads]
            for i, p in enumerate(payloads):
                svc.submit_classify_pick(
                    pair, *p, lambda v, pk, pl, i=i: (
                        got.__setitem__(i, (v, pk)), evs[i].set()))
            submitted.set()
            assert all(ev.wait(30) for ev in evs)
            assert got == [(-1, -1)] * b
        else:
            submitted.set()
            svc._spawn_probe("cpick", pair, payloads[0])
            deadline = time.monotonic() + 10
            while svc.error is None and time.monotonic() < deadline:
                time.sleep(0.01)
        assert isinstance(svc.error, FC.KernelError)
        st = svc.stats
        assert st.failovers == 0 and st.oracle_queries == 0 \
            and st.device_queries == 0
        with pytest.raises(FC.KernelError, match="CUDA error 209"):
            svc.submit_classify_pick(pair, *payloads[0],
                                     lambda *r: None)
        kinds = {e["kind"] for e in events.FlightRecorder.get().snapshot()}
        assert "classify_kernel_error" in kinds
    finally:
        svc.close()


@pytest.mark.parametrize("where", ["batch", "probe"])
@pytest.mark.parametrize("kind", ["hint", "cpick"])
def test_service_card_dispatch_fault_never_served_from_host(monkeypatch,
                                                            kind, where):
    """On the card every fault of a device dispatch is a KernelError: a
    ValueError out of a matcher on the card (meta stands in for CUDA)
    closes the service like a refused launch, and the host index
    (_oracle_batch) answers none of its batches. On the CPU the same
    fault fails over (test_service_batches_vs_reference_service)."""
    rules = mk_rules(300)
    pair, _ = pair_of(rules, m=251)
    pair.hm.device = torch.device("meta")
    target = pair if kind == "cpick" else pair.hm
    submitted = threading.Event()

    def bad_batch(*a, **kw):
        submitted.wait(10)  # every submit lands before the service closes
        raise ValueError("fused kernel: query windows differ")
    monkeypatch.setattr(target, "dispatch_snap", bad_batch)
    served = []
    monkeypatch.setattr(ClassifyService, "_oracle_batch",
                        lambda self, *a: served.append(a) or [])
    svc = ClassifyService(mode="device")
    b = 24
    hints = mk_queries(rules, b)
    payloads = list(zip(hints, mk_ips(b), [None] * b)) \
        if kind == "cpick" else hints
    try:
        if where == "batch":
            got, evs = [None] * b, [threading.Event() for _ in payloads]
            for i, p in enumerate(payloads):
                def cb(*r, i=i):
                    got[i] = r[:-1]
                    evs[i].set()
                if kind == "cpick":
                    svc.submit_classify_pick(target, *p, cb)
                else:
                    svc.submit_hint(target, p, cb)
            submitted.set()
            assert all(ev.wait(30) for ev in evs)
            assert got == [(-1, -1) if kind == "cpick" else (-1,)] * b
        else:
            submitted.set()
            svc._spawn_probe(kind, target, payloads[0])
            deadline = time.monotonic() + 10
            while svc.error is None and time.monotonic() < deadline:
                time.sleep(0.01)
        assert isinstance(svc.error, FC.KernelError)
        assert isinstance(svc.error.__cause__, ValueError)
        st = svc.stats
        assert not served and st.failovers == 0 \
            and st.oracle_queries == 0 and st.device_queries == 0
        with pytest.raises(FC.KernelError, match="query windows differ"):
            svc.submit_hint(pair.hm, hints[0], lambda *r: None)
    finally:
        svc.close()


def test_service_host_mode_and_host_backend():
    rules = mk_rules(200)
    hosts = E.HintMatcher(rules, backend="host")
    hints = mk_queries(rules, 30)
    svc = ClassifyService(mode="device")
    try:
        got = run_service(svc, "hint", hosts, hints)
        assert got == [(oracle.search(rules, h),) for h in hints]
        assert svc.stats.device_queries == 0
    finally:
        svc.close()
