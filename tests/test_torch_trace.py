"""Request tracing on the port: the cases of tests/test_trace.py that no
other port test holds (test_torch_policing.py has its key sampling,
waterfall, bind context, install spans and histogram merge).

* host logic (sampling, trace ids, the bounded buffer, the pre-
  registered metric series, the `trace` command surface, the flight
  recorder's cross-reference, the StepLoop's queue items and host-index
  spans): the same calls through vproxy_tpu and vproxy_tpu_torch give
  the same answers;
* the native span rings and the lane-to-Python stitch: properties of
  the port's own libvtl (net/vtl.py builds it from native/vtl.cpp),
  asserted as the reference asserts them of its own.

Everything runs on the CPU: no matcher reaches a device.
"""
import re
import socket
import struct
import threading
import time

import pytest

from vproxy_tpu.utils import trace as RT
from vproxy_tpu_torch.net import vtl
from vproxy_tpu_torch.utils import trace as T

from test_torch_tcplb import _torch_cpu, stack  # noqa: F401

PKGS = {"vproxy_tpu": RT, "vproxy_tpu_torch": T}

needs_lanes = pytest.mark.skipif(
    not (vtl.lanes_supported() and vtl.trace_supported()),
    reason="native provider without lane/trace symbols")


@pytest.fixture(autouse=True)
def _trace_off():
    """Every test starts and ends with both packages' knob off and
    empty buffers (the knob is process-global, C side included)."""
    for mod in PKGS.values():
        mod.configure(0)
        mod.reset()
    yield
    for mod in PKGS.values():
        mod.configure(0)
        mod.reset()


def _wait(pred, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


# ------------------------------------------------------------- sampling

def test_sampling_off_is_off():
    for mod in PKGS.values():
        assert not mod.enabled()
        assert mod.maybe_sample() == 0
        assert not mod.sampled_key(b"anything")


def test_counter_sampling_every_nth():
    """Deterministic 1-in-N in both packages: 100 of 400, one in every
    4 consecutive calls at the same phase."""
    for mod in PKGS.values():
        mod.configure(4)
        picks = [i for i in range(400) if mod.maybe_sample()]
        assert len(picks) == 100
        assert len({i % 4 for i in picks}) == 1


def test_trace_id_namespaces_disjoint():
    # python allocates odd ids; the C lane plane even ones
    for mod in PKGS.values():
        assert mod.new_trace_id() % 2 == 1
        assert mod.new_trace_id() != mod.new_trace_id()


# -------------------------------------------------------------- buffer

def test_buffer_bounded_and_drops_counted():
    """The same over-full recording keeps the same number of traces,
    the newest, and counts the same drops in both packages."""
    assert T.MAX_TRACES == RT.MAX_TRACES
    kept, dropped = {}, {}
    for name, mod in PKGS.items():
        mod.configure(1)
        before = mod.py_dropped_total()
        tids = [mod.new_trace_id() for _ in range(mod.MAX_TRACES + 50)]
        for i, tid in enumerate(tids):
            mod.record_span(tid, "accept", "acl", i, 1)
        assert len(mod.trace_ids()) == mod.MAX_TRACES
        assert mod.trace_ids() == tids[50:]
        dropped[name] = mod.py_dropped_total() - before
        kept[name] = [mod.get_trace(t) for t in mod.trace_ids()[-3:]]
    assert dropped["vproxy_tpu"] == dropped["vproxy_tpu_torch"] >= 50
    assert [[{k: v for k, v in s.items() if k != "trace"} for s in t]
            for t in kept["vproxy_tpu"]] == \
        [[{k: v for k, v in s.items() if k != "trace"} for s in t]
         for t in kept["vproxy_tpu_torch"]]


# ----------------------------------------------------- operator surfaces

_TRACE_SERIES = re.compile(r"^(vproxy_trace_[a-z_]+\{[^}]*\})", re.M)


def test_metrics_preregistered_zeros():
    """The silent-drops rule: the trace series exist on /metrics BEFORE
    the first sampled request, the same series in both packages."""
    from vproxy_tpu.utils.metrics import GlobalInspection as RGI
    from vproxy_tpu_torch.utils.metrics import GlobalInspection
    text = GlobalInspection.get().prometheus_string()
    assert 'vproxy_trace_drop_total{ring="lane"}' in text
    assert 'vproxy_trace_drop_total{ring="py"}' in text
    for plane in ("lane", "accept", "engine", "install", "cluster"):
        assert f'vproxy_trace_spans_total{{plane="{plane}"}}' in text
    assert sorted(_TRACE_SERIES.findall(text)) == sorted(
        _TRACE_SERIES.findall(RGI.get().prometheus_string()))


def test_command_surface_trace():
    """`list trace`, `list-detail trace` and `trace <id>` answer alike
    for the same recording; a bad id is a CmdError in both."""
    from vproxy_tpu.control.command import CmdError as RCmdError
    from vproxy_tpu.control.command import Command as RCommand
    from vproxy_tpu_torch.control.command import CmdError, Command
    outs = []
    for mod, cmd, err in ((RT, RCommand, RCmdError), (T, Command, CmdError)):
        mod.configure(1)
        tid = 1_000_001  # one id in both packages: the outputs name it
        mod.record_span(tid, "accept", "acl", 1000, 500)
        mod.record_span(tid, "accept", "connect", 1500, 2000)
        out = cmd.execute(None, "list trace")
        assert any(f"[{tid}]" in line for line in out)
        detail = cmd.execute(None, "list-detail trace")
        assert any(t["trace"] == tid for t in detail)
        wf = cmd.execute(None, f"trace {tid}")
        assert "acl" in "\n".join(wf)
        with pytest.raises(err):
            cmd.execute(None, "trace nope")
        outs.append((out, detail, wf))
    assert outs[0] == outs[1]


def test_flight_recorder_trace_crossref():
    from vproxy_tpu.utils.events import FlightRecorder as RFR
    from vproxy_tpu_torch.utils.events import FlightRecorder
    snaps = []
    for fr in (RFR, FlightRecorder):
        fr.reset()
        rec = fr.get()
        rec.record("conn", "plain event")
        rec.record("conn", "traced event", trace_id=42)
        rec.record("conn", "unsampled", trace_id=0)  # 0 = no crossref
        evs = rec.snapshot(trace=42)
        assert len(evs) == 1 and evs[0]["msg"] == "traced event"
        assert "trace_id" not in rec.snapshot(trace=None)[0]
        assert "trace_id" not in rec.snapshot()[2]
        snaps.append([{k: v for k, v in e.items()
                       if k not in ("ts", "mono", "mono_ns")}
                      for e in rec.snapshot()])
        fr.reset()
    assert snaps[0] == snaps[1]


# ------------------------------------------------------------ C planes

class _Backend:
    """Accept-and-serve-one-line backend for raw lane tests."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(128)
        self.port = self.sock.getsockname()[1]
        self.alive = True
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        while self.alive:
            try:
                c, _ = self.sock.accept()
            except OSError:
                return
            try:
                c.sendall(b"ok\n")
                c.close()
            except OSError:
                pass

    def close(self):
        self.alive = False
        try:
            self.sock.close()
        except OSError:
            pass


def _raw_lanes(backend_port, nlanes=1):
    h = vtl.lanes_new("127.0.0.1", 0, 64, nlanes, 65536, False, 60000,
                      3000)
    rec = vtl.LANE_REC.pack(b"127.0.0.1", backend_port, 0, 1)
    gen = vtl.lane_gen(h)
    assert vtl.lane_install(h, rec, 1, [0], gen) == 1
    return h, vtl.lanes_port(h)


@needs_lanes
def test_native_trace_rec_abi():
    """The port's libvtl writes the reference's 40-byte span record."""
    assert int(vtl.LIB.vtl_trace_rec_size()) == vtl.TRACE_REC.size
    assert vtl.TRACE_REC.size == 40
    assert vtl.TRACE_REC.format == "<QQQQIBBH"
    assert struct.calcsize("<QQQQIBBH") == 40


class _LanePoller:
    """Background lane_poll pump (the lane thread's role): serving and
    span writes happen INSIDE lane_poll, so a test that blocks on
    recv() needs someone polling. Optionally drains the span ring
    (SPSC: this thread is then the one consumer)."""

    def __init__(self, h, drain=True):
        self.h = h
        self.drain = drain
        self.recs: list = []
        self.stop = threading.Event()
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        while not self.stop.is_set():
            punts = vtl.lane_poll(self.h, 0, 50)
            if punts:
                for p in punts:
                    vtl.close(p[0])
            if self.drain:
                self.recs += vtl.trace_drain(self.h, 0)
            if punts is None:
                return

    def close(self):
        self.stop.set()
        self.t.join(5)


@needs_lanes
def test_lane_whole_lifetime_trace_monotonic():
    """One sampled lane-served connection yields accept -> route_pick
    -> connect -> splice -> close with monotonic, non-overlapping
    stages: the whole-lifetime C-plane trace."""
    be = _Backend()
    T.configure(1)
    h, port = _raw_lanes(be.port)
    poller = _LanePoller(h)
    try:
        c = socket.create_connection(("127.0.0.1", port), timeout=5)
        c.settimeout(5)
        assert c.recv(16) == b"ok\n"
        c.close()
        assert _wait(lambda: len(poller.recs) >= 5)
        recs = poller.recs
        spans = {r[5]: r for r in recs}
        names = [vtl.TRACE_SPANS[i] for i in sorted(spans)]
        assert names == ["accept", "route_pick", "connect", "splice",
                         "close"], names
        tids = {r[0] for r in recs}
        assert len(tids) == 1 and list(tids)[0] % 2 == 0  # one EVEN id
        ordered = sorted(recs, key=lambda r: r[1])
        for a, b in zip(ordered, ordered[1:]):
            assert a[1] + a[2] <= b[1] + 1000, \
                f"stage overlap: {a} vs {b}"  # 1us clock-read slack
        splice = spans[vtl.TRACE_SPANS.index("splice")]
        assert splice[3] >= 3  # aux = bytes moved ("ok\n")
    finally:
        vtl.lanes_shutdown(h, 100)
        poller.close()
        vtl.lanes_free(h)
        be.close()


@needs_lanes
def test_span_ring_overflow_counted_never_silent():
    """A ring smaller than the span volume must DROP and COUNT, not
    block the lane or grow unbounded."""
    be = _Backend()
    T.configure(1)
    vtl.trace_set_ring_cap(64)
    poller = None
    try:
        h, port = _raw_lanes(be.port)
        poller = _LanePoller(h, drain=False)  # serve but NEVER drain
        try:
            drops0 = vtl.trace_counters()[1]
            # ~40 conns x 5 spans >> 64 slots, never drained meanwhile
            for _ in range(40):
                c = socket.create_connection(("127.0.0.1", port),
                                             timeout=5)
                c.settimeout(5)
                c.recv(16)
                c.close()
            assert _wait(lambda: vtl.trace_counters()[1] > drops0)
            poller.close()
            poller = None
            # the drain returns at most the ring's capacity
            recs = vtl.trace_drain(h, 0, 256)
            total = len(recs)
            while recs:
                recs = vtl.trace_drain(h, 0, 256)
                total += len(recs)
            assert total <= 64
        finally:
            vtl.lanes_shutdown(h, 100)
            if poller is not None:
                poller.close()
            else:
                while vtl.lane_poll(h, 0, 100) is not None:
                    pass
            vtl.lanes_free(h)
    finally:
        vtl.trace_set_ring_cap(8192)
        be.close()


@needs_lanes
def test_punt_carries_trace_id():
    """A sampled punt's LanePunt record carries the C-side trace id so
    the python path CONTINUES the trace (the cross-plane stitch)."""
    be = _Backend()
    T.configure(1)
    h = vtl.lanes_new("127.0.0.1", 0, 64, 1, 65536, False, 60000, 3000)
    port = vtl.lanes_port(h)  # NO entry installed: every accept punts
    try:
        c = socket.create_connection(("127.0.0.1", port), timeout=5)
        punts = []
        deadline = time.time() + 5
        while time.time() < deadline and not punts:
            punts = vtl.lane_poll(h, 0, 100) or []
        assert punts, "no punt arrived"
        fd, kind, err, cip, cport, bip, bport, tid = punts[0]
        assert kind == vtl.LANE_PUNT_CLASSIC
        assert tid != 0 and tid % 2 == 0  # sampled: EVEN C-plane id
        vtl.close(fd)
        c.close()
        # the C-side spans for the same trace id are in the ring
        recs = vtl.trace_drain(h, 0)
        names = {vtl.TRACE_SPANS[r[5]] for r in recs if r[0] == tid}
        assert {"accept", "punt"} <= names
    finally:
        vtl.lanes_shutdown(h, 100)
        while vtl.lane_poll(h, 0, 100) is not None:
            pass
        vtl.lanes_free(h)
        be.close()


# -------------------------------------------------- cross-plane stitch

@needs_lanes
def test_stitched_trace_lane_to_python(stack):
    """A sampled connection arriving at the C lanes whose entry punts
    (non-trivial ACL -> empty lane entry) yields ONE trace spanning the
    C plane (accept + punt) and the python planes (acl, backend_pick,
    connect, splice, close) with consistent monotonic timestamps."""
    from vproxy_tpu_torch.components.secgroup import SecurityGroup
    from vproxy_tpu_torch.components.servergroup import ServerGroup
    from vproxy_tpu_torch.components.tcplb import TcpLB
    from vproxy_tpu_torch.components.upstream import Upstream
    from vproxy_tpu_torch.rules.ir import AclRule, Proto
    from vproxy_tpu_torch.utils.ip import Network

    from test_torch_tcplb import IdServer, fast_hc, tcp_get_id, wait_healthy

    elg = stack["make_elg"](2)
    srv = IdServer("A")
    stack["servers"].append(srv)
    g = ServerGroup("st-g", elg, fast_hc())
    stack["groups"].append(g)
    g.add("a", "127.0.0.1", srv.port)
    wait_healthy(g, 1)
    ups = Upstream("st-u")
    ups.add(g)
    sg = SecurityGroup("st-acl", default_allow=False)
    sg.add_rule(AclRule("lo", Network.parse("127.0.0.0/8"), Proto.TCP,
                        1, 65535, True))
    T.configure(1)
    lb = TcpLB("st-lb", elg, elg, "127.0.0.1", 0, ups, protocol="tcp",
               lanes=2, security_group=sg)
    stack["lbs"].append(lb)
    lb.start()
    assert lb.lanes is not None
    assert tcp_get_id(lb.bind_port) == "A"

    def stitched():
        # complete only: the session's connect/splice/close spans land
        # at pump DONE, after the client already saw its bytes
        for t in T.summaries(last=0):
            if "lane" in t["planes"] and "accept" in t["planes"] \
                    and any(s["span"] == "close"
                            for s in T.get_trace(t["trace"])):
                return t
        return None

    assert _wait(lambda: stitched() is not None, timeout=8), \
        "no complete cross-plane trace appeared"
    t = stitched()
    spans = T.get_trace(t["trace"])
    by_plane = {p: [s for s in spans if s["plane"] == p]
                for p in t["planes"]}
    lane_names = {s["span"] for s in by_plane["lane"]}
    py_names = {s["span"] for s in by_plane["accept"]}
    assert {"accept", "punt"} <= lane_names
    assert {"acl", "backend_pick", "connect", "close"} <= py_names
    # consistent monotonic timestamps across planes: the C accept span
    # precedes every python span (same CLOCK_MONOTONIC on both sides)
    c_start = min(s["t_ns"] for s in by_plane["lane"])
    py_start = min(s["t_ns"] for s in by_plane["accept"])
    assert c_start <= py_start
    t0 = min(s["t_ns"] for s in spans)
    t1 = max(s["t_ns"] + s["dur_ns"] for s in spans)
    assert 0 < t1 - t0 < 60 * 10**9  # one sane end-to-end window


# --------------------------------------------------- stage histograms

@needs_lanes
def test_lane_stage_histograms_fold(stack):
    """Lane-served connections land in the SAME vproxy_accept_stage_us
    series python-path connections populate (the stat-ABI widening).
    The port has no bench_snapshot: the series' counts are read from
    the histograms themselves."""
    from vproxy_tpu_torch.components.servergroup import ServerGroup
    from vproxy_tpu_torch.components.tcplb import TcpLB
    from vproxy_tpu_torch.components.upstream import Upstream
    from vproxy_tpu_torch.utils.metrics import GlobalInspection

    from test_torch_tcplb import IdServer, fast_hc, tcp_get_id, wait_healthy

    def stage_count(stage):
        return GlobalInspection.get().get_histogram(
            "vproxy_accept_stage_us", stage=stage).state()[0]

    before = {s: stage_count(s) for s in ("backend_pick", "handover",
                                          "total")}
    elg = stack["make_elg"](2)
    srv = IdServer("A")
    stack["servers"].append(srv)
    g = ServerGroup("sh-g", elg, fast_hc())
    stack["groups"].append(g)
    g.add("a", "127.0.0.1", srv.port)
    wait_healthy(g, 1)
    ups = Upstream("sh-u")
    ups.add(g)
    lb = TcpLB("sh-lb", elg, elg, "127.0.0.1", 0, ups, protocol="tcp",
               lanes=2)
    stack["lbs"].append(lb)
    lb.start()
    assert lb.lanes is not None
    for _ in range(10):
        assert tcp_get_id(lb.bind_port) == "A"
    assert lb.accepted == 0  # all served in C — YET the histograms move
    raw = vtl.lanes_stage_stat(lb.lanes.handle, 2)
    assert raw[0] >= 10  # C-side cumulative total-stage count
    assert _wait(lambda: all(
        stage_count(s) >= before[s] + 10
        for s in ("backend_pick", "handover", "total")), timeout=8)


# ------------------------------------------------------ the step loop

def test_step_loop_queue_shape():
    """StepLoop queue items carry the trace context (6-tuples) and the
    degraded host-index path records spans for sampled queries, the
    same items and spans in both packages."""
    from vproxy_tpu.cluster.submit import StepLoop as RStepLoop
    from vproxy_tpu.rules.engine import HintMatcher as RHintMatcher
    from vproxy_tpu.rules.ir import Hint as RHint
    from vproxy_tpu.rules.ir import HintRule as RHintRule
    from vproxy_tpu_torch.cluster.submit import StepLoop
    from vproxy_tpu_torch.rules.engine import HintMatcher
    from vproxy_tpu_torch.rules.ir import Hint, HintRule
    seen = []
    for mod, loop_cls, m_cls, hint, rule in (
            (RT, RStepLoop, RHintMatcher, RHint, RHintRule),
            (T, StepLoop, HintMatcher, Hint, HintRule)):
        mod.configure(1)
        m = m_cls([rule(host="x.example.com")], backend="host")
        loop = loop_cls(m, membership=None, step_ms=5, batch_cap=4,
                        timeout_ms=200)
        loop.degraded = True  # force the host-index path, no clock needed
        got = []
        tid = mod.new_trace_id()
        with mod.bind(tid):
            loop.submit(hint(host="x.example.com"),
                        lambda idx, pl: got.append(idx))
        with loop._qlock:
            batch = list(loop._q)
            loop._q.clear()
        assert len(batch[0]) == 6 and batch[0][5] == tid
        loop._serve_host(batch)
        assert got == [0]
        spans = mod.get_trace(tid)
        assert any(s["span"] == "host_index" and s["plane"] == "cluster"
                   for s in spans)
        seen.append(sorted((s["plane"], s["span"], s.get("n"))
                           for s in spans))
    assert seen[0] == seen[1]


# ------------------------------------- the dispatcher's batch cycle

# every span of a traced device batch, with the fields each carries
# besides trace / plane / span / t_ns / dur_ns ("cpu_ns": the thread's
# CPU time, never above dur_ns)
CYCLE_FIELDS = {
    "submit": {"kind", "cpu_ns"},
    "queue_wait": {"kind"},
    "dispatcher_idle": {"idle_ns", "waits", "since_ns"},
    "dispatch": {"kind", "batch", "cpu_ns"},
    "encode": {"batch", "cpu_ns"},
    "flow_slots": {"batch", "cpu_ns"},
    "upload": {"copies", "bytes", "cpu_ns"},
    "launch": {"kind", "fused"},
    "d2h_sync": {"kind", "batch", "cpu_ns"},
    "deliver": {"kind", "batch", "handoffs", "cpu_ns"},
    "callback_wait": {"kind"},
    "callback": {"kind", "cpu_ns"},
}


def _cycle_case(kind: str, b: int = 24):
    """-> (a ClassifyService in mode "device", submit(payload, cb,
    loop) of `kind` to it, b payloads) on the CPU tier (the "torch"
    backend)."""
    from test_fused import mk_ips, mk_queries, mk_rules
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules import maglev as M
    from vproxy_tpu_torch.rules.ir import AclRule, Proto
    from vproxy_tpu_torch.rules.service import ClassifyService
    from vproxy_tpu_torch.utils.ip import Network, mask_bytes
    svc = ClassifyService(mode="device")
    if kind == "cidr":
        acl = [AclRule(f"r{i}", Network(bytes([10, i, 0, 0]), mask_bytes(16)),
                       Proto.TCP, 1000, 2000, True) for i in range(20)]
        m = E.CidrMatcher([a.network for a in acl], acl=acl)
        payloads = [(bytes([10, i % 20, 1, 2]), 1500) for i in range(b)]
        return svc, (lambda p, cb, lp: svc.submit_cidr(m, *p, cb, lp)), \
            payloads
    rules = mk_rules(200)
    hm = E.HintMatcher(rules)
    if kind == "hint":
        return svc, (lambda p, cb, lp: svc.submit_hint(hm, p, cb, lp)), \
            mk_queries(rules, b)
    pair = M.FusedPair(hm, M.MaglevMatcher(
        [(f"10.9.0.{i}:80", 1) for i in range(7)], m=251))
    return svc, \
        (lambda p, cb, lp: svc.submit_classify_pick(pair, *p, cb, lp)), \
        [(h, ip, 1024 + i) for i, (h, ip) in
         enumerate(zip(mk_queries(rules, b), mk_ips(b)))]


def _serve(submit, payloads, lp, tid: int) -> None:
    """Submit every payload under trace context `tid` (0: none) with
    callbacks on `lp`; wait for every answer."""
    left = [len(payloads)]
    done = threading.Event()

    def cb(*_):
        left[0] -= 1  # on the loop thread only
        if not left[0]:
            done.set()

    with T.bind(tid):
        for p in payloads:
            submit(p, cb, lp)
    assert done.wait(60)


@pytest.mark.parametrize("kind", ["cpick", "hint", "cidr"])
def test_dispatcher_batch_cycle_spans(kind):
    """A bound, sampled submit records every phase of the dispatcher's
    batch cycle (submit, the dispatcher's idle wait, encode, flow_slots
    for cpick, upload, dispatch, d2h_sync, deliver, and the callback's
    wait and run on the loop) with its fields, cpu_ns <= dur_ns; each
    device batch's dispatch and deliver count its queries once. With
    sampling off a batch leaves the buffer and the engine plane's span
    count as they were."""
    from vproxy_tpu_torch.net.eventloop import SelectorEventLoop
    lp = SelectorEventLoop("trace-cycle")
    lp.loop_thread()
    svc, submit, payloads = _cycle_case(kind)
    try:
        n0 = T.plane_spans_total("engine")
        _serve(submit, payloads, lp, T.maybe_sample())  # sampling off: 0
        assert T.trace_ids() == []
        assert T.plane_spans_total("engine") == n0
        T.configure(1)
        # one untraced batch, so the dispatcher next waits while tracing
        _serve(submit, payloads[:1], lp, 0)
        time.sleep(0.3)
        tid = T.new_trace_id()
        _serve(submit, payloads, lp, tid)
        want = set(CYCLE_FIELDS) - ({"flow_slots"} if kind != "cpick"
                                    else set())
        n = len(payloads)
        # a loop may run a batch's callbacks before the dispatcher closes
        # the batch's deliver span (one hand-off a loop): wait for both
        assert _wait(lambda: sum(s["span"] == "callback"
                                 for s in T.get_trace(tid)) == n
                     and sum(s["batch"] for s in T.get_trace(tid)
                             if s["span"] == "deliver") == n)
        spans = T.get_trace(tid)
        assert {s["span"] for s in spans} == want
        for s in spans:
            assert s["plane"] == "engine"
            assert set(s) - {"trace", "plane", "span", "t_ns", "dur_ns"} \
                == CYCLE_FIELDS[s["span"]], s
            if "cpu_ns" in s:
                assert 0 <= s["cpu_ns"] <= s["dur_ns"], s
        by = {}
        for s in spans:
            by.setdefault(s["span"], []).append(s)
        for name in ("submit", "queue_wait", "callback_wait", "callback"):
            assert len(by[name]) == n, name
        for name in ("dispatch", "d2h_sync", "deliver"):
            assert sum(s["batch"] for s in by[name]) == n, name
        assert sum(s["batch"] for s in by["encode"]) == n
        assert all(s["copies"] >= 2 and s["bytes"] > 0
                   for s in by["upload"])
        # the idle wait ends before the first batch's dispatch begins,
        # and it is the last (here the one) wait its idle_ns counts
        idle = by["dispatcher_idle"][0]
        assert idle["t_ns"] + idle["dur_ns"] <= by["dispatch"][0]["t_ns"]
        assert idle["waits"] >= 1 and idle["since_ns"] <= idle["t_ns"]
        assert idle["idle_ns"] >= idle["dur_ns"] >= 200_000_000
    finally:
        svc.close()
        lp.close()


@pytest.mark.parametrize("kind", ["cpick", "cidr"])
def test_dispatcher_idle_counts_the_waits_of_unsampled_batches(kind):
    """While tracing, the dispatcher's waits before small batches with no
    sampled request are not lost: the next sampled wake's
    engine/dispatcher_idle span counts them all (`idle_ns`, `waits`,
    from `since_ns`), and the span itself is the last wait."""
    from vproxy_tpu_torch.net.eventloop import SelectorEventLoop
    lp = SelectorEventLoop("trace-idle")
    lp.loop_thread()
    svc, submit, payloads = _cycle_case(kind, b=8)
    try:
        _serve(submit, payloads[:2], lp, 0)  # built and warm
        T.configure(1)
        _serve(submit, payloads[:2], lp, 0)  # its wait began untraced
        for i in range(3):
            time.sleep(0.1)
            if i < 2:
                _serve(submit, payloads[2 * i + 2:2 * i + 4], lp, 0)
        tid = T.new_trace_id()
        _serve(submit, payloads[6:], lp, tid)
        idle = [s for s in T.get_trace(tid)
                if s["span"] == "dispatcher_idle"]
        assert len(idle) == 1
        idle = idle[0]
        assert idle["waits"] == 3
        assert idle["idle_ns"] >= 300_000_000
        assert 100_000_000 <= idle["dur_ns"] < idle["idle_ns"]
        assert idle["since_ns"] + idle["idle_ns"] <= \
            idle["t_ns"] + idle["dur_ns"]
        # nothing carried on: the next sampled wake counts its own wait
        time.sleep(0.05)
        tid2 = T.new_trace_id()
        _serve(submit, payloads[:2], lp, tid2)
        nxt = [s for s in T.get_trace(tid2)
               if s["span"] == "dispatcher_idle"]
        assert [s["waits"] for s in nxt] == [1]
        assert nxt[0]["since_ns"] == nxt[0]["t_ns"]
    finally:
        svc.close()
        lp.close()


def test_dispatcher_phases_are_profiler_ranges(tmp_path):
    """While a torch profiler records (every thread), the dispatcher's
    traced phases are also record_function ranges named
    "engine/<span>": the exported chrome trace holds engine/encode,
    engine/upload and engine/deliver as user_annotation events."""
    import json

    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    from vproxy_tpu_torch.net.eventloop import SelectorEventLoop
    lp = SelectorEventLoop("trace-prof")
    lp.loop_thread()
    svc, submit, payloads = _cycle_case("cpick")
    try:
        _serve(submit, payloads[:1], lp, 0)  # built and warm
        T.configure(1)
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            _serve(submit, payloads, lp, T.new_trace_id())
        out = tmp_path / "trace.json"
        prof.export_chrome_trace(str(out))
    finally:
        svc.close()
        lp.close()
    names = {e.get("name") for e in json.loads(out.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"engine/encode", "engine/flow_slots", "engine/upload",
            "engine/dispatch", "engine/d2h_sync", "engine/deliver"} <= names
