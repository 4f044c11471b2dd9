"""The port's ClassifyService delivery at batch grain, on the CPU with a
fake matcher: each loop gets its callbacks of a batch in one hand-off
(SelectorEventLoop.run_batch_on_loop), in submit order; requests with no
loop, or a closed one, run inline on the delivering thread; and the
dispatcher holds its next take of the queue while handed-off callbacks
have not started, until they have, or a query comes from a submitter
that holds none of them, or the service closes.

Also the benchmark's readers of the deliver span's `handoffs` field
(portbench/metrics/deliver_handoffs_per_batch*.py).

Every wait is bounded.
"""
import threading
import time

import numpy as np
import pytest

from portbench import spec
from vproxy_tpu_torch.net.eventloop import SelectorEventLoop
from vproxy_tpu_torch.rules.service import ClassifyService, _Req
from vproxy_tpu_torch.utils import trace as T


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("VPROXY_TPU_TORCH_DEVICE", "cpu")
    yield
    T.configure(0)


@pytest.fixture
def loops():
    lps = [SelectorEventLoop(f"deliver-{i}") for i in range(2)]
    for lp in lps:
        lp.loop_thread()
    yield lps
    for lp in lps:
        lp.close()


class FakePair:
    """A classify+pick target answering (q % 1000, q % 7) for a query
    whose hint is (q, ...): `enc_us` of host work a query and `batch_ms`
    (GIL held) a batch, as an encode and an upload would."""

    backend = "torch"
    device = None

    def __init__(self, enc_us: float = 0.0, batch_ms: float = 0.0):
        self.enc_us, self.batch_ms = enc_us, batch_ms

    def snapshot(self):
        return 1

    def snap_payload(self, snap):
        return "gen"

    def size(self):
        return 100_000

    def dispatch_snap(self, snap, payloads, pad_to=None, sync=False):
        out = np.full((pad_to, 2), -1, np.int32)
        for i, (hint, _ip, _port) in enumerate(payloads):
            _spin(self.enc_us)
            out[i] = (hint[0] % 1000, hint[0] % 7)
        _spin(self.batch_ms * 1e3)
        return out


def _spin(us: float) -> None:
    t = time.perf_counter() + us / 1e6
    while time.perf_counter() < t:
        pass


class Rec:
    """Callbacks that record (request id, answer, thread name) in order."""

    def __init__(self, n: int):
        self.got = []
        self.lock = threading.Lock()
        self.n = n
        self.done = threading.Event()

    def cb(self, i):
        def cb(*res):
            with self.lock:
                self.got.append((i, res, threading.current_thread().name))
                if len(self.got) == self.n:
                    self.done.set()
        return cb


def _count_handoffs(monkeypatch):
    """-> [loop names of each run_batch_on_loop call, in order]."""
    calls = []
    orig = SelectorEventLoop.run_batch_on_loop

    def counted(self, fns):
        calls.append((self.name, len(fns)))
        return orig(self, fns)
    monkeypatch.setattr(SelectorEventLoop, "run_batch_on_loop", counted)
    return calls


def test_grouped_by_loop_in_submit_order(loops, monkeypatch):
    """One batch over two loops and no loop: one hand-off a loop, each
    loop's callbacks on its thread in submit order, the loop-less ones
    inline on the delivering thread."""
    calls = _count_handoffs(monkeypatch)
    svc = ClassifyService(mode="device")
    try:
        n = 30
        rec = Rec(n)
        owners = [loops[0], loops[1], None]
        reqs = [_Req(((i,), b"\1\2\3\4", 80), rec.cb(i), owners[i % 3])
                for i in range(n)]
        idxs = np.array([(i, 100 + i) for i in range(n)], np.int32)
        svc._deliver(reqs, idxs, "gen", kind="cpick")
        assert rec.done.wait(5)
    finally:
        svc.close()
    assert sorted(calls) == [("deliver-0", 10), ("deliver-1", 10)]
    by_thread = {}
    for i, res, th in rec.got:
        by_thread.setdefault(th, []).append(i)
        assert res == (i, 100 + i, "gen")
    me = threading.current_thread().name
    assert by_thread == {"deliver-0": list(range(0, n, 3)),
                         "deliver-1": list(range(1, n, 3)),
                         me: list(range(2, n, 3))}
    assert svc._handoffs == []  # every callback started


def test_closed_loop_runs_inline(loops):
    gone = SelectorEventLoop("deliver-gone")
    gone.loop_thread()
    gone.close()
    svc = ClassifyService(mode="device")
    try:
        rec = Rec(6)
        reqs = [_Req(((i,), b"\1\2\3\4", 80), rec.cb(i),
                     gone if i % 2 else loops[0]) for i in range(6)]
        svc._deliver(reqs, np.arange(6, dtype=np.int32), None, kind="hint")
        assert rec.done.wait(5)
    finally:
        svc.close()
    me = threading.current_thread().name
    assert sorted((i, th) for i, _, th in rec.got) == \
        [(i, me if i % 2 else "deliver-0") for i in range(6)]
    assert all(res == (i, None) for i, res, _ in rec.got)
    assert svc._handoffs == []  # the refused hand-off holds nothing


@pytest.mark.parametrize("rows,want", [
    (np.array([[3, 4], [5, 6]], np.int32), [(3, 4), (5, 6)]),
    ([(3, 4), (5, 6)], [(3, 4), (5, 6)]),
    ([np.int32(-1), -1], [(-1, -1), (-1, -1)]),  # the scalar error fill
])
def test_cpick_rows_and_the_error_fill(loops, rows, want):
    svc = ClassifyService(mode="device")
    try:
        rec = Rec(2)
        reqs = [_Req(None, rec.cb(i), loops[i]) for i in range(2)]
        svc._deliver(reqs, rows, "pl", kind="cpick")
        assert rec.done.wait(5)
    finally:
        svc.close()
    got = {i: res for i, res, _ in rec.got}
    assert [got[0], got[1]] == [(*w, "pl") for w in want]
    assert all(type(x) is int for r in got.values() for x in r[:2])


@pytest.mark.parametrize("kind", ["hint", "cpick"])
def test_deliver_nomatch_answers_minus_one(loops, kind):
    svc = ClassifyService(mode="device")
    try:
        rec = Rec(4)
        reqs = [_Req(None, rec.cb(i), loops[i % 2] if i < 3 else None)
                for i in range(4)]
        svc._deliver_nomatch(reqs, kind)
        assert rec.done.wait(5)
    finally:
        svc.close()
    want = (-1, -1, None) if kind == "cpick" else (-1, None)
    assert sorted(i for i, _, _ in rec.got) == [0, 1, 2, 3]
    assert all(res == want for _, res, _ in rec.got)


def test_sampled_requests_record_their_callback_wait_and_run(loops):
    T.configure(1)
    svc = ClassifyService(mode="device")
    try:
        tid = T.new_trace_id()
        rec = Rec(8)
        reqs = [_Req(None, rec.cb(i), loops[i % 2], tid if i in (1, 6)
                     else 0) for i in range(8)]
        svc._deliver(reqs, list(range(8)), None, kind="hint", tid=tid)
        assert rec.done.wait(5)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and sum(
                s["span"] == "callback" for s in T.get_trace(tid)) < 2:
            time.sleep(0.01)
        spans = T.get_trace(tid)
    finally:
        svc.close()
    by = {}
    for s in spans:
        by.setdefault(s["span"], []).append(s)
    assert len(by["callback_wait"]) == len(by["callback"]) == 2
    (d,) = by["deliver"]
    assert d["batch"] == 8 and d["handoffs"] == 2
    for w in by["callback_wait"]:
        assert w["t_ns"] >= d["t_ns"] and w["dur_ns"] >= 0


def _serve(svc, pair, ids, loop, rec):
    for i in ids:
        svc.submit_classify_pick(pair, (i,), b"\1\2\3\4", 80, rec.cb(i),
                                 loop=loop)


def _park(svc, pair, loop, behind: list, rec):
    """Park `loop` in a long callback (that of query behind[0] - 1) with
    the callbacks of `behind`, a later delivery, queued after it, so the
    service holds on `loop`. -> the event that releases it."""
    release, parked = threading.Event(), threading.Event()

    def slow(*res):
        parked.set()
        release.wait(20)
        rec.cb(behind[0] - 1)(*res)
    svc.submit_classify_pick(pair, (behind[0] - 1,), b"\1\2\3\4", 80,
                             slow, loop=loop)
    assert parked.wait(5)
    _serve(svc, pair, behind, loop, rec)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        with svc._lock:
            if svc._holds(loop):
                break
        time.sleep(0.01)
    with svc._lock:
        assert svc._holds(loop) and svc._holding()
    return release


def test_hold_releases_for_a_plain_thread_while_a_loop_is_blocked(loops):
    """A loop parked in a long callback keeps later callbacks of a
    delivery queued behind it, which holds the dispatcher; a query from
    a plain thread (no loop), and one naming a loop that holds none of
    them, are answered all the same, and the parked loop's own come
    once it is released."""
    svc = ClassifyService(mode="device")
    pair = FakePair()
    held = Rec(4)
    release = None
    try:
        release = _park(svc, pair, loops[0], [1, 2, 3], held)
        plain = Rec(1)
        threading.Thread(target=_serve,
                         args=(svc, pair, [10], None, plain)).start()
        assert plain.done.wait(5)
        other = Rec(1)
        _serve(svc, pair, [11], loops[1], other)
        assert other.done.wait(5)
        assert not held.done.is_set()
        release.set()
        assert held.done.wait(5)
    finally:
        if release is not None:
            release.set()
        svc.close()
    assert plain.got == [(10, (10, 3, "gen"), "classify-dispatch")]
    assert other.got == [(11, (11, 4, "gen"), "deliver-1")]
    assert sorted(i for i, _, _ in held.got) == [0, 1, 2, 3]


def test_the_hold_ends_as_the_last_handoff_drains(loops):
    """Queries queued for a loop while it held callbacks (here submitted
    off its thread) wait until every hand-off has drained: that loop
    draining while another is still parked with its own does not end
    the hold; the last one draining does."""
    svc = ClassifyService(mode="device")
    pair = FakePair()
    parked0, parked1 = Rec(3), Rec(3)
    rel0 = rel1 = None
    try:
        rel0 = _park(svc, pair, loops[0], [1, 2], parked0)
        rel1 = _park(svc, pair, loops[1], [11, 12], parked1)
        late = Rec(1)
        _serve(svc, pair, [20], loops[1], late)
        rel1.set()
        assert parked1.done.wait(5)
        time.sleep(0.2)
        assert not late.done.is_set()  # loop 0 still holds callbacks
        with svc._lock:
            assert svc._holding() and svc._pending
        rel0.set()
        assert parked0.done.wait(5)
        assert late.done.wait(5)
    finally:
        for rel in (rel0, rel1):
            if rel is not None:
                rel.set()
        svc.close()
    assert late.got == [(20, (20, 6, "gen"), "deliver-1")]


def test_the_hold_waits_for_the_handed_off_callbacks(loops):
    """While a delivery's callbacks have not all started, a query from
    their own loop waits in the queue; it is taken once they have."""
    svc = ClassifyService(mode="device")
    pair = FakePair()
    rec = Rec(3)
    release = None
    try:
        release = _park(svc, pair, loops[0], [1], rec)
        # a query of the held loop (submitted here, off its thread)
        _serve(svc, pair, [2], loops[0], rec)
        time.sleep(0.2)
        with svc._lock:
            assert svc._holding() and svc._pending
        release.set()
        assert rec.done.wait(5)
    finally:
        if release is not None:
            release.set()
        svc.close()
    assert sorted(i for i, _, _ in rec.got) == [0, 1, 2]


def test_the_hold_ends_when_the_service_closes(loops):
    svc = ClassifyService(mode="device")
    pair = FakePair()
    rec = Rec(3)
    release = None
    try:
        release = _park(svc, pair, loops[0], [1], rec)
        _serve(svc, pair, [2], loops[0], rec)
        svc.close()
        svc._thread.join(5)
        assert not svc._thread.is_alive()
        with svc._lock:
            assert not svc._pending  # taken and served on the way out
    finally:
        if release is not None:
            release.set()
    assert rec.done.wait(5)


def test_closed_loop_clients_keep_batches_large(loops):
    """4,096 closed-loop clients on two loops, each answer's callback
    submitting the next query, with per-query and per-batch host work:
    batches stay in the thousands (a hand-off a loop, then the hold),
    not the tens, and every answer is right."""
    svc = ClassifyService(mode="device")
    pair = FakePair(enc_us=4.0, batch_ms=1.5)
    stop = threading.Event()
    bad = []

    class Client:
        def __init__(self, q, lp):
            self.q, self.lp = q, lp

        def send(self):
            self.q += 1
            svc.submit_classify_pick(pair, (self.q,), b"\1\2\3\4", 80,
                                     self.done, loop=self.lp)

        def done(self, v, p, pl):
            if (v, p) != (self.q % 1000, self.q % 7):
                bad.append(self.q)
            _spin(10.0)  # the accept's own work
            if not stop.is_set():
                self.send()
    try:
        clients = [Client(j * 100_003, loops[j % 2]) for j in range(4096)]
        for c in clients:
            c.lp.run_on_loop(c.send)
        time.sleep(1.0)
        with svc.stats.lock:
            b0, q0 = svc.stats.by_kind["cpick"][:2]
        time.sleep(2.0)
        with svc.stats.lock:
            b1, q1 = svc.stats.by_kind["cpick"][:2]
        stop.set()
        time.sleep(0.3)
    finally:
        stop.set()
        svc.close()
    assert b1 > b0 and not bad
    assert (q1 - q0) / (b1 - b0) >= 400


# ---------------------------------------- the benchmark's readers

def _sp(span, **f):
    return {"trace": 1, "plane": "engine", "span": span, "t_ns": 0,
            "dur_ns": 1000, **f}


@pytest.mark.parametrize("name", ["deliver_handoffs_per_batch",
                                  "deliver_handoffs_per_batch.cidr"])
def test_handoffs_reader(name):
    read = spec.metric_reader(name)
    spans = [_sp("deliver", kind="cpick", batch=2048, handoffs=2),
             _sp("deliver", kind="cpick", batch=1000, handoffs=3),
             _sp("dispatch", kind="cpick", batch=1000),
             _sp("callback", kind="cpick", handoffs=99)]
    assert read({"spans": spans}) == pytest.approx(2.5)
    # a program whose deliver spans carry no such field, and no spans
    old = [{k: v for k, v in s.items() if k != "handoffs"} for s in spans]
    assert read({"spans": old}) is None
    assert read({"spans": []}) is None


def test_handoffs_readers_are_listed_per_cell():
    names = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for n, cell, moves in (
            ("deliver_handoffs_per_batch", "hint100k.cpick-c4096",
             "lookups_per_s"),
            ("deliver_handoffs_per_batch.cidr",
             "sg5k-rt50k.cidr-dual-c4096", "device_peak_mb")):
        m = names[n]
        assert m["workloads"] == [cell] and m["moves"] == moves
        assert m["source"] == "program_span" and m["layer"] == "delivery"
        assert m["better"] == "lower"


def test_a_batch_records_its_latencies_against_one_now(loops, monkeypatch):
    """_deliver records each request's submit->delivery latency once,
    in submit order, all against the one clock reading of the batch."""
    svc = ClassifyService(mode="device")
    got = []
    monkeypatch.setattr(svc.stats, "record_latency", got.append)
    try:
        rec = Rec(5)
        reqs = [_Req(None, rec.cb(i), loops[i % 2] if i < 4 else None)
                for i in range(5)]
        for k, r in enumerate(reqs):
            r.t0 -= 0.25 * k
        svc._deliver(reqs, list(range(5)), None, kind="hint")
        assert rec.done.wait(5)
    finally:
        svc.close()
    assert len(got) == 5
    assert got == sorted(got)
    nows = [lat + r.t0 for lat, r in zip(got, reqs)]
    assert max(nows) - min(nows) < 1e-6
