"""Host-side parity of the port's policing, trace, sketch and workload
modules with the reference's: the same seeded inputs through both
packages give equal verdicts, spans, top-K tables and captures.

* policing: the token-bucket law over a seeded debit schedule, key
  hashes, and the verdicts and enforcement tables two engines compile
  from identical sketch windows;
* sketch: Count-Min estimates and Space-Saving top-K over a seeded Zipf
  stream, and the module plane's top tables and counters;
* trace: FNV-64, key sampling, and the spans, summaries and waterfall of
  identical recordings;
* workload: a capture window fed the same arrivals, connection sizes
  and heavy hitters exports the same model in both packages, and the
  seeded histogram sampler draws the same values.

Everything here is host code: no matcher, no device.
"""
import random

import pytest

from vproxy_tpu.policing import engine as RP
from vproxy_tpu.utils import metrics as RM
from vproxy_tpu.utils import sketch as RS
from vproxy_tpu.utils import trace as RT
from vproxy_tpu.utils import workload as RW
from vproxy_tpu_torch.policing import engine as P
from vproxy_tpu_torch.utils import metrics as M
from vproxy_tpu_torch.utils import sketch as S
from vproxy_tpu_torch.utils import trace as T
from vproxy_tpu_torch.utils import workload as W

PAIRS = {"policing": (RP, P), "sketch": (RS, S), "trace": (RT, T),
         "workload": (RW, W), "metrics": (RM, M)}
_NS = 1_000_000_000


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (RS, S, RT, T, RW, W):
        mod.reset()
    for eng in (RP.default(), P.default()):
        eng.set_policies([])
        eng.reset()
    yield
    for mod in (RS, S, RT, T, RW, W):
        mod.reset()
    RT.configure(0)
    T.configure(0)


def zipf_stream(seed: int, n_keys: int, n_events: int, s: float = 1.2):
    """Seeded Zipf-distributed (key, weight) events."""
    rng = random.Random(seed)
    weights = [1.0 / (i + 1) ** s for i in range(n_keys)]
    keys = [f"10.{i // 250}.{i % 250}.{1 + i % 7}" for i in range(n_keys)]
    return [(k, 1 + rng.randrange(3))
            for k in rng.choices(keys, weights, k=n_events)]


# ------------------------------------------------------------ policing

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_token_bucket_law_parity(seed):
    rng = random.Random(seed)
    t0 = 1_000 * _NS
    rate, burst = rng.choice([0.5, 2.0, 40.0]), rng.choice([1.0, 3.0, 9.0])
    a = RP.TokenBucket(rate=rate, burst=burst, now_ns=t0)
    b = P.TokenBucket(rate=rate, burst=burst, now_ns=t0)
    now = t0
    for _ in range(400):
        now += rng.choice([0, 1, _NS // 100, _NS // 3, -_NS // 10, _NS])
        assert a.debit(now) == b.debit(now)
        assert a.level_mtok == b.level_mtok


def test_key_hash_parity():
    rng = random.Random(5)
    for dim in RS.DIMS:
        for _ in range(50):
            key = f"{rng.randrange(256)}.{rng.randrange(256)}.0.1" \
                if dim == "clients" else f"k{rng.randrange(10**6)}.example"
            assert RP.key_hash(dim, key) == P.key_hash(dim, key)


@pytest.mark.parametrize("action", ["shed", "throttle", "monitor"])
def test_policing_verdicts_and_tables_parity(action):
    """Identical sketch windows -> identical enforcement tables and the
    same verdict for every check of a seeded schedule."""
    events = zipf_stream(11, 300, 4000)
    for mod in (RS, S):
        for key, w in events:
            mod.update("clients", key, w)
    engines = []
    for mod in (RP, P):
        eng = mod.PolicingEngine()
        eng.set_policy(mod.Policy("crowd", "clients", 5, 10, action))
        eng.set_policy(mod.Policy("net9", "clients", 2, 4, "shed",
                                  tenant="10.1.0.0/16"))
        eng.tick(now=100.0, now_ns=100 * _NS)
        engines.append(eng)
    ref, got = engines

    def table(eng):
        return sorted((e["dim"], e["key"], e["action"], e["policy"])
                      for e in eng.table_snapshot())

    assert table(ref) == table(got) and table(got)
    rng = random.Random(12)
    keys = [k for k, _ in events[:200]] + ["192.0.2.1", "10.1.3.4"]
    now = 100 * _NS
    for _ in range(1500):
        now += rng.choice([0, 0, _NS // 50])
        key = rng.choice(keys)
        assert ref.check_at("clients", key, now) == \
            got.check_at("clients", key, now), key
    assert ref.shed_receipt() == got.shed_receipt()


# -------------------------------------------------------------- sketch

def test_count_min_and_space_saving_parity():
    events = zipf_stream(21, 2000, 20000)
    cms = (RS.CountMin(), S.CountMin())
    sss = (RS.SpaceSaving(), S.SpaceSaving())
    for key, w in events:
        for cm in cms:
            cm.update(key.encode(), w)
        for ss in sss:
            ss.update(key, w)
    keys = {k for k, _ in events}
    assert all(cms[0].estimate(k.encode()) == cms[1].estimate(k.encode())
               for k in keys)
    assert sss[0].top() == sss[1].top()


def test_sketch_plane_top_tables_parity():
    """Plane counters are process-lifetime totals (other tests' C lanes
    add to the "lane" plane): the planes fed here are compared by their
    increments."""
    rng = random.Random(22)
    streams = {dim: zipf_stream(30 + i, 500, 3000)
               for i, dim in enumerate(RS.DIMS)}
    fed = ("accept", "dns", "engine")
    before = {mod: [mod.plane_updates_total(pl) for pl in fed]
              for mod in (RS, S)}
    for dim, events in streams.items():
        for key, w in events:
            plane = rng.choice(fed)
            RS.update(dim, key, w, plane=plane)
            S.update(dim, key, w, plane=plane)

    def rows(mod, dim):
        return [(r["key"], r["count"], r["err"])
                for r in mod.top_table(dim, mod.TOPK)]

    for dim in RS.DIMS:
        assert rows(RS, dim) == rows(S, dim) and rows(S, dim)
    inc = {mod: [mod.plane_updates_total(pl) - b
                 for pl, b in zip(fed, before[mod])] for mod in (RS, S)}
    assert inc[RS] == inc[S] and sum(inc[S]) > 0
    table = RS.top_table("clients")  # rates read the clock: one table
    assert RS.render_top("clients", table) == S.render_top("clients", table)


# --------------------------------------------------------------- trace

def test_trace_hash_and_key_sampling_parity():
    rng = random.Random(31)
    blobs = [bytes(rng.randrange(256) for _ in range(rng.randrange(40)))
             for _ in range(300)]
    assert [RT.fnv64(b) for b in blobs] == [T.fnv64(b) for b in blobs]
    for n in (1, 3, 16):
        RT.configure(n)
        T.configure(n)
        keys = [f"10.0.{i % 256}.{i // 256}" for i in range(500)]
        assert [RT.sampled_key(k) for k in keys] == \
            [T.sampled_key(k) for k in keys]


def test_trace_spans_summaries_and_waterfall_parity():
    """The same spans recorded under the same ids give the same trace,
    the same summaries and the same rendered waterfall."""
    RT.configure(1)
    T.configure(1)
    rng = random.Random(32)
    tids = [1000 + i for i in range(6)]
    # process-lifetime counters: compared by their increments
    before = {mod: mod.plane_spans_total("accept") for mod in (RT, T)}
    for tid in tids:
        t = 5_000_000
        for span in ("acl", "classify_inline", "backend_pick", "connect"):
            d = rng.randrange(1, 90_000)
            for mod in (RT, T):
                mod.record_span(tid, "accept", span, t, d, lb="lb1",
                                kind="hint")
            t += d + rng.randrange(5_000)
    for tid in tids:
        assert RT.get_trace(tid) == T.get_trace(tid)
        assert RT.waterfall(tid) == T.waterfall(tid)
    mine = set(tids)  # spans a still-running lane may add stay out

    def ours(mod):
        return ([t for t in mod.trace_ids() if t in mine],
                [r for r in mod.summaries(0) if r["trace"] in mine],
                mod.stage_table(lambda sp: sp["trace"] in mine))

    assert ours(RT) == ours(T)
    assert RT.plane_spans_total("accept") - before[RT] == \
        T.plane_spans_total("accept") - before[T] == 24


def test_trace_bind_context_parity():
    for mod in (RT, T):
        assert mod.current_id() == 0
        with mod.bind(77):
            assert mod.current_id() == 77
            with mod.bind(0):  # no-op: the context stays
                assert mod.current_id() == 77
            with mod.bind(78):
                assert mod.current_id() == 78
            assert mod.current_id() == 77
        assert mod.current_id() == 0


# ------------------------------------------------------------ workload

@pytest.fixture
def _zero_conn_hists():
    """Both packages' process-global conn histograms (the aggregate the
    capture window reads, and the test's per-LB pair) start from zero
    and get their earlier state back afterwards. Earlier tests in the
    same process fill the two packages' aggregates to different sums,
    and a capture is the difference of two cumulative sums: over
    different bases the same observations round differently."""
    saved = []
    for mt in (RM, M):
        for lb in (None, "lb-w"):
            for h in mt.conn_hists(lb):
                with h._lock:
                    saved.append((h, h._count, h._sum, list(h._counts)))
                    h._count, h._sum = 0, 0.0
                    h._counts = [0] * len(h._counts)
    yield
    for h, count, total, counts in saved:
        with h._lock:
            h._count, h._sum, h._counts = count, total, counts


@pytest.mark.usefixtures("_zero_conn_hists")
def test_workload_capture_export_parity():
    """A capture window fed the same arrivals (pre-bucketed, as the C
    lanes fold them), connection sizes and heavy hitters exports the
    same model, up to the window's wall-clock fields. The workload
    sessions and sketch dimensions start fresh (_fresh), the conn
    histograms from zero (_zero_conn_hists)."""
    rng = random.Random(41)
    nb = 28  # log2 buckets + the +Inf bucket
    feeds = []
    for _ in range(20):
        pl = rng.choice(RW.PLANES)
        deltas = [rng.randrange(6) if i < 20 else 0 for i in range(nb)]
        feeds.append((pl, deltas, float(rng.randrange(10**6)),
                      sum(deltas)))
    conns = [(rng.randrange(1, 10**6), rng.randrange(1, 10**4))
             for _ in range(200)]
    hitters = zipf_stream(42, 200, 2000)
    models = []
    for wl, mt, sk in ((RW, RM, RS), (W, M, S)):
        wl.configure(True)
        sk.configure(True)
        wl.capture_start()
        for pl, deltas, s, c in feeds:
            wl.arrival_merge(pl, deltas, s, c)
        for nbytes, dur in conns:
            mt.conn_observe("lb-w", nbytes, dur)
        for key, w in hitters:
            sk.update("clients", key, w)
        wl.capture_stop()
        m = wl.export_model(seed=7)
        for k in ("captured_at", "window_s"):
            m.pop(k)
        for pl in m["planes"].values():
            pl.pop("rate_hz")
        models.append(m)
    assert models[0] == models[1]
    assert models[1]["planes"] and models[1]["popularity"]["clients"]["top"]
    text = W.WorkloadModel(models[1] | {"window_s": 1.0,
                                        "captured_at": 0.0}).to_json()
    assert W.WorkloadModel.from_json(text).to_json() == \
        RW.WorkloadModel.from_json(text).to_json()


@pytest.mark.parametrize("seed", [1, 2])
def test_workload_sampler_and_zipf_fit_parity(seed):
    rng = random.Random(seed)
    hist = {"count": 0, "sum": 0.0,
            "buckets": [rng.randrange(50) for _ in range(28)]}
    ra, rb = random.Random(seed + 100), random.Random(seed + 100)
    assert [RW.sample_from_hist(ra, hist) for _ in range(500)] == \
        [W.sample_from_hist(rb, hist) for _ in range(500)]
    counts = sorted((rng.randrange(1, 10**5) for _ in range(40)),
                    reverse=True)
    assert RW.fit_zipf_alpha(counts) == W.fit_zipf_alpha(counts)


def test_histogram_merge_and_state_parity():
    """Histogram.merge / state: the C lanes' pre-bucketed deltas fold
    into the same series and the same capture primitive."""
    rng = random.Random(51)
    a, b = RM.Histogram("h"), M.Histogram("h")
    for _ in range(50):
        v = rng.random() * 10**rng.randrange(7)
        a.observe(v)
        b.observe(v)
        deltas = [rng.randrange(3) for _ in range(28)]
        a.merge(deltas, float(sum(deltas)), sum(deltas))
        b.merge(deltas, float(sum(deltas)), sum(deltas))
    assert a.state() == b.state()
    assert a.sample_lines() == b.sample_lines()


# ------------------------------------ the engine and service hooks

def _span_names(mod, tid) -> list:
    return sorted({(s["plane"], s["span"]) for s in mod.get_trace(tid)})


def test_install_and_dispatch_spans_and_routes_parity(monkeypatch):
    """The hooks of rules/engine.py and rules/service.py: a traced
    standby install records the same install / compile / upload / swap
    spans in both packages, a traced device batch the reference's
    queue_wait / dispatch / launch / d2h_sync spans in both (the port
    adds the phases of its dispatcher's batch cycle, and only those),
    and the batches credit the same `upstream:<alias>` keys to the
    routes dimension."""
    import threading

    from test_fused import mk_queries, mk_rules
    from vproxy_tpu.rules import engine as RE
    from vproxy_tpu.rules.service import ClassifyService as RefService
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules.service import ClassifyService
    monkeypatch.setenv("VPROXY_TPU_INSTALL_PACE", "0")
    rules = mk_rules(300)
    hints = mk_queries(rules, 24)
    got = {}
    for name, tr, sk, eng, svc_cls, kw in (
            ("ref", RT, RS, RE, RefService, {}),
            ("port", T, S, E, ClassifyService, {"device": "cpu"})):
        tr.configure(1)
        sk.configure(True)
        m = eng.HintMatcher(rules[:100], backend=eng.default_backend(),
                            **kw)
        m.owner_alias = "u-parity"
        before = set(tr.trace_ids())
        m.set_rules(rules)  # a standby install: its own trace
        eng.flush_installs(30)
        install = [t for t in tr.trace_ids() if t not in before]
        assert len(install) == 1, (name, install)
        svc = svc_cls(mode="device")
        done = threading.Event()
        left = [len(hints)]
        lock = threading.Lock()

        def cb(*_):
            with lock:
                left[0] -= 1
                if left[0] == 0:
                    done.set()

        tid = tr.new_trace_id()
        try:
            with tr.bind(tid):
                for h in hints:
                    svc.submit_hint(m, h, cb)
            assert done.wait(60), name
        finally:
            svc.close()
        got[name] = (_span_names(tr, install[0]), _span_names(tr, tid),
                     sorted(r["key"] for r in sk.top_table("routes")))
    ref_install, ref_batch, ref_routes = got["ref"]
    install_spans, batch_spans, routes = got["port"]
    assert (install_spans, routes) == (ref_install, ref_routes)
    assert set(ref_batch) <= set(batch_spans)
    assert {("engine", s) for s in ("submit", "encode", "upload",
                                    "deliver")} <= \
        set(batch_spans) - set(ref_batch) <= \
        {("engine", s) for s in ("submit", "dispatcher_idle", "encode",
                                 "upload", "deliver")}
    assert {("install", s) for s in ("install", "compile", "upload",
                                     "swap")} <= set(install_spans)
    assert {("engine", s) for s in ("queue_wait", "dispatch", "launch",
                                    "d2h_sync")} <= set(batch_spans)
    assert routes == ["upstream:u-parity"]
