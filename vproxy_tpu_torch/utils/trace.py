"""Request tracing — span-level latency attribution across every plane.

The observability layer (utils/metrics histograms + the
utils/events flight recorder) answers "how much / how fast" and "what
happened around second X"; this module answers "where did THIS request
spend its time". A sampled request carries a **trace context** — a
nonzero u64 trace id — through every plane it touches, and each plane
records `(trace_id, plane, span, t_start_ns, dur_ns, fields)` into one
process-wide bounded buffer:

* **lane**    — the C accept plane (native/vtl.cpp): each lane thread
  writes fixed binary TraceRec records into a lock-free SPSC span ring
  (accept → route_pick → connect → splice → close for lane-served
  connections; accept → punt for punted ones, with the trace id riding
  the widened LanePunt so the python path CONTINUES the same trace).
  components/lanes.py drains the rings through `vtl_trace_drain` into
  this buffer. Ring overflow is counted, never silent
  (`vproxy_trace_drop_total{ring="lane"}`).
* **accept**  — the python accept path (components/tcplb.py): acl,
  backend_pick, connect, splice, close, total.
* **engine**  — classify dispatch (rules/service.py + rules/engine.py):
  submit, queue_wait, dispatcher_idle, dispatch (holding encode,
  flow_slots and upload), launch markers (fused vs unfused
  distinguishable), d2h_sync, deliver, callback_wait, callback,
  classify_inline / host_index fallbacks.
* **install** — the TableInstaller (rules/engine.py): every standby
  generation install traced as compile / upload / swap spans.
* **cluster** — the step-synchronized submit loop (cluster/submit.py):
  barrier, collective, barrier_stall, host_index — a degraded query's
  trace shows WHICH phase ate the time on the node that served it.

Sampling: `VPROXY_TPU_TRACE_SAMPLE` = N samples 1-in-N (0 = off, the
default). Knob-off cost is one branch per site. Two deciders:

* `maybe_sample()` — deterministic counter-based 1-in-N (the accept
  paths; every Nth request).
* `sampled_key(key)` — seeded hash decision, value-stable across
  processes (FNV-1a 64 over `VPROXY_TPU_TRACE_SEED` + key — the
  VPROXY_TPU_FAILPOINT_SEED idiom: the same key samples identically on
  every host, so a fleet traces the same request end to end).

Trace ids: python allocates ODD ids, the C lane plane allocates EVEN
ids (one atomic each) — no coordination, no collisions. Timestamps are
CLOCK_MONOTONIC nanoseconds on both sides (time.monotonic_ns() and
clock_gettime share the clock on linux), so cross-plane spans in one
trace order consistently.

`Span(tid, plane, span)` ... `Span.end(**fields)` times a block on
that clock and adds `cpu_ns`, the thread's CPU time over it (wall minus
CPU is time spent waiting for the interpreter lock or descheduled).
Where the thread CPU clock moves in scheduler ticks, a single span's
`cpu_ns` is 0 or a tick: read it only as a sum over many spans. While a
torch profiler records in the process (`torch.autograd.profiler`'s
flag), the block is also a `torch.profiler.record_function(
"<plane>/<span>")` range: a profiler trace of the program (every thread
recorded: `_ExperimentalConfig(profile_all_threads=True)`) holds those
spans as `user_annotation` events on the device trace's own clock,
beside the copies and kernels they launched. A site opens one only for
a nonzero trace id (`Span(...) if tid else None`), so untraced it reads
no clock.

The ClassifyService dispatcher's batch cycle, in the `engine` plane.
Per-batch spans go on the batch's first sampled request:

| span | where | per | fields |
| --- | --- | --- | --- |
| `submit` | `ClassifyService._submit`, on the submitting thread: the queue lock, the request, the dispatcher's wake-up | sampled request | `kind`, `cpu_ns` |
| `dispatcher_idle` | `_run`'s wait for work | the next wake with a sampled request | `idle_ns`, `waits`, `since_ns` |
| `encode` | the host encode of a batch (`_fused_hint_q`, `_cidr_q`, the other backends' encoders) | batch | `batch`, `cpu_ns` |
| `flow_slots` | `_fused_slots`: a classify+pick batch's Maglev slots | batch | `batch`, `cpu_ns` |
| `upload` | `_upload_q`: the batch's query arrays to the serving device | batch | `copies`, `bytes`, `cpu_ns` |
| `dispatch` | encode + slots + upload + launch | batch | `kind`, `batch`, `cpu_ns` |
| `d2h_sync` | the pull of a batch's answers | batch | `kind`, `batch`, `cpu_ns` |
| `deliver` | `_deliver`: the batch's latency records, a closure a query, one hand-off a loop (`run_batch_on_loop`); `handoffs` counts those plus the callbacks run inline | batch | `kind`, `batch`, `handoffs`, `cpu_ns` |
| `callback_wait` | the hand-off of its batch to its loop -> the callback starts there | sampled request | `kind` |
| `callback` | the callback's run on its loop | sampled request | `kind`, `cpu_ns` |

`dispatcher_idle` is the last wait's own interval; `idle_ns` sums every
wait since the previous such span (`waits` of them, the first from
`since_ns`), those that woke for batches with no sampled request
included. Untraced, a submit costs the trace-id check it always had;
a batch one check in `_run`, one in each of `_begin_uniform` and
`_finish_inflight`, a thread-local read of the bound id in each of its
host phases (encode, slots, upload) and a test of `deliver`'s (None)
span a query: no clock read, lock or allocation.

Surfaces: `GET /trace` (inspection server + HTTP controller),
`list[-detail] trace` and the bare `trace <id>` line on every command
surface, `tools/traceview.py` for offline artifacts, and the
`bench.py --trace` stage committing the per-stage attribution table.

The port's copy of vproxy_tpu/utils/trace.py, same names and behaviour.
"""
from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from collections import OrderedDict
from typing import Optional

SAMPLE = int(os.environ.get("VPROXY_TPU_TRACE_SAMPLE", "0") or 0)
SEED = os.environ.get("VPROXY_TPU_TRACE_SEED", "")
# bounded: at most this many live traces; evicting a trace counts its
# spans as dropped (ring="py") — bounded memory, never silent loss
MAX_TRACES = int(os.environ.get("VPROXY_TPU_TRACE_BUF", "512"))
MAX_SPANS_PER_TRACE = 256

PLANES = ("lane", "accept", "engine", "install", "cluster")

_lock = threading.Lock()
_traces: "OrderedDict[int, list]" = OrderedDict()
_plane_spans = {p: 0 for p in PLANES}
_py_dropped = 0
_id_seq = itertools.count(0)
_sample_seq = itertools.count(0)
_tls = threading.local()


def sample_every() -> int:
    return SAMPLE


def enabled() -> bool:
    return SAMPLE > 0


def configure(n: int) -> None:
    """Set the sampling knob at runtime (bench/test hook; production
    uses the env). Pushes the knob into the C lane plane too, so C
    sampling and python sampling flip together."""
    global SAMPLE
    SAMPLE = int(n)
    try:
        from ..net import vtl
        if hasattr(vtl, "trace_set_sample"):
            vtl.trace_set_sample(SAMPLE)
    except Exception:
        pass  # py provider / pre-trace .so: python-plane tracing only


def fnv64(data: bytes) -> int:
    """FNV-1a 64 (the maglev/flow-cache hash idiom) — value-stable
    across processes, unlike PYTHONHASHSEED-randomized hash()."""
    h = 14695981039346656037
    for b in data:
        h ^= b
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


def sampled_key(key) -> bool:
    """Seeded, value-stable 1-in-N decision for `key` (bytes or str):
    the same (seed, key) decides identically in every process — the
    VPROXY_TPU_FAILPOINT_SEED reproducibility contract, trace form."""
    if SAMPLE <= 0:
        return False
    if SAMPLE == 1:
        return True
    kb = key if isinstance(key, (bytes, bytearray)) else str(key).encode()
    return fnv64(SEED.encode() + b"\x00" + bytes(kb)) % SAMPLE == 0


def new_trace_id() -> int:
    """Fresh python-plane trace id (odd; the C lane plane allocates
    even ids from its own atomic — disjoint by construction)."""
    return (next(_id_seq) << 1) | 1


def maybe_sample() -> int:
    """Deterministic counter-based 1-in-N: a fresh trace id for every
    Nth call, 0 otherwise. The accept paths' decider."""
    if SAMPLE <= 0:
        return 0
    if next(_sample_seq) % SAMPLE:
        return 0
    return new_trace_id()


# ------------------------------------------------------------- context

class bind:
    """Context manager pushing `tid` as the current trace context for
    this thread (no-op for tid=0): spans recorded by downstream code
    (engine launch markers, installer phases) attach to the request
    that triggered them."""

    __slots__ = ("tid",)

    def __init__(self, tid: int):
        self.tid = tid

    def __enter__(self):
        if self.tid:
            stack = getattr(_tls, "stack", None)
            if stack is None:
                stack = _tls.stack = []
            stack.append(self.tid)
        return self.tid

    def __exit__(self, *exc):
        if self.tid:
            _tls.stack.pop()
        return False


def current_id() -> int:
    """The calling thread's active trace id, 0 when none (one getattr
    + a truthiness check when tracing never bound on this thread)."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else 0


# -------------------------------------------------------------- buffer

def record_span(trace_id: int, plane: str, span: str, t_start_ns: int,
                dur_ns: int, **fields) -> None:
    """Append one span (any thread). Bounded: trace eviction and
    per-trace span caps count into the py drop tally, never block."""
    global _py_dropped
    if not trace_id:
        return
    ev = {"trace": trace_id, "plane": plane, "span": span,
          "t_ns": int(t_start_ns), "dur_ns": int(dur_ns)}
    if fields:
        ev.update(fields)
    with _lock:
        spans = _traces.get(trace_id)
        if spans is None:
            if len(_traces) >= MAX_TRACES:
                _, evicted = _traces.popitem(last=False)
                _py_dropped += len(evicted)
            spans = _traces[trace_id] = []
        if len(spans) >= MAX_SPANS_PER_TRACE:
            _py_dropped += 1
            return
        spans.append(ev)
        _plane_spans[plane] = _plane_spans.get(plane, 0) + 1


class Span:
    """One open span of `plane`/`span` on trace `trace_id` (nonzero) on
    the calling thread. end() records it with `cpu_ns`: the
    thread's CPU time over the block, read inside the wall-clock pair so
    cpu_ns <= dur_ns where the thread CPU clock is exact (where it moves
    in scheduler ticks, as on some VMs, only sums over many spans mean
    anything). While a torch profiler records in the process
    (torch.autograd.profiler's flag, read once a span), the block is also a
    record_function range named "<plane>/<span>", opened before the
    clocks are read and closed after, so the range holds the span. A
    span whose end() is never reached (the block raised) is not
    recorded."""

    __slots__ = ("tid", "plane", "span", "t0", "c0", "rf")

    def __init__(self, trace_id: int, plane: str, span: str):
        self.tid, self.plane, self.span = trace_id, plane, span
        self.rf = None
        prof = sys.modules.get("torch.autograd.profiler")
        if prof is not None and getattr(prof, "_is_profiler_enabled", 0):
            self.rf = prof.record_function(f"{plane}/{span}")
            self.rf.__enter__()
        self.t0 = time.monotonic_ns()
        self.c0 = time.thread_time_ns()

    def end(self, **fields) -> None:
        c1 = time.thread_time_ns()
        t1 = time.monotonic_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        record_span(self.tid, self.plane, self.span, self.t0, t1 - self.t0,
                    cpu_ns=c1 - self.c0, **fields)


def ingest_lane_recs(recs) -> None:
    """Fold drained C TraceRecs ((trace_id, t_start_ns, dur_ns, aux,
    lane, span, flags, err) tuples, net/vtl.py trace_drain shape) into
    the buffer. Called from the lane threads (components/lanes.py)."""
    from ..net.vtl import TRACE_SPANS
    for tid, t_ns, dur_ns, aux, lane, span, flags, err in recs:
        name = TRACE_SPANS[span] if span < len(TRACE_SPANS) \
            else f"span{span}"
        fields = {"lane": lane}
        if name == "splice":
            fields["bytes"] = aux
        elif name == "punt":
            fields["kind"] = "connect_fail" if aux else "classic"
        if err:
            fields["err"] = err
        record_span(tid, "lane", name, t_ns, dur_ns, **fields)


def plane_spans_total(plane: str) -> int:
    return _plane_spans.get(plane, 0)


def py_dropped_total() -> int:
    return _py_dropped


def reset() -> None:
    """Test hook: drop every buffered trace (counters stay — they are
    process-lifetime totals, like every other /metrics series)."""
    with _lock:
        _traces.clear()


# ------------------------------------------------------------- queries

def get_trace(trace_id: int) -> list:
    """All spans of one trace, start-time ordered ([] when unknown)."""
    with _lock:
        spans = list(_traces.get(trace_id, ()))
    return sorted(spans, key=lambda s: (s["t_ns"], s["dur_ns"]))


def trace_ids(last: int = 0) -> list:
    with _lock:
        ids = list(_traces.keys())
    return ids[-last:] if last > 0 else ids


def summaries(last: int = 64) -> list:
    """Newest-last trace summaries: id, span count, planes touched,
    end-to-end ns (max span end - min span start)."""
    out = []
    with _lock:
        items = list(_traces.items())[-last:] if last > 0 \
            else list(_traces.items())
    for tid, spans in items:
        if not spans:
            continue
        t0 = min(s["t_ns"] for s in spans)
        t1 = max(s["t_ns"] + s["dur_ns"] for s in spans)
        out.append({"trace": tid, "spans": len(spans),
                    "planes": sorted({s["plane"] for s in spans}),
                    "total_us": round((t1 - t0) / 1000.0, 1)})
    return out


def waterfall(trace_id: int, width: int = 48) -> list:
    """Text waterfall for one trace (the `trace <id>` command): one bar
    per span, offset/scaled to the trace's own [t0, t1] window."""
    spans = get_trace(trace_id)
    if not spans:
        return [f"trace {trace_id}: not found (evicted or never sampled)"]
    return render_spans(trace_id, spans, width)


def render_spans(trace_id, spans: list, width: int = 48) -> list:
    """Waterfall renderer over raw span dicts — shared by the live
    `trace <id>` command and tools/traceview.py (offline artifacts)."""
    spans = sorted(spans, key=lambda s: (s["t_ns"], s["dur_ns"]))
    t0 = min(s["t_ns"] for s in spans)
    t1 = max(s["t_ns"] + s["dur_ns"] for s in spans)
    total = max(1, t1 - t0)
    out = [f"trace {trace_id}  total {total / 1000.0:.1f}us  "
           f"spans {len(spans)}"]
    for s in spans:
        off = int((s["t_ns"] - t0) * width / total)
        w = max(1, int(s["dur_ns"] * width / total))
        w = min(w, width - off) if off < width else 1
        bar = " " * min(off, width - 1) + "#" * w
        extras = " ".join(
            f"{k}={s[k]}" for k in sorted(s)
            if k not in ("trace", "plane", "span", "t_ns", "dur_ns"))
        out.append(f"  [{bar:<{width}}] {s['plane']:>7}/{s['span']:<14} "
                   f"+{(s['t_ns'] - t0) / 1000.0:9.1f}us "
                   f"{s['dur_ns'] / 1000.0:9.1f}us"
                   + (f"  {extras}" if extras else ""))
    return out


def slowest(n: int = 8) -> list:
    """The n slowest buffered traces, spans attached — the worst-trace
    dump shape shared by the bench --trace stage, storm and chaos
    reports (docs/observability.md)."""
    worst = sorted(summaries(last=0), key=lambda t: t["total_us"],
                   reverse=True)[:n]
    return [dict(t, spans=get_trace(t["trace"])) for t in worst]


def stage_table(span_filter=None) -> dict:
    """Per-(plane, span) duration percentiles over every buffered
    trace — the bench attribution table's source. -> {"plane/span":
    {"n", "p50_us", "p99_us"}}."""
    by: dict[str, list] = {}
    with _lock:
        all_spans = [s for spans in _traces.values() for s in spans]
    for s in all_spans:
        key = f"{s['plane']}/{s['span']}"
        if span_filter is not None and not span_filter(s):
            continue
        by.setdefault(key, []).append(s["dur_ns"] / 1000.0)
    out = {}
    for key, durs in sorted(by.items()):
        durs.sort()
        n = len(durs)
        out[key] = {"n": n,
                    "p50_us": round(durs[n // 2], 1),
                    "p99_us": round(durs[min(n - 1, (n * 99) // 100)], 1)}
    return out
