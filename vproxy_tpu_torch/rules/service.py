"""ClassifyService — the cross-connection micro-batching dispatch queue.

The port of `vproxy_tpu/rules/service.py` for the hint, cidr and
classify+pick kinds. Data-plane code never dispatches the device per
connection; it enqueues a query with a callback and the service
coalesces everything that arrives while the previous device batch is in
flight into ONE dispatch ("natural batching": the dispatch latency
itself is the batch window, so the queue adapts from batch=1 at idle to
hundreds under load with no timer). Kinds:

* "hint"  — submit_hint: a HintMatcher verdict (the path
            Upstream.next_async takes on every accept);
* "cidr"  — submit_cidr: a CidrMatcher first match (route lookups, and
            the ACL gate SecurityGroup.allow_async puts on a
            connection), ONE launch of the CIDR kernel per batch
            (ops/cidr_cuda.py); port=None queries (no port gate) never
            share a device batch with port-carrying ones;
* "cpick" — submit_classify_pick: verdict AND Maglev pick from a
            maglev.FusedPair, ONE fused launch per batch (the hand CUDA
            kernel on the GPU, ops/fused_cuda.py); the unfused backends
            ("torch-fp", "torch-dense") launch their hint kernel (B6,
            B9) and the Maglev take (B5, ops/take_cuda.py).

Dispatch-path policy (mode = VPROXY_TPU_CLASSIFY, default "auto"):

* "auto"   — a flushed batch goes to the device when it has >= 2 queries
             (micro-batch) or the table is big (> SMALL_TABLE rules);
             lone queries take the host path.
* "device" — every flushed batch goes to the device (tests and
             benchmarks force the device path end-to-end with it).
* "host"   — pure oracle (latency floor; also the correctness baseline).

Inline fast lane (VPROXY_TPU_INLINE_LONE, default on): in "auto" mode a
LONE query with nothing pending for its matcher is answered INLINE on
the submitting thread from the snapshot's O(probes) host index
(rules/index.py — exact, winner bit-for-bit vs the oracle): no
dispatcher-thread hop, no device round trip. Micro-batches (n >= 2)
always ride the device. With the lane off, the latency-budget policy
applies (VPROXY_TPU_CLASSIFY_BUDGET_US, default 5000; 0 = off): lone
big-table queries ride the device while its EWMA stays within budget.
Either way the device EWMA is kept live by OFF-PATH probes: every
PROBE_EVERY-th inline-served lone query (at most one per
VPROXY_TPU_PROBE_MIN_S seconds) hands the persistent probe worker a
synthetic device dispatch, so real accept-path queries never pay the
probe; the service shrinks the interpreter's GIL slice
(VPROXY_TPU_GIL_SLICE_MS, default 1ms) so a probe mid-dispatch delays an
inline answer by about one slice at most.

Every delivered query records submit->delivery latency;
stats.latency_percentiles() surfaces p50/p99.

Failure containment: if a device dispatch raises (an injected
`device.dispatch.error`, an encode fault), the service logs one alarm,
serves that batch and everything after it from the host index, and
re-probes the device every RETRY_S seconds. Accepts never die with a
classify backtrace. A KernelError is different: a CUDA kernel could
not be built, loaded or launched, or the card faulted while
producing a result. The card cannot serve then, and the host does not
quietly take over: the service logs it, answers the batches it holds
with -1 ("no match") so callers proceed, closes, and every later submit
raises the error (`ClassifyService.error`). That holds for every kind:
the fused kernel (cpick), B3 (hint) and the CIDR kernel (cidr) alike,
and the kernels of the unfused backends (B5-B7, B9).
On the card every fault of a device dispatch is a KernelError
(`_card_error`): the failover above is for the CPU tiers only. Device
results reach the host only through utils/torchenv.to_host (a CUDA
tensor cannot be np.asarray()ed — a raise there would quietly fail
every batch over to the host).

Batch shapes are padded to power-of-two buckets (min VPROXY_TPU_PAD_LO,
default 4) at the ARRAY level: only the real queries pay the host-side
encode; pad rows are invalid-probe fills that can never match.

The dispatcher is DOUBLE-BUFFERED: a device batch is submitted
asynchronously and the dispatcher goes straight back to draining the
queue — the next batch's encode overlaps the previous batch's device
work, and the previous result is pulled (one host round trip per
batch) just before delivery.

Callbacks are delivered on the submitting event loop via run_on_loop();
submissions without a loop get the callback on the dispatcher thread.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

import numpy as np

import torch

from ..ops.fused_cuda import KernelError
from ..utils import sketch, trace
from ..utils.log import Logger
from ..utils.torchenv import to_host
from .engine import SMALL_TABLE, pad_batch
from .ir import Hint

_log = Logger("classify")

RETRY_S = float(os.environ.get("VPROXY_TPU_DEVICE_RETRY_S", "5"))
PAD_LO = int(os.environ.get("VPROXY_TPU_PAD_LO", "4"))
BUDGET_US = float(os.environ.get("VPROXY_TPU_CLASSIFY_BUDGET_US", "5000"))
INLINE_LONE = os.environ.get("VPROXY_TPU_INLINE_LONE", "1") != "0"
PROBE_EVERY = 32     # re-probe the non-preferred lone-query path
PROBE_MIN_S = float(os.environ.get("VPROXY_TPU_PROBE_MIN_S", "0.25"))
GIL_SLICE_MS = float(os.environ.get("VPROXY_TPU_GIL_SLICE_MS", "1"))
LAT_RESERVOIR = 4096  # submit->delivery latency samples kept

_gil_slice_applied = False


def _apply_gil_slice() -> None:
    """Shrink the interpreter's thread-switch interval (once, process-
    wide, never loosening an even smaller configured value): a GIL-
    holding device probe can then only delay an inline accept-path
    answer by ~one slice instead of CPython's default 5ms (multi-ms
    p999 spikes otherwise)."""
    global _gil_slice_applied
    if _gil_slice_applied or GIL_SLICE_MS <= 0:
        return
    _gil_slice_applied = True
    import sys
    want = GIL_SLICE_MS / 1000.0
    if want < sys.getswitchinterval():
        sys.setswitchinterval(want)


class _Req:
    __slots__ = ("payload", "cb", "loop", "t0", "tid")

    def __init__(self, payload, cb, loop):
        self.payload = payload
        self.cb = cb
        self.loop = loop
        self.t0 = time.monotonic()
        # the submitter's trace context rides the request so the
        # dispatcher thread can attach its spans (queue wait, dispatch,
        # d2h sync) to the sampled request that triggered them
        self.tid = trace.current_id()


class _Inflight:
    """One async-submitted device batch awaiting its sync + delivery
    (the dispatcher's double buffer slot)."""

    __slots__ = ("kind", "matcher", "reqs", "snap", "arr", "t0",
                 "lone_big")

    def __init__(self, kind, matcher, reqs, snap, arr, t0, lone_big):
        self.kind = kind
        self.matcher = matcher
        self.reqs = reqs
        self.snap = snap
        self.arr = arr
        self.t0 = t0
        self.lone_big = lone_big


class ClassifyStats:
    """Counters surfaced via utils/metrics GlobalInspection."""

    def __init__(self):
        self.queries = 0          # total submitted
        self.dispatches = 0       # device batches dispatched
        self.device_queries = 0   # queries answered by the device
        self.oracle_queries = 0   # queries answered by the host oracle
        self.failovers = 0        # device errors that degraded a batch
        self.max_batch = 0
        self.budget_reroutes = 0  # lone queries sent to oracle by budget
        self.inline_fast = 0      # lone queries served by the fast lane
        # device batches per kind: kind -> [batches, queries, max batch]
        self.by_kind: dict[str, list[int]] = {}
        # counter read-modify-writes go through `lock` (writers are the
        # dispatcher thread AND every inline-answering submit thread)
        self.lock = threading.Lock()
        # submit->delivery latency rides the process-global histogram
        # (utils/metrics): log2 buckets on /metrics as
        # vproxy_classify_latency_us_{bucket,sum,count}. That series
        # survives ClassifyService.reset() — it is per-process, like the
        # /metrics surface it feeds. A second, UNregistered histogram
        # keeps this instance's own exact reservoir window, so the
        # p99-contract percentiles of a fresh service (bench runs one
        # per contract) are not polluted by a previous instance's
        # samples still sitting in a shared ring.
        from ..utils.metrics import GlobalInspection, Histogram
        self.lat_hist = GlobalInspection.get().get_histogram(
            "vproxy_classify_latency_us", reservoir=LAT_RESERVOIR)
        self._lat_local = Histogram("classify_latency_local_us",
                                    reservoir=LAT_RESERVOIR)

    def note_batch(self, kind: str, n: int) -> None:
        """One device batch of n queries of `kind` (caller holds lock)."""
        k = self.by_kind.setdefault(kind, [0, 0, 0])
        k[0] += 1
        k[1] += n
        k[2] = max(k[2], n)

    def bump(self, name: str, n: int = 1) -> None:
        with self.lock:
            setattr(self, name, getattr(self, name) + n)

    def record_latency(self, seconds: float) -> None:
        us = seconds * 1e6
        self.lat_hist.observe(us)
        self._lat_local.observe(us)

    def latency_percentiles(self) -> Optional[dict]:
        """p50/p99/p999 submit->delivery latency in us (exact over this
        instance's reservoir window)."""
        pct = self._lat_local.percentiles((50.0, 99.0, 99.9))
        if pct is None:
            return None
        return {"n": pct["n"], "p50_us": pct["p50"],
                "p99_us": pct["p99"], "p999_us": pct["p999"]}

    def snapshot(self) -> dict:
        d = {k: getattr(self, k) for k in (
            "queries", "dispatches", "device_queries", "oracle_queries",
            "failovers", "max_batch", "budget_reroutes", "inline_fast")}
        lat = self.latency_percentiles()
        if lat is not None:
            d["latency_p50_us"] = round(lat["p50_us"], 1)
            d["latency_p99_us"] = round(lat["p99_us"], 1)
        return d


class ClassifyService:
    _instance: Optional["ClassifyService"] = None
    _instance_lock = threading.Lock()

    @classmethod
    def get(cls) -> "ClassifyService":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        """Test hook: drop the singleton (a new one lazily respawns)."""
        with cls._instance_lock:
            inst, cls._instance = cls._instance, None
        if inst is not None:
            inst.close()

    def __init__(self, mode: Optional[str] = None):
        self.mode = mode or os.environ.get("VPROXY_TPU_CLASSIFY", "auto")
        self.retry_s = RETRY_S
        self.budget_us = BUDGET_US
        self.inline_lone = INLINE_LONE
        _apply_gil_slice()
        # lone-query EWMA latency (us) per path, None until first sample
        self._ewma = {"device": None, "oracle": None}
        self._elock = threading.Lock()
        self._lone_seen = 0
        self._probe_last = 0.0  # monotonic ts of the last spawned probe
        # persistent probe worker: the inline accept path only hands it
        # a request + notify (~1us); spawning a Thread per probe costs
        # ~200us and was visible in the accept-path p99
        self._probe_req: Optional[tuple] = None
        self._probe_cv = threading.Condition()
        self._probe_thread: Optional[threading.Thread] = None
        self.stats = ClassifyStats()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # key -> (kind, matcher, list[_Req]); key identifies the matcher
        self._pending: dict[int, tuple[str, object, list[_Req]]] = {}
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # the KernelError that closed the service (None while serving)
        self.error: Optional[KernelError] = None
        self._device_down_until = 0.0

    # ------------------------------------------------------------- submit

    def submit_hint(self, matcher, hint: Hint,
                    cb: Callable[[int, object], None], loop=None) -> None:
        """Queue one hint classify; cb(rule_idx, payload) with idx=-1 for
        no match and payload = the matcher generation's attached object
        (Upstream registers its GroupHandle list there so idx is always
        interpreted against the generation that produced it)."""
        self._submit("hint", matcher, hint, cb, loop)

    def submit_cidr(self, matcher, addr: bytes, port: Optional[int],
                    cb: Callable[[int, object], None], loop=None) -> None:
        """Queue one route/ACL lookup; cb(first-match idx, payload), -1
        for none. port=None skips ACL port-range gating entirely."""
        self._submit("cidr", matcher, (addr, port), cb, loop)

    def submit_classify_pick(self, pair, hint: Hint, ip: bytes,
                             port: Optional[int],
                             cb: Callable[[int, int, object], None],
                             loop=None) -> None:
        """Queue one fused classify+pick against a maglev.FusedPair:
        cb(verdict_idx, pick_idx, (hint_payload, maglev_payload)).
        Micro-batches ride the fused ONE-launch program
        (rules/engine.fused_dispatch); lone queries take the inline
        host lane (hint index + O(1) maglev read), same fast-lane
        policy as plain hint submits. port=None = source affinity
        (the shared Maglev hash contract)."""
        self._submit("cpick", pair, (hint, ip, port), cb, loop)

    def _submit(self, kind: str, matcher, payload, cb, loop) -> None:
        inline = False
        with self._cv:
            if self.error is not None:
                raise self.error
            if self._closed:
                raise OSError("ClassifyService is closed")
            self.stats.queries += 1
            key = id(matcher)
            ent = self._pending.get(key)
            if ent is None and self._inline_host(matcher):
                inline = True  # answered below, outside the lock
            elif ent is None:
                self._pending[key] = (kind, matcher, [_Req(payload, cb, loop)])
            else:
                ent[2].append(_Req(payload, cb, loop))
            if not inline:
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._run, name="classify-dispatch",
                        daemon=True)
                    self._thread.start()
                self._cv.notify()
        if inline:
            self._answer_inline(kind, matcher, payload, cb, loop)

    def _inline_host(self, matcher) -> bool:
        """Lone query, nothing pending for this matcher: answer it
        synchronously on the submitting thread from the host index. With
        the fast lane on (default) this is the first-class path for
        EVERY lone query in auto mode — the O(probes) index gives the
        same winner as the oracle at ~us cost, so there is nothing a
        device round trip could add but latency. With the lane off, the
        budget gates apply: small table (the oracle crossover),
        device marked down, or the budget policy preferring the host.
        Called under the lock; must stay O(1)."""
        if self.mode != "auto":
            return False
        if getattr(matcher, "backend", "host") == "host":
            return True
        if time.monotonic() < self._device_down_until:
            return True
        if matcher.size() <= SMALL_TABLE:
            return True
        if self.inline_lone:
            self.stats.inline_fast += 1
            return True
        if self.budget_us <= 0:
            return False
        dev = self._ewma["device"]
        if dev is None or dev <= self.budget_us:
            return False          # ride the device (measures the EWMA)
        self.stats.budget_reroutes += 1
        return True

    def _answer_inline(self, kind: str, matcher, payload, cb, loop) -> None:
        """Serve one lone query from the snapshot's host index, inline.
        Every PROBE_EVERY-th rerouted query also hands the off-path
        probe worker a request so the device EWMA tracks current
        conditions without any real query eating the probe cost.
        Delivery keeps the loop-confinement contract: run_on_loop runs
        the callback immediately when the submitter IS the loop thread
        (the accept path — fully synchronous), else queues it there."""
        t0 = time.monotonic()
        tid = trace.current_id()
        snap = matcher.snapshot()
        # a host-backend matcher has no device to probe (and its
        # dispatch_snap is the O(rules) oracle — exactly the GIL-holding
        # scan the probe worker must never run)
        big = (matcher.size() > SMALL_TABLE
               and getattr(matcher, "backend", "host") != "host")
        try:
            if kind == "cidr":
                i = matcher.index_snap(snap, payload[0], payload[1])
            else:
                # cpick: the FusedPair host lane -> (verdict, pick)
                i = matcher.index_snap(snap, payload)
        except MemoryError:
            raise
        except Exception:
            _log.error("inline classify failed; delivering no-match",
                       exc=True)
            i = (-1, -1) if kind == "cpick" else -1
        dt = time.monotonic() - t0
        if tid:
            trace.record_span(tid, "engine", "classify_inline",
                              int(t0 * 1e9), int(dt * 1e9), kind=kind)
        st = self.stats
        with st.lock:
            st.oracle_queries += 1
            st.max_batch = max(st.max_batch, 1)
        st.record_latency(dt)
        if big:
            self._note_lone_latency("oracle", dt)
            with self._elock:
                self._lone_seen += 1
                now = time.monotonic()
                probe = (self._lone_seen % PROBE_EVERY == 0
                         and now - self._probe_last >= PROBE_MIN_S)
                if probe:
                    self._probe_last = now
            if probe and self.device_ok():
                self._spawn_probe(kind, matcher, payload)
        pl = matcher.snap_payload(snap)
        if kind == "cpick":
            v, p = int(i[0]), int(i[1])

            def run(cb=cb, v=v, p=p, pl=pl) -> None:
                try:
                    cb(v, p, pl)
                except MemoryError:
                    raise
                except Exception:
                    _log.error("classify callback failed", exc=True)
        else:
            i = int(i)

            def run(cb=cb, i=i, pl=pl) -> None:
                try:
                    cb(i, pl)
                except MemoryError:
                    raise
                except Exception:
                    _log.error("classify callback failed", exc=True)

        if loop is None or not loop.run_on_loop(run):
            run()

    def _spawn_probe(self, kind: str, matcher, payload) -> None:
        """Hand (kind, matcher, payload) to the persistent probe worker;
        at most one probe in flight (a slow device must not queue up),
        and the accept path pays only a notify."""
        with self._probe_cv:
            if self._probe_req is not None:
                return
            self._probe_req = (kind, matcher, payload)
            if self._probe_thread is None:
                self._probe_thread = threading.Thread(
                    target=self._probe_run, name="classify-probe",
                    daemon=True)
                self._probe_thread.start()
            self._probe_cv.notify()

    def _probe_run(self) -> None:
        while True:
            with self._probe_cv:
                while self._probe_req is None:
                    if self._closed:
                        return
                    self._probe_cv.wait(1.0)
                kind, matcher, payload = self._probe_req
            try:
                # chunked, deliberately-yielding dispatch: the probe is
                # background work sharing the GIL with the inline accept
                # path, so it gives the scheduler an explicit preemption
                # point before each GIL-heavy phase (encode, dispatch)
                time.sleep(0)
                snap = matcher.snapshot()
                time.sleep(0)
                t0 = time.monotonic()
                # pad exactly like real dispatches: the probe must time
                # the SAME batch shape they run
                self._probe_dispatch(kind, matcher, snap, payload)
                self._note_lone_latency("device", time.monotonic() - t0)
            except MemoryError:
                raise
            except KernelError as e:
                self._kernel_failed(e, kind, [])
            except Exception as e:
                ke = _card_error(matcher, e)
                if ke is not None:
                    self._kernel_failed(ke, kind, [])
                    continue
                self.stats.bump("failovers")
                self._device_down_until = time.monotonic() + self.retry_s
                _log.alert(f"device probe failed ({e!r}); device marked "
                           f"down for {self.retry_s:.0f}s")
                from ..utils import events
                events.record("classify_failover",
                              f"device probe failed: {e!r}",
                              retry_s=self.retry_s)
            finally:
                with self._probe_cv:
                    self._probe_req = None

    def _probe_dispatch(self, kind: str, matcher, snap, payload):
        return self._device_batch(kind, matcher, snap,
                                  [_Req(payload, None, None)])

    # ---------------------------------------------------------- dispatcher

    def _run(self) -> None:
        # double-buffered: at most ONE device batch in flight while the
        # next one encodes/submits; the in-flight result syncs just
        # before its delivery (one host round trip per batch)
        inflight: Optional[_Inflight] = None
        while True:
            with self._cv:
                while not self._pending and not self._closed \
                        and inflight is None:
                    self._cv.wait()
                batches = list(self._pending.values())
                self._pending.clear()
                closed = self._closed
            if not batches:
                if inflight is not None:
                    self._finish_guarded(inflight)
                    inflight = None
                    continue
                if closed:
                    return
                continue
            for kind, matcher, reqs in batches:
                for part in self._split_uniform(kind, reqs):
                    nxt = None
                    if self.error is not None:  # closed by a KernelError
                        self._deliver_nomatch(part, kind)
                        continue
                    try:
                        nxt = self._begin_uniform(kind, matcher, part)
                    except MemoryError:
                        raise  # OOM contract: log-then-die (utils/oom)
                    except KernelError as e:
                        self._kernel_failed(e, kind, part)
                    except Exception:
                        # the dispatcher thread must survive ANY
                        # per-batch error (incl. oracle/delivery bugs)
                        # — a dead thread would strand every future
                        # classify silently. Callbacks get -1 ("no
                        # match") so callers proceed.
                        _log.error("classify dispatch failed; delivering "
                                   "no-match to batch", exc=True)
                        self._deliver_nomatch(part, kind)
                    if inflight is not None:
                        # deliver the PREVIOUS batch now that the next
                        # one is already on the device
                        self._finish_guarded(inflight)
                        inflight = None
                    inflight = nxt

    def _use_device(self, matcher, n: int) -> bool:
        if self.mode == "host" or getattr(matcher, "backend", "host") == "host":
            return False
        if time.monotonic() < self._device_down_until:
            return False
        if self.mode == "device":
            return True
        # auto: micro-batches always ride the device; lone queries only
        # when the table is past the oracle's crossover size
        if n >= 2:
            return True
        if matcher.size() <= SMALL_TABLE:
            return False
        return self._lone_path_is_device()

    def _lone_path_is_device(self) -> bool:
        """Budget policy for a lone query that reached the dispatcher
        (the inline gate already served budget-rerouted ones): ride the
        device while it is unmeasured or within budget."""
        if self.budget_us <= 0:
            return True
        dev = self._ewma["device"]
        return dev is None or dev <= self.budget_us

    def _note_lone_latency(self, path: str, seconds: float) -> None:
        # writers: inline submit threads, the probe worker, and the
        # dispatcher — the EWMA read-modify-write needs the lock
        us = seconds * 1e6
        with self._elock:
            cur = self._ewma[path]
            self._ewma[path] = us if cur is None else 0.8 * cur + 0.2 * us

    @staticmethod
    def _split_uniform(kind: str, reqs: list[_Req]) -> list[list[_Req]]:
        if kind == "cidr":
            # port=None means "ignore port ranges" and must NOT share a
            # device batch with port-carrying queries (it would be
            # coerced to port 0 and gated against the ACL ranges)
            with_p = [r for r in reqs if r.payload[1] is not None]
            without = [r for r in reqs if r.payload[1] is None]
            if with_p and without:
                return [with_p, without]
        return [reqs]

    def _begin_uniform(self, kind: str, matcher,
                       reqs: list[_Req]) -> Optional["_Inflight"]:
        """Submit one uniform batch: device batches go out ASYNC and
        return an _Inflight for _finish_inflight to sync+deliver; host
        batches deliver here and return None."""
        n = len(reqs)
        with self.stats.lock:  # inline submit threads write stats too
            self.stats.max_batch = max(self.stats.max_batch, n)
        snap = matcher.snapshot()  # ONE generation for device/oracle/payload
        lone_big = n == 1 and matcher.size() > SMALL_TABLE
        if sketch.ON:
            # device-plane attribution: which upstream's classify load
            # is filling the batches (routes dim, `upstream:<alias>`
            # keys, weight = batch occupancy)
            own = getattr(matcher, "owner_alias", None)
            if own:
                sketch.update("routes", f"upstream:{own}", n,
                              plane="engine")
        # sampled requests in the batch: batch-shared phases (dispatch,
        # d2h sync, host_index) attach to the FIRST one — one span, not
        # one per request; per-request queue wait is recorded for every
        # sampled request on BOTH serving branches
        tids = [r.tid for r in reqs if r.tid]
        if tids:
            t_q = time.monotonic()
            for r in reqs:
                if r.tid:
                    trace.record_span(
                        r.tid, "engine", "queue_wait",
                        int(r.t0 * 1e9), int((t_q - r.t0) * 1e9),
                        kind=kind)
        if self._use_device(matcher, n):
            try:
                t0 = time.monotonic()
                with trace.bind(tids[0] if tids else 0):
                    # the bind makes engine-level launch markers
                    # (rules/engine.note_launch) attach to the sampled
                    # request's trace
                    arr = self._device_submit(kind, matcher, snap, reqs)
                if tids:
                    trace.record_span(
                        tids[0], "engine", "dispatch", int(t0 * 1e9),
                        int((time.monotonic() - t0) * 1e9), kind=kind,
                        batch=n)
                return _Inflight(kind, matcher, reqs, snap, arr, t0,
                                 lone_big)
            except (MemoryError, KernelError):
                raise  # a kernel that cannot serve is never failed over
            except Exception as e:
                ke = _card_error(matcher, e)
                if ke is not None:
                    raise ke
                self._device_failed(e, n)
        t0 = time.monotonic()
        idxs = self._oracle_batch(kind, matcher, snap, reqs)
        if tids:
            trace.record_span(tids[0], "engine", "host_index",
                              int(t0 * 1e9),
                              int((time.monotonic() - t0) * 1e9),
                              kind=kind, batch=n)
        if lone_big:
            self._note_lone_latency("oracle", time.monotonic() - t0)
        self.stats.bump("oracle_queries", n)
        self._deliver(reqs, idxs, matcher.snap_payload(snap), kind=kind)
        return None

    def _finish_guarded(self, inf: "_Inflight") -> None:
        """_finish_inflight behind the dispatcher's survival guard: the
        thread must outlive ANY per-batch error (incl. oracle/delivery
        bugs) — a dead dispatcher would strand every future classify
        silently. Callbacks get -1 ("no match") so callers proceed."""
        try:
            self._finish_inflight(inf)
        except MemoryError:
            raise  # OOM contract: log-then-die, not limp (utils/oom)
        except KernelError as e:
            self._kernel_failed(e, inf.kind, inf.reqs)
        except Exception:
            _log.error("classify finish failed; delivering no-match "
                       "to batch", exc=True)
            self._deliver_nomatch(inf.reqs, inf.kind)

    def _finish_inflight(self, inf: "_Inflight") -> None:
        """Pull one in-flight device batch (the single host round trip)
        and deliver; a device error here degrades THIS batch to the
        oracle and marks the device down, same as a submit failure —
        except a CUDA fault, which raises KernelError."""
        n = len(inf.reqs)
        idxs = None
        tids = [r.tid for r in inf.reqs if r.tid]
        try:
            t_sync = time.monotonic()
            idxs = _pull(inf.arr)[:n]
            if tids:
                trace.record_span(
                    tids[0], "engine", "d2h_sync", int(t_sync * 1e9),
                    int((time.monotonic() - t_sync) * 1e9),
                    kind=inf.kind, batch=n)
            if inf.lone_big:
                self._note_lone_latency("device", time.monotonic() - inf.t0)
            with self.stats.lock:
                self.stats.dispatches += 1
                self.stats.device_queries += n
                self.stats.note_batch(inf.kind, n)
        except (MemoryError, KernelError):
            raise
        except Exception as e:
            ke = _card_error(inf.matcher, e)
            if ke is not None:
                raise ke
            self._device_failed(e, n)
        if idxs is None:
            t0 = time.monotonic()
            idxs = self._oracle_batch(inf.kind, inf.matcher, inf.snap,
                                      inf.reqs)
            if inf.lone_big:
                self._note_lone_latency("oracle", time.monotonic() - t0)
            self.stats.bump("oracle_queries", n)
        try:
            self._deliver(inf.reqs, idxs,
                          inf.matcher.snap_payload(inf.snap),
                          kind=inf.kind)
        except MemoryError:
            raise
        except Exception:
            _log.error("classify delivery failed", exc=True)

    def _kernel_failed(self, e: KernelError, kind: str,
                       reqs: list[_Req]) -> None:
        """The card cannot serve (see the module doc): close, answer
        what is held with -1, and make every later submit raise `e`."""
        with self._cv:
            first = self.error is None
            if first:
                self.error = e
            self._closed = True
            held = list(self._pending.values())
            self._pending.clear()
            self._cv.notify()
        if first:
            _log.alert(f"CUDA kernel failed ({e!r}); classify service "
                       f"closed, submits raise")
            from ..utils import events
            events.record("classify_kernel_error",
                          f"CUDA kernel failed: {e!r}", classify_kind=kind,
                          batch=len(reqs))
        self._deliver_nomatch(reqs, kind)
        for k, _m, part in held:
            self._deliver_nomatch(part, k)

    def _deliver_nomatch(self, reqs: list[_Req], kind: str) -> None:
        try:
            self._deliver(reqs, [-1] * len(reqs), kind=kind)
        except MemoryError:
            raise
        except Exception:
            _log.error("classify delivery failed", exc=True)

    def _device_failed(self, e: Exception, n: int) -> None:
        self.stats.bump("failovers")
        self._device_down_until = time.monotonic() + self.retry_s
        _log.alert(f"device classify failed ({e!r}); serving from "
                   f"host oracle, retry in {self.retry_s:.0f}s")
        from ..utils import events
        events.record("classify_failover",
                      f"device classify failed: {e!r}",
                      batch=n, retry_s=self.retry_s)

    def _device_submit(self, kind: str, matcher, snap, reqs: list[_Req]):
        """Encode + submit (NO sync): returns the async device result.
        Only the real queries are encoded — the engine pads the arrays
        to the batch bucket with can-never-match fill rows."""
        from ..utils import failpoint
        if failpoint.hit("device.dispatch.error", kind):
            # injected device fault: exercises the host-oracle failover
            # (and the down-until/re-probe machinery) deterministically
            raise RuntimeError("failpoint device.dispatch.error")
        cap = pad_batch(len(reqs), lo=PAD_LO)
        # dispatch-cost policy (the reference's): single-device
        # dispatches PIPELINE (the submit is async and the dispatcher
        # pulls the result just before delivery), while sharded
        # dispatches PARK the dispatcher (sync): their fixed cost per
        # dispatch is high enough that the natural batching window
        # matters more than overlap
        sync = getattr(matcher, "backend", "host") in (
            "torch-sharded", "torch-fp-sharded")
        if kind in ("hint", "cpick"):
            # cpick is the FusedPair's matcher interface: the same
            # dispatch_snap call, ONE launch answering verdicts AND picks
            return matcher.dispatch_snap(snap, [r.payload for r in reqs],
                                         pad_to=cap, sync=sync)
        addrs = [r.payload[0] for r in reqs]
        ports = [r.payload[1] for r in reqs]
        if ports[0] is None:  # uniform batches only (see _split_uniform)
            ports = None
        return matcher.dispatch_snap(snap, addrs, ports, pad_to=cap,
                                     sync=sync)

    def _device_batch(self, kind: str, matcher, snap, reqs: list[_Req]):
        """Synchronous submit+pull (the probe worker's path)."""
        return _pull(
            self._device_submit(kind, matcher, snap, reqs))[: len(reqs)]

    def _oracle_batch(self, kind: str, matcher, snap,
                      reqs: list[_Req]) -> list[int]:
        """Host-served batch (device down / host path): rides the
        snapshot's O(probes) index — same winner as the linear oracle
        (rules/index.py parity tests), O(table) cheaper per query."""
        if kind in ("hint", "cpick"):
            return [matcher.index_snap(snap, r.payload) for r in reqs]
        return [matcher.index_snap(snap, r.payload[0], r.payload[1])
                for r in reqs]

    def _deliver(self, reqs: list[_Req], idxs, payload=None,
                 kind: str = "hint") -> None:
        """cb(idx, payload) — or cb(verdict, pick, payload) for cpick
        batches, where a row is the fused program's (verdict, pick)
        pair (a scalar row is an error fill: both -1). payload is the
        matcher-owner's object versioned with the table generation that
        served the batch (None when the owner didn't register one).
        Callbacks run on the submitting loop; if that loop is gone,
        inline on this thread so cleanup (closing an accepted fd)
        still happens."""
        now = time.monotonic()
        for r, idx in zip(reqs, idxs):
            self.stats.record_latency(now - r.t0)
            if kind == "cpick":
                v, p = (int(idx[0]), int(idx[1])) if np.ndim(idx) \
                    else (int(idx), int(idx))

                def run(cb=r.cb, v=v, p=p) -> None:
                    try:
                        cb(v, p, payload)
                    except MemoryError:
                        raise
                    except Exception:
                        _log.error("classify callback failed", exc=True)
            else:
                i = int(idx)

                def run(cb=r.cb, i=i) -> None:
                    try:
                        cb(i, payload)
                    except MemoryError:
                        raise
                    except Exception:
                        _log.error("classify callback failed", exc=True)

            if r.loop is None or not r.loop.run_on_loop(run):
                run()

    # ------------------------------------------------------------- control

    def device_ok(self) -> bool:
        return time.monotonic() >= self._device_down_until

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        with self._probe_cv:  # wake the probe worker so it exits
            self._probe_cv.notify()


def _card_error(matcher, e: Exception) -> Optional[KernelError]:
    """-> the KernelError that a fault `e` of a device dispatch of
    `matcher` is on the card, where the host never answers in its
    place; None for the CPU tiers, which fail over."""
    dev = getattr(matcher, "device", None)
    if dev is None or dev.type == "cpu":
        return None
    err = KernelError(f"device dispatch on the card failed: {e!r}")
    err.__cause__ = e
    return err


def _pull(arr) -> np.ndarray:
    """to_host() of a dispatch result. A CUDA tensor that cannot be
    pulled means the card faulted (a kernel's illegal access surfaces
    here, at the sync): KernelError, never a host failover."""
    try:
        return to_host(arr)
    except MemoryError:
        raise
    except Exception as e:
        if isinstance(arr, torch.Tensor) and arr.is_cuda:
            raise KernelError(f"CUDA fault pulling a device result: "
                              f"{e!r}") from e
        raise
