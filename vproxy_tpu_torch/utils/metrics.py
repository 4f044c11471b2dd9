"""Prometheus-style metrics registry + global inspection surface.

Parity: reference `vproxybase/prometheus/Metrics.java` (Counter / Gauge
/ GaugeF with a label set, text exposition) and `GlobalInspection.java:
24-205`: one process-global surface collecting direct-memory bytes,
per-loop thread registry, stack-trace dump and open-FD dump, exposed
over HTTP (`getPrometheusString():177`,
`GlobalInspectionHttpServerLauncher.java:9` — /metrics, /lsof, /jstack).

The port's copy of vproxy_tpu/utils/metrics.py: the same family names
(one scrape config reads both packages; a scrape of either lists the
same families for the same resources) and the same inspection server
(`launch_inspection_http`). The cluster families read 0 and /cluster
answers {"enabled": false}: no cluster node boots in the port yet
(ROADMAP Queue A item 8). The reference's `bench_snapshot` (read by
its bench scripts only) is not carried over.
"""
from __future__ import annotations

import os
import sys
import threading
import traceback
from typing import Callable, Dict, List, Optional, Tuple


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Metric:
    mtype = "untyped"

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = dict(labels or {})

    def value(self) -> float:
        raise NotImplementedError

    def sample_line(self) -> str:
        v = self.value()
        v_str = "%d" % v if float(v).is_integer() else repr(float(v))
        return f"{self.name}{_fmt_labels(self.labels)} {v_str}"

    def sample_lines(self) -> List[str]:
        return [self.sample_line()]


class Counter(Metric):
    mtype = "counter"

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        super().__init__(name, labels)
        self._v = 0
        self._lock = threading.Lock()

    def incr(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    def value(self) -> float:
        return self._v


class Gauge(Metric):
    mtype = "gauge"

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        super().__init__(name, labels)
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = v

    def add(self, d: float) -> None:
        self._v += d

    def value(self) -> float:
        return self._v


class GaugeF(Metric):
    """Gauge computed by a function at scrape time."""
    mtype = "gauge"

    def __init__(self, name: str, fn: Callable[[], float],
                 labels: Optional[Dict[str, str]] = None):
        super().__init__(name, labels)
        self.fn = fn

    def value(self) -> float:
        return float(self.fn())


class Histogram(Metric):
    """Fixed log2-bucket histogram with Prometheus exposition.

    Bucket upper bounds are 1, 2, 4, ... 2**(buckets-1) in the metric's
    own unit (latencies here use microseconds, hence the `_us` naming
    convention), plus the implicit +Inf bucket. The hot path is one
    uncontended lock acquisition, a bit_length() bucket pick and three
    integer adds — no allocation, no percentile math.

    An optional reservoir (ring of the last N raw samples) makes
    percentiles() EXACT over the recent window instead of log2-bucket
    estimates; the classify latency contract (BASELINE p99 < 50us) is
    measured through it, while /metrics scrapes see the cumulative
    buckets either way.
    """
    mtype = "histogram"

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None,
                 buckets: int = 27, reservoir: int = 0):
        super().__init__(name, labels)
        self._bounds = [1 << k for k in range(buckets)]
        self._counts = [0] * (buckets + 1)  # + the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()
        self._res_cap = reservoir
        self._res: List[float] = [0.0] * reservoir
        self._res_n = 0

    def _bucket_of(self, v: float) -> int:
        if v <= 1.0:
            return 0
        iv = int(v)
        if iv < v:
            iv += 1
        return min((iv - 1).bit_length(), len(self._bounds))

    def observe(self, v: float) -> None:
        i = self._bucket_of(v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if self._res_cap:
                self._res[self._res_n % self._res_cap] = v
                self._res_n += 1

    def merge(self, bucket_deltas, sum_delta: float,
              count_delta: int) -> None:
        """Fold pre-bucketed counts in (the C accept-lane stage
        histograms: native/vtl.cpp buckets with the same log2 rule and
        python merges the per-tick deltas, so lane-served connections
        land in the SAME series python-path connections populate). The
        reservoir stays sample-level-only by design — percentiles fall
        back to the bucket estimate when merged counts dominate."""
        if count_delta <= 0:
            return
        with self._lock:
            for i, d in enumerate(bucket_deltas):
                if d:
                    self._counts[i] += d
            self._sum += sum_delta
            self._count += count_delta

    def value(self) -> float:
        return self._count

    def state(self) -> Tuple[int, float, List[int]]:
        """(count, sum, [bucket counts]) snapshot — the workload-capture
        delta-window primitive (utils/workload.py)."""
        with self._lock:
            return self._count, self._sum, list(self._counts)

    def sample_lines(self) -> List[str]:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        out = []
        cum = 0
        for bound, n in zip(self._bounds, counts):
            cum += n
            lbl = _fmt_labels({**self.labels, "le": str(bound)})
            out.append(f"{self.name}_bucket{lbl} {cum}")
        lbl = _fmt_labels({**self.labels, "le": "+Inf"})
        out.append(f"{self.name}_bucket{lbl} {total}")
        base = _fmt_labels(self.labels)
        s_str = "%d" % s if float(s).is_integer() else repr(float(s))
        out.append(f"{self.name}_sum{base} {s_str}")
        out.append(f"{self.name}_count{base} {total}")
        return out

    def percentiles(self, qs=(50.0, 99.0, 99.9)) -> Optional[Dict[str, float]]:
        """-> {"n", "p50", "p99", "p999", ...} or None when empty.
        Exact over the reservoir window when one is configured, else a
        log-linear estimate from the cumulative buckets."""
        with self._lock:
            if self._count == 0:
                return None
            if self._res_cap and self._res_n:
                n = min(self._res_n, self._res_cap)
                window = sorted(self._res[:n])
                out = {"n": self._res_n}
                for q in qs:
                    i = min(n - 1, max(0, int(round(q / 100.0 * (n - 1)))))
                    out[_q_key(q)] = float(window[i])
                return out
            counts = list(self._counts)
            total = self._count
        out = {"n": total}
        for q in qs:
            out[_q_key(q)] = _bucket_quantile(self._bounds, counts, total,
                                              q / 100.0)
        return out


def _q_key(q: float) -> str:
    return "p" + ("%g" % q).replace(".", "")


def _bucket_quantile(bounds, counts, total, q: float) -> float:
    """Log-linear interpolation inside the winning log2 bucket."""
    rank = q * total
    cum = 0
    lo = 0.0
    for bound, n in zip(bounds, counts):
        if cum + n >= rank and n > 0:
            frac = (rank - cum) / n
            return lo + frac * (bound - lo)
        cum += n
        lo = float(bound)
    return float(bounds[-1] * 2)  # landed in +Inf


class MetricsRegistry:
    def __init__(self):
        self._metrics: List[Metric] = []
        self._lock = threading.Lock()

    def add(self, m: Metric) -> Metric:
        with self._lock:
            self._metrics.append(m)
        return m

    def remove(self, m: Metric) -> None:
        with self._lock:
            if m in self._metrics:
                self._metrics.remove(m)

    def counter(self, name: str, **labels) -> Counter:
        return self.add(Counter(name, labels))  # type: ignore[return-value]

    def gauge(self, name: str, **labels) -> Gauge:
        return self.add(Gauge(name, labels))  # type: ignore[return-value]

    def gauge_f(self, name: str, fn, **labels) -> GaugeF:
        return self.add(GaugeF(name, fn, labels))  # type: ignore[return-value]

    def histogram(self, name: str, buckets: int = 27, reservoir: int = 0,
                  **labels) -> Histogram:
        return self.add(Histogram(name, labels, buckets=buckets,
                                  reservoir=reservoir))  # type: ignore[return-value]

    def prometheus_text(self) -> str:
        with self._lock:
            metrics = list(self._metrics)
        by_name: Dict[str, Tuple[str, List[Metric]]] = {}
        for m in metrics:
            by_name.setdefault(m.name, (m.mtype, []))[1].append(m)
        out = []
        for name in sorted(by_name):
            mtype, ms = by_name[name]
            out.append(f"# TYPE {name} {mtype}")
            for m in ms:
                out.extend(m.sample_lines())
        return "\n".join(out) + ("\n" if out else "")


class GlobalInspection:
    """Process-global metric surface (singleton)."""

    _instance: Optional["GlobalInspection"] = None
    _ilock = threading.Lock()

    def __init__(self):
        self.registry = MetricsRegistry()
        self._loops: Dict[int, object] = {}  # id(loop) -> SelectorEventLoop
        self._lock = threading.Lock()
        # (name, sorted-label-items) -> Metric for get-or-create users
        self._named: Dict[tuple, Metric] = {}
        self.direct_memory_bytes = self.registry.gauge(
            "vproxy_direct_memory_bytes_current")
        self.registry.gauge_f("vproxy_event_loop_count",
                              lambda: len(self._loops))
        self.registry.gauge_f("vproxy_open_fd_count",
                              lambda: len(self._open_fds()))
        self.registry.gauge_f("vproxy_thread_count",
                              lambda: threading.active_count())
        # micro-batch classify queue (rules/service.py): batching ratio
        # = queries / dispatches
        for k in ("queries", "dispatches", "device_queries",
                  "oracle_queries", "failovers", "max_batch"):
            self.registry.gauge_f(
                f"vproxy_classify_{k}", lambda k=k: self._classify_stat(k))
        # native splice-pump counters (native/vtl.cpp): bytes spliced,
        # write syscalls, short writes, TLS handshakes
        for i, k in enumerate(("bytes", "splice_calls", "short_writes",
                               "tls_handshakes")):
            self.registry.gauge_f(f"vproxy_pump_{k}_total",
                                  lambda i=i: self._pump_counter(i))
        # switch flow-cache counters (native/vtl.cpp's flow table)
        for i, k in enumerate(("hit", "miss", "evict", "stale")):
            self.registry.gauge_f(f"vproxy_switch_flowcache_{k}_total",
                                  lambda i=i: self._flowcache_counter(i))
        self.registry.gauge_f("vproxy_switch_native_fwd_total",
                              lambda: self._flowcache_counter(4))
        try:  # the reason-index contract lives in net/vtl.py
            from ..net.vtl import FLOW_DROP_REASONS as _fc_reasons
        except Exception:  # provider import failure: labels still exist
            _fc_reasons = ("acl_deny", "same_iface", "route_miss",
                           "unknown_vni", "egress_short_write", "other")
        for j, r in enumerate(_fc_reasons):
            self.registry.gauge_f("vproxy_switch_native_drop_total",
                                  lambda j=j: self._flowcache_counter(5 + j),
                                  reason=r)
        # accept-lane counters (native/vtl.cpp accept lanes): accepts
        # taken by lanes, sessions served wholly in C, punts by reason
        self.registry.gauge_f("vproxy_lane_accepted_total",
                              lambda: self._lane_counter(0))
        self.registry.gauge_f("vproxy_lane_served_total",
                              lambda: self._lane_counter(1))
        for j, r in enumerate(("classic", "stale", "connect_fail")):
            self.registry.gauge_f("vproxy_lane_punt_total",
                                  lambda j=j: self._lane_counter(2 + j),
                                  reason=r)
        # classify-engine generation installs and fused-dispatch
        # accounting (rules/engine.py)
        self.registry.gauge_f("vproxy_engine_generation",
                              lambda: self._engine_stat("generation_total"))
        for kind in ("hint", "cidr"):
            self.registry.gauge_f(
                "vproxy_engine_table_bytes",
                lambda kind=kind: self._engine_stat("table_bytes_total",
                                                    kind),
                matcher=kind)
        self.registry.gauge_f("vproxy_engine_dispatch_launches_total",
                              lambda: self._engine_stat(
                                  "dispatch_launches_total"))
        self.registry.gauge_f("vproxy_engine_fused_dispatches_total",
                              lambda: self._engine_stat(
                                  "fused_dispatches_total"))
        # cluster plane: the reference's families, 0 until a cluster
        # node boots, which no node does in the port yet
        for k in ("peers_up", "generation", "generation_lag",
                  "steps_total", "barrier_stalls_total"):
            self.registry.gauge_f(f"vproxy_cluster_{k}", lambda: 0.0)
        # event-loop health: worst timer slip and longest single callback
        # across all live loops since the previous scrape; reading
        # resets the window
        self.registry.gauge_f("vproxy_loop_timer_slip_us_max",
                              lambda: self._loop_health("slip"))
        self.registry.gauge_f("vproxy_loop_callback_us_max",
                              lambda: self._loop_health("cb"))
        # maglev table-compiler accounting (rules/maglev.py): a scrape
        # shows the zeros before any build
        self.get_counter("vproxy_maglev_table_builds_total")
        self.get_gauge("vproxy_maglev_remap_fraction")
        # pre-registered with their reservoirs: the get_histogram calls
        # in rules/engine.py and rules/maglev.py resolve to these
        self.get_histogram("vproxy_engine_swap_ms", reservoir=512)
        self.get_histogram("vproxy_maglev_build_ms", reservoir=256)
        # silent-drop accounting (udp_drop_incr below): created eagerly
        # so a scrape shows the zero before the first drop
        self.get_counter("vproxy_udp_drop_total")
        # span tracing (utils/trace.py + the native span rings): the
        # zeros show before the first sampled request
        self.registry.gauge_f("vproxy_trace_spans_total",
                              self._trace_c_spans, plane="lane")
        for pl in ("accept", "engine", "install", "cluster"):
            self.registry.gauge_f("vproxy_trace_spans_total",
                                  lambda pl=pl: self._trace_py_spans(pl),
                                  plane=pl)
        self.registry.gauge_f("vproxy_trace_drop_total",
                              self._trace_c_drops, ring="lane")
        self.registry.gauge_f("vproxy_trace_drop_total",
                              self._trace_py_drops, ring="py")
        # traffic analytics (utils/sketch + the native HH shards), with
        # closed label vocabularies
        from . import sketch as _sketch
        for dim in _sketch.DIMS:
            for slot in range(_sketch.TOP_SLOTS):
                self.registry.gauge_f(
                    "vproxy_hh_count",
                    lambda dim=dim, slot=slot: _sketch.top_slot(dim,
                                                                slot),
                    dim=dim, slot=str(slot))
        for pl in _sketch.PLANES:
            self.registry.gauge_f(
                "vproxy_analytics_updates_total",
                lambda pl=pl: float(_sketch.plane_updates_total(pl)),
                plane=pl)
        self.registry.gauge_f("vproxy_analytics_drop_total",
                              self._hh_overflow, reason="shard_overflow")
        self.registry.gauge_f(
            "vproxy_analytics_drop_total",
            lambda: float(_sketch.merge_truncated_last()),
            reason="merge_truncated")
        self.registry.gauge_f(
            "vproxy_analytics_rotations_total",
            lambda: float(_sketch.rotations_total()))
        self.registry.gauge_f(
            "vproxy_analytics_enabled",
            lambda: 1.0 if _sketch.enabled() else 0.0)
        # admission policing (policing/engine.py): table size, installs,
        # and policed totals over the closed action x dim grid
        for k in ("keys", "tables_installed_total", "gossip_merges_total"):
            self.registry.gauge_f(f"vproxy_policy_{k}",
                                  lambda k=k: self._policing_stat(k))
        self.registry.gauge_f("vproxy_policing_enabled",
                              lambda: self._policing_stat("enabled"))
        for act in ("monitor", "throttle", "shed"):
            for dim in _sketch.DIMS:
                self.registry.gauge_f(
                    "vproxy_lb_policed_total",
                    lambda act=act, dim=dim: self._policed_total(act,
                                                                 dim),
                    action=act, dim=dim)
        # accept-path stage histograms: the stage vocabulary is closed,
        # so the five series exist (at zero) before the first connection
        for st in ("acl", "classify", "backend_pick", "handover",
                   "total"):
            self.get_histogram("vproxy_accept_stage_us", stage=st)
        # workload capture (utils/workload.py): per-plane inter-arrival
        # histograms and the process-wide per-connection series
        from . import workload as _workload
        for pl in _workload.PLANES:
            self.get_histogram("vproxy_workload_interarrival_us",
                               plane=pl)
        self.get_histogram("vproxy_lb_conn_bytes")
        self.get_histogram("vproxy_lb_conn_duration_ms")
        self.registry.gauge_f(
            "vproxy_workload_capture_enabled",
            lambda: 1.0 if _workload.enabled() else 0.0)

    @staticmethod
    def _classify_stat(key: str) -> float:
        svc = sys.modules.get("vproxy_tpu_torch.rules.service")
        inst = None if svc is None else svc.ClassifyService._instance
        return 0.0 if inst is None else float(getattr(inst.stats, key))

    @staticmethod
    def _pump_counter(i: int) -> float:
        from ..net import vtl
        return float(vtl.pump_counters()[i])

    @staticmethod
    def _flowcache_counter(i: int) -> float:
        from ..net import vtl
        return float(vtl.flowcache_counters()[i])

    @staticmethod
    def _lane_counter(i: int) -> float:
        from ..net import vtl
        return float(vtl.lane_counters()[i])

    def _loop_health(self, key: str) -> float:
        with self._lock:
            loops = list(self._loops.values())
        worst = 0.0
        for lp in loops:
            take = getattr(lp, "take_health", None)
            if take is not None:
                worst = max(worst, take(key))
        return worst * 1e6

    @staticmethod
    def _engine_stat(name: str, *args) -> float:
        # a scrape never forces the engine (and torch's device) to load
        eng = sys.modules.get("vproxy_tpu_torch.rules.engine")
        return 0.0 if eng is None else float(getattr(eng, name)(*args))

    @staticmethod
    def _trace_c_spans() -> float:
        from ..net import vtl
        return float(vtl.trace_counters()[0])

    @staticmethod
    def _trace_c_drops() -> float:
        from ..net import vtl
        return float(vtl.trace_counters()[1])

    @staticmethod
    def _trace_py_spans(plane: str) -> float:
        from . import trace
        return float(trace.plane_spans_total(plane))

    @staticmethod
    def _trace_py_drops() -> float:
        from . import trace
        return float(trace.py_dropped_total())

    @staticmethod
    def _policing_stat(key: str) -> float:
        # a scrape never forces the policing import
        eng = sys.modules.get("vproxy_tpu_torch.policing.engine")
        if eng is None:
            return 0.0
        return float(eng.default().status().get(key, 0))

    @staticmethod
    def _policed_total(action: str, dim: str) -> float:
        eng = sys.modules.get("vproxy_tpu_torch.policing.engine")
        return 0.0 if eng is None else float(
            eng.default().policed_total(action=action, dim=dim))

    @staticmethod
    def _hh_overflow() -> float:
        from ..net import vtl
        return float(vtl.hh_counters()[1])

    # ------------------------------------------- named get-or-create

    def get_counter(self, name: str, **labels) -> Counter:
        return self._get_named(name, labels,
                               lambda: Counter(name, labels))  # type: ignore[return-value]

    def get_gauge(self, name: str, **labels) -> Gauge:
        return self._get_named(name, labels,
                               lambda: Gauge(name, labels))  # type: ignore[return-value]

    def get_histogram(self, name: str, buckets: int = 27, reservoir: int = 0,
                      **labels) -> Histogram:
        return self._get_named(
            name, labels, lambda: Histogram(name, labels, buckets=buckets,
                                            reservoir=reservoir))  # type: ignore[return-value]

    def _get_named(self, name: str, labels: dict, mk) -> Metric:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            m = self._named.get(key)
            if m is None:
                m = self._named[key] = mk()
                self.registry.add(m)
        return m

    @classmethod
    def get(cls) -> "GlobalInspection":
        with cls._ilock:
            if cls._instance is None:
                cls._instance = GlobalInspection()
            return cls._instance

    # ----------------------------------------------------------- loops

    def register_loop(self, loop) -> None:
        with self._lock:
            self._loops[id(loop)] = loop

    def deregister_loop(self, loop) -> None:
        with self._lock:
            self._loops.pop(id(loop), None)

    def prometheus_string(self) -> str:
        return self.registry.prometheus_text()

    # ------------------------------------------------------------ dumps

    @staticmethod
    def _open_fds() -> List[str]:
        try:
            return sorted(os.listdir("/proc/self/fd"), key=int)
        except OSError:
            return []

    def open_fd_dump(self) -> str:
        """lsof analog: fd -> target (GlobalInspection.java:196-205)."""
        lines = []
        for fd in self._open_fds():
            try:
                target = os.readlink(f"/proc/self/fd/{fd}")
            except OSError:
                target = "?"
            lines.append(f"{fd}\t{target}")
        return "\n".join(lines) + "\n"

    @staticmethod
    def stack_trace_dump() -> str:
        """jstack analog (GlobalInspection.java:181-194)."""
        names = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for tid, frame in sys._current_frames().items():
            out.append(f'Thread "{names.get(tid, "?")}" id={tid}')
            out.extend(l.rstrip() for l in traceback.format_stack(frame))
            out.append("")
        return "\n".join(out)


_UDP_DROP_CTR: Optional[Counter] = None


def udp_drop_incr(n: int = 1) -> None:
    """Count datagrams dropped on a full queue (net/wrapfd.py)."""
    global _UDP_DROP_CTR
    if _UDP_DROP_CTR is None:
        _UDP_DROP_CTR = GlobalInspection.get().get_counter(
            "vproxy_udp_drop_total")
    _UDP_DROP_CTR.incr(n)


# accept-path span timers (components/tcplb.py + components/upstream.py):
# one histogram family, labeled by stage — acl (accept->ACL verdict),
# classify (hint submit->index), backend_pick (group/WRR selection),
# handover (backend connect->pump running), total (accept->pump running).
# Local memo keeps the hot path at one dict hit; a racy double-create
# resolves to the same metric through get_histogram's dedup.
_ACCEPT_STAGE_HISTS: Dict[str, Histogram] = {}


def accept_stage_observe(stage: str, seconds: float) -> None:
    h = _ACCEPT_STAGE_HISTS.get(stage)
    if h is None:
        h = _ACCEPT_STAGE_HISTS[stage] = GlobalInspection.get().get_histogram(
            "vproxy_accept_stage_us", stage=stage)
    h.observe(seconds * 1e6)


def accept_stage_merge(stage: str, bucket_deltas, sum_us: float,
                       count: int) -> None:
    """Fold C-side pre-bucketed stage counts (accept lanes,
    vtl_lanes_stage_stat deltas) into the SAME
    vproxy_accept_stage_us{stage=} series the python accept path
    populates — lane-served connections stop being invisible to the
    stage histograms."""
    h = _ACCEPT_STAGE_HISTS.get(stage)
    if h is None:
        h = _ACCEPT_STAGE_HISTS[stage] = GlobalInspection.get().get_histogram(
            "vproxy_accept_stage_us", stage=stage)
    h.merge(bucket_deltas, sum_us, count)


# per-connection size/duration histograms (the workload-capture
# satellite): one process-wide aggregate pair (lb=None — what the
# workload model reads) plus a labeled pair per LB. Memoized like the
# stage histograms; a racy double-create dedups through _get_named.
_CONN_HISTS: Dict[Optional[str], Tuple[Histogram, Histogram]] = {}


def conn_hists(lb: Optional[str] = None) -> Tuple[Histogram, Histogram]:
    """(bytes, duration_ms) histogram pair for one LB (or the process
    aggregate when lb is None)."""
    pair = _CONN_HISTS.get(lb)
    if pair is None:
        gi = GlobalInspection.get()
        labels = {"lb": lb} if lb else {}
        pair = _CONN_HISTS[lb] = (
            gi.get_histogram("vproxy_lb_conn_bytes", **labels),
            gi.get_histogram("vproxy_lb_conn_duration_ms", **labels))
    return pair


def conn_observe(lb: Optional[str], nbytes: float, dur_ms: float) -> None:
    """One closed python-path session's size/duration, folded into the
    per-LB series AND the process aggregate the workload model reads."""
    for target in ((None, lb) if lb else (None,)):
        hb, hd = conn_hists(target)
        hb.observe(nbytes)
        hd.observe(dur_ms)


def conn_merge(lb: Optional[str], which: str, bucket_deltas,
               sum_delta: float, count: int) -> None:
    """Fold C-side pre-bucketed per-connection counts (accept lanes,
    vtl_lanes_capture_stat deltas) into the SAME series the python
    splice path populates — lane-served connections stop being
    invisible to the conn histograms. which: "bytes" | "duration_ms"."""
    idx = 0 if which == "bytes" else 1
    for target in ((None, lb) if lb else (None,)):
        conn_hists(target)[idx].merge(bucket_deltas, sum_delta, count)


def launch_inspection_http(loop, ip: str, port: int):
    """Serve /metrics, /lsof, /jstack, /events, /healthz — the
    reference's `-Dglobal_inspection=host:port` server (Main.java:
    85-104) plus the flight-recorder dump. Returns the HttpServer
    (close() to stop)."""
    from ..lib.vserver import HttpServer
    from . import failpoint, lifecycle
    from .events import FlightRecorder

    gi = GlobalInspection.get()
    srv = HttpServer(loop)
    srv.get("/metrics", lambda ctx: ctx.resp
            .header("Content-Type", "text/plain; version=0.0.4")
            .end(gi.prometheus_string()))
    srv.get("/lsof", lambda ctx: ctx.resp
            .header("Content-Type", "text/plain").end(gi.open_fd_dump()))
    srv.get("/jstack", lambda ctx: ctx.resp
            .header("Content-Type", "text/plain").end(gi.stack_trace_dump()))

    def events(ctx) -> None:
        try:
            last = int(ctx.req.query.get("n", "0"))
        except ValueError:
            last = 0
        try:  # ?trace=<id>: only events cross-referencing that trace
            tid = int(ctx.req.query.get("trace", "0"))
        except ValueError:
            tid = 0
        # ?plane=<p>: only events of that plane (utils/events.plane_of
        # — the analytics drill-down filter)
        plane = ctx.req.query.get("plane") or None

        # ?since=&until=: monotonic-ns bounds, the SAME clock trace
        # spans stamp t_ns with — a capture window joins against
        # recorder events without clock arithmetic
        def _ns(key):
            try:
                v = int(ctx.req.query.get(key, "0"))
            except ValueError:
                v = 0
            return v or None

        ctx.resp.end(FlightRecorder.get().snapshot(
            last, trace=tid or None, plane=plane,
            since=_ns("since"), until=_ns("until")))

    srv.get("/events", events)

    def analytics(ctx) -> None:
        # the heavy-hitter plane (utils/sketch): local top tables (one
        # shared assembly across all three serving surfaces)
        from . import sketch as SK
        out = SK.snapshot()
        # per-node policed attribution (the enforcement half of the
        # analytics loop — what the detected heavy hitters COST them)
        from ..policing import engine as PE
        out["policing"] = {"self": PE.default().policed_by_node(),
                           "peers": {}}
        ctx.resp.end(out)

    srv.get("/analytics", analytics)

    def policing_ep(ctx) -> None:
        # the Guardian enforcement surface (policing/engine.py):
        # engine status + declared policies + the live enforcement
        # table (per-key buckets with origin/ttl — local vs gossiped)
        from ..policing import engine as PE
        eng = PE.default()
        st = eng.status()
        st["policy_list"] = eng.list_policies()
        st["table"] = eng.table_snapshot()
        st["policed_by_node"] = eng.policed_by_node()
        st["shed_receipt"] = eng.shed_receipt()
        ctx.resp.end(st)

    srv.get("/policing", policing_ep)

    def workload_ep(ctx) -> None:
        # the capture artifact (utils/workload): the current window's
        # fitted model — tools/replay.py consumes this live
        from . import workload as WL
        ctx.resp.end(WL.export_model())

    srv.get("/workload", workload_ep)

    def trace_ep(ctx) -> None:
        # GET /trace -> recent trace summaries; ?id=<trace> -> that
        # trace's spans (start-time ordered); ?n= bounds the list
        from . import trace as TR
        try:
            tid = int(ctx.req.query.get("id", "0"))
        except ValueError:
            tid = 0
        if tid:
            ctx.resp.end({"trace": tid, "spans": TR.get_trace(tid)})
            return
        try:
            last = int(ctx.req.query.get("n", "64"))
        except ValueError:
            last = 64
        ctx.resp.end({"sample_every": TR.sample_every(),
                      "traces": TR.summaries(last)})

    srv.get("/trace", trace_ep)
    srv.get("/faults", lambda ctx: ctx.resp.end(failpoint.active()))

    srv.get("/cluster", lambda ctx: ctx.resp.end({"enabled": False}))

    def healthz(ctx) -> None:
        # draining flips to 503 so upstream LB health probes steer away
        # while in-flight sessions finish (utils/lifecycle)
        if lifecycle.is_draining():
            ctx.resp.status(503).end(b"draining")
        else:
            ctx.resp.end(b"OK")

    srv.get("/healthz", healthz)
    srv.listen(port, ip)
    return srv
