"""Prometheus-style metrics registry + the process-global surface.

Parity: reference `vproxybase/prometheus/Metrics.java` (Counter / Gauge
/ GaugeF with a label set, text exposition). The port carries only the
families its modules read — the classify service counters, the engine
launch/generation gauges, the install and Maglev build histograms, the
event-loop count and the UDP drop counter — under the same names as
`vproxy_tpu`'s /metrics, so one scrape config reads both packages;
GlobalInspection also keeps the registry of live event loops
(register_loop / deregister_loop, called by net/eventloop.py).
"""
from __future__ import annotations

import sys
import threading
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

    def value(self) -> float:
        return self._count

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
        self.registry.gauge_f("vproxy_event_loop_count",
                              lambda: len(self._loops))
        # micro-batch classify queue (rules/service.py): batching ratio
        # = queries / dispatches
        for k in ("queries", "dispatches", "device_queries",
                  "oracle_queries", "failovers", "max_batch"):
            self.registry.gauge_f(
                f"vproxy_classify_{k}", lambda k=k: self._classify_stat(k))
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
        # pre-registered with their reservoirs: the get_histogram calls
        # in rules/engine.py and rules/maglev.py resolve to these
        self.get_histogram("vproxy_engine_swap_ms", reservoir=512)
        self.get_histogram("vproxy_maglev_build_ms", reservoir=256)
        # silent-drop accounting (udp_drop_incr below): created eagerly
        # so a scrape shows the zero before the first drop
        self.get_counter("vproxy_udp_drop_total")

    @staticmethod
    def _classify_stat(key: str) -> float:
        svc = sys.modules.get("vproxy_tpu_torch.rules.service")
        inst = None if svc is None else svc.ClassifyService._instance
        return 0.0 if inst is None else float(getattr(inst.stats, key))

    @staticmethod
    def _engine_stat(name: str, *args) -> float:
        # a scrape never forces the engine (and torch's device) to load
        eng = sys.modules.get("vproxy_tpu_torch.rules.engine")
        return 0.0 if eng is None else float(getattr(eng, name)(*args))

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


_UDP_DROP_CTR: Optional[Counter] = None


def udp_drop_incr(n: int = 1) -> None:
    """Count datagrams dropped on a full queue (net/wrapfd.py)."""
    global _UDP_DROP_CTR
    if _UDP_DROP_CTR is None:
        _UDP_DROP_CTR = GlobalInspection.get().get_counter(
            "vproxy_udp_drop_total")
    _UDP_DROP_CTR.incr(n)
