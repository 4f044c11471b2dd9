"""Workload capture — the measured-traffic model behind record-replay.

The observability planes can *see* traffic (stage histograms, span
traces, heavy-hitter sketches) but nothing could *play it back*: every
bench and storm scenario was a synthetic blast, so capacity claims
rested on guesses. This module fits a `WorkloadModel` from what the
planes already emit plus three cheap capture hooks, and serializes it
as a versioned JSON artifact that tools/replay.py can re-synthesize
deterministically (docs/replay.md):

* per-plane arrival processes — inter-arrival log2 histograms at the
  accept paths (`vproxy_workload_interarrival_us{plane=accept|lane|
  dns}`): python accepts and DNS queries observe here directly; the C
  accept lanes bucket with the SAME log2 rule in native code
  (vtl_lanes_capture_stat) and lane 0's poll tick folds the deltas in
  via arrival_merge, the accept_stage_merge idiom;
* Zipf popularity per dimension — fitted from the Space-Saving /
  Count-Min top tables (utils/sketch): the sketch output IS the model's
  popularity parameters, error bounds included;
* per-connection size/duration — the `vproxy_lb_conn_bytes` /
  `vproxy_lb_conn_duration_ms` histograms (utils/metrics.conn_observe,
  fed by the python splice path and the lane reap fold).

Capture is windowed with `capture start|stop|export` (command surface)
or `GET /workload` (both HTTP servers): start snapshots the cumulative
histogram state, export fits the model from the deltas — when no
session is open the window is process lifetime, so a bare GET /workload
always yields a usable model. The ON knob (VPROXY_TPU_WORKLOAD=0 to
disable) gates the python hooks and pushes into the native plane
(vtl_workload_set_enabled), mirroring the analytics knob — the
capture-off A/B overhead gate in bench has a real toggle.

The port's copy of vproxy_tpu/utils/workload.py, same names and behaviour.
"""
from __future__ import annotations

import json
import math
import threading
import time
import os
from typing import Dict, List, Optional

MODEL_KIND = "vproxy-workload"
MODEL_VERSION = 1

# arrival planes with their own inter-arrival histograms (closed label
# vocabulary: vproxy_workload_interarrival_us{plane=} is pre-registered
# from GlobalInspection.__init__ for the vlint registry pass)
PLANES = ("accept", "lane", "dns")

ON = os.environ.get("VPROXY_TPU_WORKLOAD", "1") != "0"

_lock = threading.Lock()
_last_arrival: Dict[str, float] = {}  # plane -> last arrival, monotonic s
_hists: Dict[str, object] = {}        # plane -> Histogram memo
_t_boot = time.monotonic()

# capture session: idle -> recording -> stopped (export works in every
# state; start replaces any previous session)
_session: dict = {"state": "idle", "t0": 0.0, "t1": 0.0,
                  "base": None, "end": None}


def enabled() -> bool:
    return ON


def configure(on: Optional[bool] = None) -> None:
    """Runtime knob (bench/test hook; production uses the env). Pushes
    the on/off state into the C plane so the lane capture histograms
    flip together with the python sites."""
    global ON
    if on is not None:
        ON = bool(on)
        from ..net import vtl
        vtl.workload_set_enabled(ON)


def push_native_knob() -> None:
    """Re-push ON into a freshly created native Lanes plane (the knob
    is a process global in C, but the .so may load after configure)."""
    from ..net import vtl
    vtl.workload_set_enabled(ON)


def _hist(plane: str):
    h = _hists.get(plane)
    if h is None:
        from .metrics import GlobalInspection
        h = _hists[plane] = GlobalInspection.get().get_histogram(
            "vproxy_workload_interarrival_us", plane=plane)
    return h


def note_arrival(plane: str) -> None:
    """Python-path arrival hook (tcplb accept, dns query): one
    monotonic read, one dict exchange, one histogram observe. The
    first arrival on a plane only seeds the cursor."""
    if not ON:
        return
    now = time.monotonic()
    with _lock:
        prev = _last_arrival.get(plane, 0.0)
        _last_arrival[plane] = now
    if prev:
        _hist(plane).observe(max(0.0, (now - prev) * 1e6))


def arrival_merge(plane: str, bucket_deltas, sum_us: float,
                  count: int) -> None:
    """Fold C-side pre-bucketed inter-arrival counts (accept lanes,
    vtl_lanes_capture_stat deltas) into the SAME per-plane histogram
    the python paths populate — the accept_stage_merge idiom."""
    _hist(plane).merge(bucket_deltas, sum_us, count)


def reset() -> None:
    """Test hook: drop session, cursors and histogram memos."""
    global _session
    with _lock:
        _last_arrival.clear()
        _hists.clear()
        _session = {"state": "idle", "t0": 0.0, "t1": 0.0,
                    "base": None, "end": None}


# ------------------------------------------------------- capture window

def _snap() -> dict:
    """Cumulative (count, sum, buckets) state of every model source —
    the delta-window primitive."""
    from . import metrics
    hb, hd = metrics.conn_hists(None)
    return {"planes": {pl: _hist(pl).state() for pl in PLANES},
            "bytes": hb.state(), "duration_ms": hd.state()}


def _dhist(h1, h0=None) -> dict:
    """h1 - h0 as a serializable {count, sum, buckets} distribution
    (h0=None means 'since boot': h1 as-is)."""
    c1, s1, b1 = h1
    if h0 is None:
        return {"count": int(c1), "sum": float(s1),
                "buckets": [int(x) for x in b1]}
    c0, s0, b0 = h0
    return {"count": int(c1 - c0), "sum": float(s1 - s0),
            "buckets": [int(x - y) for x, y in zip(b1, b0)]}


def capture_start() -> dict:
    global _session
    with _lock:
        _session = {"state": "recording", "t0": time.monotonic(),
                    "t1": 0.0, "base": _snap(), "end": None}
    from . import events
    events.record("workload_capture", "capture started")
    return capture_status()


def capture_stop() -> dict:
    global _session
    with _lock:
        if _session["state"] != "recording":
            raise ValueError("no capture recording "
                             f"(state: {_session['state']})")
        _session["state"] = "stopped"
        _session["t1"] = time.monotonic()
        _session["end"] = _snap()
    from . import events
    events.record("workload_capture", "capture stopped",
                  window_s=round(_session["t1"] - _session["t0"], 3))
    return capture_status()


def capture_status() -> dict:
    with _lock:
        st = dict(_session)
    if st["state"] == "recording":
        window = time.monotonic() - st["t0"]
    elif st["state"] == "stopped":
        window = st["t1"] - st["t0"]
    else:
        window = time.monotonic() - _t_boot
    return {"state": st["state"], "enabled": ON,
            "window_s": round(window, 3)}


def fit_zipf_alpha(counts: List[float]) -> float:
    """Least-squares slope of log(count) vs log(rank) over a top
    table's head — the Zipf exponent the sketch measured. Clamped to
    [0, 8]; 1.0 when the head is too short to fit."""
    pts = [(math.log(i + 1), math.log(c))
           for i, c in enumerate(counts) if c > 0]
    if len(pts) < 2:
        return 1.0
    n = len(pts)
    mx = sum(x for x, _ in pts) / n
    my = sum(y for _, y in pts) / n
    sxx = sum((x - mx) ** 2 for x, _ in pts)
    if sxx <= 0:
        return 1.0
    sxy = sum((x - mx) * (y - my) for x, y in pts)
    return max(0.0, min(8.0, -(sxy / sxx)))


def _fit_popularity() -> dict:
    """Per-dimension Zipf head from the analytics top tables: the
    Space-Saving keys/counts (with their error bounds) ARE the model's
    popularity parameters."""
    from . import sketch as SK
    out = {}
    for dim in SK.DIMS:
        try:
            rows = SK.top_table(dim, SK.TOPK)
        except Exception:
            rows = []
        top = [[r["key"], int(r["count"]), int(r.get("err", 0))]
               for r in rows if int(r.get("count", 0)) > 0]
        out[dim] = {"alpha": round(fit_zipf_alpha([c for _, c, _ in top]),
                                   4),
                    "top": top}
    return out


def export_model(seed: Optional[int] = None) -> dict:
    """Fit the WorkloadModel from the current capture window (stopped
    session > live session > process lifetime) — the `capture export`
    verb and the GET /workload body."""
    with _lock:
        st = dict(_session)
    if st["state"] == "stopped":
        base, end, secs = st["base"], st["end"], st["t1"] - st["t0"]
    elif st["state"] == "recording":
        base, end, secs = st["base"], _snap(), time.monotonic() - st["t0"]
    else:
        base, end, secs = None, _snap(), time.monotonic() - _t_boot
    secs = max(secs, 1e-9)
    planes = {}
    for pl in PLANES:
        d = _dhist(end["planes"][pl],
                   base["planes"][pl] if base else None)
        planes[pl] = {"arrivals": d["count"],
                      "rate_hz": round(d["count"] / secs, 6),
                      "interarrival_us": d}
    model = {
        "kind": MODEL_KIND, "version": MODEL_VERSION,
        "seed": seed, "captured_at": time.time(),
        "window_s": round(secs, 6),
        "planes": planes,
        "conn": {"bytes": _dhist(end["bytes"],
                                 base["bytes"] if base else None),
                 "duration_ms": _dhist(end["duration_ms"],
                                       base["duration_ms"] if base
                                       else None)},
        "popularity": _fit_popularity(),
    }
    return model


def capture(verb: str, seed: Optional[int] = None) -> dict:
    """The command-surface dispatcher: capture start|stop|export|status."""
    if verb == "start":
        return capture_start()
    if verb == "stop":
        return capture_stop()
    if verb == "export":
        return export_model(seed=seed)
    if verb == "status":
        return capture_status()
    raise ValueError(f"unknown capture verb {verb!r} "
                     "(one of: start, stop, export, status)")


# --------------------------------------------------------- model object

class WorkloadModel:
    """The versioned capture artifact: a thin validator/serializer over
    the model dict (replay.py loads these from files or a live
    GET /workload)."""

    def __init__(self, data: dict):
        self.data = data

    @property
    def seed(self) -> Optional[int]:
        return self.data.get("seed")

    def plane_rate(self, plane: str) -> float:
        return float(self.data["planes"].get(plane, {}).get("rate_hz",
                                                            0.0))

    def to_json(self) -> str:
        # canonical form: sorted keys, no whitespace — two exports of
        # the same state are byte-identical, so artifacts diff cleanly
        return json.dumps(self.data, sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def fit(cls, seed: Optional[int] = None) -> "WorkloadModel":
        return cls(export_model(seed=seed))

    @classmethod
    def from_json(cls, text: str) -> "WorkloadModel":
        data = json.loads(text)
        if data.get("kind") != MODEL_KIND:
            raise ValueError(f"not a workload model (kind="
                             f"{data.get('kind')!r})")
        ver = int(data.get("version", 0))
        if ver < 1 or ver > MODEL_VERSION:
            raise ValueError(f"workload model version {ver} outside "
                             f"supported range [1, {MODEL_VERSION}]")
        for field in ("planes", "conn", "popularity", "window_s"):
            if field not in data:
                raise ValueError(f"workload model missing {field!r}")
        return cls(data)


def sample_from_hist(rng, dhist: dict) -> float:
    """One draw from a {count, sum, buckets} log2 distribution: pick a
    bucket by cumulative weight, then uniform within its bounds (the
    +Inf tail draws in (2**26, 2**27]). Pure function of (rng state,
    dhist) — the seeded-determinism contract replay schedules build on."""
    buckets = dhist.get("buckets") or []
    total = sum(buckets)
    if total <= 0:
        return 0.0
    x = rng.randrange(total)
    cum = 0
    for i, n in enumerate(buckets):
        cum += n
        if x < cum:
            lo = 0.0 if i == 0 else float(1 << (i - 1))
            hi = float(1 << i) if i < 27 else float(1 << 27)
            return lo + (hi - lo) * rng.random()
    return 0.0
