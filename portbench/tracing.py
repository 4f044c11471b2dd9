"""What a traced run (--trace 1) reads besides the program's counters:
the program's own spans (utils/trace, sampled 1-in-N around the
harness's submits) and a torch.profiler trace of a steady stretch of
the window.

The profiler's chrome trace is parsed rather than its Python event
objects, whose shape differs between PyTorch versions: `kernel`,
`gpu_memcpy` and `gpu_memset` events are the device's work, `cpu_op`
events the host's (every thread's, where the profiler can record all
threads). The stretch is the trace's `Trace` event. The trace's clock need not
be time.monotonic()'s (on the card it is not), so the program's spans
are placed on it by that event's start, taken as the moment the
profiler came up.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(ivs: list) -> list:
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _profiler():
    from torch.profiler import ProfilerActivity, profile as tprofile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        from torch._C._profiler import _ExperimentalConfig
        return tprofile(activities=acts, experimental_config=
                        _ExperimentalConfig(profile_all_threads=True))
    except (ImportError, TypeError):
        return tprofile(activities=acts)


def profile(seconds: float, mark) -> dict:
    """Profile the process for `seconds`, calling mark() as the stretch
    opens and as it closes (before the trace is collected, which takes
    seconds more). -> {"marks": (the two results), "device": [(cat,
    name, t0, t1)], "host": [(name, t0, t1)], "t0", "t1" (the stretch on
    the trace's clock, us), "mono_off" (trace us minus time.monotonic()
    us), "window_s"}."""
    with _profiler() as prof:
        m0 = mark()
        mono0 = time.monotonic()
        time.sleep(seconds)
        mono1 = time.monotonic()
        m1 = mark()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            evs = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    dev, host, whole = [], [], None
    for e in evs:
        if e.get("ph") != "X":
            continue
        ts, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((cat, e.get("name", ""), ts, ts + dur))
        elif cat == "cpu_op":
            host.append((e.get("name", ""), ts, ts + dur))
        elif cat == "Trace":
            whole = (ts, ts + dur)
    t0, t1 = whole or (mono0 * 1e6, mono1 * 1e6)
    n_raw = len(dev)
    dev = [d for d in dev if d[3] > t0 and d[2] < t1]
    counts = {}
    for _c, name, _a, _b in dev:
        counts[name[:60]] = counts.get(name[:60], 0) + 1
    return {"marks": (m0, m1), "device": dev, "host": host, "t0": t0,
            "t1": t1,
            "mono_off": t0 - mono0 * 1e6, "window_s": (t1 - t0) / 1e6,
            "events": {"device_all": n_raw, "device_in_stretch": len(dev),
                       "host": len(host), "device_by_name": counts}}


def busy_s(prof: dict) -> float:
    """Seconds of the stretch in which the device ran anything."""
    t0, t1 = prof["t0"], prof["t1"]
    ivs = [(max(a, t0), min(b, t1)) for _c, _n, a, b in prof["device"]]
    return sum(b - a for a, b in _union([iv for iv in ivs if iv[1] > iv[0]])) \
        / 1e6


def spans_on_trace_clock(prof: dict, spans: list) -> list:
    """The program's spans as (plane/span, t0, t1) on the trace's clock."""
    off = prof["mono_off"]
    return [(f"{s['plane']}/{s['span']}", s["t_ns"] / 1e3 + off,
             (s["t_ns"] + s["dur_ns"]) / 1e3 + off) for s in spans]


def breakdown(prof: dict, spans: list) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps, each named by the program span (else the host op) that
    covers the gap's middle."""
    tot = {}
    for _c, name, a, b in prof["device"]:
        tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
    t0, t1 = prof["t0"], prof["t1"]
    busy = _union([(max(a, t0), min(b, t1)) for _c, _n, a, b in prof["device"]])
    gaps, at = [], t0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if t1 > at:
        gaps.append((at, t1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = spans_on_trace_clock(prof, spans)
    out = []
    for a, b in gaps:
        mid = (a + b) / 2
        name = _cover(named, mid) or _cover(prof["host"], mid) or \
            "host: no traced span or op"
        out.append([name, (b - a) / 1e6])
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": out}


def _cover(ivs: list, t: float):
    """The name of the shortest interval that holds t."""
    best = None
    for name, a, b in ivs:
        if a <= t <= b and (best is None or b - a < best[1]):
            best = (name, b - a)
    return best[0] if best else None


def sampled_spans(tids: list) -> list:
    """Every span the program recorded under the harness's trace ids."""
    from vproxy_tpu_torch.utils import trace
    out = []
    for tid in tids:
        out += trace.get_trace(tid)
    return out
