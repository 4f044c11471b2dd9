"""Record-replay engine — the capacity twin (docs/replay.md).

The port's copy of tools/replay.py, on vproxy_tpu_torch: the same
schedule (a pure function of the model JSON and the seed, so both
packages hash the same model and seed to the same 64-hex schedule),
the same world, gates and report keys.

Loads a captured `WorkloadModel` (a file exported by `capture export`,
or a live `GET /workload`), synthesizes a deterministic arrival
schedule from it, and replays that schedule at Nx speed against a
candidate LB config on the `_fleetlib` fleet harness — shed-vs-fail
accounting, latency percentiles and explicit SLO gates, so "would this
config survive yesterday's traffic at twice the rate?" is a command,
not a guess.

Determinism is the seeded-failpoint idiom (`VPROXY_TPU_FAILPOINT_SEED`
family): every sampling site gets its own `random.Random(f"{seed}:
<site>")` stream, string seeds hash by VALUE in CPython, so the same
(model, seed) pair produces a byte-identical schedule in every process
— `schedule_hash` (sha256 over the canonical JSON) is echoed into the
replay report, and two same-seed runs MUST agree on it.

The fidelity gate closes the loop: replayed clients bind distinct
loopback source addresses (one_session `src_ip`), so the analytics
sketch and the workload capture hooks see the synthesized traffic
exactly like real traffic; re-capturing during the replay and
comparing top-K identity plus per-plane rate shape against the source
model proves the twin is faithful, not just plausible.

The replay's LB classifies on the card (utils/torchenv.default_device):
without a GPU `run_replay` and the CLI raise unless the CPU is asked
for (`--device cpu` or VPROXY_TPU_TORCH_DEVICE=cpu). `--hash-only`
builds the schedule alone and touches no device.

Run: python -m vproxy_tpu_torch.tools.replay \
        (--model capture.json | --url http://HOST:PORT/workload) \
        [--seed N] [--speed X] [--max-arrivals N] [--fidelity] \
        [--hash-only] [--overload static|adaptive] [--device cpu] \
        [--out report.json]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import sys
import threading
import time

from . import _fleetlib

# schedule caps: a replay is a bounded experiment, not a soak
MAX_ARRIVALS_DEFAULT = 400
PAYLOAD_CAP = 1 << 18          # clamp sampled connection sizes (bytes)
SYNTH_KEYS = 16                # synthetic client count when top is empty


def _gate(value, limit, op: str = "<=") -> dict:
    ok = {"<=": value <= limit, ">=": value >= limit,
          "==": value == limit}[op]
    return {"value": round(value, 4) if isinstance(value, float) else value,
            "op": op, "limit": limit, "pass": bool(ok)}


# ---------------------------------------------------------- model loading

def load_model(src: str):
    """A WorkloadModel from a file path or a live `GET /workload` URL
    (stdlib urllib only — the replay box may be anywhere)."""
    from ..utils.workload import WorkloadModel
    if src.startswith(("http://", "https://")):
        import urllib.request
        with urllib.request.urlopen(src, timeout=10) as r:
            return WorkloadModel.from_json(r.read().decode())
    with open(src, encoding="utf-8") as f:
        return WorkloadModel.from_json(f.read())


def client_addr_map(model) -> dict:
    """Model client key -> replayable loopback source address. Keys
    that already ARE loopback addresses (a capture taken on this
    harness) replay as themselves; foreign keys (real client IPs,
    opaque ids) get deterministic 127.0.x.y aliases by top-table rank,
    so top-K identity survives the round trip via this map."""
    out = {}
    nxt = 0
    top = model.data["popularity"].get("clients", {}).get("top", [])
    for key, _cnt, _err in top:
        if isinstance(key, str) and key.startswith("127."):
            out[key] = key
        else:
            out[key] = f"127.0.{1 + nxt // 250}.{2 + nxt % 250}"
            nxt += 1
    return out


# ------------------------------------------------------ schedule synthesis

def _weighted_keys(model, alpha: float):
    """(keys, cumulative integer weights) for popularity draws. The
    sketch top table is the head; when it is empty (fresh process) a
    synthetic Zipf(alpha) head stands in so a schedule always exists."""
    top = model.data["popularity"].get("clients", {}).get("top", [])
    pairs = [(k, int(c)) for k, c, _e in top if int(c) > 0]
    if not pairs:
        pairs = [(f"c{i:02d}", max(1, int(1e6 * (i + 1) ** -alpha)))
                 for i in range(SYNTH_KEYS)]
    keys, cum, acc = [], [], 0
    for k, w in pairs:
        acc += w
        keys.append(k)
        cum.append(acc)
    return keys, cum, acc


def build_schedule(model, seed: int, speed: float = 1.0,
                   max_arrivals: int = MAX_ARRIVALS_DEFAULT,
                   duration_s: float = 0.0, plane: str = "accept") -> dict:
    """Synthesize the deterministic replay schedule: arrival offsets
    from the plane's inter-arrival histogram, client identity from the
    Zipf popularity head, connection sizes from the bytes histogram.
    Offsets `t` are in SOURCE time (seconds); `speed` only divides at
    dispatch, so one schedule serves every replay rate. Pure function
    of (model JSON, seed) — byte-identical in every process."""
    import random

    from ..utils.workload import sample_from_hist
    rng_arr = random.Random(f"{seed}:arrivals")
    rng_key = random.Random(f"{seed}:keys")
    rng_size = random.Random(f"{seed}:sizes")

    pl = model.data["planes"].get(plane, {})
    ia = pl.get("interarrival_us", {})
    ia_total = sum(ia.get("buckets") or [])
    rate = float(pl.get("rate_hz", 0.0))
    alpha = float(model.data["popularity"].get("clients", {})
                  .get("alpha", 1.0))
    keys, cum, total_w = _weighted_keys(model, alpha)
    addr_map = client_addr_map(model)
    bh = model.data["conn"].get("bytes", {})
    bh_total = sum(bh.get("buckets") or [])

    raws = []
    for _ in range(max(1, int(max_arrivals))):
        if ia_total > 0:
            raws.append(sample_from_hist(rng_arr, ia) / 1e6)
        elif rate > 0:
            raws.append(1.0 / rate)
        else:
            raws.append(0.001)
    # mean-true rescale: log2 buckets preserve SHAPE but uniform
    # within-bucket resampling biases the mean (up to ~1.5x for a
    # single-bucket mass) — scale the draws so the schedule's mean
    # inter-arrival equals the model's measured sum/count exactly,
    # which is what the fidelity rate-ratio gate holds replay to
    if ia_total > 0 and ia.get("count", 0) > 0:
        true_mean = (ia["sum"] / ia["count"]) / 1e6
        raw_mean = sum(raws) / len(raws)
        if raw_mean > 0 and true_mean > 0:
            factor = true_mean / raw_mean
            raws = [r * factor for r in raws]

    arrivals, t = [], 0.0
    import bisect
    for dt in raws:
        t += dt
        if duration_s and t > duration_s:
            break
        key = keys[bisect.bisect_right(cum, rng_key.randrange(total_w))]
        nbytes = int(sample_from_hist(rng_size, bh)) if bh_total else 2048
        arrivals.append({
            "t": round(t, 9),
            "key": key,
            "src": addr_map.get(key, "127.0.0.1"),
            "bytes": max(1, min(PAYLOAD_CAP, nbytes)),
        })
    return {"seed": int(seed), "speed": float(speed), "plane": plane,
            "arrivals": arrivals}


def schedule_hash(schedule: dict) -> str:
    """sha256 over the canonical JSON form — the determinism receipt
    two same-seed replays must agree on."""
    blob = json.dumps(schedule, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


# ------------------------------------------------------------ replay world

class ReplayWorld:
    """Backends + group + upstream + one TcpLB — the candidate config
    under replay (the storm _LBWorld shape, minus scenario extras)."""

    def __init__(self, alias: str = "replay", n_backends: int = 2,
                 workers: int = 1, overload: str = "static",
                 max_sessions: int = 0):
        from ..components.elgroup import EventLoopGroup
        from ..components.servergroup import (HealthCheckConfig,
                                                       ServerGroup)
        from ..components.tcplb import TcpLB
        from ..components.upstream import Upstream
        self.backends = [_fleetlib.EchoBackend(b"%d" % i)
                         for i in range(n_backends)]
        self.elg = EventLoopGroup(f"{alias}-elg", workers)
        self.group = ServerGroup(
            f"{alias}-g", self.elg,
            HealthCheckConfig(timeout_ms=500, period_ms=200, up=1,
                              down=100), "wrr")
        for i, b in enumerate(self.backends):
            self.group.add(f"b{i}", "127.0.0.1", b.port)
        if not _fleetlib.wait_for(
                lambda: sum(1 for s in self.group.servers if s.healthy)
                == n_backends, 10):
            raise TimeoutError("replay backends never came healthy")
        self.ups = Upstream(f"{alias}-u")
        self.ups.add(self.group)
        self.lb = TcpLB(alias, self.elg, self.elg, "127.0.0.1", 0,
                        self.ups, protocol="tcp", overload=overload,
                        max_sessions=max_sessions)
        self.lb.start()

    def close(self) -> None:
        self.lb.stop()
        self.group.close()
        for b in self.backends:
            b.close()
        self.elg.close()


def _payload(n: int) -> bytes:
    return (b"vproxy-replay---" * (n // 16 + 1))[:n]


def replay_schedule(schedule: dict, port: int, timeout: float = 10.0,
                    max_inflight: int = 64) -> dict:
    """Dispatch every arrival at its deadline (absolute offsets — a
    slow session never skews later arrivals) with shed-vs-fail
    accounting: `{"ok","fail","shed","ids","lat_s","span_s","late_s"}`.
    `speed` comes from the schedule; sessions run on daemon threads
    capped at max_inflight so an overloaded target back-pressures the
    pacer visibly (late_s) instead of silently thinning the offered
    rate."""
    speed = max(1e-9, float(schedule.get("speed", 1.0)))
    lock = threading.Lock()
    stats: dict = {"ok": 0, "fail": 0, "shed": 0, "ids": {}}
    lats: list = []
    sem = threading.BoundedSemaphore(max_inflight)
    threads = []

    def one(arr: dict) -> None:
        t0 = time.monotonic()
        try:
            sid = _fleetlib.one_session(port, _payload(arr["bytes"]),
                                        timeout, src_ip=arr["src"])
        except OSError as e:
            with lock:
                stats["shed" if getattr(e, "shed", False)
                      else "fail"] += 1
        else:
            with lock:
                stats["ok"] += 1
                stats["ids"][sid] = stats["ids"].get(sid, 0) + 1
                lats.append(time.monotonic() - t0)
        finally:
            sem.release()

    t_start = time.monotonic()
    late = 0.0
    for arr in schedule["arrivals"]:
        due = t_start + arr["t"] / speed
        delay = due - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        else:
            late = max(late, -delay)
        sem.acquire()
        th = threading.Thread(target=one, args=(arr,), daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=timeout + 5)
    stats["span_s"] = round(time.monotonic() - t_start, 6)
    stats["late_s"] = round(late, 6)
    stats["lat_s"] = sorted(lats)
    return stats


# ----------------------------------------------------------- fidelity gate

def fidelity(source_model, recap_model, speed: float, k: int = 5,
             rate_band=(0.9, 1.1), plane: str = "accept") -> dict:
    """Compare the RE-CAPTURED replay traffic against the source model:
    top-K client identity (>= 4/5 of the source's heavy hitters must
    reappear in the replay's sketch, modulo the loopback alias map) and
    per-plane offered-rate shape (recaptured rate / source rate must
    land within rate_band of the replay speed)."""
    amap = client_addr_map(source_model)
    src_top = [kk for kk, _c, _e in
               source_model.data["popularity"].get("clients", {})
               .get("top", [])][:k]
    want = {amap.get(kk, kk) for kk in src_top}
    got = {kk for kk, _c, _e in
           recap_model.data["popularity"].get("clients", {})
           .get("top", [])}
    hits = len(want & got)
    src_rate = source_model.plane_rate(plane)
    rep_rate = recap_model.plane_rate(plane)
    ratio = rep_rate / (src_rate * speed) if src_rate > 0 else 0.0
    out = {
        "topk_want": sorted(want), "topk_hits": hits,
        "rate_source_hz": round(src_rate, 4),
        "rate_replay_hz": round(rep_rate, 4),
        "gates": {
            "topk_identity": _gate(hits, max(1, math.ceil(len(want)
                                                          * 4 / 5)), ">="),
            "rate_ratio_lo": _gate(ratio, rate_band[0], ">="),
            "rate_ratio_hi": _gate(ratio, rate_band[1], "<="),
        },
    }
    out["pass"] = all(g["pass"] for g in out["gates"].values())
    return out


# --------------------------------------------------------- capacity maths

def capacity_row(model, node_capacity_rps: float,
                 users: int = 10_000_000, peak_factor: float = 2.0) -> dict:
    """Nodes needed for a diurnal fleet: the model's mean per-client
    arrival rate (plane rate / distinct heads the sketch saw) scaled to
    `users` at `peak_factor`x diurnal peak, divided by the measured
    per-node serving capacity. Planning arithmetic from MEASURED
    numbers — both inputs ride in the row so the estimate audits."""
    top = model.data["popularity"].get("clients", {}).get("top", [])
    heads = max(1, len(top))
    per_user = model.plane_rate("accept") / heads
    demand = users * per_user * peak_factor
    nodes = (math.ceil(demand / node_capacity_rps)
             if node_capacity_rps > 0 and demand > 0 else 0)
    return {"users": users, "peak_factor": peak_factor,
            "per_user_rps": round(per_user, 6),
            "peak_demand_rps": round(demand, 2),
            "node_capacity_rps": round(node_capacity_rps, 2),
            "nodes_needed": nodes}


# ------------------------------------------------------------- full replay

def run_replay(model, seed: int = None, speed: float = 1.0,
               max_arrivals: int = MAX_ARRIVALS_DEFAULT,
               duration_s: float = 0.0, n_backends: int = 2,
               workers: int = 1, overload: str = "static",
               max_sessions: int = 0, timeout: float = 10.0,
               served_floor: float = 0.9, p99_ms: float = 500.0,
               fidelity_gate: bool = False, rate_band=(0.9, 1.1)) -> dict:
    """capture twin end-to-end: schedule -> ReplayWorld -> SLO verdicts
    (-> fidelity). With fidelity_gate the process-global sketch and
    workload windows are reset around the replay (run it in a dedicated
    process, the bench/storm idiom) so the re-capture sees ONLY the
    synthesized traffic."""
    _fleetlib.select_device()
    if seed is None:
        seed = model.seed if model.seed is not None else 0
    sched = build_schedule(model, seed, speed=speed,
                           max_arrivals=max_arrivals,
                           duration_s=duration_s)
    shash = schedule_hash(sched)
    recap = None
    if fidelity_gate:
        from ..utils import sketch, workload
        sketch.reset()
        workload.reset()
    world = ReplayWorld(n_backends=n_backends, workers=workers,
                        overload=overload, max_sessions=max_sessions)
    try:
        if fidelity_gate:
            from ..utils import workload
            workload.capture_start()
        res = replay_schedule(sched, world.lb.bind_port, timeout=timeout)
        if fidelity_gate:
            from ..utils.workload import WorkloadModel, capture_stop
            capture_stop()
            recap = WorkloadModel.fit(seed=seed)
    finally:
        world.close()

    total = res["ok"] + res["fail"] + res["shed"]
    served = res["ok"] / total if total else 0.0
    p99 = _fleetlib.percentile(res["lat_s"], 99) * 1e3
    slo = {
        "hard_failures": _gate(res["fail"], 0, "<="),
        "served_ratio": _gate(served, served_floor, ">="),
        "p99_ms": _gate(p99, p99_ms, "<="),
    }
    report = {
        "seed": int(seed), "speed": float(speed),
        "schedule_hash": shash,
        "arrivals": len(sched["arrivals"]),
        "span_s": res["span_s"], "late_s": res["late_s"],
        "config": {"n_backends": n_backends, "workers": workers,
                   "overload": overload, "max_sessions": max_sessions},
        "results": {"ok": res["ok"], "fail": res["fail"],
                    "shed": res["shed"], "ids": res["ids"]},
        "p50_ms": round(_fleetlib.percentile(res["lat_s"], 50) * 1e3, 3),
        "p99_ms": round(p99, 3),
        "slo": slo,
    }
    if fidelity_gate and recap is not None:
        report["fidelity"] = fidelity(model, recap, speed,
                                      rate_band=rate_band)
        report["recaptured"] = recap.data
    report["pass"] = (all(g["pass"] for g in slo.values())
                      and (report.get("fidelity", {}).get("pass", True)))
    return report


# -------------------------------------------------- seeded source traffic

def drive_zipf_mix(port: int, seed: int, n: int = 200, clients: int = 8,
                   alpha: float = 1.2, keys: int = 12,
                   payload_bytes: int = 2048, timeout: float = 10.0,
                   pace_s: float = 0.0) -> dict:
    """The seeded SOURCE mix for bench/storm capture loops: n sessions
    across `clients` threads, each session's loopback source address
    drawn Zipf(alpha) over `keys` synthetic clients (127.0.1.x) — real
    traffic through the real accept path, with ground-truth heavy
    hitters known in advance. Returns {"ok","fail","shed",
    "true_top": [addr, ...]} ranked hottest first."""
    import random
    rng = random.Random(f"{seed}:mix")
    addrs = [f"127.0.1.{10 + i}" for i in range(keys)]
    weights = [(i + 1) ** -alpha for i in range(keys)]
    draws = rng.choices(range(keys), weights=weights, k=n)
    payload = _payload(payload_bytes)
    lock = threading.Lock()
    stats: dict = {"ok": 0, "fail": 0, "shed": 0}
    counts = [0] * keys

    def worker(idxs) -> None:
        for i in idxs:
            if pace_s:
                time.sleep(pace_s)
            try:
                _fleetlib.one_session(port, payload, timeout,
                                      src_ip=addrs[i])
            except OSError as e:
                with lock:
                    stats["shed" if getattr(e, "shed", False)
                          else "fail"] += 1
            else:
                with lock:
                    stats["ok"] += 1
                    counts[i] += 1
    ts = [threading.Thread(target=worker, args=(draws[c::clients],))
          for c in range(clients)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    order = sorted(range(keys), key=lambda i: -counts[i])
    stats["true_top"] = [addrs[i] for i in order if counts[i] > 0]
    return stats


# ------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--model", help="workload model JSON file")
    src.add_argument("--url", help="live GET /workload URL")
    ap.add_argument("--seed", type=int, default=None,
                    help="schedule seed (default: the model's seed, "
                         "else 0); echoed into the report")
    ap.add_argument("--speed", type=float, default=1.0,
                    help="replay rate multiplier (2.0 = twice as fast)")
    ap.add_argument("--max-arrivals", type=int,
                    default=MAX_ARRIVALS_DEFAULT)
    ap.add_argument("--duration", type=float, default=0.0,
                    help="cap schedule span (source-time seconds)")
    ap.add_argument("--backends", type=int, default=2)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--overload", default="static",
                    choices=("static", "adaptive"))
    ap.add_argument("--max-sessions", type=int, default=0)
    ap.add_argument("--served-floor", type=float, default=0.9)
    ap.add_argument("--p99-ms", type=float, default=500.0)
    ap.add_argument("--fidelity", action="store_true",
                    help="re-capture the replayed traffic and gate "
                         "top-K identity + rate shape vs the source")
    ap.add_argument("--hash-only", action="store_true",
                    help="print the schedule hash and exit (the "
                         "cross-process determinism check)")
    ap.add_argument("--device", default=None,
                    help="serve on this torch device (default: "
                         "VPROXY_TPU_TORCH_DEVICE, else cuda; no GPU "
                         "raises unless cpu is asked for)")
    ap.add_argument("--out", help="write the JSON report here")
    args = ap.parse_args(argv)

    model = load_model(args.model or args.url)
    seed = args.seed if args.seed is not None else (model.seed or 0)
    if args.hash_only:
        sched = build_schedule(model, seed, speed=args.speed,
                               max_arrivals=args.max_arrivals,
                               duration_s=args.duration)
        print(schedule_hash(sched))
        return 0
    _fleetlib.select_device(args.device)
    report = run_replay(
        model, seed=seed, speed=args.speed,
        max_arrivals=args.max_arrivals, duration_s=args.duration,
        n_backends=args.backends, workers=args.workers,
        overload=args.overload, max_sessions=args.max_sessions,
        served_floor=args.served_floor, p99_ms=args.p99_ms,
        fidelity_gate=args.fidelity)
    blob = json.dumps(report, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(blob + "\n")
    print(blob)
    print(f"replay: {'PASS' if report['pass'] else 'FAIL'} "
          f"(seed={report['seed']} speed={report['speed']} "
          f"hash={report['schedule_hash'][:12]})", file=sys.stderr)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
