"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix and
metrics are found by name (portbench/spec.py). The run builds the
deployment's tables and the mix's query pools, the same in every run,
orders each pool by the seed, warms every batch shape its traffic uses,
drives the program's entry points from closed-loop clients on the
program's own event loops for a warm-up and then for `--seconds`, and
checks a seeded sample of the answers against the plain reference once
the window has closed and the program's state is freed.

--trace 0 prints the cell's end-to-end metrics; --trace 1 samples the
program's spans, profiles a steady stretch of the window and prints the
per-layer metrics instead. The last line of standard output is one JSON
object; the host's state over the window (CPU clock, load, the
process's CPU time a lookup), then the checks and their limits, close
standard error. Without a CUDA
card, or if JAX or the JAX package got loaded, the run exits non-zero
and prints no result.
"""
from __future__ import annotations

import time

T_PROC0 = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BANNED = frozenset({"jax", "jaxlib", "flax", "vproxy_tpu"})
DRAIN_S = 60.0        # how long past the close an answer may still come
PROFILE_S = 2.0       # the profiled stretch, at the end of the warm-up
TRACE_EVERY = 256     # 1-in-N queries sampled for spans in a traced run


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: vproxy_tpu_torch is not vproxy_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


def buckets(n: int) -> list:
    """The batch shapes the service pads batches of 1..n queries to."""
    from vproxy_tpu_torch.rules.engine import pad_batch
    from vproxy_tpu_torch.rules.service import PAD_LO
    return sorted({pad_batch(k, lo=PAD_LO) for k in range(1, n + 1)})


def host_state() -> dict:
    """The host under the run, read from /proc (Linux): the CPUs' mean
    clock, the load average, and the CPU model."""
    mhz, model = [], ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                k, _, v = line.partition(":")
                if k.strip() == "cpu MHz":
                    mhz.append(float(v))
                elif k.strip() == "model name" and not model:
                    model = v.strip()
    except OSError:
        pass
    return {"cpu_mhz": sum(mhz) / len(mhz) if mhz else None,
            "load_1m": os.getloadavg()[0], "cpu_model": model,
            "cpus": len(mhz)}


def ordered(pool: list, rng) -> list:
    """The pool in the run's own order."""
    return [pool[i] for i in rng.permutation(len(pool)).tolist()]


def stats_snapshot() -> dict:
    from vproxy_tpu_torch.rules.service import ClassifyService
    st = ClassifyService.get().stats
    with st.lock:
        return {"queries": st.queries, "device_queries": st.device_queries,
                "oracle_queries": st.oracle_queries,
                "inline_fast": st.inline_fast, "failovers": st.failovers,
                "by_kind": {k: tuple(v[:2]) for k, v in st.by_kind.items()}}


def stats_delta(a: dict, b: dict) -> dict:
    d = {k: b[k] - a[k] for k in a if k != "by_kind"}
    d["by_kind"] = {k: (v[0] - a["by_kind"].get(k, (0, 0))[0],
                        v[1] - a["by_kind"].get(k, (0, 0))[1])
                    for k, v in b["by_kind"].items()}
    return d


def control_entries(dep, names: list, pools: dict) -> dict:
    """The control in the program's place: each entry answers from the
    plain reference with one stated guarantee broken, on the submitting
    loop, from the plain query itself."""
    from portbench.deploy import Entry
    answer = dep.reference()

    def submit_for(e):
        def submit(q, done, loop):
            loop.run_on_loop(lambda: done(answer(e, q, control=True)))
        return submit
    return {e: Entry(e, submit_for(e), lambda q: q, None, None)
            for e in names}


def run_cell(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
             traced: bool, metrics: list, control: bool = False) -> dict:
    """Build, warm, drive, check. -> the result object (printed by main).
    metrics: the cell's end-to-end metric entries (traced False) or its
    per-layer ones (traced True). control=True drives the control
    (control_entries) instead of the program and skips the warming of
    device batches."""
    os.environ["VPROXY_TPU_CLASSIFY"] = mix["mode"]
    if traced:
        os.environ["VPROXY_TPU_TRACE_BUF"] = str(1 << 20)
    import torch
    from portbench import loadgen, spec, tracing
    from portbench.latency import p99
    from vproxy_tpu_torch.rules.service import ClassifyService
    from vproxy_tpu_torch.utils import trace
    ClassifyService.reset()  # the singleton reads the mode once
    import numpy as np
    seed = seed % (1 << 62)

    t_imp = time.monotonic()
    dep = spec.deploy_module(cfg["kind"]).build(cfg)
    t_built = time.monotonic()
    names = mix["entries"]
    plan = [names[c % len(names)] for c in range(mix["clients"])]
    # the tables and each pool's queries are the same in every run; the
    # seed orders each pool and draws the checked sample
    rng = np.random.default_rng(seed)
    pools = {e: ordered(dep.pool(e, mix), rng) for e in names}
    entries = control_entries(dep, names, pools) if control \
        else dep.entries
    payloads = {e: [entries[e].payload(q) for q in pools[e]] for e in names}
    t_pools = time.monotonic()
    for e in names if not control else ():
        for cap in buckets(plan.count(e)):  # every batch shape it can form
            entries[e].warm(payloads[e][:cap], cap)
    t_warm = time.monotonic()
    # the set-up's objects (tables, pools) move out of the collector's
    # reach, so no full collection over them lands inside the window
    gc.collect()
    gc.freeze()
    if traced:
        trace.configure(TRACE_EVERY)
    win = loadgen.Window()
    cl = loadgen.ClosedLoop(entries, payloads, plan, mix["event_loops"],
                            win, trace.maybe_sample if traced else None)
    on_card = torch.cuda.is_available()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    try:
        cl.start()
        time.sleep(mix["warmup_s"])
        prof = None
        if traced:
            # the profiled stretch closes the warm-up: a profiler started
            # inside the measured window has come back empty on the card
            win.t_sample = time.monotonic()
            prof = tracing.profile(PROFILE_S, stats_snapshot)
        s0 = stats_snapshot()
        host0 = host_state()
        pc0 = time.process_time()
        win.open(seconds)
        setup_s = win.t_start - T_PROC0
        time.sleep(max(0.0, win.t_end - time.monotonic()))
        s1 = stats_snapshot()
        pc1 = time.process_time()
        host1 = host_state()
        t_gave = cl.drain(DRAIN_S)
        waiting = cl.waiting()
    finally:
        cl.close()
    if traced:
        trace.configure(0)
    found = banned_modules()
    if found:
        raise SystemExit(f"loaded in this process: {', '.join(found)}")
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": cell["chips"],
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
              if on_card else 0}
    tallies = cl.tallies
    lat = [x for t in tallies for x in t.lat]
    lat += [t_gave - t0 for t0 in waiting if t0 >= win.t_start]
    attempted = sum(t.submitted for t in tallies)
    failed = len(waiting) + sum(t.errors for t in tallies)
    answers = {}
    inconsistent = 0
    for t in tallies:
        for k, v in zip(t.keys, t.answers):
            if answers.setdefault(k, v) != v:
                inconsistent += 1
    spans = tracing.sampled_spans([i for t in tallies for i in t.tids]) \
        if traced else []
    work = None
    if traced:
        ws = [[dep.work(e, q) for q in pools[e]] for e in names]
        work = tuple(min(sum(w[j] for w in we) / len(we) for we in ws)
                     for j in (0, 1))

    # free the program's state before the reference runs
    t_ref = time.monotonic()
    gc.unfreeze()
    ClassifyService.reset()
    answer_of = dep.reference()
    del dep, cl, payloads, entries
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    rng = random.Random(seed ^ 0x5EED)
    keys = sorted(answers)
    sample = rng.sample(keys, min(mix["check_sample"], len(keys)))
    mismatches = 0
    for e, i in sample:
        if answer_of(e, pools[e][i]) != answers[(e, i)]:
            mismatches += 1
    checks = {"mismatches": {"value": mismatches, "limit": 0,
                             "of": len(sample)},
              "inconsistent": {"value": inconsistent, "limit": 0},
              "unanswered": {"value": failed, "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) \
        and attempted > 0

    rate = sum(t.done_in_window for t in tallies) / seconds
    if not traced:
        e2e = {"lookups_per_s": rate,
               "latency_p99_ms": p99(lat) * 1e3 if lat else None,
               "device_peak_mb": device["memory_peak_bytes"] / 1e6,
               "setup_s": setup_s}
        out = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
               for m in metrics}
        extra = {}
    else:
        ctx = {"window_delta": stats_delta(s0, s1),
               "prof_delta": stats_delta(*prof["marks"]), "prof": prof,
               "busy_s": tracing.busy_s(prof), "spans": spans,
               "work_per_query": work, "latencies_s": lat,
               "lookups_per_s": rate}
        out = {}
        for m in metrics:
            v = spec.metric_reader(m["name"])(ctx)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = ctx["busy_s"]
        device["window_s"] = prof["window_s"]
        extra = {"breakdown": tracing.breakdown(prof, spans)}
    wd = stats_delta(s0, s1)
    done = sum(t.done_in_window for t in tallies)
    host = {"window_cpu_s": pc1 - pc0,
            "cpu_us_per_lookup": (pc1 - pc0) / done * 1e6 if done else None,
            "cpu_mhz_open": host0["cpu_mhz"], "cpu_mhz_close": host1["cpu_mhz"],
            "load_1m_open": host0["load_1m"], "load_1m_close": host1["load_1m"],
            "cpus": host1["cpus"], "cpu_model": host1["cpu_model"]}
    info = {"window_queries": wd["queries"], "failovers": wd["failovers"],
            "p99_ms": p99(lat) * 1e3 if lat else None,
            "device_batches": sum(v[0] for v in wd["by_kind"].values()),
            "latencies": len(lat), "seed": seed,
            "setup_parts_s": {"imports": t_imp - T_PROC0,
                              "build": t_built - t_imp,
                              "pools": t_pools - t_built,
                              "warm_shapes": t_warm - t_pools,
                              "warm_load": win.t_start - t_warm},
            "check_s": time.monotonic() - t_ref}
    if traced:
        info["profiled"] = {**prof["events"], "spans": len(spans)}
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": out, "device": device, **extra, "info": info,
            "host": host, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="1: drive the control (the reference with one "
                    "stated guarantee broken) in the program's place; "
                    "its result has to read not correct")
    args = ap.parse_args(argv)
    from portbench import spec
    sp = spec.benchmark()
    cell = spec.cell(sp, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = run_cell(cell, spec.config(sp, cell["config"]),
                   spec.traffic(cell["traffic"]), args.seed, args.seconds,
                   bool(args.trace),
                   spec.metrics_for(sp, args.workload, "per_layer"
                                    if args.trace else "end_to_end"),
                   control=bool(args.control))
    print("host " + " ".join(f"{k} {v}" for k, v in res["host"].items()),
          file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
