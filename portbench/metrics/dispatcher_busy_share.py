"""Share of the dispatcher thread's traced time not spent waiting for
work: 100 x (1 - idle / (the end of the last dispatcher-thread span -
the start of the first)), in % (rules/service.py _run, _IdleWaits).
Idle is the engine/dispatcher_idle spans' `idle_ns`, which counts every
wait while tracing, those that woke for batches with no sampled query
included; the first span starts at the earliest such wait (`since_ns`).
None where the program does not trace its batches' delivery
(engine/deliver), and so not its whole cycle."""

DISPATCHER = frozenset({"dispatcher_idle", "dispatch", "encode",
                        "flow_slots", "upload", "launch", "d2h_sync",
                        "deliver", "host_index"})


def read(ctx):
    sp = [s for s in ctx["spans"]
          if s["plane"] == "engine" and s["span"] in DISPATCHER]
    if not any(s["span"] == "deliver" for s in sp):
        return None
    t0 = min(s.get("since_ns", s["t_ns"]) for s in sp)
    t1 = max(s["t_ns"] + s["dur_ns"] for s in sp)
    if t1 <= t0:
        return None
    idle = sum(s.get("idle_ns", s["dur_ns"]) for s in sp
               if s["span"] == "dispatcher_idle")
    return 100.0 * (1.0 - idle / (t1 - t0))
