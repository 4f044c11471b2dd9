"""Share of the dispatcher's dispatch and deliver spans that its thread
spent off the CPU (waiting for the interpreter lock, or descheduled):
100 x (1 - their cpu_ns sum / their dur_ns sum), in % (rules/service.py;
utils/trace.Span)."""


def read(ctx):
    sp = [s for s in ctx["spans"] if s["plane"] == "engine"
          and s["span"] in ("dispatch", "deliver") and "cpu_ns" in s]
    dur = sum(s["dur_ns"] for s in sp)
    if not dur:
        return None
    return 100.0 * (1.0 - sum(s["cpu_ns"] for s in sp) / dur)
