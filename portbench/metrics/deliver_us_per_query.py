"""engine/deliver spans (one batch's delivery on the dispatcher thread:
latency records, a closure and a run_on_loop a query) over their batch
size, mean over the sampled batches, in us (rules/service.py
_deliver)."""


def read(ctx):
    d = [s["dur_ns"] / 1e3 / s["batch"] for s in ctx["spans"]
         if s["plane"] == "engine" and s["span"] == "deliver"
         and s.get("batch")]
    return sum(d) / len(d) if d else None
