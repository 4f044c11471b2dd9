"""engine/encode spans (the host encode of one device batch's queries,
pad rows included) over their batch size, mean over the sampled
batches, in us (rules/engine.py _fused_hint_q, _cidr_q)."""


def read(ctx):
    d = [s["dur_ns"] / 1e3 / s["batch"] for s in ctx["spans"]
         if s["plane"] == "engine" and s["span"] == "encode"
         and s.get("batch")]
    return sum(d) / len(d) if d else None
