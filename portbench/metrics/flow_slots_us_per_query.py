"""engine/flow_slots spans (the Maglev slots of one classify+pick batch,
hashed on the host) over their batch size, mean over the sampled
batches, in us (rules/engine.py _fused_slots -> maglev.flow_slots)."""


def read(ctx):
    d = [s["dur_ns"] / 1e3 / s["batch"] for s in ctx["spans"]
         if s["plane"] == "engine" and s["span"] == "flow_slots"
         and s.get("batch")]
    return sum(d) / len(d) if d else None
