"""engine/dispatch span (encode, upload and launch of one device batch)
over its batch size, mean over the sampled batches, in us
(rules/service.py, rules/engine.py, rules/maglev.py FusedPair)."""


def read(ctx):
    d = [s["dur_ns"] / 1e3 / s["batch"] for s in ctx["spans"]
         if s["plane"] == "engine" and s["span"] == "dispatch"
         and s.get("batch")]
    return sum(d) / len(d) if d else None
