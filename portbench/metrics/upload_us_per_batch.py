"""engine/upload spans (one batch's query arrays copied to the card:
torchenv.tables_from_reference), mean, in us (rules/engine.py
_upload_q)."""


def read(ctx):
    d = [s["dur_ns"] / 1e3 for s in ctx["spans"]
         if s["plane"] == "engine" and s["span"] == "upload"]
    return sum(d) / len(d) if d else None
