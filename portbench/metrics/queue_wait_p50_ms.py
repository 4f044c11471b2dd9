"""Median of the engine/queue_wait spans (submit -> its batch starts) of
the window's sampled queries, in ms (rules/service.py)."""


def read(ctx):
    w = sorted(s["dur_ns"] for s in ctx["spans"]
               if s["plane"] == "engine" and s["span"] == "queue_wait")
    return w[(len(w) - 1) // 2] / 1e6 if w else None
