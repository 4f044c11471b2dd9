"""Median of the engine/callback_wait spans (a sampled query's answer
queued on its event loop by run_on_loop -> its callback starts there)
of the window's sampled queries, in ms (rules/service.py _traced_run)."""


def read(ctx):
    w = sorted(s["dur_ns"] for s in ctx["spans"]
               if s["plane"] == "engine" and s["span"] == "callback_wait")
    return w[(len(w) - 1) // 2] / 1e6 if w else None
