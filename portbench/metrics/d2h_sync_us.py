"""engine/d2h_sync spans (the pull of one batch's answers, waiting on
the device), mean, in us (rules/service.py _pull -> torchenv.to_host)."""


def read(ctx):
    d = [s["dur_ns"] / 1e3 for s in ctx["spans"]
         if s["plane"] == "engine" and s["span"] == "d2h_sync"]
    return sum(d) / len(d) if d else None
