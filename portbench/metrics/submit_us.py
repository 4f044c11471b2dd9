"""engine/submit spans (ClassifyService._submit on the submitting loop:
the queue lock, the request, the dispatcher's wake-up), mean, in us
(rules/service.py)."""


def read(ctx):
    d = [s["dur_ns"] / 1e3 for s in ctx["spans"]
         if s["plane"] == "engine" and s["span"] == "submit"]
    return sum(d) / len(d) if d else None
