"""engine/deliver spans' `handoffs` (one batch's delivery: the loops its
callbacks were handed to, one hand-off each, plus the callbacks run
inline on the dispatcher thread), mean over the sampled batches
(rules/service.py _deliver). None where the program's deliver spans
carry no such field."""


def read(ctx):
    h = [s["handoffs"] for s in ctx["spans"]
         if s["plane"] == "engine" and s["span"] == "deliver"
         and "handoffs" in s]
    return sum(h) / len(h) if h else None
