"""Answers delivered in the traced run's window over its seconds: the
end-to-end lookups_per_s, read per layer in the cidr cells, where runs
of one code spread too widely for an end-to-end bound (PERF.md §2).
Tracing costs the rate 15-20%, so it reads below an untraced run."""


def read(ctx):
    return ctx["lookups_per_s"] or None
