"""% of the profiled stretch in which the device ran no kernel, copy or
memset."""


def read(ctx):
    w = ctx["prof"]["window_s"]
    return 100.0 * (1.0 - ctx["busy_s"] / w) if w > 0 and ctx["busy_s"] > 0 \
        else None
