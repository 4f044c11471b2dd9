"""The window's tail, from the harness's own clock."""


def p99(xs: list) -> float:
    """Nearest-rank 99th percentile."""
    s = sorted(xs)
    return s[max(0, -(-99 * len(s) // 100) - 1)]


def p99_ms(ctx):
    """read(ctx) of the latency_p99_ms.<cell> metrics."""
    lat = ctx["latencies_s"]
    return p99(lat) * 1e3 if lat else None
