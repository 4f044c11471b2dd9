"""Queries per device batch over the window: ClassifyStats.by_kind, the
window's change, all kinds together (rules/service.py)."""


def read(ctx):
    b = sum(v[0] for v in ctx["window_delta"]["by_kind"].values())
    q = sum(v[1] for v in ctx["window_delta"]["by_kind"].values())
    return q / b if b else None
