"""The card's peaks and a kernel's share of its roofline.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35 TB/s of HBM3, and INT32 issue of 132 SMs x 64 lanes x 1.98 GHz.
The kernels here compare and hash bytes: integer work, no tensor cores.

A batch's least time is the larger of its bytes over the HBM rate and
its integer ops over the INT32 rate. The bytes and ops come from the
cell's own queries (Deployment.work: each query read once, its answer
written once, one op a byte at least), never from arrays the program
built, so a later encoder or kernel is held to the same work. The share
is that least time, summed over the queries the device answered in the
profiled stretch, over the time the profiler saw the kernel run there.
"""
from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9


def kernel_s(ctx: dict, pattern: str) -> float:
    """Seconds the device spent in kernels whose name matches `pattern`
    (a regular expression) in the profiled stretch."""
    rx = re.compile(pattern)
    t0, t1 = ctx["prof"]["t0"], ctx["prof"]["t1"]
    return sum(min(b, t1) - max(a, t0)
               for cat, name, a, b in ctx["prof"]["device"]
               if cat == "kernel" and rx.search(name)) / 1e6


def share(ctx: dict, pattern: str, kind: str):
    """% of the roofline for the kernels matching `pattern`, over the
    device batches of service kind `kind` in the stretch; None where the
    stretch holds none."""
    q = ctx["prof_delta"]["by_kind"].get(kind, (0, 0))[1]
    ks = kernel_s(ctx, pattern)
    if q <= 0 or ks <= 0:
        return None
    nbytes, ops = ctx["work_per_query"]
    least = max(q * nbytes / HBM_BYTES_PER_S, q * ops / INT_OPS_PER_S)
    return 100.0 * least / ks
