"""traceview — offline text waterfalls for committed trace artifacts.

The port's copy of tools/traceview.py, rendering with the port's
utils/trace.render_spans (the same waterfall the port's live `trace
<id>` command shows). It reads JSON and touches no device.

Reads the `bench.py --trace` stage's artifact (BENCH_r*_trace.json:
`slowest_traces` = [{"trace": id, "total_us": ..., "spans": [...]}]),
a `GET /trace?id=` dump ({"trace": id, "spans": [...]}) or a bare
span list, and renders the same per-span waterfall the live
`trace <id>` command shows — so a committed BENCH round's worst
requests stay inspectable without a live process.

    python -m vproxy_tpu_torch.tools.traceview TRACE.json
    python -m vproxy_tpu_torch.tools.traceview TRACE.json --id 42
    curl -s lb:18776/trace?id=42 | python -m vproxy_tpu_torch.tools.traceview -

The attribution table (per-stage p50/p99) is printed when the artifact
carries one (`stage_table`).
"""
from __future__ import annotations

import argparse
import json
import sys

from ..utils.trace import render_spans


def _traces_of(doc) -> list:
    """-> [(trace_id, spans)] from any of the accepted shapes."""
    if isinstance(doc, list):  # bare span list
        if doc and isinstance(doc[0], dict) and "span" in doc[0]:
            return [(doc[0].get("trace", 0), doc)]
        return [(t.get("trace", 0), t.get("spans", [])) for t in doc]
    if isinstance(doc, dict):
        if "spans" in doc:  # one GET /trace?id= dump
            return [(doc.get("trace", 0), doc["spans"])]
        for key in ("slowest_traces", "traces"):
            if key in doc:
                return _traces_of(doc[key])
    return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="artifact json, or - for stdin")
    ap.add_argument("--id", type=int, default=0,
                    help="render only this trace id")
    ap.add_argument("--width", type=int, default=48)
    ap.add_argument("--limit", type=int, default=0,
                    help="render at most N traces (0 = all)")
    args = ap.parse_args(argv)
    if args.path == "-":
        doc = json.load(sys.stdin)
    else:
        with open(args.path) as f:
            doc = json.load(f)

    table = (doc.get("stage_table") or doc.get("trace_stage_table")) \
        if isinstance(doc, dict) else None
    if table and not args.id:
        w = max(len(k) for k in table) + 2
        print(f"{'stage':<{w}} {'n':>8} {'p50_us':>10} {'p99_us':>10}")
        for k, v in table.items():
            print(f"{k:<{w}} {v['n']:>8} {v['p50_us']:>10} "
                  f"{v['p99_us']:>10}")
        print()

    traces = _traces_of(doc)
    if args.id:
        traces = [(tid, sp) for tid, sp in traces if tid == args.id]
        if not traces:
            print(f"trace {args.id}: not in this artifact",
                  file=sys.stderr)
            return 1
    if args.limit > 0:
        traces = traces[: args.limit]
    for tid, spans in traces:
        if not spans:
            continue
        for line in render_spans(tid, spans, args.width):
            print(line)
        print()
    return 0


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except BrokenPipeError:  # `traceview ... | head` is the normal use
        raise SystemExit(0)
