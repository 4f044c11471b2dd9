"""`python -m vproxy_tpu_torch.tools.vlint` — run the analyzer over
the port from the repo root.

Exit codes: 0 clean (baselined findings allowed), 1 open findings or
stale baseline entries, 2 the analyzer itself failed. `--json` emits
the snapshot row; `--all` lists baselined findings too;
`--no-baseline` shows the raw findings (the triage view).
"""
from __future__ import annotations

import json
import os
import sys

from . import run_all, snapshot


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    root = None
    for i, a in enumerate(argv):
        if a == "--root" and i + 1 < len(argv):
            root = argv[i + 1]
    if root is None:
        root = os.getcwd()
    baseline_path = "" if "--no-baseline" in argv else None
    rep = run_all(root, baseline_path=baseline_path)
    if "--json" in argv:
        print(json.dumps(snapshot(rep), indent=2))
    else:
        shown = rep.findings if "--all" in argv else rep.open_findings
        for f in shown:
            print(f.format())
        for k in rep.stale_baseline:
            print(f"[baseline] stale entry {k!r}: finding no longer "
                  f"occurs — prune it from baseline.toml")
        print(f"# vlint: {len(rep.findings)} findings "
              f"({len(rep.open_findings)} open, "
              f"{sum(1 for f in rep.findings if f.baselined)} "
              f"baselined, {len(rep.stale_baseline)} stale baseline) "
              f"in {rep.elapsed_s:.2f}s")
    return 1 if (rep.open_findings or rep.stale_baseline) else 0


if __name__ == "__main__":
    sys.exit(main())
