"""vlint — the invariant-checking static analyzer, over the port.

The port's copy of tools/vlint: the same four passes, finding keys and
baseline format, pointed at vproxy_tpu_torch/. The system's
correctness rests on conventions no compiler checks: C structs
mirrored byte-for-byte in net/vtl.py, every mutation of replicated
state bumping a generation atomic, every metric family pre-registered
so scrapes show the zero, and event-loop callbacks that must never
block. They are machine-enforced here, as a tier-1 test
(tests/test_torch_vlint.py) and as `python -m vproxy_tpu_torch.tools.
vlint` from the repo root.

Four passes (docs/static-analysis.md is the operator reference):

* abi      — field-by-field C/python struct parity (structs.py):
             the port's native/vtl.cpp against its net/vtl.py
* gengate  — generation-gate audit over guarded stores (gengate.py)
* registry — metric + failpoint registry audit (registry.py)
* loop     — loop-affinity lint: no blocking calls in callables
             registered on a SelectorEventLoop (loopcheck.py)

Findings carry a stable `key`; deliberate exceptions live in
baseline.toml next to this file with one-line justifications, so the
tier-1 gate is delta-based: new findings fail, baselined ones don't,
and a baseline entry whose finding disappeared is reported stale. The
tree scans skip FIXTURES, the analyzer's own seeded violations.
"""
from __future__ import annotations

import ast
import gc
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union


@dataclass
class Finding:
    pass_name: str   # abi | gengate | registry | loop
    key: str         # stable identity for baseline matching
    path: str
    line: int
    message: str
    baselined: bool = False
    baseline_reason: str = ""

    def format(self) -> str:
        loc = f"{os.path.relpath(self.path)}:{self.line}" if self.line \
            else os.path.relpath(self.path)
        tag = " [baselined]" if self.baselined else ""
        return f"[{self.pass_name}] {loc}: {self.message} " \
               f"(key={self.key}){tag}"


# ------------------------------------------------------------- baseline
#
# baseline.toml is a flat [[finding]] list:
#
#   [[finding]]
#   pass = "registry"
#   key = "metric-unregistered:vproxy_lb_retries_total"
#   reason = "per-LB label set exists only after an LB is configured"
#
# Python 3.10 has no tomllib and the container must not grow deps, so
# this is a parser for exactly that subset: [[finding]] table headers
# and `key = "string"` pairs. Anything fancier is a config error.

PKG = "vproxy_tpu_torch"  # the analyzed package, root-relative
# the analyzer's fixtures (each pass's seeded violations), root-relative
FIXTURES = os.path.join(PKG, "tools", "vlint", "fixtures")


def py_files(root: str, rel_dirs) -> List[str]:
    """Sorted .py paths under root-relative dirs/files, skipping
    __pycache__, dot-dirs and FIXTURES (shared by the registry and loop
    passes)."""
    out: List[str] = []
    skip = os.path.join(root, FIXTURES)
    for rel in rel_dirs:
        base = os.path.join(root, rel)
        if os.path.isfile(base):
            out.append(base)
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames
                           if d != "__pycache__" and not d.startswith(".")
                           and os.path.join(dirpath, d) != skip]
            out.extend(os.path.join(dirpath, f) for f in filenames
                       if f.endswith(".py"))
    return sorted(out)


# -------------------------------------------------------------- parsing
#
# The registry, loop and gengate passes read the same files, and the
# registry pass reads them twice. Inside run_all one per-run cache
# holds each file's tree (or the error parsing it raised) and its calls
# in ast.walk order, keyed by path, so a run parses and walks each file
# once; a pass called on its own parses afresh.

def walk(node: ast.AST) -> List[ast.AST]:
    """node and every node below it, in ast.walk's breadth-first order
    (a list built without ast.walk's generators: ~2.5x faster)."""
    todo = [node]
    i = 0
    while i < len(todo):
        n = todo[i]
        i += 1
        for name in n._fields:
            v = getattr(n, name, None)
            if isinstance(v, ast.AST):
                todo.append(v)
            elif isinstance(v, list):
                todo.extend(x for x in v if isinstance(x, ast.AST))
    return todo


class Trees:
    """Parsed files keyed by path: each one's tree, or the error that
    parsing it raised, and its calls."""

    def __init__(self):
        self._trees: Dict[str, Union[ast.Module, Exception]] = {}
        self._calls: Dict[str, List[ast.Call]] = {}

    def parse(self, path: str) -> ast.Module:
        got = self._trees.get(path)
        if got is None:
            try:
                with open(path) as f:
                    got = ast.parse(f.read(), path)
            except (OSError, SyntaxError) as e:
                got = e
            self._trees[path] = got
        if isinstance(got, Exception):
            raise got
        return got

    def calls(self, path: str) -> List[ast.Call]:
        """Every Call node of path's tree, in ast.walk order ([] when it
        does not parse)."""
        got = self._calls.get(path)
        if got is None:
            try:
                tree = self.parse(path)
            except (OSError, SyntaxError):
                return []
            got = self._calls[path] = [n for n in walk(tree)
                                       if isinstance(n, ast.Call)]
        return got


_run_trees: Optional[Trees] = None  # set by run_all for its passes


def trees() -> Trees:
    """The running run_all's cache, or a fresh one for a pass called on
    its own."""
    return _run_trees if _run_trees is not None else Trees()


def parse_baseline(path: str) -> List[Dict[str, str]]:
    if not os.path.exists(path):
        return []
    out: List[Dict[str, str]] = []
    cur: Optional[Dict[str, str]] = None
    with open(path) as f:
        for ln, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line == "[[finding]]":
                cur = {}
                out.append(cur)
                continue
            if "=" in line and cur is not None:
                k, _, v = line.partition("=")
                k, v = k.strip(), v.strip()
                if not (len(v) >= 2 and v[0] == '"' and v[-1] == '"'):
                    raise ValueError(
                        f"{path}:{ln}: expected key = \"string\"")
                cur[k] = v[1:-1]
                continue
            raise ValueError(f"{path}:{ln}: unparseable line {line!r}")
    for i, ent in enumerate(out):
        if "key" not in ent or "reason" not in ent:
            raise ValueError(
                f"{path}: finding #{i + 1} needs both key and reason")
    return out


def apply_baseline(findings: List[Finding],
                   baseline: List[Dict[str, str]]) -> List[str]:
    """Mark baselined findings in place; -> stale baseline keys (entries
    whose finding no longer occurs — prune them, they hide nothing)."""
    by_key = {e["key"]: e for e in baseline}
    seen = set()
    for f in findings:
        ent = by_key.get(f.key)
        if ent is not None and ent.get("pass", f.pass_name) == f.pass_name:
            f.baselined = True
            f.baseline_reason = ent["reason"]
            seen.add(f.key)
    return [k for k in by_key if k not in seen]


# -------------------------------------------------------------- run_all

@dataclass
class Report:
    findings: List[Finding]
    stale_baseline: List[str]
    elapsed_s: float
    counts: Dict[str, int] = field(default_factory=dict)

    @property
    def open_findings(self) -> List[Finding]:
        return [f for f in self.findings if not f.baselined]


def run_all(root: Optional[str] = None,
            baseline_path: Optional[str] = None) -> Report:
    """Run all four passes over the tree; apply the committed baseline
    (pass baseline_path="" to skip). The whole run must stay inside the
    tier-1 10s budget — every pass is parse-only plus one in-process
    metrics-registry instantiation — so the passes share one Trees."""
    global _run_trees
    from . import gengate, loopcheck, registry, structs
    t0 = time.monotonic()
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
    _run_trees = Trees()
    # the trees hold no cycles; the cyclic collector would only rescan
    # their ~500k nodes at each threshold while they are built (~25%)
    gc_was_on = gc.isenabled()
    gc.disable()
    findings: List[Finding] = []
    try:
        findings += structs.check_abi(root)
        findings += gengate.check_gengate(root)
        findings += registry.check_registry(root)
        findings += loopcheck.check_loops(root)
    finally:
        _run_trees = None
        if gc_was_on:
            gc.enable()
    # the baseline belongs to the ANALYZED tree (a --root run over a
    # checkout must honor that checkout's exceptions, not the ones
    # committed next to whichever copy of the analyzer is imported)
    bp = os.path.join(root, PKG, "tools", "vlint", "baseline.toml") \
        if baseline_path is None else baseline_path
    stale = apply_baseline(findings, parse_baseline(bp)) if bp else []
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.pass_name] = counts.get(f.pass_name, 0) + 1
    return Report(findings, stale, time.monotonic() - t0, counts)


def snapshot(report: Report) -> dict:
    """The `static_analysis` row: finding counts by pass + baseline
    totals, so a report over time shows drift."""
    return {
        "findings_by_pass": dict(sorted(report.counts.items())),
        "findings_total": len(report.findings),
        "baselined": sum(1 for f in report.findings if f.baselined),
        "open": len(report.open_findings),
        "stale_baseline": len(report.stale_baseline),
        "elapsed_s": round(report.elapsed_s, 3),
    }
