"""vlint pass 3 — metric-family and failpoint registry audit.

Two registries hold this repo's observability honest, and both drift
silently when unchecked:

* **Metrics** (the silent-drops rule: silent drops counted, families pre-registered
  so a scrape shows the ZERO before the first event). The audit builds
  the eager set — the families a fresh `GlobalInspection.get()`
  registers, probed in a clean subprocess so test-session leftovers
  can't leak in — and flags every family referenced at a call site
  that is NOT eagerly registered: that family is invisible on /metrics
  until its first increment, which is exactly when dashboards alerting
  on "metric missing vs metric zero" stop working. Families whose
  label sets only exist at runtime (per-LB, per-group) are deliberate
  exceptions carried in baseline.toml with the justification inline.
  Docs naming a family that exists nowhere in code are findings too.

* **Failpoints** (utils/failpoint.py SITES is the catalog). A
  `failpoint.hit()` site whose name is not in SITES can never be
  armed; a SITES entry with no hit() site arms successfully and then
  never fires — a chaos run "passes" while injecting nothing. Both
  directions are findings, as are `arm()` calls and doc references to
  nonexistent sites.
"""
from __future__ import annotations

import ast
import fnmatch
import os
import re
import subprocess
import sys
from typing import Dict, List, Optional, Set, Tuple

from . import PKG, Finding, py_files, trees

# dotted doc tokens that look like failpoint sites but are not
FAILPOINT_DOC_ALLOW = {"cluster.vproxy.local"}

# a family name is exactly this (the package name and dotted module
# paths also start with "vproxy_" — they are not metric families)
_FAMILY = re.compile(r"^vproxy_[a-z0-9_]+$")

# modules whose import-time registrations define the eager set: the
# core registry plus every subsystem that pre-registers its closed
# label vocabularies at import (a process that never imports a
# subsystem correctly never scrapes its families either)
REGISTRY_MODULES = ("vproxy_tpu_torch.utils.metrics",
                    "vproxy_tpu_torch.vswitch.swmetrics")

_EAGER_PROBE = r"""
import importlib
import sys
mods = [importlib.import_module(m) for m in %r]
gi = mods[0].GlobalInspection.get()
names = set()
with gi.registry._lock:
    for m in gi.registry._metrics:
        names.add(m.name)
for (name, _labels) in gi._named:
    names.add(name)
sys.stdout.write("\n".join(sorted(names)))
"""

_eager_cache: Dict[str, Optional[Set[str]]] = {}


def eager_metric_families(root: str) -> Optional[Set[str]]:
    """The families a fresh process registers before any traffic —
    probed in a subprocess (a test session's lazily-created families
    must not leak into the registered set and mask findings). None
    when the probe itself fails (reported as a finding, not a crash)."""
    if root in _eager_cache:
        return _eager_cache[root]
    try:
        r = subprocess.run(
            [sys.executable, "-c", _EAGER_PROBE % (REGISTRY_MODULES,)],
            cwd=root,
            capture_output=True, text=True, timeout=60,
            env={**os.environ, "VPROXY_TPU_FD_PROVIDER": "py"})
        out = set(r.stdout.split()) if r.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired):
        out = None
    _eager_cache[root] = out
    return out


def _package_name(tok: str) -> bool:
    """The port's package name, or the reference's (PKG without its
    "_torch"): a "vproxy_*" token, but no metric family."""
    return tok in (PKG, PKG.rsplit("_", 1)[0])


def _parse(path: str):
    try:
        return trees().parse(path)
    except (OSError, SyntaxError):
        return None


def metric_references(root: str,
                      files: Optional[List[str]] = None
                      ) -> Dict[str, List[Tuple[str, int]]]:
    """Every call whose first positional argument is a "vproxy_*"
    string literal is a family reference — this catches the registry
    methods, the raw Metric constructors AND module-local memo wrappers
    (swmetrics._ctr) without a brittle method-name list."""
    refs: Dict[str, List[Tuple[str, int]]] = {}
    run_trees = trees()
    for path in files if files is not None else py_files(
            root, [PKG]):
        for node in run_trees.calls(path):
            if (node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and _FAMILY.match(node.args[0].value)
                    and not _package_name(node.args[0].value)):
                refs.setdefault(node.args[0].value, []).append(
                    (path, node.lineno))
    return refs


_DOC_METRIC = re.compile(r"\bvproxy_[a-z0-9_]+\b")
_EXPO_SUFFIXES = ("_bucket", "_sum", "_count")


def _doc_files(root: str) -> List[str]:
    docs = os.path.join(root, "docs")
    if not os.path.isdir(docs):
        return []
    return sorted(os.path.join(docs, f) for f in os.listdir(docs)
                  if f.endswith(".md"))


def check_metrics(root: str,
                  files: Optional[List[str]] = None,
                  eager_override: Optional[Set[str]] = None
                  ) -> List[Finding]:
    findings: List[Finding] = []
    eager = eager_override if eager_override is not None \
        else eager_metric_families(root)
    refs = metric_references(root, files=files)
    if eager is None:
        findings.append(Finding(
            "registry", "metric-probe", root, 0,
            "could not probe the eager metric registry (fresh "
            "GlobalInspection subprocess failed)"))
        eager = set()
    else:
        for name, sites in sorted(refs.items()):
            if name in eager:
                continue
            path, line = sites[0]
            findings.append(Finding(
                "registry", f"metric-unregistered:{name}", path, line,
                f"metric family {name!r} is created at its increment "
                f"site only — never eagerly registered, so /metrics "
                f"cannot show the zero before the first event "
                f"(the silent-drops rule)"))
    if files is not None:
        return findings  # fixture run: no doc cross-check
    known = eager | set(refs)
    for path in _doc_files(root):
        with open(path) as f:
            text = f.read()
        for ln, line in enumerate(text.splitlines(), 1):
            for tok in _DOC_METRIC.findall(line):
                name = tok
                # the package name, and prose family-prefix references
                # like "vproxy_cluster_{peers_up,...}" (token ends at
                # the brace, leaving a trailing underscore)
                if _package_name(name) or name.endswith("_"):
                    continue
                if name not in known:
                    for suf in _EXPO_SUFFIXES:
                        if name.endswith(suf) and name[:-len(suf)] in known:
                            name = name[:-len(suf)]
                            break
                if name not in known:
                    findings.append(Finding(
                        "registry", f"metric-doc:{tok}", path, ln,
                        f"docs reference metric family {tok!r} which "
                        f"exists nowhere in the tree"))
    return findings


# ------------------------------------------------------------ failpoints

def failpoint_sites(root: str) -> Set[str]:
    """The SITES catalog, from utils/failpoint.py's AST."""
    path = os.path.join(root, PKG, "utils", "failpoint.py")
    tree = _parse(path)
    if tree is None:
        return set()
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "SITES"
                and isinstance(node.value, (ast.Tuple, ast.List))):
            return {e.value for e in node.value.elts
                    if isinstance(e, ast.Constant)}
    return set()


def _call_name_refs(files: List[str], methods
                    ) -> Dict[str, Dict[str, List[Tuple[str, int]]]]:
    """{method: {name: sites}}: the first-arg string literals of every
    `<x>.method("...")` / `method("...")` call in files, for each of
    methods, in one walk of each file."""
    refs: Dict[str, Dict[str, List[Tuple[str, int]]]] = {
        m: {} for m in methods}
    run_trees = trees()
    for path in files:
        for node in run_trees.calls(path):
            if not (node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if name in refs:
                refs[name].setdefault(node.args[0].value, []).append(
                    (path, node.lineno))
    return refs


# a file outside the package is read for arm() calls only, and one
# whose text never holds the word "arm" has none: it is not parsed
_ARM_WORD = re.compile(r"\barm\b")


def _mentions_arm(path: str) -> bool:
    try:
        with open(path) as f:
            return _ARM_WORD.search(f.read()) is not None
    except OSError:
        return False


def _site_token_re(sites: Set[str]) -> re.Pattern:
    prefixes = sorted({s.split(".")[0] for s in sites})
    return re.compile(r"\b(?:" + "|".join(prefixes)
                      + r")(?:\.[a-z_*]+)+\b")


def _two_seg(tok: str) -> str:
    return ".".join(tok.split(".")[:2])


def check_failpoints(root: str) -> List[Finding]:
    findings: List[Finding] = []
    sites = failpoint_sites(root)
    fp_py = os.path.join(root, PKG, "utils", "failpoint.py")
    if not sites:
        return [Finding("registry", "failpoint-catalog", fp_py, 0,
                        "could not extract the SITES catalog")]
    # hit() sites in the package and arm() references in the package,
    # the port's tests and its chip drive, gathered in one walk
    arm_only = ["chip_smoke.py"]
    tests = os.path.join(root, "tests")
    if os.path.isdir(tests):
        arm_only += [os.path.join("tests", f) for f in os.listdir(tests)
                     if f.startswith("test_torch_") and f.endswith(".py")]
    refs = _call_name_refs(sorted(
        py_files(root, [PKG]) + [p for p in py_files(root, arm_only)
                                 if _mentions_arm(p)]), ("hit", "arm"))
    pkg = os.path.join(root, PKG) + os.sep
    hits: Dict[str, List[Tuple[str, int]]] = {}
    for name, where in refs["hit"].items():
        where = [w for w in where if w[0].startswith(pkg)]
        if where:
            hits[name] = where
    # hit() names that aren't sites never fire (hit() returns False
    # silently for unknown names — the injection is dead code)
    for name, where in sorted(hits.items()):
        if name not in sites:
            path, line = where[0]
            findings.append(Finding(
                "registry", f"failpoint-unknown-hit:{name}", path, line,
                f"failpoint.hit({name!r}) names a site missing from "
                f"SITES — it can never be armed and never fires"))
    # sites with no hit() anywhere arm successfully and inject nothing
    for name in sorted(sites):
        if name not in hits:
            findings.append(Finding(
                "registry", f"failpoint-orphan:{name}", fp_py, 0,
                f"failpoint site {name!r} is in SITES but has no "
                f"failpoint.hit() site — arming it injects nothing "
                f"and every chaos run 'passes'"))
    # arm() references must resolve
    for name, where in sorted(refs["arm"].items()):
        if name not in sites:
            path, line = where[0]
            findings.append(Finding(
                "registry", f"failpoint-unknown-arm:{name}", path, line,
                f"arm({name!r}) names a site missing from SITES"))
    # docs: dotted tokens in site namespaces must be sites (or site
    # prefixes / globs — "backend.connect.*" is a family reference).
    # Docs also mention python attributes ("engine.flush_installs") in
    # the same first-segment namespaces, so a token is only suspicious
    # when its two-segment prefix matches a real site family — the
    # precision/recall trade documented in docs/static-analysis.md.
    tok_re = _site_token_re(sites)
    two_segs = {_two_seg(s) for s in sites}
    for path in _doc_files(root):
        with open(path) as f:
            text = f.read()
        for ln, line in enumerate(text.splitlines(), 1):
            for tok in tok_re.findall(line):
                if tok in sites or tok in FAILPOINT_DOC_ALLOW:
                    continue
                if _two_seg(tok) not in two_segs:
                    continue
                if "*" in tok and any(fnmatch.fnmatch(s, tok)
                                      for s in sites):
                    continue
                if any(s.startswith(tok + ".") for s in sites):
                    continue
                findings.append(Finding(
                    "registry", f"failpoint-doc:{tok}", path, ln,
                    f"docs reference failpoint {tok!r} which is not "
                    f"in SITES"))
    return findings


def check_registry(root: str) -> List[Finding]:
    return check_metrics(root) + check_failpoints(root)
