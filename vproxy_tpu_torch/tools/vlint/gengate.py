"""vlint pass 2 — the generation-gate audit.

The native planes (flow cache, accept lanes) and the engine serve from
compiled state that is only correct while a generation atomic / atomic
pub-tuple says so: every mutation of the source-of-truth stores MUST
bump the gate on the same path, or a stale compiled entry keeps
serving traffic the mutation just outlawed (the exact failure the
`switch.flowcache.stale` / `lane.entry.stale` failpoints exist to
prove). The convention is enforced here as config: GUARDS names every
guarded store and the gate calls that protect it, and the pass flags
any function that mutates a guarded store with no gate reachable on
the path — in its own body, in a callee (the gate may be downstream:
add_route -> _sync_routes), or in every one of its callers (helpers
like SyntheticIpHolder._unindex_mac are gated by construction when all
call sites gate).

Publish-tuple stores (`_pub` on the matchers, the membership steering
tuple) use the stricter `only_in` form: assignment anywhere outside
the designated installer methods is a finding regardless of gating —
the TableInstaller swap IS the gate.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from . import Finding, trees

MUT_METHODS = {"append", "add", "remove", "pop", "popitem", "clear",
               "update", "insert", "extend", "setdefault", "discard",
               "sort"}

_MAX_DEPTH = 4  # bounded closure over the intra-module call graph


@dataclass
class Guard:
    module: str                      # repo-relative source path
    cls: Optional[str]               # class scope; None = whole module
    attrs: frozenset = frozenset()   # guarded self.<attr> stores
    gates: frozenset = frozenset()   # gate call names
    elem_attrs: frozenset = frozenset()  # guarded <obj>.<attr> writes
    only_in: Optional[frozenset] = None  # publish-only methods
    exempt: frozenset = frozenset()  # deliberate exceptions (baselined
                                     # instead where possible)


# The guarded-store catalog. Growing a new generation-gated store
# (conntrack entries, O(delta) installs — the roadmap items this pass
# exists for) means adding its Guard here; tests/test_torch_vlint.py's
# fixtures prove each rule form fires.
GUARDS: List[Guard] = [
    # switch flow cache: MAC/ARP/synthetic-ip/route/iface
    # mutations must reach Switch._gen_bump (one C atomic)
    Guard("vproxy_tpu_torch/vswitch/network.py", "MacTable",
          attrs=frozenset({"_e"}), gates=frozenset({"_bump"})),
    Guard("vproxy_tpu_torch/vswitch/network.py", "ArpTable",
          attrs=frozenset({"_e"}), gates=frozenset({"_bump"})),
    Guard("vproxy_tpu_torch/vswitch/network.py", "SyntheticIpHolder",
          attrs=frozenset({"_ips", "_by_mac"}),
          gates=frozenset({"on_change"})),
    Guard("vproxy_tpu_torch/vswitch/network.py", "VpcNetwork",
          attrs=frozenset({"routes"}),
          gates=frozenset({"_sync_routes", "on_route_change"})),
    Guard("vproxy_tpu_torch/vswitch/switch.py", "Switch",
          attrs=frozenset({"ifaces", "networks"}),
          gates=frozenset({"_bump_registry", "_gen_bump"})),
    # accept lanes: backend membership / weight / health edges
    # and upstream/ACL mutations must fire the change listeners the
    # lane compiler subscribes to (lane_gen_bump rides them)
    Guard("vproxy_tpu_torch/components/servergroup.py", "ServerGroup",
          attrs=frozenset({"servers"}),
          elem_attrs=frozenset({"weight", "healthy", "ejected"}),
          gates=frozenset({"_recalc", "_notify"})),
    Guard("vproxy_tpu_torch/components/upstream.py", "Upstream",
          attrs=frozenset({"handles"}),
          gates=frozenset({"_fire"})),
    Guard("vproxy_tpu_torch/components/secgroup.py", "SecurityGroup",
          attrs=frozenset({"_rules"}),
          gates=frozenset({"_fire"})),
    # matcher pub-tuples: ONLY the installer swaps them
    Guard("vproxy_tpu_torch/rules/engine.py", "HintMatcher",
          attrs=frozenset({"_pub"}),
          only_in=frozenset({"__init__", "_recompile"})),
    Guard("vproxy_tpu_torch/rules/engine.py", "CidrMatcher",
          attrs=frozenset({"_pub"}),
          only_in=frozenset({"__init__", "_recompile"})),
    Guard("vproxy_tpu_torch/rules/maglev.py", "MaglevMatcher",
          attrs=frozenset({"_pub"}),
          only_in=frozenset({"__init__", "_recompile"})),
    # cluster steering table: atomic tuple publish, one builder
    Guard("vproxy_tpu_torch/cluster/membership.py", "Membership",
          attrs=frozenset({"_maglev"}),
          only_in=frozenset({"__init__", "_maglev_build"})),
]


@dataclass
class _FnInfo:
    name: str
    node: ast.FunctionDef
    mutated: List = field(default_factory=list)  # (attr, lineno)
    gates: bool = False
    calls: Set[str] = field(default_factory=set)


def _self_attr(node, attrs: frozenset) -> Optional[str]:
    """node is `self.<a>` or `self.<a>[...]` for a guarded a -> a."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if (isinstance(node, ast.Attribute) and node.attr in attrs
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _scan_fn(fn: ast.FunctionDef, g: Guard) -> _FnInfo:
    info = _FnInfo(fn.name, fn)
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                for e in elts:
                    a = _self_attr(e, g.attrs)
                    if a is not None:
                        info.mutated.append((a, node.lineno))
                    elif (g.elem_attrs and isinstance(e, ast.Attribute)
                          and e.attr in g.elem_attrs
                          and not (isinstance(e.value, ast.Name)
                                   and e.value.id == "self")):
                        info.mutated.append((e.attr, node.lineno))
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                a = _self_attr(t, g.attrs)
                if a is not None:
                    info.mutated.append((a, node.lineno))
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute):
                if f.attr in g.gates:
                    info.gates = True
                if (f.attr in MUT_METHODS
                        and _self_attr(f.value, g.attrs) is not None):
                    info.mutated.append(
                        (_self_attr(f.value, g.attrs), node.lineno))
                if (isinstance(f.value, ast.Name)
                        and f.value.id == "self"):
                    info.calls.add(f.attr)
            elif isinstance(f, ast.Name):
                if f.id in g.gates:
                    info.gates = True
                info.calls.add(f.id)
    return info


def _functions(tree: ast.Module, cls: Optional[str]) -> List[ast.FunctionDef]:
    """Methods of `cls`, or every function/method in the module."""
    out: List[ast.FunctionDef] = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and (cls is None
                                               or node.name == cls):
            out.extend(n for n in node.body
                       if isinstance(n, ast.FunctionDef))
        elif cls is None and isinstance(node, ast.FunctionDef):
            out.append(node)
    return out


def _downstream_gated(name: str, infos: Dict[str, _FnInfo],
                      seen: Set[str], depth: int = 0) -> bool:
    if name in seen or depth > _MAX_DEPTH:
        return False
    info = infos.get(name)
    if info is None:
        return False
    if info.gates:
        return True
    seen.add(name)
    return any(_downstream_gated(c, infos, seen, depth + 1)
               for c in info.calls if c in infos)


def _caller_gated(name: str, infos: Dict[str, _FnInfo],
                  callers: Dict[str, Set[str]], seen: Set[str],
                  depth: int = 0) -> bool:
    """Every caller reaches a gate (in its own downstream closure) or
    is itself fully caller-gated. Zero callers = not gated (dead or
    externally-called helper: the mutation escapes unguarded)."""
    if name in seen or depth > _MAX_DEPTH:
        return False
    seen.add(name)
    cs = callers.get(name, set())
    if not cs:
        return False
    for c in cs:
        if _downstream_gated(c, infos, set()):
            continue
        if not _caller_gated(c, infos, callers, seen, depth + 1):
            return False
    return True


def check_gengate(root: str,
                  guards: Optional[List[Guard]] = None) -> List[Finding]:
    findings: List[Finding] = []
    run_trees = trees()
    for g in (guards if guards is not None else GUARDS):
        path = os.path.join(root, g.module)
        try:
            tree = run_trees.parse(path)
        except (OSError, SyntaxError) as e:
            findings.append(Finding("gengate", f"gengate:{g.module}:parse",
                                    path, 0, f"cannot parse: {e}"))
            continue
        fns = _functions(tree, g.cls)
        if g.cls is not None and not fns:
            findings.append(Finding(
                "gengate", f"gengate:{g.module}:{g.cls}:missing", path, 0,
                f"guarded class {g.cls} not found (stale GUARDS entry?)"))
            continue
        infos = {fn.name: _scan_fn(fn, g) for fn in fns}
        callers: Dict[str, Set[str]] = {}
        for name, info in infos.items():
            for c in info.calls:
                callers.setdefault(c, set()).add(name)
        scope = g.cls or os.path.basename(g.module)
        for name, info in infos.items():
            if not info.mutated or name in g.exempt:
                continue
            if g.only_in is not None:
                if name not in g.only_in:
                    for attr, ln in info.mutated:
                        findings.append(Finding(
                            "gengate",
                            f"gengate:{scope}.{name}:{attr}", path, ln,
                            f"{scope}.{name} assigns {attr!r} outside "
                            f"the designated publish methods "
                            f"({', '.join(sorted(g.only_in))}) — "
                            f"published state must swap atomically "
                            f"through the installer"))
                continue
            if name == "__init__":
                continue  # construction precedes any compiled consumer
            if _downstream_gated(name, infos, set()):
                continue
            if _caller_gated(name, infos, callers, set()):
                continue
            for attr, ln in info.mutated:
                findings.append(Finding(
                    "gengate", f"gengate:{scope}.{name}:{attr}", path,
                    ln,
                    f"{scope}.{name} mutates guarded store {attr!r} "
                    f"with no {'/'.join(sorted(g.gates))} call "
                    f"reachable on the path — a compiled native/"
                    f"device entry can serve stale state"))
    return findings
