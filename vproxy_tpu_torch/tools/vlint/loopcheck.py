"""vlint pass 4 — loop-affinity lint.

A SelectorEventLoop is a single thread: every registered callable —
readiness handlers (`loop.add`), timers (`delay`/`period`),
cross-thread submits (`run_on_loop`/`call_sync`/`next_tick`) — runs
inline on it, and one blocking call stalls every session, timer and
health probe that loop owns: a 65537-slot maglev table build that
landed on a serving loop via a listener callback did exactly that, and
the stall counters (vproxy_loop_callback_us_max) only show the damage
after the fact. This pass flags the known blocking families
*statically*, at registration time:

* time.sleep
* subprocess.* (run/call/check_*/Popen)
* blocking socket module ops (create_connection, getaddrinfo,
  gethostby*) — loop code uses the nonblocking vtl layer
* unbounded queue.get (no timeout, block not False)

Resolution is bounded and honest: the callback expression is resolved
within its module (lambda bodies, nested defs, same-class methods,
module functions, functools.partial), and its callees are followed two
levels inside the same scope. Cross-module calls are not followed —
a deliberate precision/recall trade documented in
docs/static-analysis.md; deliberate exceptions go in baseline.toml.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Tuple

from . import PKG, Finding, py_files, trees, walk

# sink method name -> callback argument index
SINKS = {"delay": 1, "period": 1, "next_tick": 0, "run_on_loop": 0,
         "call_sync": 0, "add": 2}

_SOCKET_BLOCKING = {"create_connection", "getaddrinfo", "gethostbyname",
                    "gethostbyaddr", "getfqdn"}

_MAX_DEPTH = 2


def _unparse(node) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return ""


def _looks_like_loop(recv: ast.AST) -> bool:
    return "loop" in _unparse(recv).lower()


def _walk_own_code(body: List[ast.stmt]):
    """Yield this body's nodes WITHOUT descending into nested
    defs/lambdas — those are separate callables (a sleeping worker-
    thread fn defined inline must not be attributed to the enclosing
    callback; it is followed only if actually called). ast.walk +
    `continue` cannot express this: continue skips the def node itself
    but its subtree is already queued."""
    stack = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue  # children deliberately NOT pushed
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _blocking_calls(fn_body: List[ast.stmt]) -> List[Tuple[int, str]]:
    """(lineno, description) for every blocking call directly in this
    body (nested defs/lambdas excluded — see _walk_own_code)."""
    out: List[Tuple[int, str]] = []
    for node in _walk_own_code(fn_body):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not isinstance(f, ast.Attribute):
            continue
        recv = _unparse(f.value)
        if f.attr == "sleep" and recv == "time":
            out.append((node.lineno, "time.sleep"))
        elif recv in ("subprocess",) and f.attr in (
                "run", "call", "check_call", "check_output",
                "Popen"):
            out.append((node.lineno, f"subprocess.{f.attr}"))
        elif recv in ("socket", "_socket") \
                and f.attr in _SOCKET_BLOCKING:
            out.append((node.lineno, f"socket.{f.attr}"))
        elif f.attr == "get" and ("queue" in recv.lower()
                                  or recv.lower().endswith("_q")):
            if _queue_get_unbounded(node):
                out.append((node.lineno, f"{recv}.get() without "
                            "timeout"))
    return out


def _queue_get_unbounded(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "timeout":
            # timeout=None blocks forever — only a real value bounds it
            return isinstance(kw.value, ast.Constant) \
                and kw.value.value is None
        if kw.arg == "block" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return False
    if call.args:
        a0 = call.args[0]
        if isinstance(a0, ast.Constant) and a0.value is False:
            return False  # q.get(False) is nonblocking
        if len(call.args) >= 2:
            return False  # q.get(block, timeout)
    return True


class _Scope:
    """Resolution environment for one registration site."""

    def __init__(self, module_fns: Dict[str, ast.FunctionDef],
                 class_fns: Dict[str, ast.FunctionDef],
                 local_fns: Dict[str, ast.FunctionDef]):
        self.module_fns = module_fns
        self.class_fns = class_fns
        self.local_fns = local_fns

    def resolve(self, name: str) -> Optional[ast.FunctionDef]:
        return (self.local_fns.get(name) or self.class_fns.get(name)
                or self.module_fns.get(name))


def _callee_names(body: List[ast.stmt]) -> List[str]:
    out = []
    for node in _walk_own_code(body):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                out.append(f.id)
            elif isinstance(f, ast.Attribute) and isinstance(
                    f.value, ast.Name) and f.value.id == "self":
                out.append(f.attr)
    return out


def _scan_callable(body: List[ast.stmt], scope: _Scope, depth: int,
                   seen: set) -> List[Tuple[int, str]]:
    found = _blocking_calls(body)
    if depth >= _MAX_DEPTH:
        return found
    for name in _callee_names(body):
        if name in seen:
            continue
        seen.add(name)
        fn = scope.resolve(name)
        if fn is not None:
            for ln, what in _scan_callable(fn.body, scope, depth + 1,
                                           seen):
                found.append((ln, f"{what} (via {name}())"))
    return found


def _resolve_cb(expr: ast.AST, scope: _Scope):
    """-> (body, label) for the callback expression, or None."""
    if isinstance(expr, ast.Lambda):
        return [ast.Expr(expr.body)], "<lambda>"
    if isinstance(expr, ast.Call):  # functools.partial(fn, ...)
        f = expr.func
        fname = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else "")
        if fname == "partial" and expr.args:
            return _resolve_cb(expr.args[0], scope)
        return None
    name = None
    if isinstance(expr, ast.Name):
        name = expr.id
    elif isinstance(expr, ast.Attribute) and isinstance(
            expr.value, ast.Name) and expr.value.id == "self":
        name = expr.attr
    if name is None:
        return None
    fn = scope.resolve(name)
    if fn is None:
        return None
    return fn.body, name


def check_loops(root: str,
                files: Optional[List[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    run_trees = trees()
    for path in files if files is not None else py_files(
            root, [PKG]):
        try:
            tree = run_trees.parse(path)
        except (OSError, SyntaxError):
            continue
        module_fns = {n.name: n for n in tree.body
                      if isinstance(n, ast.FunctionDef)}
        units: List[Tuple[Dict, ast.FunctionDef]] = []
        for n in tree.body:
            if isinstance(n, ast.FunctionDef):
                units.append(({}, n))
            elif isinstance(n, ast.ClassDef):
                cls_fns = {m.name: m for m in n.body
                           if isinstance(m, ast.FunctionDef)}
                units.extend((cls_fns, m) for m in cls_fns.values())
        rel = os.path.relpath(path, root)
        for cls_fns, fn in units:
            nodes = walk(fn)
            local_fns = {d.name: d for d in nodes
                         if isinstance(d, ast.FunctionDef) and d is not fn}
            scope = _Scope(module_fns, cls_fns, local_fns)
            for node in nodes:
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in SINKS):
                    continue
                idx = SINKS[node.func.attr]
                if len(node.args) <= idx:
                    continue
                if not _looks_like_loop(node.func.value):
                    continue
                resolved = _resolve_cb(node.args[idx], scope)
                if resolved is None:
                    continue
                body, label = resolved
                for ln, what in _scan_callable(body, scope, 0,
                                               {label}):
                    findings.append(Finding(
                        "loop", f"loop:{rel}:{fn.name}:{label}:{what}",
                        path, ln,
                        f"{label} is registered on an event loop at "
                        f"{rel}:{node.lineno} ({node.func.attr}) but "
                        f"contains blocking call {what} — one call "
                        f"stalls every session on that loop"))
    return findings
