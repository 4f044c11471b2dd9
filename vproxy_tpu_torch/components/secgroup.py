"""SecurityGroup — L4 ACL on the classify engine.

The port of `vproxy_tpu/components/secgroup.py`. Reference:
component/secure/SecurityGroup.java (per-protocol ordered first-match
lists, default allow/deny) and SecurityGroupRule.java. The per-rule
linear scan becomes a CidrMatcher table query: on the card, batches of
allow_async lookups ride ClassifyService's `cidr` kind into the CIDR
kernel (ops/cidr_cuda.py).
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

from ..rules.engine import CidrMatcher
from ..rules.ir import AclRule, Proto
from ..utils.ip import Network


class SecurityGroup:
    DEFAULT_NAME = "(allow-all)"

    def __init__(self, alias: str, default_allow: bool = True,
                 backend: Optional[str] = None):
        self.alias = alias
        self.default_allow = default_allow
        self._rules: list[AclRule] = []
        self._backend = backend
        # proto -> (matcher, rules) published atomically; matchers are
        # immutable once published (a recalc builds a NEW one) so a data-
        # plane allow() never sees a half-updated table/rule-list pair
        self._tables: dict[Proto, tuple[CidrMatcher, list[AclRule]]] = {}
        self._lock = threading.Lock()
        # mutation listeners (fired AFTER the new table publishes, lock
        # released): the switch flow cache registers its generation bump
        # here so an ACL edit invalidates native entries immediately
        self._listeners: list = []

    def add_listener(self, cb) -> None:
        self._listeners.append(cb)

    def remove_listener(self, cb) -> None:
        try:
            self._listeners.remove(cb)
        except ValueError:
            pass

    def _fire(self) -> None:
        for cb in list(self._listeners):
            cb()

    @classmethod
    def allow_all(cls) -> "SecurityGroup":
        return cls(cls.DEFAULT_NAME, True)

    @property
    def rules(self) -> list[AclRule]:
        return list(self._rules)

    def add_rule(self, rule: AclRule) -> None:
        with self._lock:
            if any(r.alias == rule.alias for r in self._rules):
                raise ValueError(f"rule {rule.alias} already exists in {self.alias}")
            for r in self._rules:
                if (r.network == rule.network and r.protocol == rule.protocol
                        and r.min_port == rule.min_port and r.max_port == rule.max_port):
                    raise ValueError(f"equivalent rule {r.alias} already exists")
            self._rules.append(rule)
            self._recalc(rule.protocol)
        self._fire()

    def extend_rules(self, rules: Sequence[AclRule]) -> None:
        """Bulk add: one table recompile per touched protocol instead of
        per rule (a 5k-rule group would otherwise pay 5k recompiles)."""
        with self._lock:
            seen = {r.alias for r in self._rules}
            eq = {(r.network, r.protocol, r.min_port, r.max_port)
                  for r in self._rules}
            for r in rules:
                if r.alias in seen:
                    raise ValueError(f"rule {r.alias} already exists in {self.alias}")
                k = (r.network, r.protocol, r.min_port, r.max_port)
                if k in eq:
                    raise ValueError(f"equivalent rule for {r.alias} already exists")
                seen.add(r.alias)
                eq.add(k)
            self._rules.extend(rules)
            for proto in {r.protocol for r in rules}:
                self._recalc(proto)
        self._fire()

    def remove_rule(self, alias: str) -> None:
        with self._lock:
            for i, r in enumerate(self._rules):
                if r.alias == alias:
                    del self._rules[i]
                    self._recalc(r.protocol)
                    break
            else:
                raise KeyError(alias)
        self._fire()

    def _recalc(self, proto: Proto) -> None:
        sub = [r for r in self._rules if r.protocol == proto]
        if not sub:
            self._tables.pop(proto, None)
            return
        m = CidrMatcher([r.network for r in sub], backend=self._backend,
                        acl=sub, payload=sub)
        self._tables[proto] = (m, sub)  # atomic publish

    def trivial_allow(self, proto: Proto) -> bool:
        """True when allow() can only ever answer True for `proto` (no
        rules for it + default allow) — the accept lanes serve in C only
        under a trivially-allowing group; anything else punts every
        connection to the python ACL path."""
        return self.default_allow and self._tables.get(proto) is None

    def allow(self, proto: Proto, addr: bytes, port: int) -> bool:
        ent = self._tables.get(proto)
        if ent is None:
            return self.default_allow
        m, sub = ent
        idx = m.match_one(addr, port)
        return sub[idx].allow if idx >= 0 else self.default_allow

    def allow_async(self, proto: Proto, addr: bytes, port: int, cb,
                    loop=None) -> None:
        """Async allow(): the CIDR+port lookup rides the ClassifyService
        micro-batch queue; cb(bool) fires on *loop*. Empty rule sets
        short-circuit synchronously (the common allow-all group costs
        nothing)."""
        ent = self._tables.get(proto)
        if ent is None:
            cb(self.default_allow)
            return
        from ..rules.service import ClassifyService
        m, _ = ent

        def on_idx(idx: int, sub) -> None:
            cb(sub[idx].allow if sub and idx >= 0 else self.default_allow)

        ClassifyService.get().submit_cidr(m, addr, port, on_idx, loop)

    def allow_batch(self, proto: Proto, addrs: Sequence[bytes],
                    ports: Sequence[int]) -> list[bool]:
        ent = self._tables.get(proto)
        if ent is None:
            return [self.default_allow] * len(addrs)
        m, sub = ent
        return [sub[i].allow if i >= 0 else self.default_allow
                for i in m.match(addrs, ports)]
