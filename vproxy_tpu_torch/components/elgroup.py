"""EventLoopGroup — named set of worker loops with round-robin next().

Analog of component/elgroup/EventLoopGroup.java (round-robin next()
:188-207, attach/detach resource lifecycle, named event-loop add/remove).
Worker topology follows app/Application.java:83-114: one control loop +
N worker loops.

The port's copy of vproxy_tpu/components/elgroup.py, same names and behaviour.
"""
from __future__ import annotations

import itertools
import traceback
from typing import Optional

from ..net.eventloop import SelectorEventLoop


class EventLoopGroup:
    def __init__(self, name: str, n_loops: int = 1):
        self.name = name
        self._loops: dict[str, SelectorEventLoop] = {}
        self._rr = itertools.count()
        self._closed = False
        self._resources: list = []
        for i in range(n_loops):
            self.add_loop(f"{name}-{i}")

    @property
    def loops(self) -> list[SelectorEventLoop]:
        return list(self._loops.values())

    def loop_names(self) -> list[str]:
        return list(self._loops.keys())

    def add_loop(self, name: str) -> SelectorEventLoop:
        if name in self._loops:
            raise ValueError(f"event-loop {name} already exists in {self.name}")
        lp = SelectorEventLoop(name)
        lp.on_death.append(self._loop_died)
        lp.loop_thread()
        self._loops[name] = lp
        return lp

    def _loop_died(self, lp: SelectorEventLoop) -> None:
        """A member loop stopped (crash or close). Unless the whole group
        is shutting down, attached resources re-home their bindings —
        the reference's LBAttach / DNSServer EventLoopAttach semantics
        (TcpLB.java:45-66, DNSServer.java:89-106)."""
        if self._closed:
            return
        for k, v in list(self._loops.items()):
            if v is lp:
                del self._loops[k]
        for r in list(self._resources):
            cb = getattr(r, "on_loop_death", None)
            if cb is None:
                continue
            try:
                cb(self, lp)
            except Exception:
                traceback.print_exc()

    def remove_loop(self, name: str) -> None:
        lp = self._loops.pop(name, None)
        if lp is None:
            raise KeyError(name)
        lp.close()

    def get_loop(self, name: str) -> Optional[SelectorEventLoop]:
        return self._loops.get(name)

    def next(self) -> SelectorEventLoop:
        loops = self.loops
        if not loops:
            raise RuntimeError(f"event loop group {self.name} is empty")
        return loops[next(self._rr) % len(loops)]

    def attach(self, resource) -> None:
        if resource not in self._resources:
            self._resources.append(resource)

    def detach(self, resource) -> None:
        if resource in self._resources:
            self._resources.remove(resource)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for r in list(self._resources):
            closer = getattr(r, "on_group_close", None)
            if closer:
                closer()
        for lp in self.loops:
            lp.close()
        self._loops.clear()
