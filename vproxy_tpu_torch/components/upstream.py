"""Upstream — groups-of-groups with hint-based selection on the classify
engine.

Reference: component/svrgroup/Upstream.java — weighted-RR across
ServerGroups (seq :68-116), hint selection via searchForGroup (:187-198).
THE difference: the linear annotation scan is replaced by the device
HintMatcher (vproxy_tpu/rules/engine.py) — the rule table lives in HBM
and single queries or micro-batches go through the same compiled kernel.

The port's copy of vproxy_tpu/components/upstream.py, same names and behaviour.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

from ..rules.engine import HintMatcher
from ..rules.ir import Hint, HintRule
from ..utils.metrics import accept_stage_observe
from .servergroup import Connector, ServerGroup


class GroupHandle:
    def __init__(self, group: ServerGroup, weight: int,
                 annotations: Optional[HintRule] = None):
        self.alias = group.alias
        self.group = group
        self.weight = weight
        self.annotations = annotations or HintRule()

    def merged_rule(self) -> HintRule:
        """Handle annotations take precedence over the group's own
        (Hint.matchLevel merges in that order, Hint.java:104-117)."""
        g = self.group.annotations
        return HintRule(
            host=self.annotations.host if self.annotations.host is not None else g.host,
            port=self.annotations.port if self.annotations.port != 0 else g.port,
            uri=self.annotations.uri if self.annotations.uri is not None else g.uri,
        )


class Upstream:
    def __init__(self, alias: str, backend: Optional[str] = None):
        self.alias = alias
        self.handles: list[GroupHandle] = []
        self._matcher = HintMatcher([], backend=backend)
        # analytics attribution: the ClassifyService credits device
        # launches/batch occupancy to this upstream by this name
        self._matcher.owner_alias = alias
        self._wrr_seq: list[int] = []
        self._wrr_groups: list[GroupHandle] = []
        self._wrr_cursor = 0
        self._lock = threading.Lock()
        # mutation listeners, fired AFTER a recalc publishes (lock
        # released): the accept lanes register their generation bump +
        # lane-entry recompile here so add/remove/annotation edits
        # invalidate the C-resident route table immediately
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
            try:
                cb()
            except Exception:
                pass

    # ------------------------------------------------------------- admin

    def add(self, group: ServerGroup, weight: int = 10,
            annotations: Optional[HintRule] = None) -> GroupHandle:
        with self._lock:
            if any(h.group is group for h in self.handles):
                raise ValueError(f"group {group.alias} already in upstream {self.alias}")
            h = GroupHandle(group, weight, annotations)
            self.handles.append(h)
            self._recalc()
        self._fire()
        return h

    def remove(self, group: ServerGroup) -> None:
        with self._lock:
            for i, h in enumerate(self.handles):
                if h.group is group:
                    del self.handles[i]
                    self._recalc()
                    break
            else:
                raise KeyError(group.alias)
        self._fire()

    def set_annotations(self, group: ServerGroup, annotations: HintRule) -> None:
        with self._lock:
            for h in self.handles:
                if h.group is group:
                    h.annotations = annotations
                    self._recalc()
                    break
            else:
                raise KeyError(group.alias)
        self._fire()

    def _recalc(self) -> None:
        # the handle list is the rules' payload: published atomically
        # with the compiled table so async classify results map their
        # index through the SAME generation (see HintMatcher._pub)
        self._matcher.set_rules([h.merged_rule() for h in self.handles],
                                payload=list(self.handles))
        groups = [h for h in self.handles if h.weight > 0]
        self._wrr_groups = groups
        self._wrr_seq = ServerGroup._wrr_compute(groups) if groups else []
        self._wrr_cursor = 0

    # ------------------------------------------------------------- data

    def search_for_group(self, hint: Hint) -> Optional[GroupHandle]:
        """Sync hint search against ONE matcher generation: the index
        is interpreted through the SNAPSHOT's payload (the handle list
        registered with those rules), never `self.handles` — a standby
        install publishes seconds after add/remove mutated the live
        list, and a published-generation index into the mutated list
        would route wrong (or past the end). Served from the exact
        O(probes) host index, same winner as the oracle/device."""
        m = self._matcher
        snap = m.snapshot()
        idx = m.index_snap(snap, hint)
        handles = m.snap_payload(snap)
        if handles is None:  # pre-first-publish: the live list
            handles = self.handles
        return handles[idx] if 0 <= idx < len(handles) else None

    def search_batch(self, hints: Sequence[Hint]) -> list[Optional[GroupHandle]]:
        m = self._matcher
        snap = m.snapshot()  # one generation for every answer
        handles = m.snap_payload(snap)
        if handles is None:
            handles = self.handles
        out = []
        for h in hints:
            i = m.index_snap(snap, h)
            out.append(handles[i] if 0 <= i < len(handles) else None)
        return out

    def seek(self, source_ip: bytes, hint: Hint,
             fam: Optional[str] = None,
             exclude: Optional[set] = None) -> Optional[Connector]:
        h = self.search_for_group(hint)
        if h is not None:
            return h.group.next(source_ip, fam, exclude)
        return None

    # --------------------------------------- host-only (retry) selection

    def _search_host(self, hint: Hint) -> Optional[GroupHandle]:
        """search_for_group on the HOST index only (exact oracle parity,
        O(probes), ~µs — rules/index.py): the connect-retry path runs
        inside event-loop failure callbacks and must never eat a
        synchronous device dispatch, least of all during a backend
        outage when retries spike."""
        m = self._matcher
        snap = m.snapshot()
        idx = m.index_snap(snap, hint)
        payload = m.snap_payload(snap)
        handles = payload if payload is not None else self.handles
        return handles[idx] if 0 <= idx < len(handles) else None

    def next_host(self, source_ip: bytes, hint: Optional[Hint] = None,
                  fam: Optional[str] = None,
                  exclude: Optional[set] = None) -> Optional[Connector]:
        """`next` semantics (hint group first, WRR fallback) with the
        classify served from the host index."""
        if hint is not None:
            h = self._search_host(hint)
            if h is not None:
                c = h.group.next(source_ip, fam, exclude)
                if c is not None:
                    return c
        return self._wrr_next(source_ip, fam, exclude)

    def seek_host(self, source_ip: bytes, hint: Hint,
                  fam: Optional[str] = None,
                  exclude: Optional[set] = None) -> Optional[Connector]:
        """`seek` semantics (hint-only, no WRR fallback), host index."""
        h = self._search_host(hint)
        if h is not None:
            return h.group.next(source_ip, fam, exclude)
        return None

    def next(self, source_ip: bytes, hint: Optional[Hint] = None,
             fam: Optional[str] = None,
             exclude: Optional[set] = None) -> Optional[Connector]:
        """exclude: ServerHandles a connect-retry must skip (the
        failure-containment layer re-enters this loop after a backend
        refused, excluding everything already tried)."""
        if hint is not None:
            c = self.seek(source_ip, hint, fam, exclude)
            if c is not None:
                return c
        return self._wrr_next(source_ip, fam, exclude)

    def _wrr_next(self, source_ip: bytes, fam: Optional[str],
                  exclude: Optional[set] = None) -> Optional[Connector]:
        with self._lock:
            seq, groups = self._wrr_seq, self._wrr_groups
            for _ in range(len(seq) + 1):
                if not seq:
                    return None
                idx = self._wrr_cursor % len(seq)
                self._wrr_cursor = idx + 1
                c = groups[seq[idx]].group.next(source_ip, fam, exclude)
                if c is not None:
                    return c
            return None

    # ------------------------------------------------- batched data plane

    def search_for_group_async(self, hint: Hint, cb, loop=None) -> None:
        """Async search_for_group via the ClassifyService micro-batch
        queue; cb(GroupHandle | None) fires on *loop*. The handle list
        arrives as the matcher generation's payload, so the index is
        always interpreted against the same add/remove generation that
        the device table encoded."""
        if not self.handles:
            cb(None)
            return
        from ..rules.service import ClassifyService

        def on_idx(idx: int, handles) -> None:
            cb(handles[idx] if handles and 0 <= idx < len(handles) else None)

        ClassifyService.get().submit_hint(self._matcher, hint, on_idx, loop)

    def next_async(self, source_ip: bytes, hint: Optional[Hint], cb,
                   fam: Optional[str] = None, loop=None) -> None:
        """Async `next`: the hint classify rides the ClassifyService
        micro-batch queue (rules/service.py) instead of a per-connection
        device dispatch; cb(Connector | None) fires on *loop*.

        This is the replacement for the reference's per-connection scan
        in Upstream.searchForGroup (Upstream.java:187-198).

        Span timers: the hint classify (submit->index) lands in the
        `classify` accept-stage histogram, the group/WRR selection in
        `backend_pick` (utils/metrics accept_stage_observe)."""
        if hint is None or not self.handles:
            t0 = time.monotonic()
            c = self._wrr_next(source_ip, fam)
            accept_stage_observe("backend_pick", time.monotonic() - t0)
            cb(c)
            return
        from ..rules.service import ClassifyService
        t_sub = time.monotonic()

        def on_idx(idx: int, handles) -> None:
            t_idx = time.monotonic()
            accept_stage_observe("classify", t_idx - t_sub)
            if handles and 0 <= idx < len(handles):
                c = handles[idx].group.next(source_ip, fam)
                if c is not None:
                    accept_stage_observe("backend_pick",
                                         time.monotonic() - t_idx)
                    cb(c)
                    return
            c = self._wrr_next(source_ip, fam)
            accept_stage_observe("backend_pick", time.monotonic() - t_idx)
            cb(c)

        ClassifyService.get().submit_hint(self._matcher, hint, on_idx, loop)

    def seek_async(self, source_ip: bytes, hint: Hint, cb,
                   fam: Optional[str] = None, loop=None) -> None:
        """Async `seek` (hint-only, no WRR fallback); cb(Connector|None)."""
        if not self.handles:
            cb(None)
            return
        from ..rules.service import ClassifyService

        def on_idx(idx: int, handles) -> None:
            if handles and 0 <= idx < len(handles):
                cb(handles[idx].group.next(source_ip, fam))
            else:
                cb(None)

        ClassifyService.get().submit_hint(self._matcher, hint, on_idx, loop)
