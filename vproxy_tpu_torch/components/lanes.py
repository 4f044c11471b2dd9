"""AcceptLanes — Python as the lane-entry COMPILER for TcpLB's C accept
plane (native/vtl.cpp "accept lanes").

The switch flow cache's division of labor applied to TCP accept: N lane
threads park inside `vtl_lane_poll` (ctypes releases the GIL) while C
runs the whole short-connection lifetime — accept4 batch, route lookup
against the installed lane entry, backend connect, splice, close. This
module owns everything that must stay in Python:

* **compile + install** — flatten the Upstream's (group weight x server
  weight) healthy-backend set into LANE_REC records plus the
  subtract-sum WRR sequence, stamped with the generation read BEFORE
  the compile began (`vtl_lane_install` rejects a raced stamp with
  -EAGAIN and we recompile against current state);
* **generation hooks** — every upstream mutation (Upstream listeners),
  ACL edit (SecurityGroup listeners) and backend membership/health
  change (ServerGroup.on_change) bumps the one C atomic
  (`vtl_lane_gen_bump`) and schedules a recompile. A lane entry whose
  stamp mismatches is a forced punt: zero stale routing by
  construction. The `lane.entry.stale` failpoint suppresses exactly one
  bump (tests/test_lanes.py proves the gate is what prevents stale
  forwards);
* **failpoint discipline** — any armed fault outside the lane.* sites
  flips the C punt_all flag, forcing the classic path so the
  backend.connect.* / pump.abort injection sites keep exact semantics
  (the `_fast_splice` rule, enforced once per arm edge instead of
  per accept);
* **punt dispatch** — classic punts land in `TcpLB._on_accept` on a
  worker loop (ACL, overload shed, drain shed, accounting all apply);
  connect-failure punts resolve the backend handle and feed
  `report_failure` + the bounded retry machinery with the client fd
  intact, exactly like `vtl_pump_connect`'s connect_failed DONE.

Knobs: VPROXY_TPU_ACCEPT_LANES (lane thread count, 0 = off, the
default), VPROXY_TPU_ACCEPT_LANES_URING (allow the io_uring engine when
the runtime probe passes; the epoll engine is the fallback and the only
engine on pre-5.1 kernels like this container's).

The port's copy of vproxy_tpu/components/lanes.py, same names and behaviour.
"""
from __future__ import annotations

import math
import os
import threading
from typing import Optional

from ..net import vtl
from ..policing import engine as policing
from ..rules.ir import Proto
from ..utils import events, failpoint, sketch, trace, workload
from ..utils.ip import parse_ip
from ..utils.log import Logger
from ..utils.metrics import accept_stage_merge, conn_merge
from .servergroup import Connector

_log = Logger("accept-lanes")

LANES = int(os.environ.get("VPROXY_TPU_ACCEPT_LANES", "0"))
LANES_URING = os.environ.get("VPROXY_TPU_ACCEPT_LANES_URING", "1") != "0"
# backend-pick mode for wrr-method upstreams: "wrr" (default — the
# configured round-robin semantics) or "maglev" (consistent hashing:
# per-connection spread via the 5-tuple hash, resize moves ~1/N of
# flows; the bench A/B lever). method=source groups ALWAYS compile the
# maglev table — that IS their semantic (docs/perf.md).
LANE_PICK = os.environ.get("VPROXY_TPU_LANE_PICK", "wrr")
_SEQ_CAP = 4096  # WRR sequence bound (weights renormalized past it)


def _wrr_seq(weights: list) -> list:
    """The reference's subtract-sum sequence over backend indexes
    (ServerGroup._wrr_compute semantics), gcd-reduced and capped so a
    pathological weight set cannot inflate the C-side table. Equal
    weights (the common fleet) short-circuit to plain round-robin —
    the subtract-sum loop is O(picks x n) and the compiler runs on
    every health edge, so big fleets must not pay it."""
    if not weights:
        return []
    if len(set(weights)) == 1:
        return list(range(len(weights)))
    g = 0
    for w in weights:
        g = math.gcd(g, w)
    if g > 1:
        weights = [w // g for w in weights]
    total = sum(weights)
    if total > _SEQ_CAP:
        weights = [max(1, (w * _SEQ_CAP) // total) for w in weights]
        total = sum(weights)
    if total > _SEQ_CAP:
        # the max(1,..) floor can't shrink below one slot per backend:
        # a fleet larger than the cap degrades to fair round-robin
        # (O(n) compile, every backend picked) instead of an O(n*total)
        # subtract-sum that would pin the compiler on each health edge
        return list(range(len(weights)))
    cur = list(weights)
    seq: list = []
    while True:
        idx = max(range(len(cur)), key=lambda i: (cur[i], -i))
        seq.append(idx)
        cur[idx] -= total
        if all(w == 0 for w in cur):
            return seq
        for i in range(len(cur)):
            cur[i] += weights[i]


class AcceptLanes:
    """One per lanes-enabled TcpLB; owns the C handle, the lane threads
    and every registered mutation hook."""

    def __init__(self, lb, n: int, uring: bool = LANES_URING):
        self.lb = lb
        self.n = n
        self.uring = uring
        self.handle = 0
        self.threads: list[threading.Thread] = []
        self._compiler: Optional[threading.Thread] = None
        self._dirty = threading.Event()
        self._stop = False
        self._groups: set = set()  # groups holding our on_change hook
        self._hook_lock = threading.Lock()
        # pick-structure state for the detail surface (compiler thread
        # writes, readers tolerate a torn mid-compile view)
        self.pick_mode = "empty"      # "wrr" | "maglev" | "empty"
        self.maglev_m = 0
        self.maglev_last_remap = 0.0
        self._maglev_prev = None      # (table, names) of the last compile
        # serializes vtl_lanes_free against cross-thread stat()/active()
        # readers (list-detail, HTTP detail, drain polling): the C
        # object must not be freed mid-read
        self._handle_lock = threading.Lock()
        # cumulative C stage-histogram snapshot (lane 0's poll tick
        # merges the deltas into vproxy_accept_stage_us)
        self._stage_last = [(0, 0.0) for _ in vtl.LANE_STAGES]
        self._stage_bkt_last = [[0] * vtl.LANE_STAGE_BUCKETS
                                for _ in vtl.LANE_STAGES]
        # cumulative C workload-capture snapshot (same fold):
        # lane-plane inter-arrival + per-connection bytes/duration
        self._cap_last = [(0, 0.0) for _ in vtl.LANE_CAPTURES]
        self._cap_bkt_last = [[0] * vtl.LANE_STAGE_BUCKETS
                              for _ in vtl.LANE_CAPTURES]
        # policing plane: the last POLICE_REC table the engine
        # compiled (re-stamped after every route recompile — a gen bump
        # stales the C police table too) + the cumulative C counter
        # snapshot lane 0 folds deltas from
        self._police_recs: list = []
        self._pol_last = (0, 0, 0, 0, 0)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        """Bind the lane listeners (resolving an ephemeral bind_port),
        install the first lane entry, register every generation hook and
        launch the lane + compiler threads. Raises OSError on bind
        failure — the caller falls back to the python accept path."""
        lb = self.lb
        # the sampling knob is one process-wide C atomic: push the
        # current python-side value so C lanes and python flip together
        # (trace.configure() pushes on later changes)
        vtl.trace_set_sample(trace.sample_every())
        # same idiom for the analytics knob (the lane HH shards gate
        # their per-accept work on one C atomic)
        sketch.push_native_knob()
        # ...and the workload-capture knob (lane inter-arrival +
        # per-connection histograms gate on one C atomic too)
        workload.push_native_knob()
        # ...and the policing knob (the lane admission probe gates on
        # one relaxed C atomic — the knob-off contract)
        policing.push_native_knob()
        self.handle = vtl.lanes_new(
            lb.bind_ip, lb.bind_port, 512, self.n, lb.in_buffer_size,
            self.uring, lb.timeout_ms, lb.connect_timeout_ms)
        if lb.bind_port == 0:
            lb.bind_port = vtl.lanes_port(self.handle)
        vtl.lanes_set_limit(self.handle,
                            max(0, lb.effective_max_sessions()
                                - lb.active_sessions))
        if getattr(lb, "_overguard", None) is not None:
            vtl.lanes_set_shed(self.handle, True)  # adaptive: RST in C
        lb.backend.add_listener(self._on_mutation)
        lb.security_group.add_listener(self._on_mutation)
        failpoint.on_change.append(self._on_failpoints)
        self._on_failpoints()  # pick up faults armed before start
        # enforcement-table installer: the decision plane pushes every
        # recompiled POLICE_REC set through here; seed with the current
        # table so a lane brought up mid-storm enforces immediately
        policing.default().on_install.append(self._install_police)
        self._install_police(policing.default().compile_recs())
        self._compile_install()
        self._compiler = threading.Thread(
            target=self._compile_loop, name=f"lane-compile-{lb.alias}",
            daemon=True)
        self._compiler.start()
        for i in range(self.n):
            t = threading.Thread(target=self._lane_loop, args=(i,),
                                 name=f"lane-{lb.alias}-{i}", daemon=True)
            t.start()
            self.threads.append(t)
        events.record(
            "lanes", f"lb {lb.alias}: {self.n} accept lanes on "
            f"{lb.bind_ip}:{lb.bind_port} engine={self.engine()}",
            lb=lb.alias, lanes=self.n, engine=self.engine())

    def close_listeners(self) -> None:
        """Drain: lanes stop accepting (each lane closes its own
        listener at the next tick); live spliced sessions run on."""
        if self.handle:
            vtl.lanes_close_listeners(self.handle)

    def shutdown(self) -> None:
        """Stop: close listeners, give in-flight pumps a short grace,
        then tear down threads, hooks and the native object."""
        lb = self.lb
        self._stop = True
        self._dirty.set()
        if self.handle:
            vtl.lanes_shutdown(self.handle, 500)
        for t in self.threads:
            t.join(3)
        if self._compiler is not None:
            self._compiler.join(3)
        lb.backend.remove_listener(self._on_mutation)
        lb.security_group.remove_listener(self._on_mutation)
        try:
            failpoint.on_change.remove(self._on_failpoints)
        except ValueError:
            pass
        try:
            policing.default().on_install.remove(self._install_police)
        except ValueError:
            pass
        with self._hook_lock:
            groups, self._groups = self._groups, set()
        for g in groups:
            g.off_change(self._on_mutation)
        alive = [t for t in self.threads if t.is_alive()]
        if self._compiler is not None and self._compiler.is_alive():
            alive.append(self._compiler)  # mid-compile: it holds handle
        if alive:
            # a wedged lane/compiler thread still owns the native
            # object: freeing under it would be a use-after-free — leak
            # instead. self.handle stays nonzero ON PURPOSE: the wedged
            # thread keeps using its live (leaked) object, never NULL.
            _log.alert(f"lanes {lb.alias}: {len(alive)} thread(s) did "
                       "not exit; leaking native lanes")
            return
        with self._handle_lock:  # no stat()/active() mid-free
            h, self.handle = self.handle, 0
        vtl.lanes_free(h)

    # ------------------------------------------------------------ state

    def engine(self) -> str:
        with self._handle_lock:  # like every cross-thread reader
            return vtl.lanes_engine(self.handle) if self.handle else "off"

    def stat(self) -> dict:
        """list-detail / HTTP detail payload. Reads under the handle
        lock so a concurrent shutdown cannot free the C object mid-
        read."""
        with self._handle_lock:
            if not self.handle:
                return {"on": False}
            st = vtl.lanes_stat(self.handle)
        (accepted, served, active, p_classic, p_stale, p_fail,
         nbytes, gen, engine, port, killed) = st[:11]
        shed = st[11] if len(st) > 11 else 0  # an older .so: no C shed
        lat_us = st[12] if len(st) > 12 else 0  # an older .so: no EWMA
        punts = p_classic + p_stale + p_fail
        return {"on": True, "lanes": self.n,
                "engine": "uring" if engine else "epoll",
                "uring_probe": vtl.uring_probe_fields(),
                "gen": gen, "accepted": accepted, "served": served,
                "active": active, "punts": punts,
                "punt_stale": p_stale, "punt_connect_fail": p_fail,
                "killed": killed, "shed": shed, "bytes": nbytes,
                "hit_rate": round(
                    (served + killed) / max(1, served + killed + punts),
                    4),
                "accept_ewma_ms": round(lat_us / 1000.0, 3),
                "pick": self.pick_mode,
                "maglev": ({"m": self.maglev_m,
                            "last_remap": round(self.maglev_last_remap, 4)}
                           if self.pick_mode == "maglev" else None),
                "port": port}

    def active(self) -> int:
        """Live lane-owned sessions (drain accounting + the per-accept
        overload check): one atomic load under the handle lock."""
        with self._handle_lock:
            if not self.handle:
                return 0
            return vtl.lanes_active(self.handle)

    def set_timeout(self, timeout_ms: int) -> None:
        """Hot-set the lane idle timeout — under the handle lock (a
        hot-update racing remove/stop must not reach a freed Lanes*)."""
        with self._handle_lock:
            if self.handle:
                vtl.lanes_set_timeout(self.handle, timeout_ms)

    def set_limit(self, n: int) -> None:
        """Hot-set the lane active-session bound (same locking)."""
        with self._handle_lock:
            if self.handle:
                vtl.lanes_set_limit(self.handle, n)

    def set_shed(self, on: bool) -> None:
        """Adaptive-overload RST shed inside C for over-limit accepts
        (components/overload.py flips this with the controller mode)."""
        with self._handle_lock:
            if self.handle:
                vtl.lanes_set_shed(self.handle, on)

    def shed_count(self) -> int:
        """Cumulative C-side RST sheds (the guard tick diffs this into
        vproxy_lb_shed_total{reason=adaptive})."""
        with self._handle_lock:
            if not self.handle:
                return 0
            st = vtl.lanes_stat(self.handle)
        return st[11] if len(st) > 11 else 0

    def accept_latency_ms(self) -> float:
        """The C-plane accept->backend-connected EWMA (ms) — the signal
        the adaptive overload controller folds in so lane-served load
        is no longer invisible to its accept-latency input (without it the
        python EWMA only ever sees punts). 0.0 on an older .so."""
        with self._handle_lock:
            if not self.handle:
                return 0.0
            st = vtl.lanes_stat(self.handle)
        return (st[12] / 1000.0) if len(st) > 12 else 0.0

    # ------------------------------------------------------------ hooks

    def _on_mutation(self) -> None:
        """ANY routing-relevant mutation lands here (upstream recalc,
        ACL edit, group membership/health edge). Bump first — the gate
        must close before the new state is even readable — then defer
        the recompile to the compiler thread (callers may hold group
        locks; the compile takes none but must not run under them)."""
        if failpoint.hit("lane.entry.stale", self.lb.alias):
            # suppress exactly ONE bump: the stale lane entry stays
            # serveable, proving the generation gate (not timing) is
            # what prevents stale routing — tests/test_lanes.py
            return
        if self.handle:
            vtl.lane_gen_bump(self.handle)
        self._dirty.set()

    def _on_failpoints(self) -> None:
        """Armed faults (outside lane.*) force every accept down the
        classic path so injection-site semantics stay exact."""
        if self.handle:
            vtl.lanes_set_punt_all(
                self.handle, failpoint.any_armed_excluding("lane."))

    # ------------------------------------------------------------ policing

    def _install_police(self, recs: list) -> bool:
        """The decision plane's installer hook: remember the table (the
        route compiler re-stamps it after every gen bump) and push it
        into C now."""
        self._police_recs = list(recs)
        return self._police_install()

    def _police_install(self) -> bool:
        """Generation-stamped POLICE_REC install, retried while bumps
        race it — same contract as the route entry, except a losing
        stamp fails OPEN (consult-miss = admit) instead of punting."""
        if not vtl.police_supported():
            return False
        with self._handle_lock:
            if not self.handle:
                return False
            for _ in range(8):
                gen = vtl.lane_gen(self.handle)
                r = vtl.police_install(
                    self.handle, b"".join(self._police_recs),
                    len(self._police_recs), gen)
                if r >= 0:
                    return True
        return False

    def _merge_police(self, handle) -> None:
        """Fold the C police-counter deltas into the decision plane's
        attribution — and the legacy shed/overload families via the LB
        (a policed refusal must move the counters the older
        dashboards alert on). shed/monitor deltas only: a C throttle
        verdict PUNTS, so the python mirror counts it exactly once;
        stale deltas are a diagnostic, not an action."""
        if not vtl.police_supported():
            return
        try:
            cur = vtl.police_counters(handle)
        except OSError:
            return
        _c, shed, _t, mon, _s = cur
        _lc, lshed, _lt, lmon, _ls = self._pol_last
        if shed > lshed:
            d = shed - lshed
            policing.account_native(self.lb.alias, "shed", "clients", d)
            self.lb._policed_shed(d)
        if mon > lmon:
            policing.account_native(self.lb.alias, "monitor", "clients",
                                    mon - lmon)
        self._pol_last = cur

    # ------------------------------------------------------------ compile

    def _compile_loop(self) -> None:
        while not self._stop:
            self._dirty.wait(timeout=1.0)
            if self._stop:
                return
            if not self._dirty.is_set():
                continue
            self._dirty.clear()
            try:
                self._compile_install()
            except Exception as e:  # never kill the compiler thread
                _log.alert(f"lanes {self.lb.alias}: compile failed: {e!r}")

    def _compile_install(self) -> None:
        """Snapshot -> LANE_RECs + pick structure (WRR seq or maglev
        table) -> vtl_lane_install / vtl_lane_maglev_install, retried
        while mutations race the compile (bounded; the gate keeps
        correctness either way — worst case the entry stays empty and
        every accept punts)."""
        lb = self.lb
        for _ in range(8):
            gen = vtl.lane_gen(self.handle)
            mode, recs, aux, hash_port = self._compile()
            if mode == "maglev":
                r = vtl.lane_maglev_install(self.handle, b"".join(recs),
                                            len(recs), aux, hash_port, gen)
            else:
                r = vtl.lane_install(self.handle, b"".join(recs),
                                     len(recs), aux, gen)
            if r >= 0:
                self.pick_mode = mode if recs else "empty"
                # the gen bump that forced this recompile staled the
                # police table too (same stamp): re-install it so
                # enforcement resumes — until then mismatched stamps
                # fail OPEN (admit), never closed
                self._police_install()
                return
            # -EAGAIN: a bump landed mid-compile; go again vs new state
        _log.warn(f"lanes {lb.alias}: install kept racing mutations; "
                  "entry left stale-gated (all accepts punt)")

    def _compile(self):
        """Flatten the upstream into (backend, combined-weight) records
        plus the pick structure. -> (mode, recs, seq_or_table,
        hash_port): mode "wrr" installs the subtract-sum sequence,
        "maglev" the consistent-hash slot table. Non-trivial ACLs and
        TLS holders compile to an EMPTY entry — every accept punts to
        the python path that owns those checks. Also (re)subscribes
        group change hooks for the current group set."""
        lb = self.lb
        handles = list(lb.backend.handles)
        groups = {gh.group for gh in handles}
        with self._hook_lock:
            for g in groups - self._groups:
                g.on_change(self._on_mutation)
            for g in self._groups - groups:
                g.off_change(self._on_mutation)
            self._groups = groups
        if (lb.holder is not None or lb.draining
                or not lb.security_group.trivial_allow(Proto.TCP)):
            return "wrr", [], [], True
        methods = {gh.group.method for gh in handles}
        if "wlc" in methods:
            # least-connections needs live python-side conn counts:
            # compile EMPTY, python keeps the semantics
            return "wrr", [], [], True
        if "source" in methods:
            weighted = [gh for gh in handles
                        if gh.weight > 0 and gh.group.method == "source"]
            if (methods != {"source"} or len(weighted) != 1
                    or not vtl.maglev_supported()):
                # mixed methods / multi-group source keep the python
                # path's two-level semantics; an old .so without the
                # maglev ABI punts too (never guess in C)
                return "wrr", [], [], True
            # source affinity IS a maglev table (hash_port=0: one
            # backend per client address). The SAME identities, weights
            # and M as ServerGroup._maglev_state, so the C pick and the
            # python punt-path pick agree at every generation —
            # tests/test_maglev.py proves it.
            return self._compile_maglev([weighted[0]], hash_port=False)
        if LANE_PICK == "maglev" and vtl.maglev_supported():
            return self._compile_maglev(
                [gh for gh in handles if gh.weight > 0], hash_port=True)
        # two-level pick, exactly like the classic path (group-level
        # WRR, then THAT group's own server WRR): flattening
        # gh.weight*s.weight would skew multi-group proportions by
        # server count. Emit the outer group sequence with each slot
        # resolved through the group's rotating server sequence.
        recs, group_seqs = [], []
        for gh in handles:
            if gh.weight <= 0:
                continue
            sidx, sweights = [], []
            for s in list(gh.group.servers):
                if not s.healthy or s.logic_delete or s.weight <= 0:
                    continue
                sidx.append(len(recs))
                sweights.append(s.weight)
                recs.append(vtl.LANE_REC.pack(
                    s.ip.encode(), s.port, 1 if ":" in s.ip else 0,
                    min(255, s.weight)))
            if sidx:
                group_seqs.append(
                    (gh.weight, [sidx[i] for i in _wrr_seq(sweights)]))
        if not group_seqs:
            return "wrr", recs, [], True
        outer = _wrr_seq([w for w, _ in group_seqs])
        # close EVERY group's rotation: lcm of the inner sequence
        # lengths (max alone leaves shorter rotations mid-cycle at the
        # wrap point — a persistent intra-group weight skew). The cap
        # bounds pathological lcm blowups; a capped sequence wraps with
        # at most one inner-cycle misalignment per seqlen picks.
        reps = 1
        for _, sq in group_seqs:
            reps = math.lcm(reps, len(sq))
        reps = min(reps, max(1, _SEQ_CAP // max(1, len(outer))))
        order, cursors = [], [0] * len(group_seqs)
        for _ in range(reps):
            for gi in outer:
                sq = group_seqs[gi][1]
                order.append(sq[cursors[gi] % len(sq)])
                cursors[gi] += 1
        return "wrr", recs, order, True

    def _compile_maglev(self, weighted, hash_port: bool):
        """Compile the maglev route: MAGLEV_REC backends + the slot
        table (rules/maglev.build_table).

        Single source group (hash_port=False): the group's OWN table
        snapshot — identical identities/weights/M to the python pick
        path, so a punted connection routes exactly where the lane
        would have. Multi-group wrr (hash_port=True): flattened with
        gh.weight x s.weight scaled by the group's weight sum, so
        group-level proportions survive regardless of server count.
        Tracks the rebuild's slot churn for the detail surface."""
        from ..rules import maglev as MG
        recs, entries = [], []
        table = None
        if not hash_port:
            # the group's own snapshot: build_table is deterministic on
            # (identities, weights, M), so reusing the group's table IS
            # the parity guarantee (and skips a redundant build)
            g = weighted[0].group
            servers, table = g.maglev_table()
            for s in servers:
                entries.append((g.maglev_identity(s), s.weight))
                recs.append(vtl.MAGLEV_REC.pack(
                    s.ip.encode(), s.port, 1 if ":" in s.ip else 0,
                    min(255, s.weight)))
        else:
            for gh in weighted:
                eligible = [s for s in list(gh.group.servers)
                            if s.healthy and not s.logic_delete
                            and s.weight > 0]
                sw = sum(s.weight for s in eligible)
                for s in eligible:
                    w = max(1, round(gh.weight * s.weight * 64 / sw))
                    entries.append(
                        (f"{gh.group.alias}|{s.ip}:{s.port}", w))
                    recs.append(vtl.MAGLEV_REC.pack(
                        s.ip.encode(), s.port, 1 if ":" in s.ip else 0,
                        min(255, s.weight)))
        if not entries:
            return "maglev", [], [], hash_port
        if table is None:
            table = MG.build_table(entries, MG.GROUP_M)
        prev = self._maglev_prev
        names = [n for n, _ in entries]
        self.maglev_last_remap = MG.remap_fraction(
            prev[0] if prev else None, table,
            prev[1] if prev else None, names)
        self._maglev_prev = (table, names)
        self.maglev_m = len(table)
        return "maglev", recs, table, hash_port

    # ------------------------------------------------------------ punts

    def _lane_loop(self, idx: int) -> None:
        # snapshot the handle: shutdown() zeroes self.handle after the
        # join window, and a late (wedged-then-recovered) thread must
        # keep polling the real — possibly leaked — C object, never 0
        handle = self.handle
        last_accepted = 0
        last_routed = 0  # routes-dim analytics credit (lane 0 only)
        while True:
            try:
                punts = vtl.lane_poll(handle, idx, 1000)
            except OSError as e:
                _log.alert(f"lane {self.lb.alias}/{idx} poll: {e!r}")
                return
            if trace.enabled() and vtl.trace_supported():
                # drain THIS lane's span ring into the process buffer
                # (SPSC: this thread is the one consumer) — until dry:
                # a lane that stayed inside C for a whole poll window
                # under load has a multi-chunk backlog. Knob-off cost
                # is the enabled() branch alone.
                try:
                    while True:
                        recs = vtl.trace_drain(handle, idx)
                        if recs:
                            trace.ingest_lane_recs(recs)
                        if len(recs) < vtl._TRACE_DRAIN_MAX:
                            break
                except OSError:
                    pass
            if sketch.enabled() and vtl.hh_supported():
                # drain THIS lane's analytics shard (same OS thread as
                # the in-C producer — no concurrency by construction)
                # until dry; knob-off cost is the enabled() branch
                try:
                    while True:
                        recs = vtl.hh_drain(handle, idx)
                        if recs:
                            sketch.ingest_hh_recs(recs)
                        if len(recs) < vtl._HH_DRAIN_MAX:
                            break
                except OSError:
                    pass
            if idx == 0:
                self._merge_stage_hists(handle)
                self._merge_capture_hists(handle)
                self._merge_police(handle)
                # the decision plane's lazy tick rides the lane-0 poll
                # cadence (the sketch-rotation idiom: no extra thread)
                policing.maybe_tick()
            if idx == 0:
                # retry-budget denominator: lane-SERVED accepts never
                # pass through _on_accept, but their connect-fail punts
                # SPEND the budget — credit them in batches (per poll
                # tick, lane 0 only). Classic/stale punts are excluded:
                # those land in _on_accept, which credits them itself
                # (double-crediting would double the retry allowance
                # exactly in degraded punt-heavy states).
                try:
                    st = vtl.lanes_stat(handle)
                    acc = st[0] - st[3] - st[4]  # - classic - stale
                    if len(st) > 11:
                        # C RST-sheds never generate connect load and
                        # must not fund the budget (the python shed path
                        # returns before on_accept for the same reason)
                        acc -= st[11]
                except OSError:
                    acc = last_accepted
                if acc > last_accepted:
                    self.lb._retry_budget.on_accepts(acc - last_accepted)
                    last_accepted = acc
                if acc > last_routed:
                    # routes-dim credit for lane-owned traffic: the LB
                    # alias keyed by the SAME punt/shed-adjusted delta
                    # the retry budget uses — classic/stale punts land
                    # in _on_accept (which credits the route itself,
                    # so raw accepted would double-count them) and RST
                    # sheds were never routed anywhere. The cursor
                    # advances even with analytics OFF: a later enable
                    # must not replay the whole off-period into one
                    # window as a phantom rate spike.
                    if sketch.enabled():
                        sketch.update("routes", self.lb.alias,
                                      acc - last_routed, plane="lane")
                    last_routed = acc
            if punts is None:
                return  # lanes_shutdown drained this lane
            for p in punts:
                try:
                    self._dispatch(p)
                except Exception:
                    vtl.close(p[0])

    def _merge_stage_hists(self, handle) -> None:
        """Fold the C stage-histogram deltas into the process-wide
        vproxy_accept_stage_us series (satellite of the tracing PR:
        lane-served connections used to be invisible to the stage
        histograms python-path connections populate). Lane 0's poll
        tick only; one ctypes call per stage per tick."""
        if not hasattr(vtl.LIB, "vtl_lanes_stage_stat"):
            return
        for si, stage in enumerate(vtl.LANE_STAGES):
            try:
                count, sum_us, bkt = vtl.lanes_stage_stat(handle, si)
            except OSError:
                return
            lc, ls = self._stage_last[si]
            if count <= lc:
                continue
            deltas = [b - p for b, p in
                      zip(bkt, self._stage_bkt_last[si])]
            accept_stage_merge(stage, deltas, float(sum_us - ls),
                               count - lc)
            self._stage_last[si] = (count, float(sum_us))
            self._stage_bkt_last[si] = bkt

    def _merge_capture_hists(self, handle) -> None:
        """Fold the C workload-capture deltas into the python-side
        series (utils/workload satellite): lane-plane inter-arrival
        into vproxy_workload_interarrival_us{plane=lane}, per-connection
        bytes/duration into the vproxy_lb_conn_* histograms (process
        aggregate + this LB). Lane 0's poll tick only — the same
        delta-fold discipline as _merge_stage_hists."""
        if not hasattr(vtl.LIB, "vtl_lanes_capture_stat"):
            return
        for ci, cap in enumerate(vtl.LANE_CAPTURES):
            try:
                count, total, bkt = vtl.lanes_capture_stat(handle, ci)
            except OSError:
                return
            lc, ls = self._cap_last[ci]
            if count <= lc:
                continue
            deltas = [b - p for b, p in zip(bkt, self._cap_bkt_last[ci])]
            if cap == "interarrival_us":
                workload.arrival_merge("lane", deltas, float(total - ls),
                                       count - lc)
            else:
                conn_merge(self.lb.alias,
                           "bytes" if cap == "conn_bytes"
                           else "duration_ms",
                           deltas, float(total - ls), count - lc)
            self._cap_last[ci] = (count, float(total))
            self._cap_bkt_last[ci] = bkt

    def _dispatch(self, punt) -> None:
        fd, kind, err, cip, cport, bip, bport, tid = punt
        lb = self.lb
        try:
            wl = lb.worker.next()
        except Exception:
            vtl.close(fd)
            return
        if kind == vtl.LANE_PUNT_CONNECT_FAIL:
            target = self._find_backend(bip, bport)
            if target is not None:
                src = parse_ip(cip) if cip else b""

                def run(wl=wl, target=target):
                    # same ownership contract as a python connect
                    # failure: report_failure feeds the ejection streak
                    # and the bounded retry either re-dials or closes
                    # (a sampled punt's trace id rides along: the retry
                    # continues the C-side trace)
                    lb._backend_connect_failed(
                        wl, fd, target, b"", f"{cip}:{cport}", None, src,
                        0, set(), err, hint=None, tid=tid)

                if not wl.run_on_loop(run):
                    vtl.close(fd)
                return
            # backend vanished from the tables since the entry compiled:
            # fall through — the classic path re-decides from scratch
            # (its analytics dims were already tallied in C at pick
            # time AND by lane 0's routes credit, so _on_accept must
            # not count them again)
            if not wl.run_on_loop(
                    lambda: lb._on_accept(wl, fd, cip, cport, tid=tid,
                                          hh_counted=True)):
                vtl.close(fd)
            return
        if not wl.run_on_loop(
                lambda: lb._on_accept(wl, fd, cip, cport, tid=tid)):
            vtl.close(fd)

    def _find_backend(self, ip: str, port: int) -> Optional[Connector]:
        for gh in list(self.lb.backend.handles):
            for s in list(gh.group.servers):
                if s.ip == ip and s.port == port and not s.logic_delete:
                    return Connector(s, gh.group)
        return None
