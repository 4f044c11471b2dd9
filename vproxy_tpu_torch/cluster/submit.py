"""Step-synchronized multi-host submit loop — the SPMD serving clock.

A copy of `vproxy_tpu/cluster/submit.py`; the dispatch results are
pulled with utils.torchenv.to_host (a CUDA tensor has no numpy view),
imported where a dispatch runs, so a metrics scrape that reads this
package never loads torch.

SPMD dispatch has a contract single-host serving never sees: EVERY
host must participate in EVERY dispatch with EQUAL padded shapes, or
the collective deadlocks (a host that skips a step leaves the others
blocked in the reduction forever). This module turns the free-running
micro-batch queue (rules/service.py) into a fleet-wide STEP CLOCK:

* each host drains its local classify queue into a FIXED-shape padded
  batch every VPROXY_TPU_CLUSTER_STEP_MS (batch cap
  VPROXY_TPU_CLUSTER_BATCH, padded with empty Hints) — a host with no
  traffic contributes an all-padding batch, so idle hosts never stall
  busy ones and per-host load may be arbitrarily unequal;
* before dispatching step N of epoch E, the host broadcasts an arrive
  datagram over the membership socket and waits until every UP,
  stepping peer has arrived at step >= N (the cluster-layer barrier).
  The epoch IS the rule generation (cluster/replicate.py), so hosts
  only ever step together against identical tables;
* the barrier AND the device dispatch share one deadline
  (VPROXY_TPU_CLUSTER_STEP_TIMEOUT_MS). Blowing it — a dead peer, a
  wedged collective (failpoint `cluster.step.stall`), or a backend
  without cross-process collectives — DEGRADES this host to the PR-3
  inline host-index path (rules/index.py, oracle-parity winners at ~us
  cost): queued and future queries are answered locally, nothing
  fails, the same failover edge as device->oracle. A degraded host
  advertises stepping=false in its heartbeats so surviving peers stop
  waiting for it.
* a degraded host RE-JOINS on the next generation heartbeat: a new
  generation is a fleet-wide epoch switch (every host resets to step 0
  of epoch G), which is exactly the barrier-reset a rejoin needs.
* a kernel that cannot serve is not a stall. A KernelError, or any
  fault of a dispatch whose matcher is on the card, CLOSES the loop
  as it closes ClassifyService (rules/service.py): the held batch and
  the queue are answered -1, every later submit raises the error, and
  the host stops stepping. Only barrier and collective faults take the
  host-index path above.

The dispatch itself is `matcher.dispatch_snap` — on a multi-host mesh
that is the sharded backends' B8 launch with its cross-rank key
reduction (parallel/mesh.py, ops/sharded_cuda.py); on a single-host
mesh it is the local device dispatch (B3, or B1 through the FusedPair),
with the step barrier still keeping the fleet in lockstep.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from ..utils import events, failpoint, trace
from ..utils.log import Logger
from .membership import Membership

_log = Logger("cluster-step")

STEP_MS = int(os.environ.get("VPROXY_TPU_CLUSTER_STEP_MS", "20"))
STEP_TIMEOUT_MS = int(os.environ.get(
    "VPROXY_TPU_CLUSTER_STEP_TIMEOUT_MS", "1000"))
BATCH = int(os.environ.get("VPROXY_TPU_CLUSTER_BATCH", "16"))


class StepLoop:
    """Per-host step-synchronized classify front. submit(hint, cb) from
    any thread; cb(rule_idx, payload) fires after the step that carried
    the query (payload = the matcher generation's attached object, the
    rules/service.py convention)."""

    def __init__(self, matcher, membership: Optional[Membership] = None,
                 step_ms: int = 0, batch_cap: int = 0, timeout_ms: int = 0,
                 on_degrade: Optional[Callable[[], None]] = None,
                 maglev=None):
        self.matcher = matcher
        self.membership = membership
        # optional Maglev plane: when a MaglevMatcher rides along, the
        # step dispatch moves onto the FUSED one-launch entry
        # (rules/engine.fused_dispatch via maglev.FusedPair) — a step
        # answers verdicts AND backend picks from one compiled program,
        # and submit_pick() queries get their pick at zero extra
        # launches. Without it, the pre-r12 hint-only dispatch serves.
        self.maglev = maglev
        self._pair = None
        if maglev is not None:
            from ..rules.maglev import FusedPair
            self._pair = FusedPair(matcher, maglev)
        self.step_ms = step_ms or STEP_MS
        self.batch_cap = batch_cap or BATCH
        self.timeout_ms = timeout_ms or STEP_TIMEOUT_MS
        self.on_degrade = on_degrade
        self.epoch = 0
        self.degraded = False
        self.steps_total = 0
        self.barrier_stalls = 0
        # the KernelError that closed the loop (None while serving)
        self.error: Optional[Exception] = None
        self._step = 0
        self._q: deque = deque()
        self._qlock = threading.Lock()
        self._arrive_cv = threading.Condition()
        # peer id -> (epoch, step) last seen in an arrive datagram
        self._peer_steps: dict[int, tuple[int, int]] = {}
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        # persistent dispatch worker: a stuck collective must not stall
        # the step loop thread itself (it has host-index work to do).
        # Requests carry a token; a rejoin bumps it and abandons any
        # stuck worker — its late result is discarded, never delivered
        # into the new epoch.
        self._disp_cv = threading.Condition()
        self._disp_req: Optional[tuple] = None   # (token, hints)
        self._disp_res: Optional[tuple] = None   # (token, "ok"/"err", ...)
        self._disp_thread: Optional[threading.Thread] = None
        self._disp_busy = False
        self._disp_token = 0
        if membership is not None:
            membership.set_step_handler(self._on_step_msg)

    # ------------------------------------------------------------- control

    def start(self, warm: bool = True) -> None:
        if self._thread is not None:
            return
        if warm:
            # compile the fixed-shape dispatch BEFORE the clock starts:
            # a first-step jit compile would blow the barrier deadline
            # and degrade a perfectly healthy host at boot. Bounded —
            # a backend that cannot dispatch at all (no cross-process
            # collectives) surfaces on step 1 as the designed stall; a
            # kernel that cannot serve raises here and the loop is closed
            wait_s = max(10.0, 3 * self.timeout_ms / 1000.0)
            try:
                self._timed_dispatch([self._PAD_ITEM()] * self.batch_cap,
                                     time.monotonic() + wait_s)
            except Exception as e:
                if _is_kernel_error(e):
                    self._kernel_failed(e, [])
                raise
        self._thread = threading.Thread(target=self._run,
                                        name="cluster-step", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop stepping and join the step thread and the dispatch
        worker (each for at most 10 s). The step in flight finishes
        (a dispatch already on the card is waited for, never abandoned),
        and what was queued is answered from the host index. A thread
        left running at interpreter exit dies inside torch's C++ frames
        and aborts the process (SIGABRT), so shutdown must come here."""
        self._stopped = True
        with self._disp_cv:
            self._disp_cv.notify_all()
        with self._arrive_cv:
            self._arrive_cv.notify_all()
        if self.membership is not None:
            # stepping=false reaches the peers now: none waits for this
            # host at a barrier while its last step finishes
            self.membership.poke()
        me = threading.current_thread()
        for t in (self._thread, self._disp_thread):
            if t is not None and t is not me:
                t.join(10.0)

    @property
    def stopped(self) -> bool:
        return self._stopped

    def rejoin(self, epoch: int) -> None:
        """Fleet-wide epoch switch (a new rule generation): every host
        resets to step 0 of the new epoch; a degraded host re-joins."""
        was = self.degraded
        with self._arrive_cv:
            if epoch <= self.epoch:
                return
            self.epoch = epoch
            self._step = 0
            self.degraded = False
            self._arrive_cv.notify_all()
        with self._disp_cv:
            # abandon a worker still stuck in the old epoch's collective
            # (its tokened result will be discarded when it surfaces)
            self._disp_token += 1
            self._disp_busy = False
            self._disp_req = None
            self._disp_res = None
            self._disp_thread = None
        if was:
            events.record("cluster_rejoin",
                          f"re-joined step dispatch at generation {epoch}",
                          generation=epoch)
            _log.info(f"re-joined step dispatch at generation {epoch}")

    @staticmethod
    def _PAD_ITEM():
        from ..rules.ir import Hint
        return (Hint(), b"\x00\x00\x00\x00", None, None, False, 0)

    def _enqueue(self, item: tuple) -> None:
        with self._qlock:
            if self.error is not None:
                raise self.error
            if self._stopped:
                raise OSError("StepLoop is stopped")
            self._q.append(item)

    def submit(self, hint, cb: Callable[[int, object], None]) -> None:
        # the trace context rides the queue item: a sampled query's
        # trace shows barrier vs collective vs host-index time on the
        # node that served it; without a bound context the step plane
        # makes its own 1-in-N decision
        tid = trace.current_id() or trace.maybe_sample()
        self._enqueue((hint, b"\x00\x00\x00\x00", None, cb, False, tid))

    def submit_pick(self, hint, ip: bytes, port: Optional[int],
                    cb: Callable[[int, int, object], None]) -> None:
        """Fused classify+pick through the step clock: cb(verdict,
        pick, (hint_payload, maglev_payload)) after the step that
        carried the query — the pick costs ZERO extra launches (it is
        one more gather inside the step's fused program). Requires the
        loop's maglev plane; port=None = source affinity."""
        if self.maglev is None:
            raise ValueError("StepLoop has no maglev plane configured")
        tid = trace.current_id() or trace.maybe_sample()
        self._enqueue((hint, ip, port, cb, True, tid))

    def _fused_live(self) -> bool:
        """True only when the NEXT step would actually dispatch fused:
        a maglev plane is configured AND the current publishes carry
        the packed tables + maglev column (VPROXY_TPU_FUSED=0, a
        non-"torch" backend, or a pre-fused publish all fall back to the
        two-dispatch chain — status must say so, not report the
        config)."""
        if self._pair is None:
            return False
        hsnap = self.matcher.snapshot()
        if len(hsnap) <= 5 or hsnap[5] is None:
            return False
        msnap = self.maglev.snapshot()
        return msnap[0] is not None and msnap[1] is not None

    def status(self) -> dict:
        return {"epoch": self.epoch, "step": self._step,
                "fused": self._fused_live(),
                "degraded": self.degraded, "steps_total": self.steps_total,
                "error": None if self.error is None else repr(self.error),
                "barrier_stalls": self.barrier_stalls,
                "queued": len(self._q), "batch_cap": self.batch_cap,
                "step_ms": self.step_ms, "timeout_ms": self.timeout_ms,
                # client steering rides the membership maglev table
                # (steer_addrs): epoch switches never move affinities,
                # only UP-set changes do — surfaced here so the step
                # view shows what a resize will cost
                "steer": (None if self.membership is None
                          else self.membership.steer_status())}

    def steer_peer(self, key: bytes):
        """Maglev-consistent UP-peer pick for a client steering key —
        the submit plane's replacement for rotation when external
        clients choose which fleet node to submit through (the DNS
        steerer is the server-side form of the same table)."""
        if self.membership is None:
            return None
        return self.membership.steer_peer(key)

    # ------------------------------------------------------------- barrier

    def _on_step_msg(self, msg: dict, peer_id: int) -> None:
        try:
            e, s = int(msg["e"]), int(msg["s"])
        except (KeyError, ValueError, TypeError):
            return
        with self._arrive_cv:
            cur = self._peer_steps.get(peer_id)
            if cur is None or (e, s) > cur:
                self._peer_steps[peer_id] = (e, s)
            self._arrive_cv.notify_all()

    def _barrier_peers(self) -> list[int]:
        """Peers this step must wait for: UP and stepping (a degraded or
        dead host must not wedge the survivors forever — membership
        flips its flags within the heartbeat hysteresis)."""
        if self.membership is None:
            return []
        return [p.node_id for p in self.membership.live_peers()
                if p.node_id != self.membership.self_id and p.stepping]

    def _barrier(self, deadline: float) -> bool:
        if self.membership is None:
            return True
        self.membership.send_step({"e": self.epoch, "s": self._step})
        with self._arrive_cv:
            while True:
                want = self._barrier_peers()
                done = all(
                    self._peer_steps.get(pid, (-1, -1)) >=
                    (self.epoch, self._step)
                    for pid in want)
                if done:
                    return True
                left = deadline - time.monotonic()
                if left <= 0 or self._stopped:
                    return False
                self._arrive_cv.wait(min(left, 0.05))
                # re-broadcast while waiting: a single lost arrive
                # datagram must cost one wait tick, not degrade the
                # fleet (UDP gives no delivery promise)
                self.membership.send_step({"e": self.epoch,
                                           "s": self._step})

    # ------------------------------------------------------------ dispatch

    def _device_dispatch(self, items: list):
        """items: padded (hint, ip, port, cb, want_pick) rows. With a
        maglev plane the step rides the FusedPair's one-launch
        (verdict, pick) program; without it, the hint-only dispatch."""
        from ..utils.torchenv import to_host
        if failpoint.hit("cluster.step.stall"):
            # a wedged collective: the step deadline must fire and
            # degrade this host, never hang the fleet
            time.sleep(self.timeout_ms * 3 / 1000.0)
        if self._pair is not None:
            snap = self._pair.snapshot()
            out = to_host(self._pair.dispatch_snap(
                snap, [(h, ip, po) for h, ip, po, _, _, _ in items]))
            return (out[: len(items)], self._pair.snap_payload(snap))
        snap = self.matcher.snapshot()
        hints = [h for h, _, _, _, _, _ in items]
        return (to_host(self.matcher.dispatch_snap(snap, hints)),
                self.matcher.snap_payload(snap))

    def _dispatch_worker(self) -> None:
        while True:
            with self._disp_cv:
                while self._disp_req is None:
                    if self._stopped:
                        return
                    self._disp_cv.wait(1.0)
                token, hints = self._disp_req
                self._disp_req = None
            try:
                res: tuple = (token, "ok") + self._device_dispatch(hints)
            except MemoryError:
                raise
            except Exception as e:
                ke = self._card_fault(e)
                res = (token, "err", e) if ke is None \
                    else (token, "kernel", ke)
            with self._disp_cv:
                if token != self._disp_token:
                    return  # abandoned by a rejoin: discard and retire
                self._disp_res = res
                self._disp_busy = False
                self._disp_cv.notify_all()

    _EPOCH_ABORT = object()  # rejoin invalidated this dispatch mid-flight

    def _timed_dispatch(self, hints: list, deadline: float):
        """Run the device dispatch on the worker with the step deadline;
        None on timeout/error (the stall edge), _EPOCH_ABORT when a
        rejoin invalidated the token mid-flight — the step was
        interrupted by an epoch switch, NOT stalled, and must not
        degrade the host."""
        with self._disp_cv:
            # a worker still finishing a PREVIOUS dispatch gets the
            # deadline to wrap up; its stale result is discarded below
            while self._disp_busy:
                left = deadline - time.monotonic()
                if left <= 0 or self._stopped:
                    return None
                self._disp_cv.wait(min(left, 0.05))
            self._disp_busy = True
            self._disp_res = None  # drop any stale completion
            self._disp_token += 1
            token = self._disp_token
            self._disp_req = (token, hints)
            if self._disp_thread is None or not self._disp_thread.is_alive():
                self._disp_thread = threading.Thread(
                    target=self._dispatch_worker, name="cluster-step-disp",
                    daemon=True)
                self._disp_thread.start()
            self._disp_cv.notify_all()
            while self._disp_res is None:
                if self._disp_token != token:
                    return self._EPOCH_ABORT
                left = deadline - time.monotonic()
                if left <= 0 or self._stopped:
                    return None
                self._disp_cv.wait(min(left, 0.05))
            res, self._disp_res = self._disp_res, None
        if res[1] == "kernel":
            raise res[2]
        if res[1] != "ok":
            _log.alert(f"step dispatch failed: {res[2]!r}")
            return None
        return res[2], res[3]

    def _card_fault(self, e: Exception) -> Optional[Exception]:
        """-> the KernelError that a dispatch fault `e` is, or None for
        the stall edge: a failed collective (a peer rank went away), or
        any fault of a matcher on the CPU."""
        if _is_kernel_error(e):
            return e
        import torch.distributed as dist
        if isinstance(e, dist.DistError):
            return None
        from ..rules.service import _card_error
        return _card_error(self.matcher, e)

    # ----------------------------------------------------------- main loop

    def _run(self) -> None:
        next_step = time.monotonic()
        cut: list = []  # the batch of a step that stop() cut short
        while not self._stopped:
            now = time.monotonic()
            if now < next_step:
                time.sleep(min(next_step - now, 0.01))
                continue
            next_step = now + self.step_ms / 1000.0
            batch: list = []
            with self._qlock:
                while self._q and len(batch) < self.batch_cap:
                    batch.append(self._q.popleft())
            self.steps_total += 1
            if self.degraded:
                self._serve_host(batch)
                continue
            deadline = time.monotonic() + self.timeout_ms / 1000.0
            out = None
            # sampled queries in this step: step-phase spans attach to
            # the first one (barrier/collective are step-shared phases)
            tids = [it[5] for it in batch if it[5]]
            t_bar = time.monotonic() if tids else 0.0
            barrier_ok = self._barrier(deadline)
            if tids:
                trace.record_span(
                    tids[0], "cluster", "barrier", int(t_bar * 1e9),
                    int((time.monotonic() - t_bar) * 1e9),
                    epoch=self.epoch, step=self._step, ok=barrier_ok)
            if barrier_ok:
                padded = list(batch) + \
                    [self._PAD_ITEM()] * (self.batch_cap - len(batch))
                t_col = time.monotonic() if tids else 0.0
                try:
                    out = self._timed_dispatch(padded, deadline)
                except Exception as e:
                    if not _is_kernel_error(e):
                        raise
                    self._kernel_failed(e, batch)
                    return
                if tids and out is not None \
                        and out is not self._EPOCH_ABORT:
                    trace.record_span(
                        tids[0], "cluster", "collective",
                        int(t_col * 1e9),
                        int((time.monotonic() - t_col) * 1e9),
                        batch=len(batch), fused=self._pair is not None)
            if self._stopped and (out is None or out is self._EPOCH_ABORT):
                cut = batch  # stop() cut the barrier or the dispatch wait
                break
            if out is self._EPOCH_ABORT:
                # a rejoin landed mid-step (new generation): not a
                # stall — answer this batch locally and step on in the
                # new epoch
                self._serve_host(batch)
                continue
            if out is None:
                self._stall(batch)
                continue
            idxs, payload = out
            self._deliver(batch, idxs, payload)
            self._step += 1
        if self.error is None:
            # stopped: the step stop() cut and the queue are answered
            # from the host index, never stranded
            with self._qlock:
                held = cut + list(self._q)
                self._q.clear()
            self._serve_host(held)

    def _stall(self, batch: list) -> None:
        """Barrier timeout / dead collective: degrade to the inline
        host-index path (the device->oracle failover edge, one level
        up). Queued queries are served immediately — nothing fails."""
        self.barrier_stalls += 1
        self.degraded = True
        now = time.monotonic_ns()
        for it in batch:
            if it[5]:  # the degrade edge lands on EVERY sampled trace
                trace.record_span(it[5], "cluster", "barrier_stall", now,
                                  0, epoch=self.epoch, step=self._step,
                                  timeout_ms=self.timeout_ms)
        events.record("cluster_degrade",
                      f"step barrier stalled past {self.timeout_ms}ms at "
                      f"epoch {self.epoch} step {self._step}; degraded to "
                      "host-index serving",
                      epoch=self.epoch, step=self._step,
                      timeout_ms=self.timeout_ms)
        _log.alert(f"step barrier stalled ({self.timeout_ms}ms); serving "
                   "from the host index until the next generation")
        if self.on_degrade is not None:
            try:
                self.on_degrade()
            except Exception:
                _log.error("on_degrade callback failed", exc=True)
        self._serve_host(batch)

    def _kernel_failed(self, e: Exception, batch: list) -> None:
        """The card cannot serve (see the module doc): close the loop,
        answer `batch` and the queue with -1, make every later submit
        raise `e`, and stop stepping."""
        with self._qlock:
            self.error = e
            self._stopped = True
            held = list(batch) + list(self._q)
            self._q.clear()
        with self._disp_cv:
            self._disp_cv.notify_all()
        with self._arrive_cv:
            self._arrive_cv.notify_all()
        events.record("cluster_kernel_error",
                      f"CUDA kernel failed: {e!r}; step loop closed",
                      epoch=self.epoch, step=self._step, batch=len(batch))
        _log.alert(f"CUDA kernel failed ({e!r}); step loop closed, "
                   "submits raise")
        if self.on_degrade is not None:  # stepping=false reaches peers
            try:
                self.on_degrade()
            except Exception:
                _log.error("on_degrade callback failed", exc=True)
        m = self.matcher
        hp = m.snap_payload(m.snapshot())
        mp = (None if self.maglev is None
              else self.maglev.snap_payload(self.maglev.snapshot()))
        for _, _, _, cb, want, _ in held:
            try:
                if want:
                    cb(-1, -1, (hp, mp))
                else:
                    cb(-1, hp)
            except MemoryError:
                raise
            except Exception:
                _log.error("step classify callback failed", exc=True)

    def _serve_host(self, batch: list) -> None:
        """Degraded / epoch-abort serving: the inline host planes —
        O(probes) hint index plus the O(1) host maglev table for pick
        queries (same winners as the fused program, rules/index.py +
        the shared FNV contract). Nothing fails."""
        if not batch:
            return
        m = self.matcher
        snap = m.snapshot()
        hp = m.snap_payload(snap)
        msnap = None if self.maglev is None else self.maglev.snapshot()
        for hint, ip, port, cb, want, tid in batch:
            v, pick = -1, -1
            t0 = time.monotonic_ns() if tid else 0
            try:  # a broken row delivers -1, never strands its caller
                v = int(m.index_snap(snap, hint))
                if want:
                    pick = int(self.maglev.pick_snap(msnap, ip, port))
            except MemoryError:
                raise
            except Exception:
                _log.error("step host classify failed; delivering "
                           "no-match", exc=True)
            if tid:
                trace.record_span(tid, "cluster", "host_index", t0,
                                  time.monotonic_ns() - t0,
                                  degraded=self.degraded)
            try:
                if want:
                    cb(v, pick, (hp, self.maglev.snap_payload(msnap)))
                else:
                    cb(v, hp)
            except MemoryError:
                raise
            except Exception:
                _log.error("step classify callback failed", exc=True)

    def _deliver(self, batch: list, idxs, payload) -> None:
        # with the maglev plane, payload is the FusedPair's
        # (hint_payload, maglev_payload) and a row is (verdict, pick);
        # plain submits keep the hint-only cb(idx, hint_payload) shape
        paired = self._pair is not None
        hp = payload[0] if paired else payload
        for (_, _, _, cb, want, _), idx in zip(batch, idxs):
            row = np.atleast_1d(np.asarray(idx))
            try:
                if want:
                    pick = int(row[1]) if row.size > 1 else -1
                    cb(int(row[0]), pick, payload)
                else:
                    cb(int(row[0]), hp)
            except MemoryError:
                raise
            except Exception:
                _log.error("step classify callback failed", exc=True)


def _is_kernel_error(e: Exception) -> bool:
    from ..ops.fused_cuda import KernelError
    return isinstance(e, KernelError)
