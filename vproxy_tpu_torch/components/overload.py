"""Adaptive overload control — degrade-rather-than-fail under flash
crowds (docs/robustness.md).

The first overload guard is a static `max_sessions` ceiling: correct for
a known capacity, wrong for the real failure mode, where the proxy's
capacity MOVES (classify load on the same cores, a slow disk, a noisy
neighbor) and a flash crowd overwhelms the event loops long before any
fixed session count is reached. Ananta and Envoy both survive overload
the same way: observe the symptoms, shed early, keep the sessions you
do admit fast.

`VPROXY_TPU_OVERLOAD=adaptive` (or `overload adaptive` on
add/update tcp-lb) attaches this controller to a TcpLB. It runs AIMD
over an *effective* session ceiling between a floor and max_sessions:

* **signals** — (1) event-loop stall rate: each loop accumulates
  `stall_total_s` (callback time beyond 1ms + timer slip, the loops'
  health machinery); the controller diffs it per tick into
  milliseconds-stalled-per-second and takes the worst loop. (2)
  accept-path latency: TcpLB feeds every completed accept→handover
  span in; the per-tick mean (0 when idle — no stale-high memory).
  Both are EWMA-smoothed (`VPROXY_TPU_OVERLOAD_ALPHA`).
* **law** — hot (either EWMA above its threshold): multiplicative
  decrease, `ceiling = max(floor, 0.75 × min(ceiling, active))` —
  anchored at the live session count so shedding starts immediately
  instead of waiting for the old ceiling to drain down. Calm (both
  EWMAs under half their thresholds): additive-ish increase of 1/8 per
  tick back toward max_sessions. In between: hold (hysteresis).
* **shed mechanics** — over-ceiling accepts are closed with an RST
  (SO_LINGER {1,0}; `net/vtl.py close_rst`) instead of a FIN: a crowd
  big enough to trip the controller would otherwise park one TIME_WAIT
  per shed and exhaust the table. Counted
  `vproxy_lb_shed_total{lb,reason=adaptive}`.
* **both planes** — the live bound is forwarded to the C accept lanes
  (`vtl_lanes_set_limit`, as `ceiling − python-held sessions`) and the
  lanes flip into C-side RST shed (`vtl_lanes_set_shed`): over-limit
  lane accepts never cross into Python. The controller folds the C
  shed counter into the same metric.

The controller runs on its OWN daemon thread, never on an event loop:
a controller scheduled on the loop it is supposed to police could not
observe that loop stalling.

Knobs: VPROXY_TPU_OVERLOAD (static|adaptive), VPROXY_TPU_OVERLOAD_FLOOR
(64), VPROXY_TPU_OVERLOAD_TICK_MS (100), VPROXY_TPU_OVERLOAD_STALL_MS
(50 — ms of loop stall per second of wall time), and
VPROXY_TPU_OVERLOAD_ACCEPT_MS (50 — mean accept→handover span).

The port's copy of vproxy_tpu/components/overload.py, same names and behaviour.
"""
from __future__ import annotations

import os
import threading
import time

from ..utils.log import Logger

_log = Logger("overload")

MODE = os.environ.get("VPROXY_TPU_OVERLOAD", "static")
FLOOR = int(os.environ.get("VPROXY_TPU_OVERLOAD_FLOOR", "64"))
TICK_MS = int(os.environ.get("VPROXY_TPU_OVERLOAD_TICK_MS", "100"))
STALL_HI_MS = float(os.environ.get("VPROXY_TPU_OVERLOAD_STALL_MS", "50"))
ACCEPT_HI_MS = float(os.environ.get("VPROXY_TPU_OVERLOAD_ACCEPT_MS", "50"))
ALPHA = float(os.environ.get("VPROXY_TPU_OVERLOAD_ALPHA", "0.3"))


class AdaptiveOverload:
    """One per adaptive-mode TcpLB; owns the ceiling and the ticker."""

    def __init__(self, lb, floor: int = 0, tick_ms: int = 0,
                 stall_hi_ms: float = 0.0, accept_hi_ms: float = 0.0,
                 alpha: float = 0.0):
        self.lb = lb
        self.floor = floor or FLOOR
        self.tick_ms = tick_ms or TICK_MS
        self.stall_hi_ms = stall_hi_ms or STALL_HI_MS
        self.accept_hi_ms = accept_hi_ms or ACCEPT_HI_MS
        self.alpha = alpha or ALPHA
        # start wide open AT the configured max — never above it: a
        # floor beyond a small max_sessions must not admit 2x the
        # operator's ceiling until the first tick's clamp runs
        self.ceiling = lb.max_sessions
        self.stall_ewma_ms = 0.0
        self.accept_ewma_ms = 0.0
        self.lane_ewma_ms = 0.0  # last tick's C-plane accept EWMA
        self.ticks = 0
        self._calm_streak = 0  # raises need SUSTAINED calm (see tick)
        self._acc_lock = threading.Lock()
        self._acc_sum = 0.0
        self._acc_n = 0
        self._prev_stall: dict[int, float] = {}  # id(loop) -> last total
        # baseline at the CURRENT cumulative C counter: a mode hot-flip
        # (static -> adaptive) builds a fresh controller against lanes
        # whose shed history is already in the metric — starting at 0
        # would re-fold it all on the first tick
        lanes = getattr(lb, "lanes", None)
        self._lane_shed_seen = lanes.shed_count() if lanes is not None else 0
        self._last_tick = time.monotonic()
        self._stop = threading.Event()
        self._thread = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"overload-{self.lb.alias}", daemon=True)
        self._thread.start()
        lanes = self.lb.lanes
        if lanes is not None:
            lanes.set_shed(True)

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(2)
        lanes = self.lb.lanes
        if lanes is not None:
            lanes.set_shed(False)

    def _run(self) -> None:
        errors = 0
        while not self._stop.wait(self.tick_ms / 1000.0):
            try:
                self.tick_once()
                errors = 0
            except Exception:
                # the controller must outlive any one bad sample — but a
                # SYSTEMATIC failure (every tick raising) would freeze
                # the ceiling wherever it last was, invisibly; log the
                # first of a streak (and every 600th: ~1/min at the
                # default tick) instead of swallowing forever
                errors += 1
                if errors == 1 or errors % 600 == 0:
                    _log.error(
                        f"overload-{self.lb.alias}: controller tick "
                        f"failed ({errors} consecutive; ceiling frozen "
                        f"at {self.ceiling})", exc=True)

    # ------------------------------------------------------------ signals

    def observe_accept(self, seconds: float) -> None:
        """One completed accept→handover span (TcpLB feeds this from the
        same sites as the `total` stage histogram)."""
        with self._acc_lock:
            self._acc_sum += seconds
            self._acc_n += 1

    def _loops(self) -> list:
        seen: set = set()
        out = []
        for grp in (self.lb.acceptor, self.lb.worker):
            for lp in list(grp.loops):
                if id(lp) not in seen:
                    seen.add(id(lp))
                    out.append(lp)
        return out

    # ------------------------------------------------------------ the law

    def tick_once(self, now: float = None) -> int:  # type: ignore[assignment]
        """One controller step; returns the (possibly moved) ceiling.
        Exposed for deterministic tests — feed observe_accept / loop
        stall state, then call this directly."""
        lb = self.lb
        if now is None:
            now = time.monotonic()
        dt = max(1e-3, now - self._last_tick)
        self._last_tick = now
        self.ticks += 1
        # worst loop's stalled-ms per second of wall time this tick
        worst = 0.0
        cur: dict[int, float] = {}
        for lp in self._loops():
            tot = getattr(lp, "stall_total_s", 0.0)
            prev = self._prev_stall.get(id(lp), tot)
            cur[id(lp)] = tot
            if tot > prev:
                worst = max(worst, (tot - prev) / dt)
        self._prev_stall = cur  # dead loops forgotten
        stall_ms = worst * 1000.0
        with self._acc_lock:
            s, n = self._acc_sum, self._acc_n
            self._acc_sum, self._acc_n = 0.0, 0
        acc_ms = (s / n * 1000.0) if n else 0.0
        # lane-aware signal: the C accept plane serves whole
        # sessions without ever calling observe_accept, so a lanes-heavy
        # LB used to look idle to this controller exactly when it was
        # busiest. The lanes export their own accept->backend-connected
        # EWMA (lanes_stat field 12); take the worse of the two planes
        # as this tick's sample — one law, both admission paths.
        lanes = getattr(lb, "lanes", None)
        self.lane_ewma_ms = (lanes.accept_latency_ms()
                             if lanes is not None else 0.0)
        acc_ms = max(acc_ms, self.lane_ewma_ms)
        a = self.alpha
        self.stall_ewma_ms += a * (stall_ms - self.stall_ewma_ms)
        self.accept_ewma_ms += a * (acc_ms - self.accept_ewma_ms)
        hot = (self.stall_ewma_ms > self.stall_hi_ms
               or self.accept_ewma_ms > self.accept_hi_ms)
        calm = (self.stall_ewma_ms < self.stall_hi_ms / 2
                and self.accept_ewma_ms < self.accept_hi_ms / 2)
        if hot:
            self._calm_streak = 0
            active = lb.active_sessions + lb.lane_active()
            base = min(self.ceiling, max(active, self.floor))
            self.ceiling = max(self.floor, int(base * 0.75))
        elif calm:
            # raises wait for SUSTAINED calm: a single quiet tick inside
            # a storm would over-admit a batch whose sessions become the
            # p99 tail — the sawtooth's top is where SLOs go to die
            self._calm_streak += 1
            if (self._calm_streak >= 3
                    and self.ceiling < lb.max_sessions):
                self.ceiling = min(lb.max_sessions,
                                   self.ceiling + max(1, self.ceiling >> 3))
        else:
            self._calm_streak = 0
        self.ceiling = min(self.ceiling, lb.max_sessions)  # hot-set clamp
        lb._push_lane_limit()
        self._fold_lane_sheds()
        return self.ceiling

    def _fold_lane_sheds(self) -> None:
        lanes = self.lb.lanes
        if lanes is None:
            return
        shed = lanes.shed_count()
        if shed > self._lane_shed_seen:
            d = shed - self._lane_shed_seen
            # BOTH counters, like every python-side shed path: the
            # legacy vproxy_lb_overload_total is the one older
            # dashboards alert on — C-plane sheds must not be invisible
            # to it
            self.lb._shed_total("adaptive").incr(d)
            self.lb._overload_total().incr(d)
            self._lane_shed_seen = shed

    # ------------------------------------------------------------ surfaces

    def stat(self) -> dict:
        return {"mode": "adaptive", "maxSessions": self.lb.max_sessions,
                "ceiling": self.ceiling, "floor": self.floor,
                "stallEwmaMs": round(self.stall_ewma_ms, 2),
                "acceptEwmaMs": round(self.accept_ewma_ms, 2),
                "laneAcceptEwmaMs": round(self.lane_ewma_ms, 2),
                "ticks": self.ticks}
