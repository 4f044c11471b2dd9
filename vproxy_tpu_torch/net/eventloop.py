"""SelectorEventLoop — the per-core scheduler.

Functional equivalent of the reference's selector/SelectorEventLoop.java
(poll loop :265-322, timer queue :159-168, cross-thread task queue
:370-389, wakeups, loop-thread confinement): a single thread polls the
native epoll loop; all state mutation happens on that thread; other
threads submit closures via run_on_loop() + eventfd wakeup (or a list of
them, one wakeup, via run_batch_on_loop()). Timers are a
heapq; the poll timeout is the nearest deadline (same single-clock
design — one coarse timestamp per tick).

The native splice pump (net/vtl.py pump_*) is the handleDirect fast
path: once a session enters TCP-splice mode both fds are handed to C++
and Python only sees the PUMP_DONE lifecycle event.

The port's copy of vproxy_tpu/net/eventloop.py, same names and behaviour,
plus run_batch_on_loop() (ClassifyService hands a batch's answers to each
loop at once).
"""
from __future__ import annotations

import ctypes
import heapq
import itertools
import os
import threading
import time
import traceback
from collections import deque
from typing import Callable, Optional

from . import vtl

MAX_EVENTS = 256

# a single callback holding the loop thread past this is a stall: the
# known GIL-contention p999 culprit — recorded to the flight recorder
# (utils/events) and surfaced via vproxy_loop_callback_us_max
STALL_MS = float(os.environ.get("VPROXY_TPU_LOOP_STALL_MS", "100"))


def _guard(fn, *args) -> None:
    """Run a callback; a failing handler must never kill the loop thread
    (the reference logs and survives — Logger error paths in
    SelectorEventLoop.doHandling). MemoryError is NOT survivable: unlike
    Java's OutOfMemoryError (an Error, invisible to catch(Exception)),
    it IS an Exception here and must reach the OOM handler's
    log-then-die contract (utils/oom.py), not a limping heap."""
    try:
        fn(*args)
    except MemoryError:
        raise
    except Exception:
        traceback.print_exc()


class TimerEvent:
    __slots__ = ("deadline", "fn", "cancelled", "seq")

    def __init__(self, deadline: float, fn: Callable[[], None], seq: int):
        self.deadline = deadline
        self.fn = fn
        self.cancelled = False
        self.seq = seq

    def cancel(self) -> None:
        self.cancelled = True

    def __lt__(self, other: "TimerEvent") -> bool:
        return (self.deadline, self.seq) < (other.deadline, other.seq)


class PeriodicEvent:
    __slots__ = ("loop", "interval_ms", "fn", "_timer", "_stopped")

    def __init__(self, loop: "SelectorEventLoop", interval_ms: int, fn):
        self.loop = loop
        self.interval_ms = interval_ms
        self.fn = fn
        self._stopped = False
        self._schedule()

    def _schedule(self) -> None:
        if self._stopped:
            return
        self._timer = self.loop.delay(self.interval_ms, self._fire)

    def _fire(self) -> None:
        if self._stopped:
            return
        try:
            self.fn()
        finally:
            self._schedule()

    def cancel(self) -> None:
        self._stopped = True
        t = getattr(self, "_timer", None)
        if t is not None:
            t.cancel()


class SelectorEventLoop:
    def __init__(self, name: str = "loop"):
        self.name = name
        self._lp = vtl.LIB.vtl_new()
        self._handlers: dict[int, tuple[int, Callable]] = {}  # tag -> (fd, cb)
        self._fd_tags: dict[int, int] = {}  # fd -> tag
        self._pump_cbs: dict[int, Callable] = {}  # pump id -> on_done
        # fast-lane pumps (5-arg DONE contract) -> their connect-deadline
        # timer (None when timeout_ms=0), cancelled on DONE
        self._pumpc: dict[int, object] = {}
        self._timers: list[TimerEvent] = []
        self._tick_q: deque = deque()
        self._xq: deque = deque()  # cross-thread queue
        self._xq_lock = threading.Lock()
        self._seq = itertools.count()
        self._taggen = itertools.count(1)
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        # fired (once, on the dying thread) when the loop stops running —
        # graceful close OR crash. EventLoopGroup re-homes resources here
        # (reference LBAttach / DNSServer.java:89-106 semantics).
        self.on_death: list = []
        self.now = time.monotonic()
        self._tags_buf = (ctypes.c_uint64 * MAX_EVENTS)()
        self._evs_buf = (ctypes.c_uint32 * MAX_EVENTS)()
        # loop-health windows (seconds), reset when /metrics scrapes them
        # through take_health(): worst timer slip (fire time past the
        # deadline) and longest single callback since the last read
        self._health = {"slip": 0.0, "cb": 0.0}
        self._stall_s = STALL_MS / 1000.0
        # cumulative stall evidence (seconds): callback time beyond the
        # 1ms scheduling floor plus timer slip past 5ms. Monotonic so
        # the adaptive overload guard (components/overload.py) can diff
        # it per tick into a stalls-per-second rate WITHOUT racing the
        # /metrics take_health() read-and-reset windows.
        self.stall_total_s = 0.0

    def take_health(self, key: str) -> float:
        """Read-and-reset one health window (racy by design: a lost
        concurrent max only shortens one scrape interval's evidence)."""
        v = self._health[key]
        self._health[key] = 0.0
        return v

    def _timed(self, fn, *args) -> None:
        """_guard plus callback-duration accounting + stall events."""
        t0 = time.monotonic()
        try:
            _guard(fn, *args)
        finally:
            dt = time.monotonic() - t0
            if dt > 0.001:
                self.stall_total_s += dt - 0.001
            if dt > self._health["cb"]:
                self._health["cb"] = dt
            if dt > self._stall_s:
                from ..utils import events
                events.record(
                    "loop_stall",
                    f"loop {self.name}: callback held the thread "
                    f"{dt * 1e3:.1f}ms",
                    loop=self.name, ms=round(dt * 1e3, 1),
                    fn=getattr(fn, "__qualname__", repr(fn)))

    # ------------------------------------------------------------ registry

    def _alive(self) -> bool:
        return not self._closed and self._lp is not None

    def add(self, fd: int, events: int, cb: Callable[[int, int], None]) -> None:
        """cb(fd, events) fires on readiness. Loop thread only."""
        if not self._alive():
            raise OSError("event loop is closed")
        tag = next(self._taggen)
        vtl.check(vtl.LIB.vtl_add(self._lp, fd, events, tag))
        self._handlers[tag] = (fd, cb)
        self._fd_tags[fd] = tag

    def modify(self, fd: int, events: int) -> None:
        if not self._alive():
            return
        tag = self._fd_tags[fd]
        vtl.check(vtl.LIB.vtl_mod(self._lp, fd, events, tag))

    def remove(self, fd: int) -> None:
        tag = self._fd_tags.pop(fd, None)
        if tag is None or not self._alive():
            return
        vtl.LIB.vtl_del(self._lp, fd)
        self._handlers.pop(tag, None)

    def registered(self, fd: int) -> bool:
        return fd in self._fd_tags

    # ------------------------------------------------------------ pumps

    def pump(self, fd_a: int, fd_b: int, bufsize: int = 65536,
             on_done: Optional[Callable[[int, int, int], None]] = None) -> int:
        """Hand both fds to the native splice engine. The loop owns the fds
        from here; on_done(bytes_a2b, bytes_b2a, err) fires when the session
        dies. Any python registration for these fds must be removed first."""
        if not self._alive():
            raise OSError("event loop is closed")
        pid = vtl.LIB.vtl_pump_new(self._lp, fd_a, fd_b, bufsize)
        if pid == 0:
            raise OSError("pump: fds busy")
        self._pump_cbs[pid] = on_done
        return pid

    def pump_tls(self, fd_tls: int, fd_plain: int, ctx: int,
                 bufsize: int = 65536,
                 on_done: Optional[Callable[[int, int, int], None]] = None
                 ) -> int:
        """TLS-terminating splice: fd_tls speaks TLS (server role, C-side
        handshake + record layer), fd_plain is plaintext. Same ownership
        and DONE contract as pump()."""
        if not self._alive():
            raise OSError("event loop is closed")
        pid = vtl.LIB.vtl_tls_pump_new(self._lp, fd_tls, fd_plain, bufsize,
                                       ctx)
        if pid == 0:
            raise OSError("tls pump: fds busy or tls unavailable")
        self._pump_cbs[pid] = on_done
        return pid

    def pump_connect(self, fd_a: int, ip: str, port: int,
                     bufsize: int = 65536,
                     on_done: Optional[Callable] = None,
                     timeout_ms: int = 0,
                     on_connected: Optional[Callable[[], None]] = None
                     ) -> int:
        """Accept fast lane: backend socket + TCP_NODELAY + nonblocking
        connect + splice registration in ONE native call; the pump idles
        until the connect resolves. on_done(a2b, b2a, err, flags,
        connect_us) — flags bit0: the backend never came up and fd_a is
        STILL OPEN (the caller retries or closes); flags bit1: the pump
        was torn down while STILL mid-connect (client died first —
        neither a backend success nor a backend failure); connect_us is
        the resolved backend-connect duration.
        Returns 0 when the provider lacks the fast lane (pure-python) or
        registration failed — callers fall back to Connection.connect.
        timeout_ms > 0 bounds the connect phase (ETIMEDOUT DONE); at
        that same deadline, a session that DID connect and is still
        running gets on_connected() — the bounded-delay substitute for
        the classic path's on_connected edge (ejection-streak reset for
        long-lived sessions; short sessions report via on_done)."""
        fn = getattr(vtl.LIB, "vtl_pump_connect", None)
        if fn is None or not self._alive():
            return 0
        pid = fn(self._lp, fd_a, ip.encode(), port,
                 1 if ":" in ip else 0, bufsize)
        if pid == 0:
            return 0
        self._pump_cbs[pid] = on_done
        self._pumpc[pid] = None
        if timeout_ms > 0:
            def expire(pid=pid):
                if not self._alive() or pid not in self._pumpc:
                    return  # DONE already delivered (timer raced it)
                # ONE authoritative check at the deadline: abort first
                # (a pump STILL mid-connect becomes the same
                # connect_failed DONE a refusal takes, fd_a preserved),
                # then consult the pump's own flags — never the DONE
                # queue, which can lag within the same timer batch —
                # before declaring the connect a success.
                if vtl.LIB.vtl_pump_abort_connect(self._lp, pid):
                    return  # timed out: the DONE carries the failure
                if on_connected is None:
                    return
                try:
                    _, _, _, flags, _ = self._pump_stat2(pid)
                except OSError:
                    return  # already freed: on_done handled the outcome
                if not (flags & 0b11):  # connected, not failed
                    on_connected()
            self._pumpc[pid] = self.delay(timeout_ms, expire)
        return pid

    def pump_close(self, pump_id: int) -> None:
        vtl.LIB.vtl_pump_close(self._lp, pump_id)

    def pump_stat(self, pump_id: int):
        out = (ctypes.c_uint64 * 3)()
        vtl.check(vtl.LIB.vtl_pump_stat(self._lp, pump_id, out))
        return int(out[0]), int(out[1]), int(out[2])

    def _pump_stat2(self, pump_id: int):
        """(a2b, b2a, err, flags, connect_us); flags bit0=connect_failed,
        bit1=still-connecting (fast-lane pumps only, 0 otherwise)."""
        fn = getattr(vtl.LIB, "vtl_pump_stat2", None)
        if fn is None:
            a2b, b2a, err = self.pump_stat(pump_id)
            return a2b, b2a, err, 0, 0
        out = (ctypes.c_uint64 * 5)()
        vtl.check(fn(self._lp, pump_id, out))
        return (int(out[0]), int(out[1]), int(out[2]), int(out[3]),
                int(out[4]))

    # ------------------------------------------------------------ timers

    def next_tick(self, fn: Callable[[], None]) -> None:
        self._tick_q.append(fn)

    def run_on_loop(self, fn: Callable[[], None]) -> bool:
        """Thread-safe submit + wakeup. Returns False when the loop is
        gone and the task was dropped (callers owning resources must then
        clean up themselves — e.g. ClassifyService delivery). True means
        the task WILL run: enqueue and the closed-flag flip share one
        lock, and close() drains tasks that raced the shutdown."""
        return self.run_batch_on_loop((fn,))

    def run_batch_on_loop(self, fns) -> bool:
        """run_on_loop for a sequence of tasks, in order, under its
        contract (False: nothing was queued): one lock and one wakeup
        for them all. Each task still runs alone through _timed, so
        callback health and stall accounting read as for single
        submits."""
        if threading.current_thread() is self._thread:
            if not self._alive():
                return False
            self._tick_q.extend(fns)
            return True
        with self._xq_lock:
            if not self._alive():
                return False
            self._xq.extend(fns)
        if self._lp is not None:
            vtl.LIB.vtl_wakeup(self._lp)
        return True

    def call_sync(self, fn: Callable[[], object], timeout: float = 5.0):
        """Run fn on the loop thread, block until it finishes, return its
        result or re-raise its exception (the cross-thread start/bind
        pattern: components must not touch loop state off-thread)."""
        if threading.current_thread() is self._thread:
            return fn()
        ev = threading.Event()
        box: list = [None, None]

        def run() -> None:
            try:
                box[0] = fn()
            except BaseException as e:
                box[1] = e
            finally:
                ev.set()

        self.run_on_loop(run)
        if not ev.wait(timeout):
            raise OSError(f"loop {self.name}: call_sync timed out after {timeout}s")
        if box[1] is not None:
            raise box[1]
        return box[0]

    def delay(self, ms: int, fn: Callable[[], None]) -> TimerEvent:
        t = TimerEvent(time.monotonic() + ms / 1000.0, fn, next(self._seq))
        heapq.heappush(self._timers, t)
        return t

    def period(self, ms: int, fn: Callable[[], None]) -> PeriodicEvent:
        return PeriodicEvent(self, ms, fn)

    # ------------------------------------------------------------ loop

    def _run_queues(self) -> None:
        if self._xq:
            with self._xq_lock:
                items, self._xq = self._xq, deque()
            for fn in items:
                self._timed(fn)
        while self._tick_q:
            self._timed(self._tick_q.popleft())

    def _run_timers(self) -> None:
        now = time.monotonic()
        self.now = now
        worst_slip = 0.0  # per-pass: a burst of equally-late timers is
        while self._timers and self._timers[0].deadline <= now:  # ONE stall
            t = heapq.heappop(self._timers)
            if not t.cancelled:
                slip = now - t.deadline
                if slip > worst_slip:
                    worst_slip = slip
                if slip > self._health["slip"]:
                    self._health["slip"] = slip
                self._timed(t.fn)
        if worst_slip > 0.005:
            self.stall_total_s += worst_slip - 0.005

    def _next_timeout_ms(self) -> int:
        while self._timers and self._timers[0].cancelled:
            heapq.heappop(self._timers)
        if self._tick_q or self._xq:
            return 0
        if not self._timers:
            return 1000
        ms = int((self._timers[0].deadline - time.monotonic()) * 1000)
        return max(ms, 0)

    def one_poll(self) -> None:
        self._run_queues()
        self._run_timers()
        n = vtl.LIB.vtl_poll(self._lp, self._tags_buf, self._evs_buf,
                             MAX_EVENTS, self._next_timeout_ms())
        if n < 0:
            raise OSError(-n, "vtl_poll")
        self.now = time.monotonic()
        for i in range(n):
            tag, ev = self._tags_buf[i], self._evs_buf[i]
            if ev & vtl.EV_PUMP_DONE:
                cb = self._pump_cbs.pop(tag, None)
                if tag in self._pumpc:  # fast-lane pump: 5-arg DONE
                    t = self._pumpc.pop(tag)
                    if t is not None:  # connect-deadline timer: dead
                        t.cancel()     # weight off the timer heap
                    a2b, b2a, err, flags, cus = self._pump_stat2(tag)
                    vtl.LIB.vtl_pump_free(self._lp, tag)
                    if cb is not None:
                        self._timed(cb, a2b, b2a, err, flags, cus)
                    continue
                a2b, b2a, err = self.pump_stat(tag)
                vtl.LIB.vtl_pump_free(self._lp, tag)
                if cb is not None:
                    self._timed(cb, a2b, b2a, err)
                continue
            ent = self._handlers.get(tag)
            if ent is not None:
                fd, cb = ent
                self._timed(cb, fd, ev)
        self._run_queues()
        self._run_timers()

    def loop(self) -> None:
        self._thread = threading.current_thread()
        from ..utils.metrics import GlobalInspection
        gi = GlobalInspection.get()
        gi.register_loop(self)
        if self._closed:  # close() raced the thread start: undo
            gi.deregister_loop(self)
            return
        try:
            while not self._closed:
                self.one_poll()
        except Exception as e:
            # the loop machinery itself died (callbacks are guarded* —
            # this is a poll/queue bug or fd catastrophe). Mark closed so
            # writers stop, release fds + the native loop (close() would
            # early-return on the _closed flag), then notify. Death
            # callbacks fire strictly AFTER fd cleanup so re-homing can
            # re-bind the same addresses; the graceful path fires them
            # from close() with the same ordering.
            # (*) MemoryError is the exception: _guard re-raises it, and
            # after the SAME cleanup (run_on_loop's "True means it WILL
            # run" promise must not outlive the thread) it propagates to
            # threading.excepthook — oom._die when installed (exit 137).
            import sys
            import traceback
            print(f"event loop {self.name} CRASHED:", file=sys.stderr)
            traceback.print_exc()
            with self._xq_lock:
                self._closed = True
            gi.deregister_loop(self)
            self._cleanup_native()
            self._fire_death()
            if isinstance(e, MemoryError):
                raise

    def loop_thread(self) -> threading.Thread:
        th = threading.Thread(target=self.loop, name=self.name, daemon=True)
        self._thread = th
        th.start()
        return th

    def close(self) -> None:
        if self._closed:
            return
        with self._xq_lock:  # paired with run_on_loop's alive re-check
            self._closed = True
        from ..utils.metrics import GlobalInspection
        GlobalInspection.get().deregister_loop(self)
        if self._thread is not None and self._thread is not threading.current_thread():
            vtl.LIB.vtl_wakeup(self._lp)
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                # loop thread is wedged in a handler: freeing the native loop
                # under it would be a use-after-free — leak it instead
                import sys
                print(f"loop {self.name}: thread did not exit; leaking native "
                      f"loop", file=sys.stderr)
                return
        self._cleanup_native()
        self._fire_death()

    def _fire_death(self) -> None:
        """Fire-once death notification. Always AFTER _cleanup_native:
        subscribers re-bind the addresses the dead loop just released."""
        cbs, self.on_death = self.on_death, []
        for cb in cbs:
            _guard(cb, self)

    def _cleanup_native(self) -> None:
        """Release fds + the native loop and honor promised tasks. Runs
        on the closing thread (graceful) or the dying loop thread
        (crash); _closed is already set so no new registrations race."""
        lp = self._lp
        if lp is None:
            return
        self._lp = None
        for fd in list(self._fd_tags):
            self._fd_tags.pop(fd, None)
            vtl.LIB.vtl_del(lp, fd)
            vtl.close(fd)
        self._handlers.clear()
        vtl.LIB.vtl_free(lp)
        # run_on_loop promised (returned True for) tasks that the loop
        # thread may have missed between its last drain and seeing the
        # closed flag — honor the promise here so resource cleanup in
        # those closures (closing accepted fds) still happens
        with self._xq_lock:
            items, self._xq = self._xq, deque()
        for fn in items:
            _guard(fn)
