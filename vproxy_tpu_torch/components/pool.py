"""Pre-warmed idle connection pool.

Parity: reference `core/.../pool/ConnectionPool.java:14` + `PoolCallback`:
a fixed-capacity set of established idle connections to one destination,
kept alive by a pluggable keepalive hook, handed out ready-to-use
(used by the reference for conn-transfer / WebSocks "holding"
connections). A connection that dies while pooled is replaced after a
short retry delay. All state is loop-thread-confined.

Two accept-fast-lane options (TcpLB's warm backend pool rides both):

* park_reads=True — pooled connections drop read interest while idle,
  so early backend bytes (server-first protocols: the banner a backend
  sends on connect) stay queued in the kernel and reach the client
  through the splice pump after handover instead of being consumed and
  dropped by on_pooled_data. The cost: a peer's clean FIN while parked
  goes unnoticed until the taker validates (MSG_PEEK) at handover.
* idle_expire_ms>0 — connections pooled longer than this are closed on
  the keepalive sweep and replaced, bounding how stale a parked socket
  can get (backends commonly reap idle connections server-side; expiry
  keeps the pool ahead of their reaper).

The port's copy of vproxy_tpu/components/pool.py, same names and behaviour.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

from ..net.connection import Connection, Handler
from ..net.eventloop import SelectorEventLoop

RETRY_MS = 1000
KEEPALIVE_MS = 15000


class PoolHandler:
    """How the pool establishes and maintains connections."""

    def connect(self, loop: SelectorEventLoop) -> Connection:
        """Create a connecting Connection (raise OSError on failure)."""
        raise NotImplementedError

    def on_warm(self, conn: Connection) -> None:
        """A pool connect completed (the socket is now idle-warm).
        TcpLB reports backend connect success here — a refill IS a
        fresh data-plane connect, and the passive-ejection failure
        streak must clear on it like on any other successful dial."""

    def keepalive(self, conn: Connection) -> None:
        """Called periodically on each idle pooled connection."""

    def on_pooled_data(self, conn: Connection, data: bytes) -> None:
        """Data arriving while pooled (keepalive replies). Default: drop."""


class ConnectionPool:
    def __init__(self, loop: SelectorEventLoop, handler: PoolHandler,
                 capacity: int, keepalive_ms: int = KEEPALIVE_MS,
                 park_reads: bool = False, idle_expire_ms: int = 0):
        self.loop = loop
        self.handler = handler
        self.capacity = capacity
        self.keepalive_ms = keepalive_ms
        self.park_reads = park_reads
        self.idle_expire_ms = idle_expire_ms
        self._idle: List[Connection] = []   # connected, ready to hand out
        self._connecting = 0
        self.expired = 0                    # idle-expiry closures (stats)
        self.closed = False
        self._ka = None

        def boot() -> None:
            self._ka = loop.period(keepalive_ms, self._keepalive_all)
            self._fill()
        loop.run_on_loop(boot)

    # ------------------------------------------------------------- intern

    def _fill(self) -> None:
        if self.closed:
            return
        while len(self._idle) + self._connecting < self.capacity:
            try:
                conn = self.handler.connect(self.loop)
            except OSError:
                self.loop.delay(RETRY_MS, self._fill)
                return
            self._connecting += 1
            conn.set_handler(_PooledHandler(self, conn))

    def _on_up(self, conn: Connection) -> None:
        self._connecting -= 1
        if self.closed:
            conn.close()
            return
        if self.park_reads:
            # early backend bytes stay in the kernel for the pump; the
            # taker validates liveness with a MSG_PEEK at handover
            conn.pause_reading()
        conn._pooled_at = time.monotonic()
        self._idle.append(conn)
        self.handler.on_warm(conn)

    def _on_dead(self, conn: Connection, connected: bool) -> None:
        if connected:
            if conn in self._idle:
                self._idle.remove(conn)
        else:
            self._connecting -= 1
        if not self.closed:
            self.loop.delay(RETRY_MS, self._fill)

    def _keepalive_all(self) -> None:
        now = time.monotonic()
        for c in list(self._idle):
            if (self.idle_expire_ms > 0
                    and (now - getattr(c, "_pooled_at", now)) * 1000
                    >= self.idle_expire_ms):
                self.expired += 1
                c.close()  # _on_dead removes it and schedules a refill
                continue
            self.handler.keepalive(c)

    # ------------------------------------------------------------- public

    def get(self) -> Optional[Connection]:
        """Hand out one warmed connection. None if the pool is empty right
        now. Must be called on the loop thread, and the caller must
        set_handler before yielding back to the loop (no events can fire
        in between — the loop is single-threaded)."""
        if self.closed or not self._idle:
            return None
        conn = self._idle.pop(0)
        self.loop.next_tick(self._fill)
        return conn

    @property
    def count(self) -> int:
        return len(self._idle)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True

        def run() -> None:
            if self._ka is not None:
                self._ka.cancel()
            # copy: conn.close() reenters _on_dead which mutates _idle
            for c in list(self._idle):
                c.close()
            self._idle.clear()
        self.loop.run_on_loop(run)


class _PooledHandler(Handler):
    def __init__(self, pool: ConnectionPool, conn: Connection):
        self.pool = pool
        self.connected = False

    def on_connected(self, conn: Connection) -> None:
        self.connected = True
        self.pool._on_up(conn)

    def on_data(self, conn: Connection, data: bytes) -> None:
        self.pool.handler.on_pooled_data(conn, data)

    def on_eof(self, conn: Connection) -> None:
        conn.close()

    def on_closed(self, conn: Connection, err: int) -> None:
        self.pool._on_dead(conn, self.connected)
