"""Connection handover utilities.

Parity: lib vlibbase (ConnRef/Conn transfer between components without
closing — impl/ConnImpl.java:288; ConnRefPool.java:166): an established
Connection can be detached from whatever component created it (e.g. an
HTTP client after its response completes) and handed to another
consumer, or parked in a pool of kept-alive idle connections.

The port's copy of vproxy_tpu/lib/transfer.py, same names and behaviour.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Optional

from ..net.connection import Connection, Handler
from ..net.eventloop import SelectorEventLoop


class ConnRef:
    """A transferable reference to a live Connection. transfer() swaps in
    the next owner's handler atomically on the loop thread; any bytes
    that arrive in between are buffered and replayed."""

    def __init__(self, conn: Connection):
        self.conn = conn
        self._hold = _Holding(self)
        conn.set_handler(self._hold)

    def transfer(self, handler: Handler) -> Connection:
        conn = self.conn
        buffered = bytes(self._hold.buf)
        self._hold.buf.clear()
        conn.set_handler(handler)
        if buffered:
            handler.on_data(conn, buffered)
        if self._hold.eof:
            handler.on_eof(conn)
        return conn

    @property
    def closed(self) -> bool:
        return self.conn.closed

    def close(self) -> None:
        self.conn.close()


class _Holding(Handler):
    def __init__(self, ref: ConnRef):
        self.ref = ref
        self.buf = bytearray()
        self.eof = False

    def on_data(self, conn: Connection, data: bytes) -> None:
        self.buf += data

    def on_eof(self, conn: Connection) -> None:
        self.eof = True


class ConnRefPool:
    """Pool of idle kept-alive connections (ConnRefPool.java): get() hands
    one out; idle connections that error/close or EOF drop silently;
    capacity-bounded."""

    def __init__(self, loop: SelectorEventLoop, capacity: int = 16):
        self.loop = loop
        self.capacity = capacity
        self._q: deque[ConnRef] = deque()

    def put(self, conn: Connection) -> bool:
        if conn.closed or conn.detached or len(self._q) >= self.capacity:
            return False
        ref = ConnRef(conn)
        watch = _IdleWatch(self, ref)
        conn.set_handler(watch)
        ref._hold = watch
        self._q.append(ref)
        return True

    def get(self) -> Optional[Connection]:
        while self._q:
            ref = self._q.popleft()
            if ref.closed or ref._hold.eof:
                ref.close()
                continue
            return ref.transfer(Handler())
        return None

    def count(self) -> int:
        return len(self._q)

    def close(self) -> None:
        while self._q:
            self._q.popleft().close()


class _IdleWatch(_Holding):
    def __init__(self, pool: ConnRefPool, ref: ConnRef):
        super().__init__(ref)
        self.pool = pool

    def on_data(self, conn: Connection, data: bytes) -> None:
        # a pooled idle conn that talks is broken: drop it
        self._drop(conn)

    def on_eof(self, conn: Connection) -> None:
        self.eof = True
        self._drop(conn)

    def on_closed(self, conn: Connection, err: int) -> None:
        try:
            self.pool._q.remove(self.ref)
        except ValueError:
            pass

    def _drop(self, conn: Connection) -> None:
        try:
            self.pool._q.remove(self.ref)
        except ValueError:
            pass
        conn.close()
