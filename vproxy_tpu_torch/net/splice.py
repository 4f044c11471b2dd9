"""Native-pump splice helper: hand a frontend fd + a fresh backend
connection to the C++ splice engine (net/native/vtl.cpp) after flushing
any buffered head bytes.

This is the generic form of TcpLB._splice (components/tcplb.py) for
callers outside the LB resource (WebSocks server/agent, KcpTun): once
handed over, bytes never enter Python again.

The port's copy of vproxy_tpu/net/splice.py, same names and behaviour.
"""
from __future__ import annotations

from typing import Callable, Optional

from . import vtl
from .connection import Connection, Handler


def splice_connect(loop, front_fd: int, ip: str, port: int, head: bytes,
                   on_done: Optional[Callable[[int, int, int], None]] = None
                   ) -> None:
    """Connect ip:port and splice front_fd <-> backend natively.

    head: client bytes already read (flushed to the backend first). Any
    protocol reply owed to the client must be written through the front
    Connection (and drained) BEFORE detaching it to get front_fd.
    on_done(bytes_a2b, bytes_b2a, err) fires when the session ends.
    Closes front_fd on any failure.
    """
    try:
        back = Connection.connect(loop, ip, port)
    except OSError as e:
        vtl.close(front_fd)
        if on_done is not None:
            on_done(0, 0, e.errno or -1)
        return

    class Back(Handler):
        def on_connected(self, conn: Connection) -> None:
            conn.pause_reading()  # keep early backend bytes in the kernel
            if head:
                conn.write(head)
            if conn.out:
                return  # wait for drain before handover
            self._handover(conn)

        def on_drained(self, conn: Connection) -> None:
            self._handover(conn)

        def _handover(self, conn: Connection) -> None:
            if conn.detached or conn.closed:
                return
            bfd = conn.detach()
            if not vtl.pump_sets_nodelay():  # an older prebuilt .so only
                vtl.set_nodelay(front_fd)
                vtl.set_nodelay(bfd)
            loop.pump(front_fd, bfd, 65536, on_done)

        def on_closed(self, conn: Connection, err: int) -> None:
            vtl.close(front_fd)
            if on_done is not None:
                on_done(0, 0, err or -1)

    back.set_handler(Back())


def detach_when_drained(conn: Connection, cb: Callable[[int], None]) -> None:
    """Run cb(raw_fd) once conn's out buffer has flushed (the written
    protocol reply reached the kernel) and the conn is detached. Replaces
    the conn's handler; reading should already be paused."""
    if not conn.out:
        cb(conn.detach())
        return

    class Flush(Handler):
        def on_drained(self, c: Connection) -> None:
            if not c.detached and not c.closed:
                cb(c.detach())

        def on_closed(self, c: Connection, err: int) -> None:
            pass  # client went away while draining; nothing to splice

    conn.set_handler(Flush())
