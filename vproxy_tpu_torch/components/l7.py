"""L7Engine — drives a Processor session over real connections.

Parity: core component/proxy/ProcessorConnectionHandler.java:16 (the L7
data pump behind every `protocol=<processor>` TcpLB): owns the frontend
connection plus up to MAX_BACKENDS backend connections, funnels bytes
into the ProtoSession, executes its backend selections through
`Upstream.next` (the classify engine), and applies byte/connection
accounting and backpressure. The reference pumps through ring buffers
with TODO instructions; here the session pushes into Connection out
buffers and the engine pauses reading a source whenever a sink's out
buffer passes the high-water mark (the writable-ET analog).

The port's copy of vproxy_tpu/components/l7.py, same names and behaviour.
"""
from __future__ import annotations

import itertools
from typing import Optional

from ..net.connection import Connection, Handler
from ..processors.base import Processor, ProcessorEngine
from ..rules.ir import Hint
from ..utils.ip import parse_ip

MAX_BACKENDS = 1024  # ProcessorConnectionHandler.java:27
HIGH_WATER = 1 * 1024 * 1024


class _Sel:
    """Opaque backend selection handed back to the session; key identifies
    the concrete backend server so sessions can pool/reuse connections.
    The hint that produced the selection rides along: connect retries
    must re-run the SAME classify, not the global WRR."""

    __slots__ = ("connector", "key", "hint")

    def __init__(self, connector, hint=None):
        self.connector = connector
        self.key = (connector.ip, connector.port)
        self.hint = hint


class L7Engine(ProcessorEngine):
    def __init__(self, lb, loop, cfd: int, ip: str, port: int,
                 processor, front=None):
        """processor: a Processor, or a session factory
        callable(engine, addr) -> ProtoSession. front: a pre-built
        Connection-like (e.g. TlsSocket); when None, cfd is wrapped."""
        self.lb = lb
        self.loop = loop
        self.client_ip = parse_ip(ip)
        self.closed = False
        self.backs: dict[int, Connection] = {}
        self.back_sels: dict[int, object] = {}   # conn_id -> Connector
        self._tried: dict[int, set] = {}         # conn_id -> retried svrs
        self._hints: dict[int, object] = {}      # conn_id -> selection hint
        self._ids = itertools.count(1)
        self._front_paused = False
        self._back_paused: set[int] = set()
        lb._sessions_delta(1)
        if front is not None:
            self.front = front
        else:
            try:
                self.front = Connection(loop, cfd, (ip, port))
            except BaseException:
                lb._sessions_delta(-1)
                from ..net import vtl
                vtl.close(cfd)
                raise
        self.front.set_handler(_FrontHandler(self))
        make = processor.session if isinstance(processor, Processor) \
            else processor
        try:
            self.session = make(self, (ip, port))
        except Exception:
            self.close()
            raise

    # ----------------------------------------------------- engine interface

    def select(self, hint: Optional[Hint]) -> _Sel:
        c = self.lb.backend.next(self.client_ip, hint)
        if c is None:
            raise OSError("no healthy backend for hint")
        return _Sel(c, hint)

    def open(self, sel: _Sel) -> int:
        if self.closed:
            raise OSError("session closed")
        if len(self.backs) >= MAX_BACKENDS:
            raise OSError("too many backend connections")
        tried: set = set()
        connector = sel.connector
        while True:
            try:
                conn = Connection.connect(
                    self.loop, connector.ip, connector.port,
                    timeout_ms=self.lb.connect_timeout_ms)
                break
            except OSError as e:
                # sync connect failure: report and re-enter selection
                # excluding everything tried (shared retry knobs/budget)
                tried.add(connector.svr)
                connector.group.report_failure(connector.svr,
                                               e.errno or 0)
                connector = self._next_retry(tried, sel.hint)
                if connector is None:
                    raise OSError("backend connect failed "
                                  "(retries exhausted)")
        conn_id = next(self._ids)
        self.backs[conn_id] = conn
        self.back_sels[conn_id] = connector
        self._tried[conn_id] = tried
        self._hints[conn_id] = sel.hint
        connector.svr.conn_count += 1
        conn.set_handler(_BackHandler(self, conn_id))
        return conn_id

    def _next_retry(self, tried: set, hint):
        """One retry-gated re-selection through the shared TcpLB gate,
        re-running the SAME hint classify select() ran (hint group
        first, then the initial pick's own WRR fallback); None when out
        of attempts."""
        lb = self.lb
        return lb._take_retry_slot(
            tried, "l7",
            lambda: lb.backend.next_host(self.client_ip, hint,
                                         exclude=tried))

    def _reconnect_back(self, conn_id: int, dead: Connection,
                        err: int = 0) -> bool:
        """A backend conn died before completing its connect: swap in a
        fresh connection to another backend under the SAME conn_id,
        carrying over any bytes the session already wrote (still sitting
        in the dead conn's out buffer — nothing reached the wire).
        Transparent to the ProtoSession. True when the swap happened."""
        if self.closed:
            return False
        tried = self._tried.setdefault(conn_id, set())
        hint = self._hints.get(conn_id)
        connector = self.back_sels.get(conn_id)
        if connector is not None:
            tried.add(connector.svr)
            connector.group.report_failure(connector.svr,
                                           -err if err < 0 else err)
        pending = bytes(dead.out)
        while True:
            nxt = self._next_retry(tried, hint)
            if nxt is None:
                return False
            try:
                newc = Connection.connect(
                    self.loop, nxt.ip, nxt.port,
                    timeout_ms=self.lb.connect_timeout_ms)
                break
            except OSError as e:
                tried.add(nxt.svr)
                nxt.group.report_failure(nxt.svr, e.errno or 0)
        self._release_back(conn_id, dead)  # pops the tried/hint state too
        self.backs[conn_id] = newc
        self.back_sels[conn_id] = nxt
        self._tried[conn_id] = tried
        self._hints[conn_id] = hint
        nxt.svr.conn_count += 1
        # handler FIRST: write() can close synchronously (late async
        # connect refusal, out-buffer blowout) and that close must reach
        # _BackHandler, not the default no-op Handler
        newc.set_handler(_BackHandler(self, conn_id))
        if pending:
            newc.write(pending)
        return True

    def send_front(self, data: bytes) -> None:
        if not self.closed:
            self.front.write(data)
            self._check_pressure()

    def send_back(self, conn_id: int, data: bytes) -> None:
        conn = self.backs.get(conn_id)
        if conn is not None:
            conn.write(data)
            self._check_pressure()

    def close_back(self, conn_id: int) -> None:
        conn = self.backs.pop(conn_id, None)
        self._back_paused.discard(conn_id)
        if conn is not None:
            self._release_back(conn_id, conn)
            conn.set_handler(Handler())  # drop session callbacks
            conn.close_graceful()

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self.lb._sessions_delta(-1)
        self.lb.bytes_in += self.front.bytes_in
        self.lb.bytes_out += self.front.bytes_out
        self.front.set_handler(Handler())
        self.front.close_graceful()
        for conn_id, conn in list(self.backs.items()):
            self._release_back(conn_id, conn)
            conn.set_handler(Handler())
            conn.close_graceful()
        self.backs.clear()

    def pause_front(self) -> None:
        self._front_paused = True
        self.front.pause_reading()

    def resume_front(self) -> None:
        self._front_paused = False
        self.front.resume_reading()

    def pause_back(self, conn_id: int) -> None:
        conn = self.backs.get(conn_id)
        if conn is not None:
            self._back_paused.add(conn_id)
            conn.pause_reading()

    def resume_back(self, conn_id: int) -> None:
        conn = self.backs.get(conn_id)
        if conn is not None:
            self._back_paused.discard(conn_id)
            conn.resume_reading()

    # ----------------------------------------------------------- internals

    def _release_back(self, conn_id: int, conn: Connection) -> None:
        sel = self.back_sels.pop(conn_id, None)
        self._tried.pop(conn_id, None)
        self._hints.pop(conn_id, None)
        if sel is not None:
            svr = sel.svr
            svr.conn_count -= 1
            svr.bytes_in += conn.bytes_out  # bytes we pushed toward the server
            svr.bytes_out += conn.bytes_in

    def _check_pressure(self) -> None:
        """Sink out-buffer past high water -> pause all sources feeding it;
        resumed from the drain callbacks."""
        if self.closed:
            return
        if len(self.front.out) > HIGH_WATER:
            for conn_id, conn in self.backs.items():
                if conn_id not in self._back_paused:
                    conn.pause_reading()
        if any(len(c.out) > HIGH_WATER for c in self.backs.values()):
            if not self._front_paused:
                self.front.pause_reading()

    def _front_drained(self) -> None:
        for conn_id, conn in self.backs.items():
            if conn_id not in self._back_paused:
                conn.resume_reading()
        self.session.on_front_drained()

    def _back_drained(self, conn_id: int) -> None:
        if not self._front_paused and \
                all(len(c.out) <= HIGH_WATER for c in self.backs.values()):
            self.front.resume_reading()
        self.session.on_back_drained(conn_id)


class _FrontHandler(Handler):
    def __init__(self, eng: L7Engine):
        self.eng = eng

    def on_data(self, conn: Connection, data: bytes) -> None:
        self.eng.session.on_front_data(data)

    def on_eof(self, conn: Connection) -> None:
        self.eng.session.on_front_eof()

    def on_closed(self, conn: Connection, err: int) -> None:
        self.eng.close()

    def on_drained(self, conn: Connection) -> None:
        self.eng._front_drained()


class _BackHandler(Handler):
    def __init__(self, eng: L7Engine, conn_id: int):
        self.eng = eng
        self.conn_id = conn_id
        self.connected = False

    def on_connected(self, conn: Connection) -> None:
        self.connected = True
        eng = self.eng
        connector = eng.back_sels.get(self.conn_id)
        if connector is not None:
            connector.group.report_success(connector.svr)
            if eng._tried.get(self.conn_id):  # a retry attempt landed
                eng.lb._retries_total("success").incr()
        eng.session.on_back_connected(self.conn_id)

    def on_data(self, conn: Connection, data: bytes) -> None:
        self.eng.session.on_back_data(self.conn_id, data)

    def on_eof(self, conn: Connection) -> None:
        self.eng.session.on_back_eof(self.conn_id)

    def on_closed(self, conn: Connection, err: int) -> None:
        eng = self.eng
        if not self.connected and not eng.closed \
                and eng.backs.get(self.conn_id) is conn:
            # pre-connect death: transparently swap in another backend
            # (the session never learns; its written bytes carry over)
            if eng._reconnect_back(self.conn_id, conn, err):
                return
        conn2 = eng.backs.pop(self.conn_id, None)
        if conn2 is not None:
            eng._release_back(self.conn_id, conn2)
        if eng.closed:
            return
        if not eng.session.on_back_closed(self.conn_id, err):
            eng.close()

    def on_drained(self, conn: Connection) -> None:
        self.eng._back_drained(self.conn_id)
