"""Multiplexed virtual streams over one ARQ (KCP) session.

Parity: reference `selector/wrap/streamed` + `wrap/h2streamed`
(`StreamedFDHandler.java:999`, `StreamedFD.java:368`,
`H2StreamedFDHandler.java:303`, client/server factories
`StreamedArqUDPServerFDs.java:223`): a "TCP-like" API where many
streams share one reliable ARQ-over-UDP session — the transport of
WebSocks UDP mode and KcpTun. The reference frames streams with an
HTTP/2-flavored codec; here each KCP message carries exactly one frame
(KCP already guarantees ordering/reliability, so the codec needs no
resync):

  stream_id:u32  type:u8  len:u32  payload     (little-endian)

types: 1 HELLO, 2 HELLO_ACK (session handshake), 3 SYN (open stream),
4 PSH (data), 5 FIN (half-close), 6 RST (abort), 7 PING, 8 PONG
(session keepalive; 3 missed pings = session broken, as the
reference's keepalive does).

Client streams use odd ids, server streams even — no id races.

The port's copy of vproxy_tpu/net/streamed.py, same names and behaviour.
"""
from __future__ import annotations

import struct
from collections import deque
from typing import Callable, Dict, Optional

from .eventloop import SelectorEventLoop
from .kcp import KcpConn, KcpHandler

F_HELLO, F_HELLO_ACK, F_SYN, F_PSH, F_FIN, F_RST, F_PING, F_PONG = range(1, 9)
_HEAD = struct.Struct("<IBI")

KEEPALIVE_MS = 5000
KEEPALIVE_MISS = 3


class StreamHandler:
    def on_connected(self, s: "Stream") -> None: ...

    def on_data(self, s: "Stream", data: bytes) -> None: ...

    def on_eof(self, s: "Stream") -> None: ...

    def on_closed(self, s: "Stream") -> None: ...


class Stream:
    """One virtual stream; Connection-flavored surface."""

    # bytes buffered while no handler is attached (accept callback may
    # defer set_handler); beyond this the stream is reset
    PENDING_MAX = 1 << 20

    def __init__(self, sess: "StreamedSession", sid: int):
        self.sess = sess
        self.sid = sid
        self.handler: Optional[StreamHandler] = None
        self.connected = False
        self.eof_sent = False
        self.eof_rcvd = False
        self.closed = False
        self._pending: deque = deque()
        self._pending_bytes = 0
        self._eof_delivered = False
        self._closed_delivered = False

    def set_handler(self, h: StreamHandler) -> None:
        self.handler = h
        while self._pending and not self.closed:
            h.on_data(self, self._pending.popleft())
        self._pending_bytes = 0
        # lifecycle events that arrived while no handler was attached
        if self.eof_rcvd and not self._eof_delivered and not self.closed:
            self._eof_delivered = True
            h.on_eof(self)
        if self.closed and not self._closed_delivered:
            self._closed_delivered = True
            h.on_closed(self)

    # one PSH = one KCP message; keep well under KCP's fragment window
    # (255 frags / rcv_wnd) so any write size is legal
    CHUNK = 32 * 1024

    def write(self, data: bytes) -> None:
        if self.closed or self.eof_sent:
            return
        for off in range(0, len(data), self.CHUNK):
            self.sess._send(self.sid, F_PSH, data[off:off + self.CHUNK])

    def close_graceful(self) -> None:
        """Send FIN; stream dies once both directions are finished."""
        if not self.closed and not self.eof_sent:
            self.eof_sent = True
            self.sess._send(self.sid, F_FIN)
            if self.eof_rcvd:
                self._die()

    def close(self) -> None:
        if not self.closed:
            self.sess._send(self.sid, F_RST)
            self._die()

    def _die(self) -> None:
        if self.closed:
            return
        self.closed = True
        self.sess.streams.pop(self.sid, None)
        if self.handler is not None:
            self._closed_delivered = True
            self.handler.on_closed(self)
        # else: delivered by set_handler when a handler attaches


class StreamedSession(KcpHandler):
    """All streams of one KCP session.

    on_accept(stream) fires (server side) when the peer opens a stream;
    on_up()/on_broken() report session state. open_stream() is valid
    after on_up (client can call earlier; SYN is queued by KCP anyway).
    """

    def __init__(self, loop: SelectorEventLoop, kcp: KcpConn,
                 is_client: bool,
                 on_accept: Optional[Callable[["Stream"], None]] = None,
                 on_up: Optional[Callable[[], None]] = None,
                 on_broken: Optional[Callable[[], None]] = None):
        self.loop = loop
        self.kcp = kcp
        kcp.handler = self
        self.is_client = is_client
        self.on_accept = on_accept
        self.on_up = on_up
        self.on_broken_cb = on_broken
        self.streams: Dict[int, Stream] = {}
        self._next_sid = 1 if is_client else 2
        self.up = False
        self.broken = False
        self._missed = 0
        self._ka = None

        def arm() -> None:
            if not self.broken:  # close() may have raced the deferred arm
                self._ka = loop.period(KEEPALIVE_MS, self._keepalive)
        loop.run_on_loop(arm)
        if is_client:
            self._send(0, F_HELLO)

    # ------------------------------------------------------------ streams

    def open_stream(self, handler: Optional[StreamHandler] = None) -> Stream:
        if self.broken:
            raise OSError("session broken")
        sid = self._next_sid
        self._next_sid += 2
        s = Stream(self, sid)
        s.handler = handler
        s.connected = True
        self.streams[sid] = s
        self._send(sid, F_SYN)
        return s

    # ------------------------------------------------------------ wire

    def _send(self, sid: int, ftype: int, payload: bytes = b"") -> None:
        if not self.broken:
            self.kcp.send(_HEAD.pack(sid, ftype, len(payload)) + payload)

    def on_message(self, conn: KcpConn, data: bytes) -> None:
        if len(data) < _HEAD.size:
            return
        sid, ftype, ln = _HEAD.unpack_from(data)
        payload = data[_HEAD.size:_HEAD.size + ln]
        if ftype == F_HELLO:
            self._send(0, F_HELLO_ACK)
            self._session_up()
        elif ftype == F_HELLO_ACK:
            self._session_up()
        elif ftype == F_PING:
            self._send(0, F_PONG)
        elif ftype == F_PONG:
            self._missed = 0
        elif ftype == F_SYN:
            # peer-opened sids must have the opposite parity of ours and
            # be fresh — a collision would silently orphan a live stream
            if sid % 2 == self._next_sid % 2 or sid in self.streams:
                self._send(sid, F_RST)
                return
            s = Stream(self, sid)
            s.connected = True
            self.streams[sid] = s
            if self.on_accept is not None:
                self.on_accept(s)
            if s.handler is not None:
                s.handler.on_connected(s)
        elif ftype == F_PSH:
            s = self.streams.get(sid)
            if s is None:
                self._send(sid, F_RST)
            elif not s.eof_rcvd:
                if s.handler is not None:
                    s.handler.on_data(s, payload)
                elif s._pending_bytes + len(payload) <= s.PENDING_MAX:
                    s._pending.append(payload)
                    s._pending_bytes += len(payload)
                else:
                    s.close()  # RSTs and dies rather than dropping bytes
        elif ftype == F_FIN:
            s = self.streams.get(sid)
            if s is not None and not s.eof_rcvd:
                s.eof_rcvd = True
                if s.handler is not None:
                    s._eof_delivered = True
                    s.handler.on_eof(s)
                if s.eof_sent:
                    s._die()
        elif ftype == F_RST:
            s = self.streams.get(sid)
            if s is not None:
                s._die()

    def _session_up(self) -> None:
        if not self.up:
            self.up = True
            if self.on_up is not None:
                self.on_up()

    # --------------------------------------------------------- keepalive

    def _keepalive(self) -> None:
        if self.broken:
            return
        self._missed += 1
        if self._missed > KEEPALIVE_MISS:
            self._break(notify=True)
            return
        self._send(0, F_PING)

    def on_broken(self, conn: KcpConn) -> None:
        self._break(notify=True)

    def _break(self, notify: bool) -> None:
        if self.broken:
            return
        self.broken = True
        if self._ka is not None:
            self.loop.run_on_loop(self._ka.cancel)
        for s in list(self.streams.values()):
            s._die()
        self.kcp.close()
        if notify and self.on_broken_cb is not None:
            self.on_broken_cb()

    def close(self) -> None:
        """Deliberate local shutdown: does NOT fire on_broken (a caller
        wiring on_broken to reconnect logic must not re-dial here)."""
        self._break(notify=False)
