"""HTTP/2 processor — per-stream backend routing (the `h2` protocol).

Behavioral parity with the reference's httpbin processor
(processor/httpbin/BinaryHttpProcessor.java:10,
BinaryHttpSubContext.java: state machine over preface/SETTINGS/frames,
per-stream Hint routing httpbin/Stream.java:50, HPACK re-encoding): this
framework terminates h2 framing on both sides and relays per stream —
client streams map to streams on per-backend h2 connections selected by
Hint(:authority, :path) through the classify engine, header blocks are
HPACK-decoded and re-encoded per hop (each hop has its own dynamic-table
state), DATA is relayed under both hops' flow-control windows, and
PING/SETTINGS/WINDOW_UPDATE stay hop-local.

grpc and h2c (connection-preface cleartext, as used by h2load/grpc) work
through this processor; our encoder is static-table-only (never adds
dynamic entries), which keeps hop HPACK state trivially consistent.

The port's copy of vproxy_tpu/processors/h2.py, same names and behaviour.
"""
from __future__ import annotations

import struct
from typing import Optional

from ..rules.ir import Hint
from . import hpack
from .base import Processor, ProcessorEngine, ProtoSession, register

FRAME_HEAD = 9
PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, GOAWAY, \
    WINDOW_UPDATE, CONTINUATION = range(10)

F_END_STREAM = 0x1
F_ACK = 0x1
F_END_HEADERS = 0x4
F_PADDED = 0x8
F_PRIORITY = 0x20

S_HEADER_TABLE_SIZE = 1
S_ENABLE_PUSH = 2
S_MAX_CONCURRENT = 3
S_INITIAL_WINDOW = 4
S_MAX_FRAME_SIZE = 5

ERR_NO, ERR_PROTOCOL, ERR_INTERNAL, ERR_FLOW, ERR_REFUSED = 0, 1, 2, 3, 7

DEFAULT_WINDOW = 65535
MAX_PEND = 4 * 1024 * 1024  # per-stream relay buffer cap


class H2Error(Exception):
    def __init__(self, msg: str, code: int = ERR_PROTOCOL):
        super().__init__(msg)
        self.code = code


def frame(ftype: int, flags: int, sid: int, payload: bytes = b"") -> bytes:
    return struct.pack(">I", len(payload))[1:] + bytes((ftype, flags)) + \
        struct.pack(">I", sid & 0x7FFFFFFF) + payload


def settings_payload(pairs: list[tuple[int, int]]) -> bytes:
    return b"".join(struct.pack(">HI", k, v) for k, v in pairs)


class _Side:
    """One h2 hop (frontend conn or one backend conn): framing state,
    HPACK codecs, and SEND-direction flow-control accounting."""

    def __init__(self, server: bool, send, sid_start: int = 0):
        self.server = server
        self.send = send  # callable(bytes)
        self.buf = bytearray()
        self.preface_left = len(PREFACE) if server else 0
        self.dec = hpack.Decoder()
        self.enc = _StaticEncoder()
        self.conn_window = DEFAULT_WINDOW  # our budget for sending to them
        self.stream_window: dict[int, int] = {}
        self.initial_window = DEFAULT_WINDOW  # their INITIAL_WINDOW_SIZE
        self.peer_max_frame = 16384
        self.got_settings = False
        self.next_sid = sid_start  # client role: odd ids we allocate
        self.goaway = False
        # header-block accumulation (HEADERS/CONTINUATION until END_HEADERS)
        self.hdr_sid: Optional[int] = None
        self.hdr_flags = 0
        self.hdr_buf = bytearray()

    def alloc_sid(self) -> int:
        self.next_sid += 2
        return self.next_sid - 2

    # ---------------------------------------------------------- rx framing

    def feed(self, data: bytes):
        """-> list of (ftype, flags, sid, payload). Raises H2Error."""
        self.buf += data
        out = []
        if self.preface_left:
            take = min(self.preface_left, len(self.buf))
            expect = PREFACE[len(PREFACE) - self.preface_left:][:take]
            if bytes(self.buf[:take]) != expect:
                raise H2Error("bad client preface")
            del self.buf[:take]
            self.preface_left -= take
            if self.preface_left:
                return out
        while len(self.buf) >= FRAME_HEAD:
            ln = int.from_bytes(self.buf[:3], "big")
            if ln > 16384 + 256:  # our MAX_FRAME_SIZE stays default
                raise H2Error("frame too large", ERR_FLOW)
            if len(self.buf) < FRAME_HEAD + ln:
                break
            ftype, flags = self.buf[3], self.buf[4]
            sid = int.from_bytes(self.buf[5:9], "big") & 0x7FFFFFFF
            payload = bytes(self.buf[FRAME_HEAD:FRAME_HEAD + ln])
            del self.buf[:FRAME_HEAD + ln]
            out.append((ftype, flags, sid, payload))
        return out

    # ---------------------------------------------------------- tx helpers

    def send_headers(self, sid: int, headers: list[tuple[bytes, bytes]],
                     end_stream: bool) -> None:
        block = self.enc.encode(headers)
        flags = F_END_STREAM if end_stream else 0
        first = block[: self.peer_max_frame]
        rest = block[self.peer_max_frame:]
        if not rest:
            self.send(frame(HEADERS, flags | F_END_HEADERS, sid, first))
            return
        self.send(frame(HEADERS, flags, sid, first))
        while rest:
            chunk, rest = rest[: self.peer_max_frame], rest[self.peer_max_frame:]
            f = F_END_HEADERS if not rest else 0
            self.send(frame(CONTINUATION, f, sid, chunk))

    def window_for(self, sid: int) -> int:
        return min(self.conn_window, self.stream_window.get(sid, 0))

    def send_data(self, sid: int, chunk: bytes, end_stream: bool) -> None:
        self.conn_window -= len(chunk)
        if sid in self.stream_window:
            self.stream_window[sid] -= len(chunk)
        self.send(frame(DATA, F_END_STREAM if end_stream else 0, sid, chunk))

    def grant(self, sid: int, n: int) -> None:
        """Give the peer back receive window for relayed DATA."""
        if n <= 0:
            return
        inc = struct.pack(">I", n)
        self.send(frame(WINDOW_UPDATE, 0, 0, inc))
        self.send(frame(WINDOW_UPDATE, 0, sid, inc))

    def apply_settings(self, payload: bytes) -> None:
        if len(payload) % 6:
            raise H2Error("bad SETTINGS length")
        for off in range(0, len(payload), 6):
            k, v = struct.unpack_from(">HI", payload, off)
            if k == S_INITIAL_WINDOW:
                if v > 0x7FFFFFFF:
                    raise H2Error("bad INITIAL_WINDOW_SIZE", ERR_FLOW)
                delta = v - self.initial_window
                self.initial_window = v
                for s in self.stream_window:
                    self.stream_window[s] += delta
            elif k == S_MAX_FRAME_SIZE:
                if 16384 <= v <= 16777215:
                    self.peer_max_frame = v
            elif k == S_HEADER_TABLE_SIZE:
                # our encoder is static-only; nothing to resize
                pass
        self.got_settings = True
        self.send(frame(SETTINGS, F_ACK, 0))


class _StaticEncoder(hpack.Encoder):
    """HPACK encoder that never grows the dynamic table (always-legal
    stateless hop encoding; peers still compress toward us and our
    Decoder tracks their dynamic table)."""

    def __init__(self):
        super().__init__(max_table_size=0)


def strip_padding(flags: int, payload: bytes, has_priority: bool) -> bytes:
    pos = 0
    pad = 0
    if flags & F_PADDED:
        if not payload:
            raise H2Error("bad padding")
        pad = payload[0]
        pos = 1
    if has_priority and flags & F_PRIORITY:
        pos += 5
    if pad > len(payload) - pos:
        raise H2Error("padding exceeds payload")
    return payload[pos: len(payload) - pad]


class _Stream:
    __slots__ = ("fsid", "conn_id", "bsid", "to_back", "to_front",
                 "end_to_back", "end_to_front", "front_closed", "back_closed",
                 "got_response", "trailers", "front_trailers")

    def __init__(self, fsid: int, conn_id: int, bsid: int):
        self.fsid = fsid
        self.conn_id = conn_id
        self.bsid = bsid
        self.to_back = bytearray()   # DATA bytes waiting for backend window
        self.to_front = bytearray()  # DATA bytes waiting for client window
        self.end_to_back = False     # END_STREAM pending/seen from client
        self.end_to_front = False
        self.front_closed = False    # fully relayed toward front
        self.back_closed = False
        self.got_response = False
        self.trailers = None         # client trailers waiting behind to_back
        self.front_trailers = None   # backend trailers waiting behind to_front


class H2Session(ProtoSession):
    def __init__(self, engine: ProcessorEngine, client_addr,
                 first_data: bytes = b""):
        self.engine = engine
        self.front = _Side(server=True, send=engine.send_front)
        self.backs: dict[int, _Side] = {}
        self.by_key: dict = {}  # connector key -> conn_id
        self.streams: dict[int, _Stream] = {}  # by front sid
        self.bstreams: dict[tuple[int, int], _Stream] = {}
        self.dead = False
        # our server settings toward the client
        engine.send_front(frame(SETTINGS, 0, 0, settings_payload([
            (S_MAX_CONCURRENT, 1024), (S_INITIAL_WINDOW, DEFAULT_WINDOW),
        ])))
        if first_data:
            self.on_front_data(first_data)

    # ------------------------------------------------------------ frontend

    def on_front_data(self, data: bytes) -> None:
        if self.dead:
            return
        try:
            for ftype, flags, sid, payload in self.front.feed(data):
                self._front_frame(ftype, flags, sid, payload)
        except H2Error as e:
            self._conn_error(e)

    def _conn_error(self, e: H2Error) -> None:
        if self.dead:
            return
        self.dead = True
        last = max(self.streams, default=0)
        try:
            self.engine.send_front(
                frame(GOAWAY, 0, 0, struct.pack(">II", last, e.code)))
        except Exception:
            pass
        self.engine.close()

    def _front_frame(self, ftype: int, flags: int, sid: int,
                     payload: bytes) -> None:
        fr = self.front
        if fr.hdr_sid is not None and ftype != CONTINUATION:
            raise H2Error("expected CONTINUATION")
        if ftype == SETTINGS:
            if sid:
                raise H2Error("SETTINGS on stream")
            if not flags & F_ACK:
                fr.apply_settings(payload)
            return
        if ftype == PING:
            if not flags & F_ACK:
                fr.send(frame(PING, F_ACK, 0, payload))
            return
        if ftype == WINDOW_UPDATE:
            inc = int.from_bytes(payload, "big") & 0x7FFFFFFF
            if inc == 0:
                raise H2Error("zero WINDOW_UPDATE")
            if sid == 0:
                fr.conn_window += inc
                for st in list(self.streams.values()):
                    self._pump_front(st)
            elif sid in self.streams:
                fr.stream_window[sid] = fr.stream_window.get(sid, 0) + inc
                self._pump_front(self.streams[sid])
            return
        if ftype == PRIORITY:
            return
        if ftype == GOAWAY:
            # client is going away; finish nothing new, drop the session
            self.engine.close()
            return
        if ftype == HEADERS:
            block = strip_padding(flags, payload, has_priority=True)
            if flags & F_END_HEADERS:
                self._front_headers(sid, flags, bytes(block))
            else:
                fr.hdr_sid, fr.hdr_flags = sid, flags
                fr.hdr_buf = bytearray(block)
            return
        if ftype == CONTINUATION:
            if fr.hdr_sid != sid:
                raise H2Error("CONTINUATION on wrong stream")
            fr.hdr_buf += payload
            if flags & F_END_HEADERS:
                hsid, hflags = fr.hdr_sid, fr.hdr_flags
                fr.hdr_sid = None
                self._front_headers(hsid, hflags, bytes(fr.hdr_buf))
            return
        if ftype == DATA:
            st = self.streams.get(sid)
            body = strip_padding(flags, payload, has_priority=False)
            if st is None or st.back_closed:
                # stream already reset/unknown: still return conn window
                fr.send(frame(WINDOW_UPDATE, 0, 0,
                              struct.pack(">I", max(len(payload), 1))))
                return
            fr.grant(sid, len(payload))
            st.to_back += body
            if len(st.to_back) > MAX_PEND:
                self._reset_both(st, ERR_FLOW)
                return
            if flags & F_END_STREAM:
                st.end_to_back = True
            self._pump_back(st)
            return
        if ftype == RST_STREAM:
            st = self.streams.pop(sid, None)
            if st is not None:
                self.bstreams.pop((st.conn_id, st.bsid), None)
                back = self.backs.get(st.conn_id)
                if back is not None and not st.back_closed:
                    back.send(frame(RST_STREAM, 0, st.bsid, payload[:4]))
            return
        if ftype == PUSH_PROMISE:
            raise H2Error("PUSH_PROMISE from client")
        # unknown frame types are ignored per RFC 7540 §4.1

    def _front_headers(self, sid: int, flags: int, block: bytes) -> None:
        headers = self._decode(self.front, block)
        end = bool(flags & F_END_STREAM)
        st = self.streams.get(sid)
        if st is not None:
            # trailers toward the backend
            back = self.backs.get(st.conn_id)
            if back is not None and not st.back_closed:
                st.end_to_back = True
                if st.to_back:
                    # flush pending data first; trailers follow when drained
                    st.trailers = headers  # type: ignore[attr-defined]
                    self._pump_back(st)
                else:
                    back.send_headers(st.bsid, headers, end_stream=True)
            return
        # new request stream
        authority = path = None
        for k, v in headers:
            if k == b":authority":
                authority = v.decode("latin-1")
            elif k == b":path":
                path = v.decode("latin-1")
            elif k == b"host" and authority is None:
                authority = v.decode("latin-1")
        hint = None
        if authority is not None and path is not None:
            hint = Hint.of_host_uri(authority, path)
        elif authority is not None:
            hint = Hint.of_host(authority)
        try:
            sel = self.engine.select(hint)
        except OSError:
            self.front.send(
                frame(RST_STREAM, 0, sid, struct.pack(">I", ERR_REFUSED)))
            return
        conn_id = self.by_key.get(sel.key, -1)
        back = self.backs.get(conn_id)
        if back is None or back.goaway:
            conn_id = self.engine.open(sel)
            back = _Side(server=False, send=lambda b, c=conn_id:
                         self.engine.send_back(c, b), sid_start=1)
            back.send(PREFACE + frame(SETTINGS, 0, 0, settings_payload([
                (S_ENABLE_PUSH, 0), (S_MAX_CONCURRENT, 1024),
            ])))
            self.backs[conn_id] = back
            self.by_key[sel.key] = conn_id
        bsid = back.alloc_sid()
        st = _Stream(sid, conn_id, bsid)
        self.streams[sid] = st
        self.bstreams[(conn_id, bsid)] = st
        self.front.stream_window.setdefault(sid, self.front.initial_window)
        back.stream_window[bsid] = back.initial_window
        back.send_headers(bsid, headers, end_stream=end)
        if end:
            st.end_to_back = True

    # ------------------------------------------------------------ backend

    def on_back_connected(self, conn_id: int) -> None: ...

    def on_back_data(self, conn_id: int, data: bytes) -> None:
        if self.dead:
            return
        back = self.backs.get(conn_id)
        if back is None:
            return
        try:
            for ftype, flags, sid, payload in back.feed(data):
                self._back_frame(back, conn_id, ftype, flags, sid, payload)
        except H2Error as e:
            self._back_dead(conn_id, e.code)

    def _back_frame(self, back: _Side, conn_id: int, ftype: int, flags: int,
                    sid: int, payload: bytes) -> None:
        if back.hdr_sid is not None and ftype != CONTINUATION:
            raise H2Error("expected CONTINUATION")
        if ftype == SETTINGS:
            if not flags & F_ACK:
                back.apply_settings(payload)
                for st in list(self.bstreams.values()):
                    if st.conn_id == conn_id:
                        self._pump_back(st)
            return
        if ftype == PING:
            if not flags & F_ACK:
                back.send(frame(PING, F_ACK, 0, payload))
            return
        if ftype == WINDOW_UPDATE:
            inc = int.from_bytes(payload, "big") & 0x7FFFFFFF
            if sid == 0:
                back.conn_window += inc
                for st in list(self.bstreams.values()):
                    if st.conn_id == conn_id:
                        self._pump_back(st)
            else:
                st = self.bstreams.get((conn_id, sid))
                if st is not None:
                    back.stream_window[sid] = back.stream_window.get(sid, 0) + inc
                    self._pump_back(st)
            return
        if ftype in (PRIORITY,):
            return
        if ftype == GOAWAY:
            self._back_dead(conn_id, ERR_NO)
            return
        if ftype == PUSH_PROMISE:
            # we sent ENABLE_PUSH=0
            raise H2Error("unexpected PUSH_PROMISE")
        if ftype == HEADERS:
            block = strip_padding(flags, payload, has_priority=True)
            if flags & F_END_HEADERS:
                self._back_headers(back, conn_id, sid, flags, bytes(block))
            else:
                back.hdr_sid, back.hdr_flags = sid, flags
                back.hdr_buf = bytearray(block)
            return
        if ftype == CONTINUATION:
            if back.hdr_sid != sid:
                raise H2Error("CONTINUATION on wrong stream")
            back.hdr_buf += payload
            if flags & F_END_HEADERS:
                hsid, hflags = back.hdr_sid, back.hdr_flags
                back.hdr_sid = None
                self._back_headers(back, conn_id, hsid, hflags,
                                   bytes(back.hdr_buf))
            return
        if ftype == DATA:
            st = self.bstreams.get((conn_id, sid))
            body = strip_padding(flags, payload, has_priority=False)
            if st is None:
                return
            back.grant(sid, len(payload))
            st.to_front += body
            if len(st.to_front) > MAX_PEND:
                self._reset_both(st, ERR_FLOW)
                return
            if flags & F_END_STREAM:
                st.end_to_front = True
            self._pump_front(st)
            return
        if ftype == RST_STREAM:
            st = self.bstreams.pop((conn_id, sid), None)
            if st is not None:
                self.streams.pop(st.fsid, None)
                self.front.send(frame(RST_STREAM, 0, st.fsid, payload[:4]))
            return

    def _back_headers(self, back: _Side, conn_id: int, sid: int, flags: int,
                      block: bytes) -> None:
        headers = self._decode(back, block)
        st = self.bstreams.get((conn_id, sid))
        if st is None:
            return
        end = bool(flags & F_END_STREAM)
        if st.got_response and st.to_front:
            # trailers behind pending data
            st.front_trailers = headers  # type: ignore[attr-defined]
            st.end_to_front = True
            self._pump_front(st)
            return
        st.got_response = True
        self.front.send_headers(st.fsid, headers, end_stream=end)
        if end:
            st.end_to_front = True
            st.front_closed = True
            self._maybe_done(st)

    # ------------------------------------------------------------ pumps

    def _decode(self, side: _Side, block: bytes) -> list[tuple[bytes, bytes]]:
        try:
            return side.dec.decode(block)
        except hpack.HpackError as e:
            raise H2Error(f"hpack: {e}", ERR_INTERNAL)

    def _pump_back(self, st: _Stream) -> None:
        back = self.backs.get(st.conn_id)
        if back is None or st.back_closed:
            return
        while st.to_back:
            w = min(back.window_for(st.bsid), back.peer_max_frame)
            if w <= 0:
                return
            chunk = bytes(st.to_back[:w])
            del st.to_back[:len(chunk)]
            last = st.end_to_back and not st.to_back and st.trailers is None
            back.send_data(st.bsid, chunk, end_stream=last)
        if st.end_to_back and not st.to_back and st.trailers is not None:
            tr, st.trailers = st.trailers, None
            back.send_headers(st.bsid, tr, end_stream=True)

    def _pump_front(self, st: _Stream) -> None:
        fr = self.front
        while st.to_front:
            w = min(fr.window_for(st.fsid), fr.peer_max_frame)
            if w <= 0:
                return
            chunk = bytes(st.to_front[:w])
            del st.to_front[:len(chunk)]
            last = st.end_to_front and not st.to_front and \
                st.front_trailers is None
            fr.send_data(st.fsid, chunk, end_stream=last)
            if last:
                st.front_closed = True
        if st.end_to_front and not st.to_front and st.front_trailers is not None:
            tr, st.front_trailers = st.front_trailers, None
            fr.send_headers(st.fsid, tr, end_stream=True)
            st.front_closed = True
        self._maybe_done(st)

    def _maybe_done(self, st: _Stream) -> None:
        if st.front_closed and st.end_to_back and not st.to_back:
            self.streams.pop(st.fsid, None)
            self.bstreams.pop((st.conn_id, st.bsid), None)
            self.front.stream_window.pop(st.fsid, None)
            back = self.backs.get(st.conn_id)
            if back is not None:
                back.stream_window.pop(st.bsid, None)

    def _reset_both(self, st: _Stream, code: int) -> None:
        self.streams.pop(st.fsid, None)
        self.bstreams.pop((st.conn_id, st.bsid), None)
        self.front.send(frame(RST_STREAM, 0, st.fsid, struct.pack(">I", code)))
        back = self.backs.get(st.conn_id)
        if back is not None:
            back.send(frame(RST_STREAM, 0, st.bsid, struct.pack(">I", code)))

    def _back_dead(self, conn_id: int, code: int) -> None:
        back = self.backs.pop(conn_id, None)
        if back is None:
            return
        back.goaway = True
        self.by_key = {k: v for k, v in self.by_key.items() if v != conn_id}
        for (cid, bsid), st in list(self.bstreams.items()):
            if cid != conn_id:
                continue
            self.bstreams.pop((cid, bsid), None)
            self.streams.pop(st.fsid, None)
            if not st.front_closed:
                self.front.send(frame(RST_STREAM, 0, st.fsid,
                                      struct.pack(">I", ERR_REFUSED)))
        self.engine.close_back(conn_id)

    # ------------------------------------------------------------ lifecycle

    def on_back_eof(self, conn_id: int) -> None:
        self._back_dead(conn_id, ERR_NO)

    def on_back_closed(self, conn_id: int, err: int) -> bool:
        self._back_dead(conn_id, ERR_INTERNAL)
        return True  # session survives a backend loss (silent disconnect)

    def on_front_eof(self) -> None:
        self.engine.close()


class H2Processor(Processor):
    name = "h2"
    alpn = ("h2",)

    def session(self, engine: ProcessorEngine, client_addr) -> H2Session:
        return H2Session(engine, client_addr)


register(H2Processor())
