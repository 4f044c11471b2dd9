"""HTTP/1.x processing: head parsing + the full per-request processor.

Two layers of parity with the reference's http1 machinery:

* `HeadParser` — incremental request-head parser used by the splice
  fast path and the controllers (scope of HttpSubContext's head states).
* `Http1Session` — the `http1` protocol processor
  (processor/http1/HttpProcessor.java + HttpSubContext.java 849-line
  state machine, hints per HttpContext.java:63-69): every request on a
  kept-alive frontend connection is routed independently — hint =
  Host[+URI] through the classify engine — with backend keep-alive
  pooling per target, body framing by content-length / chunked /
  read-to-close, and strict request/response serialization (the next
  pipelined request is not consumed until the current response ends).

The port's copy of vproxy_tpu/processors/http1.py, same names and behaviour.
"""
from __future__ import annotations

from typing import Optional

from ..rules.ir import Hint
from .base import Processor, ProcessorEngine, ProtoSession, register

MAX_HEAD = 64 * 1024


class HeadParser:
    """Feed bytes; .done becomes True when the full head (incl. CRLFCRLF)
    has been seen or .error is set."""

    def __init__(self) -> None:
        self.buf = bytearray()
        self.done = False
        self.error: Optional[str] = None
        self.method: Optional[str] = None
        self.uri: Optional[str] = None
        self.version: Optional[str] = None
        self.headers: list[tuple[str, str]] = []

    def feed(self, data: bytes) -> None:
        if self.done or self.error:
            return
        self.buf += data
        if len(self.buf) > MAX_HEAD:
            self.error = "head too large"
            return
        end = self.buf.find(b"\r\n\r\n")
        if end < 0:
            # tolerate bare-LF heads
            end_lf = self.buf.find(b"\n\n")
            if end_lf < 0:
                return
            head = bytes(self.buf[:end_lf])
            self._parse(head, end_lf + 2)
            return
        self._parse(bytes(self.buf[:end]), end + 4)

    def _parse(self, head: bytes, head_len: int) -> None:
        lines = head.replace(b"\r\n", b"\n").split(b"\n")
        try:
            req = lines[0].decode("latin-1")
            parts = req.split()
            if len(parts) < 2:
                self.error = "bad request line"
                return
            self.method = parts[0]
            self.uri = parts[1]
            self.version = parts[2] if len(parts) > 2 else "HTTP/1.0"
        except Exception:
            self.error = "bad request line"
            return
        for ln in lines[1:]:
            if not ln:
                continue
            i = ln.find(b":")
            if i < 0:
                continue
            k = ln[:i].strip().decode("latin-1").lower()
            v = ln[i + 1:].strip().decode("latin-1")
            self.headers.append((k, v))
        self.head_len = head_len
        self.done = True

    def header(self, name: str) -> Optional[str]:
        for k, v in self.headers:
            if k == name:
                return v
        return None

    def hint(self) -> Optional[Hint]:
        if not self.done:
            return None
        host = self.header("host")
        if host is not None and self.uri is not None:
            return Hint.of_host_uri(host, self.uri)
        if host is not None:
            return Hint.of_host(host)
        if self.uri is not None:
            return Hint.of_uri(self.uri)
        return None


# ---------------------------------------------------------------- processor


class _ChunkScanner:
    """Incremental chunked-body boundary scanner. feed() returns how many
    of the offered bytes belong to the current message and whether the
    message ended inside them. Bytes are relayed verbatim elsewhere."""

    SIZE, DATA, DATA_CRLF, TRAILER = range(4)

    def __init__(self) -> None:
        self.state = self.SIZE
        self.line = bytearray()
        self.left = 0
        self.error: Optional[str] = None

    def feed(self, data: bytes) -> tuple[int, bool]:
        pos = 0
        n = len(data)
        while pos < n:
            if self.state == self.SIZE:
                nl = data.find(b"\n", pos)
                if nl < 0:
                    self.line += data[pos:]
                    if len(self.line) > 1024:
                        self.error = "chunk size line too long"
                        return n, True
                    return n, False
                self.line += data[pos:nl]
                pos = nl + 1
                try:
                    size = int(bytes(self.line).split(b";")[0].strip() or b"0", 16)
                except ValueError:
                    self.error = "bad chunk size"
                    return pos, True
                self.line = bytearray()
                if size == 0:
                    self.state = self.TRAILER
                else:
                    self.left = size + 2  # data + CRLF
                    self.state = self.DATA
            elif self.state == self.DATA:
                take = min(self.left, n - pos)
                self.left -= take
                pos += take
                if self.left == 0:
                    self.state = self.SIZE
            else:  # TRAILER: lines until an empty line
                nl = data.find(b"\n", pos)
                if nl < 0:
                    self.line += data[pos:]
                    return n, False
                self.line += data[pos:nl]
                blank = not bytes(self.line).strip(b"\r")
                self.line = bytearray()
                pos = nl + 1
                if blank:
                    return pos, True
        return pos, False


class _MsgFramer:
    """Framing for one HTTP/1 message body after the head: mode one of
    none/len/chunked/eof."""

    def __init__(self, mode: str, length: int = 0):
        self.mode = mode
        self.left = length
        self.chunks = _ChunkScanner() if mode == "chunked" else None

    def feed(self, data: bytes) -> tuple[int, bool]:
        if self.mode == "none":
            return 0, True
        if self.mode == "len":
            take = min(self.left, len(data))
            self.left -= take
            return take, self.left == 0
        if self.mode == "chunked":
            return self.chunks.feed(data)
        return len(data), False  # eof: ends only when the peer closes


def _req_framer(parser: HeadParser) -> _MsgFramer:
    te = (parser.header("transfer-encoding") or "").lower()
    if "chunked" in te:
        return _MsgFramer("chunked")
    cl = parser.header("content-length")
    if cl is not None and int(cl) > 0:
        return _MsgFramer("len", int(cl))
    return _MsgFramer("none")


class _RespHead:
    """Incremental response-head parser (status line + headers)."""

    def __init__(self) -> None:
        self.buf = bytearray()
        self.done = False
        self.error: Optional[str] = None
        self.status = 0
        self.headers: list[tuple[str, str]] = []
        self.head_len = 0

    def feed(self, data: bytes) -> None:
        if self.done or self.error:
            return
        self.buf += data
        if len(self.buf) > MAX_HEAD:
            self.error = "head too large"
            return
        end = self.buf.find(b"\r\n\r\n")
        ln = 4
        if end < 0:
            end = self.buf.find(b"\n\n")
            ln = 2
            if end < 0:
                return
        head = bytes(self.buf[:end])
        self.head_len = end + ln
        lines = head.replace(b"\r\n", b"\n").split(b"\n")
        parts = lines[0].decode("latin-1").split()
        if len(parts) < 2 or not parts[1][:3].isdigit():
            self.error = "bad status line"
            return
        self.status = int(parts[1][:3])
        for line in lines[1:]:
            i = line.find(b":")
            if i > 0:
                self.headers.append((line[:i].strip().decode("latin-1").lower(),
                                     line[i + 1:].strip().decode("latin-1")))
        self.done = True

    def header(self, name: str) -> Optional[str]:
        for k, v in self.headers:
            if k == name:
                return v
        return None


class Http1Session(ProtoSession):
    # frontend states
    REQ_HEAD, REQ_BODY, WAIT_RESP, TUNNEL = range(4)

    def __init__(self, engine: ProcessorEngine, client_addr,
                 first_data: bytes = b""):
        self.engine = engine
        self.fbuf = bytearray()
        self.state = self.REQ_HEAD
        self.parser = HeadParser()
        self.req_framer: Optional[_MsgFramer] = None
        self.req_method = ""
        self.req_close = False
        self.cur_back: Optional[int] = None  # conn_id serving current request
        self.cur_key = None
        self.idle: dict = {}  # connector key -> conn_id (kept-alive backends)
        self.resp: Optional[_RespHead] = None
        self.resp_framer: Optional[_MsgFramer] = None
        self.resp_done_pending_close = False
        if first_data:
            self.on_front_data(first_data)

    # ------------------------------------------------------------ frontend

    def on_front_data(self, data: bytes) -> None:
        self.fbuf += data
        self._drive_front()

    def _drive_front(self) -> None:
        while self.fbuf:
            if self.state == self.TUNNEL:
                if self.cur_back is not None:
                    self.engine.send_back(self.cur_back, bytes(self.fbuf))
                self.fbuf.clear()
                return
            if self.state == self.WAIT_RESP:
                return  # strict serialization: hold pipelined requests
            if self.state == self.REQ_HEAD:
                self.parser.feed(bytes(self.fbuf))
                if self.parser.error:
                    self.engine.send_front(
                        b"HTTP/1.1 400 Bad Request\r\ncontent-length: 0\r\n"
                        b"connection: close\r\n\r\n")
                    self.engine.close()
                    return
                if not self.parser.done:
                    self.fbuf.clear()  # parser buffered everything
                    return
                # parser consumed the whole fbuf into parser.buf; bytes past
                # the head belong to the body / next request
                head_raw = bytes(self.parser.buf[:self.parser.head_len])
                leftover = bytes(self.parser.buf[self.parser.head_len:])
                self.fbuf = bytearray(leftover)
                if not self._begin_request(head_raw):
                    return
                continue
            if self.state == self.REQ_BODY:
                used, done = self.req_framer.feed(bytes(self.fbuf))
                if self.req_framer.chunks is not None and \
                        self.req_framer.chunks.error:
                    self.engine.close()
                    return
                if used and self.cur_back is not None:
                    self.engine.send_back(self.cur_back, bytes(self.fbuf[:used]))
                del self.fbuf[:used]
                if done:
                    self.state = self.WAIT_RESP
                else:
                    return

    def _begin_request(self, head_raw: bytes) -> bool:
        p = self.parser
        self.req_method = (p.method or "").upper()
        conn_hdr = (p.header("connection") or "").lower()
        self.req_close = "close" in conn_hdr or (
            p.version == "HTTP/1.0" and "keep-alive" not in conn_hdr)
        try:
            sel = self.engine.select(p.hint())
        except OSError:
            self.engine.send_front(
                b"HTTP/1.1 503 Service Unavailable\r\ncontent-length: 0\r\n"
                b"connection: close\r\n\r\n")
            self.engine.close()
            return False
        conn_id = self.idle.pop(sel.key, None)
        if conn_id is None:
            try:
                conn_id = self.engine.open(sel)
            except OSError:
                self.engine.send_front(
                    b"HTTP/1.1 503 Service Unavailable\r\ncontent-length: 0\r\n"
                    b"connection: close\r\n\r\n")
                self.engine.close()
                return False
        self.cur_back = conn_id
        self.cur_key = sel.key
        self.engine.send_back(conn_id, head_raw)
        self.resp = _RespHead()
        self.resp_framer = None
        self.req_framer = _req_framer(p)
        self.parser = HeadParser()
        if self.req_framer.mode == "none":
            self.state = self.WAIT_RESP
        else:
            self.state = self.REQ_BODY
        return True

    def on_front_eof(self) -> None:
        if self.state == self.TUNNEL and self.cur_back is not None:
            # half-close toward the backend is not modeled; tear down
            self.engine.close()
            return
        self.engine.close()

    # ------------------------------------------------------------ backend

    def on_back_data(self, conn_id: int, data: bytes) -> None:
        if conn_id != self.cur_back:
            # data on an idle pooled connection is a protocol violation;
            # drop the connection (reference closes idle conns that talk)
            self._drop_idle(conn_id)
            return
        if self.state == self.TUNNEL:
            self.engine.send_front(data)
            return
        self._drive_back(data)

    def _drive_back(self, data: bytes) -> None:
        while data:
            if self.resp_framer is None:
                self.resp.feed(data)
                if self.resp.error:
                    self.engine.close()
                    return
                if not self.resp.done:
                    return
                head_raw = bytes(self.resp.buf[:self.resp.head_len])
                data = bytes(self.resp.buf[self.resp.head_len:])
                self.engine.send_front(head_raw)
                st = self.resp.status
                if st == 101:
                    # protocol upgrade (websocket): raw tunnel from here on
                    self.state = self.TUNNEL
                    if data:
                        self.engine.send_front(data)
                    return
                if 100 <= st < 200:
                    self.resp = _RespHead()  # interim; real response follows
                    continue
                self.resp_framer = self._resp_framer(st)
                continue
            used, done = self.resp_framer.feed(data)
            if self.resp_framer.chunks is not None and self.resp_framer.chunks.error:
                self.engine.close()
                return
            if self.resp_framer.mode == "eof":
                self.engine.send_front(data)
                return
            if used:
                self.engine.send_front(data[:used])
            data = data[used:]
            if done:
                self._response_complete()
                if data:
                    # backend pipelined beyond the response: protocol error
                    self.engine.close()
                return

    def _resp_framer(self, status: int) -> _MsgFramer:
        if self.req_method == "HEAD" or status in (204, 304):
            return _MsgFramer("none")
        te = (self.resp.header("transfer-encoding") or "").lower()
        if "chunked" in te:
            return _MsgFramer("chunked")
        cl = self.resp.header("content-length")
        if cl is not None:
            n = int(cl)
            return _MsgFramer("len", n) if n > 0 else _MsgFramer("none")
        return _MsgFramer("eof")

    def _response_complete(self) -> None:
        back_close = "close" in (self.resp.header("connection") or "").lower()
        conn_id, key = self.cur_back, self.cur_key
        self.cur_back = self.cur_key = None
        self.resp = None
        self.resp_framer = None
        if back_close:
            self.engine.close_back(conn_id)
        elif key is not None:
            old = self.idle.get(key)
            if old is not None and old != conn_id:
                self.engine.close_back(old)
            self.idle[key] = conn_id
        if self.req_close:
            self.engine.close()
            return
        if self.state != self.REQ_BODY:  # normal case: request already done
            self.state = self.REQ_HEAD
            self._drive_front()

    def on_back_eof(self, conn_id: int) -> None:
        if conn_id == self.cur_back and self.resp_framer is not None and \
                self.resp_framer.mode == "eof":
            # close-delimited response ends at backend EOF: propagate
            self.engine.close()
            return
        if conn_id == self.cur_back:
            self.engine.close()
            return
        self._drop_idle(conn_id)

    def on_back_closed(self, conn_id: int, err: int) -> bool:
        if conn_id == self.cur_back or self.state == self.TUNNEL:
            return False  # mid-exchange loss kills the session
        self._drop_idle(conn_id)
        return True

    def _drop_idle(self, conn_id: int) -> None:
        for k, v in list(self.idle.items()):
            if v == conn_id:
                del self.idle[k]
        self.engine.close_back(conn_id)


class Http1Processor(Processor):
    name = "http1"
    alpn = ("http/1.1",)

    def session(self, engine: ProcessorEngine, client_addr) -> Http1Session:
        return Http1Session(engine, client_addr)


class GeneralHttpProcessor(Processor):
    """`http`: sniff h2 connection preface vs HTTP/1 (the reference's
    general-http processor registered by DefaultProcessorRegistry)."""

    name = "http"
    alpn = ("h2", "http/1.1")

    def session(self, engine: ProcessorEngine, client_addr) -> "_SniffSession":
        return _SniffSession(engine, client_addr)


class _SniffSession(ProtoSession):
    def __init__(self, engine: ProcessorEngine, client_addr):
        self.engine = engine
        self.client_addr = client_addr
        self.buf = bytearray()
        self.inner: Optional[ProtoSession] = None

    def on_front_data(self, data: bytes) -> None:
        if self.inner is not None:
            self.inner.on_front_data(data)
            return
        self.buf += data
        from .h2 import PREFACE, H2Session
        if len(self.buf) >= len(PREFACE):
            first = bytes(self.buf)
            self.buf.clear()
            if first.startswith(PREFACE):
                self.inner = H2Session(self.engine, self.client_addr, first)
            else:
                self.inner = Http1Session(self.engine, self.client_addr, first)
        elif not PREFACE.startswith(bytes(self.buf)):
            first = bytes(self.buf)
            self.buf.clear()
            self.inner = Http1Session(self.engine, self.client_addr, first)

    # backend/lifecycle events delegate to the resolved session

    def on_front_eof(self) -> None:
        if self.inner is not None:
            self.inner.on_front_eof()
        else:
            self.engine.close()

    def on_back_connected(self, conn_id: int) -> None:
        if self.inner is not None:
            self.inner.on_back_connected(conn_id)

    def on_back_data(self, conn_id: int, data: bytes) -> None:
        if self.inner is not None:
            self.inner.on_back_data(conn_id, data)

    def on_back_eof(self, conn_id: int) -> None:
        if self.inner is not None:
            self.inner.on_back_eof(conn_id)

    def on_back_closed(self, conn_id: int, err: int) -> bool:
        if self.inner is not None:
            return self.inner.on_back_closed(conn_id, err)
        return False

    def on_front_drained(self) -> None:
        if self.inner is not None:
            self.inner.on_front_drained()

    def on_back_drained(self, conn_id: int) -> None:
        if self.inner is not None:
            self.inner.on_back_drained(conn_id)


register(Http1Processor())
register(GeneralHttpProcessor())
