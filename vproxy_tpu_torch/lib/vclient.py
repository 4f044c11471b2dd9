"""Async HTTP/1 client + SOCKS5 client.

Parity: lib vclient (HttpClient.java:131 callback-style request API,
impl/Http1ClientConn.java:257, impl/SocksClientImpl.java:127) and the
base socks client handshake (socks/Socks5ClientHandshake.java:232).
Callbacks fire on the event loop thread.

The port's copy of vproxy_tpu/lib/vclient.py, same names and behaviour.
"""
from __future__ import annotations

import struct
from typing import Callable, Optional

from ..net.connection import Connection, Handler
from ..net.eventloop import SelectorEventLoop
from ..processors.http1 import _MsgFramer, _RespHead
from ..utils.ip import is_ip_literal


class HttpResponse:
    def __init__(self, status: int, headers: list[tuple[str, str]],
                 body: bytes):
        self.status = status
        self.headers = headers
        self.body = body

    def header(self, name: str) -> Optional[str]:
        for k, v in self.headers:
            if k == name.lower():
                return v
        return None


class HttpClient:
    """One-shot request API; `conn` may be supplied to reuse a kept-alive
    connection (and is handed back in the callback for transfer/reuse)."""

    def __init__(self, loop: SelectorEventLoop):
        self.loop = loop

    def request(self, method: str, host: str, port: int, uri: str,
                cb: Callable[[Optional[Exception], Optional[HttpResponse],
                              Optional[Connection]], None],
                headers: Optional[list[tuple[str, str]]] = None,
                body: bytes = b"",
                conn: Optional[Connection] = None) -> None:
        def run() -> None:
            try:
                c = conn or Connection.connect(self.loop, host, port)
            except OSError as e:
                cb(e, None, None)
                return
            _HttpReq(self, c, method, host, port, uri, headers or [], body, cb)
        self.loop.run_on_loop(run)

    def get(self, host: str, port: int, uri: str, cb, **kw) -> None:
        self.request("GET", host, port, uri, cb, **kw)

    def post(self, host: str, port: int, uri: str, body: bytes, cb, **kw) -> None:
        self.request("POST", host, port, uri, cb, body=body, **kw)


class _HttpReq(Handler):
    def __init__(self, client: HttpClient, conn: Connection, method: str,
                 host: str, port: int, uri: str, headers, body: bytes, cb):
        self.cb = cb
        self.conn = conn
        self.method = method
        self.resp = _RespHead()
        self.framer: Optional[_MsgFramer] = None
        self.body = bytearray()
        self.done = False
        conn.set_handler(self)
        names = {k.lower() for k, _ in headers}
        head = f"{method} {uri} HTTP/1.1\r\n"
        if "host" not in names:
            head += f"host: {host}:{port}\r\n"
        for k, v in headers:
            head += f"{k}: {v}\r\n"
        if body and "content-length" not in names:
            head += f"content-length: {len(body)}\r\n"
        head += "\r\n"
        conn.write(head.encode() + body)

    def on_data(self, conn: Connection, data: bytes) -> None:
        while data and not self.done:
            if self.framer is None:
                self.resp.feed(data)
                if self.resp.error:
                    self._fail(OSError(self.resp.error))
                    return
                if not self.resp.done:
                    return
                data = bytes(self.resp.buf[self.resp.head_len:])
                st = self.resp.status
                if 100 <= st < 200 and st != 101:
                    self.resp = _RespHead()
                    continue
                self.framer = self._mk_framer(st)
                continue
            used, done = self.framer.feed(data)
            if self.framer.mode == "eof":
                self.body += data
                return
            self.body += data[:used]
            data = data[used:]
            if done:
                self._finish()
                return

    def _mk_framer(self, status: int) -> _MsgFramer:
        if self.method == "HEAD" or status in (204, 304):
            return _MsgFramer("none")
        te = (self.resp.header("transfer-encoding") or "").lower()
        if "chunked" in te:
            return _MsgFramer("chunked")
        cl = self.resp.header("content-length")
        if cl is not None:
            n = int(cl)
            return _MsgFramer("len", n) if n > 0 else _MsgFramer("none")
        return _MsgFramer("eof")

    def _finish(self) -> None:
        if self.done:
            return
        self.done = True
        body = bytes(self.body)
        if self.framer is not None and self.framer.mode == "chunked":
            body = _dechunk(body)
        self.conn.set_handler(Handler())
        self.cb(None, HttpResponse(self.resp.status, self.resp.headers, body),
                self.conn)

    def _fail(self, e: Exception) -> None:
        if self.done:
            return
        self.done = True
        self.conn.close()
        self.cb(e, None, None)

    def on_eof(self, conn: Connection) -> None:
        if self.framer is not None and self.framer.mode == "eof":
            self._finish()
            self.conn.close()
        else:
            self._fail(OSError("connection closed before response end"))

    def on_closed(self, conn: Connection, err: int) -> None:
        self._fail(OSError(f"connection closed ({err})"))


def _dechunk(data: bytes) -> bytes:
    out = b""
    while data:
        ln, _, data = data.partition(b"\r\n")
        n = int(ln.split(b";")[0] or b"0", 16)
        if n == 0:
            break
        out += data[:n]
        data = data[n + 2:]
    return out


# ----------------------------------------------------------------- socks5

class SocksClient:
    """CONNECT through a SOCKS5 server; yields a transferable ConnRef to
    the target (Socks5ClientHandshake.java). A ConnRef (lib/transfer.py)
    rather than a bare Connection: bytes the target sends immediately
    after the handshake are buffered and replayed into whatever handler
    the consumer transfers the connection to."""

    def __init__(self, loop: SelectorEventLoop, socks_host: str,
                 socks_port: int):
        self.loop = loop
        self.socks = (socks_host, socks_port)

    def connect(self, target_host: str, target_port: int,
                cb: Callable[[Optional[Exception], Optional["ConnRef"]], None]
                ) -> None:
        def run() -> None:
            try:
                c = Connection.connect(self.loop, *self.socks)
            except OSError as e:
                cb(e, None)
                return
            _SocksHandshake(c, target_host, target_port, cb)
        self.loop.run_on_loop(run)


class _SocksHandshake(Handler):
    ST_GREET, ST_REP = range(2)

    def __init__(self, conn: Connection, host: str, port: int, cb):
        self.conn = conn
        self.host = host
        self.port = port
        self.cb = cb
        self.buf = bytearray()
        self.state = self.ST_GREET
        self.done = False
        conn.set_handler(self)
        conn.write(b"\x05\x01\x00")

    def on_data(self, conn: Connection, data: bytes) -> None:
        self.buf += data
        if self.state == self.ST_GREET:
            if len(self.buf) < 2:
                return
            if self.buf[0] != 5 or self.buf[1] != 0:
                self._fail(OSError("socks5 auth rejected"))
                return
            del self.buf[:2]
            self.state = self.ST_REP
            if is_ip_literal(self.host):
                from ..utils.ip import parse_ip
                ip = parse_ip(self.host)
                atyp = b"\x01" if len(ip) == 4 else b"\x04"
                addr = atyp + ip
            else:
                hb = self.host.encode()
                addr = b"\x03" + bytes([len(hb)]) + hb
            conn.write(b"\x05\x01\x00" + addr + struct.pack(">H", self.port))
        if self.state == self.ST_REP:
            if len(self.buf) < 4:
                return
            rep, atyp = self.buf[1], self.buf[3]
            need = 4 + (4 if atyp == 1 else 16 if atyp == 4 else
                        1 + self.buf[4] if len(self.buf) > 4 else 999) + 2
            if len(self.buf) < need:
                return
            del self.buf[:need]
            if rep != 0:
                self._fail(OSError(f"socks5 connect failed: rep={rep}"))
                return
            self.done = True
            from .transfer import ConnRef
            ref = ConnRef(self.conn)  # installs the buffering holder
            if self.buf:  # early target bytes that rode with the reply
                ref._hold.buf += self.buf
                self.buf.clear()
            self.cb(None, ref)

    def _fail(self, e: Exception) -> None:
        if not self.done:
            self.done = True
            self.conn.close()
            self.cb(e, None)

    def on_closed(self, conn: Connection, err: int) -> None:
        self._fail(OSError(f"socks5 server closed ({err})"))

    def on_eof(self, conn: Connection) -> None:
        self._fail(OSError("socks5 server eof"))
