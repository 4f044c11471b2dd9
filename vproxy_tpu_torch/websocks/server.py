"""WebSocksProxyServer — SOCKS5 tunneled inside a WebSocket upgrade.

Parity: vproxyx/WebSocksProxyServer.java:347 + the protocol handler
websocks/WebSocksProtocolHandler.java:540 (behavior per doc/websocks.md):

* HTTP request that is a valid WebSocket upgrade with protocol
  "socks5" and a valid minute-salted Basic auth -> 101 + 10-byte
  max-payload frame exchange -> SOCKS5 handshake -> connect target ->
  relay. Plain-TCP fronts hand both fds to the native splice pump;
  KCP-streamed fronts relay through the stream mux.
* Any other HTTP request -> fake web page (WebRootPageProvider.java:216
  analog: an in-memory default page or a file root) or a redirect —
  the server looks like an ordinary website to probes.
* Unsolicited PONG frames are absorbed at any point before the
  max-payload frame.

Transports: TCP listener and/or a KCP-streamed UDP listener (the agent
side's "UDP-over-KCP" option) — the SAME protocol state machine drives
both via a small duplex adapter.

The port's copy of vproxy_tpu/websocks/server.py, same names and behaviour.
"""
from __future__ import annotations

import os
import struct
from typing import Callable, Optional

from ..net import vtl
from ..net.connection import Connection, Handler, ServerSock
from ..net.eventloop import SelectorEventLoop
from ..net.kcp import KcpConn
from ..net.splice import detach_when_drained, splice_connect
from ..net.streamed import Stream, StreamedSession, StreamHandler
from ..net.udp import UdpServer
from ..processors.http1 import HeadParser
from ..utils.log import Logger
from . import common

_log = Logger("websocks-server")

KCP_CONV = 0x77736B73  # "wsks"

DEFAULT_PAGE = (b"<!DOCTYPE html><html><head><title>Welcome</title></head>"
                b"<body><h1>Welcome to nginx!</h1><p>If you see this page, "
                b"the web server is successfully installed.</p></body></html>")


class PageProvider:
    """Serves the fake site (WebRootPageProvider analog). root: optional
    directory of static files; falls back to the built-in page for /."""

    def __init__(self, root: Optional[str] = None):
        self.root = root

    def get(self, path: str) -> Optional[tuple[bytes, str]]:
        if self.root is not None:
            root = os.path.abspath(self.root)
            p = os.path.normpath(os.path.join(root, path.lstrip("/")))
            if os.path.commonpath([root, p]) != root:
                return None
            if os.path.isdir(p):
                p = os.path.join(p, "index.html")
            if os.path.isfile(p):
                ctype = "text/html" if p.endswith((".html", ".htm")) \
                    else "application/octet-stream"
                with open(p, "rb") as f:
                    return f.read(), ctype
            return None
        if path in ("/", "/index.html"):
            return DEFAULT_PAGE, "text/html"
        return None


class _Duplex:
    """Uniform face over a TCP Connection or a KCP Stream for the
    handshake machine: write/close + data/closed callbacks. raw_fd is
    set only for plain TCP (enables the native pump handover)."""

    def __init__(self, write, close, conn: Optional[Connection] = None):
        self.write = write
        self.close = close
        self.conn = conn  # plain-TCP front, pump-capable


# SOCKS5 bits (RFC 1928; constants shared with components/socks5)
_VER = 5
_CMD_CONNECT = 1
_ATYP_V4, _ATYP_DOMAIN, _ATYP_V6 = 1, 3, 4


class _Session:
    """One front connection's protocol state machine."""

    ST_HTTP, ST_FRAME10, ST_GREET, ST_REQ, ST_TUNNEL, ST_DONE = range(6)

    def __init__(self, server: "WebSocksProxyServer", loop, dup: _Duplex):
        self.server = server
        self.loop = loop
        self.dup = dup
        self.buf = bytearray()
        self.state = self.ST_HTTP
        self.parser = HeadParser()
        self.back: Optional[Connection] = None

    # ------------------------------------------------------------- input

    def on_data(self, data: bytes) -> None:
        self.buf += data
        try:
            self._advance()
        except Exception:
            _log.error("websocks session error", exc=True)
            self.close()

    def _advance(self) -> None:
        while True:
            if self.state == self.ST_HTTP:
                if not self._http():
                    return
            elif self.state == self.ST_FRAME10:
                if not self._frame10():
                    return
            elif self.state == self.ST_GREET:
                if not self._greet():
                    return
            elif self.state == self.ST_REQ:
                if not self._request():
                    return
            elif self.state == self.ST_TUNNEL:
                # bytes that raced the backend connect: queue to backend
                if self.buf and self.back is not None:
                    self.back.write(bytes(self.buf))
                    self.buf.clear()
                return
            else:
                return

    def _http(self) -> bool:
        self.parser.feed(bytes(self.buf))
        self.buf.clear()
        if self.parser.error:
            self._page_status(400, b"bad request")
            return False
        if not self.parser.done:
            return False
        rest = bytes(self.parser.buf)[self.parser.head_len:]
        h = dict(self.parser.headers)  # keys already lowercased
        if (h.get("upgrade", "").lower() == "websocket"
                and "socks5" in h.get("sec-websocket-protocol", "")):
            user = common.validate_auth(h.get("authorization"),
                                        self.server.users)
            if user is None:
                self._page_status(401, b"unauthorized",
                                  [("WWW-Authenticate", "Basic")])
                return False
            self.user = user
            key = h.get("sec-websocket-key", "")
            self.dup.write(common.upgrade_response(key))
            self.state = self.ST_FRAME10
            self.buf += rest  # combined packets are allowed
            return True
        self._serve_page()
        return False

    def _frame10(self) -> bool:
        # absorb unsolicited PONGs, then expect the 10-byte frame
        while len(self.buf) >= 2 and self.buf[0] == 0x8A:
            if self.buf[1] != 0x00:
                self.close()
                return False
            del self.buf[:2]
        if len(self.buf) < 10:
            return False
        if bytes(self.buf[:2]) != common.MAX_PAYLOAD_FRAME[:2]:
            self.close()
            return False
        del self.buf[:10]
        self.dup.write(common.MAX_PAYLOAD_FRAME)
        self.state = self.ST_GREET
        return True

    def _greet(self) -> bool:
        if len(self.buf) < 2:
            return False
        ver, n = self.buf[0], self.buf[1]
        if ver != _VER or len(self.buf) < 2 + n:
            if ver != _VER:
                self.close()
            return False
        methods = self.buf[2: 2 + n]
        del self.buf[: 2 + n]
        if 0 not in methods:
            self.dup.write(b"\x05\xff")
            self.close()
            return False
        self.dup.write(b"\x05\x00")
        self.state = self.ST_REQ
        return True

    def _request(self) -> bool:
        if len(self.buf) < 4:
            return False
        ver, cmd, _rsv, atyp = self.buf[:4]
        if ver != _VER:
            self.close()
            return False
        if atyp == _ATYP_V4:
            need = 4 + 4 + 2
        elif atyp == _ATYP_V6:
            need = 4 + 16 + 2
        elif atyp == _ATYP_DOMAIN:
            if len(self.buf) < 5:
                return False
            need = 4 + 1 + self.buf[4] + 2
        else:
            self.dup.write(b"\x05\x08\x00\x01" + b"\x00" * 6)
            self.close()
            return False
        if len(self.buf) < need:
            return False
        if cmd != _CMD_CONNECT:
            self.dup.write(b"\x05\x07\x00\x01" + b"\x00" * 6)
            self.close()
            return False
        if atyp == _ATYP_DOMAIN:
            dlen = self.buf[4]
            host = bytes(self.buf[5:5 + dlen]).decode("latin-1")
            port = struct.unpack(">H", self.buf[5 + dlen:7 + dlen])[0]
        else:
            alen = 4 if atyp == _ATYP_V4 else 16
            import socket as _s
            host = _s.inet_ntop(_s.AF_INET if alen == 4 else _s.AF_INET6,
                                bytes(self.buf[4:4 + alen]))
            port = struct.unpack(">H", self.buf[4 + alen:6 + alen])[0]
        del self.buf[:need]
        self.state = self.ST_TUNNEL
        self._connect(host, port, bytes(self.buf))
        self.buf.clear()
        return False

    # ----------------------------------------------------------- connect

    def _connect(self, host: str, port: int, early: bytes) -> None:
        from ..utils.ip import is_ip_literal
        resolve = self.server.resolve
        if is_ip_literal(host):
            self._connect_ip(host, port, early)
        else:
            def done(ip: Optional[str]) -> None:
                if ip is None:
                    self.dup.write(b"\x05\x04\x00\x01" + b"\x00" * 6)
                    self.close()
                else:
                    self._connect_ip(ip, port, early)
            resolve(self.loop, host, done)

    def _connect_ip(self, ip: str, port: int, early: bytes) -> None:
        ok_reply = b"\x05\x00\x00\x01" + b"\x00" * 6
        if self.dup.conn is not None:
            # plain-TCP front: reply, drain, then native pump handover
            conn = self.dup.conn
            conn.pause_reading()
            conn.write(ok_reply)
            self.server.sessions += 1
            self.server.tunneled += 1

            def done(a2b, b2a, err):
                self.server.sessions -= 1

            detach_when_drained(conn, lambda fd: splice_connect(
                self.loop, fd, ip, port, early, done))
            self.state = self.ST_DONE
            return
        # streamed front: python bridge
        try:
            back = Connection.connect(self.loop, ip, port)
        except OSError:
            self.dup.write(b"\x05\x05\x00\x01" + b"\x00" * 6)
            self.close()
            return
        self.back = back
        sess = self
        self.server.sessions += 1
        self.server.tunneled += 1

        class Back(Handler):
            def on_connected(self, c: Connection) -> None:
                sess.dup.write(ok_reply)
                if early:
                    c.write(early)

            def on_data(self, c: Connection, data: bytes) -> None:
                sess.dup.write(data)

            def on_eof(self, c: Connection) -> None:
                sess.dup.close()

            def on_closed(self, c: Connection, err: int) -> None:
                sess.server.sessions -= 1
                sess.back = None
                sess.dup.close()

        back.set_handler(Back())

    # -------------------------------------------------------------- page

    def _serve_page(self) -> None:
        if self.server.redirect is not None:
            self.dup.write((f"HTTP/1.1 302 Found\r\nLocation: "
                            f"{self.server.redirect}\r\ncontent-length: 0"
                            f"\r\nconnection: close\r\n\r\n").encode())
            self.close()
            return
        got = self.server.pages.get(self.parser.uri or "/")
        if got is None:
            self._page_status(404, b"404 not found")
            return
        body, ctype = got
        self.dup.write((f"HTTP/1.1 200 OK\r\ncontent-type: {ctype}\r\n"
                        f"content-length: {len(body)}\r\n"
                        f"connection: close\r\n\r\n").encode() + body)
        self.close()

    def _page_status(self, code: int, body: bytes, extra=()) -> None:
        lines = "".join(f"{k}: {v}\r\n" for k, v in extra)
        self.dup.write((f"HTTP/1.1 {code} X\r\n{lines}"
                        f"content-length: {len(body)}\r\n"
                        f"connection: close\r\n\r\n").encode() + body)
        self.close()

    def close(self) -> None:
        self.state = self.ST_DONE
        if self.back is not None:
            self.back.close()
            self.back = None
        self.dup.close()


def _default_resolve(loop, host: str, cb: Callable[[Optional[str]], None]) -> None:
    """Off-loop getaddrinfo, continuation on the loop (Socks5 pattern)."""
    import socket
    import threading

    def work() -> None:
        try:
            infos = socket.getaddrinfo(host, None, type=socket.SOCK_STREAM)
            ip = infos[0][4][0]
        except OSError:
            ip = None
        loop.run_on_loop(lambda: cb(ip))

    threading.Thread(target=work, daemon=True).start()


class WebSocksProxyServer:
    """users: {username: password}. TCP listener always; kcp=True adds a
    KCP-streamed UDP listener on the same port number."""

    def __init__(self, alias: str, loop: SelectorEventLoop, bind_ip: str,
                 bind_port: int, users: dict, page_root: Optional[str] = None,
                 redirect: Optional[str] = None, kcp: bool = False,
                 resolve=None):
        self.alias = alias
        self.loop = loop
        self.users = dict(users)
        self.pages = PageProvider(page_root)
        self.redirect = redirect
        self.resolve = resolve or _default_resolve
        self.sessions = 0
        self.tunneled = 0  # cumulative established tunnels
        self.accepted = 0
        self.bind_ip = bind_ip
        self.bind_port = bind_port
        self.want_kcp = kcp
        self.tcp: Optional[ServerSock] = None
        self.udp: Optional[UdpServer] = None
        self.started = False

    def start(self) -> None:
        if self.started:
            return
        self.tcp = self.loop.call_sync(lambda: ServerSock(
            self.loop, self.bind_ip, self.bind_port, self._on_accept))
        if self.bind_port == 0:
            self.bind_port = self.tcp.port
        if self.want_kcp:
            self.udp = self.loop.call_sync(lambda: UdpServer(
                self.loop, self.bind_ip, self.bind_port, self._on_kcp))
        self.started = True

    def stop(self) -> None:
        if not self.started:
            return
        self.started = False
        if self.tcp is not None:
            self.loop.run_on_loop(self.tcp.close)
            self.tcp = None
        if self.udp is not None:
            self.udp.close()
            self.udp = None

    # --------------------------------------------------------- TCP front

    def _on_accept(self, fd: int, ip: str, port: int) -> None:
        self.accepted += 1
        conn = Connection(self.loop, fd, (ip, port))
        dup = _Duplex(conn.write, conn.close, conn=conn)
        sess = _Session(self, self.loop, dup)

        class Front(Handler):
            def on_data(self, c: Connection, data: bytes) -> None:
                sess.on_data(data)

            def on_eof(self, c: Connection) -> None:
                sess.close()

            def on_closed(self, c: Connection, err: int) -> None:
                sess.close()

        conn.set_handler(Front())

    # --------------------------------------------------------- KCP front

    def _on_kcp(self, vconn) -> None:
        self.accepted += 1
        loop = self.loop
        kcp = KcpConn(loop, KCP_CONV, vconn.write)

        def on_stream(stream: Stream) -> None:
            dup = _Duplex(stream.write, stream.close)
            sess = _Session(self, loop, dup)

            class SH(StreamHandler):
                def on_data(self, s, data):
                    sess.on_data(data)

                def on_eof(self, s):
                    sess.close()

                def on_closed(self, s):
                    sess.close()

            stream.set_handler(SH())

        mux = StreamedSession(loop, kcp, is_client=False,
                              on_accept=on_stream)

        class VH:
            def on_data(self, c, data):
                kcp.feed(data)

            def on_closed(self, c, err):
                mux.close()

        vconn.set_handler(VH())
