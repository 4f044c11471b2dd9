"""Embeddable async HTTP/1.x server with express-style routing.

Parity: lib vserver (HttpServer.java:5 get/pst/put/del routing with
`:param` sub-paths route/*, Http1ServerImpl.java:460): handlers are
callbacks on the event loop; routes match by segments with `:name`
captures and `*` wildcards; the first matching route wins; keep-alive
connections serve sequential requests.

The port's copy of vproxy_tpu/lib/vserver.py, same names and behaviour.
"""
from __future__ import annotations

import json
from typing import Callable, Optional
from urllib.parse import parse_qs, unquote

from ..net.connection import Connection, Handler, ServerSock
from ..net.eventloop import SelectorEventLoop
from ..processors.http1 import HeadParser

# inbound body cap: requests to the control surface / embedded servers
# must not balloon memory on a huge (or garbage) content-length
MAX_BODY = 16 * 1024 * 1024

REASONS = {200: "OK", 201: "Created", 204: "No Content", 301: "Moved Permanently",
           302: "Found", 400: "Bad Request", 401: "Unauthorized",
           403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
           500: "Internal Server Error", 503: "Service Unavailable"}


class Request:
    def __init__(self, parser: HeadParser, body: bytes, params: dict,
                 query: dict):
        self.method = parser.method
        self.uri = parser.uri
        self.headers = parser.headers
        self.body = body
        self.params = params  # :name captures
        self.query = query

    def header(self, name: str) -> Optional[str]:
        for k, v in self.headers:
            if k == name.lower():
                return v
        return None

    def json(self):
        return json.loads(self.body or b"{}")


class Response:
    def __init__(self, rctx: "RoutingContext"):
        self._rctx = rctx
        self.status_code = 200
        self.headers: list[tuple[str, str]] = []

    def status(self, code: int) -> "Response":
        self.status_code = code
        return self

    def header(self, k: str, v: str) -> "Response":
        self.headers.append((k, v))
        return self

    def end(self, body=b"") -> None:
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
            if not any(k.lower() == "content-type" for k, _ in self.headers):
                self.headers.append(("content-type", "application/json"))
        elif isinstance(body, str):
            body = body.encode()
        self._rctx._finish(self.status_code, self.headers, body)


class RoutingContext:
    def __init__(self, server: "HttpServer", conn: Connection, req: Request,
                 close_after: bool = False):
        self.server = server
        self.conn = conn
        self.req = req
        self.resp = Response(self)
        self._done = False
        # `connection: close` requests tear down here, after the response
        # is actually written — handlers may finish asynchronously
        self._close_after = close_after

    def _finish(self, status: int, headers: list, body: bytes) -> None:
        if self._done:
            return
        self._done = True
        reason = REASONS.get(status, "OK")
        head = f"HTTP/1.1 {status} {reason}\r\n"
        names = {k.lower() for k, _ in headers}
        if "content-length" not in names:
            headers = list(headers) + [("content-length", str(len(body)))]
        for k, v in headers:
            head += f"{k}: {v}\r\n"
        head += "\r\n"
        self.conn.write(head.encode() + body)
        self.server._request_done(self.conn)
        if self._close_after:
            self.conn.close_graceful()


def _match(route: str, path: str) -> Optional[dict]:
    """`/a/:id/b` style matching; `*` matches the rest."""
    rsegs = [s for s in route.split("/") if s]
    psegs = [s for s in path.split("/") if s]
    params: dict = {}
    i = 0
    for i, rs in enumerate(rsegs):
        if rs == "*":
            params["*"] = "/".join(psegs[i:])
            return params
        if i >= len(psegs):
            return None
        if rs.startswith(":"):
            params[rs[1:]] = unquote(psegs[i])
        elif rs != psegs[i]:
            return None
    if len(psegs) != len(rsegs):
        return None
    return params


class HttpServer:
    def __init__(self, loop: SelectorEventLoop):
        self.loop = loop
        self.routes: list[tuple[str, str, Callable]] = []  # (method, path, fn)
        self._srv: Optional[ServerSock] = None
        self._conns: set[Connection] = set()
        self.port = 0

    # ----------------------------------------------------------- routing

    def route(self, method: str, path: str, fn: Callable) -> "HttpServer":
        self.routes.append((method.upper(), path, fn))
        return self

    def get(self, path: str, fn) -> "HttpServer":
        return self.route("GET", path, fn)

    def post(self, path: str, fn) -> "HttpServer":
        return self.route("POST", path, fn)

    def put(self, path: str, fn) -> "HttpServer":
        return self.route("PUT", path, fn)

    def delete(self, path: str, fn) -> "HttpServer":
        return self.route("DELETE", path, fn)

    def all(self, path: str, fn) -> "HttpServer":
        return self.route("*", path, fn)

    # ---------------------------------------------------------- lifecycle

    def listen(self, port: int, ip: str = "127.0.0.1") -> "HttpServer":
        def mk() -> None:
            self._srv = ServerSock(self.loop, ip, port, self._accept)
            self.port = self._srv.port
        self.loop.call_sync(mk)
        return self

    def listen_unix(self, path: str) -> "HttpServer":
        """Serve over a unix-domain socket (used by the docker
        libnetwork plugin — DockerNetworkPluginController.java:56)."""
        def mk() -> None:
            self._srv = ServerSock.unix(self.loop, path, self._accept)
        self.loop.call_sync(mk)
        return self

    def close(self, sync: bool = False) -> None:
        """sync=True blocks until the listener is closed (and a unix
        socket path unlinked) — callers reporting completion to an
        operator need the fd gone, not merely scheduled to go."""
        if self._srv is not None:
            srv, self._srv = self._srv, None

            def shut() -> None:
                srv.close()
                for c in list(self._conns):
                    c.close_graceful()
                self._conns.clear()
            if sync:
                self.loop.call_sync(shut)
            else:
                self.loop.run_on_loop(shut)

    # ---------------------------------------------------------- internals

    def _accept(self, fd: int, ip: str, port: int) -> None:
        conn = Connection(self.loop, fd, (ip, port))
        self._conns.add(conn)
        _HttpSrvConn(self, conn)

    def _request_done(self, conn: Connection) -> None: ...

    def _dispatch(self, conn: Connection, parser: HeadParser,
                  body: bytes, close_after: bool = False) -> None:
        path, _, qs = (parser.uri or "/").partition("?")
        query = {k: v[-1] for k, v in parse_qs(qs).items()}
        for method, route, fn in self.routes:
            if method != "*" and method != parser.method:
                continue
            params = _match(route, path)
            if params is None:
                continue
            rctx = RoutingContext(self, conn, Request(parser, body, params,
                                                      query), close_after)
            try:
                fn(rctx)
            except Exception as e:  # handler error -> 500
                if not rctx._done:
                    rctx.resp.status(500).end({"error": f"{type(e).__name__}: {e}"})
            return
        rctx = RoutingContext(self, conn, Request(parser, body, {}, query),
                              close_after)
        rctx.resp.status(404).end({"error": f"Cannot {parser.method} {path}"})


class _HttpSrvConn(Handler):
    def __init__(self, server: HttpServer, conn: Connection):
        self.server = server
        self.conn = conn
        self.parser = HeadParser()
        self.buf = bytearray()
        conn.set_handler(self)

    def on_data(self, conn: Connection, data: bytes) -> None:
        self.buf += data
        self._drive()

    def _drive(self) -> None:
        while True:
            if not self.parser.done:
                if not self.buf:
                    return
                self.parser.feed(bytes(self.buf))
                self.buf.clear()
                if self.parser.error:
                    self.conn.write(
                        b"HTTP/1.1 400 Bad Request\r\n"
                        b"content-length: 0\r\nconnection: close\r\n\r\n")
                    # peer may still be streaming: drain, don't RST
                    self.conn.close_draining()
                    return
                if not self.parser.done:
                    return
            elif self.buf:
                # head already parsed: bytes accumulate as body
                self.parser.buf += self.buf
                self.buf.clear()
            # chunked is unsupported here: a request bearing
            # transfer-encoding would be framed as length-0 and its body
            # parsed as the NEXT request (TE.CL desync) — reject it
            if self.parser.header("transfer-encoding") is not None:
                self.conn.write(b"HTTP/1.1 501 Not Implemented\r\n"
                                b"content-length: 0\r\n"
                                b"connection: close\r\n\r\n")
                self.conn.close_draining()
                return
            # strict 1*DIGIT and NO disagreeing duplicates (RFC 9110):
            # int()'s leniency ('+16', '1_6') or picking one of two
            # different content-lengths would disagree with a front
            # proxy on framing — a request-smuggling vector
            cls_ = {v for k, v in self.parser.headers
                    if k == "content-length"}
            if not cls_:
                cl = 0
            elif len(cls_) == 1:
                cl_s = next(iter(cls_))
                cl = (int(cl_s) if cl_s.isascii() and cl_s.isdigit()
                      else -1)
            else:
                cl = -1
            if cl < 0 or cl > MAX_BODY:
                code = (b"400 Bad Request" if cl < 0
                        else b"413 Payload Too Large")
                self.conn.write(b"HTTP/1.1 " + code +
                                b"\r\ncontent-length: 0\r\n"
                                b"connection: close\r\n\r\n")
                self.conn.close_draining()
                return
            have = len(self.parser.buf) - self.parser.head_len
            if have < cl:
                return
            total = self.parser.head_len + cl
            body = bytes(self.parser.buf[self.parser.head_len:total])
            leftover = bytes(self.parser.buf[total:])
            parser = self.parser
            self.parser = HeadParser()
            self.buf = bytearray(leftover)
            close = "close" in (parser.header("connection") or "").lower()
            self.server._dispatch(self.conn, parser, body, close)
            if close:
                return  # conn closes in _finish once the response is out

    def on_eof(self, conn: Connection) -> None:
        conn.close()

    def on_closed(self, conn: Connection, err: int) -> None:
        self.server._conns.discard(conn)
