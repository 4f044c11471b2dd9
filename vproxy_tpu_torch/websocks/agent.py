"""WebSocksProxyAgent — local SOCKS5/HTTP-CONNECT/PAC endpoint that
tunnels selected domains through WebSocks servers.

Parity: vproxyx/WebSocksProxyAgent.java:398 + the connector provider
websocks/WebSocksProxyAgentConnectorProvider.java:826, PAC server
pac/PACHandler.java:145, per-domain rules DomainChecker.java:

* local SOCKS5 front (no auth) and HTTP CONNECT front;
* DomainChecker decides proxy-vs-direct per target (suffix rules,
  ":port" suffixes, regex patterns, wildcard);
* a weighted healthy server list (health checks ride ServerGroup's
  checker exactly like any backend group);
* transport per server: plain TCP or KCP-streamed mux (the agent's
  "UDP over KCP" option); the WebSocks handshake (upgrade + auth +
  10-byte frame + socks5) runs over either;
* plain-TCP tunnels hand both fds to the native splice pump after the
  handshake; KCP tunnels bridge through the stream mux;
* PAC endpoint serving the auto-config script.

The port's copy of vproxy_tpu/websocks/agent.py, same names and behaviour.
"""
from __future__ import annotations

import re
import socket
import struct
from typing import Callable, Optional

from ..components.elgroup import EventLoopGroup
from ..components.servergroup import HealthCheckConfig, ServerGroup
from ..lib.vserver import HttpServer
from ..net.connection import Connection, Handler, ServerSock
from ..net.eventloop import SelectorEventLoop
from ..net.kcp import KcpConn
from ..net.splice import detach_when_drained
from ..net.streamed import Stream, StreamedSession, StreamHandler
from ..net.udp import UdpSock
from ..processors.http1 import HeadParser
from ..utils.log import Logger
from . import common
from .server import KCP_CONV

_log = Logger("websocks-agent")


class DomainChecker:
    """Which targets go through the proxy (DomainChecker.java).

    rules: strings —
      "example.com"      suffix match (and exact)
      ":443"             port suffix rule
      "/regex/"          regex on the hostname
      "*"                everything
    """

    def __init__(self, rules=()):
        self.suffixes: list[str] = []
        self.ports: set[int] = set()
        self.patterns: list[re.Pattern] = []
        self.match_all = False
        for r in rules:
            self.add(r)

    def add(self, rule: str) -> None:
        if rule == "*":
            self.match_all = True
        elif rule.startswith(":"):
            self.ports.add(int(rule[1:]))
        elif len(rule) > 1 and rule.startswith("/") and rule.endswith("/"):
            self.patterns.append(re.compile(rule[1:-1]))
        else:
            self.suffixes.append(rule.lstrip("."))

    def needs_proxy(self, host: str, port: int) -> bool:
        if self.match_all or port in self.ports:
            return True
        for s in self.suffixes:
            if host == s or host.endswith("." + s):
                return True
        return any(p.search(host) for p in self.patterns)


class WebSocksServerRef:
    def __init__(self, host: str, port: int, user: str, password: str,
                 kcp: bool = False, weight: int = 10, tls: bool = False,
                 tls_verify: bool = True,
                 tls_sni: Optional[str] = None):
        self.host = host
        self.port = port
        self.user = user
        self.password = password
        self.kcp = kcp
        self.weight = weight
        self.tls = tls            # wss:// — TLS to the websocks server
        self.tls_verify = tls_verify
        self.tls_sni = tls_sni or host
        self._ctx = None

    def client_ctx(self):
        """One SSLContext per server ref: creating one per tunnel would
        re-load the CA bundle on the loop thread for every connection
        and discard TLS session-resumption state."""
        if self._ctx is None:
            from ..net.tls import client_context
            self._ctx = client_context(verify=self.tls_verify)
        return self._ctx


class _KcpTransport:
    """One shared KCP-streamed session per server; streams carry the
    individual tunnels (the streamed mux reused as agent transport)."""

    def __init__(self, loop: SelectorEventLoop, ref: WebSocksServerRef):
        self.loop = loop
        self.ref = ref
        self.sess: Optional[StreamedSession] = None
        self.sock: Optional[UdpSock] = None

    def stream(self) -> Optional[Stream]:
        if self.sess is None or self.sess.broken:
            self._dial()
        if self.sess is None or self.sess.broken:
            return None
        return self.sess.open_stream()

    def _dial(self) -> None:
        if self.sock is not None:
            self.sock.close()
        try:
            self.sock = UdpSock(self.loop)
        except OSError:
            self.sock = None
            return
        kcp = KcpConn(self.loop, KCP_CONV,
                      lambda d: self.sock.send(d, self.ref.host,
                                               self.ref.port))
        self.sock.on_packet = lambda d, ip, p: kcp.feed(d)
        self.sess = StreamedSession(self.loop, kcp, is_client=True,
                                    on_broken=lambda: None)

    def close(self) -> None:
        if self.sess is not None:
            self.sess.close()
        if self.sock is not None:
            self.sock.close()


class WebSocksProxyAgent:
    def __init__(self, elg: EventLoopGroup, servers: list,
                 proxy_rules=("*",), socks_port: int = 0,
                 http_connect_port: Optional[int] = None,
                 pac_port: Optional[int] = None,
                 hc: Optional[HealthCheckConfig] = None):
        self.elg = elg
        self.loop = elg.next()
        self.checker = DomainChecker(proxy_rules)
        self.refs: dict[str, WebSocksServerRef] = {}
        # health checks ride the standard ServerGroup machinery
        self.group = ServerGroup("websocks-servers", elg,
                                 hc or HealthCheckConfig(), "wrr")
        for i, ref in enumerate(servers):
            self.refs[f"{ref.host}:{ref.port}"] = ref
            self.group.add(f"s{i}", ref.host, ref.port, weight=ref.weight)
        self._kcp: dict[str, _KcpTransport] = {}

        self.socks = self.loop.call_sync(lambda: ServerSock(
            self.loop, "127.0.0.1", socks_port, self._on_socks))
        self.socks_port = self.socks.port
        self.http_connect: Optional[ServerSock] = None
        self.http_connect_port = None
        if http_connect_port is not None:
            self.http_connect = self.loop.call_sync(lambda: ServerSock(
                self.loop, "127.0.0.1", http_connect_port, self._on_connect))
            self.http_connect_port = self.http_connect.port
        self.pac: Optional[HttpServer] = None
        self.pac_port = None
        if pac_port is not None:
            self.pac = HttpServer(self.loop)
            self.pac.get("/pac", self._pac)
            self.pac.get("/proxy.pac", self._pac)
            self.pac.listen(pac_port, "127.0.0.1")
            self.pac_port = self.pac.port

    def close(self) -> None:
        self.loop.run_on_loop(self.socks.close)
        if self.http_connect is not None:
            self.loop.run_on_loop(self.http_connect.close)
        if self.pac is not None:
            self.pac.close()
        for t in self._kcp.values():
            t.close()
        self.group.close()

    # ------------------------------------------------------------ fronts

    def _on_socks(self, fd: int, ip: str, port: int) -> None:
        _SocksFront(self, Connection(self.loop, fd, (ip, port)))

    def _on_connect(self, fd: int, ip: str, port: int) -> None:
        _ConnectFront(self, Connection(self.loop, fd, (ip, port)))

    def _pac(self, rctx) -> None:
        js = ("function FindProxyForURL(url, host) {\n"
              f'  return "SOCKS5 127.0.0.1:{self.socks_port}; '
              f'SOCKS 127.0.0.1:{self.socks_port}";\n}}\n')
        rctx.resp.header("content-type",
                         "application/x-ns-proxy-autoconfig").end(js.encode())

    # ------------------------------------------------------ tunnel setup

    def pick_server(self) -> Optional[WebSocksServerRef]:
        c = self.group.next(b"\x7f\x00\x00\x01")
        if c is None:
            return None
        return self.refs.get(f"{c.ip}:{c.port}")

    def open_tunnel(self, host: str, port: int,
                    cb: Callable[[Optional["_Tunnel"]], None]) -> None:
        """Handshake a tunnel to host:port through a healthy server (or
        direct if the rules say so); cb(tunnel|None) on the agent loop."""
        if not self.checker.needs_proxy(host, port):
            _DirectTunnel.open(self, host, port, cb)
            return
        ref = self.pick_server()
        if ref is None:
            cb(None)
            return
        if ref.kcp:
            t = self._kcp.get(f"{ref.host}:{ref.port}")
            if t is None:
                t = _KcpTransport(self.loop, ref)
                self._kcp[f"{ref.host}:{ref.port}"] = t
            s = t.stream()
            if s is None:
                cb(None)
                return
            _StreamTunnel(self, ref, s, host, port, cb)
        else:
            _TcpTunnel.open(self, ref, host, port, cb)


class _Tunnel:
    """Established path to the target: write()/close() + a data/closed
    sink set by the front; pump_fd() is non-None when the tunnel is a
    plain fd ready for the native pump. Target bytes arriving before
    the sink is attached (e.g. a server that talks first, racing the
    front's reply flush) are buffered, never dropped."""

    def __init__(self):
        self._pending: list[bytes] = []
        self._sink: Optional[Callable[[bytes], None]] = None
        self._closed_cb: Optional[Callable[[], None]] = None
        self._dead = False

    # transports deliver through these
    def _emit(self, data: bytes) -> None:
        if self._sink is not None:
            self._sink(data)
        else:
            self._pending.append(data)

    def _emit_closed(self) -> None:
        self._dead = True
        if self._closed_cb is not None:
            self._closed_cb()

    # fronts consume through these
    def set_sink(self, on_data: Callable[[bytes], None],
                 on_closed: Callable[[], None]) -> None:
        self._sink = on_data
        self._closed_cb = on_closed
        pending, self._pending = self._pending, []
        for d in pending:
            on_data(d)
        if self._dead:
            on_closed()

    def take_pending(self) -> bytes:
        """Drain buffered target bytes (pump-handover path: the caller
        writes them to the front before detaching it)."""
        out = b"".join(self._pending)
        self._pending.clear()
        return out

    def write(self, data: bytes) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def pump_fd(self) -> Optional[int]:
        return None


class _DirectTunnel(_Tunnel):
    @staticmethod
    def open(agent: WebSocksProxyAgent, host: str, port: int, cb) -> None:
        from ..utils.ip import is_ip_literal

        def connect(ip: Optional[str]) -> None:
            if ip is None:
                cb(None)
                return
            try:
                conn = Connection.connect(agent.loop, ip, port)
            except OSError:
                cb(None)
                return
            t = _DirectTunnel()
            t.conn = conn

            class H(Handler):
                def on_connected(self, c):
                    cb(t)

                def on_data(self, c, data):
                    t._emit(data)

                def on_closed(self, c, err):
                    t._emit_closed()

                def on_eof(self, c):
                    t._emit_closed()

            conn.set_handler(H())

        if is_ip_literal(host):
            connect(host)
        else:
            def work():
                try:
                    ip = socket.getaddrinfo(
                        host, None, type=socket.SOCK_STREAM)[0][4][0]
                except OSError:
                    ip = None
                agent.loop.run_on_loop(lambda: connect(ip))
            import threading
            threading.Thread(target=work, daemon=True).start()

    def write(self, data: bytes) -> None:
        self.conn.write(data)

    def close(self) -> None:
        self.conn.close()

    def pump_fd(self) -> Optional[int]:
        if self.conn.closed or self.conn.detached or self.conn.out:
            return None
        return self.conn.detach()


def _socks5_connect_req(host: str, port: int) -> bytes:
    """Greeting (no-auth) + CONNECT in one packet (combined packets are
    explicitly allowed by the spec)."""
    try:
        a4 = socket.inet_pton(socket.AF_INET, host)
        addr = b"\x01" + a4
    except OSError:
        try:
            a6 = socket.inet_pton(socket.AF_INET6, host)
            addr = b"\x04" + a6
        except OSError:
            hb = host.encode("idna" if any(ord(ch) > 127 for ch in host)
                             else "latin-1")
            addr = b"\x03" + bytes([len(hb)]) + hb
    return (b"\x05\x01\x00" +
            b"\x05\x01\x00" + addr + struct.pack(">H", port))


class _HandshakeMachine:
    """Client-side WebSocks handshake over any duplex. Sends the
    upgrade at construction; on 101 sends the 10-byte frame + the
    combined socks5 greeting/CONNECT (combined packets are explicitly
    allowed AFTER the upgrade round trip); then parses the server's
    10-byte frame, method choice and reply. Calls done(ok, leftover)."""

    ST_HTTP, ST_FRAME10, ST_METHOD, ST_REPLY, ST_DONE = range(5)

    def __init__(self, ref: WebSocksServerRef,
                 write: Callable[[bytes], None], socks_payload: bytes, done):
        self.write = write
        self.done = done
        self.payload = socks_payload
        self.buf = bytearray()
        self.state = self.ST_HTTP
        self.write(common.upgrade_request(ref.host, ref.user, ref.password))

    def feed(self, data: bytes) -> None:
        self.buf += data
        if self.state == self.ST_HTTP:
            i = self.buf.find(b"\r\n\r\n")
            if i < 0:
                return
            head = bytes(self.buf[:i])
            del self.buf[: i + 4]
            if b" 101 " not in head.split(b"\r\n", 1)[0]:
                self._fail()
                return
            self.write(common.MAX_PAYLOAD_FRAME + self.payload)
            self.state = self.ST_FRAME10
        if self.state == self.ST_FRAME10:
            while len(self.buf) >= 2 and self.buf[0] == 0x8A:
                del self.buf[:2]  # unsolicited PONG
            if len(self.buf) < 10:
                return
            del self.buf[:10]
            self.state = self.ST_METHOD
        if self.state == self.ST_METHOD:
            if len(self.buf) < 2:
                return
            if self.buf[0] != 5 or self.buf[1] != 0:
                self._fail()
                return
            del self.buf[:2]
            self.state = self.ST_REPLY
        if self.state == self.ST_REPLY:
            if len(self.buf) < 4:
                return
            if self.buf[1] != 0:
                self._fail()
                return
            atyp = self.buf[3]
            need = 4 + (4 if atyp == 1 else 16 if atyp == 4 else
                        1 + self.buf[4] if len(self.buf) > 4 else 256) + 2
            if len(self.buf) < need:
                return
            del self.buf[:need]
            self.state = self.ST_DONE
            self.done(True, bytes(self.buf))

    def _fail(self) -> None:
        self.state = self.ST_DONE
        self.done(False, b"")


class _TcpTunnel(_Tunnel):
    """Plain-TCP or TLS (wss) transport to the websocks server. In TLS
    mode `self.conn` is the TlsSocket (same write/close surface) and the
    tunnel never upgrades to the native pump — the TLS state lives in
    Python (WebSocksProxyAgentConnectorProvider.java:826's SSL branch).
    """

    @staticmethod
    def open(agent: WebSocksProxyAgent, ref: WebSocksServerRef,
             host: str, port: int, cb) -> None:
        try:
            raw = Connection.connect(agent.loop, ref.host, ref.port)
        except OSError:
            cb(None)
            return
        if ref.tls:
            from ..net.tls import TlsSocket
            conn = TlsSocket(raw, ref.client_ctx(),
                             server_side=False, server_hostname=ref.tls_sni)
        else:
            conn = raw
        t = _TcpTunnel()
        t.conn = conn
        t._tls = ref.tls
        hs_req = _socks5_connect_req(host, port)

        class H(Handler):
            def __init__(self):
                self.hs: Optional[_HandshakeMachine] = None
                self.notified = False  # cb fired (tunnel or None)

            def on_connected(self, c):
                self.hs = _HandshakeMachine(ref, c.write, hs_req,
                                            self._done)

            def _done(self, ok: bool, leftover: bytes) -> None:
                # hs cleared FIRST: c.close() below re-enters via
                # on_closed -> _dead, which must not re-run the machine
                self.hs = None
                if self.notified:
                    return
                self.notified = True
                if not ok:
                    c = t.conn
                    t.conn = None
                    if c is not None:
                        c.close()
                    cb(None)
                    return
                if leftover:
                    t._emit(leftover)
                cb(t)

            def on_data(self, c, data):
                if self.hs is not None:
                    self.hs.feed(data)
                else:
                    t._emit(data)

            def on_eof(self, c):
                self._dead()

            def on_closed(self, c, err):
                self._dead()

            def _dead(self):
                if self.hs is not None:
                    hs, self.hs = self.hs, None
                    hs.done(False, b"")
                elif not self.notified:
                    # died before the handshake even started (TCP
                    # refusal after connect(), TLS handshake/verify
                    # failure) — the front must still hear about it
                    self.notified = True
                    cb(None)
                else:
                    t._emit_closed()

        conn.set_handler(H())

    def write(self, data: bytes) -> None:
        if self.conn is not None:
            self.conn.write(data)

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()

    def pump_fd(self) -> Optional[int]:
        if getattr(self, "_tls", False):
            return None  # TLS state is Python-resident: no pump handover
        if self.conn is None or self.conn.closed or self.conn.detached \
                or self.conn.out:
            return None
        return self.conn.detach()


class _StreamTunnel(_Tunnel):
    def __init__(self, agent, ref, stream: Stream, host, port, cb):
        super().__init__()
        self.stream = stream
        self.cb = cb
        self.hs: Optional[_HandshakeMachine] = None
        tun = self

        class SH(StreamHandler):
            def on_data(self, s, data):
                if tun.hs is not None:
                    tun.hs.feed(data)
                else:
                    tun._emit(data)

            def on_eof(self, s):
                self.on_closed(s)

            def on_closed(self, s):
                if tun.hs is not None:
                    hs, tun.hs = tun.hs, None
                    hs.done(False, b"")
                else:
                    tun._emit_closed()

        stream.set_handler(SH())
        # client-opened streams are writable immediately (optimistic SYN)
        self.hs = _HandshakeMachine(ref, stream.write,
                                    _socks5_connect_req(host, port),
                                    self._done)

    def _done(self, ok: bool, leftover: bytes) -> None:
        self.hs = None
        cb, self.cb = self.cb, None
        if not ok:
            self.stream.close()
            if cb:
                cb(None)
            return
        if leftover:
            self._emit(leftover)
        if cb:
            cb(self)

    def write(self, data: bytes) -> None:
        self.stream.write(data)

    def close(self) -> None:
        self.stream.close()


class _SocksFront(Handler):
    """Local SOCKS5 server (no auth) in front of open_tunnel."""

    ST_GREET, ST_REQ, ST_TUNNEL = range(3)

    def __init__(self, agent: WebSocksProxyAgent, conn: Connection):
        self.agent = agent
        self.conn = conn
        self.buf = bytearray()
        self.state = self.ST_GREET
        self.tunnel: Optional[_Tunnel] = None
        conn.set_handler(self)

    def on_data(self, conn, data):
        self.buf += data
        if self.state == self.ST_GREET and len(self.buf) >= 2:
            n = self.buf[1]
            if self.buf[0] != 5 or len(self.buf) < 2 + n:
                if self.buf[0] != 5:
                    conn.close()
                return
            methods = self.buf[2:2 + n]
            del self.buf[:2 + n]
            if 0 not in methods:
                conn.write(b"\x05\xff")
                conn.close()
                return
            conn.write(b"\x05\x00")
            self.state = self.ST_REQ
        if self.state == self.ST_REQ and len(self.buf) >= 4:
            ver, cmd, _rsv, atyp = self.buf[:4]
            if atyp == 1:
                need = 10
            elif atyp == 4:
                need = 22
            elif atyp == 3:
                if len(self.buf) < 5:
                    return
                need = 7 + self.buf[4]
            else:
                conn.close()
                return
            if len(self.buf) < need:
                return
            if cmd != 1:
                conn.write(b"\x05\x07\x00\x01" + b"\x00" * 6)
                conn.close()
                return
            if atyp == 3:
                host = bytes(self.buf[5:5 + self.buf[4]]).decode("latin-1")
                port = struct.unpack(">H", self.buf[need - 2:need])[0]
            else:
                alen = 4 if atyp == 1 else 16
                host = socket.inet_ntop(
                    socket.AF_INET if alen == 4 else socket.AF_INET6,
                    bytes(self.buf[4:4 + alen]))
                port = struct.unpack(">H", self.buf[need - 2:need])[0]
            del self.buf[:need]
            self.state = self.ST_TUNNEL
            conn.pause_reading()
            self.agent.open_tunnel(host, port, self._up)
        elif self.state == self.ST_TUNNEL and self.tunnel is not None:
            self.tunnel.write(bytes(self.buf))
            self.buf.clear()

    def _up(self, tunnel: Optional[_Tunnel]) -> None:
        if tunnel is None:
            if not self.conn.closed:
                self.conn.write(b"\x05\x05\x00\x01" + b"\x00" * 6)
                self.conn.close_graceful()
            return
        if self.conn.closed:
            tunnel.close()
            return
        self.tunnel = tunnel
        self.conn.write(b"\x05\x00\x00\x01" + b"\x00" * 6)
        early = bytes(self.buf)
        self.buf.clear()
        if early:
            tunnel.write(early)
        # both sides plain fds -> native pump
        pfd = tunnel.pump_fd()
        if pfd is not None:
            loop = self.agent.loop
            self.conn.write(tunnel.take_pending())

            def go(ffd: int) -> None:
                from ..net import vtl
                if not vtl.pump_sets_nodelay():  # an older prebuilt .so only
                    vtl.set_nodelay(ffd)
                    vtl.set_nodelay(pfd)
                loop.pump(ffd, pfd, 65536, None)

            detach_when_drained(self.conn, go)
            return
        # stream tunnel: python bridge
        front = self.conn
        tunnel.set_sink(front.write, front.close)
        front.resume_reading()

    def on_eof(self, conn):
        if self.tunnel is not None:
            self.tunnel.close()
        conn.close()

    def on_closed(self, conn, err):
        if self.tunnel is not None:
            self.tunnel.close()


class _ConnectFront(Handler):
    """HTTP CONNECT front (the agent's http-connect gateway)."""

    def __init__(self, agent: WebSocksProxyAgent, conn: Connection):
        self.agent = agent
        self.conn = conn
        self.parser = HeadParser()
        self.tunnel: Optional[_Tunnel] = None
        self.established = False
        conn.set_handler(self)

    def on_data(self, conn, data):
        if self.established and self.tunnel is not None:
            self.tunnel.write(data)
            return
        self.parser.feed(data)
        if self.parser.error:
            conn.close()
            return
        if not self.parser.done:
            return
        if self.parser.method != "CONNECT":
            conn.write(b"HTTP/1.1 405 Method Not Allowed\r\n"
                       b"content-length: 0\r\n\r\n")
            conn.close_graceful()
            return
        hostport = self.parser.uri
        host, _, p = hostport.rpartition(":")
        try:
            port = int(p)
        except ValueError:
            conn.close()
            return
        host = host.strip("[]")
        conn.pause_reading()
        self.early = bytes(self.parser.buf)[self.parser.head_len:]
        self.agent.open_tunnel(host, port, self._up)

    def _up(self, tunnel: Optional[_Tunnel]) -> None:
        if tunnel is None:
            if not self.conn.closed:
                self.conn.write(b"HTTP/1.1 502 Bad Gateway\r\n"
                                b"content-length: 0\r\n\r\n")
                self.conn.close_graceful()
            return
        if self.conn.closed:
            tunnel.close()
            return
        self.tunnel = tunnel
        self.established = True
        self.conn.write(b"HTTP/1.1 200 Connection Established\r\n\r\n")
        if self.early:
            tunnel.write(self.early)
        pfd = tunnel.pump_fd()
        if pfd is not None:
            loop = self.agent.loop
            self.conn.write(tunnel.take_pending())

            def go(ffd: int) -> None:
                from ..net import vtl
                if not vtl.pump_sets_nodelay():  # an older prebuilt .so only
                    vtl.set_nodelay(ffd)
                    vtl.set_nodelay(pfd)
                loop.pump(ffd, pfd, 65536, None)

            detach_when_drained(self.conn, go)
            return
        front = self.conn
        tunnel.set_sink(front.write, front.close)
        front.resume_reading()

    def on_eof(self, conn):
        if self.tunnel is not None:
            self.tunnel.close()
        conn.close()

    def on_closed(self, conn, err):
        if self.tunnel is not None:
            self.tunnel.close()
