"""KcpTun — TCP-over-KCP tunnel client/server.

Parity: reference `vproxyx/KcpTun.java:199` (`doc/vproxy-kcp-tunnel.md`):
the client listens on TCP and multiplexes every accepted connection as
a stream over one KCP/UDP session to the server; the server terminates
streams by connecting to a fixed TCP target. Transport = net/streamed
over net/kcp over net/udp.

Usage:
  python -m vproxy_tpu_torch kcptun server <udp-port> <target-ip:port>
  python -m vproxy_tpu_torch kcptun client <tcp-port> <server-ip:port>

The port's copy of vproxy_tpu/apps/kcptun.py, same names and
behaviour; run() prints the ports it bound (port 0 asks for a free
one) and exits 0 on SIGTERM as on SIGINT, its loop closed.
"""
from __future__ import annotations

import sys
from typing import List, Optional

from ..net.connection import Connection, Handler, ServerSock
from ..net.eventloop import SelectorEventLoop
from ..net.kcp import KcpConn
from ..net.streamed import Stream, StreamedSession, StreamHandler
from ..net.udp import UdpServer, UdpSock
from .helloworld import wait_for_stop

CONV = 0x76707478  # arbitrary fixed conv both sides agree on ("vptx")


class _TcpSide(Handler):
    """TCP half of a bridge: forwards to the stream."""

    def __init__(self, stream: Stream):
        self.stream = stream

    def on_data(self, conn, data):
        self.stream.write(data)

    def on_eof(self, conn):
        self.stream.close_graceful()

    def on_closed(self, conn, err):
        self.stream.close()


class _StreamSide(StreamHandler):
    """Stream half of a bridge: forwards to the TCP connection."""

    def __init__(self):
        self.conn: Optional[Connection] = None
        self._early: list[bytes] = []

    def attach(self, conn: Connection) -> None:
        self.conn = conn
        for d in self._early:
            conn.write(d)
        self._early.clear()

    def on_data(self, s, data):
        if self.conn is None:
            self._early.append(data)
        else:
            self.conn.write(data)

    def on_eof(self, s):
        if self.conn is not None:
            self.conn.close_graceful()

    def on_closed(self, s):
        if self.conn is not None:
            self.conn.close()


def run_server(loop: SelectorEventLoop, udp_port: int, target_ip: str,
               target_port: int) -> UdpServer:
    def on_udp_accept(vconn):
        kcp = KcpConn(loop, CONV, vconn.write)

        def on_stream(stream: Stream) -> None:
            sh = _StreamSide()
            stream.set_handler(sh)
            try:
                conn = Connection.connect(loop, target_ip, target_port)
            except OSError:
                stream.close()
                return
            conn.set_handler(_TcpSide(stream))
            sh.attach(conn)

        sess = StreamedSession(loop, kcp, is_client=False,
                               on_accept=on_stream)

        class VH:
            def on_data(self, c, data):
                kcp.feed(data)

            def on_closed(self, c, err):
                sess.close()
        vconn.set_handler(VH())

    return UdpServer(loop, "0.0.0.0", udp_port, on_udp_accept)


class TunClient:
    def __init__(self, loop: SelectorEventLoop, tcp_port: int,
                 server_ip: str, server_port: int, bind_ip: str = "0.0.0.0"):
        self.loop = loop
        self.server = (server_ip, server_port)
        self.sess: Optional[StreamedSession] = None
        self.sock: Optional[UdpSock] = None
        self.closed = False
        self._redial = None
        self._dial()

        self.tcp = loop.call_sync(lambda: ServerSock(
            loop, bind_ip, tcp_port, self._on_accept))
        self.port = self.tcp.port

    def _dial(self) -> None:
        if self.closed:
            return
        self._redial = None
        self.sock = UdpSock(self.loop)
        kcp = KcpConn(self.loop, CONV,
                      lambda d: self.sock.send(d, *self.server))
        self.sock.on_packet = lambda d, ip, p: kcp.feed(d)
        self.sess = StreamedSession(
            self.loop, kcp, is_client=True,
            on_broken=self._on_broken)

    def _on_broken(self) -> None:
        sock, self.sock = self.sock, None
        if sock is not None:
            sock.close()
        if not self.closed:
            self._redial = self.loop.delay(1000, self._dial)  # auto re-dial

    def _on_accept(self, fd: int, ip: str, port: int) -> None:
        conn = Connection(self.loop, fd, (ip, port))
        if self.sess is None or self.sess.broken:
            conn.close()
            return
        sh = _StreamSide()
        stream = self.sess.open_stream(sh)
        conn.set_handler(_TcpSide(stream))
        sh.attach(conn)

    def close(self) -> None:
        self.closed = True
        if self._redial is not None:
            self.loop.run_on_loop(self._redial.cancel)
            self._redial = None
        self.tcp.close()
        if self.sess is not None:
            self.sess.close()
        if self.sock is not None:
            self.sock.close()


def run(argv: List[str]) -> int:
    if len(argv) < 3 or argv[0] not in ("server", "client"):
        print(__doc__, file=sys.stderr)
        return 1
    mode = argv[0]
    port = int(argv[1])
    host, sep, p = argv[2].rpartition(":")
    if not sep or not host or not p.isdigit():
        print(__doc__, file=sys.stderr)
        return 1
    peer = (host, int(p))
    loop = SelectorEventLoop("kcptun")
    loop.loop_thread()
    if mode == "server":
        srv = run_server(loop, port, peer[0], peer[1])
        print(f"kcptun server: udp {srv.local[1]} -> tcp "
              f"{peer[0]}:{peer[1]}", flush=True)
    else:
        cli = TunClient(loop, port, peer[0], peer[1])
        print(f"kcptun client: tcp {cli.port} -> kcp {peer[0]}:{peer[1]}",
              flush=True)
    wait_for_stop()
    loop.close()
    return 0
