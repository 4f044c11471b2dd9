"""UDP datagram sockets + a UDP server that emulates accept().

Parity: reference `selector/wrap/udp` — `ServerDatagramFD.java:350`
(`VirtualDatagramFD:186`), `UDPFDs`: one bound datagram socket serves
many remotes; each new remote address materializes a virtual
connection-like object delivered through an accept callback, with its
own receive queue, idle expiry and sendto-backed writes.

Everything runs on one SelectorEventLoop thread; the API mirrors
net/connection.py's handler style so protocol code written against
Connection ports over unchanged.

The port's copy of vproxy_tpu/net/udp.py, same names and behaviour.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Optional, Tuple

from . import vtl
from .eventloop import SelectorEventLoop

# reference: Config.udpTimeout = 5 min (vproxybase/Config.java:24)
DEFAULT_IDLE_MS = 5 * 60 * 1000


class UdpSock:
    """Plain nonblocking datagram socket registered on a loop.

    on_packet(data, ip, port) fires on the loop thread for every
    datagram. Unbound client sockets pass port=0.
    """

    def __init__(self, loop: SelectorEventLoop, ip: str = "", port: int = 0,
                 on_packet: Optional[Callable[[bytes, str, int], None]] = None,
                 v6: bool = False, reuseport: bool = False):
        self.loop = loop
        self.on_packet = on_packet
        self.closed = False

        def mk() -> None:
            if ip:
                self.fd = vtl.udp_bind(ip, port, reuseport)
            else:
                self.fd = vtl.udp_socket(v6)
            self.local = vtl.sock_name(self.fd)
            loop.add(self.fd, vtl.EV_READ, self._on_readable)
        loop.call_sync(mk)

    def _on_readable(self, fd: int, ev: int) -> None:
        while not self.closed:
            r = vtl.recvfrom(fd)
            if r is None:
                return
            data, ip, port = r
            if self.on_packet is not None:
                self.on_packet(data, ip, port)

    def send(self, data: bytes, ip: str, port: int) -> None:
        if not self.closed:
            vtl.sendto(self.fd, data, ip, port)  # drop on EAGAIN (UDP)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True

        def rm() -> None:
            if self.loop.registered(self.fd):
                self.loop.remove(self.fd)
            vtl.close(self.fd)
        self.loop.run_on_loop(rm)


class UdpVirtualConn:
    """One remote peer of a UdpServer, shaped like a Connection.

    handler needs on_data(conn, data) and on_closed(conn, err); writes
    are sendto() on the shared server socket.
    """

    # datagrams buffered while no handler is attached; beyond this they
    # are dropped (UDP semantics), bounding memory against floods
    PENDING_MAX = 256

    def __init__(self, server: "UdpServer", ip: str, port: int):
        self.server = server
        self.remote = (ip, port)
        self.handler = None
        self.closed = False
        self._pending: deque = deque()
        self._touch()

    def _touch(self) -> None:
        self.last_active = self.server.loop.now

    def set_handler(self, h) -> None:
        self.handler = h
        while self._pending and not self.closed:
            h.on_data(self, self._pending.popleft())

    def _deliver(self, data: bytes) -> None:
        self._touch()
        if self.handler is None:
            if len(self._pending) < self.PENDING_MAX:
                self._pending.append(data)
        else:
            self.handler.on_data(self, data)

    def write(self, data: bytes) -> None:
        if not self.closed:
            self._touch()
            self.server.sock.send(data, self.remote[0], self.remote[1])

    def close(self, err: int = 0) -> None:
        if self.closed:
            return
        self.closed = True
        self.server._conns.pop(self.remote, None)
        if self.handler is not None:
            self.handler.on_closed(self, err)


class UdpServer:
    """accept()-emulating UDP server (reference ServerDatagramFD).

    New remote (ip, port) -> on_accept(UdpVirtualConn); datagrams for a
    known remote go to that conn's handler. Idle conns expire after
    idle_ms (sweep every idle_ms/4).
    """

    def __init__(self, loop: SelectorEventLoop, ip: str, port: int,
                 on_accept: Callable[[UdpVirtualConn], None],
                 idle_ms: int = DEFAULT_IDLE_MS, reuseport: bool = False):
        self.loop = loop
        self.on_accept = on_accept
        self.idle_ms = idle_ms
        self._conns: Dict[Tuple[str, int], UdpVirtualConn] = {}
        self.closed = False
        self.sock = UdpSock(loop, ip, port, self._on_packet,
                            reuseport=reuseport)
        self.local = self.sock.local
        sweep = max(250, idle_ms // 4)
        self._sweeper = None

        def arm() -> None:
            if not self.closed:  # close() may have raced the deferred arm
                self._sweeper = loop.period(sweep, self._expire)
        loop.run_on_loop(arm)

    def _on_packet(self, data: bytes, ip: str, port: int) -> None:
        key = (ip, port)
        conn = self._conns.get(key)
        if conn is None:
            conn = UdpVirtualConn(self, ip, port)
            self._conns[key] = conn
            self.on_accept(conn)
        conn._deliver(data)

    def _expire(self) -> None:
        dead = [c for c in self._conns.values()
                if self.loop.now - c.last_active > self.idle_ms / 1000.0]
        for c in dead:
            c.close()

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if self._sweeper is not None:
            self.loop.run_on_loop(self._sweeper.cancel)
        for c in list(self._conns.values()):
            c.close()
        self.sock.close()
