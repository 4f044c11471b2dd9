"""Socket-style API over the user-space TCP stack.

The port of `vproxy_tpu/vswitch/fds.py`, same names and behaviour.

Parity: core vswitch/stack/fd (VSwitchFDs/VSwitchSocketFD/
VSwitchServerSocketFD — stack/fd/VSwitchSocketFD.java:274): components
can listen and connect INSIDE a VPC of the virtual switch. The surface
mirrors net/connection.py's handler style so code written against
Connection/ServerSock ports over with a one-line change.

All callbacks fire on the switch's event loop thread.
"""
from __future__ import annotations

from typing import Callable, Optional

from .switch import Switch, synthetic_mac
from .tcp import L4, TcpConn, TcpHandler


def get_l4(sw: Switch) -> L4:
    if sw.stack.l4 is None:
        L4(sw)
    return sw.stack.l4


class VServerSock:
    """Listen on ip:port inside a VPC. The listen ip is added as a
    synthetic ip (the switch answers ARP for it)."""

    def __init__(self, sw: Switch, vni: int, ip: bytes, port: int,
                 on_accept: Callable[["VConn"], None]):
        self.sw = sw
        net = sw.networks.get(vni)
        if net is None:
            raise OSError(f"no vpc {vni}")
        self.net = net
        self.ip = ip
        self.port = port
        if net.ips.lookup_mac(ip) is None:
            net.ips.add(ip, synthetic_mac(vni, ip))
        self.l4 = get_l4(sw)
        self._on_accept = on_accept
        self.l4.conntrack(net).listen(ip, port, self._accept)
        self.closed = False

    def _accept(self, conn: TcpConn) -> None:
        vc = VConn(conn, connected=True)
        self._on_accept(vc)
        if vc.handler is not None:
            vc.handler.on_connected(vc)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self.l4.conntrack(self.net).stop_listen(self.ip, self.port)


class VConn:
    """Connection-style wrapper over a user-space TcpConn."""

    def __init__(self, conn: TcpConn, connected: bool):
        self.conn = conn
        self.connected = connected
        self.handler = None  # object with on_data/on_eof/on_closed/...
        self.closed = False
        conn.set_handler(_Adapter(self))

    @classmethod
    def connect(cls, sw: Switch, vni: int, local_ip: bytes,
                remote_ip: bytes, remote_port: int) -> "VConn":
        net = sw.networks.get(vni)
        if net is None:
            raise OSError(f"no vpc {vni}")
        if net.ips.lookup_mac(local_ip) is None:
            net.ips.add(local_ip, synthetic_mac(vni, local_ip))
        l4 = get_l4(sw)
        conn = l4.connect(net, local_ip, (remote_ip, remote_port))
        return cls(conn, connected=False)

    @property
    def remote(self):
        return self.conn.remote

    @property
    def local(self):
        return self.conn.local

    def set_handler(self, h) -> None:
        self.handler = h

    def write(self, data: bytes) -> None:
        self.conn.write(data)

    @property
    def out(self) -> bytes:
        """Unsent bytes (backpressure signal, like Connection.out)."""
        return self.conn.pending

    def shutdown_write(self) -> None:
        self.conn.shutdown_write()

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self.conn.close()

    def abort(self) -> None:
        self.conn.abort()


class _Adapter(TcpHandler):
    def __init__(self, v: VConn):
        self.v = v

    def on_connected(self, conn: TcpConn) -> None:
        self.v.connected = True
        if self.v.handler is not None:
            self.v.handler.on_connected(self.v)

    def on_data(self, conn: TcpConn, data: bytes) -> None:
        if self.v.handler is not None:
            self.v.handler.on_data(self.v, data)

    def on_eof(self, conn: TcpConn) -> None:
        if self.v.handler is not None:
            self.v.handler.on_eof(self.v)

    def on_closed(self, conn: TcpConn) -> None:
        self.v.closed = True
        if self.v.handler is not None:
            self.v.handler.on_closed(self.v, 0)

    def on_drained(self, conn: TcpConn) -> None:
        if self.v.handler is not None:
            self.v.handler.on_drained(self.v)
