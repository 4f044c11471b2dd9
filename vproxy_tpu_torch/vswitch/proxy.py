"""Switch `proxy` resource — in-VPC listener bridged to a host address.

The port of `vproxy_tpu/vswitch/proxy.py`, same names and behaviour.

Parity: vswitch/ProxyHolder (reference `add proxy <ip:port> to vpc N in
switch sw address <target>`): the switch listens on ip:port INSIDE the
VPC via the user-space TCP stack and proxies each accepted virtual
connection to a real (host-network) address, so workloads living only
in the overlay can reach services on the host network.

Both ends ride the switch's event loop: the VConn callbacks already
fire there, and the host Connection is created on the same loop, so the
bridge is loop-confined with no locking.

Backpressure: host->VPC pauses the host connection while the user-space
TCP send buffer drains (peer-window pacing). VPC->host has no pause
surface on the user-space conn; bursts are bounded per-RTT by the
advertised 64KB window and the host Connection's MAX_OUT close is the
final safety valve.
"""
from __future__ import annotations

from typing import Optional

from ..net.connection import Connection, Handler
from ..utils.ip import parse_ip
from ..utils.log import Logger
from .fds import VConn, VServerSock
from .switch import Switch

_log = Logger("vpc-proxy")


class VpcProxy:
    def __init__(self, sw: Switch, vni: int, listen_ip: str, listen_port: int,
                 target_ip: str, target_port: int):
        self.sw = sw
        self.vni = vni
        self.listen = (listen_ip, listen_port)
        self.target = (target_ip, target_port)
        self.sessions = 0
        self.accepted = 0
        self.closed = False
        self.sock: VServerSock = sw.loop.call_sync(lambda: VServerSock(
            sw, vni, parse_ip(listen_ip), listen_port, self._on_accept))

    @property
    def alias(self) -> str:
        return f"{self.listen[0]}:{self.listen[1]}"

    def _on_accept(self, vc: VConn) -> None:
        self.accepted += 1
        self.sessions += 1
        proxy = self

        try:
            back = Connection.connect(self.sw.loop, self.target[0],
                                      self.target[1])
        except OSError as e:
            _log.alert(f"vpc-proxy {self.alias}: target connect failed {e!r}")
            self.sessions -= 1
            vc.close()
            return

        done = []

        def teardown() -> None:
            if done:
                return
            done.append(1)
            proxy.sessions -= 1
            vc.close()
            back.close()

        class VSide:
            def on_connected(self, _v) -> None: ...

            def on_drained(self, _v) -> None:
                if not done:
                    back.resume_reading()  # vc send buffer flushed

            def on_data(self, _v, data: bytes) -> None:
                back.write(data)

            def on_eof(self, _v) -> None:
                teardown()

            def on_closed(self, _v, err: int = 0) -> None:
                teardown()

        class HostSide(Handler):
            def on_data(self, c: Connection, data: bytes) -> None:
                vc.write(data)
                if vc.out:  # pace the host to the in-VPC peer's window
                    c.pause_reading()

            def on_eof(self, c: Connection) -> None:
                teardown()

            def on_closed(self, c: Connection, err: int) -> None:
                teardown()

        vc.set_handler(VSide())
        back.set_handler(HostSide())

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self.sw.loop.run_on_loop(self.sock.close)

    def detail(self) -> dict:
        return {"name": self.alias, "vni": self.vni,
                "target": f"{self.target[0]}:{self.target[1]}",
                "sessions": self.sessions, "accepted": self.accepted}
