"""Switch ifaces — how VXLAN frames enter and leave the switch.

The port of `vproxy_tpu/vswitch/iface.py`, same names and behaviour.

Parity: core vswitch/iface/* — `Iface` SPI; `BareVXLanIface` (plain
VXLAN peer), `RemoteSwitchIface` (switch-to-switch link),
`UserIface`/`UserClientIface` (encrypted tunnel with per-user AES-256
key and ping keepalive, VProxyEncryptedPacket), `TapIface` (OS tap via
/dev/net/tun ioctl — the FDsWithTap/JNI path done with fcntl, no JNI
needed on linux).
"""
from __future__ import annotations

import fcntl
import os
import struct
from typing import Optional

from ..net import vtl
from .packets import (VPROXY_TYPE_PING, VPROXY_TYPE_VXLAN, Ethernet,
                      PacketError, VProxySwitchPacket, Vxlan)


class Iface:
    """send_vxlan delivers an encapsulated frame out this iface; `vni`
    restriction 0 means untagged (use packet vni)."""

    name: str = ""
    local_side_vni: int = 0  # forced vni for frames entering via this iface

    def send_vxlan(self, sw, pkt: Vxlan) -> None:
        raise NotImplementedError

    # send_vxlan_raw(sw, data) — OPTIONAL: emit an already-serialized
    # vxlan datagram without re-parsing (the burst fast path's egress,
    # vswitch/fastpath.py). Ifaces that must transform the frame
    # (encrypting user tunnels) simply don't define it and the fast
    # path routes their traffic through the object pipeline.

    def close(self) -> None: ...


class BareVXLanIface(Iface):
    """A plain VXLAN endpoint (e.g. a hypervisor VTEP) at ip:port."""

    def __init__(self, remote_ip: str, remote_port: int):
        self.remote = (remote_ip, remote_port)
        self.name = f"bare-vxlan:{remote_ip}:{remote_port}"

    def send_vxlan(self, sw, pkt: Vxlan) -> None:
        sw.send_udp(pkt.to_bytes(), self.remote)

    def send_vxlan_raw(self, sw, data: bytes) -> None:
        sw.send_udp(data, self.remote)

    def send_vxlan_raw_many(self, sw, datas: list) -> None:
        sw.send_udp_many(datas, self.remote)


class RemoteSwitchIface(Iface):
    """Link to another vproxy-style switch (plain VXLAN, any vni)."""

    def __init__(self, alias: str, remote_ip: str, remote_port: int,
                 add_switch_flag: bool = True):
        self.alias = alias
        self.remote = (remote_ip, remote_port)
        self.name = f"remote:{alias}"

    def send_vxlan(self, sw, pkt: Vxlan) -> None:
        sw.send_udp(pkt.to_bytes(), self.remote)

    def send_vxlan_raw(self, sw, data: bytes) -> None:
        sw.send_udp(data, self.remote)

    def send_vxlan_raw_many(self, sw, datas: list) -> None:
        sw.send_udp_many(datas, self.remote)


class UserIface(Iface):
    """Server side of an encrypted user tunnel: a remote client
    authenticated as `user`; frames are AES-256-CFB encrypted switch
    packets; the client's vni is forced to the user's assigned vni."""

    def __init__(self, user: str, remote: tuple[str, int], vni: int):
        from .switch import display_user_name  # call-time: import cycle
        self.user = user  # wire form ('+'-padded to 8)
        self.remote = remote
        self.local_side_vni = vni
        self.name = f"user:{display_user_name(user)}"

    def send_vxlan(self, sw, pkt: Vxlan) -> None:
        p = VProxySwitchPacket(self.user, VPROXY_TYPE_VXLAN, pkt)
        sw.send_udp(p.to_bytes(sw.key_for_user), self.remote)

    def send_ping(self, sw) -> None:
        p = VProxySwitchPacket(self.user, VPROXY_TYPE_PING, None)
        sw.send_udp(p.to_bytes(sw.key_for_user), self.remote)


class UserClientIface(Iface):
    """Client side of an encrypted user tunnel: dials a remote switch and
    keeps the link alive with periodic pings (UserClientIface.java)."""

    PING_PERIOD_MS = 20_000

    def __init__(self, user: str, key: bytes, remote_ip: str, remote_port: int):
        from .switch import display_user_name  # call-time: import cycle
        self.user = user  # wire form ('+'-padded to 8)
        self.key = key
        self.remote = (remote_ip, remote_port)
        self.name = f"ucli:{display_user_name(user)}"
        self._periodic = None

    def attach(self, sw) -> None:
        self._periodic = sw.loop.period(self.PING_PERIOD_MS,
                                        lambda: self.send_ping(sw))
        self.send_ping(sw)

    def key_for(self, user: str) -> Optional[bytes]:
        return self.key if user == self.user else None

    def send_vxlan(self, sw, pkt: Vxlan) -> None:
        p = VProxySwitchPacket(self.user, VPROXY_TYPE_VXLAN, pkt)
        sw.send_udp(p.to_bytes(self.key_for), self.remote)

    def send_ping(self, sw) -> None:
        p = VProxySwitchPacket(self.user, VPROXY_TYPE_PING, None)
        sw.send_udp(p.to_bytes(self.key_for), self.remote)

    def close(self) -> None:
        if self._periodic is not None:
            self._periodic.cancel()


# --------------------------------------------------------------------- tap

TUNSETIFF = 0x400454CA
IFF_TAP = 0x0002
IFF_NO_PI = 0x1000


class TapIface(Iface):
    """OS tap device bridged into a VPC: raw ethernet frames from the
    kernel enter the switch tagged with `vni` (TapIface.java +
    vfd_posix createTapFD :766). Requires /dev/net/tun access (root)."""

    post_script: Optional[str] = None

    def __init__(self, pattern: str, vni: int, loop, on_frame,
                 annotations: Optional[dict] = None):
        """on_frame(tap_iface, Ethernet) delivers inbound frames."""
        self.local_side_vni = vni
        self.annotations: dict = annotations or {}
        self.fd = os.open("/dev/net/tun", os.O_RDWR | os.O_NONBLOCK)
        ifr = struct.pack("16sH", pattern.encode(), IFF_TAP | IFF_NO_PI)
        out = fcntl.ioctl(self.fd, TUNSETIFF, ifr)
        self.dev = out[:16].rstrip(b"\x00").decode()
        self.name = f"tap:{self.dev}"
        self.loop = loop
        self.on_frame = on_frame
        loop.add(self.fd, vtl.EV_READ, self._readable)

    def _readable(self, fd: int, ev: int) -> None:
        while True:
            try:
                data = os.read(self.fd, 65536)
            except BlockingIOError:
                return
            except OSError:
                return
            if not data:
                return
            try:
                ether = Ethernet.parse(data)
            except PacketError:
                continue
            self.on_frame(self, ether)

    def send_vxlan(self, sw, pkt: Vxlan) -> None:
        try:
            os.write(self.fd, pkt.ether.to_bytes())
        except OSError:
            pass

    def send_vxlan_raw(self, sw, data: bytes) -> None:
        try:
            os.write(self.fd, data[8:])  # strip the vxlan header
        except OSError:
            pass

    def close(self) -> None:
        try:
            self.loop.remove(self.fd)
        except Exception:
            pass
        try:
            os.close(self.fd)
        except OSError:
            pass


def tap_supported() -> bool:
    return os.path.exists("/dev/net/tun") and os.access("/dev/net/tun", os.W_OK)
