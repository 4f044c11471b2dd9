"""DHCP DNS-server discovery.

Parity: base dhcp/DHCPClientHelper.java:27-180 + DHCPPacket/options —
the reference broadcasts a DHCPDISCOVER carrying a parameter-request
list asking for option 6 (domain name servers) and collects the servers
from the OFFER/ACK replies; `system-property dns discover-by-dhcp` uses
it to seed the resolver.

This implementation keeps the same wire behavior (BOOTP/DHCP codec,
DISCOVER with PRL=[6], option-6 harvesting, xid matching) on the
framework's event loop. Tests (and non-root use) point it at an
explicit server address/port instead of the 255.255.255.255:67
broadcast.

The port's copy of vproxy_tpu/dns/dhcp.py, same names and behaviour.
"""
from __future__ import annotations

import os
import struct
import time
from typing import Callable, Optional

from ..net.eventloop import SelectorEventLoop
from ..net.udp import UdpSock
from ..utils.log import Logger

_log = Logger("dhcp")

DHCP_SERVER_PORT = 67
DHCP_CLIENT_PORT = 68
MAGIC = b"\x63\x82\x53\x63"
OPT_MSG_TYPE = 53
OPT_PRL = 55
OPT_DNS = 6
OPT_END = 255
DISCOVER = 1
OFFER = 2
ACK = 5


def build_discover(xid: int, mac: bytes = b"\x02\x00\x00\x00\x00\x01") -> bytes:
    """BOOTREQUEST + DHCPDISCOVER asking for option 6 (DNS servers)."""
    head = struct.pack(">BBBBIHH", 1, 1, 6, 0, xid, 0, 0x8000)  # broadcast
    head += b"\x00" * 16  # ciaddr/yiaddr/siaddr/giaddr
    head += mac.ljust(16, b"\x00")
    head += b"\x00" * (64 + 128)  # sname + file
    opts = bytes([OPT_MSG_TYPE, 1, DISCOVER,
                  OPT_PRL, 1, OPT_DNS,
                  OPT_END])
    return head + MAGIC + opts


def parse_reply(data: bytes, xid: int) -> Optional[list]:
    """-> list of DNS server IPv4 bytes from an OFFER/ACK matching xid,
    None if not ours / not a DHCP reply."""
    if len(data) < 240 or data[0] != 2:  # BOOTREPLY
        return None
    (got_xid,) = struct.unpack(">I", data[4:8])
    if got_xid != xid or data[236:240] != MAGIC:
        return None
    i = 240
    msg_type = None
    dns: list = []
    while i + 1 < len(data):
        opt = data[i]
        if opt == OPT_END:
            break
        if opt == 0:  # pad
            i += 1
            continue
        # clamp to the actual remaining bytes: a hostile length must not
        # yield truncated "server" entries
        ln = min(data[i + 1], len(data) - i - 2)
        body = data[i + 2: i + 2 + ln]
        if opt == OPT_MSG_TYPE and ln == 1:
            msg_type = body[0]
        elif opt == OPT_DNS:
            dns += [bytes(body[j: j + 4])
                    for j in range(0, len(body) // 4 * 4, 4)]
        i += 2 + ln
    if msg_type not in (OFFER, ACK):
        return None
    return dns


def get_dns_servers(loop: SelectorEventLoop,
                    cb: Callable[[set, Optional[Exception]], None],
                    server: tuple = ("255.255.255.255", DHCP_SERVER_PORT),
                    bind_ip: str = "", bind_port: Optional[int] = None,
                    timeout_ms: int = 2000, retries: int = 2) -> None:
    """Broadcast (or unicast, for tests) a DHCPDISCOVER and collect DNS
    servers from every OFFER/ACK until the timeout; cb(set[bytes], err)
    on the loop. The set may aggregate multiple responding servers,
    like the reference's per-NIC collection."""
    xid = int.from_bytes(os.urandom(4), "big")
    found: set = set()
    state = {"done": False, "sock": None, "tries": 0}

    def finish(err: Optional[Exception]) -> None:
        if state["done"]:
            return
        state["done"] = True
        if state["sock"] is not None:
            state["sock"].close()
        if found:
            cb(set(found), None)
        else:
            cb(set(), err or TimeoutError("no DHCP reply"))

    def on_packet(data: bytes, ip: str, port: int) -> None:
        dns = parse_reply(data, xid)
        if dns is None:
            return
        found.update(dns)

    def send() -> None:
        if state["done"]:
            return
        state["tries"] += 1
        try:
            state["sock"].send(build_discover(xid), server[0], server[1])
        except OSError as e:
            finish(e)
            return
        if state["tries"] <= retries:
            loop.delay(timeout_ms // (retries + 1), send)

    def mk() -> None:
        broadcast = server[0].endswith(".255") or \
            server[0] == "255.255.255.255"
        # broadcast replies target 255.255.255.255:68 (the DISCOVER sets
        # the broadcast flag) — an ephemeral bind would never hear them
        port = bind_port if bind_port is not None else (
            DHCP_CLIENT_PORT if broadcast else 0)
        sock = None
        try:
            sock = UdpSock(loop, bind_ip or "0.0.0.0", port, on_packet)
            if broadcast:
                import socket as pysock
                tmp = pysock.socket(fileno=os.dup(sock.fd))
                tmp.setsockopt(pysock.SOL_SOCKET, pysock.SO_BROADCAST, 1)
                tmp.close()
        except OSError as e:
            if sock is not None:
                sock.close()
            cb(set(), e)
            return
        state["sock"] = sock
        send()
        loop.delay(timeout_ms, lambda: finish(None))

    if not loop.run_on_loop(mk):
        # loop is gone: the callback must still fire (per run_on_loop's
        # cleanup contract), or waiters hang with no diagnostic
        cb(set(), OSError("event loop is closed"))
