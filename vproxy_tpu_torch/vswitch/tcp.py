"""User-space TCP inside the virtual network.

The port of `vproxy_tpu/vswitch/tcp.py`, same names and behaviour.

Parity: base vpacket/conntrack (Conntrack.java:12 lookup/listen/create,
tcp/TcpEntry.java:443 per-connection seq/ack state machine with send/
recv queues and SYN backlog, tcp/TcpState) driven by core
stack/L4.java:544 (input dispatch: established lookup -> listen backlog
-> RST :25-90; ack + retransmission timers :408-517). Segments enter
from the L3 stack and leave through stack.send_ether; endpoints are
exposed to applications via fds.py (the stack/fd VSwitchFD analog).
"""
from __future__ import annotations

import os
import struct
from collections import deque
from typing import Callable, Optional

from .packets import (ETHER_TYPE_IPV4, ETHER_TYPE_IPV6, PROTO_TCP, TCP_ACK,
                      TCP_FIN, TCP_PSH, TCP_RST, TCP_SYN, Ethernet, Ipv4,
                      Ipv6, Tcp)

MAX_SYN_BACKLOG = 128  # ListenEntry.MAX_SYN_BACKLOG_SIZE
RTO_MS = 400
MAX_RETRIES = 8
TIME_WAIT_MS = 5_000
MSS = 1360
WINDOW = 65535  # no window scaling: the 16-bit field is the whole window


def _seq_lt(a: int, b: int) -> bool:
    return ((a - b) & 0xFFFFFFFF) > 0x7FFFFFFF


def _seq_add(a: int, n: int) -> int:
    return (a + n) & 0xFFFFFFFF


# TcpState (tcp/TcpState.java)
CLOSED, LISTEN, SYN_SENT, SYN_RECEIVED, ESTABLISHED, FIN_WAIT_1, FIN_WAIT_2, \
    CLOSING, CLOSE_WAIT, LAST_ACK, TIME_WAIT = range(11)


class ListenEntry:
    def __init__(self, local: tuple[bytes, int],
                 on_accept: Callable[["TcpConn"], None]):
        self.local = local  # (ip, port); ip may be None for any
        self.on_accept = on_accept
        self.syn_backlog: dict = {}  # conn key -> TcpConn in SYN_RECEIVED


class TcpHandler:
    def on_connected(self, conn: "TcpConn") -> None: ...

    def on_data(self, conn: "TcpConn", data: bytes) -> None: ...

    def on_eof(self, conn: "TcpConn") -> None: ...

    def on_closed(self, conn: "TcpConn") -> None: ...

    def on_drained(self, conn: "TcpConn") -> None: ...


class _Seg:
    __slots__ = ("seq", "data", "flags", "retries")

    def __init__(self, seq: int, data: bytes, flags: int):
        self.seq = seq
        self.data = data
        self.flags = flags
        self.retries = 0

    def length(self) -> int:
        n = len(self.data)
        if self.flags & (TCP_SYN | TCP_FIN):
            n += 1
        return n


class TcpConn:
    def __init__(self, l4: "L4", net, local: tuple[bytes, int],
                 remote: tuple[bytes, int], state: int):
        self.l4 = l4
        self.net = net
        self.local = local
        self.remote = remote
        self.state = state
        self.handler: TcpHandler = TcpHandler()
        iss = struct.unpack(">I", os.urandom(4))[0]
        self.snd_una = iss  # oldest unacked
        self.snd_nxt = iss
        self.rcv_nxt = 0
        self.snd_wnd = MSS  # peer window (learned from segments)
        self.mss = MSS
        self.rtx: deque[_Seg] = deque()  # sent, unacked
        self.pending = bytearray()  # app bytes not yet segmented
        self.fin_queued = False
        self.fin_sent = False
        self.closed = False
        self._timer = None
        self.bytes_in = 0
        self.bytes_out = 0

    @property
    def key(self):
        return (self.remote[0], self.remote[1], self.local[0], self.local[1])

    # ----------------------------------------------------------- app side

    def set_handler(self, h: TcpHandler) -> None:
        self.handler = h

    def write(self, data: bytes) -> None:
        if self.closed or self.fin_queued:
            return
        self.pending += data
        self._push()

    def shutdown_write(self) -> None:
        """Queue FIN after pending data (active close, half-close ok)."""
        if self.closed or self.fin_queued:
            return
        self.fin_queued = True
        self._push()

    def close(self) -> None:
        if self.state in (ESTABLISHED, SYN_RECEIVED):
            self.state = FIN_WAIT_1
            self.shutdown_write()
        elif self.state == CLOSE_WAIT:
            self.state = LAST_ACK
            self.shutdown_write()
        else:
            self.abort()

    def abort(self) -> None:
        if not self.closed:
            self._emit(TCP_RST | TCP_ACK, self.snd_nxt, self.rcv_nxt, b"")
            self._dead()

    # --------------------------------------------------------- tcp engine

    def _push(self) -> None:
        """Segment pending bytes within the peer's window and send."""
        if self.state not in (ESTABLISHED, CLOSE_WAIT, FIN_WAIT_1, LAST_ACK):
            return
        in_flight = (self.snd_nxt - self.snd_una) & 0xFFFFFFFF
        budget = max(0, self.snd_wnd - in_flight)
        while self.pending and budget > 0:
            chunk = bytes(self.pending[:min(self.mss, budget)])
            del self.pending[:len(chunk)]
            budget -= len(chunk)
            seg = _Seg(self.snd_nxt, chunk, TCP_ACK | TCP_PSH)
            self.rtx.append(seg)
            self.snd_nxt = _seq_add(self.snd_nxt, len(chunk))
            self._emit(seg.flags, seg.seq, self.rcv_nxt, chunk)
        if self.fin_queued and not self.pending and not self.fin_sent:
            seg = _Seg(self.snd_nxt, b"", TCP_FIN | TCP_ACK)
            self.rtx.append(seg)
            self.snd_nxt = _seq_add(self.snd_nxt, 1)
            self.fin_sent = True
            self._emit(seg.flags, seg.seq, self.rcv_nxt, b"")
        self._arm_timer()

    def send_syn(self) -> None:
        seg = _Seg(self.snd_nxt, b"", TCP_SYN)
        self.rtx.append(seg)
        self.snd_nxt = _seq_add(self.snd_nxt, 1)
        self.state = SYN_SENT
        self._emit(TCP_SYN, seg.seq, 0, b"",
                   options=struct.pack(">BBH", 2, 4, self.mss))
        self._arm_timer()

    def _send_syn_ack(self) -> None:
        seg = _Seg(self.snd_nxt, b"", TCP_SYN | TCP_ACK)
        self.rtx.append(seg)
        self.snd_nxt = _seq_add(self.snd_nxt, 1)
        self._emit(TCP_SYN | TCP_ACK, seg.seq, self.rcv_nxt, b"",
                   options=struct.pack(">BBH", 2, 4, self.mss))
        self._arm_timer()

    def segment(self, tcp: Tcp) -> None:
        """One inbound segment for this connection (L4.input)."""
        if self.closed:
            return
        if tcp.flags & TCP_RST:
            self._dead()
            return
        self.snd_wnd = max(tcp.window, 1)

        if self.state == SYN_SENT:
            if tcp.flags & TCP_SYN and tcp.flags & TCP_ACK:
                if tcp.ack != self.snd_nxt:
                    self.abort()
                    return
                self.rcv_nxt = _seq_add(tcp.seq, 1)
                self._acked(tcp.ack)
                self.state = ESTABLISHED
                mss = tcp.mss_option()
                if mss:
                    self.mss = min(self.mss, mss)
                self._emit(TCP_ACK, self.snd_nxt, self.rcv_nxt, b"")
                self.handler.on_connected(self)
                self._push()
            return

        if self.state == SYN_RECEIVED:
            if tcp.flags & TCP_ACK and tcp.ack == self.snd_nxt:
                self._acked(tcp.ack)
                self.state = ESTABLISHED
                self.l4.established(self)
            # fall through: first ACK may carry data

        if tcp.flags & TCP_ACK:
            self._acked(tcp.ack)

        # --- receive data ---
        data = tcp.data
        if data:
            if tcp.seq == self.rcv_nxt:
                self.rcv_nxt = _seq_add(self.rcv_nxt, len(data))
                self.bytes_in += len(data)
                self._emit(TCP_ACK, self.snd_nxt, self.rcv_nxt, b"")
                self.handler.on_data(self, data)
            else:
                # out-of-order or retransmission: re-ack what we have
                self._emit(TCP_ACK, self.snd_nxt, self.rcv_nxt, b"")
                return
        if tcp.flags & TCP_FIN:
            expected = _seq_add(tcp.seq, len(data))
            if expected != self.rcv_nxt and tcp.seq != self.rcv_nxt:
                return
            self.rcv_nxt = _seq_add(self.rcv_nxt, 1)
            self._emit(TCP_ACK, self.snd_nxt, self.rcv_nxt, b"")
            if self.state == ESTABLISHED:
                self.state = CLOSE_WAIT
                self.handler.on_eof(self)
            elif self.state == FIN_WAIT_1:
                self.state = CLOSING if self.rtx else TIME_WAIT
                self.handler.on_eof(self)
                self._maybe_time_wait()
            elif self.state == FIN_WAIT_2:
                self.state = TIME_WAIT
                self.handler.on_eof(self)
                self._maybe_time_wait()

    def _acked(self, ack: int) -> None:
        progressed = False
        while self.rtx:
            seg = self.rtx[0]
            end = _seq_add(seg.seq, seg.length())
            if _seq_lt(ack, end):
                break
            self.rtx.popleft()
            progressed = True
        if _seq_lt(self.snd_una, ack):
            self.snd_una = ack
        if progressed:
            self._arm_timer()
            self._push()
            if not self.rtx and not self.pending:
                if self.state == FIN_WAIT_1 and self.fin_sent:
                    self.state = FIN_WAIT_2
                elif self.state == CLOSING:
                    self.state = TIME_WAIT
                    self._maybe_time_wait()
                elif self.state == LAST_ACK and self.fin_sent:
                    self._dead()
                    return
                if not self.fin_queued:
                    self.handler.on_drained(self)

    def _maybe_time_wait(self) -> None:
        if self.state == TIME_WAIT:
            self._cancel_timer()
            self.l4.loop.delay(TIME_WAIT_MS, self._dead)

    # ------------------------------------------------------------- timers

    def _arm_timer(self) -> None:
        self._cancel_timer()
        if self.rtx and not self.closed:
            self._timer = self.l4.loop.delay(RTO_MS, self._retransmit)

    def _cancel_timer(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _retransmit(self) -> None:
        if self.closed or not self.rtx:
            return
        seg = self.rtx[0]
        seg.retries += 1
        if seg.retries > MAX_RETRIES:
            self.abort()
            return
        opts = b""
        if seg.flags & TCP_SYN:
            opts = struct.pack(">BBH", 2, 4, self.mss)
        self._emit(seg.flags, seg.seq, self.rcv_nxt if seg.flags & TCP_ACK
                   else 0, seg.data, options=opts)
        self._timer = self.l4.loop.delay(
            min(RTO_MS * (1 << seg.retries), 6000), self._retransmit)

    # -------------------------------------------------------------- wire

    def _emit(self, flags: int, seq: int, ack: int, data: bytes,
              options: bytes = b"") -> None:
        if data:
            self.bytes_out += len(data)
        self.l4.emit(self.net, self.local, self.remote, flags, seq, ack,
                     data, options)

    def _dead(self) -> None:
        if self.closed:
            return
        self.closed = True
        self._cancel_timer()
        self.state = CLOSED
        self.l4.conn_closed(self)
        self.handler.on_closed(self)


class Conntrack:
    """Listen table + connection table for one VPC (Conntrack.java:45-91)."""

    def __init__(self):
        self.listens: dict[tuple[Optional[bytes], int], ListenEntry] = {}
        self.conns: dict = {}  # (rip, rport, lip, lport) -> TcpConn

    def listen(self, ip: Optional[bytes], port: int,
               on_accept) -> ListenEntry:
        key = (ip, port)
        if key in self.listens:
            raise OSError(f"port {port} already listening")
        le = ListenEntry((ip, port), on_accept)
        self.listens[key] = le
        return le

    def stop_listen(self, ip: Optional[bytes], port: int) -> None:
        self.listens.pop((ip, port), None)

    def lookup(self, rip: bytes, rport: int, lip: bytes, lport: int):
        return self.conns.get((rip, rport, lip, lport))

    def lookup_listen(self, lip: bytes, lport: int) -> Optional[ListenEntry]:
        le = self.listens.get((lip, lport))
        if le is None:
            le = self.listens.get((None, lport))
        return le


class L4:
    """The TCP dispatch attached to a switch's NetworkStack
    (stack/L4.java:25-90)."""

    def __init__(self, sw):
        self.sw = sw
        self.loop = sw.loop
        sw.stack.l4 = self

    def conntrack(self, net) -> Conntrack:
        if net.conntrack is None:
            net.conntrack = Conntrack()
        return net.conntrack

    # ---------------------------------------------------------- dispatch

    def input(self, net, ether: Ethernet, ip, v6: bool) -> None:
        tcp = ip.packet
        if not isinstance(tcp, Tcp):
            return
        ct = self.conntrack(net)
        conn = ct.lookup(ip.src, tcp.sport, ip.dst, tcp.dport)
        if conn is not None:
            conn.segment(tcp)
            return
        le = ct.lookup_listen(ip.dst, tcp.dport)
        if le is not None and tcp.flags & TCP_SYN and not tcp.flags & TCP_ACK:
            if len(le.syn_backlog) >= MAX_SYN_BACKLOG:
                return
            conn = TcpConn(self, net, (ip.dst, tcp.dport),
                           (ip.src, tcp.sport), SYN_RECEIVED)
            conn.rcv_nxt = _seq_add(tcp.seq, 1)
            mss = tcp.mss_option()
            if mss:
                conn.mss = min(conn.mss, mss)
            ct.conns[conn.key] = conn
            le.syn_backlog[conn.key] = conn
            conn._send_syn_ack()
            return
        if not tcp.flags & TCP_RST:
            # no matching conn/listen: RST (L4.java:80-90)
            self.emit(net, (ip.dst, tcp.dport), (ip.src, tcp.sport),
                      TCP_RST | TCP_ACK, 0,
                      _seq_add(tcp.seq, len(tcp.data) + 1), b"")

    def established(self, conn: TcpConn) -> None:
        """SYN_RECEIVED -> ESTABLISHED: move from backlog to accept."""
        ct = self.conntrack(conn.net)
        le = ct.lookup_listen(conn.local[0], conn.local[1])
        if le is not None and conn.key in le.syn_backlog:
            del le.syn_backlog[conn.key]
            le.on_accept(conn)

    def connect(self, net, local_ip: bytes, remote: tuple[bytes, int],
                local_port: int = 0) -> TcpConn:
        ct = self.conntrack(net)
        if not local_port:
            for _ in range(64):
                local_port = 20000 + struct.unpack(">H", os.urandom(2))[0] % 40000
                if (remote[0], remote[1], local_ip, local_port) not in ct.conns:
                    break
        conn = TcpConn(self, net, (local_ip, local_port), remote, CLOSED)
        ct.conns[conn.key] = conn
        conn.send_syn()
        return conn

    def conn_closed(self, conn: TcpConn) -> None:
        ct = self.conntrack(conn.net)
        ct.conns.pop(conn.key, None)
        le = ct.lookup_listen(conn.local[0], conn.local[1])
        if le is not None:
            le.syn_backlog.pop(conn.key, None)

    # -------------------------------------------------------------- wire

    def emit(self, net, local: tuple[bytes, int], remote: tuple[bytes, int],
             flags: int, seq: int, ack: int, data: bytes,
             options: bytes = b"") -> None:
        tcp = Tcp(local[1], remote[1], seq, ack, flags, WINDOW, data, options)
        v6 = len(local[0]) == 16
        if v6:
            pkt = Ipv6(local[0], remote[0], PROTO_TCP, b"", packet=tcp)
            et = ETHER_TYPE_IPV6
        else:
            pkt = Ipv4(local[0], remote[0], PROTO_TCP, b"", packet=tcp)
            et = ETHER_TYPE_IPV4
        src_mac = net.ips.lookup_mac(local[0]) or b"\x02\x00\x00\x00\x00\x02"
        dst_mac = net.ips.lookup_mac(remote[0]) or net.arps.lookup(remote[0])
        if dst_mac is None:
            # trigger resolution; handshake retransmit will retry
            src = net.ips.first_in(net.v4net)
            if src is not None and not v6:
                self.sw.stack._arp_request(net, src[1], src[0], remote[0])
            return
        self.sw.stack.send_ether(net, Ethernet(dst_mac, src_mac, et, b"", pkt))
