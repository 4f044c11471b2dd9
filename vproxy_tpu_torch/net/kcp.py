"""KCP ARQ reliable transport over UDP.

Parity: reference `selector/wrap/kcp` + `selector/wrap/arqudp`
(`Kcp.java` — a port of the public skywind3000/KCP protocol;
`ArqUDPSocketFD.java:32`): a user-space reliable, ordered byte/segment
transport over UDP with RTO-based and fast retransmission, sliding
windows and window probing. This is a clean-room implementation from
the public KCP wire protocol, not a translation of the reference.

Wire format, little-endian (public KCP spec):

  conv:u32  cmd:u8  frg:u8  wnd:u16  ts:u32  sn:u32  una:u32  len:u32  data

cmd: 81 PUSH (data), 82 ACK, 83 WASK (window probe ask), 84 WINS
(window probe answer). `frg` counts remaining fragments of a message.

`Kcp` is the pure protocol machine (feed input(), poll recv(),
schedule via update()/check()); `KcpConn` binds it to a UdpSock /
UdpVirtualConn on a SelectorEventLoop with the "fast mode" tuning the
reference uses for its tunnels (nodelay, 10ms interval, fast resend=2,
no congestion control).

The port's copy of vproxy_tpu/net/kcp.py, same names and behaviour.
"""
from __future__ import annotations

import struct
import threading
from collections import deque
import time
from typing import Callable, List, Optional

from .eventloop import SelectorEventLoop

CMD_PUSH = 81
CMD_ACK = 82
CMD_WASK = 83
CMD_WINS = 84

HEAD = struct.Struct("<IBBHIIII")
OVERHEAD = HEAD.size  # 24

RTO_MIN = 100
RTO_DEF = 200
RTO_MAX = 60000
PROBE_INIT = 7000
PROBE_LIMIT = 120000


def _diff(a: int, b: int) -> int:
    """signed distance a-b on the u32 circle."""
    d = (a - b) & 0xFFFFFFFF
    return d - 0x100000000 if d >= 0x80000000 else d


class _Seg:
    __slots__ = ("conv", "cmd", "frg", "wnd", "ts", "sn", "una", "data",
                 "resendts", "rto", "fastack", "xmit")

    def __init__(self, data: bytes = b""):
        self.conv = self.cmd = self.frg = self.wnd = 0
        self.ts = self.sn = self.una = 0
        self.data = data
        self.resendts = self.rto = self.fastack = self.xmit = 0

    def encode(self) -> bytes:
        return HEAD.pack(self.conv, self.cmd, self.frg, self.wnd, self.ts,
                         self.sn, self.una, len(self.data)) + self.data


class Kcp:
    """The ARQ state machine. All times are int milliseconds supplied by
    the caller (monotonic); output(data) emits one UDP datagram."""

    def __init__(self, conv: int, output: Callable[[bytes], None],
                 mtu: int = 1400):
        self.conv = conv
        self.output = output
        self.mtu = mtu
        self.mss = mtu - OVERHEAD
        self.snd_una = 0
        self.snd_nxt = 0
        self.rcv_nxt = 0
        self.snd_wnd = 32
        self.rcv_wnd = 128
        self.rmt_wnd = 32
        self.cwnd = 0
        self.incr = 0
        self.ssthresh = 2
        self.snd_queue: deque = deque()
        self.snd_buf: deque = deque()
        self.rcv_queue: deque = deque()
        self.rcv_buf: List[_Seg] = []  # out-of-order window; stays small
        self.acklist: List[tuple] = []  # (sn, ts)
        self.rx_srtt = 0
        self.rx_rttval = 0
        self.rx_rto = RTO_DEF
        self.rx_minrto = RTO_MIN
        self.current = 0
        self.interval = 100
        self.ts_flush = 100
        self.updated = False
        self.nodelay = 0
        self.fastresend = 0
        self.nocwnd = 0
        self.probe = 0
        self.ts_probe = 0
        self.probe_wait = 0
        self.dead_link = 20
        self.state = 0  # -1 once a segment exceeds dead_link xmits

    # -------------------------------------------------------------- tuning

    def set_nodelay(self, nodelay: int, interval: int, resend: int,
                    nc: int) -> None:
        """Public KCP "fast mode" knob: (1, 10, 2, 1) for tunnels."""
        self.nodelay = nodelay
        self.rx_minrto = 30 if nodelay else RTO_MIN
        self.interval = max(10, min(5000, interval))
        self.fastresend = resend
        self.nocwnd = nc

    def set_wndsize(self, snd: int, rcv: int) -> None:
        self.snd_wnd = snd
        self.rcv_wnd = max(rcv, 128)

    # --------------------------------------------------------------- send

    def send(self, data: bytes) -> None:
        """Queue a message; fragmented into <=mss segments with frg
        counting down to 0 (stream-of-messages semantics)."""
        if not data:
            return
        n = (len(data) + self.mss - 1) // self.mss
        # frg is u8 AND the whole message must fit the peer's reassembly
        # window or recv() can never complete it (public KCP rejects
        # count >= rcv_wnd for the same reason)
        if n > 255 or n >= self.rcv_wnd:
            raise ValueError("message too large: %d fragments" % n)
        for i in range(n):
            seg = _Seg(data[i * self.mss:(i + 1) * self.mss])
            seg.frg = n - i - 1
            self.snd_queue.append(seg)

    # -------------------------------------------------------------- recv

    def recv(self) -> Optional[bytes]:
        """Pop one complete (defragmented) message, or None."""
        if not self.rcv_queue:
            return None
        # whole message present?
        if self.rcv_queue[0].frg + 1 > len(self.rcv_queue):
            return None
        was_full = len(self.rcv_queue) >= self.rcv_wnd
        parts = []
        while self.rcv_queue:
            seg = self.rcv_queue.popleft()
            parts.append(seg.data)
            if seg.frg == 0:
                break
        self._move_rcv_buf()
        if was_full and len(self.rcv_queue) < self.rcv_wnd:
            # window reopened after advertising 0: tell the peer now
            # instead of waiting for its WASK probe (public KCP ASK_TELL)
            self.probe |= 2
        return b"".join(parts)

    def _move_rcv_buf(self) -> None:
        while self.rcv_buf and self.rcv_buf[0].sn == self.rcv_nxt and \
                len(self.rcv_queue) < self.rcv_wnd:
            self.rcv_nxt = (self.rcv_nxt + 1) & 0xFFFFFFFF
            self.rcv_queue.append(self.rcv_buf.pop(0))

    # -------------------------------------------------------------- input

    def input(self, data: bytes) -> None:
        off = 0
        maxack = -1
        una_before = self.snd_una
        while len(data) - off >= OVERHEAD:
            conv, cmd, frg, wnd, ts, sn, una, ln = HEAD.unpack_from(data, off)
            off += OVERHEAD
            if conv != self.conv or len(data) - off < ln:
                return
            payload = data[off:off + ln]
            off += ln
            self.rmt_wnd = wnd
            self._parse_una(una)
            if cmd == CMD_ACK:
                rtt = _diff(self.current, ts)
                if rtt >= 0:
                    self._update_rtt(rtt)
                self._parse_ack(sn)
                if maxack < 0 or _diff(sn, maxack) > 0:
                    maxack = sn
            elif cmd == CMD_PUSH:
                if _diff(sn, (self.rcv_nxt + self.rcv_wnd) & 0xFFFFFFFF) < 0:
                    self.acklist.append((sn, ts))
                    if _diff(sn, self.rcv_nxt) >= 0:
                        seg = _Seg(payload)
                        seg.sn = sn
                        seg.frg = frg
                        self._parse_data(seg)
            elif cmd == CMD_WASK:
                self.probe |= 2  # should send WINS
            elif cmd == CMD_WINS:
                pass
            else:
                return
        # only an in-window maxack may drive fast retransmit; an
        # out-of-range ack sn would inflate fastack on every segment
        if maxack >= 0 and _diff(maxack, self.snd_una) >= 0 and \
                _diff(maxack, self.snd_nxt) < 0:
            for seg in self.snd_buf:
                if _diff(seg.sn, maxack) < 0:
                    seg.fastack += 1
        if _diff(self.snd_una, una_before) > 0:
            self._update_cwnd_on_ack()

    def _update_rtt(self, rtt: int) -> None:
        if self.rx_srtt == 0:
            self.rx_srtt = rtt
            self.rx_rttval = rtt // 2
        else:
            delta = abs(rtt - self.rx_srtt)
            self.rx_rttval = (3 * self.rx_rttval + delta) // 4
            self.rx_srtt = max(1, (7 * self.rx_srtt + rtt) // 8)
        rto = self.rx_srtt + max(self.interval, 4 * self.rx_rttval)
        self.rx_rto = min(max(self.rx_minrto, rto), RTO_MAX)

    def _parse_una(self, una: int) -> None:
        while self.snd_buf and _diff(self.snd_buf[0].sn, una) < 0:
            self.snd_buf.popleft()
        self._shrink_buf()

    def _parse_ack(self, sn: int) -> None:
        if _diff(sn, self.snd_una) < 0 or _diff(sn, self.snd_nxt) >= 0:
            return
        for seg in self.snd_buf:
            if seg.sn == sn:
                self.snd_buf.remove(seg)
                break
            if _diff(sn, seg.sn) < 0:
                break
        self._shrink_buf()

    def _shrink_buf(self) -> None:
        self.snd_una = self.snd_buf[0].sn if self.snd_buf else self.snd_nxt

    def _parse_data(self, newseg: _Seg) -> None:
        # insert into rcv_buf sorted by sn, dropping duplicates
        i = len(self.rcv_buf) - 1
        repeat = False
        while i >= 0:
            d = _diff(newseg.sn, self.rcv_buf[i].sn)
            if d == 0:
                repeat = True
                break
            if d > 0:
                break
            i -= 1
        if not repeat:
            self.rcv_buf.insert(i + 1, newseg)
        self._move_rcv_buf()

    def _update_cwnd_on_ack(self) -> None:
        if self.nocwnd:
            return
        if self.cwnd < self.rmt_wnd:
            mss = self.mss
            if self.cwnd < self.ssthresh:
                self.cwnd += 1
                self.incr += mss
            else:
                self.incr = max(self.incr, mss)
                self.incr += (mss * mss) // self.incr + (mss // 16)
                if (self.cwnd + 1) * mss <= self.incr:
                    self.cwnd = (self.incr + mss - 1) // max(1, mss)
            if self.cwnd > self.rmt_wnd:
                self.cwnd = self.rmt_wnd
                self.incr = self.rmt_wnd * mss

    # -------------------------------------------------------------- flush

    def _wnd_unused(self) -> int:
        return max(0, self.rcv_wnd - len(self.rcv_queue))

    def flush(self) -> None:
        if not self.updated:
            return
        current = self.current
        wnd = self._wnd_unused()
        base = _Seg()
        base.conv = self.conv
        base.wnd = wnd
        base.una = self.rcv_nxt
        out: List[bytes] = []
        size = 0

        def emit(chunk: bytes) -> None:
            nonlocal size
            if size + len(chunk) > self.mtu and out:
                self.output(b"".join(out))
                out.clear()
                size = 0
            out.append(chunk)
            size += len(chunk)

        # pending acks
        for sn, ts in self.acklist:
            base.cmd = CMD_ACK
            base.sn = sn
            base.ts = ts
            emit(base.encode())
        self.acklist.clear()

        # window probing
        if self.rmt_wnd == 0:
            if self.probe_wait == 0:
                self.probe_wait = PROBE_INIT
                self.ts_probe = current + self.probe_wait
            elif _diff(current, self.ts_probe) >= 0:
                self.probe_wait = min(PROBE_LIMIT,
                                      self.probe_wait + self.probe_wait // 2)
                self.ts_probe = current + self.probe_wait
                self.probe |= 1
        else:
            self.ts_probe = 0
            self.probe_wait = 0
        if self.probe & 1:
            base.cmd = CMD_WASK
            base.sn = 0
            base.ts = 0
            emit(base.encode())
        if self.probe & 2:
            base.cmd = CMD_WINS
            base.sn = 0
            base.ts = 0
            emit(base.encode())
        self.probe = 0

        # move from snd_queue into snd_buf within the window
        cwnd = min(self.snd_wnd, self.rmt_wnd)
        if not self.nocwnd:
            cwnd = min(cwnd, max(1, self.cwnd))
        while self.snd_queue and \
                _diff(self.snd_nxt, (self.snd_una + cwnd) & 0xFFFFFFFF) < 0:
            seg = self.snd_queue.popleft()
            seg.conv = self.conv
            seg.cmd = CMD_PUSH
            seg.sn = self.snd_nxt
            self.snd_nxt = (self.snd_nxt + 1) & 0xFFFFFFFF
            self.snd_buf.append(seg)

        resent = self.fastresend if self.fastresend > 0 else 0x7FFFFFFF
        rtomin = 0 if self.nodelay else self.rx_rto >> 3
        lost = change = False
        for seg in self.snd_buf:
            needsend = False
            if seg.xmit == 0:
                needsend = True
                seg.rto = self.rx_rto
                seg.resendts = current + seg.rto + rtomin
            elif _diff(current, seg.resendts) >= 0:
                needsend = True
                if self.nodelay:
                    seg.rto += self.rx_rto // 2
                else:
                    seg.rto += self.rx_rto
                seg.resendts = current + seg.rto
                lost = True
            elif seg.fastack >= resent:
                needsend = True
                seg.fastack = 0
                seg.resendts = current + seg.rto
                change = True
            if needsend:
                seg.xmit += 1
                seg.ts = current
                seg.wnd = wnd
                seg.una = self.rcv_nxt
                emit(seg.encode())
                if seg.xmit >= self.dead_link:
                    self.state = -1
        if out:
            self.output(b"".join(out))

        # congestion window reaction
        if not self.nocwnd:
            if change:
                inflight = _diff(self.snd_nxt, self.snd_una)
                self.ssthresh = max(2, inflight // 2)
                self.cwnd = self.ssthresh + (self.fastresend or 0)
                self.incr = self.cwnd * self.mss
            if lost:
                self.ssthresh = max(2, cwnd // 2)
                self.cwnd = 1
                self.incr = self.mss

    # ---------------------------------------------------------- schedule

    def update(self, current: int) -> None:
        self.current = current
        if not self.updated:
            self.updated = True
            self.ts_flush = current
        slap = _diff(current, self.ts_flush)
        if slap >= 10000 or slap < -10000:
            self.ts_flush = current
            slap = 0
        if slap >= 0:
            self.ts_flush += self.interval
            if _diff(current, self.ts_flush) >= 0:
                self.ts_flush = current + self.interval
            self.flush()

    def check(self, current: int) -> int:
        """ms until the next update() is needed."""
        if not self.updated:
            return 0
        ts_flush = self.ts_flush
        if _diff(current, ts_flush) >= 10000 or _diff(current, ts_flush) <= -10000:
            ts_flush = current
        if _diff(current, ts_flush) >= 0:
            return 0
        tm = _diff(ts_flush, current)
        for seg in self.snd_buf:
            d = _diff(seg.resendts, current)
            if d <= 0:
                return 0
            tm = min(tm, d)
        return min(tm, self.interval)

    @property
    def waitsnd(self) -> int:
        return len(self.snd_buf) + len(self.snd_queue)


class KcpHandler:
    """Callbacks for KcpConn, all on the loop thread."""

    def on_message(self, conn: "KcpConn", data: bytes) -> None: ...

    def on_broken(self, conn: "KcpConn") -> None: ...


class KcpConn:
    """A Kcp machine driven by a SelectorEventLoop timer, transported
    over any object with write(bytes) (UdpVirtualConn) or a (UdpSock,
    ip, port) triple. Fast-mode tuned like the reference's tunnels."""

    def __init__(self, loop: SelectorEventLoop, conv: int,
                 send_raw: Callable[[bytes], None],
                 handler: Optional[KcpHandler] = None):
        self.loop = loop
        self.handler = handler
        self.closed = False
        self.kcp = Kcp(conv, send_raw)
        self.kcp.set_nodelay(1, 10, 2, 1)
        self.kcp.set_wndsize(1024, 1024)
        self._t0 = loop.now
        self._timer = None
        self._flush_pending = False
        loop.run_on_loop(self._schedule)

    def _now_ms(self) -> int:
        return int((time.monotonic() - self._t0) * 1000) & 0xFFFFFFFF

    def _on_loop(self, fn: Callable[[], None]) -> None:
        """Kcp state is loop-thread-confined (same discipline as every
        other component); callers on other threads are marshaled."""
        if threading.current_thread() is self.loop._thread:
            fn()
        else:
            self.loop.run_on_loop(fn)

    def _schedule(self) -> None:
        if self.closed:
            return
        cur = self._now_ms()
        self.kcp.update(cur)
        if self.kcp.state < 0:
            self.close()
            if self.handler is not None:
                self.handler.on_broken(self)
            return
        delay = max(1, self.kcp.check(self._now_ms()))
        self._timer = self.loop.delay(delay, self._schedule)

    def _flush_soon(self) -> None:
        """Coalesce to ONE flush per loop tick. Flushing on every input
        datagram lets duplicate acks fast-retransmit the same segment
        unboundedly (xmit races to dead_link); pacing per tick keeps ack
        latency low without the storm."""
        if self._flush_pending or self.closed:
            return
        self._flush_pending = True

        def run() -> None:
            self._flush_pending = False
            if not self.closed:
                self.kcp.current = self._now_ms()
                self.kcp.flush()
        self.loop.next_tick(run)

    def feed(self, datagram: bytes) -> None:
        """Call with every raw UDP payload for this session."""
        def run() -> None:
            if self.closed:
                return
            self.kcp.input(datagram)
            while True:
                msg = self.kcp.recv()
                if msg is None:
                    break
                if self.handler is not None:
                    self.handler.on_message(self, msg)
            self._flush_soon()
        self._on_loop(run)

    def send(self, data: bytes) -> None:
        def run() -> None:
            if self.closed:
                return
            self.kcp.send(data)
            self._flush_soon()
        self._on_loop(run)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if self._timer is not None:
            self._timer.cancel()
