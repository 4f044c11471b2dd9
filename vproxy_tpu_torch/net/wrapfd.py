"""Blocking and file virtual FDs.

Parity:
* selector/wrap/blocking/BlockingDatagramFD.java:364 — a blocking
  send/recv facade over a loop-registered datagram socket, for code that
  runs OFF the event loop (blocking resolvers, scripts) but must share
  the loop's socket. `BlockingUdp` queues inbound datagrams from the
  loop thread and hands them out under a timeout.
* selector/wrap/file/FileFD.java:22 — a file exposed through the
  socket-FD surface so protocol code can stream file contents with the
  same handler API as network connections. `FileConn` quacks like a
  read-only Connection: on_data chunks delivered on the loop with
  pause/resume backpressure, on_eof at the end.

The port's copy of vproxy_tpu/net/wrapfd.py, same names and behaviour.
"""
from __future__ import annotations

import os
import queue
from typing import Optional

from .connection import Handler
from .eventloop import SelectorEventLoop
from .udp import UdpSock


class BlockingUdp:
    """Blocking datagram facade over a loop-owned UdpSock."""

    def __init__(self, loop: SelectorEventLoop, ip: str = "",
                 port: int = 0, queue_cap: int = 1024):
        self._q: queue.Queue = queue.Queue(queue_cap)
        self.sock = UdpSock(loop, ip, port, self._on_packet)
        self.local = self.sock.local
        self.closed = False

    _CLOSED = object()  # sentinel: wakes receivers blocked in recv()

    def _on_packet(self, data: bytes, ip: str, port: int) -> None:
        try:
            self._q.put_nowait((data, ip, port))
        except queue.Full:
            # UDP: drop under overload, like the kernel would — but
            # COUNTED (vproxy_udp_drop_total): a storm that overruns a
            # blocking consumer must be visible on /metrics, not silent
            from ..utils.metrics import udp_drop_incr
            udp_drop_incr()

    def send(self, data: bytes, ip: str, port: int) -> None:
        if self.closed:
            raise OSError("closed")
        self.sock.send(data, ip, port)

    def recv(self, timeout: Optional[float] = None):
        """-> (data, ip, port); raises TimeoutError. May be called from
        any thread EXCEPT the owning loop (it would deadlock the loop)."""
        if self.closed:
            raise OSError("closed")
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError("recv timed out")
        if item is self._CLOSED:
            self._q.put_nowait(item)  # wake any other blocked receiver
            raise OSError("closed")
        return item

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self.sock.close()
            try:
                self._q.put_nowait(self._CLOSED)
            except queue.Full:
                pass  # a full queue means receivers aren't blocked


class FileConn:
    """Read-only Connection-like over a regular file: chunks stream to
    handler.on_data on the loop, then on_eof. pause/resume give the
    same backpressure surface as a socket Connection."""

    CHUNK = 65536

    def __init__(self, loop: SelectorEventLoop, path: str):
        self.loop = loop
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        self.length = os.fstat(self._fd).st_size
        self.remote = ("file", 0)
        self.handler: Handler = Handler()
        self.closed = False
        self.detached = False
        self.bytes_in = 0
        self.bytes_out = 0
        self.out = b""
        self._paused = True
        self._pumping = False

    def set_handler(self, h: Handler) -> None:
        self.handler = h
        self.resume_reading()

    def pause_reading(self) -> None:
        self._paused = True

    def resume_reading(self) -> None:
        self._paused = False
        self._arm()

    def _arm(self) -> None:
        if not self._pumping and not self.closed:
            self._pumping = True
            self.loop.run_on_loop(self._pump)

    def _pump(self) -> None:
        self._pumping = False
        if self.closed or self._paused:
            return
        try:
            chunk = os.read(self._fd, self.CHUNK)
        except OSError:
            self.close(1)
            return
        if not chunk:
            self.handler.on_eof(self)
            return
        self.bytes_in += len(chunk)
        self.handler.on_data(self, chunk)
        self._arm()  # next chunk on the next loop pass (fair scheduling)

    def write(self, data: bytes) -> None:
        raise OSError("FileConn is read-only")

    def close(self, err: int = 0) -> None:
        if self.closed:
            return
        self.closed = True
        os.close(self._fd)
        self.handler.on_closed(self, err)

    close_graceful = close
