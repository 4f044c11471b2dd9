"""Connection layer over the event loop.

Functional analog of the reference's connection package (NetEventLoop /
Connection / ConnectableConnection / ServerSock — connection/*.java):
nonblocking connections with buffered writes and callback handlers,
accept loops, and client-side connects with deferred completion. The
TCP-splice fast path is NOT here — a proxied session detaches both fds
and hands them to the native pump (eventloop.SelectorEventLoop.pump);
this layer drives the L7/handler-mode paths (protocol parsing, health
checks, controllers).

The port's copy of vproxy_tpu/net/connection.py, same names and behaviour.
"""
from __future__ import annotations

import errno
from typing import Callable, Optional

from . import vtl
from ..utils import failpoint
from .eventloop import SelectorEventLoop


class Handler:
    """Override some of these; attach with Connection.set_handler."""

    def on_data(self, conn: "Connection", data: bytes) -> None: ...

    def on_eof(self, conn: "Connection") -> None:
        conn.close()

    def on_closed(self, conn: "Connection", err: int) -> None: ...

    def on_connected(self, conn: "Connection") -> None: ...

    def on_drained(self, conn: "Connection") -> None:
        """out buffer fully flushed."""


class _DrainHandler(Handler):
    """close_draining's discard mode: inbound bytes are dropped, EOF
    closes, but close notification still reaches the ORIGINAL handler —
    owners (e.g. HttpServer._conns) must not leak rejected sessions."""

    def __init__(self, prev: Handler):
        self._prev = prev

    def on_closed(self, conn: "Connection", err: int) -> None:
        self._prev.on_closed(conn, err)


class Connection:
    MAX_OUT = 4 * 1024 * 1024

    def __init__(self, loop: SelectorEventLoop, fd: int, remote, local=None,
                 connecting: bool = False, connect_timeout_ms: int = 0):
        self.loop = loop
        self.fd = fd
        self.remote = remote  # (ip, port)
        self.local = local
        self.handler: Handler = Handler()
        self.out = bytearray()
        self.closed = False
        self.detached = False
        self.eof_seen = False
        self.bytes_in = 0
        self.bytes_out = 0
        self._connecting = connecting
        self._fp_hang = False  # backend.connect.hang failpoint armed
        self._closing = False
        self._shut_wr_pending = False
        self._interest = 0
        self._conn_deadline = None
        loop.add(fd, 0, self._on_event)
        self._want(vtl.EV_WRITE if connecting else vtl.EV_READ)
        if connecting and connect_timeout_ms > 0:
            # a peer that neither completes nor refuses the connect (SYN
            # blackhole) must surface as on_closed(-ETIMEDOUT), not a
            # forever-pending handler
            def _timed_out() -> None:
                self._conn_deadline = None
                if self._connecting and not (self.closed or self.detached):
                    self.close(-errno.ETIMEDOUT)

            self._conn_deadline = loop.delay(connect_timeout_ms, _timed_out)

    # ---------------------------------------------------------- public api

    @classmethod
    def connect(cls, loop: SelectorEventLoop, ip: str, port: int,
                failpoints: bool = True,
                timeout_ms: int = 0) -> "Connection":
        """failpoints=False opts this connect out of the
        backend.connect.* injection sites — health-check probes pass it
        so they can't consume count-armed data-plane faults (they have
        their own dedicated site, hc.force_down). timeout_ms > 0 bounds
        the connect: on expiry the handler sees on_closed(-ETIMEDOUT)."""
        ctx = f"{ip}:{port}"
        if failpoints and failpoint.hit("backend.connect.refuse", ctx):
            raise ConnectionRefusedError(errno.ECONNREFUSED,
                                         f"failpoint refused {ctx}")
        fd = vtl.tcp_connect(ip, port)
        conn = cls(loop, fd, (ip, port), connecting=True,
                   connect_timeout_ms=timeout_ms)
        if failpoints and failpoint.hit("backend.connect.hang", ctx):
            # the connect never completes and never errors, leaving only
            # the caller's timeout path; interest drops to 0 so the
            # level-triggered writable fd can't busy-spin the loop
            # (_want ignores all later re-arms — e.g. a write() before
            # the flag, which would otherwise restore EV_WRITE forever)
            conn._want(0)
            conn._fp_hang = True
        return conn

    @classmethod
    def connect_unix(cls, loop: SelectorEventLoop, path: str) -> "Connection":
        fd = vtl.unix_connect(path)
        return cls(loop, fd, (path, 0), connecting=True)

    def set_handler(self, h: Handler) -> None:
        self.handler = h

    def write(self, data: bytes) -> None:
        if self.closed or self.detached:
            return
        self.out += data
        try:
            self._flush()
        except OSError as e:
            self.close(e.errno or 1)
            return
        if len(self.out) > self.MAX_OUT:
            # backpressure limit blown: the peer has stalled for > MAX_OUT
            # bytes; kill the session rather than balloon memory
            self.close(1)
            return
        if self.out:
            self._want(self._interest | vtl.EV_WRITE)

    def close(self, err: int = 0) -> None:
        if self.closed or self.detached:
            return
        self.closed = True
        self._cancel_conn_deadline()
        self.loop.remove(self.fd)
        vtl.close(self.fd)
        self.handler.on_closed(self, err)

    def close_graceful(self) -> None:
        """Close after the out buffer drains (final flush on write-ready);
        a hard close would drop queued response bytes."""
        if self.closed or self.detached:
            return
        if not self.out:
            self.close()
            return
        self._closing = True
        self.pause_reading()

    def close_draining(self, grace_ms: int = 1000) -> None:
        """Early-response teardown: flush the response, HALF-close the
        write side, and keep discarding inbound bytes for up to grace_ms.
        Closing while the peer is still streaming (e.g. a rejected
        oversized body) leaves unread bytes in the kernel buffer and the
        close turns into a RST that can destroy the delivered response;
        draining lets the peer actually see the 413/-ERR."""
        if self.closed or self.detached:
            return
        self.set_handler(_DrainHandler(self.handler))
        self._want(self._interest | vtl.EV_READ)
        if self.out:
            self._shut_wr_pending = True
            self._want(self._interest | vtl.EV_WRITE)
        else:
            vtl.shutdown_wr(self.fd)
        self.loop.delay(grace_ms, self.close)

    def detach(self) -> int:
        """Unregister and return the raw fd (for pump handover / transfer)."""
        if self.closed:
            raise OSError("closed")
        self.detached = True
        self._cancel_conn_deadline()
        self.loop.remove(self.fd)
        return self.fd

    def pause_reading(self) -> None:
        self._want(self._interest & ~vtl.EV_READ)

    def resume_reading(self) -> None:
        self._want(self._interest | vtl.EV_READ)

    # ---------------------------------------------------------- internals

    def _cancel_conn_deadline(self) -> None:
        if self._conn_deadline is not None:
            self._conn_deadline.cancel()
            self._conn_deadline = None

    def _want(self, interest: int) -> None:
        if self.closed or self.detached or self._fp_hang:
            return
        if interest != self._interest:
            self.loop.modify(self.fd, interest)
            self._interest = interest

    def _flush(self) -> None:
        while self.out:
            n = vtl.write(self.fd, bytes(self.out[:262144]))
            if n == vtl.AGAIN:
                return
            if n <= 0:
                return
            self.bytes_out += n
            del self.out[:n]

    def _on_event(self, fd: int, ev: int) -> None:
        try:
            self._on_event_inner(fd, ev)
        except OSError as e:
            # peer reset / broken pipe etc. -> close this connection only
            self.close(e.errno or 1)

    def _on_event_inner(self, fd: int, ev: int) -> None:
        if self.closed or self.detached:
            return
        if self._fp_hang:
            return  # failpoint: this connect never resolves
        if self._connecting:
            self._connecting = False
            self._cancel_conn_deadline()
            err = vtl.finish_connect(fd)
            if err != 0:
                self.close(-err)
                return
            self._want(vtl.EV_READ)
            self.handler.on_connected(self)
            if self.out:
                self._flush()
                if self.out:
                    self._want(self._interest | vtl.EV_WRITE)
            return
        if ev & vtl.EV_ERROR:
            self.close(vtl.finish_connect(fd) or 1)
            return
        if ev & vtl.EV_READ:
            while not (self.closed or self.detached):
                data = vtl.read(self.fd)
                if data is None:  # EAGAIN
                    break
                if data == b"":
                    self.eof_seen = True
                    self._want(self._interest & ~vtl.EV_READ)
                    self.handler.on_eof(self)
                    break
                self.bytes_in += len(data)
                self.handler.on_data(self, data)
        if (ev & vtl.EV_WRITE) and not (self.closed or self.detached):
            self._flush()
            if not self.out:
                if self._closing:
                    self.close()
                    return
                if self._shut_wr_pending:
                    self._shut_wr_pending = False
                    vtl.shutdown_wr(self.fd)
                self._want(self._interest & ~vtl.EV_WRITE)
                self.handler.on_drained(self)


class ServerSock:
    def __init__(self, loop: SelectorEventLoop, ip: str, port: int,
                 on_accept: Callable[[int, str, int], None],
                 backlog: int = 512, reuseport: bool = False,
                 _fd: Optional[int] = None):
        self.loop = loop
        self.ip, self.port = ip, port
        self.fd = vtl.tcp_listen(ip, port, backlog, reuseport,
                                 ":" in ip) if _fd is None else _fd
        self.on_accept = on_accept
        self.closed = False
        loop.add(self.fd, vtl.EV_READ, self._on_event)
        if port == 0 and _fd is None:
            _, self.port = vtl.sock_name(self.fd)

    @classmethod
    def unix(cls, loop: SelectorEventLoop, path: str,
             on_accept: Callable[[int, str, int], None],
             backlog: int = 512) -> "ServerSock":
        """Listen on a unix-domain socket path (vfd UDSPath analog);
        accepted peers are reported with ip="" port=0."""
        fd = vtl.unix_listen(path, backlog)
        srv = cls(loop, path, 0, on_accept, backlog, _fd=fd)
        srv.unix_path = path
        return srv

    def _on_event(self, fd: int, ev: int) -> None:
        while not self.closed:
            r = vtl.accept(self.fd)
            if r is None:
                break
            cfd, ip, port = r
            self.on_accept(cfd, ip, port)

    unix_path: Optional[str] = None

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self.loop.remove(self.fd)
        vtl.close(self.fd)
        if self.unix_path is not None:
            try:
                import os
                os.unlink(self.unix_path)
            except OSError:
                pass
