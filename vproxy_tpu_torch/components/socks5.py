"""Socks5Server — SOCKS5 proxy with upstream-backed target selection.

Parity: component/app/Socks5Server.java — domain CONNECTs become
Hint.ofHostPort lookups into the upstream (:63-66); IP CONNECTs are
matched against the backend server list (:73-82); unmatched targets are
only honored when allow_non_backend is set (direct connect). Handshake
is the RFC 1928 no-auth flow (socks/Socks5ProxyProtocolHandler.java).
After the reply, the session drops into the native splice pump.

The port's copy of vproxy_tpu/components/socks5.py, same names and behaviour.
"""
from __future__ import annotations

import socket
import struct
import threading
from typing import Optional

from ..net import vtl
from ..net.connection import Connection, Handler, ServerSock
from ..rules.ir import Hint, Proto
from ..utils.ip import format_ip, is_ip_literal, parse_ip
from .elgroup import EventLoopGroup
from .secgroup import SecurityGroup
from .servergroup import Connector
from .tcplb import TcpLB
from .upstream import Upstream

VER = 5
CMD_CONNECT = 1
ATYP_V4, ATYP_DOMAIN, ATYP_V6 = 1, 3, 4
REP_OK, REP_FAIL, REP_NOT_ALLOWED, REP_HOST_UNREACH, REP_CMD_UNSUP = 0, 1, 2, 4, 7


class Socks5Server(TcpLB):
    """Same resource shape as TcpLB (bind, elgroups, upstream, secgroup)
    with the SOCKS5 handshake instead of http/tcp classify."""

    # protocol reads "tcp" but every client speaks RFC 1928 first: the
    # C accept lanes must never raw-splice a SOCKS5 connection
    lanes_capable = False

    def __init__(self, alias: str, acceptor: EventLoopGroup,
                 worker: EventLoopGroup, bind_ip: str, bind_port: int,
                 backend: Upstream,
                 security_group: Optional[SecurityGroup] = None,
                 allow_non_backend: bool = False,
                 in_buffer_size: int = 65536, timeout_ms: int = 900_000):
        super().__init__(alias, acceptor, worker, bind_ip, bind_port, backend,
                         protocol="tcp", security_group=security_group,
                         in_buffer_size=in_buffer_size, timeout_ms=timeout_ms)
        self.allow_non_backend = allow_non_backend

    # override: every accepted conn goes through the handshake
    def _serve(self, loop, cfd: int, ip: str, port: int,
               t_acc=None, tid: int = 0) -> None:
        # tid: the accept path's trace context (unused here — the RFC
        # 1928 session has no span instrumentation yet)
        _Socks5Session(self, loop, cfd, ip, port)

    # ---------------------------------------------------------- selection

    def pick_target_async(self, client_ip: bytes, atyp: int, addr, port: int,
                          cb, loop=None) -> None:
        """Async pick_target: the domain classify rides the
        ClassifyService micro-batch queue; cb(connector, direct_addr)."""
        if atyp == ATYP_DOMAIN:
            def on_conn(c) -> None:
                if c is not None:
                    cb(c, None)
                elif self.allow_non_backend:
                    cb(None, (addr, port))
                else:
                    cb(None, None)
            self.backend.seek_async(client_ip, Hint.of_host_port(addr, port),
                                    on_conn, loop=loop)
            return
        cb(*self._pick_literal(addr, port))

    def pick_target(self, client_ip: bytes, atyp: int, addr, port: int
                    ) -> tuple[Optional[Connector], Optional[tuple[str, int]]]:
        """-> (connector, direct_addr). Only one is non-None on success."""
        if atyp == ATYP_DOMAIN:
            c = self.backend.seek(client_ip, Hint.of_host_port(addr, port))
            if c is not None:
                return c, None
            if self.allow_non_backend:
                return None, (addr, port)
            return None, None
        return self._pick_literal(addr, port)

    def _pick_literal(self, addr, port: int
                      ) -> tuple[Optional[Connector], Optional[tuple[str, int]]]:
        ip_str = format_ip(addr)
        # match the literal ip:port against known backend servers
        for h in self.backend.handles:
            for s in h.group.servers:
                if s.port == port and s.ip == ip_str and s.healthy:
                    return Connector(s, h.group), None
        if self.allow_non_backend:
            return None, (ip_str, port)
        return None, None


class _Socks5Session(Handler):
    ST_GREETING, ST_REQUEST, ST_DONE = range(3)

    def __init__(self, server: Socks5Server, loop, cfd: int, ip: str, port: int):
        self.server = server
        self.loop = loop
        self.client_ip = ip
        self.buf = bytearray()
        self.state = self.ST_GREETING
        self.conn = Connection(loop, cfd, (ip, port))
        self.conn.set_handler(self)

    def on_data(self, conn: Connection, data: bytes) -> None:
        self.buf += data
        if self.state == self.ST_GREETING:
            self._try_greeting(conn)
        if self.state == self.ST_REQUEST:
            self._try_request(conn)

    def _try_greeting(self, conn: Connection) -> None:
        if len(self.buf) < 2:
            return
        ver, n = self.buf[0], self.buf[1]
        if ver != VER:
            conn.close()
            return
        if len(self.buf) < 2 + n:
            return
        methods = self.buf[2: 2 + n]
        del self.buf[: 2 + n]
        if 0 not in methods:  # only no-auth supported
            conn.write(b"\x05\xff")
            self.loop.delay(20, conn.close)
            self.state = self.ST_DONE
            return
        conn.write(b"\x05\x00")
        self.state = self.ST_REQUEST

    def _try_request(self, conn: Connection) -> None:
        if len(self.buf) < 4:
            return
        ver, cmd, _rsv, atyp = self.buf[:4]
        if ver != VER:
            conn.close()
            return
        if atyp == ATYP_V4:
            need = 4 + 4 + 2
        elif atyp == ATYP_V6:
            need = 4 + 16 + 2
        elif atyp == ATYP_DOMAIN:
            if len(self.buf) < 5:
                return
            need = 4 + 1 + self.buf[4] + 2
        else:
            self._reply(conn, REP_FAIL)
            return
        if len(self.buf) < need:
            return
        if cmd != CMD_CONNECT:
            self._reply(conn, REP_CMD_UNSUP)
            return
        if atyp == ATYP_DOMAIN:
            dlen = self.buf[4]
            addr = bytes(self.buf[5:5 + dlen]).decode("latin-1")
            port = struct.unpack(">H", self.buf[5 + dlen:7 + dlen])[0]
        else:
            alen = 4 if atyp == ATYP_V4 else 16
            addr = bytes(self.buf[4:4 + alen])
            port = struct.unpack(">H", self.buf[4 + alen:6 + alen])[0]
        del self.buf[:need]
        self.state = self.ST_DONE

        # retries re-run THIS selection (hint-only seek) minus tried —
        # a CONNECT to db.example:5432 must never fail over to a backend
        # of some other service
        hint = (Hint.of_host_port(addr, port) if atyp == ATYP_DOMAIN
                else None)

        def picked(connector, direct) -> None:
            if conn.closed:
                return
            if connector is None and direct is None:
                self._reply(conn, REP_NOT_ALLOWED)
                return
            target = (connector.ip, connector.port) if connector else direct
            self._connect_and_splice(conn, connector, target, set(), hint)

        self.server.pick_target_async(
            parse_ip(self.client_ip), atyp, addr, port, picked, self.loop)

    def _reply(self, conn: Connection, rep: int) -> None:
        conn.write(b"\x05" + bytes([rep]) + b"\x00\x01\x00\x00\x00\x00\x00\x00")
        if rep != REP_OK:
            self.loop.delay(20, conn.close)

    def _connect_and_splice(self, conn: Connection, connector, target,
                            tried=None, hint=None) -> None:
        svr = connector.svr if connector else None
        if svr is not None:
            svr.conn_count += 1
        self.server._sessions_delta(1)
        # stop pulling client bytes into python: whatever is already in
        # session.buf is flushed to the backend at handover; everything
        # later stays in the kernel buffer for the pump
        conn.pause_reading()
        host, port = target
        if is_ip_literal(host):
            self._do_connect(conn, svr, host, port, self._mk_release(svr),
                             connector=connector, tried=tried, hint=hint)
            return
        # direct (allow_non_backend) domain target: resolve off-loop, then
        # continue on the loop (Socks5Server.java resolves via Resolver)
        release = self._mk_release(svr)

        def resolve() -> None:
            try:
                infos = socket.getaddrinfo(host, port, type=socket.SOCK_STREAM)
                ip = infos[0][4][0]
            except OSError:
                ip = None
            self.loop.run_on_loop(lambda: cont(ip))

        def cont(ip: Optional[str]) -> None:
            if conn.closed:
                release()
                return
            if ip is None:
                release()
                self._reply(conn, REP_HOST_UNREACH)
                return
            self._do_connect(conn, svr, ip, port, release)

        threading.Thread(target=resolve, name="socks5-resolve", daemon=True).start()

    def _mk_release(self, svr):
        lb = self.server
        released = [False]

        def release() -> None:
            if released[0]:
                return
            released[0] = True
            if svr is not None:
                svr.conn_count -= 1
            lb._sessions_delta(-1)
        return release

    def _retry_backend(self, conn: Connection, tried: set, hint) -> bool:
        """Pre-reply backend connect failed: re-run the ORIGINAL
        hint-only selection (never the global WRR — the client named a
        target) minus tried, under the shared TcpLB retry gate. Literal
        ip:port targets have no hint and therefore no alternatives; they
        don't retry. True when a new attempt owns the session."""
        lb = self.server
        if conn.closed or conn.detached or hint is None:
            return False
        src_ip = parse_ip(self.client_ip)
        c = lb._take_retry_slot(
            tried, f"socks5 {self.client_ip}",
            lambda: lb.backend.seek_host(src_ip, hint, exclude=tried))
        if c is None:
            return False
        self._connect_and_splice(conn, c, (c.ip, c.port), tried, hint)
        return True

    def _do_connect(self, conn: Connection, svr, ip: str, port: int,
                    release, connector=None, tried=None,
                    hint=None) -> None:
        lb = self.server
        session = self
        group = connector.group if connector is not None else None
        try:
            # bounded connect for BACKEND targets only: a SYN blackhole
            # times out into the same on_closed retry path a refusal
            # takes. Direct (allow-non-backend) targets are arbitrary
            # internet hosts with no retry alternative — they keep the
            # kernel's own connect deadline.
            back = Connection.connect(
                self.loop, ip, port,
                timeout_ms=(lb.connect_timeout_ms
                            if connector is not None else 0))
        except OSError as e:
            retried = False
            if group is not None and tried is not None:
                tried.add(svr)
                group.report_failure(svr, e.errno or 0)
                retried = self._retry_backend(conn, tried, hint)
            # release AFTER the retry decision: the new attempt's
            # increment keeps active_sessions from dipping to 0, which
            # drain_wait would misread as "drained"
            release()
            if not retried:
                self._reply(conn, REP_HOST_UNREACH)
            return
        class Back(Handler):
            connected = False

            def on_connected(self, bconn: Connection) -> None:
                self.connected = True
                if group is not None:
                    group.report_success(svr)
                    if tried:  # a retry attempt landed
                        lb._retries_total("success").incr()
                # keep early backend bytes in the kernel buffer for the pump
                bconn.pause_reading()
                session._reply(conn, REP_OK)
                leftover = bytes(session.buf)
                if leftover:
                    bconn.write(leftover)
                if bconn.out:
                    return
                self._handover(bconn)

            def on_drained(self, bconn: Connection) -> None:
                self._handover(bconn)

            def _handover(self, bconn: Connection) -> None:
                if bconn.detached or bconn.closed:
                    return
                if conn.closed:
                    # client went away before handover: drop the backend
                    # (on_closed below releases the counters)
                    bconn.close()
                    return
                front_desc = (f"{conn.remote[0]}:{conn.remote[1]}"
                              if conn.remote else "?")
                ffd = conn.detach()
                bfd = bconn.detach()
                if not vtl.pump_sets_nodelay():  # an older prebuilt .so only
                    vtl.set_nodelay(ffd)
                    vtl.set_nodelay(bfd)
                pid = session.loop.pump(ffd, bfd, lb.in_buffer_size,
                                        self._done)
                self._pid = pid
                # session/connection listing + the idle-timeout sweep
                # (the reference's tcpTimeout covers socks5 sessions too)
                lb._watch_pump(session.loop, pid,
                               f"{front_desc} -> {ip}:{port}")

            def _done(self, a2b: int, b2a: int, err: int) -> None:
                lb._unwatch_pump(session.loop, getattr(self, "_pid", None))
                lb.bytes_in += a2b
                lb.bytes_out += b2a
                if svr is not None:
                    svr.bytes_in += a2b
                    svr.bytes_out += b2a
                release()

            def on_closed(self, bconn: Connection, err: int) -> None:
                retried = False
                if not (conn.closed or conn.detached) \
                        and not self.connected and group is not None \
                        and tried is not None:
                    # nonblocking connect failed asynchronously: same
                    # retry re-entry as the sync raise above
                    tried.add(svr)
                    group.report_failure(svr, -err if err < 0 else err)
                    retried = session._retry_backend(conn, tried, hint)
                release()  # after the retry decision: no count dip
                if retried or conn.closed or conn.detached:
                    return
                session._reply(conn, REP_HOST_UNREACH)

        back.set_handler(Back())

    def on_eof(self, conn: Connection) -> None:
        conn.close()
