"""WebSocks TLS front, SNI-based relay, and the direct-relay machinery.

Parity targets (reference):
* TLS/wss listener + SNI dispatch — WebSocksProtocolHandler.java:540 and
  WebSocksUtils/ssl setup: the server listens with a real certificate;
  a ClientHello whose SNI is NOT one of the server's own domains is not
  terminated at all but relayed as raw TCP to that host:443, so probes
  see a genuine TLS site (the camouflage story).
* DomainBinder — vproxyx/websocks/relay/DomainBinder.java:148: leases a
  fake IP per proxied domain (with TTL) so the agent's DNS answers give
  the OS a connectable address.
* RelayHttpsServer — relay/RelayHttpsServer.java:289: accepts on the
  fake IPs, recovers the domain from the accepted socket's LOCAL
  address (the client connected to the fake IP), and tunnels to
  domain:443 through the websocks server without touching the TLS
  bytes.

Notes: the fake-IP pool lives in 127.64.0.0/10 — on Linux the
whole 127/8 is locally bindable/connectable, so tests and single-host
agents need no interface configuration (the reference uses TUN/TAP or
requires route setup for its 100.64/10 pool).

The port's copy of vproxy_tpu/websocks/tls_relay.py, same names and behaviour.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Callable, Optional

from ..net import vtl
from ..net.connection import Connection, Handler, ServerSock
from ..net.eventloop import SelectorEventLoop
from ..net.tls import TlsSocket
from ..utils.log import Logger

_log = Logger("websocks-tls")


# ------------------------------------------------------------ SNI sniff


def parse_client_hello_sni(buf: bytes):
    """-> ("need", None) while incomplete, ("bad", None) if not a TLS
    ClientHello, ("ok", sni_or_None) once the ClientHello is complete.

    Accumulates handshake bytes across TLS records (a ClientHello may
    span records). Only the server_name extension (RFC 6066) is read.
    """
    hs = bytearray()
    off = 0
    while True:
        if len(buf) - off < 5:
            break
        ctype, ver, rlen = buf[off], buf[off + 1:off + 3], \
            struct.unpack(">H", buf[off + 3:off + 5])[0]
        if ctype != 0x16 or ver[0] != 3:
            return ("bad", None) if not hs and off == 0 else ("need", None)
        if len(buf) - off - 5 < rlen:
            break
        hs += buf[off + 5: off + 5 + rlen]
        off += 5 + rlen
        if len(hs) >= 4:
            mlen = int.from_bytes(hs[1:4], "big")
            if len(hs) - 4 >= mlen:
                break
    if len(hs) < 4:
        return ("need", None)
    if hs[0] != 0x01:  # not ClientHello
        return ("bad", None)
    mlen = int.from_bytes(hs[1:4], "big")
    if len(hs) - 4 < mlen:
        return ("need", None)
    try:
        return ("ok", _sni_from_client_hello(bytes(hs[4: 4 + mlen])))
    except (IndexError, struct.error):
        return ("bad", None)


def _sni_from_client_hello(b: bytes) -> Optional[str]:
    p = 2 + 32  # client_version + random
    sid = b[p]
    p += 1 + sid
    (cs_len,) = struct.unpack(">H", b[p:p + 2])
    p += 2 + cs_len
    cm = b[p]
    p += 1 + cm
    if p + 2 > len(b):
        return None  # no extensions
    (ext_len,) = struct.unpack(">H", b[p:p + 2])
    p += 2
    end = min(p + ext_len, len(b))
    while p + 4 <= end:
        etype, elen = struct.unpack(">HH", b[p:p + 4])
        p += 4
        if etype == 0:  # server_name
            q = p + 2  # skip server_name_list length
            if q + 3 <= p + elen:
                ntype = b[q]
                (nlen,) = struct.unpack(">H", b[q + 1:q + 3])
                if ntype == 0:
                    return b[q + 3: q + 3 + nlen].decode("ascii", "replace")
        p += elen
    return None


# ------------------------------------------------------ TLS front server


class WebSocksTlsFrontend:
    """TLS listener in front of a WebSocksProxyServer.

    SNI in `self_domains` (or absent) -> terminate TLS with the holder's
    certificate and run the normal WebSocks session over the plaintext.
    Any other SNI -> raw TCP relay to (sni, relay_port): the listener is
    indistinguishable from a TLS reverse proxy for that site.
    """

    def __init__(self, server, holder, bind_ip: str, bind_port: int,
                 self_domains: Optional[list] = None, relay_port: int = 443):
        self.server = server
        self.loop: SelectorEventLoop = server.loop
        self.holder = holder
        self.bind_ip = bind_ip
        self.bind_port = bind_port
        self.self_domains = list(self_domains or [])
        self.relay_port = relay_port
        self.relayed = 0
        self.terminated = 0
        self.sock: Optional[ServerSock] = None

    def start(self) -> None:
        self.sock = self.loop.call_sync(lambda: ServerSock(
            self.loop, self.bind_ip, self.bind_port, self._on_accept))
        if self.bind_port == 0:
            self.bind_port = self.sock.port

    def stop(self) -> None:
        if self.sock is not None:
            self.loop.run_on_loop(self.sock.close)
            self.sock = None

    def _is_self(self, sni: Optional[str]) -> bool:
        if sni is None:
            return True
        if sni in self.self_domains:
            return True
        return any(ck.matches(sni) for ck in self.holder.cert_keys)

    def _on_accept(self, fd: int, ip: str, port: int) -> None:
        front = self
        conn = Connection(self.loop, fd, (ip, port))
        buf = bytearray()

        class Sniff(Handler):
            def on_data(self, c: Connection, data: bytes) -> None:
                buf.extend(data)
                state, sni = parse_client_hello_sni(bytes(buf))
                if state == "need" and len(buf) < 32768:
                    return
                if state == "bad" or state == "need":
                    c.close()
                    return
                c.pause_reading()
                if front._is_self(sni):
                    front.terminated += 1
                    front._terminate(c, bytes(buf))
                else:
                    front.relayed += 1
                    front._relay(c, sni, bytes(buf))

            def on_eof(self, c: Connection) -> None:
                c.close()

        conn.set_handler(Sniff())

    def _terminate(self, conn: Connection, sniffed: bytes) -> None:
        """Own-domain path: TLS handshake with our cert, then the normal
        WebSocks session machine over the decrypted stream."""
        from .server import _Duplex, _Session

        tls = TlsSocket(conn, self.holder.front_context)
        # conn=None: the session must NOT detach the raw fd for a native
        # pump handover — the raw stream is ciphertext and the TLS state
        # lives here in Python; tunneled bytes relay through tls.write
        dup = _Duplex(tls.write, tls.close, conn=None)
        sess = _Session(self.server, self.loop, dup)

        class Plain(Handler):
            def on_data(self, t, data: bytes) -> None:
                sess.on_data(data)

            def on_eof(self, t) -> None:
                sess.close()

            def on_closed(self, t, err: int) -> None:
                sess.close()

        tls.set_handler(Plain())
        conn.resume_reading()
        tls.feed_raw(sniffed)

    def _relay(self, conn: Connection, sni: str, sniffed: bytes) -> None:
        """Foreign-SNI path: raw TCP relay to (sni, relay_port); the TLS
        session passes through untouched (we never hold its keys).
        After the sniffed head drains to the backend both fds hand over
        to the native splice pump."""
        loop = self.loop
        front_dead = []

        def connect(ipaddr: Optional[str]) -> None:
            if ipaddr is None or conn.closed:
                conn.close()
                return
            try:
                back = Connection.connect(loop, ipaddr, self.relay_port)
            except OSError:
                conn.close()
                return

            class Back(Handler):
                def on_connected(self, b: Connection) -> None:
                    b.pause_reading()
                    if front_dead:
                        b.close()
                        return
                    b.write(sniffed)
                    if not b.out:
                        self.on_drained(b)

                def on_drained(self, b: Connection) -> None:
                    if b.detached or b.closed:
                        return
                    if front_dead or conn.closed or conn.detached:
                        b.close()
                        return
                    bfd = b.detach()
                    ffd = conn.detach()
                    if not vtl.pump_sets_nodelay():  # an older prebuilt .so
                        vtl.set_nodelay(ffd)
                        vtl.set_nodelay(bfd)
                    loop.pump(ffd, bfd, 65536, None)

                def on_closed(self, b: Connection, err: int) -> None:
                    if not conn.detached:
                        conn.close()

                def on_eof(self, b: Connection) -> None:
                    b.close()

            back.set_handler(Back())

            class FrontWait(Handler):
                def on_eof(self, c: Connection) -> None:
                    front_dead.append(1)
                    c.close()

                def on_closed(self, c: Connection, err: int) -> None:
                    front_dead.append(1)

            conn.set_handler(FrontWait())

        self.server.resolve(loop, sni, connect)


# -------------------------------------------------------- domain binder


class DomainBinder:
    """domain <-> fake-IP leases with TTL (DomainBinder.java:148).

    Pool: 127.64.0.0/10 (~4M addresses). A lease is refreshed on every
    bind/lookup; expired leases are reclaimed lazily on allocation."""

    BASE = (127 << 24) | (64 << 16)
    SIZE = 1 << 22

    def __init__(self, ttl_s: float = 300.0):
        self.ttl = ttl_s
        self._by_domain: dict = {}  # domain -> [ip_int, expiry]
        self._by_ip: dict = {}      # ip_int -> domain
        self._next = 1

    @staticmethod
    def _fmt(ip_int: int) -> str:
        return socket.inet_ntoa(struct.pack(">I", ip_int))

    def bind(self, domain: str) -> str:
        """Lease (or refresh) the fake IP for a domain."""
        now = time.monotonic()
        ent = self._by_domain.get(domain)
        if ent is not None:
            ent[1] = now + self.ttl
            return self._fmt(ent[0])
        for _ in range(self.SIZE):
            cand = self.BASE + self._next
            self._next = self._next % (self.SIZE - 2) + 1
            old = self._by_ip.get(cand)
            if old is None:
                break
            oent = self._by_domain.get(old)
            if oent is None or oent[1] < now:  # expired: reclaim
                self._by_domain.pop(old, None)
                break
        else:
            raise OSError("fake-IP pool exhausted")
        self._by_ip[cand] = domain
        self._by_domain[domain] = [cand, now + self.ttl]
        return self._fmt(cand)

    def lookup_ip(self, ip: str) -> Optional[str]:
        """fake IP -> domain (refreshes the lease), None if unknown or
        expired."""
        try:
            (ip_int,) = struct.unpack(">I", socket.inet_aton(ip))
        except OSError:
            return None
        domain = self._by_ip.get(ip_int)
        if domain is None:
            return None
        ent = self._by_domain.get(domain)
        now = time.monotonic()
        if ent is None or ent[1] < now:
            self._by_ip.pop(ip_int, None)
            self._by_domain.pop(domain, None)
            return None
        ent[1] = now + self.ttl
        return domain


# --------------------------------------------------- direct relay server


class DirectRelayServer:
    """Accepts connections addressed to DomainBinder fake IPs and
    tunnels them to (domain, target_port) through the agent
    (RelayHttpsServer.java:289). The domain comes from the accepted
    socket's LOCAL address — the client connected to the fake IP the
    agent's DNS handed out; the TLS (or any) bytes pass through opaque.

    Binds 0.0.0.0 so every 127.64/10 address is accepted on one socket.
    """

    def __init__(self, agent, binder: DomainBinder, bind_port: int = 443,
                 target_port: Optional[int] = None, bind_ip: str = "0.0.0.0"):
        self.agent = agent
        self.binder = binder
        self.loop: SelectorEventLoop = agent.loop
        self.bind_ip = bind_ip
        self.bind_port = bind_port
        # None = same port the client aimed at (our bind port)
        self.target_port = target_port
        self.relayed = 0
        self.sock: Optional[ServerSock] = None

    def start(self) -> None:
        self.sock = self.loop.call_sync(lambda: ServerSock(
            self.loop, self.bind_ip, self.bind_port, self._on_accept))
        if self.bind_port == 0:
            self.bind_port = self.sock.port

    def stop(self) -> None:
        if self.sock is not None:
            self.loop.run_on_loop(self.sock.close)
            self.sock = None

    @staticmethod
    def _local_ip(fd: int) -> Optional[str]:
        try:
            s = socket.socket(fileno=os.dup(fd))
        except OSError:
            return None
        try:
            return s.getsockname()[0]
        finally:
            s.close()

    def _on_accept(self, fd: int, ip: str, port: int) -> None:
        local = self._local_ip(fd)
        domain = None if local is None else self.binder.lookup_ip(local)
        if domain is None:
            _log.alert(f"direct-relay: no binding for {local}")
            vtl.close(fd)
            return
        conn = Connection(self.loop, fd, (ip, port))
        conn.pause_reading()
        early = bytearray()

        class FrontWait(Handler):
            def on_data(self, c: Connection, data: bytes) -> None:
                early.extend(data)

            def on_eof(self, c: Connection) -> None:
                c.close()

        conn.set_handler(FrontWait())
        self.relayed += 1
        target = self.bind_port if self.target_port is None \
            else self.target_port

        def up(tunnel) -> None:
            if tunnel is None:
                conn.close()
                return
            if conn.closed:
                tunnel.close()
                return
            if early:
                tunnel.write(bytes(early))

            class Front(Handler):
                def on_data(self, c: Connection, data: bytes) -> None:
                    tunnel.write(data)

                def on_eof(self, c: Connection) -> None:
                    tunnel.close()
                    c.close()

                def on_closed(self, c: Connection, err: int) -> None:
                    tunnel.close()

            conn.set_handler(Front())
            tunnel.set_sink(conn.write, lambda: conn.close())
            conn.resume_reading()

        self.agent.open_tunnel(domain, target, up)
