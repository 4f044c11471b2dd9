"""Shadowsocks server protocol (aes-256-cfb) for the WebSocks server.

Parity: vproxyx/websocks/ss/SSProtocolHandler.java:196 — the reference's
websocks server can speak plain shadowsocks so stock ss clients use it
as an exit. Wire format (shadowsocks AEAD-less stream ciphers):

  client -> server:  IV(16) || AES-256-CFB( atyp(1) addr port(2) data... )
  server -> client:  IV(16) || AES-256-CFB( data... )

atyp/addr as in SOCKS5 (1=IPv4(4B), 3=domain(len||bytes), 4=IPv6(16B)).
Key = EVP_BytesToKey(MD5, password) like the original ss tools, so any
stock client with method aes-256-cfb interoperates.

The cipher is a stream: each direction keeps ONE incremental CFB
context for the connection's lifetime.

The port's copy of vproxy_tpu/websocks/ss.py, same names and behaviour.
"""
from __future__ import annotations

import hashlib
import os
import struct
from typing import Callable, Optional

from ..net import vtl
from ..net.connection import Connection, Handler, ServerSock
from ..net.eventloop import SelectorEventLoop
from ..utils.log import Logger

_log = Logger("ss")


def evp_bytes_to_key(password: str, key_len: int = 32) -> bytes:
    """OpenSSL EVP_BytesToKey with MD5, no salt — the shadowsocks KDF."""
    out = b""
    prev = b""
    pw = password.encode()
    while len(out) < key_len:
        prev = hashlib.md5(prev + pw).digest()
        out += prev
    return out[:key_len]


class CfbStream:
    """Incremental AES-256-CFB en/decryptor (one per direction)."""

    def __init__(self, key: bytes, iv: bytes, encrypt: bool):
        from cryptography.hazmat.primitives.ciphers import (Cipher,
                                                            algorithms,
                                                            modes)
        c = Cipher(algorithms.AES(key), modes.CFB(iv))
        self._ctx = c.encryptor() if encrypt else c.decryptor()

    def update(self, data: bytes) -> bytes:
        return self._ctx.update(data)


class _SSSession(Handler):
    """One client connection: IV -> address -> connect -> relay."""

    def __init__(self, server: "SSServer", loop, conn: Connection):
        self.server = server
        self.loop = loop
        self.conn = conn
        self.buf = bytearray()
        self.dec: Optional[CfbStream] = None
        self.enc: Optional[CfbStream] = None
        self.back: Optional[Connection] = None
        self.addr_done = False  # address parsed, back connect in flight
        self.back_up = False
        self.early = bytearray()  # decrypted payload before back is up
        self.dead = False
        conn.set_handler(self)

    # ------------------------------------------------------ front events

    def on_data(self, c: Connection, data: bytes) -> None:
        if self.dec is None:
            self.buf.extend(data)
            if len(self.buf) < 16:
                return
            iv, rest = bytes(self.buf[:16]), bytes(self.buf[16:])
            self.buf = bytearray()
            self.dec = CfbStream(self.server.key, iv, encrypt=False)
            data = rest
            if not data:
                return
        plain = self.dec.update(data)
        if not self.addr_done:
            self.buf.extend(plain)
            self._try_addr()
        elif not self.back_up:
            self.early.extend(plain)
        else:
            self.back.write(plain)
            if self.back.out:  # backpressure: pause the faster side
                self.conn.pause_reading()

    def on_drained(self, c: Connection) -> None:
        # client out-buffer flushed: resume the backend
        if self.back_up and not self.dead:
            self.back.resume_reading()

    def on_eof(self, c: Connection) -> None:
        self._close()

    def on_closed(self, c: Connection, err: int) -> None:
        self._close()

    def _close(self) -> None:
        if self.dead:
            return
        self.dead = True
        self.conn.close()
        if self.back is not None:
            self.back.close()
        self.server.sessions -= 1

    # --------------------------------------------------- address + relay

    def _try_addr(self) -> None:
        b = self.buf
        if len(b) < 1:
            return
        atyp = b[0]
        if atyp == 1:
            need = 1 + 4 + 2
            if len(b) < need:
                return
            host = ".".join(str(x) for x in b[1:5])
        elif atyp == 4:
            need = 1 + 16 + 2
            if len(b) < need:
                return
            import socket as s
            host = s.inet_ntop(s.AF_INET6, bytes(b[1:17]))
        elif atyp == 3:
            if len(b) < 2:
                return
            dl = b[1]
            need = 2 + dl + 2
            if len(b) < need:
                return
            host = bytes(b[2:2 + dl]).decode("ascii", "replace")
        else:
            _log.alert(f"ss: bad atyp {atyp}")
            self._close()
            return
        (port,) = struct.unpack(">H", b[need - 2:need])
        self.early.extend(b[need:])
        self.buf = bytearray()
        self.addr_done = True
        self.server.resolve(self.loop, host, lambda ip:
                            self._connect(ip, port))

    def _connect(self, ip: Optional[str], port: int) -> None:
        if self.dead:
            return
        if ip is None:
            self._close()
            return
        try:
            back = Connection.connect(self.loop, ip, port)
        except OSError:
            self._close()
            return
        self.back = back
        sess = self

        class Back(Handler):
            def on_connected(self, bc: Connection) -> None:
                sess.back_up = True
                # server->client stream starts with our IV
                iv = os.urandom(16)
                sess.enc = CfbStream(sess.server.key, iv, encrypt=True)
                sess.conn.write(iv)
                if sess.early:
                    bc.write(bytes(sess.early))
                    sess.early = bytearray()

            def on_data(self, bc: Connection, data: bytes) -> None:
                if sess.enc is not None and not sess.dead:
                    sess.conn.write(sess.enc.update(data))
                    if sess.conn.out:  # backpressure on a slow client
                        bc.pause_reading()

            def on_drained(self, bc: Connection) -> None:
                if not sess.dead:
                    sess.conn.resume_reading()

            def on_eof(self, bc: Connection) -> None:
                sess._close()

            def on_closed(self, bc: Connection, err: int) -> None:
                sess._close()

        back.set_handler(Back())


def _default_resolve(loop, host: str, cb: Callable[[Optional[str]], None]):
    from .server import _default_resolve as d
    d(loop, host, cb)


class SSServer:
    """Plain shadowsocks exit speaking aes-256-cfb."""

    def __init__(self, alias: str, loop: SelectorEventLoop, bind_ip: str,
                 bind_port: int, password: str, resolve=None):
        self.alias = alias
        self.loop = loop
        self.key = evp_bytes_to_key(password)
        self.resolve = resolve or _default_resolve
        self.bind_ip = bind_ip
        self.bind_port = bind_port
        self.sessions = 0
        self.accepted = 0
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

    def _on_accept(self, fd: int, ip: str, port: int) -> None:
        self.accepted += 1
        self.sessions += 1
        try:
            conn = Connection(self.loop, fd, (ip, port))
        except OSError:
            self.sessions -= 1
            vtl.close(fd)
            return
        _SSSession(self, self.loop, conn)
