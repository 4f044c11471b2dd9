"""TLS termination over the Connection layer.

Functional analog of the reference's SSL ring buffers
(util/ringbuffer/SSLWrapRingBuffer.java:23 / SSLUnwrapRingBuffer.java:28
wrapping JDK SSLEngine): here `ssl.MemoryBIO` + `SSLObject` sit between
the raw Connection and the upper protocol handler. SNI is surfaced
during the handshake (the TlsExplorer peek, SSLUnwrapRingBuffer.java:
174-186) both to pick the certificate (holder.choose) and as a classify
Hint for tcp-mode relays.

TlsSocket quacks like Connection (write/close/close_graceful/pause/
resume/set_handler/out/bytes counters) so the L7 engine can drive a
TLS-terminated frontend unchanged.

The port's copy of vproxy_tpu/net/tls.py, same names and behaviour.
"""
from __future__ import annotations

import ssl
import threading
from typing import Optional

from .connection import Connection, Handler

# The SSLContext (and its sni_callback) is shared across connections; the
# callback fires synchronously inside do_handshake(), so the socket being
# handshaken is tracked per-thread (loop threads are single-writer).
_handshaking = threading.local()


def current_handshake_socket() -> Optional["TlsSocket"]:
    return getattr(_handshaking, "tls", None)


def install_sni_chooser(ctx: ssl.SSLContext, choose) -> None:
    """Install the holder's SNI dispatch on a shared front context:
    choose(server_name) -> SSLContext or None (keep the default)."""

    def _cb(sslobj, server_name, _ctx):
        tls = current_handshake_socket()
        if tls is not None:
            tls.sni = server_name
        chosen = choose(server_name)
        if chosen is not None and chosen is not ctx:
            sslobj.context = chosen
        return None

    ctx.sni_callback = _cb


class TlsSocket:
    """TLS endpoint layered on an established Connection. Server side by
    default (`context` is the shared front SSLContext built by the
    cert-key holder, with SNI dispatch via install_sni_chooser); with
    server_side=False it is the CLIENT side (the agent's wss transport)
    and emits its ClientHello immediately."""

    def __init__(self, conn: Connection, context: ssl.SSLContext,
                 server_side: bool = True,
                 server_hostname: Optional[str] = None):
        self.conn = conn
        self.loop = conn.loop
        self.remote = conn.remote
        self.handler: Handler = Handler()
        self.closed = False
        self.detached = False
        self.sni: Optional[str] = None
        self.alpn_selected: Optional[str] = None
        self.bytes_in = 0
        self.bytes_out = 0
        self._hs_done = False
        self._pending_plain = bytearray()  # writes queued during handshake
        self._in = ssl.MemoryBIO()
        self._out = ssl.MemoryBIO()
        self._obj = context.wrap_bio(self._in, self._out,
                                     server_side=server_side,
                                     server_hostname=server_hostname)
        conn.set_handler(_RawTlsHandler(self))
        if not server_side:
            self._step()  # drive the ClientHello into the out-BIO

    # ----------------------------------------------- Connection-like api

    def set_handler(self, h: Handler) -> None:
        self.handler = h

    def write(self, data: bytes) -> None:
        if self.closed:
            return
        if not self._hs_done:
            self._pending_plain += data
            return
        self._write_plain(data)

    def close(self, err: int = 0) -> None:
        if self.closed:
            return
        self.closed = True
        self.conn.close(err)
        self.handler.on_closed(self, err)

    def close_graceful(self) -> None:
        if self.closed:
            return
        try:
            self._obj.unwrap()  # queue close_notify
        except (ssl.SSLError, OSError, ValueError):
            pass
        self._flush_out()
        self.closed = True
        self.conn.close_graceful()

    def pause_reading(self) -> None:
        self.conn.pause_reading()

    def resume_reading(self) -> None:
        self.conn.resume_reading()

    def feed_raw(self, data: bytes) -> None:
        """Inject ciphertext that was consumed from the Connection BEFORE
        this TlsSocket took it over (an SNI sniffer's buffered bytes)."""
        self._in.write(data)
        self._step()

    # -------------------------------------------------------- internals

    def _mirror(self, data: bytes, outbound: bool) -> None:
        """vmirror "ssl" origin: the only place decrypted bytes exist
        (Mirror.java's SSL-plaintext tap)."""
        from ..utils.ip import parse_ip
        from ..utils.mirror import Mirror
        try:
            rip = parse_ip(self.remote[0])
        except (ValueError, TypeError):
            rip = b"\x00\x00\x00\x00"
        rport = self.remote[1] if self.remote else 0
        if outbound:
            Mirror.get().mirror("ssl", data, src_ip=None, dst_ip=rip,
                                dst_port=rport)
        else:
            Mirror.get().mirror("ssl", data, src_ip=rip, dst_ip=None,
                                src_port=rport)

    def _write_plain(self, data: bytes) -> None:
        from ..utils.mirror import Mirror
        if Mirror.get().hot:
            self._mirror(data, outbound=True)
        try:
            view = memoryview(data)
            while view:
                n = self._obj.write(view[:65536])
                view = view[n:]
        except (ssl.SSLError, OSError):
            self.close(1)
            return
        self.bytes_out += len(data)
        self._flush_out()

    def _flush_out(self) -> None:
        if self._out.pending and not self.conn.closed:
            self.conn.write(self._out.read())

    def _step(self) -> None:
        """Drive handshake + reads after raw bytes land in the in-BIO."""
        if self.closed:
            return
        if not self._hs_done:
            _handshaking.tls = self
            try:
                self._obj.do_handshake()
            except ssl.SSLWantReadError:
                self._flush_out()
                return
            except (ssl.SSLError, OSError):
                self._flush_out()
                self.close(1)
                return
            finally:
                _handshaking.tls = None
            self._hs_done = True
            try:
                self.alpn_selected = self._obj.selected_alpn_protocol()
            except Exception:
                self.alpn_selected = None
            self._flush_out()
            self.handler.on_connected(self)
            if self._pending_plain:
                pending, self._pending_plain = self._pending_plain, bytearray()
                self._write_plain(bytes(pending))
        # decrypt application data
        while not self.closed:
            try:
                plain = self._obj.read(65536)
            except ssl.SSLWantReadError:
                break
            except ssl.SSLZeroReturnError:
                self._flush_out()
                self.handler.on_eof(self)
                return
            except (ssl.SSLError, OSError):
                self.close(1)
                return
            if not plain:
                self._flush_out()
                self.handler.on_eof(self)
                return
            self.bytes_in += len(plain)
            from ..utils.mirror import Mirror
            if Mirror.get().hot:
                self._mirror(plain, outbound=False)
            self.handler.on_data(self, plain)
        self._flush_out()

    @property
    def out(self):
        """Unflushed (ciphertext) output — the backpressure signal the L7
        engine watches, same meaning as Connection.out."""
        return self.conn.out


class _RawTlsHandler(Handler):
    def __init__(self, tls: TlsSocket):
        self.tls = tls

    def on_data(self, conn: Connection, data: bytes) -> None:
        self.tls._in.write(data)
        self.tls._step()

    def on_eof(self, conn: Connection) -> None:
        self.tls._in.write_eof()
        self.tls._step()
        if not self.tls.closed:
            self.tls.handler.on_eof(self.tls)

    def on_closed(self, conn: Connection, err: int) -> None:
        if not self.tls.closed:
            self.tls.closed = True
            self.tls.handler.on_closed(self.tls, err)

    def on_drained(self, conn: Connection) -> None:
        self.tls.handler.on_drained(self.tls)


def client_context(verify: bool = True) -> ssl.SSLContext:
    ctx = ssl.create_default_context()
    if not verify:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    return ctx
