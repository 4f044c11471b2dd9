"""Processor SPI — pluggable L7 protocol engines for the proxy.

Functional analog of the reference's processor SPI
(processor/Processor.java:11-276 + ProcessorProvider.java:6): a TcpLB
with `protocol=<name>` drives every accepted connection through a
per-connection protocol session that may route each request/stream to a
different backend (Hint-based selection through the classify engine).

The reference SPI is pull-based (process() returns TODO{len, mode
handle|proxy, feed} instructions the library executes). This framework's
Connection layer is callback-driven, so the SPI here is push-based and
event-driven — same capabilities (per-frame backend selection, proxy
mode for bulk bytes, multiple backends per frontend), mapped 1:1 onto
handler callbacks instead of TODO objects:

    reference                         here
    ---------                         ----
    process().mode=handle + feed()    on_front_data / on_back_data
    HandleTODO.send + connTODO        engine.send_back(conn_id, data)
    HandleTODO.produce                engine.send_front(data)
    ConnectionTODO{-1, hint, chosen}  engine.connect(hint) -> conn_id
    proxy mode (bulk)                 the same callbacks (python relays
                                      in large chunks; the native splice
                                      pump covers protocol="tcp")
    disconnected() silent|kill        on_back_closed returning bool

The port's copy of vproxy_tpu/processors/base.py, same names and behaviour.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..rules.ir import Hint


class ProcessorEngine:
    """What a ProtoSession may call. Implemented by components/l7.py."""

    def send_front(self, data: bytes) -> None:
        raise NotImplementedError

    def send_back(self, conn_id: int, data: bytes) -> None:
        raise NotImplementedError

    def connect(self, hint: Optional[Hint]) -> int:
        """Open a backend connection selected via the upstream (hint goes
        through the classify engine). Returns a conn_id > 0. Raises
        OSError if no backend matches. The connection is established
        asynchronously; on_back_connected(conn_id) fires when writable.
        Data may be queued with send_back before that."""
        raise NotImplementedError

    def close_back(self, conn_id: int) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Tear down the whole session (frontend + all backends)."""
        raise NotImplementedError

    def pause_front(self) -> None: ...

    def resume_front(self) -> None: ...

    def pause_back(self, conn_id: int) -> None: ...

    def resume_back(self, conn_id: int) -> None: ...


class ProtoSession:
    """Per-frontend-connection protocol state machine."""

    def on_front_data(self, data: bytes) -> None:
        raise NotImplementedError

    def on_front_eof(self) -> None:
        """Frontend half-closed. Default: tear down."""
        self.engine.close()  # type: ignore[attr-defined]

    def on_back_connected(self, conn_id: int) -> None: ...

    def on_back_data(self, conn_id: int, data: bytes) -> None:
        raise NotImplementedError

    def on_back_eof(self, conn_id: int) -> None:
        self.engine.close_back(conn_id)  # type: ignore[attr-defined]

    def on_back_closed(self, conn_id: int, err: int) -> bool:
        """Backend gone. Return True if handled silently (session keeps
        going — Processor.DisconnectTODO.silent), False to kill the whole
        session."""
        return False

    def on_front_drained(self) -> None:
        """Frontend out-buffer flushed (resume proxying paused sources)."""

    def on_back_drained(self, conn_id: int) -> None: ...


class Processor:
    """Protocol factory registered under a name (ProcessorProvider)."""

    name: str = ""
    alpn: Optional[Sequence[str]] = None

    def session(self, engine: ProcessorEngine, client_addr) -> ProtoSession:
        raise NotImplementedError


class TcpRelaySession(ProtoSession):
    """Raw bidirectional relay through one backend — the handleDirect
    analog for fronts that cannot use the native splice pump (e.g. a
    TLS-terminated frontend, Proxy.java:65-149 with SSL buffers). The
    backend is selected on first data via hint_fn (SNI flows in here)."""

    def __init__(self, engine: ProcessorEngine, client_addr, hint_fn=None):
        self.engine = engine
        self.client_addr = client_addr
        self.hint_fn = hint_fn
        self.back: Optional[int] = None

    def _ensure(self) -> Optional[int]:
        if self.back is None:
            hint = self.hint_fn() if self.hint_fn is not None else None
            try:
                self.back = self.engine.open(self.engine.select(hint))
            except OSError:
                self.engine.close()
                return None
        return self.back

    def _mirror(self, data: bytes, outbound: bool) -> None:
        from ..utils.ip import parse_ip
        from ..utils.mirror import Mirror
        addr = self.client_addr
        try:
            cip = parse_ip(addr[0]) if addr else b"\x00\x00\x00\x00"
        except ValueError:
            cip = b"\x00\x00\x00\x00"
        cport = addr[1] if addr else 0
        if outbound:
            Mirror.get().mirror("proxy", data, dst_ip=cip, dst_port=cport)
        else:
            Mirror.get().mirror("proxy", data, src_ip=cip, src_port=cport)

    def on_front_data(self, data: bytes) -> None:
        from ..utils.mirror import Mirror
        if Mirror.get().hot:
            self._mirror(data, outbound=False)
        back = self._ensure()
        if back is not None:
            self.engine.send_back(back, data)

    def on_back_data(self, conn_id: int, data: bytes) -> None:
        from ..utils.mirror import Mirror
        if Mirror.get().hot:
            self._mirror(data, outbound=True)
        self.engine.send_front(data)

    def on_back_eof(self, conn_id: int) -> None:
        self.engine.close()

    def on_back_closed(self, conn_id: int, err: int) -> bool:
        return False


_REGISTRY: dict[str, Processor] = {}


def register(p: Processor) -> None:
    _REGISTRY[p.name] = p


def get(name: str) -> Optional[Processor]:
    _ensure_defaults()
    return _REGISTRY.get(name)


def names() -> list[str]:
    _ensure_defaults()
    return sorted(_REGISTRY)


_defaults_loaded = False


def _ensure_defaults() -> None:
    """Register built-ins lazily (DefaultProcessorRegistry.java:19-23:
    h2, int32-framed, dubbo, http1, general http)."""
    global _defaults_loaded
    if _defaults_loaded:
        return
    _defaults_loaded = True
    from . import framed, h2, http1  # noqa: F401  (self-registering)
