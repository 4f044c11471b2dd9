"""Length-framed protocol processors: generic int32-framed and Dubbo.

Parity: processor/common/HeadPayloadProcessor.java:6 (generic protocols
with a fixed-size head carrying the payload length at a fixed offset)
and processor/dubbo/DubboProcessor.java (head 16 bytes, 4-byte payload
length at offset 12). Sessions pick one backend on the first frame
(hint=None -> plain upstream WRR) and relay whole frames; frame
boundaries are tracked both ways so a backend lost between frames can be
replaced silently (the reference's silent DisconnectTODO), mid-frame
loss kills the session.

The port's copy of vproxy_tpu/processors/framed.py, same names and behaviour.
"""
from __future__ import annotations

from typing import Optional

from .base import Processor, ProcessorEngine, ProtoSession, register


class _FrameScanner:
    """Tracks frame boundaries: head of `head_len` bytes, payload length =
    int at [off, off+len_bytes) big-endian (+head itself not counted)."""

    def __init__(self, head_len: int, off: int, len_bytes: int, max_frame: int):
        self.head_len = head_len
        self.off = off
        self.len_bytes = len_bytes
        self.max_frame = max_frame
        self.head = bytearray()
        self.payload_left = 0
        self.error: Optional[str] = None

    def at_boundary(self) -> bool:
        return not self.head and self.payload_left == 0

    def feed(self, data: bytes) -> int:
        """Consume data (it is relayed verbatim elsewhere); returns number
        of complete frames that ENDED inside this chunk."""
        ended = 0
        pos = 0
        n = len(data)
        while pos < n:
            if self.payload_left:
                take = min(self.payload_left, n - pos)
                self.payload_left -= take
                pos += take
                if self.payload_left == 0:
                    ended += 1
                continue
            need = self.head_len - len(self.head)
            take = min(need, n - pos)
            self.head += data[pos:pos + take]
            pos += take
            if len(self.head) < self.head_len:
                break
            ln = int.from_bytes(
                self.head[self.off:self.off + self.len_bytes], "big")
            self.head = bytearray()
            if ln < 0 or ln > self.max_frame:
                self.error = f"frame length {ln} out of range"
                break
            if ln == 0:
                ended += 1
            else:
                self.payload_left = ln
        return ended


class FramedSession(ProtoSession):
    def __init__(self, engine: ProcessorEngine, proc: "HeadPayloadProcessor"):
        self.engine = engine
        self.proc = proc
        self.back: Optional[int] = None
        self.fscan = proc.scanner()
        self.bscan = proc.scanner()
        self.in_flight = 0  # frames sent minus responses completed

    def _ensure_back(self) -> Optional[int]:
        if self.back is not None:
            return self.back
        try:
            sel = self.engine.select(None)
            self.back = self.engine.open(sel)
        except OSError:
            self.engine.close()
            return None
        return self.back

    def on_front_data(self, data: bytes) -> None:
        back = self._ensure_back()
        if back is None:
            return
        self.in_flight += self.fscan.feed(data)
        if self.fscan.error:
            self.engine.close()
            return
        self.engine.send_back(back, data)

    def on_back_data(self, conn_id: int, data: bytes) -> None:
        done = self.bscan.feed(data)
        if self.bscan.error:
            self.engine.close()
            return
        self.in_flight = max(0, self.in_flight - done)
        self.engine.send_front(data)

    def on_back_closed(self, conn_id: int, err: int) -> bool:
        self.back = None
        # lost between frames with nothing outstanding: next frame reconnects
        if self.fscan.at_boundary() and self.bscan.at_boundary() and \
                self.in_flight == 0:
            return True
        return False

    def on_back_eof(self, conn_id: int) -> None:
        self.engine.close_back(conn_id)


class HeadPayloadProcessor(Processor):
    def __init__(self, name: str, head_len: int, off: int, len_bytes: int,
                 max_frame: int = 16 * 1024 * 1024):
        self.name = name
        self.head_len = head_len
        self.off = off
        self.len_bytes = len_bytes
        self.max_frame = max_frame

    def scanner(self) -> _FrameScanner:
        return _FrameScanner(self.head_len, self.off, self.len_bytes,
                             self.max_frame)

    def session(self, engine: ProcessorEngine, client_addr) -> FramedSession:
        return FramedSession(engine, self)


# dubbo wire: 2B magic, 1B flags, 1B status, 8B request id, 4B body length
register(HeadPayloadProcessor("dubbo", head_len=16, off=12, len_bytes=4))
# generic 4-byte big-endian length-prefixed framing
register(HeadPayloadProcessor("framed-int32", head_len=4, off=0, len_bytes=4))
