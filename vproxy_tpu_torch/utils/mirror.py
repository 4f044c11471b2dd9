"""vmirror — filtered traffic capture to pcap with JSON hot-reload.

Parity: the reference's base/src/main/java/vmirror/Mirror.java:18-89 and
doc/mirror-example.json. The reference taps chosen origins (switch
frames, SSL-plaintext ring buffers, ...) behind filters and re-emits
synthetic ethernet frames into a TAP device for wireshark. The TPU-era
redesign emits a standard pcap FILE instead (no kernel device needed;
wireshark/tcpdump read it directly); origins here:

  * "switch" — ethernet frames entering the vswitch stack (raw frames,
    no synthesis needed);
  * "ssl"    — TLS plaintext at the termination boundary, both
    directions (the only place decrypted bytes exist);
  * "proxy"  — L7 relay payload through ProcessorEngine sessions.

Config (JSON, hot-reloaded on mtime change, checked at most once per
second from the data path):

    {"enabled": true,
     "output": "/tmp/capture.pcap",
     "origins": [
        {"origin": "ssl",
         "filters": [{"network": "10.0.0.0/8", "port": 443}]},
        {"origin": "switch"}          # no filters = everything
     ]}

A filter matches when every present field matches either endpoint
(network = CIDR against src/dst ip, port against src/dst port). An
origin with no filters captures all. The process-wide instance is
Mirror.get(); VPROXY_TPU_MIRROR=<path> arms it at first use. Hot paths
gate on the plain-bool `Mirror.get().active` before building any
metadata.

The port's copy of vproxy_tpu/utils/mirror.py, same names and behaviour.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import time
from typing import Optional

from .ip import Network, parse_ip
from .log import Logger

_log = Logger("mirror")

LINKTYPE_EN10MB = 1


class PcapWriter:
    """Minimal classic-pcap writer (microsecond timestamps)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "ab")
        if self._f.tell() == 0:
            self._f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0,
                                      65535, LINKTYPE_EN10MB))
            self._f.flush()

    def write(self, frame: bytes) -> None:
        ts = time.time()
        self._f.write(struct.pack("<IIII", int(ts), int(ts % 1 * 1e6),
                                  len(frame), len(frame)) + frame)
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class _Filter:
    def __init__(self, cfg: dict):
        self.network: Optional[Network] = None
        if cfg.get("network"):
            net = cfg["network"]
            if "/" not in net:
                raw = parse_ip(net)
                net = f"{net}/{32 if len(raw) == 4 else 128}"
            # Network.parse validates host bits — a silently-never-
            # matching filter is worse than a rejected config
            self.network = Network.parse(net)
        self.port = int(cfg["port"]) if cfg.get("port") else None

    def match(self, src_ip, dst_ip, src_port, dst_port) -> bool:
        if self.network is not None:
            ok = False
            for ip in (src_ip, dst_ip):
                if ip is not None and self.network.contains_ip(ip):
                    ok = True
            if not ok:
                return False
        if self.port is not None and self.port not in (src_port, dst_port):
            return False
        return True


def _synth_tcp_frame(src_ip: bytes, dst_ip: bytes, src_port: int,
                     dst_port: int, payload: bytes) -> bytes:
    """Fake ether+ip+tcp around a plaintext payload (Mirror.java builds
    the same shape so wireshark can dissect flows)."""
    v6 = len(src_ip) == 16 or len(dst_ip) == 16

    def pad(ip: bytes) -> bytes:
        if v6 and len(ip) == 4:
            return b"\x00" * 10 + b"\xff\xff" + ip
        return ip

    src_ip, dst_ip = pad(src_ip), pad(dst_ip)
    # synthetic locally-administered macs derived from the ip tails
    eth = (b"\x02" + (b"\x00" * 5 + dst_ip)[-5:]) + \
        (b"\x02" + (b"\x00" * 5 + src_ip)[-5:]) + \
        (b"\x86\xdd" if v6 else b"\x08\x00")
    tcp = struct.pack(">HHIIBBHHH", src_port, dst_port, 0, 0,
                      5 << 4, 0x18, 65535, 0, 0) + payload  # PSH|ACK
    if v6:
        ip = struct.pack(">IHBB", 6 << 28, len(tcp), 6, 64) + src_ip + dst_ip
    else:
        ip = struct.pack(">BBHHHBBH", 0x45, 0, 20 + len(tcp), 0, 0, 64, 6,
                         0) + src_ip + dst_ip
    return eth + ip + tcp


class Mirror:
    """Process-wide mirror registry. `active` is a plain bool so hot
    paths pay one attribute read when mirroring is off."""

    _instance: Optional["Mirror"] = None
    _ilock = threading.Lock()

    @classmethod
    def get(cls) -> "Mirror":
        inst = cls._instance
        if inst is not None:  # lock-free fast path: called per data event
            return inst
        with cls._ilock:
            if cls._instance is None:
                cls._instance = cls()
                path = os.environ.get("VPROXY_TPU_MIRROR")
                if path:
                    cls._instance.load(path)
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._ilock:
            inst, cls._instance = cls._instance, None
        if inst is not None:
            inst.disable()

    def __init__(self):
        self.active = False
        self.hot = False  # active OR a config file is armed for reload
        self.path: Optional[str] = None
        self._mtime = 0.0
        self._next_check = 0.0
        self._origins: dict = {}
        self._writer: Optional[PcapWriter] = None
        self._lock = threading.Lock()

    # ----------------------------------------------------- configuration

    def load(self, path: str) -> None:
        """Load (or arm for hot-reload) a JSON config file. Once armed,
        `hot` stays True even while disabled so the taps keep probing
        wants() and a config edit can re-enable capture."""
        self.path = path
        try:
            self._mtime = os.stat(path).st_mtime
            with open(path) as f:
                cfg = json.load(f)
        except (OSError, ValueError) as e:
            _log.alert(f"mirror config {path}: {e!r}; disabled")
            self.set_config(None)
            return
        self.set_config(cfg)

    def set_config(self, cfg: Optional[dict]) -> None:
        with self._lock:
            if self._writer is not None:
                self._writer.close()
                self._writer = None
            self._origins = {}
            self.active = False
            try:
                if cfg and cfg.get("enabled", True):
                    origins = {}
                    for ent in cfg.get("origins", []):
                        origins[ent["origin"]] = [
                            _Filter(f) for f in ent.get("filters", [])]
                    out = cfg.get("output")
                    if out:
                        self._writer = PcapWriter(out)
                        self._origins = origins
                    self.active = bool(self._origins) \
                        and self._writer is not None
            except (OSError, ValueError, KeyError, TypeError) as e:
                # a malformed hot-reloaded config must never raise out
                # of the packet data path — disable and report instead
                _log.alert(f"mirror config invalid ({e!r}); disabled")
                self._origins = {}
                self.active = False
            self.hot = self.active or self.path is not None

    def disable(self) -> None:
        self.path = None
        self.set_config(None)

    def maybe_reload(self) -> None:
        """mtime-based hot reload, throttled to one stat() per second.
        Called from the data path only while a config file is armed."""
        if self.path is None:
            return
        now = time.monotonic()
        if now < self._next_check:
            return
        self._next_check = now + 1.0
        try:
            m = os.stat(self.path).st_mtime
        except OSError:
            return
        if m != self._mtime:
            self._mtime = m
            _log.info(f"mirror config changed; reloading {self.path}")
            self.load(self.path)

    # ------------------------------------------------------------- taps

    def wants(self, origin: str) -> bool:
        self.maybe_reload()
        return self.active and origin in self._origins

    def mirror(self, origin: str, payload: bytes,
               src_ip: Optional[bytes] = None, dst_ip: Optional[bytes] = None,
               src_port: int = 0, dst_port: int = 0,
               raw_ether: bool = False) -> None:
        """Capture one payload. raw_ether=True writes payload verbatim
        (already an ethernet frame — the switch origin)."""
        if not self.wants(origin):
            return
        flts = self._origins.get(origin, [])
        if flts and not any(f.match(src_ip, dst_ip, src_port, dst_port)
                            for f in flts):
            return
        if raw_ether:
            frame = payload
        else:
            frame = _synth_tcp_frame(src_ip or b"\x00" * 4,
                                     dst_ip or b"\x00" * 4,
                                     src_port, dst_port, payload)
        with self._lock:
            if self._writer is not None:
                try:
                    self._writer.write(frame)
                except OSError as e:
                    _log.alert(f"mirror write failed: {e!r}; disabled")
                    self.active = False
