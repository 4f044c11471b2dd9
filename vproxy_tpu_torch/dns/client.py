"""DNSClient + caching resolver.

Parity: base dns/DNSClient.java (UDP-only queries, timeout + maxRetry
rotation across nameservers, :34-52,156-181) and AbstractResolver.java
(async TTL cache). Runs on a SelectorEventLoop; callbacks fire on the
loop thread.

The port's copy of vproxy_tpu/dns/client.py, same names and behaviour.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Optional

from ..net import vtl
from ..net.eventloop import SelectorEventLoop
from . import packet as P


class DNSClient:
    def __init__(self, loop: SelectorEventLoop, nameservers: list[tuple[str, int]],
                 timeout_ms: int = 1500, max_retry: int = 2):
        self.loop = loop
        self.nameservers = list(nameservers)
        self.timeout_ms = timeout_ms
        self.max_retry = max_retry
        self._idgen = itertools.count(1)
        self._inflight: dict[int, dict] = {}
        self._fd: Optional[int] = None

    def _ensure_sock(self) -> int:
        if self._fd is None:
            self._fd = vtl.udp_bind("0.0.0.0", 0)
            self.loop.add(self._fd, vtl.EV_READ, self._on_readable)
        return self._fd

    def _on_readable(self, fd: int, ev: int) -> None:
        while True:
            r = vtl.recvfrom(fd)
            if r is None:
                return
            data, ip, port = r
            try:
                resp = P.parse(data)
            except P.DNSFormatError:
                continue
            st = self._inflight.pop(resp.id & 0xFFFF, None)
            if st is None:
                continue
            st["timer"].cancel()
            st["cb"](resp, None)

    def query(self, qname: str, qtype: int,
              cb: Callable[[Optional[P.Packet], Optional[Exception]], None]) -> None:
        """Send a query; cb(resp, err) on the loop thread."""
        qid = next(self._idgen) & 0xFFFF or 1
        pkt = P.Packet(id=qid, rd=True,
                       questions=[P.Question(qname, qtype)])
        data = pkt.encode()
        st = {"cb": cb, "attempt": 0, "data": data}
        self._inflight[qid] = st

        def send_attempt() -> None:
            ns = self.nameservers[st["attempt"] % len(self.nameservers)]
            try:
                vtl.sendto(self._ensure_sock(), data, ns[0], ns[1])
            except OSError:
                pass
            st["timer"] = self.loop.delay(self.timeout_ms, on_timeout)

        def on_timeout() -> None:
            st["attempt"] += 1
            if st["attempt"] >= self.max_retry * len(self.nameservers):
                self._inflight.pop(qid, None)
                cb(None, TimeoutError(f"dns query {qname} timed out"))
                return
            send_attempt()

        send_attempt()

    def close(self) -> None:
        if self._fd is not None:
            self.loop.remove(self._fd)
            vtl.close(self._fd)
            self._fd = None


class Resolver:
    """TTL-cached async resolver (AbstractResolver/VResolver analog)."""

    def __init__(self, loop: SelectorEventLoop, client: DNSClient,
                 hosts: Optional[dict[str, bytes]] = None):
        self.loop = loop
        self.client = client
        self.hosts = hosts or {}
        self._cache: dict[tuple[str, int], tuple[float, list[bytes]]] = {}

    def resolve(self, name: str, cb: Callable[[Optional[list[bytes]], Optional[Exception]], None],
                qtype: int = P.A) -> None:
        key = name.rstrip(".")
        if key in self.hosts:
            cb([self.hosts[key]], None)
            return
        ent = self._cache.get((key, qtype))
        now = time.monotonic()
        if ent and ent[0] > now:
            cb(list(ent[1]), None)
            return

        def on_resp(resp, err):
            if err is not None or resp is None:
                cb(None, err or OSError("no response"))
                return
            addrs = [r.rdata for r in resp.answers
                     if r.rtype == qtype and isinstance(r.rdata, (bytes, bytearray))]
            ttl = min((r.ttl for r in resp.answers), default=60) or 60
            if addrs:
                self._cache[(key, qtype)] = (now + ttl, addrs)
                cb(addrs, None)
            else:
                cb(None, OSError(f"no {qtype} records for {name}"))

        self.client.query(key + ".", qtype, on_resp)
