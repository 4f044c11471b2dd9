"""AgentDNSServer — the agent's caching DNS front with fake-IP answers.

Parity: vproxyx/websocks/AgentDNSServer.java:396. The agent runs a
small UDP DNS server the host OS points at. For an A query whose domain
the proxy rules claim (DomainChecker.needs_proxy), it leases a fake IP
from the DomainBinder and answers with it — the OS then connects to the
fake IP, landing on the DirectRelayServer, which recovers the domain
and tunnels through the websocks server. Everything else resolves
upstream (system resolver in a worker thread, like the agent's direct
path) and is cached with a TTL.

AAAA queries for proxied domains answer empty-NOERROR so dual-stack
clients fall back to the fake v4 address.

The port's copy of vproxy_tpu/websocks/agentdns.py, same names and behaviour.
"""
from __future__ import annotations

import socket
import threading
import time
from typing import Optional

from ..dns import packet as P
from ..net.eventloop import SelectorEventLoop
from ..net.udp import UdpSock
from ..utils.log import Logger

_log = Logger("agent-dns")

CACHE_TTL = 60.0
FAKE_TTL = 10  # answer TTL for fake-IP leases (seconds, kept short)


class AgentDNSServer:
    def __init__(self, alias: str, loop: SelectorEventLoop, bind_ip: str,
                 bind_port: int, checker, binder, resolve=None):
        """checker: DomainChecker (agent.checker); binder: DomainBinder
        shared with the DirectRelayServer; resolve(name) -> list[str]
        override for tests (runs on a worker thread)."""
        self.alias = alias
        self.loop = loop
        self.checker = checker
        self.binder = binder
        self.bind_ip = bind_ip
        self.bind_port = bind_port
        self._resolve = resolve or self._system_resolve
        self.sock: Optional[UdpSock] = None
        self.queries = 0
        self.fake_answers = 0
        self.upstream_answers = 0
        self._cache: dict = {}  # (name, qtype) -> (ips, expiry)
        # in-flight dedup: one resolver thread per name; concurrent
        # queries (OS resolvers retry aggressively) join the waiters
        self._inflight: dict = {}  # (name, qtype) -> [(req, ip, port)]

    # ---------------------------------------------------------- lifecycle

    def start(self) -> None:
        self.sock = UdpSock(self.loop, self.bind_ip, self.bind_port,
                            self._on_packet)
        if self.bind_port == 0:
            self.bind_port = self.sock.local[1]

    def stop(self) -> None:
        if self.sock is not None:
            self.sock.close()
            self.sock = None

    # ------------------------------------------------------------ serving

    def _on_packet(self, data: bytes, ip: str, port: int) -> None:
        try:
            req = P.parse(data)
        except P.DNSFormatError:
            return
        if req.is_resp or not req.questions:
            return
        self.queries += 1
        q = req.questions[0]
        domain = q.qname.rstrip(".")
        if q.qtype not in (P.A, P.AAAA):
            self._respond(req, ip, port, [], rcode=4)  # NOTIMP
            return
        if self.checker.needs_proxy(domain, 0):
            self.fake_answers += 1
            answers = []
            if q.qtype == P.A:
                fake = self.binder.bind(domain)
                answers.append(P.Record(
                    name=q.qname, rtype=P.A, ttl=FAKE_TTL,
                    rdata=socket.inet_aton(fake)))
            # AAAA for a proxied domain: empty NOERROR -> v4 fallback
            self._respond(req, ip, port, answers)
            return
        key = (domain, q.qtype)
        ent = self._cache.get(key)
        if ent is not None and ent[1] > time.monotonic():
            self._answer_ips(req, ip, port, q, ent[0])
            return
        waiters = self._inflight.get(key)  # loop-confined state
        if waiters is not None:
            waiters.append((req, ip, port))
            return
        self._inflight[key] = [(req, ip, port)]

        def work() -> None:
            try:
                ips = self._resolve(domain, q.qtype)
            except OSError:
                ips = []

            def deliver() -> None:
                if ips:
                    if len(self._cache) > 4096:  # hard bound
                        now = time.monotonic()
                        for k in [k for k, v in self._cache.items()
                                  if v[1] < now]:
                            del self._cache[k]
                        # lookup storm of fresh entries: evict oldest
                        overflow = len(self._cache) - 4096
                        if overflow > 0:
                            for k in sorted(self._cache,
                                            key=lambda k: self._cache[k][1]
                                            )[:overflow]:
                                del self._cache[k]
                    self._cache[key] = (ips, time.monotonic() + CACHE_TTL)
                for w_req, w_ip, w_port in self._inflight.pop(key, []):
                    self._answer_ips(w_req, w_ip, w_port,
                                     w_req.questions[0], ips)

            if not self.loop.run_on_loop(deliver):
                pass  # loop gone: drop

        threading.Thread(target=work, daemon=True,
                         name="agent-dns-resolve").start()

    @staticmethod
    def _system_resolve(domain: str, qtype: int) -> list:
        fam = socket.AF_INET if qtype == P.A else socket.AF_INET6
        infos = socket.getaddrinfo(domain, None, fam,
                                   socket.SOCK_STREAM)
        return sorted({i[4][0] for i in infos})

    def _answer_ips(self, req, ip: str, port: int, q, ips: list) -> None:
        answers = []
        for a in ips:
            try:
                raw = socket.inet_pton(
                    socket.AF_INET if q.qtype == P.A else socket.AF_INET6, a)
            except OSError:
                continue
            answers.append(P.Record(name=q.qname, rtype=q.qtype,
                                    ttl=int(CACHE_TTL), rdata=raw))
        if answers:
            self.upstream_answers += 1
        # empty -> NOERROR/no-data, never NXDOMAIN: getaddrinfo cannot
        # distinguish them, and a spurious NXDOMAIN on (say) AAAA would
        # negative-cache the NAME and kill the sibling A lookup (RFC 2308)
        self._respond(req, ip, port, answers)

    def _respond(self, req, ip: str, port: int, answers: list,
                 rcode: int = 0) -> None:
        resp = P.Packet(id=req.id, is_resp=True, aa=False, rd=req.rd,
                        ra=True, rcode=rcode,
                        questions=list(req.questions), answers=answers)
        if self.sock is not None:
            self.sock.send(resp.encode(), ip, port)
