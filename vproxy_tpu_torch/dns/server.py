"""DNSServer — authoritative + recursive DNS over UDP, with DNS-as-LB.

Parity: core dns/DNSServer.java. Lookup order per qname
(DNSServer.java:116-195): hosts map -> rrsets (an Upstream searched with
Hint.ofHost(domain) — the classify engine) -> IP-literal echo ->
`*.vproxy.local` introspection (DNSServer.java:150-157 + runInternal
:339-349: who.am.i answers the requester's own address, who.are.you the
server's local address facing them; plus the resource extension below)
-> recursive upstream via DNSClient. A/AAAA answers pick a HEALTHY
backend via the matched group's nextIPv4/nextIPv6 (DNS answers
load-balance); SRV lists all healthy server handles with weights.
Queries are gated by a SecurityGroup (UDP protocol).

Resource introspection extension: `resource_resolver` (installed by the
control plane, control/command.py) maps the sub-domain left of
`.vproxy.local` to a live resource address — e.g. `web.tcp-lb
.vproxy.local` answers tcp-lb `web`'s bind address from the running
Application state.

The port's copy of vproxy_tpu/dns/server.py, same names and behaviour.
The cluster arm of `<name>.vproxy.local` reads the port's cluster
package, whose dns_peer_addrs() is None until the cluster plane is
ported (ROADMAP Queue A item 8): the reference's answer without a node.
"""
from __future__ import annotations

import os
import time
from typing import Optional

from ..components.secgroup import SecurityGroup
from ..components.upstream import Upstream
from ..net import vtl
from ..net.eventloop import SelectorEventLoop
from ..policing import engine as policing
from ..rules.ir import Hint, Proto
from ..utils import sketch, workload
from ..utils.ip import is_ip_literal, parse_ip
from ..utils.log import Logger
from . import packet as P
from .client import DNSClient

_log = Logger("dns-server")


class DNSServer:
    def __init__(self, alias: str, loop: SelectorEventLoop, bind_ip: str,
                 bind_port: int, rrsets: Upstream, ttl: int = 0,
                 security_group: Optional[SecurityGroup] = None,
                 recursive_client: Optional[DNSClient] = None,
                 hosts: Optional[dict[str, bytes]] = None, elg=None,
                 resource_resolver=None):
        self.alias = alias
        self.loop = loop
        self.bind_ip = bind_ip
        self.bind_port = bind_port
        self.rrsets = rrsets
        self.ttl = ttl
        self.security_group = security_group or SecurityGroup.allow_all()
        self.recursive = recursive_client
        self.hosts = hosts or {}
        # optional `(subdomain) -> Optional[bytes addr]` hook answering
        # `<subdomain>.vproxy.local` from live resource state
        self.resource_resolver = resource_resolver
        self._fd: Optional[int] = None
        self.elg = elg  # attach target for loop-death re-homing
        self.started = False
        self.queries = 0
        # hot-path answer cache: packed response bytes per (qname,
        # qtype, rd) for single-question group-backed queries — without
        # it every repeat query re-walks the group and re-packs records.
        # Entries pin the tokens they were built under (the rrsets
        # matcher snapshot = rule generation, the group + its
        # health_version = backend health edges) and die the instant
        # either moves; a short TTL bounds how long the DNS-as-LB
        # rotation is frozen on one backend. VPROXY_TPU_DNS_CACHE_MS=0
        # disables.
        self._cache_ms = int(os.environ.get("VPROXY_TPU_DNS_CACHE_MS",
                                            "1000"))
        self._ans_cache: dict = {}  # key -> (expires, token, resp bytes)
        self.cache_hits = 0
        self.drops = 0  # responses the kernel refused (EAGAIN) — counted
        # qname quarantine (vproxy_tpu/policing): a quarantined qname
        # answers REFUSED from this packed-response cache — the flood
        # never re-walks the group or re-packs records
        self._ref_cache: dict = {}  # key -> (expires, packed REFUSED)
        self.quarantines = 0

    def _send(self, data: bytes, ip: str, port: int) -> None:
        """One response datagram; an EAGAIN under storm load is a DROP
        and must be counted (vproxy_udp_drop_total), never silent —
        the client's retry is the recovery, the counter is the evidence.
        A raised OSError is a real send failure (EBADF, ENETUNREACH…),
        not backpressure: logged, never reclassified as a storm drop —
        an outage must not read as benign overload on /metrics."""
        if self._fd is None:
            return
        try:
            r = vtl.sendto(self._fd, data, ip, port)
        except OSError:
            _log.error(f"dns response sendto {ip}:{port} failed",
                       exc=True)
            return
        if r == vtl.AGAIN:
            self.drops += 1
            from ..utils.metrics import udp_drop_incr
            udp_drop_incr()

    # ------------------------------------------------------------ control

    def start(self) -> None:
        if self.started:
            return
        self._bind(self.loop)
        if self.elg is not None:
            self.elg.attach(self)
        self.started = True

    def _bind(self, loop) -> None:
        def mk() -> None:
            self._fd = vtl.udp_bind(self.bind_ip, self.bind_port)
            if self.bind_port == 0:
                _, self.bind_port = vtl.sock_name(self._fd)
            loop.add(self._fd, vtl.EV_READ, self._on_readable)
        try:
            loop.call_sync(mk)
        except OSError as e:
            raise OSError(f"dns-server {self.alias}: bind failed: {e}") from e

    def on_loop_death(self, group, lp) -> None:
        """DNSServer.java:89-106: when the hosting loop dies, re-home
        the UDP bind onto a surviving loop of the attached group (death
        callbacks fire after the dead loop released our fd)."""
        if lp is not self.loop or not self.started:
            return
        self._fd = None
        if not group.loops:
            self.started = False
            group.detach(self)
            return
        self.loop = group.next()
        try:
            self._bind(self.loop)
        except OSError as e:
            _log.alert(f"dns-server {self.alias}: re-home bind failed: "
                       f"{e!r}; server is down")
            self.started = False
            group.detach(self)
            return
        if not self.started:  # raced a concurrent stop(): undo the bind
            fd, self._fd = self._fd, None
            lp2 = self.loop

            def rm() -> None:
                if fd is not None:
                    lp2.remove(fd)
                    vtl.close(fd)
            lp2.run_on_loop(rm)

    def stop(self) -> None:
        if not self.started:
            return
        self.started = False
        if self.elg is not None:
            self.elg.detach(self)
        fd = self._fd
        self._fd = None

        def rm() -> None:
            if fd is not None:
                self.loop.remove(fd)
                vtl.close(fd)
        self.loop.run_on_loop(rm)

    # --------------------------------------------------------- data plane

    def _on_readable(self, fd: int, ev: int) -> None:
        # drain the socket; every datagram's ACL gate is submitted to the
        # ClassifyService immediately, so a burst of queries coalesces
        # into one device batch (the DNS arm of the north-star queue)
        while self._fd is not None:
            r = vtl.recvfrom(fd)
            if r is None:
                return
            data, ip, port = r
            self.queries += 1

            def gated(ok: bool, data=data, ip=ip, port=port) -> None:
                if not ok or self._fd is None:
                    return
                try:
                    req = P.parse(data)
                except P.DNSFormatError:
                    return
                self._handle(req, ip, port)

            self.security_group.allow_async(Proto.UDP, parse_ip(ip),
                                            self.bind_port, gated, self.loop)

    def _respond(self, req: P.Packet, ip: str, port: int,
                 answers: list, rcode: int = 0) -> None:
        resp = P.Packet(id=req.id, is_resp=True, aa=rcode == 0, rd=req.rd,
                        ra=self.recursive is not None, rcode=rcode,
                        questions=list(req.questions), answers=answers)
        data = resp.encode()
        ck = getattr(req, "_cache_key", None)
        if ck is not None and rcode == 0:
            if len(self._ans_cache) > 4096:
                self._ans_cache.clear()
            self._ans_cache[ck] = (
                time.monotonic() + self._cache_ms / 1000.0,
                req._cache_token, data)
        self._send(data, ip, port)

    def _cache_lookup(self, req: P.Packet, q) -> Optional[bytes]:
        """-> a fresh cached response (id already patched) or None."""
        key = (q.qname, q.qtype, req.rd)
        ent = self._ans_cache.get(key)
        if ent is None:
            return None
        expires, (gh, hv, snap), data = ent
        if (time.monotonic() >= expires
                or gh.group.health_version != hv
                or self.rrsets._matcher.snapshot() is not snap):
            del self._ans_cache[key]
            return None
        out = bytearray(data)
        out[0:2] = req.id.to_bytes(2, "big")
        return bytes(out)

    def _handle(self, req: P.Packet, ip: str, port: int) -> None:
        if not req.questions:
            self._respond(req, ip, port, [], rcode=1)
            return
        qs = list(req.questions)
        # workload capture: the dns-plane arrival process (one query =
        # one arrival, cache hits included — the offered load is what
        # the capacity model wants, not the miss rate)
        workload.note_arrival("dns")
        # analytics: which qnames are hot (covers cache hits too — the
        # whole point is seeing the crowd, cached or not)
        if sketch.ON:
            for q in qs:
                sketch.update("qnames", q.qname, plane="dns")
        # qname-flood quarantine: the policing verdict comes BEFORE the
        # answer cache (a quarantined name must not serve stale answers
        # from a pre-quarantine fill) and the REFUSED bytes come from
        # their own packed cache. One branch when the knob is off.
        if policing.ON:
            policing.maybe_tick()
            if self._quarantine_refuse(req, ip, port, qs):
                return
        if len(qs) == 1 and self._cache_ms > 0:
            hit = self._cache_lookup(req, qs[0])
            if hit is not None:
                self.cache_hits += 1
                self._send(hit, ip, port)
                return
        # continuation pipeline over the questions: each rrsets lookup
        # rides the ClassifyService queue (DNSServer.java:136's scan),
        # coalescing with other in-flight queries across datagrams
        self._handle_q(req, ip, port, qs, 0, [])

    def _quarantine_refuse(self, req: P.Packet, ip: str, port: int,
                           qs: Optional[list] = None) -> bool:
        """True = a quarantined qname answered REFUSED (rcode 5) from
        the packed cache (id patched per query) — the group walk, the
        record packing and the classify submit never run."""
        if qs is None:
            qs = list(req.questions)
        hit = None
        for q in qs:
            if policing.quarantined(q.qname, lb=self.alias):
                hit = q
                break
        if hit is None:
            return False
        self.quarantines += 1
        key = (hit.qname, hit.qtype, req.rd)
        now = time.monotonic()
        ent = self._ref_cache.get(key)
        if ent is not None and now < ent[0]:
            out = bytearray(ent[1])
            out[0:2] = req.id.to_bytes(2, "big")
            self._send(bytes(out), ip, port)
            return True
        resp = P.Packet(id=req.id, is_resp=True, aa=False, rd=req.rd,
                        ra=self.recursive is not None, rcode=5,
                        questions=list(req.questions), answers=[])
        data = resp.encode()
        if len(self._ref_cache) > 1024:
            self._ref_cache.clear()
        # the verdict is re-checked per query (quarantine lifting takes
        # effect immediately); the cache only skips the re-pack
        self._ref_cache[key] = (now + 1.0, data)
        self._send(data, ip, port)
        return True

    def _handle_q(self, req: P.Packet, ip: str, port: int, qs: list,
                  i: int, answers: list) -> None:
        while i < len(qs):
            q = qs[i]
            if q.qtype not in (P.A, P.AAAA, P.SRV, P.ANY):
                self._run_recursive(req, ip, port)
                return
            domain = q.qname.rstrip(".")
            host_hit = self.hosts.get(domain)
            if host_hit is not None:
                answers.append(self._addr_record(q.qname, host_hit))
                i += 1
                continue

            def found(gh, q=q, i=i, domain=domain) -> None:
                if gh is None:
                    if is_ip_literal(domain):
                        addr = parse_ip(domain)
                        if ((q.qtype == P.A and len(addr) == 4)
                                or (q.qtype == P.AAAA and len(addr) == 16)
                                or q.qtype == P.SRV):
                            answers.append(self._addr_record(q.qname, addr))
                        self._handle_q(req, ip, port, qs, i + 1, answers)
                        return
                    if domain.endswith(".vproxy.local"):
                        # DNSServer.java:150-157: answered from internal
                        # state, never recursed out; family gated by the
                        # question type like the IP-literal arm above
                        for a in self._run_internal(
                                domain[: -len(".vproxy.local")], ip):
                            if ((q.qtype == P.A and len(a) == 4)
                                    or (q.qtype == P.AAAA and len(a) == 16)
                                    or q.qtype in (P.SRV, P.ANY)):
                                answers.append(
                                    self._addr_record(q.qname, a))
                        self._handle_q(req, ip, port, qs, i + 1, answers)
                        return
                    self._run_recursive(req, ip, port)
                    return
                # single-question group answer: cacheable — pin the
                # tokens whose movement must invalidate it. Per-client
                # picks (source hash, live-connection wlc) must NOT be
                # cached: one client's backend would serve everyone.
                # SRV lists all healthy servers, so it is always safe.
                if len(qs) == 1 and self._cache_ms > 0 and (
                        q.qtype == P.SRV or gh.group.method == "wrr"):
                    req._cache_key = (q.qname, q.qtype, req.rd)
                    req._cache_token = (gh, gh.group.health_version,
                                        self.rrsets._matcher.snapshot())
                self._answer_group(q, gh, ip, answers)
                self._handle_q(req, ip, port, qs, i + 1, answers)

            self.rrsets.search_for_group_async(Hint.of_host(domain), found,
                                               self.loop)
            return
        self._respond(req, ip, port, answers)

    def _answer_group(self, q, gh, ip: str, answers: list) -> None:
        if q.qtype == P.SRV:
            for svr in gh.group.servers:
                if not svr.healthy:
                    continue
                answers.append(P.Record(
                    name=q.qname, rtype=P.SRV, ttl=self.ttl,
                    rdata=(0, svr.weight, svr.port,
                           (svr.host_name or svr.ip) + ".")))
        else:
            fam = "v4" if q.qtype == P.A else ("v6" if q.qtype == P.AAAA else None)
            conn = gh.group.next(parse_ip(ip), fam)
            if conn is not None:  # no healthy server: empty answer section
                answers.append(self._addr_record(q.qname, parse_ip(conn.ip)))

    def _run_internal(self, sub: str, ip: str) -> list[bytes]:
        """`<sub>.vproxy.local` answers (DNSServer.runInternal
        :339-349): who.am.i = the requester's address; who.are.you =
        this server's local address facing them; the cluster service
        name = the UP cluster peers (DNS-as-LB across the fleet,
        cluster/membership.py — healthy-only, but never an empty set:
        this node itself is the floor); anything else consults the
        control plane's resource resolver."""
        if sub == "who.am.i":
            return [parse_ip(ip)]
        from ..cluster import cluster_service_name, dns_peer_addrs
        if sub == cluster_service_name():
            # maglev-steered by the requester's address: the picked
            # peer answers FIRST, so one client keeps one peer across
            # repeat queries and a fleet resize moves only ~1/N of
            # client affinities (cluster/membership.steer_addrs)
            try:
                client = parse_ip(ip)
            except (OSError, ValueError):
                client = None
            addrs = dns_peer_addrs(client)
            if addrs is not None:
                return addrs
        if sub == "who.are.you":
            local = self.bind_ip
            if local in ("0.0.0.0", "::"):
                import socket
                try:  # routed local address toward the requester
                    s = socket.socket(socket.AF_INET6 if ":" in ip
                                      else socket.AF_INET,
                                      socket.SOCK_DGRAM)
                    s.connect((ip, 53))
                    local = s.getsockname()[0]
                    s.close()
                except OSError:
                    return []
            return [parse_ip(local)]
        if self.resource_resolver is not None:
            a = self.resource_resolver(sub)
            if a is not None:
                return [a]
        return []

    def _addr_record(self, qname: str, addr: bytes) -> P.Record:
        return P.Record(name=qname, rtype=P.A if len(addr) == 4 else P.AAAA,
                        ttl=self.ttl, rdata=addr)

    def _run_recursive(self, req: P.Packet, ip: str, port: int) -> None:
        if self.recursive is None or not req.questions:
            self._respond(req, ip, port, [], rcode=3)  # NXDOMAIN
            return
        q = req.questions[0]

        def on_resp(resp: Optional[P.Packet], err) -> None:
            if resp is None:
                self._respond(req, ip, port, [], rcode=2)  # SERVFAIL
                return
            resp.id = req.id
            resp.is_resp = True
            resp.ra = True
            self._send(resp.encode(), ip, port)

        self.recursive.query(q.qname, q.qtype, on_resp)
