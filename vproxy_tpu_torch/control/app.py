"""Application — the singleton resource-holder registry.

Analog of app/Application.java:16-115: one holder per resource kind plus
the default event-loop topology (a control loop, N worker loops, the
acceptor group aliased to the worker group — REUSEPORT always available
on the Linux hosts we target).

The port's copy of vproxy_tpu/control/app.py, same names and behaviour.
"""
from __future__ import annotations

import os
from typing import Optional

from ..components.elgroup import EventLoopGroup
from ..components.secgroup import SecurityGroup
from ..components.servergroup import ServerGroup
from ..components.socks5 import Socks5Server
from ..components.tcplb import TcpLB
from ..components.upstream import Upstream
from ..dns.server import DNSServer

DEFAULT_ACCEPTOR_ELG = "(acceptor-elg)"
DEFAULT_WORKER_ELG = "(worker-elg)"
DEFAULT_CONTROL_ELG = "(control-elg)"


class Application:
    _instance: Optional["Application"] = None

    def __init__(self, workers: Optional[int] = None):
        if workers is None:
            workers = int(os.environ.get("VPROXY_TPU_WORKERS", "0")) or (
                os.cpu_count() or 1)
        self.elgs: dict[str, EventLoopGroup] = {}
        self.upstreams: dict[str, Upstream] = {}
        self.server_groups: dict[str, ServerGroup] = {}
        self.security_groups: dict[str, SecurityGroup] = {}
        self.tcp_lbs: dict[str, TcpLB] = {}
        self.socks5_servers: dict[str, Socks5Server] = {}
        self.dns_servers: dict[str, DNSServer] = {}
        self.cert_keys: dict[str, object] = {}
        self.switches: dict[str, object] = {}
        self.resp_controllers: dict[str, object] = {}
        self.http_controllers: dict[str, object] = {}
        self.docker_controllers: dict[str, object] = {}
        # (switch alias, vni) -> {"ip:port": VpcProxy}
        self.vpc_proxies: dict[tuple, dict] = {}
        # cluster plane (the reference's ClusterNode): None until the
        # port has one (ROADMAP Queue A item 8; main.py refuses
        # VPROXY_TPU_CLUSTER_PEERS)
        self.cluster = None
        self._resolver = None  # lazy "(default)" resolver
        # fired by request_drain (the `drain` command / SIGTERM path);
        # main.py registers its stop event here
        self.on_drain_request: list = []

        self.elgs[DEFAULT_CONTROL_ELG] = EventLoopGroup(DEFAULT_CONTROL_ELG, 1)
        worker = EventLoopGroup(DEFAULT_WORKER_ELG, workers)
        self.elgs[DEFAULT_WORKER_ELG] = worker
        # acceptor aliased to worker (Application.java:103-105, REUSEPORT)
        self.elgs[DEFAULT_ACCEPTOR_ELG] = worker

    @property
    def control_loop(self):
        return self.elgs[DEFAULT_CONTROL_ELG].loops[0]

    def get_resolver(self):
        """The "(default)" resolver singleton (AbstractResolver analog):
        TTL-cached, nameservers from /etc/resolv.conf."""
        if self._resolver is None:
            from ..dns.client import DNSClient, Resolver
            ns = []
            try:
                with open("/etc/resolv.conf") as f:
                    for line in f:
                        parts = line.split()
                        if len(parts) >= 2 and parts[0] == "nameserver":
                            ns.append((parts[1], 53))
            except OSError:
                pass
            if not ns:
                ns = [("127.0.0.53", 53), ("8.8.8.8", 53)]
            self._resolver = Resolver(
                self.control_loop, DNSClient(self.control_loop, ns))
        return self._resolver

    @property
    def worker_elg(self) -> EventLoopGroup:
        return self.elgs[DEFAULT_WORKER_ELG]

    @property
    def acceptor_elg(self) -> EventLoopGroup:
        return self.elgs[DEFAULT_ACCEPTOR_ELG]

    # ------------------------------------------------------ graceful drain

    def sessions_in_flight(self) -> int:
        """Live client sessions across every LB surface: python-side
        active_sessions plus sessions owned by C accept lanes (real
        in-flight work the drain contract protects, invisible to the
        python counter)."""
        return sum(lb.active_sessions
                   + getattr(lb, "lane_active", lambda: 0)()
                   for lb in list(self.tcp_lbs.values())
                   + list(self.socks5_servers.values()))

    def request_drain(self) -> str:
        """Begin graceful drain (SIGTERM and the `drain` command funnel
        here): flip /healthz to draining so upstream LBs steer away,
        close every frontend listener (in-flight pumps keep running),
        and fire the drain-request callbacks (main.py registers its
        stop event there so the process exits after the drain window)."""
        from ..utils import events, lifecycle
        if not lifecycle.set_draining():
            return "already draining"
        total = self.sessions_in_flight()
        events.record("drain", f"drain requested: {total} sessions in "
                      "flight, healthz now draining", sessions=total)
        for lb in list(self.tcp_lbs.values()) \
                + list(self.socks5_servers.values()):
            lb.begin_drain()
        for cb in list(self.on_drain_request):
            cb()
        return "OK"

    def drain_wait(self, timeout_s: float, poll_s: float = 0.05,
                   settle_s: float = 0.2) -> bool:
        """Block (main thread only) until every LB session finishes or
        the drain window closes; True when fully drained. Completion
        requires the count to stay zero across a settle window:
        active_sessions counts from backend-pick onward, so connections
        still in their handshake/classify phase (socks5 greeting, TLS
        peek, http head-parse) surface a moment later — an instant zero
        must not be read as 'drained'."""
        import time as _time
        from ..utils import events
        deadline = _time.monotonic() + timeout_s
        zero_since = None
        while True:
            left = self.sessions_in_flight()
            now = _time.monotonic()
            if left <= 0:
                if zero_since is None:
                    zero_since = now
                elif now - zero_since >= settle_s:
                    events.record("drain", "drain complete: all sessions "
                                  "finished")
                    return True
            else:
                zero_since = None
            if now >= deadline:
                events.record("drain", f"drain window closed with {left} "
                              "sessions still in flight", sessions=left)
                return left <= 0
            _time.sleep(poll_s)

    @classmethod
    def create(cls, workers: Optional[int] = None) -> "Application":
        cls._instance = cls(workers)
        return cls._instance

    @classmethod
    def get(cls) -> "Application":
        if cls._instance is None:
            raise RuntimeError("Application not created")
        return cls._instance

    def close(self) -> None:
        if self.cluster is not None:
            self.cluster.close()
            self.cluster = None
        for ctl in self.docker_controllers.values():
            ctl.stop()  # unlinks the uds socket file
        for lb in list(self.tcp_lbs.values()) + list(self.socks5_servers.values()):
            lb.stop()
        for d in self.dns_servers.values():
            d.stop()
        for g in self.server_groups.values():
            g.close()
        seen = set()
        for elg in self.elgs.values():
            if id(elg) not in seen:
                seen.add(id(elg))
                elg.close()
        if Application._instance is self:
            Application._instance = None
