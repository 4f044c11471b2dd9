"""Storm suite — fleet-scale adversarial scenarios with SLO gates.

The port's copy of tools/storm.py: the same seven scenarios, gates,
report keys and CLI, on vproxy_tpu_torch. Chaos (tools/chaos.py)
proves the fleet survives component DEATH; production traffic fails
uglier. This harness drives seven adversarial workloads against live
components, each scored by explicit pass/fail SLO gates:

  flash_crowd      a 10x client-concurrency step against a TcpLB on a
                   single worker loop. Runs TWICE at identical load —
                   overload guard static, then adaptive
                   (docs/robustness.md): the differential gate shows
                   the adaptive controller passing the p99 SLO that the
                   static guard fails (degrade-rather-than-fail: shed
                   some with RST, serve the rest fast); on hardware
                   with headroom for both, there is nothing to
                   demonstrate and the gate passes as not-demonstrable.
  adversarial_crowd a replayed legit client mix (docs/replay.md) plus
                   an attacking herd from one address, policing ON vs
                   OFF at identical load: the legit SLO must hold and
                   the herd shed >=90% by ATTRIBUTED policing actions
                   with policing on, the differential demonstrated (or
                   honestly not-demonstrable) with it off
                   (docs/robustness.md "admission policing").
  slowloris        a half-open flood (incomplete HTTP heads) against an
                   http-splice LB pins fds/parser state; the
                   pre-handover handshake deadline must release every
                   half-open session (counted
                   vproxy_lb_shed_total{reason=halfopen}) while legit
                   traffic keeps >= 99% success.
  dns_storm        a query storm against the DNS server's packed-answer
                   cache, repeat names + NXDOMAIN misses, with a
                   mid-storm group mutation; zero failed queries.
  elephant_mice    an elephant flow (one hot 5-tuple) vs hundreds of
                   one-packet mice through the native switch flow
                   cache; the elephant must not starve the mice and
                   nothing may drop or stale-forward.
  rolling_upgrade  a 3-node cluster fleet under step-synchronized
                   classify load, every peer drained/restarted one at a
                   time; a mid-roll torn replication frame must be
                   REJECTED at the framing layer leaving last-known-good
                   serving (generation_reject observed, zero failed
                   queries), and the fleet must converge after.

`--seed` pins every probability failpoint arm
(VPROXY_TPU_FAILPOINT_SEED) plus harness payloads, and is echoed into
the report so a failed gate replays exactly. `--scale` shrinks the
load shape (the tier-1 smoke runs at a fraction; full scenarios are
`slow`-marked). `--only <name>` runs one scenario. `--out FILE` writes
the report there as well; without it nothing is written.

Where the port differs from the reference:

* the device: every matcher a scenario builds serves on
  utils/torchenv.default_device (the card), and without a GPU
  `run_all` and the CLI raise unless the CPU is asked for (`--device
  cpu` or VPROXY_TPU_TORCH_DEVICE=cpu);
* rolling_upgrade's step loops carry a Maglev plane
  (_fleetlib.attach_pick_loop):
  each step is the FusedPair's one launch (B1 on the card), every
  query a `submit_pick`, held to the oracle's verdict and to the host
  Maglev pick; the reference's steps are hint-only;
* each scenario's report carries `device`: the engine's dispatches by
  kind (rules/engine.dispatches_by_kind) and the launches of the CUDA
  kernels that serve them on "torch" (B1, B3, B4) while it ran;
* dns_storm and rolling_upgrade seed their per-thread generators with
  strings (f"{seed}:{wid}", f"{seed}:roll:{i}"): the reference's tuple
  seeds raise TypeError on Python 3.11 and later;
* `metrics` is read from the port's registry (the port has no
  `bench_snapshot`): counters and gauges of the same families.

Run: python -m vproxy_tpu_torch.tools.storm [--seed N] [--scale X]
     [--only name] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import socket
import sys
import threading
import time

from . import _fleetlib


ROUND = "r10"


# ------------------------------------------------------------- SLO gates

def _gate(value, limit, op: str = "<=") -> dict:
    ok = {"<=": value <= limit, ">=": value >= limit,
          "==": value == limit}[op]
    return {"value": round(value, 4) if isinstance(value, float) else value,
            "op": op, "limit": limit, "pass": bool(ok)}


def _passed(slo: dict) -> bool:
    return all(g["pass"] for g in slo.values())


def _ctr(name: str, **labels):
    from ..utils.metrics import GlobalInspection
    return GlobalInspection.get().get_counter(name, **labels)


# --------------------------------------------------------- LB scaffolding

class _LBWorld:
    """Backends + group + upstream + one TcpLB, torn down in close()."""

    def __init__(self, alias: str, n_backends: int = 2, workers: int = 1,
                 protocol: str = "tcp", overload: str = "static",
                 max_sessions: int = 0, host_hint: str = None,
                 lanes: int = -1):
        from ..components.elgroup import EventLoopGroup
        from ..components.servergroup import (HealthCheckConfig,
                                                       ServerGroup)
        from ..components.tcplb import TcpLB
        from ..components.upstream import Upstream
        from ..rules.ir import HintRule
        self.backends = [_fleetlib.EchoBackend(b"%d" % i)
                         for i in range(n_backends)]
        self.elg = EventLoopGroup(f"{alias}-elg", workers)
        # hc period long: health edges play no part in these scenarios
        self.group = ServerGroup(
            f"{alias}-g", self.elg,
            HealthCheckConfig(timeout_ms=500, period_ms=200, up=1,
                              down=100), "wrr")
        for i, b in enumerate(self.backends):
            self.group.add(f"b{i}", "127.0.0.1", b.port)
        if not _fleetlib.wait_for(
                lambda: sum(1 for s in self.group.servers if s.healthy)
                == n_backends, 10):
            raise TimeoutError("storm backends never came healthy")
        self.ups = Upstream(f"{alias}-u")
        if host_hint:
            self.ups.add(self.group, annotations=HintRule(host=host_hint))
        else:
            self.ups.add(self.group)
        self.lb = TcpLB(alias, self.elg, self.elg, "127.0.0.1", 0,
                        self.ups, protocol=protocol, overload=overload,
                        max_sessions=max_sessions, lanes=lanes)
        self.lb.start()

    def close(self) -> None:
        self.lb.stop()
        self.group.close()
        for b in self.backends:
            b.close()
        self.elg.close()


# ------------------------------------------------------------ scenario 1

def scenario_flash_crowd(scale: float = 1.0, seed: int = 0,
                         log=lambda *_: None) -> dict:
    """10x client-concurrency step (8 -> 80 closed-loop clients on a
    single worker loop), static vs adaptive at IDENTICAL load. The
    differential gate is the tentpole proof: adaptive passes the p99
    SLO static fails — the AIMD ceiling holds admitted concurrency near
    the accept-latency setpoint, RST-shedding the excess cheaply, while
    static queues all 80 and Little's law sets the latency. Both rows
    measure the SUSTAINED crowd (a short unmeasured warm surge lets the
    controller reach steady state — SLOs are about the storm's body,
    not its first half-second)."""
    from ..components import overload as ov
    sessions = max(80, int(1200 * scale))
    base_clients, surge_clients = 8, 80      # the 10x step
    payload = random.Random(seed or "storm").randbytes(4096)
    p99_limit_ms = 120.0
    served_floor = 0.30
    saved = (ov.FLOOR, ov.TICK_MS, ov.STALL_HI_MS, ov.ACCEPT_HI_MS)
    # storm-sized controller: small floor so the shed is visible, fast
    # ticks so the ceiling moves within the surge window, and an
    # accept-latency setpoint well under the SLO being gated
    ov.FLOOR, ov.TICK_MS = 6, 50
    ov.STALL_HI_MS, ov.ACCEPT_HI_MS = 50.0, 20.0
    rows = {}
    from ..utils import sketch
    try:
        for mode in ("static", "adaptive"):
            log(f"flash_crowd: {mode} run")
            sketch.reset()  # per-mode window: the crowd must show NOW
            w = _LBWorld(f"storm-flash-{mode}", n_backends=2, workers=1,
                         overload=mode, max_sessions=4096)
            shed_ctr = _ctr("vproxy_lb_shed_total",
                            lb=f"storm-flash-{mode}", reason=mode)
            try:
                base = _fleetlib.blast(w.lb.bind_port, sessions // 6,
                                       base_clients, payload,
                                       latencies=True, timeout=15)
                # unmeasured warm surge: the controller converges
                _fleetlib.blast(w.lb.bind_port, surge_clients,
                                surge_clients, payload, retry_shed=2,
                                timeout=15)
                shed0 = shed_ctr.value()
                surge = _fleetlib.blast(w.lb.bind_port, sessions,
                                        surge_clients, payload,
                                        latencies=True, retry_shed=2,
                                        timeout=15)
                ceiling = w.lb.overload_stat().get("ceiling")
                guard = w.lb.overload_stat()
                # analytics: the flash crowd must SHOW as a heavy
                # hitter — the crowd's source in top-clients and the
                # storm LB in top-routes (utils/sketch; the loopback
                # blaster is one client address by construction)
                top_clients = sketch.top_table("clients", 5)
                top_routes = sketch.top_table("routes", 5)
            finally:
                w.close()
            attempts = max(1, sessions // surge_clients) * surge_clients
            lat = surge.get("lat_s", [])
            p99_ms = _fleetlib.percentile(lat, 99) * 1000
            crowd_seen = int(
                not sketch.enabled()  # knob off: nothing to gate
                or (bool(top_clients)
                    and top_clients[0]["key"] == "127.0.0.1"
                    and any(r["key"] == f"storm-flash-{mode}"
                            for r in top_routes)))
            slo = {
                "p99_ms": _gate(p99_ms, p99_limit_ms, "<="),
                "hard_failures": _gate(surge["fail"], 0, "=="),
                "served_rate": _gate(surge["ok"] / attempts,
                                     served_floor, ">="),
                "crowd_in_top_clients": _gate(crowd_seen, 1, "=="),
            }
            rows[mode] = {
                "mode": mode, "attempts": attempts, "ok": surge["ok"],
                "fail": surge["fail"], "shed": surge["shed"],
                "p50_ms": round(_fleetlib.percentile(lat, 50) * 1000, 2),
                "p99_ms": round(p99_ms, 2),
                "base_p99_ms": round(
                    _fleetlib.percentile(base.get("lat_s", []), 99) * 1000,
                    2),
                "final_ceiling": ceiling, "guard": guard,
                "shed_counted": shed_ctr.value() - shed0,
                "top_clients": top_clients, "top_routes": top_routes,
                "slo": slo, "pass": _passed(slo),
            }
    finally:
        ov.FLOOR, ov.TICK_MS, ov.STALL_HI_MS, ov.ACCEPT_HI_MS = saved
    # the differential: adaptive survives the load static drowns under.
    # On hardware with enough headroom that static ALSO holds every
    # gate at this scale, the crowd never saturated the loop and there
    # is no differential to demonstrate — that is capacity, not a
    # regression, so the gate passes as "demonstrated OR not
    # demonstrable here" instead of demanding the machine be slow (an
    # inverted absolute-SLO assertion would go permanently red on a
    # fast builder with zero product change). The committed artifact's
    # rows carry the actual demonstration when it happens.
    demonstrated = (not rows["static"]["slo"]["p99_ms"]["pass"]
                    and rows["adaptive"]["pass"])
    headroom = rows["static"]["pass"]
    slo = {"adaptive_passes": _gate(int(rows["adaptive"]["pass"]), 1, "=="),
           "differential": _gate(int(demonstrated or headroom), 1, "==")}
    return {"name": "flash_crowd", "rows": rows,
            "differential_demonstrated": demonstrated, "slo": slo,
            "pass": _passed(slo)}


# ------------------------------------------------------------ scenario 2

def scenario_slowloris(scale: float = 1.0, seed: int = 0,
                       log=lambda *_: None) -> dict:
    """Half-open flood: incomplete HTTP heads pin parser state until the
    pre-handover handshake deadline (VPROXY_TPU_HANDSHAKE_MS) kills and
    counts them; legit traffic must not notice."""
    from ..components import tcplb as T
    half_open = max(20, int(120 * scale))
    legit_n = max(30, int(240 * scale))
    deadline_ms = 1000
    saved_hs = T.HANDSHAKE_MS
    T.HANDSHAKE_MS = deadline_ms
    alias = "storm-loris"
    w = _LBWorld(alias, n_backends=2, workers=1, protocol="http-splice",
                 host_hint="storm.example.com")
    halfopen_ctr = _ctr("vproxy_lb_shed_total", lb=alias, reason="halfopen")
    shed0 = halfopen_ctr.value()
    port = w.lb.bind_port
    head = b"GET / HTTP/1.1\r\nHost: storm.example.com\r\n\r\n"
    try:
        log(f"slowloris: {half_open} half-open + {legit_n} legit")
        flood = []
        for _ in range(half_open):
            try:
                s = socket.create_connection(("127.0.0.1", port),
                                             timeout=5)
                s.settimeout(10)
                s.sendall(b"GET / HTTP/1.1\r\nHost: storm")  # never done
                flood.append(s)
            except OSError:
                pass
        # legit traffic WHILE the flood is pinned
        lock = threading.Lock()
        stats = {"ok": 0, "fail": 0}
        lats: list = []
        ids = {b.sid for b in w.backends}

        def legit(count: int) -> None:
            for _ in range(count):
                t0 = time.monotonic()
                try:
                    c = socket.create_connection(("127.0.0.1", port),
                                                 timeout=5)
                    c.settimeout(5)
                    c.sendall(head)
                    want = 1 + len(head)  # backend id byte + head echo
                    got = b""
                    while len(got) < want:
                        d = c.recv(4096)
                        if not d:
                            raise OSError("short")
                        got += d
                    c.close()
                    ok = got[:1] in ids and got[1:] == head
                except OSError:
                    ok = False
                with lock:
                    stats["ok" if ok else "fail"] += 1
                    if ok:
                        lats.append(time.monotonic() - t0)

        clients = 6
        ts = [threading.Thread(target=legit,
                               args=(max(1, legit_n // clients),))
              for _ in range(clients)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        # the deadline must release every half-open session (RST)
        released = 0
        release_deadline = time.monotonic() + deadline_ms / 1000.0 + 6
        for s in flood:
            s.settimeout(max(0.1, release_deadline - time.monotonic()))
            try:
                released += int(s.recv(1) == b"")
            except (ConnectionResetError, ConnectionAbortedError,
                    BrokenPipeError):
                released += 1  # RST: exactly the designed shed
            except OSError:
                pass  # still open at the deadline: NOT released
            s.close()
        _fleetlib.wait_for(lambda: w.lb.active_sessions == 0, 5)
        legit_total = stats["ok"] + stats["fail"]
        slo = {
            "legit_success": _gate(
                stats["ok"] / max(1, legit_total), 0.99, ">="),
            "halfopen_released": _gate(
                released / max(1, len(flood)), 0.99, ">="),
            "halfopen_counted": _gate(
                (halfopen_ctr.value() - shed0) / max(1, len(flood)),
                0.95, ">="),
            "sessions_drained": _gate(w.lb.active_sessions, 0, "=="),
            "legit_p99_ms": _gate(
                _fleetlib.percentile(sorted(lats), 99) * 1000, 400.0,
                "<="),
        }
        return {"name": "slowloris", "half_open": len(flood),
                "released": released,
                "halfopen_counted": halfopen_ctr.value() - shed0,
                "legit": dict(stats),
                "legit_p99_ms": round(
                    _fleetlib.percentile(sorted(lats), 99) * 1000, 2),
                "deadline_ms": deadline_ms, "slo": slo,
                "pass": _passed(slo)}
    finally:
        T.HANDSHAKE_MS = saved_hs
        w.close()


# ------------------------------------------------------------ scenario 3

def scenario_dns_storm(scale: float = 1.0, seed: int = 0,
                       log=lambda *_: None) -> dict:
    """Query storm against the packed-answer cache: repeat names (cache
    hits), NXDOMAIN misses, and a mid-storm group mutation (cache
    invalidation). Gate: ZERO failed queries — a dropped datagram is
    recovered by the client retry and counted, never lost."""
    from ..components.elgroup import EventLoopGroup
    from ..components.servergroup import (HealthCheckConfig,
                                                   ServerGroup)
    from ..components.upstream import Upstream
    from ..dns import packet as P
    from ..dns.server import DNSServer
    from ..rules.ir import HintRule
    n_svcs = 6
    total = max(400, int(4000 * scale))
    clients = 8
    elg = EventLoopGroup("storm-dns-elg", 1)
    groups = []
    ups = Upstream("storm-dns-u")
    try:
        for i in range(n_svcs):
            # protocol="none": always-healthy synthetic backends — the
            # storm is about the answer path, not health edges
            g = ServerGroup(f"storm-sd{i}", elg,
                            HealthCheckConfig(timeout_ms=500,
                                              period_ms=60000, up=1,
                                              down=2, protocol="none"),
                            "wrr")
            g.add(f"s{i}a", "10.9.0.1", 1000 + i)
            g.add(f"s{i}b", "10.9.0.2", 1000 + i)
            groups.append(g)
            ups.add(g, annotations=HintRule(
                host=f"svc{i}.storm.example"))
        d = DNSServer("storm-d", elg.next(), "127.0.0.1", 0, ups)
        d.start()
        log(f"dns_storm: {total} queries x {clients} clients")
        names = [f"svc{i}.storm.example." for i in range(n_svcs)]
        names += [f"nx{i}.storm.example." for i in range(2)]  # NXDOMAIN
        lock = threading.Lock()
        stats = {"ok": 0, "fail": 0, "retried": 0}
        lats: list = []

        def worker(wid: int, count: int) -> None:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.settimeout(0.5)
            # a string seed: Python 3.11+ refuses the reference's
            # tuple (seed, wid)
            rng = random.Random(f"{seed}:{wid}")
            for q in range(count):
                qid = (wid * 131 + q) % 65536
                name = names[rng.randrange(len(names))]
                pkt = P.Packet(id=qid, rd=True,
                               questions=[P.Question(name, P.A)]).encode()
                t0 = time.monotonic()
                got = False
                for attempt in range(3):  # client retry IS the protocol
                    try:
                        s.sendto(pkt, ("127.0.0.1", d.bind_port))
                        while True:
                            data, _ = s.recvfrom(4096)
                            resp = P.parse(data)
                            if resp.id == qid:  # stale answers skipped
                                got = True
                                break
                    except (socket.timeout, OSError):
                        with lock:
                            stats["retried"] += attempt < 2
                        continue
                    except P.DNSFormatError:
                        continue
                    break
                with lock:
                    stats["ok" if got else "fail"] += 1
                    if got:
                        lats.append(time.monotonic() - t0)
                if wid == 0 and q == count // 2:
                    # mid-storm mutation: the packed-answer cache must
                    # invalidate (group recalc bumps health_version)
                    groups[0].add("mid", "10.9.0.3", 999)
            s.close()

        ts = [threading.Thread(target=worker,
                               args=(i, max(1, total // clients)))
              for i in range(clients)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        slo = {
            "failed_queries": _gate(stats["fail"], 0, "=="),
            "p99_ms": _gate(
                _fleetlib.percentile(sorted(lats), 99) * 1000, 50.0,
                "<="),
            "cache_hits": _gate(d.cache_hits, 1, ">="),
        }
        return {"name": "dns_storm", "queries": stats["ok"] + stats["fail"],
                "ok": stats["ok"], "fail": stats["fail"],
                "retried": stats["retried"], "cache_hits": d.cache_hits,
                "server_drops": d.drops,
                "p50_ms": round(
                    _fleetlib.percentile(sorted(lats), 50) * 1000, 3),
                "p99_ms": round(
                    _fleetlib.percentile(sorted(lats), 99) * 1000, 3),
                "slo": slo, "pass": _passed(slo)}
    finally:
        try:
            d.stop()
        except Exception:
            pass
        for g in groups:
            g.close()
        elg.close()


# ------------------------------------------------------------ scenario 4

def scenario_elephant_mice(scale: float = 1.0, seed: int = 0,
                           log=lambda *_: None) -> dict:
    """One hot 5-tuple (the elephant, riding the C flow cache) vs
    hundreds of one-packet mice (every one a cache miss compiling
    through the python slow path) through the native switch. The
    elephant must not starve the mice, nothing may drop, and the
    forward/drop accounting must balance."""
    from ..net import vtl as V
    if not (V.PROVIDER == "native" and V.flowcache_supported()):
        return {"name": "elephant_mice", "skipped": True,
                "reason": "native flow cache unavailable", "pass": None}
    from ..components.secgroup import SecurityGroup
    from ..net.eventloop import SelectorEventLoop
    from ..utils.ip import Network, parse_ip
    from ..vswitch.packets import Ethernet, Ipv4, Vxlan
    from ..vswitch.switch import Switch, synthetic_mac
    from ..rules.ir import RouteRule
    elephant_n = max(400, int(4000 * scale))
    mice_n = max(60, int(400 * scale))
    DST_MAC = b"\x02\xfe\x00\x00\x00\x01"
    env = {"VPROXY_TPU_FLOWCACHE": "1",
           "VPROXY_TPU_FLOWCACHE_TTL_MS": "60000"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    loop = SelectorEventLoop("storm-sw")
    loop.loop_thread()
    sw = None
    rx = tx = None
    mice_socks: list = []
    try:
        sw = Switch("storm-sw", loop, "127.0.0.1", 0,
                    bare_vxlan_access=SecurityGroup.allow_all())
        sw.start()
        n1 = sw.add_network(101, Network.parse("10.1.0.0/16"))
        n2 = sw.add_network(102, Network.parse("10.2.0.0/16"))
        gw_mac = synthetic_mac(101, parse_ip("10.1.0.1"))
        n1.ips.add(parse_ip("10.1.0.1"), gw_mac)
        n2.ips.add(parse_ip("10.2.255.254"),
                   synthetic_mac(102, parse_ip("10.2.255.254")))
        n1.add_route(RouteRule("r0", Network.parse("10.2.0.0/16"),
                               to_vni=102))
        rx = V.udp_bind("127.0.0.1", 0)
        V.set_rcvbuf(rx, 8 << 20)
        _, rx_port = V.sock_name(rx)
        sw.add_remote_switch("out", "127.0.0.1", rx_port)
        out = sw.ifaces[("remote", "out")][0]
        n2.macs.record(DST_MAC, out)
        dst = parse_ip("10.2.0.9")
        n2.arps.record(dst, DST_MAC)

        def frame(src_ip: bytes, src_tail: int, payload: bytes) -> bytes:
            ip = Ipv4(src=src_ip, dst=dst, proto=17, payload=payload,
                      ttl=64)
            eth = Ethernet(gw_mac,
                           b"\x02\xaa\x00\x00\x00" + bytes([src_tail]),
                           0x0800, b"", packet=ip)
            return Vxlan(101, eth).to_bytes()

        # payload length tells the receiver which herd a frame is from.
        # Mice are distinct FLOWS (the key includes the outer sender
        # ip:port and the inner v4 src) from a BOUNDED endpoint set — 8
        # source MACs x 64 inner IPs, uniqueness via a sender-socket
        # pool. A brand-new mac/ip per mouse would be a MAC/ARP-LEARNING
        # mutation per packet, and the generation gate — correctly —
        # invalidates every installed flow on each one; real mice are
        # new flows from known endpoints, not new endpoints.
        ele = frame(parse_ip("10.1.0.9"), 1, b"e" * 18)
        mice = [frame(parse_ip(f"10.1.1.{1 + (i // 16) % 64}"),
                      2 + (i % 8), b"m" * 26)
                for i in range(mice_n)]
        counters0 = V.flowcache_counters()
        got = {"ele": 0, "mice": 0}
        stop_rx = threading.Event()
        ele_len, mice_len = len(ele), len(mice[0])

        def drain() -> None:
            while not stop_rx.is_set():
                try:
                    if not V.wait_readable(rx, 200):
                        continue
                except OSError:
                    return
                for data, _, _ in V.recvmmsg(rx):
                    if len(data) == ele_len:
                        got["ele"] += 1
                    elif len(data) == mice_len:
                        got["mice"] += 1

        rt = threading.Thread(target=drain, daemon=True)
        rt.start()
        log(f"elephant_mice: {elephant_n} elephant + {mice_n} mice")
        tx = V.udp_socket()
        mice_socks = [V.udp_socket() for _ in range(16)]
        sent = {"ele": 0, "mice": 0}
        # pre-learn the mice endpoints (one frame per mac/ip pair):
        # after this the storm itself causes no table mutations at all
        seen = set()
        for i, m in enumerate(mice):
            key = (2 + (i % 8), 1 + (i // 16) % 64)
            if key in seen:
                continue
            seen.add(key)
            V.sendto(mice_socks[i % 16], m, "127.0.0.1", sw.bind_port)
            sent["mice"] += 1
        time.sleep(0.4)

        def send_ele() -> None:
            # a real elephant is a LONG-LIVED flow: the first packets
            # miss (python compiles the flow entry), the stream then
            # rides the C fast path. Model that: a small warm burst, a
            # beat for the install, then the flood.
            warm = min(64, elephant_n // 4)
            for i in range(elephant_n):
                try:
                    V.sendto(tx, ele, "127.0.0.1", sw.bind_port)
                    sent["ele"] += 1
                except OSError:
                    pass
                if i == warm:
                    time.sleep(0.4)  # flow-entry install window (the
                    # compile runs on the switch loop's PYTHON side and
                    # must win the GIL from this very sender)
                elif i % 64 == 0:
                    time.sleep(0.0002)  # real yield: mice + switch loop

        def send_mice() -> None:
            for i, m in enumerate(mice):
                try:
                    V.sendto(mice_socks[i % 16], m, "127.0.0.1",
                             sw.bind_port)
                    sent["mice"] += 1
                except OSError:
                    pass
                time.sleep(0.0005)  # a trickle under the elephant

        te = threading.Thread(target=send_ele)
        tm = threading.Thread(target=send_mice)
        te.start()
        tm.start()
        te.join()
        tm.join()
        deadline = time.monotonic() + 5
        while (got["ele"] + got["mice"] < sent["ele"] + sent["mice"]
               and time.monotonic() < deadline):
            time.sleep(0.05)
        stop_rx.set()
        rt.join(2)
        counters = [c - c0 for c, c0
                    in zip(V.flowcache_counters(), counters0)]
        hits, misses = counters[0], counters[1]
        drops = sum(counters[5:])
        slo = {
            "mice_delivery": _gate(
                got["mice"] / max(1, sent["mice"]), 0.99, ">="),
            "elephant_delivery": _gate(
                got["ele"] / max(1, sent["ele"]), 0.95, ">="),
            "native_drops": _gate(drops, 0, "=="),
            "cache_hit_rate": _gate(
                hits / max(1, hits + misses), 0.5, ">="),
        }
        return {"name": "elephant_mice", "sent": dict(sent),
                "received": dict(got),
                "flowcache": {"hits": hits, "misses": misses,
                              "evict": counters[2], "stale": counters[3],
                              "native_fwd": counters[4], "drops": drops},
                "slo": slo, "pass": _passed(slo)}
    finally:
        if sw is not None:
            sw.stop()
        for fd in [rx, tx] + mice_socks:
            if fd:
                try:
                    V.close(fd)
                except OSError:
                    pass
        loop.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ------------------------------------------------------------ scenario 5

def scenario_rolling_upgrade(scale: float = 1.0, seed: int = 0,
                             log=lambda *_: None) -> dict:
    """Drain/restart every peer of a 3-node fleet, one at a time, under
    continuous step-synchronized classify load; mid-roll, a torn
    replication frame forces a REJECTED generation that must leave
    last-known-good serving. Zero failed or wrong verdicts anywhere.
    Each node's step loop carries a Maglev plane (_fleetlib.
    attach_pick_loop),
    so a step is the FusedPair's one launch and every query a
    submit_pick: a verdict other than the oracle's, or a pick other
    than the host Maglev table's, counts as bad."""
    from ..control.command import Command
    from ..rules import oracle
    from ..rules.ir import Hint
    from ..rules.maglev import pick as maglev_pick
    from ..utils import failpoint
    from ..utils.events import FlightRecorder
    failpoint.clear()
    FlightRecorder.reset()
    G = 10
    per_node_inflight = max(20, int(120 * scale))
    HB, POLL, STEP_TO = 300, 120, 400
    wait_for = _fleetlib.wait_for
    spec = _fleetlib.cluster_spec(3)
    apps, nodes = zip(*[_fleetlib.make_node(i, spec, hb_ms=HB,
                                            poll_ms=POLL)
                        for i in range(3)])
    apps, nodes = list(apps), list(nodes)
    loops: list = [None, None, None]
    stats = {i: {"ok": 0, "bad": 0, "lost": 0} for i in range(3)}
    stop_evts = [threading.Event() for _ in range(3)]
    threads: list = [None, None, None]
    lock = threading.Lock()
    report: dict = {"name": "rolling_upgrade"}
    try:
        assert wait_for(
            lambda: all(n.membership.peers_up() == 3 for n in nodes)), \
            "membership never converged"
        Command.execute(apps[0], "add upstream u0")
        for i in range(G):
            Command.execute(
                apps[0], f"add server-group g{i} timeout 500 period 60000 "
                "up 1 down 2 annotations "
                f'{{"vproxy/hint-host":"s{i}.storm.example"}}')
            Command.execute(
                apps[0], f"add server-group g{i} to upstream u0 weight 10")
        gen0 = nodes[0].replicator.generation
        assert wait_for(lambda: all(n.replicator.generation == gen0
                                    for n in nodes)), "replication lag"
        # the oracle verdict set: mid-roll mutations only APPEND groups
        # with hints nobody queries, so these indices stay authoritative
        rules = [h.merged_rule() for h in apps[0].upstreams["u0"].handles]

        def attach(i: int) -> None:
            loops[i] = _fleetlib.attach_pick_loop(
                nodes[i], apps[i].upstreams["u0"]._matcher, step_ms=20,
                batch_cap=8, timeout_ms=STEP_TO)

        for i in range(3):
            attach(i)
        assert wait_for(lambda: all(
            p.stepping for n in nodes for p in n.membership.peer_list()),
            15), "fleet never stepped"

        def traffic(i: int) -> None:
            # closed loop: one in-flight query per pass, loss bounded
            rng = random.Random(f"{seed}:roll:{i}")
            mtab = loops[i].maglev.snapshot()[0]
            q = 0
            while not stop_evts[i].is_set():
                h = Hint(host=f"s{rng.randrange(G + 2)}.storm.example")
                ip = bytes([10, 77, i, q % 256])
                port = None if q % 3 == 0 else 1024 + q % 4096
                got = {"e": threading.Event(), "idx": None, "pick": None}

                def cb(idx, pick, payload, got=got):
                    got["idx"], got["pick"] = idx, pick
                    got["e"].set()
                try:
                    loops[i].submit_pick(h, ip, port, cb)
                except OSError:
                    break  # node is being drained
                if not got["e"].wait(10):
                    with lock:
                        stats[i]["lost"] += 1
                else:
                    with lock:
                        key = ("ok" if got["idx"] == oracle.search(rules, h)
                               and got["pick"] == maglev_pick(mtab, ip, port)
                               else "bad")
                        stats[i][key] += 1
                q += 1
                time.sleep(0.01)

        def start_traffic(i: int) -> None:
            stop_evts[i] = threading.Event()
            threads[i] = threading.Thread(target=traffic, args=(i,))
            threads[i].start()

        for i in range(3):
            start_traffic(i)
        time.sleep(0.6)  # mid-traffic, not before it
        mutations = [0]
        rolls = []
        for k, victim in enumerate((2, 1, 0)):
            log(f"rolling_upgrade: drain node {victim}")
            # drain: stop steering load at it, then take it down
            stop_evts[victim].set()
            threads[victim].join(30)
            threads[victim] = None
            nodes[victim].close()
            apps[victim].close()
            time.sleep(0.8)  # survivors ride the barrier-timeout degrade
            survivors = [i for i in range(3) if i != victim
                         and threads[i] is not None]
            leader = min(survivors)
            assert wait_for(lambda: nodes[leader].membership.leader_id()
                            == leader, 10), "leadership never settled"
            # mid-roll mutation; on the middle roll the frame is TORN —
            # the follower must reject it at the framing layer and keep
            # serving last-known-good until the snapshot heal
            torn = (k == 1)
            if torn:
                failpoint.arm("cluster.replicate.torn", count=1)
            mutations[0] += 1
            m = mutations[0]
            Command.execute(
                apps[leader],
                f"add server-group roll{m} timeout 500 period 60000 up 1 "
                f"down 2 annotations "
                f'{{"vproxy/hint-host":"roll{m}.storm.example"}}')
            Command.execute(
                apps[leader],
                f"add server-group roll{m} to upstream u0 weight 10")
            genm = nodes[leader].replicator.generation
            healed = wait_for(
                lambda: all(nodes[i].replicator.generation == genm
                            for i in survivors), 20)
            rolls.append({"victim": victim, "torn": torn,
                          "generation": genm, "survivors_healed": healed})
            # restart the victim: re-sync to the CURRENT generation
            apps[victim], nodes[victim] = _fleetlib.make_node(
                victim, spec, hb_ms=HB, poll_ms=POLL)
            assert wait_for(
                lambda: all(n.membership.peers_up() == 3 for n in nodes),
                20), f"node {victim} never re-joined membership"
            assert wait_for(
                lambda: "u0" in apps[victim].upstreams
                and nodes[victim].replicator.generation
                == nodes[leader].replicator.generation, 20), \
                f"node {victim} never re-synced"
            attach(victim)
            start_traffic(victim)
            time.sleep(0.4)
        for i in range(3):
            stop_evts[i].set()
        for t in threads:
            if t is not None:
                t.join(30)
        rejects = sum(1 for e in FlightRecorder.get().snapshot()
                      if e["kind"] == "generation_reject")
        gen_final = nodes[0].replicator.generation
        converged = wait_for(
            lambda: all(n.replicator.generation == gen_final
                        for n in nodes), 10)
        # a wait, not a point sample: an engine install can still be
        # in flight right after the last roll's traffic stops
        checksums_equal = wait_for(
            lambda: len({n.replicator.checksum() for n in nodes}) == 1,
            10)
        total_bad = sum(stats[i]["bad"] for i in range(3))
        total_lost = sum(stats[i]["lost"] for i in range(3))
        total_ok = sum(stats[i]["ok"] for i in range(3))
        slo = {
            "failed_queries": _gate(total_bad + total_lost, 0, "=="),
            "rejected_generation_seen": _gate(rejects, 1, ">="),
            "healed_after_reject": _gate(
                int(all(r["survivors_healed"] for r in rolls)), 1, "=="),
            "fleet_converged": _gate(
                int(converged and checksums_equal), 1, "=="),
            "min_traffic": _gate(total_ok, per_node_inflight, ">="),
        }
        report.update({
            "traffic": {str(i): dict(stats[i]) for i in range(3)},
            "rolls": rolls, "generation_rejects": rejects,
            "final_generation": gen_final, "converged": converged,
            "checksums_equal": checksums_equal, "slo": slo,
            "pass": _passed(slo)})
        return report
    finally:
        for e in stop_evts:
            e.set()
        for t in threads:
            if t is not None:
                t.join(5)
        failpoint.clear()
        _fleetlib.close_fleet(nodes, apps)


# ---------------------------------------------------------------- driver

def scenario_replay_flash_crowd(scale: float = 1.0, seed: int = 0,
                                log=lambda *_: None) -> dict:
    """Record-replay under storm rules (docs/replay.md): record a
    flash-crowd client mix through a real LB (workload capture window
    + analytics sketch, distinct loopback client addresses), then
    replay the captured model at 2x SPEED against a FRESH world via
    tools/replay.py and hold the replay to the legit-traffic SLO —
    zero hard failures (shed is the designed degrade, scored apart),
    a served-rate floor, and the p99 bound. The schedule is the
    seeded-determinism contract: two builds of the same (model, seed)
    must hash identically and the hash rides the artifact, so a
    failed gate replays exactly."""
    from . import replay as RP
    from ..utils import sketch, workload
    from ..utils.workload import WorkloadModel
    rseed = seed or 1
    n = max(60, int(240 * scale))
    served_floor, p99_limit_ms = 0.80, 500.0
    log(f"replay_flash_crowd: recording a {n}-session crowd")
    sketch.reset()
    workload.reset()
    w = _LBWorld("storm-replay-src", n_backends=2, workers=1,
                 max_sessions=4096)
    try:
        workload.capture_start()
        mix = RP.drive_zipf_mix(w.lb.bind_port, seed=rseed, n=n,
                                clients=10, alpha=1.3, keys=14,
                                pace_s=0.004)
        workload.capture_stop()
        model = WorkloadModel.fit(seed=rseed)
    finally:
        w.close()
    # same (model, seed) -> byte-identical schedule, twice over
    h_a = RP.schedule_hash(RP.build_schedule(model, rseed, speed=2.0,
                                             max_arrivals=n))
    h_b = RP.schedule_hash(RP.build_schedule(model, rseed, speed=2.0,
                                             max_arrivals=n))
    log("replay_flash_crowd: replaying at 2x against a fresh world")
    rep = RP.run_replay(model, seed=rseed, speed=2.0, max_arrivals=n,
                        n_backends=2, workers=1, max_sessions=4096,
                        served_floor=served_floor, p99_ms=p99_limit_ms)
    total = sum(rep["results"][k] for k in ("ok", "fail", "shed"))
    slo = {
        "recorded_mix_clean": _gate(mix["fail"], 0, "=="),
        "hard_failures": _gate(rep["results"]["fail"], 0, "=="),
        "served_rate": _gate(rep["results"]["ok"] / max(1, total),
                             served_floor, ">="),
        "p99_ms": _gate(rep["p99_ms"], p99_limit_ms, "<="),
        "schedule_deterministic": _gate(
            int(h_a == h_b == rep["schedule_hash"]), 1, "=="),
    }
    return {
        "name": "replay_flash_crowd",
        "recorded": {"sessions": n, "ok": mix["ok"],
                     "shed": mix["shed"], "fail": mix["fail"],
                     "true_top3": mix["true_top"][:3]},
        "model_rate_hz": model.plane_rate("accept"),
        "schedule_hash": h_a,
        "replay": {"speed": rep["speed"], "span_s": rep["span_s"],
                   "late_s": rep["late_s"], "ok": rep["results"]["ok"],
                   "shed": rep["results"]["shed"],
                   "fail": rep["results"]["fail"],
                   "p50_ms": rep["p50_ms"], "p99_ms": rep["p99_ms"]},
        "slo": slo, "pass": _passed(slo),
    }


def scenario_adversarial_crowd(scale: float = 1.0, seed: int = 0,
                               log=lambda *_: None) -> dict:
    """The policing plane's acceptance proof (docs/robustness.md
    "admission policing"): a REPLAYED legit mix (the capture →
    schedule loop, distinct loopback client identities) runs while an
    attacking herd hammers from one address. With policing ON a
    rate-based `clients` policy — calibrated from the schedule itself
    so the hottest legit client sits at 1/3 of quota — must shed the
    herd >=90% (attributed to policing actions, receipted) while the
    legit mix holds its SLO; with policing OFF at identical load the
    differential is demonstrated (the herd eats the serving capacity
    or 3x+ the served slots), or machine-honestly reported
    not-demonstrable (the flash-crowd headroom rule)."""
    from . import replay as RP
    from ..policing import engine as policing
    from ..policing.engine import Policy, PolicingEngine
    from ..utils import failpoint, sketch, workload
    from ..utils.workload import WorkloadModel
    if not sketch.enabled():
        return {"name": "adversarial_crowd", "skipped": True,
                "reason": "analytics sketches disabled", "pass": None}
    rseed = seed or 1
    n = max(60, int(240 * scale))
    herd_threads = 3
    herd_cap = max(400, int(4000 * scale))  # per thread, a runaway stop
    herd_ip = "127.66.6.6"  # outside every legit identity range
    served_floor, p99_limit_ms = 0.30, 250.0
    herd_payload = b"h" * 256

    # --- record the legit mix (the capture loop) --------------
    log(f"adversarial_crowd: recording a {n}-session legit mix")
    sketch.reset()
    workload.reset()
    w = _LBWorld("storm-adv-src", n_backends=2, workers=1,
                 max_sessions=4096)
    try:
        workload.capture_start()
        mix = RP.drive_zipf_mix(w.lb.bind_port, seed=rseed, n=n,
                                clients=10, alpha=1.3, keys=14,
                                pace_s=0.004)
        workload.capture_stop()
        model = WorkloadModel.fit(seed=rseed)
    finally:
        w.close()
    sched = RP.build_schedule(model, rseed, speed=1.0, max_arrivals=n)
    # stretch the replay to a fixed measurement window: the capture is
    # a tight loopback blast, and a quota calibrated against THAT rate
    # would sit above anything a closed-loop herd can even offer —
    # rate discrimination needs legit rates human-shaped, not
    # benchmark-shaped. `speed` only divides at dispatch, so the
    # schedule (and its hash) is still the pure (model, seed) function
    span_s = 4.0
    src_span = (sched["arrivals"][-1]["t"] if sched["arrivals"]
                else 1.0)
    sched["speed"] = max(1e-3, src_span / span_s)
    shash = RP.schedule_hash(sched)
    # calibrate the policy FROM the schedule: the hottest legit client
    # replays at a known rate, quota = 3x that — rate discrimination,
    # not identity discrimination (the herd is caught for BEHAVING
    # like a herd, legit clients keep 3x headroom by construction)
    per_src: dict = {}
    for a in sched["arrivals"]:
        per_src[a["src"]] = per_src.get(a["src"], 0) + 1
    hot_legit_rate = max(per_src.values()) / span_s
    rate = max(4.0, 3.0 * hot_legit_rate)
    burst = 2.0 * rate

    # --- determinism receipt: same schedule + same seed => the SAME
    # shed set, twice over (the policing.decision.force coin under
    # VPROXY_TPU_FAILPOINT_SEED is the replayable-evidence contract)
    def _receipt() -> str:
        eng = PolicingEngine()
        failpoint.arm("policing.decision.force", probability=0.25,
                      seed=rseed)
        try:
            for arr in sched["arrivals"]:
                eng.check("clients", arr["src"], lb="storm-adv")
        finally:
            failpoint.clear()
        return eng.shed_receipt()

    r_a, r_b = _receipt(), _receipt()

    rows = {}
    eng = policing.default()
    try:
        for knob in ("on", "off"):
            log(f"adversarial_crowd: policing {knob} run")
            sketch.reset()
            eng.set_policies([])
            eng.reset()
            policing.configure(knob == "on")
            w = _LBWorld(f"storm-adv-{knob}", n_backends=2, workers=1,
                         max_sessions=4096, lanes=2)
            try:
                eng.set_policy(Policy("crowd", "clients", rate, burst,
                                      "shed"))
                # warm: the herd must SURFACE in the sketch before the
                # tick can bucket it — detection precedes enforcement.
                # Lane-accepted warm sessions reach the python sketch on
                # the lane-0 drain cadence (~1 poll period), so WAIT for
                # the key before ticking: a tick against a not-yet-
                # drained sketch compiles an empty table AND resets the
                # tick clock, pushing the first real install a full
                # TICK_S into the measurement window
                for _ in range(16):
                    try:
                        _fleetlib.one_session(w.lb.bind_port,
                                              herd_payload, 5,
                                              src_ip=herd_ip)
                    except OSError:
                        pass
                _fleetlib.wait_for(
                    lambda: any(r["key"] == herd_ip
                                for r in sketch.top_table("clients", 0)),
                    6)
                if knob == "on":
                    policing.tick()
                    # enforcement armed = the key holds a bucket in the
                    # decision table (the tick pushed it into the C
                    # lanes synchronously via the installer hooks)
                    if not any(e["key"] == herd_ip
                               for e in eng.table_snapshot()):
                        log("adversarial_crowd: WARNING herd key not "
                            "in decision table after warm tick")
                pol0 = eng.policed_total(action="shed", dim="clients")
                herd = {"ok": 0, "shed": 0, "fail": 0, "attempts": 0}
                hlock = threading.Lock()
                stop_herd = threading.Event()

                def herd_worker() -> None:
                    for _ in range(herd_cap):
                        if stop_herd.is_set():
                            return
                        try:
                            _fleetlib.one_session(w.lb.bind_port,
                                                  herd_payload, 5,
                                                  src_ip=herd_ip)
                        except OSError as e:
                            k = ("shed" if _fleetlib._is_shed(e)
                                 else "fail")
                        else:
                            k = "ok"
                        with hlock:
                            herd[k] += 1
                            herd["attempts"] += 1

                hts = [threading.Thread(target=herd_worker)
                       for _ in range(herd_threads)]
                for t in hts:
                    t.start()
                res = RP.replay_schedule(sched, w.lb.bind_port,
                                         timeout=10)
                stop_herd.set()
                for t in hts:
                    t.join(30)
                if knob == "on":
                    # the C lane sheds fold on the lane-0 drain tick
                    _fleetlib.wait_for(
                        lambda: eng.policed_total(
                            action="shed", dim="clients") - pol0
                        >= 0.9 * herd["shed"], 3)
                policed = eng.policed_total(action="shed",
                                            dim="clients") - pol0
            finally:
                w.close()
            total = res["ok"] + res["fail"] + res["shed"]
            p99_ms = _fleetlib.percentile(res["lat_s"], 99) * 1000
            legit_slo = {
                "hard_failures": _gate(res["fail"], 0, "=="),
                "served_rate": _gate(res["ok"] / max(1, total),
                                     served_floor, ">="),
                "p99_ms": _gate(p99_ms, p99_limit_ms, "<="),
            }
            rows[knob] = {
                "policing": knob,
                "legit": {"ok": res["ok"], "fail": res["fail"],
                          "shed": res["shed"],
                          "p50_ms": round(_fleetlib.percentile(
                              res["lat_s"], 50) * 1000, 2),
                          "p99_ms": round(p99_ms, 2)},
                "herd": dict(herd), "policed_sheds": policed,
                "shed_receipt": eng.shed_receipt(),
                "legit_slo": legit_slo,
                "legit_pass": _passed(legit_slo),
            }
    finally:
        policing.configure(True)
        eng.set_policies([])
        eng.reset()
    on, off = rows["on"], rows["off"]
    herd_rej = on["herd"]["shed"] / max(1, on["herd"]["attempts"])
    # the differential, under the flash-crowd honesty rule: OFF either
    # breaks a legit gate or hands the herd 3x+ the served slots
    # (demonstrated); a machine with headroom for BOTH at this scale
    # has nothing to demonstrate and says so instead of going red
    demonstrated = ((not off["legit_pass"])
                    or off["herd"]["ok"] >= 3 * max(1, on["herd"]["ok"]))
    headroom = off["legit_pass"]
    slo = {
        "legit_slo_on": _gate(int(on["legit_pass"]), 1, "=="),
        "herd_rejected": _gate(herd_rej, 0.90, ">="),
        "herd_attributed": _gate(
            int(on["policed_sheds"] >= 0.9 * on["herd"]["shed"]), 1,
            "=="),
        "receipt_deterministic": _gate(int(r_a == r_b), 1, "=="),
        "differential": _gate(int(demonstrated or headroom), 1, "=="),
    }
    return {"name": "adversarial_crowd",
            "recorded": {"sessions": n, "ok": mix["ok"],
                         "shed": mix["shed"], "fail": mix["fail"]},
            "schedule_hash": shash,
            "policy": {"rate": round(rate, 2), "burst": round(burst, 2),
                       "hot_legit_rate": round(hot_legit_rate, 2)},
            "rows": rows,
            "determinism_receipt": r_a,
            "differential_demonstrated": demonstrated,
            "slo": slo, "pass": _passed(slo)}


SCENARIOS = {
    "flash_crowd": scenario_flash_crowd,
    "adversarial_crowd": scenario_adversarial_crowd,
    "replay_flash_crowd": scenario_replay_flash_crowd,
    "slowloris": scenario_slowloris,
    "dns_storm": scenario_dns_storm,
    "elephant_mice": scenario_elephant_mice,
    "rolling_upgrade": scenario_rolling_upgrade,
}


def device_counts() -> dict:
    """The engine's dispatches by kind and the launches of the CUDA
    kernels that serve them on "torch": B1 (fused classify+pick, with
    its route column), B3 (its verdict-only instances), B4 (CIDR)."""
    from ..ops import cidr_cuda as CC
    from ..ops import fused_cuda as FC
    from ..rules import engine as E
    return {"batches": E.dispatches_by_kind(),
            "launches": {"B1": FC.fused_classify_pick_cuda.launches,
                         "B3": FC.hint_match_cuda.launches,
                         "B4": CC.cidr_first_cuda.launches}}


def counts_since(before: dict) -> dict:
    """device_counts() now less `before` (batch kinds that moved)."""
    now = device_counts()
    batches = {k: v - before["batches"].get(k, 0)
               for k, v in now["batches"].items()}
    return {"batches": {k: v for k, v in batches.items() if v},
            "launches": {k: v - before["launches"][k]
                         for k, v in now["launches"].items()}}


def _metrics_view(prefixes: tuple) -> dict:
    """Counters and gauges (histograms as percentiles) of the families
    under `prefixes`, keyed "name.label_value..." as the reference's
    bench_snapshot keys them."""
    from ..utils.metrics import GlobalInspection, Histogram
    reg = GlobalInspection.get().registry
    with reg._lock:
        metrics = [m for m in reg._metrics if m.name.startswith(prefixes)]
    out: dict = {}
    for m in metrics:
        key = m.name
        if m.labels:
            key += "." + ".".join(str(v) for _, v in
                                  sorted(m.labels.items()))
        try:
            out[key] = (m.percentiles() if isinstance(m, Histogram)
                        else m.value())
        except Exception:
            pass  # a dead GaugeF fn must not sink the report
    return out


def run_all(seed: int = 0, scale: float = 1.0, only: str = None,
            log=lambda *_: None) -> dict:
    device = _fleetlib.select_device()
    os.environ["VPROXY_TPU_FAILPOINT_SEED"] = str(seed)
    report = {"round": ROUND, "seed": seed, "scale": scale,
              "device": str(device),
              "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
              "scenarios": {}}
    names = [only] if only else list(SCENARIOS)
    for name in names:
        log(f"=== scenario {name}")
        t0 = time.monotonic()
        c0 = device_counts()
        try:
            out = SCENARIOS[name](scale=scale, seed=seed, log=log)
        except Exception as e:  # a crashed scenario is a FAILED gate
            out = {"name": name, "error": f"{type(e).__name__}: {e}",
                   "pass": False}
        out["elapsed_s"] = round(time.monotonic() - t0, 2)
        out["device"] = counts_since(c0)
        report["scenarios"][name] = out
        log(f"=== scenario {name}: "
            f"{'SKIP' if out.get('skipped') else 'PASS' if out.get('pass') else 'FAIL'} "
            f"({out['elapsed_s']}s)")
    ran = [s for s in report["scenarios"].values() if not s.get("skipped")]
    report["pass"] = bool(ran) and all(s.get("pass") for s in ran)
    # the shed/drop counters the scenarios exercised, straight from the
    # production /metrics surface
    report["metrics"] = _metrics_view(("vproxy_lb_shed_total",
                                       "vproxy_lb_overload_total",
                                       "vproxy_udp_drop_total",
                                       "vproxy_cluster_",
                                       "vproxy_trace_"))
    # storm runs under VPROXY_TPU_TRACE_SAMPLE dump their worst traces
    # like the bench --trace stage: the slowest sampled requests of an
    # adversarial run, attribution included, right in the report
    from ..utils import trace as TR
    if TR.enabled():
        report["slowest_traces"] = TR.slowest(8)
        report["stage_table"] = TR.stage_table()
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="pin failpoint RNGs + payloads; echoed into "
                    "the artifact so a failed gate replays exactly")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink/grow every scenario's load shape")
    ap.add_argument("--only", choices=sorted(SCENARIOS), default=None)
    ap.add_argument("--device", default=None,
                    help="serve on this torch device (default: "
                    "VPROXY_TPU_TORCH_DEVICE, else cuda; no GPU raises "
                    "unless cpu is asked for)")
    ap.add_argument("--out", default=None,
                    help="also write the report JSON here (nothing is "
                    "written without it)")
    args = ap.parse_args(argv)
    _fleetlib.select_device(args.device)
    report = run_all(seed=args.seed, scale=args.scale, only=args.only,
                     log=lambda m: print(f"[storm] {m}", file=sys.stderr))
    print(json.dumps(report, indent=2, default=str))
    if args.out:
        with open(args.out + ".tmp", "w") as f:
            json.dump(report, f, indent=2, default=str)
        os.replace(args.out + ".tmp", args.out)
    print(f"[storm] overall: {'PASS' if report['pass'] else 'FAIL'}",
          file=sys.stderr)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
