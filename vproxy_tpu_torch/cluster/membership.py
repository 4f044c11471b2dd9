"""Cluster membership — UDP heartbeats among peers with hysteresis edges.

A copy of `vproxy_tpu/cluster/membership.py`; one change: this node's
id is the torch.distributed rank when a process group is up (in place
of jax.process_index()).

The fleet-coordination analog of Maglev's LB-fleet membership (NSDI'16,
PAPERS.md): every vproxy-tpu host heartbeats every other host over UDP
and keeps an up/down view with the SAME edge-hysteresis idiom as the
backend health checker (components/servergroup._HealthChecker._result:
N consecutive good periods flip UP, N consecutive missed periods flip
DOWN), so a single dropped datagram never flaps the fleet view.

Topology comes from `VPROXY_TPU_CLUSTER_PEERS` — a comma-separated list
of `host:port[/replport]` entries, one per node, in node-id order (the
replication TCP port defaults to the heartbeat port + 1). This node's
id is `torch.distributed.get_rank()` when a process group is up (the
cluster id IS the job's rank, parallel/mesh.py init_distributed) and
`VPROXY_TPU_CLUSTER_SELF` otherwise.

The heartbeat datagram carries (node id, rule generation, stepping
flag, boot incarnation): generation is how a degraded host learns the
fleet moved to a new table generation (its re-join edge,
cluster/submit.py), stepping is how the step barrier knows which peers
participate in SPMD dispatch.

The same socket carries the step-barrier arrive messages
(cluster/submit.py) — one port per node in the peers spec, demuxed on
the "t" field. Heartbeat RX is a failpoint site (`cluster.peer.drop`,
ctx "from=<id> <addr>"): dropping a peer's heartbeats drives the DOWN
edge deterministically in tests without killing anything.

Membership feeds DNS-as-LB across the fleet: `dns_addrs()` returns the
UP peers' addresses for the cluster service name
(`<VPROXY_TPU_CLUSTER_SERVICE>.vproxy.local`, dns/server.py) — and
never returns an empty set: this node itself is always a member, so
the last peer is never evicted from the answers (an empty A answer
would take the whole service down harder than any dead peer could).
"""
from __future__ import annotations

import json
import os
import select
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..utils import failpoint
from ..utils.log import Logger

_log = Logger("cluster-member")

HB_MS = int(os.environ.get("VPROXY_TPU_CLUSTER_HB_MS", "200"))
UP_N = int(os.environ.get("VPROXY_TPU_CLUSTER_UP", "2"))
DOWN_N = int(os.environ.get("VPROXY_TPU_CLUSTER_DOWN", "3"))


def cluster_service_name() -> str:
    """Sub-domain left of `.vproxy.local` that answers the healthy peer
    set (DNS-as-LB across the fleet)."""
    return os.environ.get("VPROXY_TPU_CLUSTER_SERVICE", "cluster")


@dataclass
class Peer:
    node_id: int
    ip: str
    port: int          # heartbeat/barrier UDP port
    repl_port: int     # rule-replication TCP port
    up: bool = False
    generation: int = 0    # last generation advertised in a heartbeat
    stepping: bool = False  # participating in step-synchronized dispatch
    incarnation: float = 0.0  # peer's boot stamp (restart detection)
    last_rx: float = 0.0
    # last analytics top-K summary gossiped in this peer's heartbeats
    # ({dim: [[key, count], ...]}, utils/sketch.gossip_summary) — the
    # fleet-merge input for GET /analytics on any node
    hh: Optional[dict] = field(default=None, repr=False)
    # last policing enforcement summary gossiped the same way
    # ({"seq", "t": [[dim, key, rate_mtok, burst_mtok, act], ...]},
    # policing/engine.gossip_summary) — a crowd seen by one node sheds
    # fleet-wide within one heartbeat period
    police: Optional[dict] = field(default=None, repr=False)
    _up_cnt: int = 0
    _down_cnt: int = 0
    _rx_since_tick: int = field(default=0, repr=False)

    @property
    def addr(self) -> tuple:
        return (self.ip, self.port)

    def describe(self) -> dict:
        return {"id": self.node_id, "address": f"{self.ip}:{self.port}",
                "replication": f"{self.ip}:{self.repl_port}",
                "up": self.up, "generation": self.generation,
                "stepping": self.stepping}


def parse_peers(spec: str) -> list[Peer]:
    """`host:port[/replport],...` in node-id order."""
    peers = []
    for i, part in enumerate(filter(None, (p.strip()
                                           for p in spec.split(",")))):
        body, _, repl = part.partition("/")
        host, _, port = body.rpartition(":")
        if host.startswith("[") and host.endswith("]"):
            host = host[1:-1]
        if not host or not port:
            raise ValueError(f"bad cluster peer {part!r} "
                             "(want host:port[/replport])")
        p = int(port)
        peers.append(Peer(node_id=i, ip=host, port=p,
                          repl_port=int(repl) if repl else p + 1))
    return peers


def self_node_id() -> int:
    """The torch.distributed rank when a process group of more than one
    process is up, else VPROXY_TPU_CLUSTER_SELF (default
    VPROXY_TPU_DIST_PROCID, then 0)."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized() and \
                dist.get_world_size() > 1:
            return dist.get_rank()
    except Exception:
        pass
    return int(os.environ.get(
        "VPROXY_TPU_CLUSTER_SELF",
        os.environ.get("VPROXY_TPU_DIST_PROCID", "0") or "0"))


class Membership:
    """UDP heartbeat loop + peer table. One daemon thread owns the
    socket (send + recv + hysteresis tick); the peer table is read
    under a lock by the DNS/metrics/command surfaces."""

    def __init__(self, self_id: int, peers: list[Peer],
                 hb_ms: int = 0, up: int = 0, down: int = 0,
                 meta: Optional[Callable[[], dict]] = None):
        if not any(p.node_id == self_id for p in peers):
            raise ValueError(f"self id {self_id} not in peers "
                             f"{[p.node_id for p in peers]}")
        self.self_id = self_id
        self.hb_ms = hb_ms or HB_MS
        self.up_n = up or UP_N
        self.down_n = down or DOWN_N
        self._meta = meta
        self._lock = threading.Lock()
        self.peers: dict[int, Peer] = {p.node_id: p for p in peers}
        me = self.peers[self_id]
        me.up = True  # this node is always a member of its own view
        me.stepping = True
        self.incarnation = time.time()
        me.incarnation = self.incarnation
        self._listeners: list[Callable[[Peer, bool], None]] = []
        self._step_handler: Optional[Callable[[dict, int], None]] = None
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((me.ip, me.port))
        if me.port == 0:
            me.port = self._sock.getsockname()[1]
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        # maglev steering table over the UP peer set (rules/maglev.py):
        # (up-id-key, live peers, table, names, last remap fraction).
        # Rebuilt on peer edges — on the membership thread, never a
        # serving one (the DNS steerer only reads the published tuple).
        # The build lock keeps a reader that races a peer edge from
        # publishing a table built against the pre-edge live set over
        # the membership thread's fresh one
        self._maglev: Optional[tuple] = None
        self._maglev_lock = threading.Lock()

    # ------------------------------------------------------------- control

    def start(self) -> None:
        if self._thread is not None:
            return
        try:
            self._maglev_table()  # pre-build: first steer never pays it
        except Exception:
            _log.error("maglev steering prebuild failed", exc=True)
        self._thread = threading.Thread(target=self._run,
                                        name="cluster-membership",
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stopped = True
        try:
            self._sock.close()
        except OSError:
            pass

    def on_peer_change(self, cb: Callable[[Peer, bool], None]) -> None:
        self._listeners.append(cb)

    def set_step_handler(self, cb: Optional[Callable[[dict, int], None]]) -> None:
        """cb(msg, peer_id) for `t=step` datagrams (cluster/submit.py)."""
        self._step_handler = cb

    def add_peer(self, node_id: int, ip: str, port: int,
                 repl_port: int = 0) -> Peer:
        with self._lock:
            if node_id in self.peers:
                raise ValueError(f"cluster-node {node_id} already exists")
            p = Peer(node_id=node_id, ip=ip, port=port,
                     repl_port=repl_port or port + 1)
            self.peers[node_id] = p
        return p

    def remove_peer(self, node_id: int) -> None:
        if node_id == self.self_id:
            raise ValueError("cannot remove this node from its own view")
        with self._lock:
            if node_id not in self.peers:
                raise KeyError(node_id)
            p = self.peers.pop(node_id)
        if p.up:
            self._notify(p, False)

    # -------------------------------------------------------------- views

    def live_peers(self) -> list[Peer]:
        with self._lock:
            return [p for p in self.peers.values() if p.up]

    def peer_list(self) -> list[Peer]:
        with self._lock:
            return sorted(self.peers.values(), key=lambda p: p.node_id)

    def leader_id(self) -> int:
        """Lowest live node id (this node always counts as live)."""
        return min(p.node_id for p in self.live_peers())

    def is_leader(self) -> bool:
        return self.leader_id() == self.self_id

    def peers_up(self) -> int:
        return len(self.live_peers())

    def dns_addrs(self) -> list[bytes]:
        """UP peer addresses for the cluster service name. Never empty:
        this node is always in its own view, so the last peer is never
        evicted from the DNS answers."""
        from ..utils.ip import parse_ip
        out = []
        for p in self.live_peers():
            try:
                out.append(parse_ip(p.ip))
            except (OSError, ValueError):
                continue
        if not out:
            out.append(parse_ip(self.peers[self.self_id].ip))
        return out

    def max_generation_seen(self) -> int:
        with self._lock:
            return max((p.generation for p in self.peers.values()),
                       default=0)

    def peer_analytics(self) -> dict:
        """{node_id: gossiped top-K summary} for every UP peer that has
        sent one (this node excluded — its live sketches are merged
        directly, utils/sketch.fleet_table)."""
        with self._lock:
            return {p.node_id: p.hh for p in self.peers.values()
                    if p.up and p.node_id != self.self_id
                    and p.hh is not None}

    def peer_policing(self) -> dict:
        """{node_id: gossiped enforcement summary} for every UP peer —
        the merge input for policing/engine.ingest_peer_tables (local
        entries always win there; dead peers' tables age out by TTL)."""
        with self._lock:
            return {p.node_id: p.police for p in self.peers.values()
                    if p.up and p.node_id != self.self_id
                    and p.police is not None}

    # ------------------------------------------------- maglev steering

    def _maglev_table(self) -> tuple:
        """The steering table over the CURRENT up set — rebuilt only
        when the up-id set changed (one atomic tuple publish; readers
        on serving threads never pay the build). Peer identity is
        id:ip:port, so a peer keeps its permutation — and its clients —
        across everyone else's churn."""
        live = sorted(self.live_peers(), key=lambda p: p.node_id)
        key = tuple(p.node_id for p in live)
        cur = self._maglev
        if cur is not None and cur[0] == key:
            return cur
        with self._maglev_lock:
            # re-derive INSIDE the lock: a concurrent builder may have
            # published while this one waited, and the up set may have
            # moved again — building from the pre-lock snapshot could
            # publish a dead peer over the fresh table
            live = sorted(self.live_peers(), key=lambda p: p.node_id)
            key = tuple(p.node_id for p in live)
            cur = self._maglev
            if cur is not None and cur[0] == key:
                return cur
            return self._maglev_build(live, key, cur)

    def _maglev_build(self, live, key, cur) -> tuple:
        from ..rules import maglev as MG
        m = int(os.environ.get("VPROXY_TPU_CLUSTER_MAGLEV_M", "0")) \
            or MG.DEFAULT_M
        names = [f"{p.node_id}:{p.ip}:{p.port}" for p in live]
        tab = MG.build_table([(n, 1) for n in names], m)
        remap = MG.remap_fraction(
            cur[2] if cur else None, tab,
            cur[3] if cur else None, names) if cur else 0.0
        built = (key, live, tab, names, remap)
        self._maglev = built
        from ..utils import events
        if cur is not None:
            events.record(
                "cluster_steer_rebuild",
                f"peer steering table rebuilt over {len(live)} UP peers: "
                f"{remap:.1%} of client affinities moved",
                peers=len(live), remap=round(remap, 4))
        return built

    def steer_addrs(self, client_ip: bytes) -> list[bytes]:
        """UP peer addresses with the Maglev-picked owner FIRST (DNS
        clients use the first A record; the rest ride along as
        fallback). One FNV over the client address + one slot load —
        and a peer join/death moves only ~1/N of client affinities,
        where the old id-ordered answer pinned every client to the
        lowest id and a resize reshuffled arbitrarily. Never empty
        (this node is always in its own up set)."""
        from ..rules import maglev as MG
        from ..utils.ip import parse_ip
        _key, live, tab, _names, _remap = self._maglev_table()
        addrs = []
        for p in live:
            try:
                addrs.append(parse_ip(p.ip))
            except (OSError, ValueError):
                addrs.append(None)  # hold index alignment with the table
        i = MG.pick(tab, client_ip)  # source affinity: address only
        out = []
        if 0 <= i < len(addrs) and addrs[i] is not None:
            out.append(addrs[i])
        out.extend(a for j, a in enumerate(addrs)
                   if a is not None and j != i)
        if not out:
            out.append(parse_ip(self.peers[self.self_id].ip))
        return out

    def steer_peer(self, key: bytes) -> Optional[Peer]:
        """Maglev-consistent UP peer for an arbitrary steering key (the
        cluster plane's generic client-steering primitive)."""
        from ..rules import maglev as MG
        _k, live, tab, _n, _r = self._maglev_table()
        i = MG.pick(tab, key)
        return live[i] if 0 <= i < len(live) else None

    def steer_status(self) -> dict:
        """GET /cluster: the steering table's shape + last-resize churn."""
        cur = self._maglev
        if cur is None:
            return {"built": False}
        return {"built": True, "m": int(len(cur[2])), "peers": len(cur[1]),
                "last_remap": round(cur[4], 4)}

    # ---------------------------------------------------------- main loop

    def send_step(self, payload: dict) -> None:
        """Broadcast a step-barrier datagram to every OTHER peer (the
        barrier in cluster/submit.py rides the membership socket)."""
        payload = dict(payload)
        payload["t"] = "step"
        payload["id"] = self.self_id
        data = json.dumps(payload, separators=(",", ":")).encode()
        with self._lock:
            others = [p.addr for p in self.peers.values()
                      if p.node_id != self.self_id]
        for addr in others:
            try:
                self._sock.sendto(data, addr)
            except OSError:
                pass

    def _heartbeat_payload(self) -> bytes:
        hb = {"t": "hb", "id": self.self_id, "inc": self.incarnation,
              "gen": 0, "stepping": True}
        if self._meta is not None:
            try:
                hb.update(self._meta())
            except Exception:
                pass
        me = self.peers[self.self_id]
        me.generation = int(hb.get("gen", 0))
        me.stepping = bool(hb.get("stepping", True))
        return json.dumps(hb, separators=(",", ":")).encode()

    def _run(self) -> None:
        next_tick = time.monotonic()
        while not self._stopped:
            now = time.monotonic()
            if now >= next_tick:
                self._send_heartbeats()
                self._tick()
                next_tick = now + self.hb_ms / 1000.0
            timeout = max(0.0, next_tick - time.monotonic())
            try:
                r, _, _ = select.select([self._sock], [], [], timeout)
            except (OSError, ValueError):
                return  # socket closed
            if not r:
                continue
            try:
                data, addr = self._sock.recvfrom(65536)
            except OSError:
                continue
            self._on_datagram(data, addr)

    def _send_heartbeats(self) -> None:
        data = self._heartbeat_payload()
        with self._lock:
            others = [p.addr for p in self.peers.values()
                      if p.node_id != self.self_id]
        for addr in others:
            try:
                self._sock.sendto(data, addr)
            except OSError:
                pass

    def poke(self) -> None:
        """Send an immediate out-of-cycle heartbeat: stepping-flag and
        generation transitions (attach/degrade/rejoin) must reach peers
        NOW, not a heartbeat period later — the step barrier reads
        those flags to build its wait set (cluster/submit.py), and a
        stale flag either wedges peers on a host that stopped stepping
        or hides one that just started."""
        self._send_heartbeats()

    def _on_datagram(self, data: bytes, addr: tuple) -> None:
        try:
            msg = json.loads(data)
            peer_id = int(msg["id"])
        except (ValueError, KeyError, TypeError):
            return
        if msg.get("t") == "step":
            h = self._step_handler
            if h is not None:
                h(msg, peer_id)
            return
        if msg.get("t") != "hb":
            return
        if failpoint.hit("cluster.peer.drop", f"from={peer_id} {addr[0]}"):
            return
        with self._lock:
            p = self.peers.get(peer_id)
            if p is None:
                return
            inc = float(msg.get("inc", 0.0))
            if p.incarnation and inc > p.incarnation and p.up:
                # the peer restarted between two of our ticks: treat the
                # new incarnation as a fresh node (hysteresis restarts)
                p.up = False
                p._up_cnt = p._down_cnt = 0
                restarted: Optional[Peer] = p
            else:
                restarted = None
            p.incarnation = inc
            p.generation = int(msg.get("gen", 0))
            p.stepping = bool(msg.get("stepping", False))
            hh = msg.get("hh")
            if isinstance(hh, dict):  # analytics top-K rides heartbeats
                p.hh = hh
            pol = msg.get("police")
            if isinstance(pol, dict):  # enforcement tables ride them too
                p.police = pol
            p.last_rx = time.monotonic()
            p._rx_since_tick += 1
        if restarted is not None:
            self._notify(restarted, False)

    def _tick(self) -> None:
        """Per-period hysteresis, the ServerGroup health-check idiom:
        heartbeats seen this period count as one success, silence as
        one failure; edges at up_n/down_n consecutive periods."""
        edges: list[tuple[Peer, bool]] = []
        with self._lock:
            for p in self.peers.values():
                if p.node_id == self.self_id:
                    continue
                if p._rx_since_tick > 0:
                    p._rx_since_tick = 0
                    p._up_cnt += 1
                    p._down_cnt = 0
                    if not p.up and p._up_cnt >= self.up_n:
                        p.up = True
                        edges.append((p, True))
                else:
                    p._down_cnt += 1
                    p._up_cnt = 0
                    if p.up and p._down_cnt >= self.down_n:
                        p.up = False
                        p.stepping = False
                        edges.append((p, False))
        for p, up in edges:
            self._notify(p, up)

    def _notify(self, peer: Peer, up: bool) -> None:
        from ..utils import events
        events.record("peer_up" if up else "peer_down",
                      f"cluster node {peer.node_id} ({peer.ip}:{peer.port}) "
                      + ("UP" if up else "DOWN"),
                      node=peer.node_id, generation=peer.generation)
        _log.info(f"cluster node {peer.node_id} "
                  + ("UP" if up else "DOWN"))
        try:
            # rebuild the steering table FIRST, before the listeners (a
            # replicator callback can block on I/O): a DNS query racing
            # that window would otherwise see the stale up-set key and
            # pay the full 65537-slot build on its serving loop
            self._maglev_table()
        except Exception:
            _log.error("maglev steering rebuild failed", exc=True)
        for cb in list(self._listeners):
            try:
                cb(peer, up)
            except Exception:
                _log.error("peer-change listener failed", exc=True)
