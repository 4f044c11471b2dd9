"""Cluster plane — membership, rule replication, step-synchronized SPMD
serving (ROADMAP north star: one fleet serving as one proxy).

A copy of `vproxy_tpu/cluster/__init__.py`; this node's id comes from
the torch.distributed rank (membership.self_node_id).

Three layers, one node object:

* membership.py — UDP heartbeats + hysteresis up/down edges; feeds
  DNS-as-LB (the cluster service name answers only healthy peers) and
  elects the leader (lowest live node id).
* replicate.py — the leader ships generation-tagged command-log
  snapshots/increments over TCP; followers install a generation only
  after the engine-table checksum matches the leader's.
* submit.py — the step clock: per-host classify queues drain into
  fixed-shape padded batches on a fleet-wide barrier; barrier timeout
  degrades a host to the inline host-index path, re-joining on the
  next rule generation.

Boot: `ClusterNode.boot_from_env(app)` (main.py) when
VPROXY_TPU_CLUSTER_PEERS is set. Operate: `add/remove/list
cluster-node` (control/command.py), `GET /cluster` (HTTP controller +
inspection server), `vproxy_cluster_*` metrics (utils/metrics.py).
"""
from __future__ import annotations

import os
import threading
from typing import Optional

from ..utils.log import Logger
from .membership import (Membership, Peer, cluster_service_name,
                         parse_peers, self_node_id)
from .replicate import Replicator, cluster_checksum
from .submit import StepLoop

_log = Logger("cluster")

__all__ = ["ClusterNode", "Membership", "Replicator", "StepLoop", "Peer",
           "cluster_checksum", "cluster_service_name", "dns_peer_addrs",
           "parse_peers", "self_node_id"]


class ClusterNode:
    """One per process; ties membership + replication + the step loop
    and feeds the metrics/DNS/command surfaces."""

    _instance: Optional["ClusterNode"] = None
    _ilock = threading.Lock()

    def __init__(self, app, self_id: int, peers: list[Peer],
                 hb_ms: int = 0, poll_ms: int = 0):
        self.app = app
        self.self_id = self_id
        self.membership = Membership(self_id, peers, hb_ms=hb_ms,
                                     meta=self._hb_meta)
        me = self.membership.peers[self_id]
        self.replicator = Replicator(app, self.membership, me.ip,
                                     me.repl_port, poll_ms=poll_ms)
        me.repl_port = self.replicator.bind_port
        self.submit: Optional[StepLoop] = None
        self.replicator.on_generation(self._on_generation)
        with ClusterNode._ilock:
            ClusterNode._instance = self

    # ------------------------------------------------------------- wiring

    def _hb_meta(self) -> dict:
        meta = {"gen": self.replicator.generation,
                "stepping": self.submit is not None
                and not self.submit.degraded and self.submit.error is None
                and not self.submit.stopped}
        # gossip this node's analytics top-K (utils/sketch): any node's
        # GET /analytics can then render the fleet-merged top table.
        # ALWAYS present (possibly {}): an empty summary must OVERWRITE
        # the peer's stored view, or a node whose burst aged out of its
        # windows would haunt the fleet table forever
        from ..utils import sketch
        meta["hh"] = sketch.gossip_summary() if sketch.enabled() else {}
        # gossip the local-origin policing enforcement table the same
        # way (policing/engine): a crowd detected by one node is shed by
        # every node within a heartbeat period. Same ALWAYS-present
        # rule: {} overwrites, so a policy removal propagates too.
        from ..policing import engine as policing
        meta["police"] = (policing.gossip_summary()
                          if policing.enabled() else {})
        # ingest is piggybacked on the heartbeat TX tick (no extra
        # thread): merge every UP peer's last-gossiped table into the
        # local engine (local entries win; peer entries age out by TTL)
        policing.ingest_peer_tables(self.membership.peer_policing())
        return meta

    def fleet_analytics(self) -> dict:
        """The fleet-merged top table: this node's live sketches +
        every UP peer's gossiped summary."""
        from ..utils import sketch
        return sketch.fleet_table(self.membership.peer_analytics())

    def fleet_policing(self) -> dict:
        """Per-node policed-action attribution for GET /analytics:
        this node's live counts + nothing gossiped yet beyond tables —
        peers report their own counts on their own /analytics; here we
        expose which peers are enforcing (table seq) next to ours."""
        from ..policing import engine as policing
        mine = policing.default().policed_by_node()
        peers = {str(nid): {"seq": (summ or {}).get("seq", 0)}
                 for nid, summ in self.membership.peer_policing().items()}
        return {"self": mine, "peers": peers}

    def _on_generation(self, gen: int) -> None:
        # new rule generation == new step epoch: every host resets its
        # barrier to step 0 of epoch `gen`; a degraded host re-joins
        if self.submit is not None:
            self.submit.rejoin(gen)
            self.membership.poke()  # epoch/stepping flip reaches peers now

    def attach_submit(self, matcher, **kw) -> StepLoop:
        """Attach (and start) the step-synchronized submit loop over
        `matcher` (typically an Upstream's HintMatcher on the multi-host
        mesh)."""
        if self.submit is not None:
            self.submit.stop()
        kw.setdefault("on_degrade", self.membership.poke)
        self.submit = StepLoop(matcher, self.membership, **kw)
        self.submit.start()
        # stepping=true must reach peers before their next barrier, not
        # a heartbeat period later (the flag gates their wait sets)
        self.membership.poke()
        return self.submit

    def on_command(self, line: str) -> None:
        """Command.execute hook: a successful replicated-type mutation
        ran on this node."""
        self.replicator.on_command(line)

    # ------------------------------------------------------------ surface

    def stat(self, key: str) -> float:
        if key == "peers_up":
            return float(self.membership.peers_up())
        if key == "generation":
            return float(self.replicator.generation)
        if key == "generation_lag":
            return float(self.replicator.generation_lag())
        if key == "steps_total":
            return 0.0 if self.submit is None \
                else float(self.submit.steps_total)
        if key == "barrier_stalls_total":
            return 0.0 if self.submit is None \
                else float(self.submit.barrier_stalls)
        return 0.0

    def status(self) -> dict:
        """The `GET /cluster` / `list-detail cluster-node` view."""
        d = {"enabled": True, "self": self.self_id,
             "leader": self.membership.leader_id(),
             "is_leader": self.membership.is_leader(),
             "service": f"{cluster_service_name()}.vproxy.local",
             "steering": self.membership.steer_status(),
             "peers": [p.describe() for p in self.membership.peer_list()]}
        d.update(self.replicator.status())
        d["step"] = None if self.submit is None else self.submit.status()
        return d

    def stop_stepping(self) -> None:
        """Stop the attached step loop (StepLoop.stop: the peers hear at
        once that this node no longer steps; its threads are joined).
        The first step of shutdown: main.py runs it before the drain."""
        if self.submit is not None:
            self.submit.stop()

    def close(self) -> None:
        self.stop_stepping()
        self.replicator.close()
        self.membership.close()
        with ClusterNode._ilock:
            if ClusterNode._instance is self:
                ClusterNode._instance = None

    # --------------------------------------------------------------- boot

    @classmethod
    def boot_from_env(cls, app) -> Optional["ClusterNode"]:
        """VPROXY_TPU_CLUSTER_PEERS=host:port[/replport],... — node id =
        list position; this node's id from the torch.distributed rank /
        VPROXY_TPU_CLUSTER_SELF. Returns None when unset (single-host
        deployments never pay for the cluster plane)."""
        spec = os.environ.get("VPROXY_TPU_CLUSTER_PEERS", "")
        if not spec.strip():
            return None
        peers = parse_peers(spec)
        self_id = self_node_id()
        node = cls(app, self_id, peers)
        node.membership.start()
        node.replicator.start()
        _log.info(f"cluster node {self_id}/{len(peers)} up "
                  f"(hb {node.membership.hb_ms}ms, repl port "
                  f"{node.replicator.bind_port})")
        return node


def dns_peer_addrs(client_ip: Optional[bytes] = None) -> Optional[list]:
    """Healthy peer addresses for the cluster service name, or None when
    no cluster is booted (dns/server.py falls through). With a client
    address the answer is Maglev-STEERED: the picked peer rides first
    (clients use the first A record), so a peer join/death mid-traffic
    moves only ~1/N of client affinities instead of reshuffling the
    whole fleet (membership.steer_addrs; docs/cluster.md)."""
    node = ClusterNode._instance
    if node is None:
        return None
    if client_ip is not None:
        return node.membership.steer_addrs(client_ip)
    return node.membership.dns_addrs()
