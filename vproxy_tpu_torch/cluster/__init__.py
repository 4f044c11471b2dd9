"""The cluster plane's names that the DNS server reads.

The reference's vproxy_tpu/cluster (membership, replication, the step
loop, ClusterNode) is not ported yet: it comes with ROADMAP Queue A
item 8, with torch.distributed in place of jax.distributed. Until then
no cluster node can boot in the port (main.py refuses
VPROXY_TPU_CLUSTER_PEERS), and this module holds only what
dns/server.py's `<name>.vproxy.local` arm reads:

* cluster_service_name(): the sub-domain that answers the fleet, the
  reference's knob and default;
* dns_peer_addrs(): always None, the reference's answer when no node
  is booted, so the DNS server falls through to its other arms.
"""
from __future__ import annotations

import os
from typing import Optional


def cluster_service_name() -> str:
    """Sub-domain left of `.vproxy.local` that answers the healthy peer
    set (DNS-as-LB across the fleet)."""
    return os.environ.get("VPROXY_TPU_CLUSTER_SERVICE", "cluster")


def dns_peer_addrs(client_ip: Optional[bytes] = None) -> Optional[list]:
    """Healthy peer addresses for the cluster service name, or None when
    no cluster is booted: always None in the port."""
    return None
