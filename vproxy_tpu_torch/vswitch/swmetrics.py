"""Labeled switch data-plane counters.

The port of `vproxy_tpu/vswitch/swmetrics.py`, same names and behaviour.

The switch consumes frames at six distinct points (ACL deny, unknown
VNI, route miss, same-iface suppression, egress backpressure) with —
until now — zero accounting, which is how a 68% drop rate stays a
mystery. Every consumed frame increments
`vproxy_switch_drops_total{reason=...}`; frames demoted from the
vectorized fast path to the object pipeline increment
`vproxy_switch_slowpath_total{reason=...}` (not drops — they are still
forwarded); egressed datagrams land in
`vproxy_switch_forwards_total{path=fast|slow}` and drained ones in
`vproxy_switch_rx_total`, so drop RATE is computable from /metrics
alone.

Counters are process-global (utils/metrics GlobalInspection) with a
module-local memo so the hot path pays one dict hit, no lock.
"""
from __future__ import annotations

from ..utils.metrics import Counter, GlobalInspection

_memo: dict = {}


def _ctr(name: str, **labels) -> Counter:
    key = (name, tuple(sorted(labels.items())))
    c = _memo.get(key)
    if c is None:
        c = _memo[key] = GlobalInspection.get().get_counter(name, **labels)
    return c


def drop(reason: str, n: int = 1) -> None:
    if n > 0:
        _ctr("vproxy_switch_drops_total", reason=reason).incr(n)


def slowpath(reason: str, n: int = 1) -> None:
    if n > 0:
        _ctr("vproxy_switch_slowpath_total", reason=reason).incr(n)


def forward(path: str, n: int = 1) -> None:
    if n > 0:
        _ctr("vproxy_switch_forwards_total", path=path).incr(n)


def rx(n: int) -> None:
    if n > 0:
        _ctr("vproxy_switch_rx_total").incr(n)


# Pre-register the full reason/path vocabularies at import (the PR-9
# silent-drops rule, enforced by tools/vlint's registry audit): a
# scrape of a freshly-booted switch must show the ZEROS, so dashboards
# can tell "no drops" from "drop counter not wired". Adding a new
# reason literal at a call site without extending these tuples is a
# vlint finding by construction — the audit's eager set is what a
# fresh import of this module registers.
DROP_REASONS = ("acl_deny", "arp_unresolved", "egress_short_write",
                "route_miss", "same_iface", "unknown_vni")
SLOWPATH_REASONS = ("bad_csum",)
FORWARD_PATHS = ("fast", "slow")
for _r in DROP_REASONS:
    _ctr("vproxy_switch_drops_total", reason=_r)
for _r in SLOWPATH_REASONS:
    _ctr("vproxy_switch_slowpath_total", reason=_r)
for _p in FORWARD_PATHS:
    _ctr("vproxy_switch_forwards_total", path=_p)
_ctr("vproxy_switch_rx_total")
