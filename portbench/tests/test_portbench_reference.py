"""The plain reference against the program's CPU tier on small tables
(2k hint rules, 2k routes, 200 ACL rules), and its controls: each breaks
its stated guarantee on a share of the same queries."""
from __future__ import annotations

import pytest

from portbench import gen
from portbench.reference.cidr import CidrReference
from portbench.reference.hint import HintReference
from portbench.reference.maglev import MaglevReference

SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("VPROXY_TPU_TORCH_DEVICE", "cpu")


def test_hint_and_maglev_agree_with_the_cpu_tier():
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules import maglev as M
    from vproxy_tpu_torch.rules.ir import Hint, HintRule
    rules = gen.mk_rules(2000, SEED)
    qs = gen.mk_queries(rules, 1500, SEED, 1.1)
    hm = E.HintMatcher([HintRule(*r) for r in rules], backend="torch",
                       device="cpu")
    got = hm.match([Hint(host=h, port=p, uri=u) for h, p, u in qs]).tolist()
    ref = HintReference(rules)
    assert got == [ref.verdict(q) for q in qs]
    assert sum(ref.verdict(q, ties_last=True) != g
               for q, g in zip(qs, got)) > len(qs) // 20
    be = gen.backends(32)
    mm = M.MaglevMatcher(be, m=4099, device="cpu")
    mr = MaglevReference(be, 4099)
    ips, ports = gen.mk_ips(1500, SEED), gen.flow_ports(1500, SEED, 3)
    want = [M.pick(mm.snapshot()[0], ip, p) for ip, p in zip(ips, ports)]
    assert want == [mr.pick(ip, p) for ip, p in zip(ips, ports)]
    assert sum(mr.pick(ip, p, affinity_only=True) != w
               for ip, p, w in zip(ips, ports, want)) > len(ips) // 2


def test_routes_and_acl_agree_with_the_cpu_tier():
    from vproxy_tpu_torch.components.secgroup import SecurityGroup
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules.ir import AclRule, Proto
    from vproxy_tpu_torch.utils.ip import Network
    nets = gen.route_nets(2000, SEED)
    addrs = [a for a, _ in gen.family_queries(nets, 1500, SEED, 0.7, 0.2,
                                              0.1, 8)]
    cm = E.CidrMatcher([Network(*n) for n in nets], backend="torch",
                       device="cpu")
    got = cm.match(addrs).tolist()
    rr = CidrReference(nets)
    assert got == [rr.first(a) for a in addrs]
    assert sum(rr.first(a, last=True) != g for a, g in zip(addrs, got)) \
        > len(addrs) // 2
    acl = gen.acl_rules(200, SEED)
    aimed = gen.family_queries([r[1] for r in acl], 1500, SEED, 0.7, 0.2,
                               0.1, 8)
    ports = gen.acl_ports(acl, aimed, SEED)
    sg = SecurityGroup("t", default_allow=False, backend="torch")
    sg.extend_rules([AclRule(a, Network(*n), Proto.TCP, lo, hi, ok)
                     for a, n, lo, hi, ok in acl])
    got = sg.allow_batch(Proto.TCP, [a for a, _ in aimed], ports)
    ar = CidrReference([r[1] for r in acl], [(r[2], r[3]) for r in acl])

    def allow(a, p, last=False):
        i = ar.first(a, p, last=last)
        return acl[i][4] if i >= 0 else False
    assert got == [allow(a, p) for (a, _), p in zip(aimed, ports)]
    assert any(allow(a, p, True) != g
               for (a, _), p, g in zip(aimed, ports, got))
