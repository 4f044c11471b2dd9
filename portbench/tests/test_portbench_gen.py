"""The generators: the same seed gives the same tables and streams,
another seed other ones of the same sizes; the frozen copies still draw
what chip_smoke.py's originals draw; the routes are ordered as
RouteTable.addRule keeps them; a run's seed orders the same pool."""
from __future__ import annotations

import sys

import pytest

from portbench import gen, run, spec
from portbench.reference.cidr import CidrReference


def _all(seed: int) -> dict:
    rules = gen.mk_rules(2000, seed)
    nets = gen.route_nets(2000, seed)
    acl = gen.acl_rules(200, seed + 1)
    aimed = gen.family_queries(nets, 500, seed, 0.7, 0.2, 0.1, 8)
    return {"rules": rules, "hints": gen.mk_queries(rules, 500, seed, 1.1),
            "ips": gen.mk_ips(500, seed), "ports": gen.flow_ports(500, seed, 3),
            "nets": nets, "acl": acl, "aimed": aimed,
            "acl_ports": gen.acl_ports(acl, gen.family_queries(
                [r[1] for r in acl], 500, seed, 1, 0, 0, 8), seed)}


def test_deterministic_per_seed():
    a, b, c = _all(2 ** 31 + 5), _all(2 ** 31 + 5), _all(2 ** 31 + 6)
    assert a == b
    assert all(len(a[k]) == len(c[k]) for k in a)
    assert a["hints"] != c["hints"] and a["nets"] != c["nets"]


def test_family_mix():
    nets = gen.route_nets(2000, 3)
    aimed = gen.family_queries(nets, 8000, 4, 0.7, 0.2, 0.1, 8)
    v4 = sum(len(a) == 4 for a, _ in aimed) / len(aimed)
    mapped = sum(a[:12] == bytes(10) + b"\xff\xff" for a, _ in aimed) \
        / len(aimed)
    assert 0.6 < v4 < 0.72 and 0.06 < mapped < 0.12
    only4 = gen.family_queries(nets, 2000, 4, 1, 0, 0, 8)
    assert all(len(a) == 4 for a, _ in only4)
    rr = CidrReference(nets)
    assert all(rr.holds(a)[j] for a, j in aimed[:500] if j >= 0)


def test_routes_more_specific_first():
    """No route lies behind one that contains it, so the first route that
    holds an address is its longest prefix; the mix is route_nets'."""
    nets = gen.route_nets(3000, 41)
    assert len(set(nets)) == 3000
    rr = CidrReference(nets)
    for net in nets:
        assert gen._effective_len(nets[rr.first(net[0])]) >= \
            gen._effective_len(net)
    v6 = sum(len(a) == 16 and a[:10] != bytes(10) for a, _m in nets)
    mapped = sum(a[:10] == bytes(10) and len(a) == 16 for a, _m in nets)
    assert 0.035 < v6 / 3000 < 0.065 and 0.003 < mapped / 3000 < 0.02
    aimed = gen.family_queries(nets, 2000, 5, 0.7, 0.2, 0.1, 8)
    lens = [gen._effective_len(n) for n in nets]
    for a, _ in aimed:
        held = rr.holds(a).nonzero()[0]
        if len(held):
            assert lens[rr.first(a)] == max(lens[k] for k in held)


def test_a_runs_seed_orders_the_same_pool():
    import numpy as np
    pool = gen.mk_queries(gen.mk_rules(500, 1), 800, 2, 1.1)
    a = run.ordered(pool, np.random.default_rng(2 ** 31 + 9))
    b = run.ordered(pool, np.random.default_rng(2 ** 31 + 9))
    c = run.ordered(pool, np.random.default_rng(2 ** 33 + 10))
    assert a == b and a != c and sorted(a, key=str) == sorted(c, key=str)


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, spec.ROOT)
    import chip_smoke
    return chip_smoke


def test_frozen_copies_match_chip_smoke(smoke, monkeypatch):
    monkeypatch.setenv("VPROXY_TPU_TORCH_DEVICE", "cpu")
    rules = smoke.mk_rules(3000, seed=11)
    assert [(r.host, r.port, r.uri) for r in rules] == gen.mk_rules(3000, 11)
    hints = smoke.mk_queries(rules, 400, seed=7)
    assert [(h.host, h.port, h.uri) for h in hints] == \
        gen.mk_queries(gen.mk_rules(3000, 11), 400, 7)
    assert smoke.mk_ips(300, 5) == gen.mk_ips(300, 5)
    assert [(f"10.{i // 250}.{i % 250}.1:80", 1 + i % 4)
            for i in range(256)] == smoke.backends() == gen.backends(256)
    acl = smoke.acl_rules(300, 42)
    assert [(r.alias, (r.network.ip, r.network.mask), r.min_port, r.max_port,
             r.allow) for r in acl] == gen.acl_rules(300, 42)

