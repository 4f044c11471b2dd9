"""Sharded-vs-oracle parity at scale for the torch port: the non-slow
cases of tests/test_sharded_scale.py on "torch-sharded" and
"torch-fp-sharded" (make_mesh(8): batch 1, rules 8, the reference's
default mesh on its 8-device virtual CPU mesh), matchers on the CPU.

Randomized 100k-rule hint tables and 100k / 20k cidr tables: every
answer equal to the oracle's winner (oracle_one), the 100k stacked hint
arrays equal to the reference's compile byte for byte, and a
caps-reusing install at 100k serving the new rules after exactly one
generation bump.
"""
import random

import numpy as np
import pytest
import torch

from vproxy_tpu.ops import hashmatch as RH
from vproxy_tpu.rules import ir as RIR
from vproxy_tpu_torch.ops import hashmatch as H
from vproxy_tpu_torch.parallel.mesh import make_mesh
from vproxy_tpu_torch.rules import oracle
from vproxy_tpu_torch.rules.engine import CidrMatcher, HintMatcher
from vproxy_tpu_torch.rules.ir import AclRule, Hint, HintRule, Proto
from vproxy_tpu_torch.utils.ip import Network, mask_bytes

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
    monkeypatch.setenv("VPROXY_TPU_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, device="cpu")


def mk_hint_rules(n, seed=11, ir=None):
    HR = HintRule if ir is None else ir.HintRule
    rnd = random.Random(seed)
    out = []
    for i in range(n):
        r = rnd.randrange(20)
        if r < 12:
            out.append(HR(host=f"svc{i}.ns{i % 997}.example.com"))
        elif r < 15:
            out.append(HR(host=f"svc{i}.ns{i % 997}.example.com",
                          uri=f"/api/v{i % 17}"))
        elif r < 17:
            out.append(HR(host=f"svc{i}.ns{i % 997}.example.com", port=443))
        elif r < 19:
            out.append(HR(uri=f"/static/{i}"))
        else:
            out.append(HR(host="*", uri=f"/w{i % 5}"))
    return out


def mk_hint_queries(rules, b, seed=7):
    rnd = random.Random(seed)
    hints = []
    for i in range(b):
        j = rnd.randrange(len(rules))
        host = rules[j].host
        if host is None or host == "*":
            host = f"nohost{j}.ns.example.com"
        k = i % 4
        if k == 0:
            hints.append(Hint.of_host(host))
        elif k == 1:
            hints.append(Hint.of_host_uri("x." + host, f"/api/v{j % 17}/s"))
        elif k == 2:
            hints.append(Hint.of_host_port(host, 443 if i % 2 else 8443))
        else:
            hints.append(Hint(uri=f"/static/{j}"))
    return hints


def mk_nets(n, seed=13):
    rnd = random.Random(seed)
    nets = []
    for i in range(n):
        ml = rnd.choice([8, 12, 16, 20, 24, 28, 32])
        ip = bytes([10 + (i % 13), rnd.randrange(256), rnd.randrange(256),
                    rnd.randrange(256)])
        mk = mask_bytes(ml)
        nets.append(Network(bytes(np.frombuffer(ip, np.uint8) &
                                  np.frombuffer(mk, np.uint8)), mk))
    return nets


def _addrs(n, seed=5):
    rnd = random.Random(seed)
    return [bytes([10 + rnd.randrange(14), rnd.randrange(256),
                   rnd.randrange(256), rnd.randrange(256)])
            for _ in range(n)]


@pytest.mark.timeout(600)
@pytest.mark.parametrize("backend", ["torch-sharded", "torch-fp-sharded"])
def test_hint_100k_sharded_parity(backend, mesh):
    rules = mk_hint_rules(100_000)
    m = HintMatcher(rules, backend=backend, mesh=mesh)
    hints = mk_hint_queries(rules, 96)
    got = m.match(hints)
    for i, h in enumerate(hints):
        assert got[i] == m.oracle_one(h), (backend, i, h)
    if backend == "torch-sharded":
        # the stacked arrays of the 100k compile, byte for byte
        ref = RH.compile_hint_hash_sharded(
            mk_hint_rules(100_000, ir=RIR), 8)
        mine = H.compile_hint_hash_sharded(rules, 8)
        assert ref.arrays.keys() == mine.arrays.keys()
        for k in ref.arrays:
            assert ref.arrays[k].dtype == mine.arrays[k].dtype, k
            assert ref.arrays[k].tobytes() == mine.arrays[k].tobytes(), k
        assert (ref.shard_size, ref.r_cap, ref.lset_u) == \
            (mine.shard_size, mine.r_cap, mine.lset_u)
        assert m._caps == ref.shards[0].caps


@pytest.mark.timeout(600)
def test_cidr_100k_sharded_parity_routes_and_acl(mesh):
    nets = mk_nets(100_000)
    rm = CidrMatcher(nets, backend="torch-sharded", mesh=mesh)
    addrs = _addrs(64)
    got = rm.match(addrs)
    for i, a in enumerate(addrs):
        assert got[i] == rm.oracle_one(a), (i, a.hex())
    acl_nets = mk_nets(20_000, seed=17)
    acls = [AclRule(f"r{i}", acl_nets[i], Proto.TCP, (i * 7) % 60000,
                    (i * 7) % 60000 + 1500, i % 2 == 0)
            for i in range(len(acl_nets))]
    am = CidrMatcher(acl_nets, acl=acls, backend="torch-sharded", mesh=mesh)
    ports = [random.Random(3).randint(1, 65535) for _ in addrs]
    got = am.match(addrs, ports)
    for i, a in enumerate(addrs):
        assert got[i] == am.oracle_one(a, ports[i]), (i, a.hex(), ports[i])


@pytest.mark.timeout(600)
def test_generation_install_at_100k_keeps_parity(monkeypatch, mesh):
    """A caps-reusing install at scale: the swap serves the NEW rules and
    bumps the generation exactly once."""
    monkeypatch.setenv("VPROXY_TPU_INSTALL_PACE", "0")
    rules = mk_hint_rules(100_000)
    m = HintMatcher(rules, backend="torch-sharded", mesh=mesh)
    g0, caps0 = m.generation, dict(m._caps)
    rules2 = [HintRule(host="flip.gen.example.net")] + rules[1:]
    m.set_rules(rules2)
    assert m.generation == g0 + 1 and m._caps == caps0
    assert int(m.match([Hint.of_host("flip.gen.example.net")])[0]) == 0
    hints = mk_hint_queries(rules2, 48, seed=23)
    got = m.match(hints)
    for i, h in enumerate(hints):
        assert got[i] == oracle.search(rules2, h), (i, h)
