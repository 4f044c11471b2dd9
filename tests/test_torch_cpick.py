"""The classify+pick batch of the port's unfused backends ("torch-fp",
"torch-dense", "torch-sharded", "torch-fp-sharded"): ONE launch of the
backend's hint kernel with its Maglev column (B6, B9 or B8, B5's take
folded in; engine.HintMatcher.dispatch_pick_snap), held to the
reference's FusedPair.dispatch_snap and classify_and_pick on the
matching backend ("jax-fp", "jax-dense", "jax-sharded",
"jax-fp-sharded"), which answers with its two-dispatch chain on the JAX
CPU backend.

On the CPU the one launch is each kernel's plain version
(fphash_cuda.hint_fp_pick_plain, matchers.hint_dense_pick_plain,
sharded_cuda.hint_pick_plain). The same seeded inputs go through both
packages and every (verdict, pick) pair is compared int32-exact: pad
rows (a batch padded past its rows), every third flow without a port
(source affinity), IPv4 and IPv6 flows mixed, and flow slots pushed
past both ends of the Maglev table (maglev.flow_slots replaced in both
packages: the port's kernel entry clamps, the reference's
jnp.take(mode="clip") clamps). Counts: the port's batch is one engine
launch and no `_device_take` call; the reference's is two launches (a
counter, not an answer, that differs: ROADMAP Queue C).
"""
import numpy as np
import pytest
import torch

from test_torch_dns import mod
from vproxy_tpu_torch.utils.torchenv import to_host

torch.set_num_threads(1)

BACKENDS = {"torch-fp": "jax-fp", "torch-dense": "jax-dense",
            "torch-sharded": "jax-sharded",
            "torch-fp-sharded": "jax-fp-sharded"}
N_RULES, BATCH, PAD_TO, M = 240, 45, 64, 251


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
    """The port's matchers on the CPU, installs unpaced."""
    monkeypatch.setenv("VPROXY_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("VPROXY_TPU_INSTALL_PACE", "0")


class Pkg:
    """One package's engine, Maglev and IR modules."""

    def __init__(self, pkg: str):
        self.ir = mod(pkg, "rules.ir")
        self.engine = mod(pkg, "rules.engine")
        self.maglev = mod(pkg, "rules.maglev")
        self.mesh = mod(pkg, "parallel.mesh")


REF, PORT = Pkg("vproxy_tpu"), Pkg("vproxy_tpu_torch")


def rule_specs(n: int, seed: int = 5) -> list:
    """(host, uri, port) of n hint rules, seeded: exact hosts, hosts with
    a uri prefix, port-gated hosts, uri-only rules and wildcard hosts."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(10))
        host = f"svc{i}.ns{i % 31}.example.com"
        if k < 5:
            out.append((host, None, 0))
        elif k < 7:
            out.append((host, f"/api/v{i % 7}", 0))
        elif k < 8:
            out.append((host, None, 443))
        elif k < 9:
            out.append((None, f"/static/{i}", 0))
        else:
            out.append(("*", f"/w{i % 5}", 0))
    return out


def flows(n: int, seed: int = 9) -> tuple:
    """n (hint spec, ip, port) flows, seeded: hints that reach the rules
    (host, host + uri, host + port, uri) and misses; IPv4 and IPv6
    addresses mixed; every third port None (source affinity)."""
    rng = np.random.default_rng(seed)
    specs = rule_specs(N_RULES)
    hints, ips, ports = [], [], []
    for i in range(n):
        host, uri, _ = specs[int(rng.integers(len(specs)))]
        host = host if host not in (None, "*") else f"nohost{i}.example.com"
        k = i % 5
        hints.append({0: (host, None, 0), 1: ("x." + host, "/api/v3/u", 0),
                      2: (host, None, 443), 3: (None, f"/static/{i}", 0),
                      4: (f"miss{i}.io", "/nothing", 0)}[k])
        ips.append(bytes(rng.integers(0, 256, 16 if i % 2 else 4,
                                      dtype=np.uint8)))
        ports.append(None if i % 3 == 0 else int(rng.integers(1, 65536)))
    return hints, ips, ports


def world(P, backend: str):
    """P's FusedPair over the hint rules on `backend` (the sharded ones
    on make_mesh(8, batch=2): four rule shards) and a Maglev table of M
    slots over 7 weighted backends."""
    rules = [P.ir.HintRule(host=h, uri=u, port=p)
             for h, u, p in rule_specs(N_RULES)]
    kw = {}
    if "sharded" in backend:
        kw["mesh"] = P.mesh.make_mesh(8, batch=2) if P is REF else \
            P.mesh.make_mesh(8, batch=2, device="cpu")
    hm = P.engine.HintMatcher(rules, backend=backend, payload="hp", **kw)
    mm = P.maglev.MaglevMatcher(
        [(f"10.9.{i}.1:80", 1 + i % 4) for i in range(7)], m=M,
        payload="mp")
    return P.maglev.FusedPair(hm, mm)


_WORLDS = {}


@pytest.fixture(params=sorted(BACKENDS), ids=lambda b: b)
def pairs(request):
    """(port pair, reference pair) on one backend, built once a
    module."""
    be = request.param
    if be not in _WORLDS:
        _WORLDS[be] = (world(PORT, be), world(REF, BACKENDS[be]))
    return _WORLDS[be]


def past_the_ends(real_flow_slots):
    """A flow_slots that pushes every fourth slot below 0 and every
    fourth past M - 1 (by multiples of M, so a clamp is the only way
    back into the table)."""
    def slots(m, ips, ports=None):
        s = real_flow_slots(m, ips, ports).copy()
        s[0::4] -= m * (1 + np.arange(len(s[0::4])))
        s[2::4] += m * (1 + np.arange(len(s[2::4])))
        return s
    return slots


@pytest.mark.parametrize("clip", [False, True], ids=["slots", "clip"])
@pytest.mark.parametrize("entry", ["fused_pair", "classify_and_pick"])
def test_cpick_matches_reference(pairs, entry, clip, monkeypatch):
    """The port's one-launch classify+pick batch == the reference's
    (verdict, pick) pairs, int32-exact, through FusedPair.dispatch_snap
    (padded to PAD_TO rows: the pad rows are sliced off) and through
    classify_and_pick; one engine launch a batch (the reference: two)
    and no `_device_take` call in the port."""
    pair, ref = pairs
    if clip:
        for P in (REF, PORT):
            monkeypatch.setattr(P.maglev, "flow_slots",
                                past_the_ends(P.maglev.flow_slots))
    specs, ips, ports = flows(BATCH)
    hints = {P: [P.ir.Hint(host=h, uri=u, port=p) for h, u, p in specs]
             for P in (REF, PORT)}
    E, RE = PORT.engine, REF.engine
    l0, r0 = E.dispatch_launches_total(), RE.dispatch_launches_total()
    t0 = PORT.maglev._device_take.calls
    if entry == "fused_pair":
        got = to_host(pair.dispatch_snap(
            pair.snapshot(), list(zip(hints[PORT], ips, ports)),
            pad_to=PAD_TO))[:BATCH]
        want = np.asarray(ref.dispatch_snap(
            ref.snapshot(), list(zip(hints[REF], ips, ports)),
            pad_to=PAD_TO))[:BATCH]
    else:
        v, p, hp, mp = PORT.maglev.classify_and_pick(
            pair.hm, pair.mm, hints[PORT], ips, ports)
        rv, rp, rhp, rmp = REF.maglev.classify_and_pick(
            ref.hm, ref.mm, hints[REF], ips, ports)
        assert (hp, mp) == (rhp, rmp) == ("hp", "mp")
        got, want = np.stack([v, p], 1), np.stack([rv, rp], 1)
    assert got.dtype == np.int32 and got.shape == (BATCH, 2)
    assert np.array_equal(got, np.asarray(want, np.int32))
    assert (got[:, 0] >= 0).sum() > BATCH // 3  # the batch reaches rules
    assert E.dispatch_launches_total() - l0 == 1
    assert RE.dispatch_launches_total() - r0 == 2
    assert PORT.maglev._device_take.calls == t0
    if clip:  # the clamp decided some picks: both ends of the table
        tab = pair.mm.snapshot()[0]
        assert np.array_equal(got[0::4, 1], np.full(len(got[0::4]),
                                                    tab[0]))
        assert np.array_equal(got[2::4, 1], np.full(len(got[2::4]),
                                                    tab[M - 1]))


def test_host_backend_keeps_the_two_dispatch_chain():
    """The "host" backend has no kernel: its classify+pick batch stays
    the chain (the host oracle, then the Maglev dispatch), as the
    reference's does."""
    rules = [PORT.ir.HintRule(host=h, uri=u, port=p)
             for h, u, p in rule_specs(40)]
    hm = PORT.engine.HintMatcher(rules, backend="host")
    mm = PORT.maglev.MaglevMatcher([("a:1", 1), ("b:2", 2)], m=M)
    pair = PORT.maglev.FusedPair(hm, mm)
    specs, ips, ports = flows(12)
    hints = [PORT.ir.Hint(host=h, uri=u, port=p) for h, u, p in specs]
    assert hm.dispatch_pick_snap(hm.snapshot(), mm.snapshot(), hints, ips,
                                 ports) is None
    t0 = PORT.maglev._device_take.calls
    rows = np.asarray(pair.dispatch_snap(pair.snapshot(),
                                         list(zip(hints, ips, ports))))
    assert rows[:, 0].tolist() == [hm.oracle_one(h) for h in hints]
    assert rows[:, 1].tolist() == [PORT.maglev.pick(mm.snapshot()[0], ip, p)
                                   for ip, p in zip(ips, ports)]
    assert PORT.maglev._device_take.calls == t0 + 1
