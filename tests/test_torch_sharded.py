"""The sharded backends of the torch port ("torch-sharded",
"torch-fp-sharded") held to the reference's "jax-sharded" and
"jax-fp-sharded".

The reference runs on its 8-device virtual CPU mesh (tests/conftest.py),
make_mesh(8, batch=2): batch 2, rules 4; the port on make_mesh(8,
batch=2) with VPROXY_TPU_TORCH_DEVICE=cpu: four rule shards stacked on
the CPU, answered by B8's plain version (ops/sharded_cuda.py). They
agree, int32-exact, on the stacked compiled arrays (byte for byte),
every answer (which is also the linear oracle's), checksum(), the caps
reuse of an update and the rebuild of one that outgrows the caps.

Ports of tests/test_engine_sharded.py (11), tests/test_mesh_hash.py (3)
and the simulated (host, batch, rules) cases of tests/test_multihost.py
(2); the brute-force case at S = 1..4 (ties across shards, shards that
answer at level 0, a rule count no S divides); and chip_smoke.py's
sharded phases at a small size. The 100k cases of
tests/test_sharded_scale.py are tests/test_torch_sharded_scale.py.
"""
import random
import threading

import numpy as np
import pytest
import torch

import chip_smoke as CS
from test_torch_dns import mod

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
    """The port's matchers on the CPU, installs unpaced."""
    monkeypatch.setenv("VPROXY_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("VPROXY_TPU_INSTALL_PACE", "0")


class Pkg:
    """One package's names: ir, ip, engine, oracle, mesh, service, the
    sharded backend names."""

    def __init__(self, pkg: str):
        self.ir = mod(pkg, "rules.ir")
        self.ip = mod(pkg, "utils.ip")
        self.engine = mod(pkg, "rules.engine")
        self.oracle = mod(pkg, "rules.oracle")
        self.mesh = mod(pkg, "parallel.mesh")
        self.service = mod(pkg, "rules.service")
        self.H = mod(pkg, "ops.hashmatch")
        self.FP = mod(pkg, "ops.fphash")
        port = pkg.endswith("_torch")
        self.sharded = "torch-sharded" if port else "jax-sharded"
        self.fp_sharded = "torch-fp-sharded" if port else "jax-fp-sharded"
        self.port = port

    def backend(self, fp: bool) -> str:
        return self.fp_sharded if fp else self.sharded


REF, PORT = Pkg("vproxy_tpu"), Pkg("vproxy_tpu_torch")


def answers(x) -> list:
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return [int(v) for v in np.asarray(x)]


@pytest.fixture(scope="module")
def meshes():
    """(reference mesh, port mesh): make_mesh(8, batch=2) in each."""
    return REF.mesh.make_mesh(8, batch=2), PORT.mesh.make_mesh(
        8, batch=2, device="cpu")


def both(fn):
    """fn(pkg, mesh) for the reference and the port."""
    def run(meshes):
        return fn(REF, meshes[0]), fn(PORT, meshes[1])
    return run


# ------------------------------------------ test_engine_sharded.py's rules

def mk_rules(P, n):
    out = []
    for i in range(n):
        r = i % 10
        if r < 6:
            out.append(P.ir.HintRule(host=f"svc{i}.ns{i % 37}.example.com"))
        elif r < 8:
            out.append(P.ir.HintRule(host=f"svc{i}.ns{i % 37}.example.com",
                                     uri=f"/api/v{i % 9}"))
        elif r < 9:
            out.append(P.ir.HintRule(host=f"svc{i}.ns{i % 37}.example.com",
                                     port=443))
        else:
            out.append(P.ir.HintRule(uri=f"/static/{i}"))
    return out


def mk_queries(P, rules, b, seed=3):
    rnd = np.random.RandomState(seed)
    hints = []
    for i in range(b):
        j = int(rnd.randint(0, len(rules)))
        host = rules[j].host or f"nohost{j}.example.com"
        if i % 3 == 0:
            hints.append(P.ir.Hint.of_host(host))
        elif i % 3 == 1:
            hints.append(P.ir.Hint.of_host_uri("x." + host,
                                               f"/api/v{j % 9}/u"))
        else:
            hints.append(P.ir.Hint.of_host_port(host, 443))
    return hints


def _hint_world(P, mesh, fp, n=300, b=96):
    rules = mk_rules(P, n)
    m = P.engine.HintMatcher(rules, backend=P.backend(fp), mesh=mesh)
    hints = mk_queries(P, rules, b)
    got = answers(m.match(hints))
    want = [P.oracle.search(rules, h) for h in hints]
    return got, want, m


@pytest.mark.parametrize("fp", [False, True], ids=["cuckoo", "fp"])
def test_hint_matcher_sharded_parity_with_oracle(meshes, fp):
    """test_hint_matcher_sharded_parity_with_oracle and
    test_hint_matcher_fp_sharded_parity: 300 rules, 96 queries, every
    answer the oracle's in both packages; caps, published bytes and
    checksum equal."""
    (rg, rw, rm), (pg, pw, pm) = both(
        lambda P, mesh: _hint_world(P, mesh, fp))(meshes)
    assert rg == rw and pg == pw and rg == pg
    assert pm.backend == PORT.backend(fp)
    assert pm._caps == rm._caps
    assert pm.published_table_bytes() == rm.published_table_bytes()
    assert pm.checksum() == rm.checksum()


def _update_caps(P, mesh):
    rules = mk_rules(P, 200)
    m = P.engine.HintMatcher(rules, backend=P.sharded, mesh=mesh)
    caps0 = dict(m._caps)
    rules2 = [P.ir.HintRule(host="updated.example.org")] + rules[1:]
    m.set_rules(rules2)
    qs = mk_queries(P, rules2, 32)
    return (m._caps == caps0, int(m.match(
        [P.ir.Hint.of_host("updated.example.org")])[0]), answers(
        m.match(qs)), [P.oracle.search(rules2, h) for h in qs], m._caps,
        m.checksum())


def test_hint_matcher_sharded_update_caps_reuse(meshes):
    ref, port = both(_update_caps)(meshes)
    assert ref[:2] == port[:2] == (True, 0)
    assert ref[2] == ref[3] == port[2] == port[3]
    assert ref[4] == port[4] and ref[5] == port[5]


def _caps_exceeded(P, mesh):
    m = P.engine.HintMatcher(mk_rules(P, 64), backend=P.sharded, mesh=mesh)
    caps0 = dict(m._caps)
    big = mk_rules(P, 1500)
    m.set_rules(big)  # outgrows the caps: a transparent rebuild
    hints = mk_queries(P, big, 64)
    return (m._caps != caps0, answers(m.match(hints)),
            [P.oracle.search(big, h) for h in hints], m._caps)


def test_hint_matcher_sharded_caps_exceeded_rebuilds(meshes):
    ref, port = both(_caps_exceeded)(meshes)
    assert ref[0] and port[0]
    assert ref[1] == ref[2] == port[1] == port[2]
    assert ref[3] == port[3]


def v4net(P, i, ml, third=None):
    ip = np.array([10, (i >> 8) & 0xFF, i & 0xFF,
                   (i * 37) & 0xFF if third is None else third], np.uint8)
    mk = np.frombuffer(P.ip.mask_bytes(ml), np.uint8)
    return P.ip.Network(bytes(ip & mk), bytes(mk))


def _routes_and_acl(P, mesh):
    routes = [v4net(P, i, 8 + (i % 17)) for i in range(257)]
    rm = P.engine.CidrMatcher(routes, backend=P.sharded, mesh=mesh)
    rnd = np.random.RandomState(5)
    addrs = [bytes([10, int(rnd.randint(0, 4)), int(rnd.randint(0, 256)),
                    int(rnd.randint(0, 256))]) for _ in range(64)]
    out = [answers(rm.match(addrs)), [rm.oracle_one(a) for a in addrs]]
    acls = [P.ir.AclRule(f"r{i}", v4net(P, i * 3, 8 + (i % 25)),
                         P.ir.Proto.TCP, (i * 7) % 60000,
                         (i * 7) % 60000 + 1000, i % 2 == 0)
            for i in range(120)]
    am = P.engine.CidrMatcher([a.network for a in acls], acl=acls,
                              backend=P.sharded, mesh=mesh)
    ports = [int(p) for p in rnd.randint(1, 65535, 64)]
    out += [answers(am.match(addrs, ports)),
            [am.oracle_one(a, ports[i]) for i, a in enumerate(addrs)],
            answers(am.match(addrs)), [am.oracle_one(a) for a in addrs],
            rm.checksum(), am.checksum(), rm.published_table_bytes(),
            am.published_table_bytes()]
    return out


def test_cidr_matcher_sharded_routes_and_acl(meshes):
    ref, port = both(_routes_and_acl)(meshes)
    for k in (0, 2, 4):  # routes, ACL with ports, ACL port=None
        assert ref[k] == ref[k + 1] == port[k] == port[k + 1], k
    assert ref[6:] == port[6:]


def _cidr_update(P, mesh):
    def net(i, ml=24):
        ip = bytes([10, 0, i & 0xFF, 0])
        mk = P.ip.mask_bytes(ml)
        return P.ip.Network(bytes(np.frombuffer(ip, np.uint8) &
                                  np.frombuffer(mk, np.uint8)), mk)

    rm = P.engine.CidrMatcher([net(i) for i in range(40)],
                              backend=P.sharded, mesh=mesh)
    a = int(rm.match([bytes([10, 0, 7, 9])])[0])
    caps0 = dict(rm._caps)
    rm.set_networks([net(i) for i in range(900)])  # past the caps
    return a, int(rm.match([bytes([10, 0, 200, 9])])[0]), \
        rm._caps != caps0, rm._caps


def test_cidr_matcher_sharded_update_and_rebuild(meshes):
    ref, port = both(_cidr_update)(meshes)
    assert ref == port and ref[:3] == (7, 200, True)


def _service_run(P, mesh, fp, n_rules, n, seed):
    P.service.ClassifyService.reset()
    svc = P.service.ClassifyService.get()
    svc.mode = "device"
    try:
        rules = mk_rules(P, n_rules)
        m = P.engine.HintMatcher(rules, backend=P.backend(fp), mesh=mesh)
        m.match(mk_queries(P, rules, 16))
        results, done, lock = {}, threading.Event(), threading.Lock()
        hints = mk_queries(P, rules, n, seed=seed)

        def cb(i, idx):
            with lock:
                results[i] = idx
                if len(results) == n:
                    done.set()

        for i, h in enumerate(hints):
            svc.submit_hint(m, h, lambda idx, _pl, i=i: cb(i, idx))
        assert done.wait(60)
        return ([results[i] for i in range(n)],
                [P.oracle.search(rules, h) for h in hints],
                svc.stats.device_queries, svc.stats.dispatches)
    finally:
        P.service.ClassifyService.reset()


@pytest.mark.parametrize("fp", [False, True], ids=["cuckoo", "fp"])
def test_classify_service_drives_sharded_engine(meshes, fp):
    """test_classify_service_drives_sharded_engine (300 rules, 120
    queries) and test_classify_service_drives_fp_sharded (250 rules, 60
    queries): the service's device path micro-batches onto the sharded
    matcher; every answer the oracle's, in both packages."""
    n_rules, n, seed = (250, 60, 5) if fp else (300, 120, 11)
    ref, port = both(lambda P, mesh: _service_run(P, mesh, fp, n_rules, n,
                                                  seed))(meshes)
    assert ref[0] == ref[1] == port[0] == port[1]
    if not fp:
        assert port[2] >= n - 1 and port[3] < n / 2  # micro-batched


def test_e2e_tcplb_sockets_over_sharded_backend():
    """TcpLB accept -> Hint classify -> backend pick with the Upstream's
    HintMatcher on "torch-sharded" (the default mesh), lookups riding
    the ClassifyService device queue over real sockets."""
    from test_torch_tcplb import IdServer, fast_hc, http_get_id, \
        wait_healthy
    from vproxy_tpu_torch.components.elgroup import EventLoopGroup
    from vproxy_tpu_torch.components.servergroup import ServerGroup
    from vproxy_tpu_torch.components.tcplb import TcpLB
    from vproxy_tpu_torch.components.upstream import Upstream
    Svc = PORT.service.ClassifyService
    Svc.reset()
    svc = Svc.get()
    svc.mode = "device"
    elg = EventLoopGroup("w", 2)
    s1, s2 = IdServer("A", http=True), IdServer("B", http=True)
    g1 = ServerGroup("g1", elg, fast_hc(), "wrr")
    g2 = ServerGroup("g2", elg, fast_hc(), "wrr")
    lb = None
    try:
        g1.add("a", "127.0.0.1", s1.port, weight=1)
        g2.add("b", "127.0.0.1", s2.port, weight=1)
        wait_healthy(g1, 1)
        wait_healthy(g2, 1)
        ups = Upstream("u", backend="torch-sharded")
        assert ups._matcher.backend == "torch-sharded"
        ups.add(g1, annotations=PORT.ir.HintRule(host="a.example.com"))
        ups.add(g2, annotations=PORT.ir.HintRule(host="b.example.com"))
        lb = TcpLB("lb", elg, elg, "127.0.0.1", 0, ups,
                   protocol="http-splice")
        lb.start()
        n, out, ths = 24, [None] * 24, []

        def one(i):
            host = "a.example.com" if i % 2 else "b.example.com"
            _, body = http_get_id(lb.bind_port, host)
            out[i] = (host, body)

        for i in range(n):
            th = threading.Thread(target=one, args=(i,), daemon=True)
            th.start()
            ths.append(th)
        for th in ths:
            th.join(timeout=30)
        for i, r in enumerate(out):
            assert r is not None, f"request {i} did not finish"
            assert r[1] == ("A" if r[0].startswith("a.") else "B"), r
        assert svc.stats.device_queries >= n
    finally:
        if lb is not None:
            lb.stop()
        for x in (g1, g2):
            x.close()
        for s in (s1, s2):
            s.close()
        elg.close()
        Svc.reset()


def _fp_update(P, mesh):
    rules = mk_rules(P, 200)
    m = P.engine.HintMatcher(rules, backend=P.fp_sharded, mesh=mesh)
    caps0 = dict(m._caps)
    rules2 = [P.ir.HintRule(host="swap.example.org")] + rules[1:]
    m.set_rules(rules2)
    reuse = m._caps == caps0
    first = int(m.match([P.ir.Hint(host="swap.example.org")])[0])
    big = rules2 + [P.ir.HintRule(host=f"g{i}.grown.example.net")
                    for i in range(900)]
    m.set_rules(big)
    qs = [P.ir.Hint(host="g123.grown.example.net"),
          P.ir.Hint(host="x.g7.grown.example.net")]
    return (reuse, first, answers(m.match(qs)),
            [P.oracle.search(big, h) for h in qs], m._caps != caps0,
            m._caps)


def test_hint_matcher_fp_sharded_update_and_growth(meshes):
    ref, port = both(_fp_update)(meshes)
    assert ref[:2] == port[:2] == (True, 0)
    assert ref[2] == ref[3] == port[2] == port[3]
    assert ref[4] and port[4] and ref[5] == port[5]


def _fp_routes_acl(P, mesh):
    rnd = random.Random(99)
    nets = []
    for i in range(120):
        ml = rnd.choice([8, 12, 16, 24, 32])
        ip = bytes([10 + i % 5, rnd.randint(0, 255), rnd.randint(0, 255), 0])
        raw = bytes(a & b for a, b in zip(ip, P.ip.mask_bytes(ml)))
        nets.append(P.ip.Network(raw, P.ip.mask_bytes(ml)))
    rm = P.engine.CidrMatcher(nets, backend=P.fp_sharded, mesh=mesh)
    addrs = [bytes([10 + rnd.randint(0, 6), rnd.randint(0, 255),
                    rnd.randint(0, 255), rnd.randint(0, 255)])
             for _ in range(64)]
    got_r = answers(rm.match(addrs))
    want_r = [next((j for j, n in enumerate(nets) if n.contains_ip(a)), -1)
              for a in addrs]
    acl = [P.ir.AclRule(f"r{i}", nets[i], P.ir.Proto.TCP, (i * 700) % 60000,
                        (i * 700) % 60000 + 2000, i % 2 == 0)
           for i in range(len(nets))]
    am = P.engine.CidrMatcher(nets, backend=P.fp_sharded, acl=acl,
                              mesh=mesh)
    ports = [rnd.randint(1, 65535) for _ in addrs]
    return (got_r, want_r, answers(am.match(addrs, ports)),
            [am.oracle_one(a, ports[i]) for i, a in enumerate(addrs)],
            rm.published_table_bytes(), am.published_table_bytes(),
            am.checksum())


def test_cidr_matcher_fp_sharded_routes_and_acl(meshes):
    ref, port = both(_fp_routes_acl)(meshes)
    assert ref[0] == ref[1] == port[0] == port[1]
    assert ref[2] == ref[3] == port[2] == port[3]
    assert ref[4:] == port[4:]


# ------------------------------------------------ test_mesh_hash.py's world

def dom(i):
    return f"svc{i}.ns{i % 13}.corp.example"


def hash_world(P):
    rules = []
    for i in range(300):
        k = i % 10
        if k < 5:
            rules.append(P.ir.HintRule(host=dom(i)))
        elif k < 7:
            rules.append(P.ir.HintRule(host=dom(i), uri=f"/v{i % 5}"))
        elif k < 8:
            rules.append(P.ir.HintRule(host=dom(i % 50)))  # cross-shard tie
        elif k < 9:
            rules.append(P.ir.HintRule(host="*", uri=f"/w{i % 3}"))
        else:
            rules.append(P.ir.HintRule(uri=f"/static/{i}"))

    def net(i, ml):
        ip = np.array([10, (i >> 8) & 0xFF, i & 0xFF, 0], np.uint8)
        m = np.frombuffer(P.ip.mask_bytes(ml), np.uint8)
        return P.ip.Network(bytes(ip & m), bytes(m))

    routes = [net(i // 2, 8 + (i % 15)) for i in range(200)]
    acls = [P.ir.AclRule(f"r{i}", net(i // 2, 8 + (i % 19)), P.ir.Proto.TCP,
                         (i * 7) % 50000, (i * 7) % 50000 + 2000, i % 2 == 0)
            for i in range(120)]
    ht = P.H.compile_hint_hash_sharded(rules, 4)
    rt = P.H.compile_cidr_hash_sharded(routes, 4)
    at = P.H.compile_cidr_hash_sharded([a.network for a in acls], 4,
                                       acl=acls)
    return rules, routes, acls, ht, rt, at


def same_stab(a, b):
    """Two ShardedHashTables equal byte for byte: keys, dtypes, shapes,
    bytes, shard_size, r_cap, lset_u and every shard's caps."""
    assert a.arrays.keys() == b.arrays.keys()
    for k in a.arrays:
        assert a.arrays[k].dtype == b.arrays[k].dtype, k
        assert a.arrays[k].shape == b.arrays[k].shape, k
        assert a.arrays[k].tobytes() == b.arrays[k].tobytes(), k
    assert (a.shard_size, a.n, a.r_cap, a.lset_u) == \
        (b.shard_size, b.n, b.r_cap, b.lset_u)
    assert [t.caps for t in a.shards] == [t.caps for t in b.shards]


def _classify(P, mesh, w, hints, addrs, ports, hts=None):
    """make_sharded_classify over the world (its hint table replaced by
    `hts`), -> int32 [B, 3] as a list of rows."""
    rules, routes, acls, ht, rt, at = w
    ht = hts or ht
    hq = P.H.encode_hint_queries_sharded(hints, ht)
    a16, fam = mod("vproxy_tpu_torch" if P.port else "vproxy_tpu",
                   "ops.tables").encode_ips(addrs)
    fn = P.mesh.make_sharded_classify(mesh, ht, rt, at,
                                      *(() if P.port else (hq,)))
    if P.port:
        out = fn(P.mesh.shard_hash_table(ht, mesh),
                 P.mesh.shard_hash_table(rt, mesh),
                 P.mesh.shard_hash_table(at, mesh),
                 P.mesh.shard_hint_queries_sharded(hq, mesh), a16, fam,
                 ports)
        return out.numpy().tolist(), fn
    with mesh:
        out = np.asarray(fn(P.mesh.shard_hash_table(ht, mesh),
                            P.mesh.shard_hash_table(rt, mesh),
                            P.mesh.shard_hash_table(at, mesh),
                            P.mesh.shard_hint_queries_sharded(hq, mesh),
                            a16, fam, ports))
    return out.tolist(), fn


def test_sharded_classify_matches_oracle(meshes):
    """test_mesh_hash.py: the sharded classify (hint, routes, ACL) equal
    to the oracle, cross-shard ties and first matches across shard
    boundaries included; the stacked arrays equal byte for byte."""
    worlds = {P: hash_world(P) for P in (REF, PORT)}
    for i in (3, 4, 5):
        same_stab(worlds[REF][i], worlds[PORT][i])
    rows = {}
    for P, mesh in ((REF, meshes[0]), (PORT, meshes[1])):
        rules, routes, acls = worlds[P][:3]
        rnd = np.random.RandomState(5)
        hints = []
        for i in range(64):
            j = int(rnd.randint(0, 300))
            hints.append(
                P.ir.Hint.of_host(dom(j)) if i % 4 == 0 else
                P.ir.Hint.of_host_uri("x." + dom(j), f"/v{j % 5}/y")
                if i % 4 == 1 else P.ir.Hint(uri=f"/static/{j}")
                if i % 4 == 2 else P.ir.Hint.of_host("none.invalid"))
        addrs = [bytes([10, int(rnd.randint(0, 2)),
                        int(rnd.randint(0, 100)), 7]) for _ in range(64)]
        ports = rnd.randint(1, 60000, 64).astype(np.int32)
        rows[P], _ = _classify(P, mesh, worlds[P], hints, addrs, ports)
        for i in range(64):
            assert rows[P][i][0] == P.oracle.search(rules, hints[i])
            assert rows[P][i][1] == next((j for j, n in enumerate(routes)
                                          if n.contains_ip(addrs[i])), -1)
            assert rows[P][i][2] == next(
                (j for j, a in enumerate(acls)
                 if a.match(addrs[i], int(ports[i]))), -1)
    assert rows[REF] == rows[PORT]


def _live_update(P, mesh, w):
    rules = w[0]
    B = 16
    hints = [P.ir.Hint.of_host("brand.new.example"),
             P.ir.Hint.of_host(dom(0))]
    hints += [P.ir.Hint.of_host("pad.x")] * (B - 2)
    addrs, ports = [b"\x0a\x00\x00\x07"] * B, np.full(B, 443, np.int32)
    out1, _ = _classify(P, mesh, w, hints, addrs, ports)
    rules2 = [P.ir.HintRule(host="brand.new.example")] + list(rules[1:])
    ht2 = P.H.compile_hint_hash_sharded(rules2, 4,
                                        caps=w[3].shards[0].caps)
    grew = any(a.caps != b.caps for a, b in zip(w[3].shards, ht2.shards))
    out2, _ = _classify(P, mesh, w, hints, addrs, ports, hts=ht2)
    return (out1[0][0], out1[1][0], P.oracle.search(rules, hints[0]), grew,
            out2[0][0], out2[1][0], P.oracle.search(rules2, hints[1]))


def test_sharded_update_changes_results(meshes):
    """A caps-reusing recompile (same shapes) serves the NEW rules."""
    ref = _live_update(REF, meshes[0], hash_world(REF))
    port = _live_update(PORT, meshes[1], hash_world(PORT))
    assert ref == port
    assert port[0] == port[2] and port[1] == 0 and not port[3]
    assert port[4] == 0 and port[5] == port[6]


def test_update_storm_no_retrace(meshes):
    """20 caps-reusing updates: shapes frozen, the new rule wins every
    time, and the port's classify fn serves ONE table shape (the
    reference counts one compiled program)."""
    for P, mesh in ((REF, meshes[0]), (PORT, meshes[1])):
        rules, routes, acls, ht, rt, at = hash_world(P)
        B = 16
        hq = P.H.encode_hint_queries_sharded([P.ir.Hint.of_host(dom(1))] * B,
                                             ht)
        fn = P.mesh.make_sharded_classify(mesh, ht, rt, at,
                                          *(() if P.port else (hq,)))
        T = mod("vproxy_tpu_torch" if P.port else "vproxy_tpu",
                "ops.tables")
        a16, fam = T.encode_ips([b"\x0a\x00\x00\x07"] * B)
        ports = np.full(B, 443, np.int32)
        rtd, atd = (P.mesh.shard_hash_table(rt, mesh),
                    P.mesh.shard_hash_table(at, mesh))
        caps = ht.shards[0].caps
        for k in range(20):
            rules_k = [P.ir.HintRule(host=f"gen{k}.example")] + \
                list(rules[1:])
            ht_k = P.H.compile_hint_hash_sharded(rules_k, 4, caps=caps)
            assert ht_k.shards[0].caps == caps
            hq_k = P.H.encode_hint_queries_sharded(
                [P.ir.Hint.of_host(f"gen{k}.example")] * B, ht_k)
            args = (P.mesh.shard_hash_table(ht_k, mesh), rtd, atd,
                    P.mesh.shard_hint_queries_sharded(hq_k, mesh), a16,
                    fam, ports)
            if P.port:
                out = fn(*args).numpy()
            else:
                with mesh:
                    out = np.asarray(fn(*args))
            assert out[0, 0] == 0, (k, out[0, 0])
        if P.port:
            assert len(fn.shapes) == 1, fn.shapes
        else:
            assert fn._cache_size() == 1


# ------------------------------------------- test_multihost.py, simulated

def mk_world(P, n_rules=300, n_acl=64, batch=64):
    rules = [P.ir.HintRule(host=f"s{i}.ns{i % 13}.corp.example")
             for i in range(n_rules)]
    acls = []
    for i in range(n_acl):
        m = P.ip.mask_bytes(8 + (i % 24))
        ip = bytes([10, i % 4, (i * 7) % 256, 0])
        acls.append(P.ir.AclRule(
            f"a{i}", P.ip.Network(bytes(np.frombuffer(ip, np.uint8) &
                                        np.frombuffer(m, np.uint8)), m),
            P.ir.Proto.TCP, (i * 11) % 50000, (i * 11) % 50000 + 2000,
            i % 2 == 0))
    hints = [P.ir.Hint.of_host(
        f"s{(i * 17) % n_rules}.ns{((i * 17) % n_rules) % 13}.corp.example")
        for i in range(batch)]
    addrs = [bytes([10, i % 4, (i * 3) % 256, i % 256]) for i in range(batch)]
    ports = [(i * 11) % 50000 + 100 for i in range(batch)]
    return rules, acls, hints, addrs, ports


def _host_mesh(P):
    mesh = P.mesh.make_mesh(8, batch=2, hosts=2) if not P.port else \
        P.mesh.make_mesh(8, batch=2, hosts=2, device="cpu")
    shape = (tuple(mesh.axis_names), P.mesh.batch_axes(mesh),
             P.mesh.query_shards(mesh))
    rules, acls, hints, addrs, ports = mk_world(P)
    hm = P.engine.HintMatcher(rules, backend=P.fp_sharded, mesh=mesh)
    am = P.engine.CidrMatcher([a.network for a in acls], acl=acls,
                              backend=P.fp_sharded, mesh=mesh)
    got_h, got_a = answers(hm.match(hints)), answers(am.match(addrs, ports))
    want_h = [P.oracle.search(rules, h) for h in hints]
    want_a = [next((j for j, a in enumerate(acls)
                    if a.network.contains_ip(addrs[i])
                    and a.min_port <= ports[i] <= a.max_port), -1)
              for i in range(len(addrs))]
    return shape, got_h, want_h, got_a, want_a, hm.checksum(), am.checksum()


def test_host_mesh_simulated_2x2x2():
    """(2 hosts x 2 batch x 2 rules): tables replicated over "host",
    rules sharded within a host, queries over (host, batch)."""
    ref, port = _host_mesh(REF), _host_mesh(PORT)
    assert ref[0] == port[0] == (("host", "batch", "rules"),
                                 ("host", "batch"), 4)
    assert ref[1] == ref[2] == port[1] == port[2]
    assert ref[3] == ref[4] == port[3] == port[4]
    assert ref[5:] == port[5:]


def _host_update(P):
    mesh = P.mesh.make_mesh(8, batch=2, hosts=2) if not P.port else \
        P.mesh.make_mesh(8, batch=2, hosts=2, device="cpu")
    rules, _, hints, _, _ = mk_world(P, n_rules=200)
    hm = P.engine.HintMatcher(rules, backend=P.fp_sharded, mesh=mesh)
    first = int(hm.match(hints[:8])[0])
    rules2 = list(rules)
    rules2[17] = P.ir.HintRule(host="swapped.corp.example")
    hm.set_rules(rules2)
    return (first, P.oracle.search(rules, hints[0]),
            int(hm.match([P.ir.Hint.of_host("swapped.corp.example")])[0]))


def test_host_mesh_runtime_update_keeps_shapes():
    ref, port = _host_update(REF), _host_update(PORT)
    assert ref == port and port[0] == port[1] and port[2] == 17


# ------------------------------------------------- the brute-force case

@pytest.mark.parametrize("s", [1, 2, 3, 4])
@pytest.mark.parametrize("fp", [False, True], ids=["cuckoo", "fp"])
def test_brute_force_ties_and_level_zero(s, fp):
    """chip_smoke.sharded_tie_case at S = 1..4 (37 rules: no S divides
    it): the best level ties across shards (the least global index
    wins), every shard answers some hints at level 0 (-1 overall), a
    port gate refuses a shard's candidate. The port's sharded answer,
    the reference's on its (batch 2, rules S) mesh and the linear
    oracle agree, and so do the per-shard keys' max and the reference's
    two-phase pmax / pmin."""
    import jax
    from vproxy_tpu_torch.ops import sharded_cuda as SC
    rules_p, hints_p = CS.sharded_tie_case()
    rules_r = [REF.ir.HintRule(host=r.host, uri=r.uri, port=r.port)
               for r in rules_p]
    hints_r = [REF.ir.Hint(host=h.host, uri=h.uri, port=h.port)
               for h in hints_p]
    rmesh = jax.sharding.Mesh(np.array(jax.devices()[:2 * s]).reshape(
        2, s), ("batch", "rules"))
    pmesh = PORT.mesh.make_mesh(2 * s, batch=2, device="cpu")
    ref = answers(REF.engine.HintMatcher(
        rules_r, backend=REF.backend(fp), mesh=rmesh).match(hints_r))
    pm = PORT.engine.HintMatcher(rules_p, backend=PORT.backend(fp),
                                 mesh=pmesh)
    port = answers(pm.match(hints_p))
    want = [PORT.oracle.search(rules_p, h) for h in hints_p]
    assert ref == port == want
    assert want[0] == 0 and want[4] == -1  # a tie won by index 0; level 0
    # the keys by hand: per shard (idx, level), the max key == the answer
    tab, dev = pm.snapshot()[0], pm.snapshot()[1]
    n = len(hints_p)
    cap = PORT.engine.pad_batch(n, 2)
    if fp:
        q = PORT.FP.encode_hint_queries_fp_sharded(
            list(hints_p) + [PORT.ir.Hint()] * (cap - n), tab)
    else:
        q = PORT.H.encode_hint_queries_sharded(hints_p, tab, pad_to=cap)
    q = PORT.mesh.shard_hint_queries_sharded(q, pmesh)
    keys = SC.hint_keys_plain(dev, q, tab.shard_size, fp=fp)
    assert SC.finish_plain(keys).tolist()[:n] == want


@pytest.mark.parametrize("s", [1, 2, 3, 4])
@pytest.mark.parametrize("fp", [False, True], ids=["cuckoo", "fp"])
def test_wildcards_only_in_later_shards(s, fp):
    """chip_smoke.sharded_late_wildcard_case at S = 1..4: the host="*"
    and uri="*" rules that answer the hints sit only in the later
    shards. The port's sharded answer, the reference's on its (batch 2,
    rules S) mesh and the linear oracle agree, and chip_smoke's case
    checks (B8's plain version on the CPU) pass."""
    import jax
    rules_p, hints_p = CS.sharded_late_wildcard_case()
    rules_r = [REF.ir.HintRule(host=r.host, uri=r.uri, port=r.port)
               for r in rules_p]
    hints_r = [REF.ir.Hint(host=h.host, uri=h.uri, port=h.port)
               for h in hints_p]
    rmesh = jax.sharding.Mesh(np.array(jax.devices()[:2 * s]).reshape(
        2, s), ("batch", "rules"))
    pmesh = PORT.mesh.make_mesh(2 * s, batch=2, device="cpu")
    ref = answers(REF.engine.HintMatcher(
        rules_r, backend=REF.backend(fp), mesh=rmesh).match(hints_r))
    port = answers(PORT.engine.HintMatcher(
        rules_p, backend=PORT.backend(fp), mesh=pmesh).match(hints_p))
    want = [PORT.oracle.search(rules_p, h) for h in hints_p]
    assert ref == port == want
    assert {28, 30} <= set(want)  # answered by the late wildcards
    if s == 4 and not fp:
        assert CS.sharded_case_checks(torch.device("cpu")) == 16


# ------------------------------------------- compilers, byte for byte

@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_sharded_compilers_byte_identical(s):
    """compile_hint_hash_sharded / compile_cidr_hash_sharded /
    compile_hint_fp_sharded / compile_cidr_fp_sharded and both sharded
    encoders: equal arrays in both packages at S shards (the rule
    counts not divided by S), caps reuse equal."""
    seed = random.Random(7 + s).randrange(1000)
    for P in (REF, PORT):
        P.rules = mk_rules(P, 301)
        P.nets = [v4net(P, i, 16 + (i % 15)) for i in range(97)]
        P.acl = [P.ir.AclRule(f"a{i}", P.nets[i], P.ir.Proto.TCP, i * 3,
                              i * 3 + 500, i % 3 == 0)
                 for i in range(len(P.nets))]
        P.hints = mk_queries(P, P.rules, 70, seed=seed)
    for comp in ("hint_hash", "hint_fp"):
        a = getattr(REF.H if comp == "hint_hash" else REF.FP,
                    f"compile_{comp}_sharded")(REF.rules, s)
        b = getattr(PORT.H if comp == "hint_hash" else PORT.FP,
                    f"compile_{comp}_sharded")(PORT.rules, s)
        same_stab(a, b)
        if comp == "hint_hash":
            for pad in (None, 96):
                qa = REF.H.encode_hint_queries_sharded(REF.hints, a, pad)
                qb = PORT.H.encode_hint_queries_sharded(PORT.hints, b, pad)
                assert qa.keys() == qb.keys()
                for k in qa:
                    assert np.array_equal(qa[k], qb[k]), k
            # the caps reuse of an update
            c = PORT.H.compile_hint_hash_sharded(
                PORT.rules[1:], s, caps={**b.shards[0].caps})
            assert c.shards[0].caps == b.shards[0].caps
        else:
            qa = REF.FP.encode_hint_queries_fp_sharded(REF.hints, a)
            qb = PORT.FP.encode_hint_queries_fp_sharded(PORT.hints, b)
            assert qa.keys() == qb.keys()
            for k in qa:
                assert np.array_equal(qa[k], qb[k]), k
    for comp in ("cidr_hash", "cidr_fp"):
        ra, pa = (REF.H, PORT.H) if comp == "cidr_hash" else (REF.FP,
                                                              PORT.FP)
        same_stab(getattr(ra, f"compile_{comp}_sharded")(REF.nets, s),
                  getattr(pa, f"compile_{comp}_sharded")(PORT.nets, s))
        same_stab(getattr(ra, f"compile_{comp}_sharded")(
            [r.network for r in REF.acl], s, acl=REF.acl),
            getattr(pa, f"compile_{comp}_sharded")(
            [r.network for r in PORT.acl], s, acl=PORT.acl))


def test_caps_exceeded_is_raised_under_reused_caps():
    """The no-retrace contract: an update that outgrows supplied caps
    raises CapsExceeded in both packages (the engine rebuilds)."""
    for P in (REF, PORT):
        small = P.H.compile_hint_hash_sharded(mk_rules(P, 40), 4)
        with pytest.raises(P.H.CapsExceeded):
            P.H.compile_hint_hash_sharded(mk_rules(P, 3000), 4,
                                          caps=small.shards[0].caps)


# ------------------------------------------------ the mesh layer

def test_mesh_layout_and_defaults(monkeypatch):
    """make_mesh's axes and this rank's shards; default_mesh one slot
    per real device (S = 1 in one process); mesh_serving off on one
    process whatever the knob; pad_batch rounds to the query shards."""
    M = PORT.mesh
    m = M.make_mesh(8, batch=2, device="cpu")
    assert (m.axis_names, m.shape) == (("batch", "rules"),
                                       {"batch": 2, "rules": 4})
    assert (m.rules_lo, m.rules_hi, m.rows, m.group) == (0, 4, (0, 1), None)
    assert M.query_shards(m) == 2 and M.batch_axes(m) == ("batch",)
    with pytest.raises(ValueError):
        M.make_mesh(6, batch=4, device="cpu")
    E = PORT.engine
    assert E.default_mesh().shape == {"batch": 1, "rules": 1}
    monkeypatch.setenv("VPROXY_TPU_MESH_BATCH", "2")
    with pytest.raises(ValueError):
        E.default_mesh()  # one slot does not split over batch 2
    monkeypatch.delenv("VPROXY_TPU_MESH_BATCH")
    for mode in ("auto", "1", "0"):
        monkeypatch.setenv("VPROXY_TPU_MESH_SERVE", mode)
        assert E.mesh_serving() is False  # one process: one real device
    assert E.default_backend() == "torch"
    assert E.pad_batch(17, 2) == 32 and E.pad_batch(3, 6) == 18


def test_sharded_entries_on_cpu_launch_nothing():
    """CPU tensors take the plain version: B8's launch count stays put,
    and a prepared stack is refused for CPU tensors."""
    from vproxy_tpu_torch.ops import sharded_cuda as SC
    m = PORT.engine.CidrMatcher([v4net(PORT, i, 24) for i in range(50)],
                                backend="torch-sharded",
                                mesh=PORT.mesh.make_mesh(4, batch=2))
    n0 = SC.sharded_cuda.launches
    assert answers(m.match([bytes([10, 0, 3, 1])])) == [3]
    assert SC.sharded_cuda.launches == n0
    with pytest.raises(ValueError, match="CUDA"):
        SC.prepare_cidr(dict(m.snapshot()[0]))


@pytest.mark.parametrize("layout", ["diagonal", "", "AUTO"])
def test_sharded_kernel_refuses_an_unknown_layout(layout):
    """B8's layouts are the three of csrc/sharded_match.cu's `Layout`, in
    its order; any other name is a KernelError before any table is
    read or any launch."""
    from vproxy_tpu_torch.ops import fused_cuda as FC
    from vproxy_tpu_torch.ops import sharded_cuda as SC
    assert SC.LAYOUTS == {"auto": 0, "split": 1, "interleaved": 2}
    src = open(SC.SOURCE).read()
    assert "enum Layout { AUTO = 0, SPLIT = 1, INTERLEAVED = 2 };" in src
    n0 = SC.sharded_cuda.launches
    with pytest.raises(FC.KernelError, match="layout"):
        SC.sharded_cuda(layout=layout)
    assert SC.sharded_cuda.launches == n0


# ------------------------------------------ chip_smoke.py, small, on the CPU

def test_chip_smoke_aten_fills_sees_fills_and_nothing_else():
    """chip_smoke.aten_fills, the dispatcher-side half of
    sharded_service's no-fill check: torch.zeros / full / fill_ / zero_
    are fills; empty, copies, arithmetic and nonzero are not."""
    assert CS.aten_fills(lambda: torch.zeros(4)) == ["aten.zeros.default"]
    assert CS.aten_fills(lambda: torch.full((3,), 7).fill_(2)) == [
        "aten.full.default", "aten.fill_.Scalar"]
    assert CS.aten_fills(lambda: torch.ones(2).zero_()) == [
        "aten.zero_.default"]
    x = np.arange(5, dtype=np.int32)
    assert CS.aten_fills(lambda: torch.empty(4).add_(1).nonzero()) == []
    assert CS.aten_fills(lambda: torch.from_numpy(x).to("cpu").clone()) == []


@pytest.mark.timeout(600)
def test_chip_smoke_sharded_phases_on_cpu():
    """chip_smoke.py's sharded_kernels (S = 4 and S = 1, every bucket to
    512, against the plain version and the host index) and
    sharded_service (both backends, one burst of each kind) at a small
    size on the CPU: the plain versions here, no launch."""
    dev = torch.device("cpu")
    pool, futs = CS.sharded_start(2000, 1500, 300, workers=2)
    tabs = CS.sharded_tables(dev, pool, futs, 2000, 1500, 300)
    out = CS.phase_sharded_kernels(dev, tabs, buckets=(16, 128, 512))
    assert out["max_abs_err"] == 0 and out["checks"] == 2 * 6 * 3
    # the hint kinds with their Maglev column, at each S, at the timed
    # batch sizes among the buckets (16, 512) and the largest (512)
    assert out["pick_checks"] == 2 * 2 * 2
    stabs = CS.sharded_service_tables(dev, tabs)
    svc = CS.phase_sharded_service(dev, stabs, bursts=1, burst=64)
    rows = CS.phase_cpick(dev, {be: (stabs[be]["pair"], stabs["rules"])
                                for be in ("torch-sharded",
                                           "torch-fp-sharded")}, b=64,
                          timed=False)
    assert len(rows) == 2
    for be in ("torch-sharded", "torch-fp-sharded"):
        assert svc[be]["queries"] == 4 * 64 and svc[be]["failovers"] == 0
        assert svc[be]["launches"]["sharded_match"] == 0
