"""The torch port's cluster plane (vproxy_tpu_torch/cluster) and its
torch.distributed bring-up.

Ports of the 16 cases of tests/test_cluster.py, run on the port's nodes
(its Application, Command grammar, HTTP controller, metrics, matchers
on the CPU): membership edges under the cluster.peer.drop failpoint,
DNS-as-LB across the fleet, replication (the checksum gate, torn
transfers), the step loop's stall / degrade / rejoin edges and the
operator surface. One more case runs two processes of a gloo
torch.distributed job (the counterpart of
tests/test_multihost.py::test_real_two_process_distributed): B8's keys
reduced across the ranks of the rules axis answer what one process
answers.

No case can lose a free-port race: the in-process nodes bind port 0
and learn each other's ports after binding, and the two-process job
meets at a TCP store the test process holds open.
"""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

from vproxy_tpu_torch.cluster import ClusterNode, parse_peers
from vproxy_tpu_torch.control.app import Application
from vproxy_tpu_torch.control.command import CmdError, Command
from vproxy_tpu_torch.rules import oracle
from vproxy_tpu_torch.rules.engine import CidrMatcher, HintMatcher
from vproxy_tpu_torch.rules.ir import Hint, HintRule
from vproxy_tpu_torch.utils import failpoint
from vproxy_tpu_torch.utils.events import FlightRecorder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def wait_for(pred, timeout=8.0, step=0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("VPROXY_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("VPROXY_TPU_INSTALL_PACE", "0")
    failpoint.clear()
    FlightRecorder.reset()
    yield
    failpoint.clear()


def boot_nodes(n: int, hb_ms=50, poll_ms=100) -> tuple:
    """n in-process cluster nodes over real localhost UDP/TCP: each binds
    ports 0 (heartbeat and replication), then every node's view takes
    the others' bound ports, then they start. -> (apps, nodes)."""
    spec = ",".join(["127.0.0.1:0/0"] * n)
    apps = [Application(workers=1) for _ in range(n)]
    nodes = [ClusterNode(apps[i], i, parse_peers(spec), hb_ms=hb_ms,
                         poll_ms=poll_ms) for i in range(n)]
    for i, node in enumerate(nodes):
        for j, other in enumerate(nodes):
            me = other.membership.peers[j]
            node.membership.peers[j].port = me.port
            node.membership.peers[j].repl_port = other.replicator.bind_port
    for a, node in zip(apps, nodes):
        a.cluster = node
        node.membership.start()
        node.replicator.start()
    return apps, nodes


@pytest.fixture
def pair():
    """Two in-process cluster nodes."""
    apps, nodes = boot_nodes(2)
    yield apps, nodes
    for n in nodes:
        n.close()
    for a in apps:
        a.close()


# ------------------------------------------------------- dist bring-up

def test_init_distributed_unreachable_coordinator_bounded():
    """init_distributed never hangs on an unreachable coordinator: the
    pre-flight probe raises within the timeout, naming every
    VPROXY_TPU_DIST_* knob to check."""
    import socket
    from vproxy_tpu_torch.parallel.mesh import init_distributed
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    s.listen(1)
    dead_port = s.getsockname()[1]
    s.close()  # nothing listens here now
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as ei:
        init_distributed(f"127.0.0.1:{dead_port}", num_processes=2,
                         process_id=1, timeout_s=2, device="cpu")
    assert time.monotonic() - t0 < 30
    msg = str(ei.value)
    for knob in ("VPROXY_TPU_DIST_COORD", "VPROXY_TPU_DIST_NPROC",
                 "VPROXY_TPU_DIST_PROCID", "VPROXY_TPU_DIST_TIMEOUT_S"):
        assert knob in msg, msg


def test_init_distributed_noop_when_unconfigured(monkeypatch):
    from vproxy_tpu_torch.parallel.mesh import init_distributed
    for k in ("VPROXY_TPU_DIST_COORD", "VPROXY_TPU_DIST_NPROC",
              "VPROXY_TPU_DIST_PROCID"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False


# ------------------------------------------------------------- membership

def test_parse_peers_spec():
    peers = parse_peers("10.0.0.1:7000,10.0.0.2:7000/9100, 10.0.0.3:7002")
    assert [p.node_id for p in peers] == [0, 1, 2]
    assert peers[0].repl_port == 7001       # default: heartbeat port + 1
    assert peers[1].repl_port == 9100       # explicit /replport
    assert peers[2].addr == ("10.0.0.3", 7002)
    with pytest.raises(ValueError):
        parse_peers("no-port")


def test_membership_convergence_and_leader(pair):
    _, nodes = pair
    assert wait_for(lambda: all(n.membership.peers_up() == 2
                                for n in nodes))
    assert nodes[0].membership.leader_id() == 0
    assert nodes[1].membership.leader_id() == 0
    assert nodes[0].membership.is_leader()
    assert not nodes[1].membership.is_leader()


def test_peer_flap_under_drop_failpoint(pair):
    """cluster.peer.drop: node 0 stops hearing node 1 -> DOWN after the
    hysteresis; disarm -> re-admitted after up_n good periods; the DNS
    answer set never goes empty."""
    _, nodes = pair
    m0 = nodes[0].membership
    assert wait_for(lambda: m0.peers_up() == 2)
    failpoint.arm("cluster.peer.drop", match="from=1")
    assert wait_for(lambda: m0.peers_up() == 1), \
        "peer 1 never went DOWN under dropped heartbeats"
    assert not m0.peers[1].up
    kinds = [e["kind"] for e in FlightRecorder.get().snapshot()]
    assert "peer_down" in kinds
    addrs = m0.dns_addrs()
    assert addrs and all(len(a) == 4 for a in addrs)
    failpoint.clear()
    assert wait_for(lambda: m0.peers_up() == 2), "peer 1 never re-admitted"
    kinds = [e["kind"] for e in FlightRecorder.get().snapshot()]
    assert kinds.count("peer_up") >= 2


def test_dns_cluster_service_answers_healthy_peers(pair):
    """`cluster.vproxy.local` A answers = the UP peer set (DNS-as-LB
    across the fleet), over a real UDP query to the port's DNS
    server."""
    from test_torch_dns import dns_query
    from vproxy_tpu_torch.components.elgroup import EventLoopGroup
    from vproxy_tpu_torch.components.upstream import Upstream
    from vproxy_tpu_torch.dns import packet as P
    from vproxy_tpu_torch.dns.server import DNSServer
    _, nodes = pair
    assert wait_for(lambda: all(n.membership.peers_up() == 2
                                for n in nodes))
    elg = EventLoopGroup("dns-cluster", 1)
    d = DNSServer("d0", elg.next(), "127.0.0.1", 0, Upstream("empty"))
    d.start()
    try:
        resp = dns_query(P, d.bind_port, "cluster.vproxy.local.")
        got = sorted(r.rdata for r in resp.answers)
        assert got == [bytes([127, 0, 0, 1]), bytes([127, 0, 0, 1])], got
    finally:
        d.stop()
        elg.close()


# ------------------------------------------------------------ replication

def test_replication_converges_and_checksums_match(pair):
    apps, nodes = pair
    assert wait_for(lambda: all(n.membership.peers_up() == 2
                                for n in nodes))
    Command.execute(apps[0], "add upstream u0")
    Command.execute(
        apps[0], "add server-group g0 timeout 500 period 60000 up 1 down 2 "
        'annotations {"vproxy/hint-host":"a.example.com"}')
    Command.execute(apps[0], "add server-group g0 to upstream u0 weight 10")
    gen = nodes[0].replicator.generation
    assert gen == 3
    assert wait_for(lambda: nodes[1].replicator.generation == gen), \
        nodes[1].replicator.status()
    assert nodes[1].replicator.generation_lag() == 0
    assert (nodes[0].replicator.checksum()
            == nodes[1].replicator.checksum())
    assert list(apps[1].upstreams) == ["u0"]
    assert (apps[0].upstreams["u0"]._matcher.checksum()
            == apps[1].upstreams["u0"]._matcher.checksum())
    Command.execute(
        apps[0], 'update server-group g0 annotations '
        '{"vproxy/hint-host":"b.example.com"}')
    assert wait_for(lambda: nodes[1].replicator.generation == gen + 1)
    assert (nodes[0].replicator.checksum()
            == nodes[1].replicator.checksum())


def test_follower_rejects_replicated_mutations(pair):
    apps, nodes = pair
    assert wait_for(lambda: all(n.membership.peers_up() == 2
                                for n in nodes))
    with pytest.raises(CmdError, match="follower"):
        Command.execute(apps[1], "add upstream u-nope")
    assert "u-nope" not in apps[1].upstreams
    assert Command.execute(apps[1], "list cluster-node") == ["0", "1"]


def test_replication_checksum_mismatch_rejects_generation(pair):
    apps, nodes = pair
    follower = nodes[1].replicator
    before = follower.generation
    ok = follower.apply_frame({"t": "incr", "gen": before + 5,
                               "cmds": ["add upstream u-bogus"],
                               "cksum": 0xDEADBEEF})
    assert not ok
    assert follower.generation == before
    assert follower.generation_lag() >= 5
    assert nodes[1].stat("generation_lag") >= 5
    kinds = [e["kind"] for e in FlightRecorder.get().snapshot()]
    assert "generation_reject" in kinds


def test_replication_torn_transfer_never_installs(pair):
    apps, nodes = pair
    assert wait_for(lambda: all(n.membership.peers_up() == 2
                                for n in nodes))
    Command.execute(apps[0], "add upstream u-torn")
    gen = nodes[0].replicator.generation
    failpoint.arm("cluster.replicate.torn", count=1)
    deadline = time.monotonic() + 8
    torn_seen = False
    while time.monotonic() < deadline and not torn_seen:
        kinds = [e["kind"] for e in FlightRecorder.get().snapshot()]
        torn_seen = "generation_reject" in kinds
        time.sleep(0.05)
    assert torn_seen, "torn transfer never rejected"
    assert wait_for(lambda: nodes[1].replicator.generation == gen), \
        "follower never converged after the torn transfer"
    assert "u-torn" in apps[1].upstreams
    assert (nodes[0].replicator.checksum()
            == nodes[1].replicator.checksum())


def test_engine_checksums_track_rules():
    """The checksums the replication gate compares: equal for equal
    rules on every backend (the sharded ones included), different
    after a change."""
    from vproxy_tpu_torch.parallel.mesh import make_mesh
    from vproxy_tpu_torch.utils.ip import Network
    mesh = make_mesh(4, batch=2, device="cpu")
    rules = [HintRule(host="x.example.com")]
    a = HintMatcher(rules, backend="host")
    b = HintMatcher(rules, backend="host")
    assert a.checksum() == b.checksum()
    for be in ("torch", "torch-fp", "torch-sharded", "torch-fp-sharded"):
        kw = {"mesh": mesh} if "sharded" in be else {}
        assert HintMatcher(rules, backend=be, **kw).checksum() == \
            a.checksum()
    b.set_rules([HintRule(host="y.example.com")])
    assert a.checksum() != b.checksum()
    nets = [Network.parse("10.0.0.0/8")]
    ca = CidrMatcher(nets, backend="host")
    cb = CidrMatcher(nets, backend="torch-sharded", mesh=mesh)
    assert ca.checksum() == cb.checksum()
    cb.set_networks([Network.parse("192.168.0.0/16")])
    assert ca.checksum() != cb.checksum()


# --------------------------------------------------------------- step loop

@pytest.fixture
def solo_node():
    apps, nodes = boot_nodes(1)
    yield apps[0], nodes[0]
    nodes[0].close()
    apps[0].close()


def _submit_all(loop, rules, n, stride=3):
    got, done = [], threading.Event()
    for q in range(n):
        h = Hint(host=f"s{(q * stride) % len(rules)}.corp.example")

        def cb(idx, payload, h=h):
            got.append((h, idx))
            if len(got) >= n:
                done.set()
        loop.submit(h, cb)
    assert done.wait(30), f"only {len(got)}/{n} step answers arrived"
    return got


def test_step_stall_degrades_to_host_index_and_rejoins(solo_node):
    """cluster.step.stall wedges a dispatch past the barrier deadline:
    the host degrades to the inline host index (every queued query
    still answered, oracle parity), and re-joins on the next rule
    generation."""
    app, node = solo_node
    rules = [HintRule(host=f"s{i}.corp.example") for i in range(200)]
    m = HintMatcher(rules, backend="torch-fp")
    loop = node.attach_submit(m, step_ms=10, batch_cap=4, timeout_ms=300)
    failpoint.arm("cluster.step.stall", count=1)
    got = _submit_all(loop, rules, 6)
    assert all(idx == oracle.search(rules, h) for h, idx in got)
    assert loop.degraded and loop.barrier_stalls == 1
    assert node.stat("barrier_stalls_total") == 1.0
    assert node.stat("steps_total") >= 1.0
    kinds = [e["kind"] for e in FlightRecorder.get().snapshot()]
    assert "cluster_degrade" in kinds
    Command.execute(app, "add upstream u-rejoin")
    assert wait_for(lambda: not loop.degraded, timeout=10)
    assert loop.epoch == node.replicator.generation
    kinds = [e["kind"] for e in FlightRecorder.get().snapshot()]
    assert "cluster_rejoin" in kinds
    got2 = _submit_all(loop, rules, 4, stride=7)
    assert all(idx == oracle.search(rules, h) for h, idx in got2)
    assert not loop.degraded and loop.barrier_stalls == 1


@pytest.mark.parametrize("fault", ["kernel", "card", "collective"])
def test_step_kernel_fault_closes_the_loop(solo_node, monkeypatch, fault):
    """A KernelError, or any other fault of a dispatch whose matcher is
    on the card, closes the step loop as it closes ClassifyService: the
    held batch and the queue answer -1, later submits raise, the host
    stops stepping, and nothing is served from the host index. Only a
    failed collective takes the stall edge to the host index."""
    from vproxy_tpu_torch.cluster.submit import StepLoop
    from vproxy_tpu_torch.ops.fused_cuda import KernelError
    app, node = solo_node
    rules = [HintRule(host=f"s{i}.corp.example") for i in range(50)]
    m = HintMatcher(rules, backend="torch-fp")
    loop = StepLoop(m, node.membership, step_ms=10, batch_cap=4,
                    timeout_ms=300, on_degrade=node.membership.poke)
    node.submit = loop
    got, done = [], threading.Event()
    for q in range(6):
        h = Hint(host=f"s{q}.corp.example")

        def cb(idx, payload, h=h):
            got.append((h, idx))
            if len(got) == 6:
                done.set()
        loop.submit(h, cb)
    err = {"kernel": KernelError("launch failed"),
           "card": RuntimeError("CUDA error: an illegal memory access"),
           "collective": torch.distributed.DistError("peer rank gone")}[fault]
    if fault != "kernel":
        monkeypatch.setattr(m, "device", torch.device("cuda"))

    def boom(items):
        raise err
    monkeypatch.setattr(loop, "_device_dispatch", boom)
    loop.start(warm=False)
    assert done.wait(10), f"only {len(got)}/6 step answers arrived"
    kinds = [e["kind"] for e in FlightRecorder.get().snapshot()]
    if fault == "collective":
        assert all(idx == oracle.search(rules, h) for h, idx in got)
        assert loop.degraded and loop.barrier_stalls == 1
        assert loop.error is None and "cluster_degrade" in kinds
        loop.stop()
        return
    assert [idx for _, idx in got] == [-1] * 6
    assert isinstance(loop.error, KernelError)
    assert not loop.degraded and loop.barrier_stalls == 0
    assert "cluster_kernel_error" in kinds and "cluster_degrade" not in kinds
    assert loop.status()["error"] is not None
    assert node._hb_meta()["stepping"] is False
    with pytest.raises(KernelError):
        loop.submit(Hint(host="s1.corp.example"), lambda *a: None)
    with pytest.raises(KernelError):  # a new generation does not reopen it
        Command.execute(app, "add upstream u-after")
        loop.rejoin(node.replicator.generation)
        loop.submit(Hint(host="s1.corp.example"), lambda *a: None)


def test_step_unequal_load_and_empty_batches(pair):
    """Two hosts on one step clock with unequal load: the idle host
    keeps contributing empty padded batches and both answer
    oracle-parity verdicts."""
    apps, nodes = pair
    assert wait_for(lambda: all(n.membership.peers_up() == 2
                                for n in nodes))
    rules = [HintRule(host=f"s{i}.corp.example") for i in range(150)]
    loops = [n.attach_submit(HintMatcher(rules, backend="torch-fp"),
                             step_ms=20, batch_cap=8, timeout_ms=2000)
             for n in nodes]
    got0 = _submit_all(loops[0], rules, 24)
    got1 = _submit_all(loops[1], rules, 3)
    for got in (got0, got1):
        assert all(idx == oracle.search(rules, h) for h, idx in got)
    assert all(not lp.degraded for lp in loops)
    assert all(lp.steps_total >= 3 for lp in loops)


def test_close_joins_the_step_loop_threads(pair):
    """ClusterNode.close() stops the attached StepLoop and joins its
    step thread and its dispatch worker, a dispatch in flight included:
    a worker still inside a torch op at interpreter exit aborts the
    process (SIGTERM ended the node with -6). Every query submitted
    before the close is answered (the queue from the host index), the
    peer hears at once that this node no longer steps and does not
    wait for it at a barrier, and later submits raise."""
    from vproxy_tpu_torch.cluster.submit import StepLoop
    apps, nodes = pair
    assert wait_for(lambda: all(n.membership.peers_up() == 2
                                for n in nodes))
    rules = [HintRule(host=f"s{i}.corp.example") for i in range(60)]
    real = StepLoop._device_dispatch
    in_flight = threading.Event()

    def slow(self, items):
        in_flight.set()
        time.sleep(0.3)
        return real(self, items)
    loops = [n.attach_submit(HintMatcher(rules, backend="torch"),
                             step_ms=10, batch_cap=4, timeout_ms=5000)
             for n in nodes]
    StepLoop._device_dispatch = slow
    try:
        got, lock = [], threading.Lock()
        in_flight.clear()
        for q in range(40):
            h = Hint(host=f"s{(q * 7) % len(rules)}.corp.example")

            def cb(idx, payload, h=h):
                with lock:
                    got.append((h, idx))
            loops[0].submit(h, cb)
        assert in_flight.wait(10)
        t0 = time.monotonic()
        nodes[0].close()
        closed_s = time.monotonic() - t0
    finally:
        StepLoop._device_dispatch = real
    assert not any(t is not None and t.is_alive()
                   for t in (loops[0]._thread, loops[0]._disp_thread))
    assert closed_s < 5.0, f"close took {closed_s:.2f}s"
    assert len(got) == 40
    assert all(idx == oracle.search(rules, h) for h, idx in got)
    with pytest.raises(OSError):
        loops[0].submit(Hint(host="s1.corp.example"), lambda *a: None)
    # the survivor stops waiting for node 0 and steps on alone
    assert wait_for(lambda: not nodes[1].membership.peers[0].stepping)
    got1 = _submit_all(loops[1], rules, 8)
    assert all(idx == oracle.search(rules, h) for h, idx in got1)
    assert not loops[1].degraded and loops[1].barrier_stalls == 0


# ------------------------------------------------------- operator surface

def test_cluster_node_verbs_and_http_surface(solo_node):
    import socket
    app, node = solo_node
    assert Command.execute(app, "list cluster-node") == ["0"]
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))  # held: the added peer's address is ours
    port = s.getsockname()[1]
    try:
        assert Command.execute(
            app, f"add cluster-node 7 address 127.0.0.1:{port}") == "OK"
        assert Command.execute(app, "list cluster-node") == ["0", "7"]
        detail = Command.execute(app, "list-detail cluster-node")
        assert any("self leader" in ln for ln in detail)
        assert any(ln.startswith("7 ->") and "DOWN" in ln for ln in detail)
        with pytest.raises(CmdError):
            Command.execute(app,
                            f"add cluster-node 7 address 127.0.0.1:{port}")
        with pytest.raises(CmdError):
            Command.execute(app, "remove cluster-node 0")  # never self
        assert Command.execute(app, "remove cluster-node 7") == "OK"
        assert Command.execute(app, "list cluster-node") == ["0"]
    finally:
        s.close()
    from vproxy_tpu_torch.control.http_controller import HttpController
    ctl = HttpController(app, "127.0.0.1", 0)
    ctl.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{ctl.bind_port}/cluster",
                timeout=5) as r:
            st = json.loads(r.read())
        assert st["enabled"] and st["self"] == 0 and st["is_leader"]
        assert [p["id"] for p in st["peers"]] == [0]
    finally:
        ctl.stop()


def test_cluster_node_commands_require_cluster():
    app = Application(workers=1)
    try:
        with pytest.raises(CmdError):
            Command.execute(app, "list cluster-node")
    finally:
        app.close()


def test_cluster_metrics_exposed(solo_node):
    app, node = solo_node
    from vproxy_tpu_torch.utils.metrics import GlobalInspection
    text = GlobalInspection.get().prometheus_string()
    for k in ("vproxy_cluster_peers_up", "vproxy_cluster_generation",
              "vproxy_cluster_generation_lag", "vproxy_cluster_steps_total",
              "vproxy_cluster_barrier_stalls_total"):
        assert k in text, k
    assert "vproxy_cluster_peers_up 1" in text


# ------------------------------------ two processes of torch.distributed

_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["VPROXY_REPO"])
os.environ["VPROXY_TPU_TORCH_DEVICE"] = "cpu"
rank, port = int(sys.argv[1]), int(sys.argv[2])
import torch
import torch.distributed as dist
dist.init_process_group(
    "gloo", store=dist.TCPStore("127.0.0.1", port, 2, False),
    rank=rank, world_size=2)
from vproxy_tpu_torch.cluster.membership import self_node_id
from vproxy_tpu_torch.ops import hashmatch as H
from vproxy_tpu_torch.ops import sharded_cuda as SC
from vproxy_tpu_torch.parallel import mesh as M
from vproxy_tpu_torch.rules import oracle
from vproxy_tpu_torch.rules.engine import CidrMatcher, HintMatcher
from vproxy_tpu_torch.utils.torchenv import to_host
sys.path.insert(0, os.path.join(os.environ["VPROXY_REPO"], "tests"))
import chip_smoke as CS
assert self_node_id() == rank
rules = CS.mk_rules(601)
hints = CS.mk_queries(rules, 64, 5)
want = [oracle.search(rules, h) for h in hints]
# the rules axis across both ranks: 4 shards, 2 a rank, one group
mesh = M.make_mesh(4, batch=1)
assert (mesh.rules_lo, mesh.rules_hi) == (2 * rank, 2 * rank + 2)
assert mesh.group is not None
for be in ("torch-sharded", "torch-fp-sharded"):
    m = HintMatcher(rules, backend=be, mesh=mesh)
    got = [int(v) for v in to_host(m.match(hints))]
    assert got == want, (be, rank)
# the keys by hand: this rank's shards, the all_reduce, the finish,
# against one process holding all four shards
stab = H.compile_hint_hash_sharded(rules, 4)
q = H.encode_hint_queries_sharded(hints, stab)
import numpy as np
one_q = SC.ShardQueries({k: torch.from_numpy(np.array(
    v[0] if v.strides[0] == 0 else v)) for k, v in q.items()})
one_q.stacked = frozenset(k for k, v in q.items() if v.strides[0] != 0)
one_keys = SC.hint_keys_plain(
    {k: torch.from_numpy(v) for k, v in stab.arrays.items()}, one_q,
    stab.shard_size, 0)
q_local = M.shard_hint_queries_sharded(q, mesh)
keys = SC.hint_keys_plain(M.shard_hash_table(stab, mesh), q_local,
                          stab.shard_size, mesh.rules_lo)
mine = keys.clone()
dist.all_reduce(keys, op=dist.ReduceOp.MAX, group=mesh.group)
assert torch.equal(keys, one_keys) and not torch.equal(mine, one_keys)
assert SC.finish_plain(keys).tolist() == want
# ACL with ports across the ranks
acl = CS.acl_rules(300, 7)
qs = CS.acl_queries(acl, 64, 8)
am = CidrMatcher([r.network for r in acl], acl=acl,
                 backend="torch-sharded", mesh=mesh)
got = [int(v) for v in to_host(am.match([a for a, _ in qs],
                                        [p for _, p in qs]))]
assert got == [am.oracle_one(a, p) for a, p in qs], rank
# (host 2, batch 1, rules 2): a host a rank, no reduction across them
hm = M.make_mesh(4, batch=1, hosts=2)
assert hm.group is None and hm.rows == (rank,)
m = HintMatcher(rules, backend="torch-fp-sharded", mesh=hm)
mine_hints = hints[rank * 32:(rank + 1) * 32]
got = [int(v) for v in to_host(m.match(mine_hints))]
assert got == want[rank * 32:(rank + 1) * 32], rank
dist.barrier()
print(f"DIST_OK rank={rank}", flush=True)
dist.destroy_process_group()
"""


@pytest.mark.timeout(240)
def test_real_two_process_torch_distributed(tmp_path):
    """Two processes of a gloo job meet at a TCP store this process
    holds (no port to race for). Across the ranks of the rules axis
    (make_mesh(4, batch=1): two shards a rank) both sharded backends
    answer every query as the oracle does, and the keys reduced by one
    all_reduce(MAX) equal the one-process keys (while a rank's own keys
    do not); an ACL with ports too; on a (host 2, batch 1, rules 2)
    mesh each rank answers its own half of the batch with no
    reduction. The rank is the cluster node id."""
    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", 0, 2, True, wait_for_workers=False)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("VPROXY_TPU_CLUSTER_SELF", "VPROXY_TPU_DIST_PROCID")}
    env["VPROXY_REPO"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), str(store.port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=200)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        del store
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert f"DIST_OK rank={rank}" in out, out[-2000:]


@pytest.mark.timeout(300)
def test_chip_smoke_cluster_phase_on_cpu():
    """chip_smoke.py's `cluster` phase small on the CPU: two `python -m
    vproxy_tpu_torch` nodes (the entry module under the phase's driver
    thread), the leader's build by command, the follower's convergence
    and refusal, both step loops answering as the host index, SIGTERM
    exit 0 (the plain tiers here: no launch). A node that loses a
    picked port to another process fails its boot and the pair boots
    again on fresh ones."""
    import chip_smoke as CS
    out = CS.phase_cluster(torch.device("cpu"), max_groups=48,
                           min_groups=16, build_s=2.0, queries=96)
    assert out["groups"] == 48 and out["generation"] == 1 + 2 * 48
    assert "follower" in out["follower_refused"]
    for o in out["step"]:
        assert o["answered"] == 96 and o["mismatches"] == 0
        assert o["steps_total"] > 0 and not o["degraded"]
