"""The port's warm backend pool wired into its TcpLB: the cases of
tests/test_pool_wiring.py on the port's modules, the matchers on the
CPU."""
import time

import pytest

from vproxy_tpu_torch.components import servergroup as SG
from vproxy_tpu_torch.components import tcplb as TL
from vproxy_tpu_torch.components.servergroup import HealthCheckConfig, ServerGroup
from vproxy_tpu_torch.components.tcplb import TcpLB
from vproxy_tpu_torch.components.upstream import Upstream
from vproxy_tpu_torch.utils import failpoint
from vproxy_tpu_torch.utils.events import FlightRecorder
from vproxy_tpu_torch.utils.metrics import GlobalInspection

from test_torch_tcplb import _torch_cpu, IdServer, stack, tcp_get_id, wait_healthy  # noqa: F401


@pytest.fixture(autouse=True)
def _clean():
    failpoint.clear()
    FlightRecorder.reset()
    yield
    failpoint.clear()


def _pool_ctr(lb, result):
    return GlobalInspection.get().get_counter(
        "vproxy_lb_pool_total", lb=lb.alias, result=result).value()


def _mk(stack, alias, ids=("A",), pool=2, eject_failures=None,
        monkeypatch=None):
    elg = stack["make_elg"](1)
    servers = [IdServer(i) for i in ids]
    stack["servers"] += servers
    # slow hc down-edge so any DOWN observed is passive ejection
    g = ServerGroup(f"g-{alias}", elg, HealthCheckConfig(
        timeout_ms=500, period_ms=100, up=1, down=100), "wrr")
    stack["groups"].append(g)
    for i, s in enumerate(servers):
        g.add(f"s{i}", "127.0.0.1", s.port)
    wait_healthy(g, len(servers))
    ups = Upstream(f"u-{alias}")
    ups.add(g)
    lb = TcpLB(alias, elg, elg, "127.0.0.1", 0, ups, protocol="tcp",
               pool_size=pool)
    stack["lbs"].append(lb)
    lb.start()
    return elg, servers, g, lb


def _prime(lb, want_hits=1, expect=("A",), deadline_s=8.0):
    """Drive sessions until the pool serves at least `want_hits`."""
    deadline = time.time() + deadline_s
    while _pool_ctr(lb, "hit") < want_hits:
        assert time.time() < deadline, "pool never warmed"
        assert tcp_get_id(lb.bind_port) in expect
        time.sleep(0.01)


def test_pool_hit_preserves_server_first_bytes(stack):
    """IdServer speaks FIRST (1-byte id): a pooled connection consumed
    nothing while parked, so the client still receives the id through
    the pump — the byte-level proof that park_reads works."""
    _, _, _, lb = _mk(stack, "lb-pw1", pool=2)
    _prime(lb, want_hits=3)
    # every session, pooled or fresh, was byte-correct (asserted above)
    assert _pool_ctr(lb, "hit") >= 3
    assert _pool_ctr(lb, "stale") == 0


def test_pool_drains_on_passive_ejection(stack, monkeypatch):
    monkeypatch.setattr(SG, "EJECT_FAILURES", 2)
    _, servers, g, lb = _mk(stack, "lb-pw2", ids=("A", "B"), pool=2)
    _prime(lb, want_hits=2, expect=("A", "B"))
    victim = g.servers[0]
    # wait for the victim's pool to exist (sessions alternate via WRR)
    deadline = time.time() + 5
    while not any(k[1] is victim for k in lb._pools):
        assert time.time() < deadline
        tcp_get_id(lb.bind_port)
        time.sleep(0.01)
    g.report_failure(victim)
    g.report_failure(victim)
    assert victim.ejected
    # the DOWN edge drained the victim's pools; the peer's survive
    assert not any(k[1] is victim for k in lb._pools)
    assert any(k[1] is g.servers[1] for k in lb._pools)


def test_pooled_handover_failure_fresh_connect_fallback(stack):
    """A warmed connection dies at handover: the session must still
    complete via a fresh connect (same backend — it is healthy), under
    the retry budget, with the failure recorded."""
    _, _, g, lb = _mk(stack, "lb-pw3", pool=2)
    _prime(lb, want_hits=1)
    port = g.servers[0].port
    failpoint.arm("pool.handover.dead", count=1, match=f":{port}")
    # hits the armed fault on the next pooled handover; session survives
    deadline = time.time() + 5
    while failpoint.active():
        assert time.time() < deadline, "fault never consumed"
        assert tcp_get_id(lb.bind_port) == "A"
    kinds = {e["kind"]: e for e in FlightRecorder.get().snapshot()}
    ev = [e for e in FlightRecorder.get().snapshot()
          if e.get("phase") == "pooled_handover_failed"]
    assert ev, kinds.keys()
    assert "retry" in kinds
    # the failed socket's siblings were presumed stale: pool was drained
    # (and lazily respawns — so just assert the session flow stayed whole)
    assert tcp_get_id(lb.bind_port) == "A"


def test_pooled_handover_from_just_died_backend_ejects_and_fails_over(
        stack, monkeypatch):
    """The motivating scenario end to end: backend dies with warm sockets
    pooled; the pooled handover fails, the fresh-connect fallback also
    fails (refused), the backend's streak ejects it, and the session
    fails over to the healthy peer — client sees bytes from B, never an
    error."""
    monkeypatch.setattr(SG, "EJECT_FAILURES", 2)
    _, servers, g, lb = _mk(stack, "lb-pw4", ids=("A", "B"), pool=2)
    _prime(lb, want_hits=2, expect=("A", "B"))
    victim = g.servers[0]
    port = victim.port
    failpoint.arm("pool.handover.dead", match=f":{port}")
    failpoint.arm("backend.connect.refuse", match=f":{port}")
    ids = [tcp_get_id(lb.bind_port) for _ in range(8)]
    assert all(i in ("A", "B") for i in ids), ids
    # once ejected, everything lands on B
    assert victim.ejected
    assert ids[-1] == "B"
    kinds = [e["kind"] for e in FlightRecorder.get().snapshot()]
    assert "eject" in kinds
    phases = {e.get("phase") for e in FlightRecorder.get().snapshot()}
    assert "pooled_handover_failed" in phases


def test_pool_idle_expiry_cycles_sockets(stack, monkeypatch):
    monkeypatch.setattr(TL, "POOL_IDLE_S", 0.3)
    _, _, _, lb = _mk(stack, "lb-pw5", pool=2)
    _prime(lb, want_hits=1)
    pools = list(lb._pools.values())
    assert pools
    deadline = time.time() + 6
    while not any(p.expired > 0 for p in pools):
        assert time.time() < deadline, "idle expiry never fired"
        time.sleep(0.05)
    # expired sockets were replaced; the pool still serves
    assert tcp_get_id(lb.bind_port) == "A"


def test_pool_size_hot_set(stack):
    _, _, _, lb = _mk(stack, "lb-pw6", pool=2)
    _prime(lb, want_hits=1)
    lb.set_pool_size(0)
    assert not lb._pools
    hits = _pool_ctr(lb, "hit")
    for _ in range(3):
        assert tcp_get_id(lb.bind_port) == "A"
    assert _pool_ctr(lb, "hit") == hits  # pool off: no pooled handovers
    lb.set_pool_size(2)
    _prime(lb, want_hits=hits + 1)  # lazily respawned at the new size


def test_pool_drains_on_lb_drain_and_stop(stack):
    _, _, g, lb = _mk(stack, "lb-pw7", pool=2)
    _prime(lb, want_hits=1)
    assert lb._pools
    lb.begin_drain()
    assert not lb._pools
    lb.stop()
    # the health listener is gone: edges after stop touch nothing
    g._notify(g.servers[0], False)
