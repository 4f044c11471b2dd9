"""The port's storm suite (vproxy_tpu_torch/tools/storm.py) on the CPU.

* tests/test_storm.py's three smoke scenarios at its scales and seed
  (flash_crowd 0.08, replay_flash_crowd 0.3, adversarial_crowd 0.25;
  seed 5) with the same structural assertions, and the port's report
  shape (SCENARIOS, gate names) held to the reference module's;
* its three fleet tests (stale-leader catch-up, the stale leader's
  mutation refusal, the loud discard) through the port's _fleetlib;
* the full suite at scale 1.0, marked `slow` and `storm` as the
  reference's is;
* chip_smoke.py's tools phase small on the CPU, in device mode
  (VPROXY_TPU_CLASSIFY=device, the small-table cut at 0): the
  scenarios that classify report their batches by kind, no CUDA kernel
  launches on the CPU, and rolling_upgrade's steps are fused
  classify+pick dispatches;
* without a GPU, run_all raises unless the CPU is asked for.

Every socket binds 127.0.0.1, and every wait is bounded.
"""
import os

import pytest

from test_torch_tcplb import _torch_cpu  # noqa: F401
from vproxy_tpu_torch.tools import _fleetlib, storm


@pytest.fixture(autouse=True)
def _seed_env(monkeypatch):
    # run_all exports the seed: monkeypatch restores it after the test
    monkeypatch.delenv("VPROXY_TPU_FAILPOINT_SEED", raising=False)


def test_scenarios_and_cli_match_the_reference():
    from tools import storm as ref_storm
    assert list(storm.SCENARIOS) == list(ref_storm.SCENARIOS)
    assert storm.ROUND == ref_storm.ROUND


@pytest.mark.storm
def test_storm_smoke_flash_crowd():
    """Scaled-down flash crowd: both guard modes run end to end, the
    harness produces gate structures, nothing hard-fails."""
    out = storm.scenario_flash_crowd(scale=0.08, seed=5)
    rows = out["rows"]
    for mode in ("static", "adaptive"):
        r = rows[mode]
        assert r["fail"] == 0, r        # no hard session failures
        assert set(r["slo"]) == {"p99_ms", "hard_failures",
                                 "served_rate", "crowd_in_top_clients"}
        # the analytics plane saw the crowd: the blaster's source is
        # the top client and the storm LB is attributed in top-routes
        assert r["slo"]["crowd_in_top_clients"]["pass"], r["top_clients"]
    assert rows["static"]["ok"] > 0
    ad = rows["adaptive"]
    assert ad["ok"] > 0
    # every attempt is accounted for: served or shed, never vanished
    assert ad["ok"] + ad["fail"] > 0 and ad["shed"] >= 0
    assert set(out["slo"]) == {"adaptive_passes", "differential"}


@pytest.mark.storm
def test_storm_smoke_replay_flash_crowd():
    """Scaled-down record-replay loop: a recorded crowd replays at 2x
    through a fresh world with zero hard failures, and the schedule
    hash is the same across both in-scenario builds."""
    out = storm.scenario_replay_flash_crowd(scale=0.3, seed=5)
    assert out["recorded"]["fail"] == 0
    assert out["replay"]["speed"] == 2.0
    assert out["slo"]["hard_failures"]["pass"], out
    assert out["slo"]["schedule_deterministic"]["pass"], out
    assert len(out["schedule_hash"]) == 64
    # every replayed session is accounted for: served or shed
    assert out["replay"]["ok"] + out["replay"]["shed"] + \
        out["replay"]["fail"] > 0
    assert out["pass"], out["slo"]


@pytest.mark.storm
def test_storm_smoke_adversarial_crowd():
    """Scaled-down policing acceptance: the replayed legit mix holds
    its SLO while the herd is shed and ATTRIBUTED, the shed receipt is
    seed-deterministic, and the OFF differential is demonstrated or
    machine-honestly waived (the flash-crowd headroom rule)."""
    from vproxy_tpu_torch.utils import sketch

    if not sketch.enabled():
        pytest.skip("analytics sketches disabled")
    out = storm.scenario_adversarial_crowd(scale=0.25, seed=5)
    on = out["rows"]["on"]
    assert on["legit"]["fail"] == 0, on
    assert on["herd"]["attempts"] > 0
    # enforcement, not accident: the sheds carry policing attribution
    assert on["policed_sheds"] >= 0.9 * on["herd"]["shed"], on
    assert set(out["slo"]) == {"legit_slo_on", "herd_rejected",
                               "herd_attributed",
                               "receipt_deterministic", "differential"}
    assert out["slo"]["herd_rejected"]["value"] >= 0.90, out["slo"]
    assert out["slo"]["receipt_deterministic"]["pass"], out
    assert len(out["determinism_receipt"]) == 16
    assert out["pass"], out["slo"]


@pytest.mark.storm
def test_restarted_lowest_id_leader_catches_up_from_fleet():
    """The rolling-upgrade edge: node 0 (leader) dies and restarts
    EMPTY while the fleet is generations ahead. It must pull the
    fleet's state (heartbeat-advertised generations) instead of leading
    with — and replicating — its own empty config."""
    from vproxy_tpu_torch.control.command import Command

    spec = _fleetlib.cluster_spec(2)
    apps, nodes = zip(*[_fleetlib.make_node(i, spec, hb_ms=250,
                                            poll_ms=100)
                        for i in range(2)])
    apps, nodes = list(apps), list(nodes)
    try:
        assert _fleetlib.wait_for(
            lambda: all(n.membership.peers_up() == 2 for n in nodes))
        Command.execute(apps[0], "add upstream u0")
        for i in range(4):
            Command.execute(
                apps[0], f"add server-group g{i} timeout 500 "
                "period 60000 up 1 down 2 annotations "
                f'{{"vproxy/hint-host":"s{i}.roll.example"}}')
            Command.execute(
                apps[0], f"add server-group g{i} to upstream u0 weight 10")
        gen = nodes[0].replicator.generation
        assert gen > 0
        assert _fleetlib.wait_for(
            lambda: nodes[1].replicator.generation == gen)
        # kill the leader; node 1 now owns the only copy of the state
        nodes[0].close()
        apps[0].close()
        assert _fleetlib.wait_for(
            lambda: nodes[1].membership.leader_id() == 1, 15)
        # restart node 0 EMPTY: leader by id, stale by state
        apps[0], nodes[0] = _fleetlib.make_node(0, spec, hb_ms=250,
                                                poll_ms=100)
        if not _fleetlib.wait_for(
                lambda: nodes[0].replicator.generation == gen
                and "u0" in apps[0].upstreams, 20):
            from vproxy_tpu_torch.utils.events import FlightRecorder
            evs = [e for e in FlightRecorder.get().snapshot()
                   if e["kind"] in ("generation_reject",
                                    "generation_install")][-8:]
            peers = {p.node_id: (p.up, p.generation)
                     for p in nodes[0].membership.peer_list()}
            raise AssertionError(
                (nodes[0].replicator.generation, list(apps[0].upstreams),
                 nodes[0].membership.leader_id(), peers, evs))
        # and node 1 NEVER rolled back to the empty boot state
        assert nodes[1].replicator.generation == gen
        assert "u0" in apps[1].upstreams
        assert len(apps[1].upstreams["u0"].handles) == 4
        assert _fleetlib.wait_for(
            lambda: len({n.replicator.checksum() for n in nodes}) == 1)
    finally:
        _fleetlib.close_fleet(nodes, apps)


@pytest.mark.storm
def test_stale_leader_refuses_mutations_while_catching_up():
    """The catch-up window's write side: a restarted lowest-id node is
    leader by id but behind the fleet — a mutation accepted there would
    be journaled into a generation the catch-up snapshot is about to
    wipe (acknowledged, then silently lost). It must refuse until
    converged."""
    from vproxy_tpu_torch.control.command import CmdError, Command

    spec = _fleetlib.cluster_spec(2)
    apps, nodes = zip(*[_fleetlib.make_node(i, spec, hb_ms=250,
                                            poll_ms=100)
                        for i in range(2)])
    apps, nodes = list(apps), list(nodes)
    try:
        assert _fleetlib.wait_for(
            lambda: all(n.membership.peers_up() == 2 for n in nodes))
        Command.execute(apps[0], "add upstream u0")
        gen = nodes[0].replicator.generation
        assert gen > 0
        assert _fleetlib.wait_for(
            lambda: nodes[1].replicator.generation == gen)
        nodes[0].close()
        apps[0].close()
        assert _fleetlib.wait_for(
            lambda: nodes[1].membership.leader_id() == 1, 15)
        # restart node 0 EMPTY with its poll thread parked (huge
        # poll_ms): the catch-up window stays open deterministically
        apps[0], nodes[0] = _fleetlib.make_node(0, spec, hb_ms=250,
                                                poll_ms=600_000)
        assert _fleetlib.wait_for(
            lambda: nodes[0].replicator._fleet_ahead() is not None, 15)
        with pytest.raises(CmdError, match="behind the fleet"):
            Command.execute(apps[0], "add upstream u-lost")
        # manual catch-up (the poll thread is parked) -> mutations flow
        assert _fleetlib.wait_for(
            lambda: (nodes[0].replicator.sync_once() or True)
            and nodes[0].replicator.generation == gen, 15)
        Command.execute(apps[0], "add upstream u-after")
        assert "u-lost" not in apps[0].upstreams
        assert "u-after" in apps[0].upstreams
    finally:
        _fleetlib.close_fleet(nodes, apps)


@pytest.mark.storm
def test_fleet_snapshot_discard_of_unconfirmed_generations_is_loud():
    """The residue of the catch-up race the mutation gate cannot close:
    a restarted node cannot SEE the fleet it is behind until heartbeats
    converge, so a write accepted in that blind window is discarded by
    the catch-up snapshot — and the discard must be loud
    (generation_discard event), never silent."""
    from vproxy_tpu_torch.cluster.replicate import cluster_checksum
    from vproxy_tpu_torch.control.app import Application
    from vproxy_tpu_torch.control.command import Command
    from vproxy_tpu_torch.utils.events import FlightRecorder

    spec = _fleetlib.cluster_spec(2)
    # lone node 0: leader by default (peer 1 never comes up), so its
    # journal is exactly the never-fleet-confirmed state
    app, node = _fleetlib.make_node(0, spec, hb_ms=250, poll_ms=600_000)
    try:
        Command.execute(app, "add upstream u-blind")
        assert node.replicator.journal
        assert not node.replicator._fleet_confirmed
        empty = Application(workers=1)
        want = cluster_checksum(empty)
        empty.close()
        # the fleet's (empty-state) snapshot arrives at a higher gen
        assert node.replicator.apply_frame(
            {"t": "snap", "gen": 7, "cksum": want, "config": ""})
        kinds = [e["kind"] for e in FlightRecorder.get().snapshot()]
        assert "generation_discard" in kinds
        assert "u-blind" not in app.upstreams
        assert node.replicator.generation == 7
    finally:
        _fleetlib.close_fleet([node], [app])


@pytest.mark.storm
def test_chip_smoke_tools_phase_on_cpu(monkeypatch):
    """chip_smoke.py's tools phase small on the CPU: device mode, the
    small-table cut at 0, every storm scenario's hard gates, its
    engine dispatches by kind (no CUDA launch on the CPU), chaos at the
    floor with the CPU's failover in phase 4, the replay round trip and
    hostbench through a port TcpLB. The http-splice and DNS scenarios
    classify in hint batches, rolling_upgrade's steps in fused
    classify+pick batches; the tcp-protocol LBs with no hint and the
    allow-all ACL classify nothing. The phase restores the mode and
    the cut."""
    import torch

    import chip_smoke as CS
    from vproxy_tpu_torch.rules import engine as E
    from vproxy_tpu_torch.rules.service import ClassifyService
    monkeypatch.delenv("VPROXY_TPU_CLASSIFY", raising=False)
    cut = E.SMALL_TABLE
    out = CS.phase_tools(torch.device("cpu"), scale=0.05,
                         replay_arrivals=40, host_secs=0.5)
    assert E.SMALL_TABLE == cut and "VPROXY_TPU_CLASSIFY" not in os.environ
    assert ClassifyService.get().mode == "auto"
    st = out["storm"]
    assert list(st) == list(storm.SCENARIOS)
    assert out["launches"] == {"B1": 0, "B3": 0, "B4": 0}
    for name in ("flash_crowd", "replay_flash_crowd", "adversarial_crowd"):
        assert st[name]["batches"] == {}, (name, st[name])
    for name in ("slowloris", "dns_storm"):
        assert set(st[name]["batches"]) == {"hint"}, (name, st[name])
        assert st[name]["batches"]["hint"] > 0
    assert set(st["rolling_upgrade"]["batches"]) == {"cpick"}
    assert out["chaos"]["classify"]["answers"] == [-1, 0]
    assert out["hostbench"]["errors"] == 0
    assert out["hostbench"]["device"]["batches"]["hint"] > 0


def test_run_all_without_gpu_raises_unless_cpu_asked(monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    monkeypatch.delenv("VPROXY_TPU_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        storm.run_all(seed=1, scale=0.01, only="flash_crowd")
    with pytest.raises(RuntimeError, match="CUDA"):
        storm.main(["--only", "flash_crowd", "--scale", "0.01"])


def test_cluster_spec_ports_are_distinct():
    spec = _fleetlib.cluster_spec(4)
    ports = [int(p) for node in spec.split(",")
             for p in node.split(":")[1].split("/")]
    assert len(ports) == 8 and len(set(ports)) == 8


@pytest.mark.storm
@pytest.mark.slow
def test_storm_full_suite():
    """The real thing: every scenario at full scale, every SLO gate
    green, and the flash-crowd differential proved (static FAILS the
    p99 gate adaptive passes, at identical load)."""
    rep = storm.run_all(seed=1, scale=1.0)
    bad = {k: v.get("slo", v.get("error"))
           for k, v in rep["scenarios"].items()
           if not v.get("skipped") and not v.get("pass")}
    assert rep["pass"], bad
    fc = rep["scenarios"]["flash_crowd"]
    assert fc["rows"]["static"]["slo"]["p99_ms"]["pass"] is False
    assert fc["rows"]["adaptive"]["pass"] is True
    ru = rep["scenarios"]["rolling_upgrade"]
    assert ru["generation_rejects"] >= 1 and ru["converged"]
