"""Chaos driver — a loopback LB under client load while failpoints toggle.

The port's copy of tools/chaos.py, on vproxy_tpu_torch: the same
script, report keys and floor. Builds 3 id-echo backends behind a
TcpLB, hammers it with short byte-verified sessions, and walks the
failure script (docs/robustness.md):

  1. warmup       — all backends healthy, traffic flows
  2. backend kill — `backend.connect.refuse` armed on one backend
                    mid-run; clients must keep completing (retry
                    failover) and the refuser must be passively ejected
                    within the failure threshold, NOT a health-check
                    interval (the hc period here is 60s to prove it)
  3. recovery     — fault disarmed; the backend re-admits via the eject
                    backoff (halved on each passing probe)
  4. device drop  — `device.dispatch.error` armed against a classify
                    dispatch. A matcher on the CPU takes the reference's
                    contract: the batch degrades to the host oracle and
                    still delivers (failovers >= 1, answers [-1, 0]). A
                    matcher on the card takes the port's (rules/
                    service.py): the fault is a KernelError, the service
                    answers what it holds with -1 and closes, no
                    failover, and a later submit raises. The phase runs
                    on a ClassifyService of its own, so the later phases
                    go on with the process-wide one.
  5. drain        — `drain` issued mid-traffic: in-flight pumps finish,
                    new accepts are shed, the process-level wait
                    completes inside the drain window

`--cluster` runs the CLUSTER-plane scenario instead (run_cluster):
three localhost nodes, one killed mid-traffic — survivors must keep
>= 99% classify success through the barrier-timeout degrade, and the
killed node must re-join at the current rule generation (the kill
drops node 2's last heartbeats at the survivors: the port's close
announces that the node stops stepping, the reference's does not, and
a node that dies announces nothing). Each node's
step loop carries a Maglev plane (_fleetlib.attach_pick_loop): every step is
the FusedPair's one launch (B1 on the card), every query a submit_pick
held to the oracle's verdict and the host Maglev pick; the reference's
steps are hint-only.

The LB and the step loops serve on utils/torchenv.default_device (the
card): without a GPU `run`, `run_cluster` and the CLI raise unless the
CPU is asked for (`--device cpu` or VPROXY_TPU_TORCH_DEVICE=cpu).

Run: python -m vproxy_tpu_torch.tools.chaos [--clients N] [--requests N]
     [--cluster] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time

from . import _fleetlib
from ..components import servergroup as SG
from ..components.elgroup import EventLoopGroup
from ..components.servergroup import HealthCheckConfig, ServerGroup
from ..components.tcplb import TcpLB
from ..components.upstream import Upstream
from ..utils import failpoint, lifecycle
from ..utils.events import FlightRecorder


# fleet/load helpers live in tools/_fleetlib.py (shared with storm.py
# and _verify_cluster.py — no per-harness copies). The chaos floor
# counts a shed (RST/refusal) as a failed session: nothing in this
# scenario is SUPPOSED to shed.
_EchoBackend = _fleetlib.EchoBackend


def _blast(port: int, n: int, clients: int, payload: bytes):
    st = _fleetlib.blast(port, n, clients, payload)
    return {"ok": st["ok"], "fail": st["fail"] + st["shed"],
            "ids": st["ids"]}


def _classify_device_drop() -> dict:
    """Phase 4: a device dispatch raises via the failpoint, on a
    ClassifyService of the phase's own. On the CPU the batch degrades
    to the host oracle and still delivers (the reference's contract);
    on the card the fault is a KernelError: every held callback gets -1
    and the service closes, so a submit that comes after the fault (the
    second one, if the fault beat it, and always the `later` one)
    raises it. A warm-up query on a host-backend matcher starts the
    dispatcher first, so both queries normally ride one batch."""
    from ..rules.engine import HintMatcher
    from ..rules.ir import Hint, HintRule
    from ..rules.service import ClassifyService

    ups = Upstream("chaos-classify")
    ups._matcher.set_rules([HintRule(host="chaos.example.com")],
                           payload=["g0"])
    on_card = ups._matcher.device.type != "cpu"
    svc = ClassifyService(mode="device")
    delivered = []
    refused = []
    done = threading.Event()
    warm = threading.Event()
    host = HintMatcher([HintRule(host="warm.example.com")], backend="host")
    svc.submit_hint(host, Hint(host="warm.example.com"),
                    lambda idx, payload: warm.set())
    warm.wait(10)

    def cb(idx, payload):
        delivered.append(idx)
        if len(delivered) + len(refused) >= 2:
            done.set()

    failpoint.arm("device.dispatch.error", count=1)
    try:
        for name in ("chaos.example.com", "nomatch.org"):
            try:
                svc.submit_hint(ups._matcher, Hint(host=name), cb)
            except Exception as e:
                refused.append(type(e).__name__)
                if len(delivered) + len(refused) >= 2:
                    done.set()
        ok = done.wait(20)
        later = None
        if on_card:
            try:
                svc.submit_hint(ups._matcher, Hint(host="later.org"),
                                lambda idx, payload: None)
            except Exception as e:
                later = type(e).__name__
    finally:
        failpoint.disarm("device.dispatch.error")
        svc.close()
    out = {"delivered": ok, "failovers": svc.stats.failovers,
           "answers": sorted(delivered), "on_card": on_card}
    if on_card:
        out.update(error=type(svc.error).__name__ if svc.error else None,
                   refused=refused, later_submit_raised=later)
    return out


def run(clients: int = 4, requests: int = 120, payload_len: int = 4096,
        eject_base_s: float = 0.5, drain_s: float = 10.0,
        seed: int = None, log=lambda *_: None) -> dict:
    """Full chaos script; returns the report dict (see test_chaos.py
    for the asserted floor on every field). `seed` pins every
    probability failpoint arm (VPROXY_TPU_FAILPOINT_SEED) and the
    payload bytes, and rides into the report so a failing run replays."""
    import random as _random
    _fleetlib.select_device()
    if seed is not None:
        os.environ["VPROXY_TPU_FAILPOINT_SEED"] = str(seed)
        payload = bytes(_random.Random(seed).randbytes(payload_len))
    else:
        payload = os.urandom(payload_len)
    report: dict = {"seed": seed}
    saved = (SG.EJECT_FAILURES, SG.EJECT_BASE_S)
    SG.EJECT_FAILURES, SG.EJECT_BASE_S = 3, eject_base_s
    failpoint.clear()
    lifecycle.reset()
    FlightRecorder.reset()

    from ..control.app import Application
    from ..control.command import Command

    backends = [_EchoBackend(b"%d" % i) for i in range(3)]
    elg = EventLoopGroup("chaos", 2)
    # the refuse failpoint gates Connection.connect (the data plane),
    # NOT the health checker's raw tcp probe — so the hc keeps passing
    # and can never mark the victim down. Any DOWN observed below is
    # provably passive ejection; the fast period only serves backoff
    # halving on the re-admission side.
    group = ServerGroup("chaos-g", elg, HealthCheckConfig(
        timeout_ms=500, period_ms=200, up=1, down=100), "wrr")
    for i, b in enumerate(backends):
        group.add(f"b{i}", "127.0.0.1", b.port)
    deadline = time.time() + 5
    while sum(1 for s in group.servers if s.healthy) < 3:
        if time.time() > deadline:
            raise TimeoutError("backends never came healthy")
        time.sleep(0.02)
    ups = Upstream("chaos-u")
    ups.add(group)
    # warm backend pool ON (round 6): the chaos floor must hold with
    # pooled handovers in the path — eject drains pools, stale sockets
    # fall back to fresh connects, server-first id bytes survive parking
    pool_size = int(os.environ.get("CHAOS_POOL", "4"))
    lb = TcpLB("chaos-lb", elg, elg, "127.0.0.1", 0, ups, protocol="tcp",
               pool_size=pool_size)
    lb.start()
    app = Application.create(workers=1)
    app.tcp_lbs["chaos-lb"] = lb

    try:
        # -------- phase 1: warmup
        log("phase 1: warmup")
        warm = _blast(lb.bind_port, requests, clients, payload)
        report["warmup"] = warm

        # -------- phase 2: refuse one backend mid-run
        log("phase 2: backend kill (connect refuse)")
        victim = group.servers[0]
        t_arm = time.monotonic()
        failpoint.arm("backend.connect.refuse",
                      match=f":{backends[0].port}")
        poll = {"eject_latency_s": None}

        def watch_eject():
            while time.monotonic() - t_arm < 10:
                if victim.ejected:
                    poll["eject_latency_s"] = time.monotonic() - t_arm
                    return
                time.sleep(0.005)

        w = threading.Thread(target=watch_eject)
        w.start()
        kill = _blast(lb.bind_port, requests, clients, payload)
        w.join()
        report["kill"] = kill
        report["eject_latency_s"] = poll["eject_latency_s"]
        report["ejected"] = victim.ejected

        # -------- phase 3: disarm -> backoff re-admission
        log("phase 3: recovery (backoff re-admission)")
        failpoint.clear()
        deadline = time.time() + eject_base_s * 8 + 5
        while not victim.healthy and time.time() < deadline:
            time.sleep(0.02)
        report["readmitted"] = victim.healthy
        recov = _blast(lb.bind_port, requests // 2, clients, payload)
        report["recovery"] = recov
        report["victim_served_after_readmit"] = \
            recov["ids"].get("0", 0) > 0

        # -------- phase 4: device drop in the classify path
        log("phase 4: device dispatch drop")
        report["classify"] = _classify_device_drop()

        # -------- phase 5: drain mid-traffic
        log("phase 5: drain mid-traffic")
        held = []
        for _ in range(3):  # long-lived sessions that outlive the drain
            c = socket.create_connection(("127.0.0.1", lb.bind_port),
                                         timeout=5)
            c.settimeout(5)
            assert c.recv(1)
            held.append(c)
        t_drain = time.monotonic()
        assert Command.execute(app, "drain") == "OK"
        # new accepts shed (refused or closed-on-accept)
        shed_ok = False
        try:
            c2 = socket.create_connection(("127.0.0.1", lb.bind_port),
                                          timeout=2)
            c2.settimeout(2)
            shed_ok = c2.recv(8) == b""
            c2.close()
        except OSError:
            shed_ok = True
        report["drain_sheds_new_accepts"] = shed_ok
        # in-flight sessions still move bytes, then finish
        drained_bytes = all(
            (c.sendall(b"drain-ok") or c.recv(16) == b"drain-ok")
            for c in held)
        report["drain_inflight_alive"] = drained_bytes
        for c in held:
            c.close()
        report["drain_clean"] = app.drain_wait(drain_s)
        report["drain_elapsed_s"] = time.monotonic() - t_drain
        report["healthz"] = lifecycle.state()
    finally:
        SG.EJECT_FAILURES, SG.EJECT_BASE_S = saved
        failpoint.clear()
        lifecycle.reset()
        app.tcp_lbs.pop("chaos-lb", None)
        app.close()
        lb.stop()
        group.close()
        for b in backends:
            b.close()
        elg.close()

    total = (warm["ok"] + warm["fail"] + kill["ok"] + kill["fail"]
             + recov["ok"] + recov["fail"])
    ok = warm["ok"] + kill["ok"] + recov["ok"]
    report["total_sessions"] = total
    report["ok_sessions"] = ok
    report["success_rate"] = ok / total if total else 0.0
    report["pool_size"] = pool_size
    # chaos runs under VPROXY_TPU_TRACE_SAMPLE dump their worst traces
    # like the bench --trace stage (docs/observability.md)
    from ..utils import trace as TR
    if TR.enabled():
        report["slowest_traces"] = TR.slowest(8)
        report["stage_table"] = TR.stage_table()
    return report


# ------------------------------------------------------- cluster scenario

def run_cluster(n_rules: int = 24, queries_per_node: int = 120,
                log=lambda *_: None) -> dict:
    """Cluster-plane chaos (vproxy_tpu_torch/cluster): three localhost nodes
    on real UDP membership + TCP replication + the step-synchronized
    submit clock. Script:

      1. convergence — 3 nodes up, node 0 leads, leader rules
         replicate, all checksums equal
      2. kill        — node 2 dies MID-TRAFFIC. The barrier timeout is
         set BELOW the membership down-detection, so survivors go
         through the barrier-timeout degrade edge (host-index serving,
         no failed query) — the floor is >= 99% classify success on
         the survivors
      3. rejoin      — node 2 restarts fresh, re-syncs replication to
         the CURRENT generation; the next leader mutation moves the
         fleet to a new generation and every host (survivors included)
         re-joins step dispatch on it
    """
    from ..control.command import Command
    from ..rules import oracle
    from ..rules.ir import Hint
    from ..rules.maglev import pick as maglev_pick

    _fleetlib.select_device()
    wait_for = _fleetlib.wait_for

    failpoint.clear()
    FlightRecorder.reset()
    report: dict = {}
    spec = _fleetlib.cluster_spec(3)  # UDP heartbeat / TCP replication
    # hb 300ms x down 3 = 900ms down-detection > 400ms barrier timeout:
    # a killed node hits the barrier-timeout degrade edge, not the
    # quiet membership eviction
    HB, POLL, STEP_TO = 300, 120, 400

    def mk_node(i):
        return _fleetlib.make_node(i, spec, hb_ms=HB, poll_ms=POLL)

    log("phase 1: convergence")
    apps, nodes = zip(*[mk_node(i) for i in range(3)])
    apps, nodes = list(apps), list(nodes)
    try:
        report["converged"] = wait_for(
            lambda: all(n.membership.peers_up() == 3 for n in nodes))
        Command.execute(apps[0], "add upstream u0")
        for i in range(n_rules):
            Command.execute(
                apps[0], f"add server-group g{i} timeout 500 period 60000 "
                "up 1 down 2 annotations "
                f'{{"vproxy/hint-host":"s{i}.corp.example"}}')
            Command.execute(apps[0],
                            f"add server-group g{i} to upstream u0 weight 10")
        gen0 = nodes[0].replicator.generation
        report["replicated"] = wait_for(
            lambda: all(n.replicator.generation == gen0 for n in nodes))
        sums = {n.replicator.checksum() for n in nodes}
        report["checksums_equal"] = len(sums) == 1
        rules = [h.merged_rule() for h in apps[0].upstreams["u0"].handles]

        loops = [_fleetlib.attach_pick_loop(
            nodes[i], apps[i].upstreams["u0"]._matcher, step_ms=20,
            batch_cap=8, timeout_ms=STEP_TO) for i in range(3)]

        # traffic: a steady trickle on every node; per-query verdicts
        # checked against the oracle, 15s delivery deadline
        lock = threading.Lock()
        stats = {i: {"ok": 0, "bad": 0, "lost": 0} for i in range(3)}
        stop_traffic = [threading.Event() for _ in range(3)]

        def traffic(i):
            pending = []
            mtab = loops[i].maglev.snapshot()[0]
            q = 0
            while q < queries_per_node and not stop_traffic[i].is_set():
                h = Hint(host=f"s{(q * 7) % (n_rules + 3)}.corp.example")
                ip = bytes([10, 79, i, q % 256])
                port = None if q % 3 == 0 else 1024 + q
                got = {"e": threading.Event(), "idx": None, "pick": None}

                def cb(idx, pick, payload, got=got):
                    got["idx"], got["pick"] = idx, pick
                    got["e"].set()
                try:
                    loops[i].submit_pick(h, ip, port, cb)
                except OSError:
                    break
                pending.append((h, ip, port, got))
                q += 1
                time.sleep(0.01)
            for h, ip, port, got in pending:
                if not got["e"].wait(15):
                    with lock:
                        stats[i]["lost"] += 1
                    continue
                with lock:
                    key = ("ok" if got["idx"] == oracle.search(rules, h)
                           and got["pick"] == maglev_pick(mtab, ip, port)
                           else "bad")
                    stats[i][key] += 1

        threads = [threading.Thread(target=traffic, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()

        log("phase 2: kill node 2 mid-traffic")
        time.sleep(0.4)  # mid-traffic, not before it
        # a kill, not a leave: the port's close() tells the peers at
        # once that node 2 no longer steps (StepLoop.stop), so its last
        # heartbeats are dropped at the survivors, which then wait for
        # it at the barrier as for a node that died
        failpoint.arm("cluster.peer.drop", match="from=2 ")
        stop_traffic[2].set()
        nodes[2].close()
        apps[2].close()
        for t in threads:
            t.join(60)
        failpoint.disarm("cluster.peer.drop")
        report["traffic"] = {str(i): dict(stats[i]) for i in range(3)}
        surv_ok = stats[0]["ok"] + stats[1]["ok"]
        surv_all = sum(stats[i][k] for i in (0, 1)
                       for k in ("ok", "bad", "lost"))
        report["survivor_success_rate"] = (surv_ok / surv_all
                                           if surv_all else 0.0)
        report["survivors_degraded"] = [loops[i].degraded for i in (0, 1)]
        report["survivor_barrier_stalls"] = [loops[i].barrier_stalls
                                             for i in (0, 1)]

        log("phase 3: node 2 rejoins at the current generation")
        apps[2], nodes[2] = mk_node(2)
        report["rejoin_member"] = wait_for(
            lambda: all(n.membership.peers_up() == 3 for n in nodes))
        report["rejoin_caught_up"] = wait_for(
            lambda: nodes[2].replicator.generation
            == nodes[0].replicator.generation)
        # a fresh generation moves the whole fleet (survivors re-join
        # step dispatch, the restarted node steps with them)
        loops[2] = _fleetlib.attach_pick_loop(
            nodes[2], apps[2].upstreams["u0"]._matcher, step_ms=20,
            batch_cap=8, timeout_ms=STEP_TO)
        Command.execute(apps[0], 'update server-group g0 annotations '
                        '{"vproxy/hint-host":"swapped.corp.example"}')
        gen2 = nodes[0].replicator.generation
        report["rejoin_generation"] = gen2
        report["fleet_at_generation"] = wait_for(
            lambda: all(n.replicator.generation == gen2 for n in nodes))
        report["survivors_rejoined"] = wait_for(
            lambda: not any(lp.degraded for lp in loops))
        report["checksums_equal_after_rejoin"] = len(
            {n.replicator.checksum() for n in nodes}) == 1
    finally:
        for n in nodes:
            n.close()
        for a in apps:
            a.close()
        failpoint.clear()
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=120,
                    help="sessions per phase")
    ap.add_argument("--payload", type=int, default=4096)
    ap.add_argument("--eject-base", type=float, default=0.5,
                    help="eject backoff base seconds (test-sized)")
    ap.add_argument("--drain-s", type=float, default=10.0)
    ap.add_argument("--cluster", action="store_true",
                    help="run the cluster-plane scenario instead")
    ap.add_argument("--seed", type=int, default=None,
                    help="pin failpoint RNGs + payload bytes "
                    "(VPROXY_TPU_FAILPOINT_SEED); echoed into the report")
    ap.add_argument("--device", default=None,
                    help="serve on this torch device (default: "
                    "VPROXY_TPU_TORCH_DEVICE, else cuda; no GPU raises "
                    "unless cpu is asked for)")
    args = ap.parse_args(argv)
    _fleetlib.select_device(args.device)
    if args.cluster:
        report = run_cluster(
            log=lambda m: print(f"[chaos] {m}", file=sys.stderr))
        print(json.dumps(report, indent=2, default=str))
        floor_ok = report["survivor_success_rate"] >= 0.99
        print(f"[chaos] survivor success rate "
              f"{report['survivor_success_rate']:.4f} "
              f"({'PASS' if floor_ok else 'FAIL'} at 0.99 floor)",
              file=sys.stderr)
        return 0 if floor_ok else 1
    report = run(clients=args.clients, requests=args.requests,
                 payload_len=args.payload, eject_base_s=args.eject_base,
                 drain_s=args.drain_s, seed=args.seed,
                 log=lambda m: print(f"[chaos] {m}", file=sys.stderr))
    print(json.dumps(report, indent=2, default=str))
    floor_ok = report["success_rate"] >= 0.99
    print(f"[chaos] success rate {report['success_rate']:.4f} "
          f"({'PASS' if floor_ok else 'FAIL'} at 0.99 floor)",
          file=sys.stderr)
    return 0 if floor_ok else 1


if __name__ == "__main__":
    sys.exit(main())
