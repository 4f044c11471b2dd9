"""Fleet bring-up/teardown + load-generation helpers shared by the
port's scenario harnesses (storm, chaos, replay).

The port's copy of tools/_fleetlib.py, building its nodes, apps and
LBs from vproxy_tpu_torch:

* `free_port` / `wait_for` — the socket/timing primitives every
  scenario script opens with;
* `cluster_spec` / `make_node` / `boot_node_env` — a localhost cluster
  fleet (real UDP membership + TCP replication), either constructed
  directly with test-sized timers or through the production env-boot
  path (`VPROXY_TPU_CLUSTER_PEERS` -> ClusterNode.boot_from_env);
* `attach_pick_loop` — a node's step loop with a Maglev plane, so each
  step is one fused classify+pick launch;
* `EchoBackend` / `one_session` / `blast` — the id-echo backend and the
  byte-verified closed-loop client used to drive a TcpLB, with
  per-session latency capture and RST-shed accounting so storm SLO
  gates can distinguish "served slowly" from "refused fast".

One difference from the reference: `cluster_spec` holds every socket
it picks a port with open until all 2n are picked, so no two ports of
one spec coincide (two nodes' UDP sockets on one port would both bind
under SO_REUSEADDR and never hear each other). A port another process
takes before the node binds it fails the node's construction; nothing
here retries.

    from vproxy_tpu_torch.tools import _fleetlib
"""
from __future__ import annotations

import os
import socket
import threading
import time


def select_device(device: str = None):
    """The device the scenario's matchers serve on: `device` when given
    (exported as VPROXY_TPU_TORCH_DEVICE, so every matcher the scenario
    builds takes it), else utils/torchenv.default_device's choice.
    Raises without a GPU unless the CPU was asked for."""
    from ..utils.torchenv import default_device
    if device:
        dev = default_device(device)
        os.environ["VPROXY_TPU_TORCH_DEVICE"] = str(dev)
        return dev
    return default_device()


def free_port(kind=socket.SOCK_STREAM) -> int:
    s = socket.socket(socket.AF_INET, kind)
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def wait_for(pred, timeout: float = 15.0, poll: float = 0.02) -> bool:
    """Poll pred() until true or the deadline; returns the final
    verdict (callers assert or record it)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll)
    return bool(pred())


# --------------------------------------------------------- cluster fleet

def cluster_spec(n: int = 3) -> str:
    """A VPROXY_TPU_CLUSTER_PEERS spec for n localhost nodes: UDP
    heartbeat port / TCP replication port per node, all distinct."""
    socks = [socket.socket(socket.AF_INET, kind)
             for _ in range(n)
             for kind in (socket.SOCK_DGRAM, socket.SOCK_STREAM)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        ports = [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()
    return ",".join(f"127.0.0.1:{ports[2 * i]}/{ports[2 * i + 1]}"
                    for i in range(n))


def make_node(i: int, spec: str, hb_ms: int = 300, poll_ms: int = 120,
              workers: int = 1):
    """Direct construction with test-sized timers (the chaos idiom):
    -> (Application, ClusterNode), membership + replication started."""
    from ..cluster import ClusterNode, parse_peers
    from ..control.app import Application
    app = Application(workers=workers)
    try:
        node = ClusterNode(app, i, parse_peers(spec), hb_ms=hb_ms,
                           poll_ms=poll_ms)
    except BaseException:
        app.close()
        raise
    app.cluster = node
    node.membership.start()
    node.replicator.start()
    return app, node


def boot_node_env(i: int, spec: str, workers: int = 1):
    """The production boot path (the _verify_cluster idiom): env vars ->
    ClusterNode.boot_from_env. -> (Application, ClusterNode)."""
    from ..cluster import ClusterNode
    from ..control.app import Application
    os.environ["VPROXY_TPU_CLUSTER_PEERS"] = spec
    os.environ["VPROXY_TPU_CLUSTER_SELF"] = str(i)
    app = Application(workers=workers)
    app.cluster = ClusterNode.boot_from_env(app)
    if app.cluster is None or app.cluster.self_id != i:
        app.close()
        raise RuntimeError(f"node {i} did not boot from {spec!r}")
    return app, app.cluster


# the backends (identity, weight) of the Maglev plane the port's
# scenarios give their step loops
MAGLEV_ENTRIES = [(f"10.78.0.{i + 1}:80", 1 + i % 3) for i in range(8)]


def attach_pick_loop(node, matcher, **kw):
    """node.attach_submit over `matcher` with a Maglev plane over
    MAGLEV_ENTRIES on the matcher's device: every step is the
    FusedPair's one launch (B1 on the card) and serves submit_pick."""
    from ..rules.maglev import MaglevMatcher
    return node.attach_submit(
        matcher, maglev=MaglevMatcher(MAGLEV_ENTRIES, device=matcher.device),
        **kw)


def close_fleet(nodes, apps) -> None:
    """Teardown tolerant of mid-scenario kills (already-closed nodes)."""
    for n in nodes:
        try:
            n.close()
        except Exception:
            pass
    for a in apps:
        try:
            a.close()
        except Exception:
            pass


# ------------------------------------------------------- LB load helpers

class EchoBackend:
    """Sends its 1-byte id, then echoes; tracks sessions served.
    Optional per-session accept delay models a slow backend."""

    def __init__(self, sid: bytes):
        self.sid = sid
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(512)
        self.port = self.sock.getsockname()[1]
        self.hits = 0
        self.alive = True
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while self.alive:
            try:
                c, _ = self.sock.accept()
            except OSError:
                return
            self.hits += 1
            threading.Thread(target=self._conn, args=(c,),
                             daemon=True).start()

    def _conn(self, c):
        try:
            c.sendall(self.sid)
            while True:
                d = c.recv(65536)
                if not d:
                    break
                c.sendall(d)
        except OSError:
            pass
        finally:
            c.close()

    def close(self):
        self.alive = False
        try:
            self.sock.close()
        except OSError:
            pass


def one_session(port: int, payload: bytes, timeout: float = 5.0,
                src_ip: str = None) -> str:
    """One byte-verified echo session; returns the backend id or raises
    OSError. Exceptions from the PRE-DATA window (refused connect, RST
    or clean close before the first byte arrived) carry `.shed = True`:
    that is the overload guard refusing fast — the designed degrade —
    and SLO gates score it apart from a session that broke after it
    was accepted for service (a reset mid-echo is a REAL failure, and
    must never hide inside the shed column). `src_ip` binds the client
    side to a specific loopback address (any 127/8 works unbound on
    Linux) — the replay engine (tools/replay.py) uses it to give every
    synthesized client a distinct identity the analytics/workload
    planes can re-capture."""
    _PRE = (ConnectionRefusedError, ConnectionResetError,
            ConnectionAbortedError)
    try:
        c = socket.create_connection(
            ("127.0.0.1", port), timeout=timeout,
            source_address=(src_ip, 0) if src_ip else None)
    except _PRE as e:
        e.shed = True
        raise
    c.settimeout(timeout)
    try:
        try:
            sid = c.recv(1)
        except _PRE as e:
            e.shed = True  # killed before a single byte: a shed
            raise
        if len(sid) != 1:
            e = OSError("no backend id (closed early)")
            e.shed = True  # clean pre-data close: the static FIN shed
            raise e
        c.sendall(payload)
        got = b""
        while len(got) < len(payload):
            d = c.recv(65536)
            if not d:
                raise OSError(f"echo truncated at {len(got)}/{len(payload)}")
            got += d
        if got != payload:
            raise OSError("echo corrupted")
        return sid.decode()
    finally:
        c.close()


def _is_shed(e: OSError) -> bool:
    """True only for pre-data refusals tagged by one_session — never
    for timeouts or post-admission breakage."""
    return bool(getattr(e, "shed", False))


def blast(port: int, n: int, clients: int, payload: bytes,
          timeout: float = 5.0, latencies: bool = False,
          retry_shed: int = 0, pace_s: float = 0.0) -> dict:
    """n sessions across `clients` threads ->
    {"ok", "fail", "shed", "ids"[, "lat_s"]}. `retry_shed` re-attempts a
    shed connection up to that many times (a flash-crowd client retrying
    an RST) — each refusal still counts into "shed". `pace_s` sleeps
    between a client's iterations (a paced open-ish arrival instead of
    a pure closed loop)."""
    lock = threading.Lock()
    stats: dict = {"ok": 0, "fail": 0, "shed": 0, "ids": {}}
    lats: list = []

    def worker(count: int) -> None:
        for _ in range(count):
            if pace_s:
                time.sleep(pace_s)
            attempt = 0
            while True:
                t0 = time.monotonic()
                try:
                    sid = one_session(port, payload, timeout)
                except OSError as e:
                    shed = _is_shed(e)
                    with lock:
                        stats["shed" if shed else "fail"] += 1
                    if shed and attempt < retry_shed:
                        # a refused client backs off for real (tens of
                        # ms): an instant-retry storm would just convert
                        # every shed into fresh connect load — the
                        # amplification shedding exists to prevent
                        attempt += 1
                        time.sleep(0.04 * attempt)
                        continue
                    break
                with lock:
                    stats["ok"] += 1
                    stats["ids"][sid] = stats["ids"].get(sid, 0) + 1
                    if latencies:
                        lats.append(time.monotonic() - t0)
                break

    per = max(1, n // clients)
    ts = [threading.Thread(target=worker, args=(per,))
          for _ in range(clients)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if latencies:
        stats["lat_s"] = sorted(lats)
    return stats


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list (0 when empty)."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return float(sorted_vals[i])
