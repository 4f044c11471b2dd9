"""Rule-generation replication — leader-shipped command logs with a
checksum-gated atomic generation swap.

A copy of `vproxy_tpu/cluster/replicate.py` (the port's engine
checksums equal the reference's, so both packages gate on one value).

The control-plane half of the cluster plane (the data-plane half is
cluster/submit.py): every host must serve the SAME rule tables, or two
connections to the same service classify differently depending on
which host accepted them. The mechanism mirrors how LB fleets
replicate forwarding state (Maglev, PAPERS.md) mapped onto this repo's
config-as-command-log persistence (control/persist.py):

* the LEADER (lowest live node id, cluster/membership.py) owns the
  rule state. Every successful mutating command against a replicated
  resource type bumps the rule GENERATION and lands in a bounded
  journal of `(generation, command-line)` entries
  (Command.execute -> Application.cluster.on_command).
* FOLLOWERS poll the leader over TCP (VPROXY_TPU_CLUSTER_POLL_MS):
  `sync(my_generation)` answers with either `noop` (up to date),
  `incr` (the journal suffix the follower is missing) or `snap` (the
  full command-log snapshot, persist.current_config serialization,
  when the follower is too far behind / fresh / diverged).
* every frame carries the leader's generation AND its cluster checksum
  (crc32 over the canonical config + every engine table's rule
  checksum — rules/engine.py HintMatcher/CidrMatcher.checksum(), the
  same generation-snapshot the classify dispatch reads). The follower
  applies the commands OFF-LOOP (this thread, never an event loop);
  the engine tables they touch rebuild as STANDBY tables on the
  engine's background installer (rules/engine.py TableInstaller) and
  land via atomic pointer swaps, so a fleet-wide rule push never
  stalls the step loop or an in-flight dispatch. The follower then
  recomputes its own checksum (after an installer barrier), and only
  then atomically publishes the new generation. Mismatch => the generation is REJECTED: the follower
  stays at its old generation (vproxy_cluster_generation_lag > 0, a
  `generation_reject` recorder event) and forces a full snapshot on
  the next poll. No two hosts ever REPORT the same generation with
  divergent rules.
* frames are length-prefixed with a payload CRC, so a torn transfer
  (connection cut mid-frame — failpoint `cluster.replicate.torn`)
  can never be installed: it fails the frame parse before any command
  is applied.

Leader change (the old leader left the live set): followers force a
full snapshot sync against the new leader — its journal numbering is
not comparable with the old leader's.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
import zlib
from typing import Optional

from ..utils import events, failpoint
from ..utils.log import Logger
from .membership import Membership

_log = Logger("cluster-repl")

POLL_MS = int(os.environ.get("VPROXY_TPU_CLUSTER_POLL_MS", "500"))
JOURNAL_CAP = int(os.environ.get("VPROXY_TPU_CLUSTER_JOURNAL", "256"))
_MAGIC = b"VPRC"

# resource types whose mutations replicate to followers: exactly the
# graph persist.current_config serializes. Control-plane-local
# resources (controllers, faults, cluster-node itself) stay per-host.
REPLICATED_TYPES = frozenset({
    "event-loop-group", "event-loop", "upstream", "server-group",
    "server", "security-group", "security-group-rule", "cert-key",
    "tcp-lb", "socks5-server", "dns-server", "switch", "vpc", "route",
    "ip", "user", "tap", "docker-network-plugin-controller",
    "policy",
})


def cluster_checksum(app) -> int:
    """Replica-identity checksum: crc32 of the canonical command-log
    config folded with every upstream engine-table checksum (the same
    published generation the classify dispatch snapshots). Two hosts
    with equal checksums serve bit-identical verdicts."""
    from ..control.persist import current_config
    c = zlib.crc32(current_config(app).encode())
    for alias in sorted(app.upstreams):
        c = zlib.crc32(
            struct.pack(">I", app.upstreams[alias]._matcher.checksum()), c)
    return c


# ------------------------------------------------------------- framing

def _send_frame(sock: socket.socket, obj: dict, torn: bool = False) -> None:
    payload = json.dumps(obj, separators=(",", ":")).encode()
    head = _MAGIC + struct.pack(">II", len(payload), zlib.crc32(payload))
    if torn:
        # failpoint cluster.replicate.torn: cut the transfer mid-frame —
        # the receiver must reject it at the framing layer
        sock.sendall((head + payload)[: len(head) + len(payload) // 2])
        return
    sock.sendall(head + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        d = sock.recv(n - len(buf))
        if not d:
            raise OSError(f"connection closed mid-frame "
                          f"({len(buf)}/{n} bytes)")
        buf += d
    return buf


def _recv_frame(sock: socket.socket) -> dict:
    head = _recv_exact(sock, 12)
    if head[:4] != _MAGIC:
        raise OSError("bad replication frame magic")
    length, crc = struct.unpack(">II", head[4:])
    if length > 64 << 20:
        raise OSError(f"replication frame too large ({length})")
    payload = _recv_exact(sock, length)
    if zlib.crc32(payload) != crc:
        raise OSError("replication frame crc mismatch (torn transfer)")
    return json.loads(payload)


class Replicator:
    """One per node; leader and follower roles flip with membership."""

    def __init__(self, app, membership: Membership,
                 bind_ip: str, repl_port: int, poll_ms: int = 0):
        self.app = app
        self.membership = membership
        self.poll_ms = poll_ms or POLL_MS
        self.generation = 0
        self.leader_gen_seen = 0
        self.journal: list[tuple[int, str]] = []
        self._lock = threading.Lock()
        # held across (handler mutates app) + (generation bump) on the
        # leader — Command.execute takes it — AND across the
        # (generation, checksum) pairing in _sync_response: a follower
        # sync must never read the OLD generation with a checksum of
        # already-mutated state (that mismatch would force a
        # destructive snapshot teardown on an up-to-date follower)
        self.mutation_lock = threading.Lock()
        self._applying = False      # replicated replay must not re-journal
        self._force_snapshot = False
        self._last_leader: Optional[int] = None
        # True once this node's state provably reached / came from the
        # fleet (a successful leader sync, or journaling with UP
        # peers): fleet-confirmed state REFUSES backward installs from
        # stale restarted leaders (apply_frame), closing the
        # rolling-upgrade rollback race
        self._fleet_confirmed = False
        self._stopped = False
        self._on_generation: list = []  # cb(generation) after install
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # bounded retry: a restarting node re-binds the port its dead
        # incarnation held moments ago (rejoin is a first-class flow)
        deadline = time.monotonic() + 3.0
        while True:
            try:
                self._srv.bind((bind_ip, repl_port))
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)
        self._srv.listen(16)
        self.bind_port = self._srv.getsockname()[1]
        self._threads: list[threading.Thread] = []

    # ------------------------------------------------------------- control

    def start(self) -> None:
        if self._threads:
            return
        for target, name in ((self._accept_loop, "cluster-repl-srv"),
                             (self._follow_loop, "cluster-repl-sync")):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def close(self) -> None:
        self._stopped = True
        try:
            # shutdown BEFORE close: a thread blocked in accept() holds
            # a kernel reference that would keep the port bound (and a
            # restarted node from re-binding it) until accept returned
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass

    def on_generation(self, cb) -> None:
        """cb(generation) after a generation installs (leader bump or
        follower checksum-verified swap) — the step loop's re-join edge."""
        self._on_generation.append(cb)

    def generation_lag(self) -> int:
        """How many generations this node is behind the fleet (0 on the
        leader and on converged followers)."""
        seen = max(self.leader_gen_seen,
                   self.membership.max_generation_seen())
        return max(0, seen - self.generation)

    def checksum(self) -> int:
        return cluster_checksum(self.app)

    def status(self) -> dict:
        return {"generation": self.generation,
                "generation_lag": self.generation_lag(),
                "leader": self.membership.leader_id(),
                "is_leader": self.membership.is_leader(),
                "checksum": self.checksum(),
                "journal_len": len(self.journal),
                "replication_port": self.bind_port}

    # ------------------------------------------------------------- leader

    def on_command(self, line: str) -> None:
        """A successful mutating command against a replicated type ran
        on this node (Command.execute hook). The leader journals it as
        the next generation; a replay-applied command (follower) is
        ignored — it is already part of a journaled generation."""
        if self._applying or not self.membership.is_leader():
            return
        with self._lock:
            self.generation += 1
            gen = self.generation
            self.journal.append((gen, line))
            if len(self.journal) > JOURNAL_CAP:
                del self.journal[: len(self.journal) - JOURNAL_CAP]
        if any(p.up for p in self.membership.peer_list()
               if p.node_id != self.membership.self_id):
            # journaling toward a live fleet: this state is (being)
            # replicated — it must never roll back to an empty restart
            self._fleet_confirmed = True
        events.record("generation_bump",
                      f"rule generation {gen}: {line[:120]}",
                      generation=gen)
        for cb in list(self._on_generation):
            cb(gen)

    def _accept_loop(self) -> None:
        while not self._stopped:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_one, args=(conn,),
                             daemon=True,
                             name="cluster-repl-conn").start()

    def _serve_one(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(10.0)
            req = _recv_frame(conn)
            if req.get("t") != "sync":
                return
            follower_gen = int(req.get("gen", 0))
            if self._fleet_ahead() is not None:
                # serving our (stale) state while we are still catching
                # up from the fleet would replicate the rollback a
                # rolling leader restart exists to avoid: tell the
                # follower to hold its last-known-good and poll again
                resp = {"t": "behind", "gen": self.generation}
            else:
                resp = self._sync_response(follower_gen)
            _send_frame(conn, resp,
                        torn=failpoint.hit("cluster.replicate.torn",
                                           f"gen={resp['gen']}"))
        except (OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _sync_response(self, follower_gen: int) -> dict:
        from ..control.persist import current_config
        # the checksum must describe the SAME generation the frame
        # advertises: mutation_lock excludes the (handler mutates app,
        # generation bumps) window, so the pairing is atomic — a stale
        # pairing would make followers reject perfectly good frames
        with self.mutation_lock:
            with self._lock:
                gen = self.generation
                journal = list(self.journal)
            cksum = cluster_checksum(self.app)
        if follower_gen == gen:
            return {"t": "noop", "gen": gen, "cksum": cksum}
        missing = [(g, ln) for g, ln in journal if g > follower_gen]
        if follower_gen > 0 and missing and missing[0][0] == follower_gen + 1:
            return {"t": "incr", "gen": gen, "cksum": cksum,
                    "cmds": [ln for _, ln in missing]}
        return {"t": "snap", "gen": gen, "cksum": cksum,
                "config": current_config(self.app)}

    # ----------------------------------------------------------- follower

    def _follow_loop(self) -> None:
        while not self._stopped:
            time.sleep(self.poll_ms / 1000.0)
            if self._stopped:
                return
            try:
                self.sync_once()
            except Exception:
                _log.error("replication sync failed", exc=True)

    def _fleet_ahead(self):
        """(peer_id, generation) of the highest-generation UP peer
        advertising a generation beyond ours, else None. Heartbeats
        carry each node's generation, which is what makes a freshly
        RESTARTED lowest-id node — leader by id, stale by state —
        visible as behind the fleet it nominally leads (the
        rolling-upgrade storm scenario's leader roll)."""
        m = self.membership
        best = None
        for p in m.peer_list():
            if p.node_id == m.self_id or not p.up:
                continue
            if p.generation > self.generation and (
                    best is None or p.generation > best[1]):
                best = (p.node_id, p.generation)
        return best

    def sync_once(self) -> bool:
        """One follower poll against the current leader; True when a
        frame was applied cleanly (incl. noop). Callable directly by
        tests/chaos for deterministic convergence."""
        m = self.membership
        lid = m.leader_id()
        if lid == m.self_id:
            ahead = self._fleet_ahead()
            if ahead is None:
                return True  # leading with fleet-current state
            # leader by id, stale by state (a rolling restart brought
            # the lowest id back empty): catch up FROM the fleet before
            # acting as its source of truth — last-known-good stays
            # serving everywhere while this node pulls a snapshot
            lid = ahead[0]
            self._force_snapshot = True
        if self._last_leader is not None and self._last_leader != lid:
            # new leader: its journal numbering is not ours to trust —
            # neither is the lag baseline we accumulated from the old one
            self._force_snapshot = True
            self.leader_gen_seen = 0
        self._last_leader = lid
        leader = m.peers.get(lid)
        if leader is None:
            return False
        try:
            conn = socket.create_connection((leader.ip, leader.repl_port),
                                            timeout=5.0)
        except OSError:
            return False
        try:
            conn.settimeout(10.0)
            gen = 0 if self._force_snapshot else self.generation
            _send_frame(conn, {"t": "sync", "gen": gen})
            frame = _recv_frame(conn)
        except (OSError, ValueError) as e:
            # torn / failed transfer: reject at the framing layer — no
            # partial apply is possible, the generation stays put
            events.record("generation_reject",
                          f"replication transfer from node {lid} "
                          f"rejected: {e}", leader=lid,
                          generation=self.generation)
            self._force_snapshot = True
            return False
        finally:
            try:
                conn.close()
            except OSError:
                pass
        return self.apply_frame(frame, leader_id=lid)

    def apply_frame(self, frame: dict, leader_id: int = -1) -> bool:
        """Apply one sync frame off-loop; atomic generation swap gated
        on the checksum. Public for tests (replication-parity edges)."""
        from ..control.command import Command
        t0 = time.monotonic()
        kind = frame.get("t")
        gen = int(frame.get("gen", 0))
        if kind == "behind":
            # the leader itself is catching up from the fleet (fresh
            # restart into the lowest id): keep serving last-known-good
            # and poll again — its stale generation must not touch the
            # lag baseline either
            return False
        if gen < self.generation and self._fleet_confirmed:
            # a leader offering to move us BACKWARD while our own state
            # is fleet-confirmed is a stale restart whose heartbeats
            # haven't told it yet (the rolling-upgrade race): hold
            # last-known-good — the catch-up path will pull OUR state
            # into it. The legitimate backward install (this node
            # journaled ALONE in its boot window, the real fleet then
            # appeared) stays allowed: that state was never confirmed.
            self._reject(gen, f"backward generation from leader "
                              f"(local {self.generation} is "
                              "fleet-confirmed; stale leader must "
                              "catch up first)")
            return False
        want = frame.get("cksum")
        # assignment, not max(): a legitimate backward move (the real
        # leader appearing after this node journaled alone in the boot
        # window) must not leave the lag gauge pinned nonzero forever
        self.leader_gen_seen = gen
        if kind == "noop":
            if want is not None and want != self.checksum():
                # same generation, different tables: divergence — force
                # a full snapshot to heal
                self._reject(gen, "checksum diverged at equal generation")
                return False
            return True
        if kind == "incr":
            lines = list(frame.get("cmds", []))
        elif kind == "snap":
            if self.journal and not self._fleet_confirmed:
                # locally-journaled generations that never reached the
                # fleet are about to be replaced by its snapshot. The
                # mutation gate (control/command.py) refuses writes on
                # a leader-by-id that can SEE it is behind, but
                # membership needs heartbeats before a restarted node
                # can see the fleet at all — a write accepted in that
                # blind window lands here, and discarded state must be
                # LOUD, never silent
                lost = [ln for _, ln in self.journal]
                _log.error(
                    f"fleet snapshot discards {len(lost)} unconfirmed "
                    "local generation(s): "
                    + "; ".join(ln[:60] for ln in lost[:4]))
                events.record(
                    "generation_discard",
                    f"{len(lost)} unconfirmed local generation(s) "
                    "replaced by fleet snapshot", discarded=len(lost))
            self._teardown()
            lines = [ln for ln in frame.get("config", "").splitlines()
                     if ln.strip() and not ln.startswith("#")]
        else:
            return False
        self._applying = True
        try:
            for ln in lines:
                try:
                    Command.execute(self.app, ln)
                except Exception as e:
                    self._reject(gen, f"replay failed at {ln[:80]!r}: {e}")
                    return False
        finally:
            self._applying = False
        # the replayed mutations install engine tables through the
        # background TableInstaller (standby compile + atomic swap —
        # the serving path never waits on them). Handlers wait for
        # their own install, but a wait=False mutation path must still
        # never pair a new generation with an old table checksum:
        # barrier on the installer before checksumming. A timed-out
        # barrier is a REJECT with its own reason — comparing against
        # half-installed tables would masquerade as rule divergence.
        from ..rules.engine import flush_installs
        barrier_s = float(os.environ.get(
            "VPROXY_TPU_INSTALL_BARRIER_S", "300"))
        if not flush_installs(timeout=barrier_s):
            self._reject(gen, "engine install barrier timed out "
                              "(standby table compiles still running)")
            return False
        got = self.checksum()
        if want is not None and got != want:
            self._reject(gen, f"table checksum mismatch "
                              f"(leader {want:#x}, local {got:#x})")
            return False
        # checksum verified: atomically publish the new generation
        self.generation = gen
        self._fleet_confirmed = True  # this state came FROM the fleet
        self._force_snapshot = False
        swap_ms = (time.monotonic() - t0) * 1e3
        events.record("generation_install",
                      f"generation {gen} installed ({kind}, "
                      f"{len(lines)} cmds, {swap_ms:.1f}ms)",
                      generation=gen, frame=kind,
                      swap_ms=round(swap_ms, 2))
        for cb in list(self._on_generation):
            cb(gen)
        return True

    def _reject(self, gen: int, why: str) -> None:
        self._force_snapshot = True
        events.record("generation_reject",
                      f"generation {gen} rejected: {why}",
                      generation=gen, local_generation=self.generation)
        _log.alert(f"cluster generation {gen} rejected: {why}; "
                   f"staying at {self.generation}, full snapshot next poll")

    def _teardown(self) -> None:
        """Snapshot apply starts from an empty resource graph: remove
        everything persist.current_config serializes, frontends first
        (reverse dependency order), through the normal handlers so every
        resource's own stop/close runs."""
        from ..control.command import Command
        app = self.app
        self._applying = True
        try:
            def rm(rtype: str, aliases) -> None:
                for a in list(aliases):
                    try:
                        Command.execute(app, f"force-remove {rtype} {a}")
                    except Exception:
                        _log.error(f"teardown {rtype} {a} failed", exc=True)
            rm("tcp-lb", app.tcp_lbs)
            rm("socks5-server", app.socks5_servers)
            rm("dns-server", app.dns_servers)
            rm("switch", app.switches)
            rm("upstream", app.upstreams)
            rm("server-group", app.server_groups)
            rm("security-group", app.security_groups)
            rm("cert-key", app.cert_keys)
            rm("docker-network-plugin-controller", app.docker_controllers)
            from ..control.app import (DEFAULT_ACCEPTOR_ELG,
                                       DEFAULT_CONTROL_ELG,
                                       DEFAULT_WORKER_ELG)
            rm("event-loop-group",
               [a for a in app.elgs
                if a not in (DEFAULT_ACCEPTOR_ELG, DEFAULT_WORKER_ELG,
                             DEFAULT_CONTROL_ELG)])
        finally:
            self._applying = False
