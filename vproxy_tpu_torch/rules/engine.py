"""Classify engine — the runtime seam between rule owners and kernels.

The port of `vproxy_tpu/rules/engine.py` for the hint + Maglev serving
path. Backends (`backend=`, default from VPROXY_TPU_MATCHER):

* "torch" — DEFAULT: cuckoo-hash classify (ops/hashmatch) as torch ops
            on the serving device, plus the packed tables the fused
            classify+pick entry reads (ops/fused, ops/fused_cuda).
* "host"  — the pure-Python oracle (correctness floor + latency floor
            for tiny tables).

The reference's fingerprint, dense and mesh-sharded backends, and its
CIDR matcher, are later slices of the port.

Rule updates never stall serving: set_rules() hands the new rule list to
a process-wide background installer (TableInstaller) that compiles and
uploads a STANDBY table while dispatchers keep serving the published
generation, waits for the upload to land on the device, then publishes
by one atomic tuple swap. Every publish bumps the matcher's
`generation` and records `vproxy_engine_swap_ms`.
"""
from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Optional, Sequence

import numpy as np

from ..ops import hashmatch as H
from ..utils.log import Logger
from ..utils.torchenv import (default_device, sync, tables_from_reference,
                              to_host)
from . import oracle
from .ir import Hint, HintRule

_log = Logger("engine")


def default_backend() -> str:
    """VPROXY_TPU_MATCHER=host selects the oracle; every other value
    serves the torch backend (the port's counterpart of "jax")."""
    return "host" if os.environ.get("VPROXY_TPU_MATCHER") == "host" \
        else "torch"


def pad_batch(n: int, lo: int = 16) -> int:
    """Batch-shape bucket: pow2 growth from `lo`. ClassifyService uses
    these buckets so the device sees few batch shapes."""
    c = lo
    while c < n:
        c <<= 1
    return c


# Below this rule count, single (unbatched) queries run on the host oracle:
# a python scan over a handful of rules is ~1us while a device dispatch
# costs a launch plus a device round trip — the device path wins only for
# big tables or batched queries. The device table is still compiled and
# kept in sync (used by match() batches).
SMALL_TABLE = int(os.environ.get("VPROXY_TPU_SMALL_TABLE", "128"))


# batch padding at the ARRAY level: a pad row must read as "no probes,
# no match" to the kernel. The cuckoo query arrays mark invalid probes
# with -1 (slot/len); everything else (byte windows, flags) zero-fills —
# exactly what encoding an empty Hint() produces, without paying the
# encode for it.
_PAD_CUCKOO = {"hp_len": -1, "hp_slot1": -1, "hp_slot2": -1,
               "up_len": -1, "up_slot1": -1, "up_slot2": -1}


def _pad_hint_q(q: dict, cap: int, fills: dict) -> dict:
    out = {}
    for k, v in q.items():
        n = v.shape[0]
        if n >= cap:
            out[k] = v
            continue
        pad = np.full((cap - n,) + v.shape[1:], fills.get(k, 0), v.dtype)
        out[k] = np.concatenate([v, pad])
    return out


# --------------------------------------------- generation-install plumbing
#
# Process-wide accounting of published table generations, surfaced on
# /metrics (utils/metrics):
#   vproxy_engine_generation      — total generation publishes
#   vproxy_engine_swap_ms         — install latency histogram
#   vproxy_engine_table_bytes{matcher="hint"} — device bytes of every
#                                   live hint matcher's published table

_gen_lock = threading.Lock()
_GENERATION = [0]
_MATCHERS: "weakref.WeakSet" = weakref.WeakSet()
_LAST_SERVE = [0.0]  # monotonic ts of the last serving-path read
_LAUNCHES = [0]      # device launches on the dispatch path (per batch)
_FUSED_DISP = [0]    # of which: fused one-launch dispatches


def note_serving() -> None:
    """Serving-path breadcrumb (one float store): the installer only
    PACES standby compiles when there is serving latency to protect."""
    _LAST_SERVE[0] = time.monotonic()


def serving_recent(window_s: float = 5.0) -> bool:
    return time.monotonic() - _LAST_SERVE[0] < window_s


def generation_total() -> int:
    return _GENERATION[0]


def note_launch(n: int = 1) -> None:
    """Count one device program on the dispatch path (a lock-free int
    store race can only lose a count, never corrupt): fused batches move
    vproxy_engine_dispatch_launches_total by exactly 1, the unfused
    chain by one per chained op."""
    _LAUNCHES[0] += n


def dispatch_launches_total() -> int:
    return _LAUNCHES[0]


def fused_dispatches_total() -> int:
    return _FUSED_DISP[0]


def table_bytes_total(kind: str) -> int:
    """Sum of published device-table bytes across live matchers of one
    kind. The WeakSet snapshot rides _gen_lock (constructors add
    concurrently)."""
    with _gen_lock:
        matchers = list(_MATCHERS)
    return sum(m.published_table_bytes() for m in matchers
               if m._kind == kind)


def _swap_hist():
    # pre-registered (reservoir config included) in
    # GlobalInspection.__init__ — this resolves to that instance
    from ..utils.metrics import GlobalInspection
    return GlobalInspection.get().get_histogram("vproxy_engine_swap_ms")


class _InstallTicket:
    """One caller's claim on a pending install; `exc` carries the
    compile failure back to a waiting set_rules()."""

    __slots__ = ("ev", "exc")

    def __init__(self):
        self.ev = threading.Event()
        self.exc: Optional[BaseException] = None


class TableInstaller:
    """The double-buffer worker: compiles + uploads STANDBY tables off
    the mutation path, one install at a time, then lets the matcher
    publish with an atomic tuple swap.

    * set_rules()/set_backends() enqueue (args, payload) and by default
      WAIT for the publish (read-your-writes for config handlers);
      wait=False callers get a ticket they can ignore.
    * dispatchers never wait: they read the published snapshot, which
      only ever changes by one atomic assignment AFTER the standby
      table is fully built and uploaded.
    * back-to-back installs for one matcher COALESCE: only the newest
      pending rule list compiles; earlier waiters are released by the
      newer publish (their write was superseded — same last-writer-wins
      outcome as racing synchronous compiles, at one compile's cost).
    * the compile yields the GIL between phases (sleep(0)) so a
      million-rule build starves inline accept-path answers by at most
      one interpreter slice, not whole seconds.
    * failpoint `engine.swap.stall` sleeps VPROXY_TPU_SWAP_STALL_S
      inside the worker — the provable "slow install stalls nothing"
      edge.
    """

    _instance: Optional["TableInstaller"] = None
    _ilock = threading.Lock()

    @classmethod
    def get(cls) -> "TableInstaller":
        with cls._ilock:
            if cls._instance is None:
                cls._instance = TableInstaller()
            return cls._instance

    def __init__(self):
        self._cv = threading.Condition()
        # id(matcher) -> (matcher, args, [tickets]); order preserved
        self._jobs: dict[int, tuple] = {}
        self._order: list[int] = []
        self._inflight = 0
        self._thread: Optional[threading.Thread] = None

    def submit(self, matcher, args: tuple) -> _InstallTicket:
        t = _InstallTicket()
        with self._cv:
            key = id(matcher)
            job = self._jobs.get(key)
            if job is None:
                self._jobs[key] = (matcher, args, [t])
                self._order.append(key)
            else:  # coalesce: newest rules win, all waiters ride along
                self._jobs[key] = (matcher, args, job[2] + [t])
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="engine-install", daemon=True)
                self._thread.start()
            self._cv.notify()
        return t

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every pending install published (True) or the
        timeout passed (False). The cluster replication gate calls this
        before checksumming so a wait=False mutation can never pair an
        old table checksum with a new generation."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._jobs or self._inflight:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cv.wait(0.05 if left is None else min(left, 0.05))
        return True

    def _run(self) -> None:
        from ..ops.cuckoo import set_build_pacing
        from ..utils import failpoint
        try:
            # background-priority: the standby compile must lose every
            # scheduling fight with a serving thread. GIL handoff is
            # interval-driven either way (service shrinks it to ~1ms),
            # but the compile's GIL-released phases (numpy, device
            # transfers) otherwise steal the serving path's cores.
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 15)
        except (AttributeError, OSError, PermissionError):
            pass  # non-linux / restricted: yields below still apply
        while True:
            with self._cv:
                while not self._order:
                    self._cv.wait(1.0)
                key = self._order.pop(0)
                matcher, args, tickets = self._jobs.pop(key)
                self._inflight += 1
            exc: Optional[BaseException] = None
            try:
                if failpoint.hit("engine.swap.stall"):
                    # a deliberately slow compile: dispatch must keep
                    # answering the old generation for this whole sleep
                    time.sleep(float(os.environ.get(
                        "VPROXY_TPU_SWAP_STALL_S", "0.5")))
                # standby-compile pacing: each cooperative yield in the
                # build hot loops sleeps ~r x the work since the last
                # one, capping this thread's CPU/GIL duty at 1/(1+r). A
                # full-speed compile costs serving threads ~half the
                # GIL; pacing trades
                # install latency (background, invisible by design)
                # for flat serving latency. Re-read per job:
                # VPROXY_TPU_INSTALL_PACE=0 disables (tests, batch
                # loads with no concurrent serving). Applied ONLY
                # when the serving path was active in the last few
                # seconds (note_serving) — an idle batch apply
                # builds at full speed.
                set_build_pacing(float(os.environ.get(
                    "VPROXY_TPU_INSTALL_PACE", "6"))
                    if serving_recent() else 0.0)
                t0 = time.monotonic()
                time.sleep(0)  # explicit preemption point pre-compile
                matcher._install(args)
                _swap_hist().observe((time.monotonic() - t0) * 1e3)
            except MemoryError as e:
                # OOM keeps the log-then-die contract (utils/oom), but
                # the waiters must still see a FAILED install — a
                # survivor embedding without the oom handler would
                # otherwise ack a mutation that never landed
                exc = e
                raise
            except BaseException as e:  # noqa: BLE001 — ticketed
                exc = e
                _log.error("standby table install failed; serving "
                           "generation unchanged", exc=True)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()
                for t in tickets:
                    t.exc = exc
                    t.ev.set()


def flush_installs(timeout: Optional[float] = None) -> bool:
    """Convenience: wait for all pending generation installs (no-op
    when the installer never started)."""
    inst = TableInstaller._instance
    return True if inst is None else inst.flush(timeout)


# --------------------------------------------- fused classify+pick entry
#
# ops/fused.py packs the compiled hash tables (one meta row + one byte
# row per rule, one slot row per cuckoo slot); the fused entry answers
# (verdict, pick) for a batch in ONE launch — the hand-written CUDA
# kernel on the GPU (ops/fused_cuda.py), the plain torch tier on the
# CPU. The packed tables are built INSIDE the matcher's standby compile,
# so they publish in the same atomic swap as everything else.

def fused_enabled() -> bool:
    """VPROXY_TPU_FUSED (default on): build packed tables on "torch"
    matchers and serve classify+pick from the fused one-launch entry.
    Off restores the two-dispatch chain, which runs only on the CPU: a
    CUDA matcher refuses to publish with it off (on the card the fused
    kernel is the one classify+pick path)."""
    return os.environ.get("VPROXY_TPU_FUSED", "1") != "0"


def fused_kernel_name(device=None) -> str:
    """Which tier serves fused batches on `device` (default: the
    serving device): "cuda" for the hand kernel, "torch" for the plain
    tier (CPU tensors). A stat read never builds a kernel."""
    return "cuda" if default_device(device).type == "cuda" else "torch"


def fused_dispatch(hm, hsnap: tuple, mm, msnap: tuple, hints,
                   ips: Sequence[bytes],
                   ports: Optional[Sequence[int]] = None,
                   pad_to: Optional[int] = None):
    """ONE launch answering (verdict, pick) for a batch: encoded hint
    queries + host-side Maglev slots into the fused entry against one
    (hint, maglev) snapshot pair. Returns the int32 [B, 2] device tensor
    (not yet pulled), or None when the fused path is unavailable for
    these snapshots (host backend, an empty table, VPROXY_TPU_FUSED=0
    on the CPU) — callers take the two-dispatch chain."""
    if not hints or len(hints) != len(ips):
        return None
    fd = hsnap[5] if len(hsnap) > 5 else None
    if fd is None or not hsnap[2]:
        return None
    mtab, mdev = msnap[0], msnap[1]
    if mtab is None or mdev is None:
        return None
    note_serving()
    q = _fused_hint_q(hsnap[0], hints, pad_to)
    q["slots"] = _fused_slots(mtab, ips, ports, q["hostb"].shape[0])
    qd = tables_from_reference(q, fd["pk_meta"].device)
    slots = qd.pop("slots")
    from ..ops import fused_cuda as FC
    note_launch()
    _FUSED_DISP[0] += 1
    return FC.fused_classify_pick(fd, qd, mdev, slots)


def _fused_hint_q(tab, hints, pad_to: Optional[int]) -> dict:
    q = H.encode_hint_queries(hints, tab, pad_to=pad_to or 0)
    if pad_to and q["hostb"].shape[0] < pad_to:
        q = _pad_hint_q(q, pad_to, _PAD_CUCKOO)
    return q


def _fused_slots(mtab, ips, ports, cap: int) -> np.ndarray:
    """Host-side Maglev slots (maglev.flow_slots — THE one copy of the
    slot-hash contract, so fused picks are bit-identical to every
    other pick plane); pad rows ride slot 0 and are sliced off by the
    caller."""
    from .maglev import flow_slots
    slots = flow_slots(len(mtab), ips, ports)
    if cap > len(slots):
        slots = np.concatenate([slots, np.zeros(cap - len(slots),
                                                np.int64)])
    return slots


class HintMatcher:
    """Device-backed (or host) Upstream/DNS hint matcher."""

    _kind = "hint"

    def __init__(self, rules: Sequence[HintRule] = (),
                 backend: Optional[str] = None, payload=None, device=None):
        self.backend = backend or default_backend()
        if self.backend not in ("torch", "host"):
            raise ValueError(f"unknown hint backend {self.backend!r} "
                             f"(this package serves 'torch' and 'host')")
        self.device = default_device(device) \
            if self.backend == "torch" else None
        self._rules: list[HintRule] = list(rules)
        self._dev: Optional[dict] = None
        self._tab = None  # hash-path table meta
        self._caps: Optional[dict] = None
        self.generation = 0  # bumps on every publish (atomic swap)
        # (tab, dev, rules, payload, index, fused) published as ONE
        # tuple so concurrent readers (the ClassifyService dispatcher)
        # never see a torn table/rule/payload version across a
        # set_rules() swap; `payload` is an opaque owner-supplied object
        # versioned WITH the rules; `index` is the O(probes) host-side
        # HintIndex lone queries are answered from (rules/index.py);
        # `fused` the packed tables of the fused entry
        self._pub: tuple = (None, None, [], payload, None, None)
        self._payload = payload
        self._recompile()
        with _gen_lock:
            _MATCHERS.add(self)

    @property
    def rules(self) -> list[HintRule]:
        return list(self._pub[2])  # the PUBLISHED generation

    def set_rules(self, rules: Sequence[HintRule], payload=None,
                  wait: bool = True) -> None:
        """Install a new rule generation via the background
        TableInstaller (standby compile + atomic publish). wait=True
        (default) blocks THIS caller until the publish — dispatchers
        never block either way."""
        t = TableInstaller.get().submit(self, (list(rules), payload))
        if wait:
            t.ev.wait()
            if t.exc is not None:
                raise t.exc

    def _install(self, args: tuple) -> None:
        """TableInstaller worker entry: compile + publish one standby
        generation. Transactional: a failed compile restores the
        serving rule list."""
        rules, payload = args
        old = (self._rules, self._payload, self._tab, self._dev,
               self._caps)
        self._rules = list(rules)
        self._payload = payload
        try:
            self._recompile()
        except BaseException:
            (self._rules, self._payload, self._tab, self._dev,
             self._caps) = old
            raise

    def published_table_bytes(self) -> int:
        """Device bytes of the published generation's table arrays."""
        dev = self._pub[1]
        if not dev:
            return 0
        return int(sum(v.numel() * v.element_size() for v in dev.values()))

    def _recompile(self) -> None:
        fused_dev = None
        if self.backend == "torch":
            on_card, fuse = self.device.type != "cpu", fused_enabled()
            if on_card and not fuse:
                raise ValueError(
                    "VPROXY_TPU_FUSED=0 selects the unfused chain, which "
                    "serves only CPU tensors: on the card classify+pick "
                    "runs through the fused CUDA kernel")
            self._tab = H.compile_hint_hash(self._rules, caps=self._caps)
            self._caps = self._tab.caps
            self._dev = tables_from_reference(self._tab.arrays, self.device)
            if fuse:
                from ..ops import fused as F
                fused_dev = tables_from_reference(
                    F.pack_hint_table(self._tab.arrays), self.device)
            if on_card:
                # checked once per publish, and the kernel built: a
                # build failure stops the publish (KernelError)
                from ..ops import fused_cuda as FC
                fused_dev = FC.prepare_table(fused_dev)
        idx = None
        # small tables answer lone queries with the linear oracle, so
        # the index build only pays for itself past SMALL_TABLE
        if len(self._rules) > SMALL_TABLE:
            from .index import HintIndex
            idx = HintIndex(self._rules)
        # the standby upload lands BEFORE the publish swap: the install
        # thread pays the transfer wait, never a serving thread
        sync(self.device)
        time.sleep(0)  # preemption point between compile and publish
        self._pub = (self._tab, self._dev, list(self._rules), self._payload,
                     idx, fused_dev)
        self.generation += 1
        with _gen_lock:
            _GENERATION[0] += 1

    def fused_stat(self) -> dict:
        """Fused-dispatch state for the operator surfaces: packed-table
        availability, device bytes, serving kernel tier."""
        fd = self._pub[5]
        if fd is None:
            return {"available": False}
        return {"available": True,
                "kernel": fused_kernel_name(fd["pk_meta"].device),
                "packed_bytes": int(sum(v.numel() * v.element_size()
                                        for v in fd.values()))}

    def match(self, hints: Sequence[Hint]) -> np.ndarray:
        """-> int32 [B] matched rule index, -1 for none."""
        return to_host(self.dispatch_snap(self._pub, hints))

    def match_one(self, hint: Hint) -> int:
        # PUBLISHED rules, never self._rules: a standby install mutates
        # the latter before the atomic publish
        pub = self._pub
        if self.backend != "host" and len(pub[2]) <= SMALL_TABLE:
            return oracle.search(pub[2], hint)
        return int(self.match([hint])[0])

    # ---- ClassifyService API (rules/service.py) ----

    def size(self) -> int:
        return len(self._pub[2])

    def snapshot(self) -> tuple:
        """One consistent (table, device, rules, payload, index, fused)
        generation."""
        return self._pub

    @staticmethod
    def snap_payload(snap: tuple):
        return snap[3]

    def oracle_snap(self, snap: tuple, hint: Hint) -> int:
        return oracle.search(snap[2], hint)

    def index_snap(self, snap: tuple, hint: Hint) -> int:
        """O(probes) host lookup against the snapshot's HintIndex (same
        winner as oracle_snap); the linear oracle when the snapshot has
        no index (small tables)."""
        note_serving()
        idx = snap[4]
        if idx is None:
            return oracle.search(snap[2], hint)
        return idx.lookup(hint)

    def dispatch_snap(self, snap: tuple, hints: Sequence[Hint],
                      pad_to: Optional[int] = None):
        """Encode + submit one batch against the snapshotted table
        generation: an int32 [cap] device tensor (to_host() it to
        block). pad_to: target batch shape (a pad_batch bucket); only
        the real hints are encoded, pad rows are invalid-probe fills."""
        note_serving()
        tab, dev, rules = snap[0], snap[1], snap[2]
        if not rules or not hints:
            return np.full(len(hints), -1, np.int32)
        if self.backend == "host":
            return np.array([oracle.search(rules, h) for h in hints],
                            np.int32)
        note_launch()
        q = tables_from_reference(_fused_hint_q(tab, hints, pad_to),
                                  self.device)
        idx, _ = H.hint_hash_match(dev, q)
        return idx
