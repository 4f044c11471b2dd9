"""Classify engine — the runtime seam between rule owners and kernels.

The port of `vproxy_tpu/rules/engine.py` for the hint, CIDR (routes and
ACL) and Maglev serving paths. Backends (`backend=`, default from
VPROXY_TPU_MATCHER):

* "torch" — DEFAULT: cuckoo-hash classify (ops/hashmatch) on the
            serving device, plus the packed tables the CUDA kernels
            read (ops/fused, ops/fused_cuda, ops/cidr_cuda). CPU tensors
            take the plain torch tiers; on the card the hint verdict
            (B3), hint+pick, CIDR and the 3-column sweep run the hand
            kernels.
* "torch-fp" — the packed-fingerprint tables (ops/fphash, the
            reference's "jax-fp"): one slot row per probe, verified by a
            64-bit fingerprint pair. CPU tensors take the plain torch
            tier; on the card hint batches launch B6 and cidr batches B7
            (ops/fphash_cuda). It fuses nothing: classify+pick is B6
            plus the Maglev take, the reference's two-dispatch chain.
* "torch-dense" — the dense bit-plane tables (ops/tables, the
            reference's "jax-dense"): every query against every rule,
            the brute-force cross-check. CPU tensors take the plain
            torch tier (ops/matchers, the bit-plane product); on the
            card hint and cidr batches launch B9 (ops/dense_cuda) over a
            packed word layout published beside the reference's arrays.
            It fuses nothing: classify+pick is B9 plus the Maglev take
            (B5), the reference's two-dispatch chain.
* "torch-sharded" — the cuckoo-hash tables sharded over the rules axis
            of a shard-slot mesh (parallel/mesh.py, the reference's
            "jax-sharded"): a contiguous rule slice per shard compiled
            into its own table under one unified caps dict, stacked on
            the serving device. A batch is ONE launch of B8
            (ops/sharded_cuda.py) over every shard of the process, which
            decides the winner in the kernel; where the rules axis spans
            ranks, its keys go through one all_reduce. CPU tensors take
            its plain version. Rule updates reuse the caps; an update
            that outgrows them (ops.hashmatch.CapsExceeded) rebuilds.
* "torch-fp-sharded" — the fingerprint tables over the same mesh
            (the reference's "jax-fp-sharded"), B8's fingerprint form.
* "host"  — the pure-Python oracle (correctness floor + latency floor
            for tiny tables).

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
import torch

from ..ops import hashmatch as H
from ..ops import tables as T
from ..utils import trace
from ..utils.log import Logger
from ..utils.torchenv import (default_device, sync, tables_from_reference,
                              to_host)
from . import oracle
from .ir import AclRule, Hint, HintRule

_log = Logger("engine")


BACKENDS = ("torch", "torch-fp", "torch-dense", "torch-sharded",
            "torch-fp-sharded", "host")
# the ones with a serving device
DEVICE_BACKENDS = ("torch", "torch-fp", "torch-dense", "torch-sharded",
                   "torch-fp-sharded")
SHARDED_BACKENDS = ("torch-sharded", "torch-fp-sharded")
# the unfused ones: a classify+pick batch is ONE launch of the hint
# kernel with its Maglev column (HintMatcher.dispatch_pick_snap)
PICK_BACKENDS = ("torch-fp", "torch-dense") + SHARDED_BACKENDS

# VPROXY_TPU_MATCHER (and VPROXY_TPU_MESH_BACKEND) speak the
# reference's names; this package serves each under its own. Any other
# value serves "torch".
_MATCHER_ENV = {"host": "host", "jax": "torch", "jax-fp": "torch-fp",
                "jax-dense": "torch-dense", "jax-sharded": "torch-sharded",
                "jax-fp-sharded": "torch-fp-sharded"}


def _check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (this package "
                         f"serves {', '.join(map(repr, BACKENDS))})")
    return backend


def mesh_serving() -> bool:
    """True when matchers without an explicit backend should serve
    sharded over the shard-slot mesh. VPROXY_TPU_MESH_SERVE: "1"/"on"
    forces it, "0"/"off" disables, "auto" (default) shards whenever the
    mesh spans more than one REAL card (the ranks of a torch.distributed
    job on CUDA, one card each): the reference's rule, where virtual
    CPU devices are opt-in. On the CPU, or on one card, several shard
    slots share one device: they buy nothing a single table does not,
    so "auto" keeps "torch"."""
    mode = os.environ.get("VPROXY_TPU_MESH_SERVE", "auto")
    if mode in ("0", "off", "no"):
        return False
    from ..parallel.mesh import _world
    if _world()[1] <= 1:
        return False
    if mode in ("1", "on", "yes"):
        return True
    try:
        return default_device().type == "cuda"
    except RuntimeError:
        return False


def default_backend() -> str:
    """VPROXY_TPU_MATCHER, read as the reference reads it: "host"
    selects the oracle, "jax-fp" the fingerprint backend ("torch-fp"),
    "jax-dense" the dense backend ("torch-dense"), "jax-sharded" and
    "jax-fp-sharded" the sharded ones ("torch-sharded",
    "torch-fp-sharded"), every other value the cuckoo backend ("torch",
    the counterpart of "jax"). Unset: the sharded backend
    (VPROXY_TPU_MESH_BACKEND, default "jax-sharded") when mesh_serving()
    says the mesh should carry the tables, else "torch"."""
    env = os.environ.get("VPROXY_TPU_MATCHER", "")
    if env:
        return _MATCHER_ENV.get(env, "torch")
    if mesh_serving():
        return _MATCHER_ENV.get(
            os.environ.get("VPROXY_TPU_MESH_BACKEND", "jax-sharded"),
            "torch")
    return "torch"


_MESH: Optional[tuple] = None  # (world, batch, device) -> Mesh


def default_mesh(device=None):
    """Process-wide (batch, rules) mesh for the sharded matchers: one
    shard slot per real card (the job's ranks; one on a one-card host),
    the batch axis from VPROXY_TPU_MESH_BATCH (default 1 = rules-only).

    Keyed on the CURRENT job size, batch knob and device, not cached
    forever: a late torch.distributed bring-up must produce a fresh
    mesh, not silently serve the stale one."""
    global _MESH
    from ..parallel import mesh as M
    batch = int(os.environ.get("VPROXY_TPU_MESH_BATCH", "1"))
    key = (M._world(), batch, default_device(device))
    if _MESH is None or _MESH[0] != key:
        _MESH = (key, M.make_mesh(batch=batch, device=key[2]))
    return _MESH[1]


def pad_batch(n: int, mult: int = 1, lo: int = 16) -> int:
    """Batch-shape bucket: pow2 growth from `lo`, rounded up to a
    multiple of `mult` (the mesh's batch-axis size, so the axis always
    divides the padded batch). ClassifyService uses these buckets
    (mult=1) so the device sees few batch shapes."""
    c = lo
    while c < n:
        c <<= 1
    return -(-c // mult) * mult


# Below this rule count, single (unbatched) queries run on the host oracle:
# a python scan over a handful of rules is ~1us while a device dispatch
# costs a launch plus a device round trip — the device path wins only for
# big tables or batched queries. The device table is still compiled and
# kept in sync (used by match() batches).
SMALL_TABLE = int(os.environ.get("VPROXY_TPU_SMALL_TABLE", "128"))


def _install_phase(tid: int, span: str, t0_ns: int, **fields) -> None:
    """One standby-install phase span (compile / upload / swap) on the
    installer's trace (utils/trace) — tid 0 (constructor compiles, or
    tracing off) records nothing."""
    if tid:
        trace.record_span(tid, "install", span, t0_ns,
                          time.monotonic_ns() - t0_ns, **fields)


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
#   vproxy_engine_table_bytes{matcher="hint"|"cidr"} — device bytes of
#                                   every live matcher's published table

_gen_lock = threading.Lock()
_GENERATION = [0]
_MATCHERS: "weakref.WeakSet" = weakref.WeakSet()
_LAST_SERVE = [0.0]  # monotonic ts of the last serving-path read
_LAUNCHES = [0]      # device launches on the dispatch path (per batch)
_FUSED_DISP = [0]    # of which: fused one-launch dispatches
_BY_KIND: dict = {}  # the same launches by kind ("hint", "cpick", ...)
_kind_lock = threading.Lock()


def note_serving() -> None:
    """Serving-path breadcrumb (one float store): the installer only
    PACES standby compiles when there is serving latency to protect."""
    _LAST_SERVE[0] = time.monotonic()


def serving_recent(window_s: float = 5.0) -> bool:
    return time.monotonic() - _LAST_SERVE[0] < window_s


def generation_total() -> int:
    return _GENERATION[0]


def note_launch(n: int = 1, kind: str = "", fused: bool = False) -> None:
    """Count one device program on the dispatch path (a lock-free int
    store race can only lose a count, never corrupt): fused batches, and
    the classify+pick batches of the unfused device backends (one launch
    with the Maglev column), move vproxy_engine_dispatch_launches_total
    by exactly 1; the "host" backend's chain by one per chained op.

    Tracing (utils/trace): when the calling thread carries a sampled
    request's trace context, every launch site also drops a `launch`
    marker span, so a trace shows how many programs a batch cost. One
    branch when no context is bound."""
    _LAUNCHES[0] += n
    with _kind_lock:
        _BY_KIND[kind] = _BY_KIND.get(kind, 0) + n
    tid = trace.current_id()
    if tid:
        trace.record_span(tid, "engine", "launch", time.monotonic_ns(),
                          0, kind=kind, fused=fused)


def dispatch_launches_total() -> int:
    return _LAUNCHES[0]


def dispatches_by_kind() -> dict:
    """The dispatch-path launches counted so far, by note_launch's kind
    ("hint", "cpick", "all", "cidr"; "" for a standalone Maglev
    take). On "torch" each of them is one CUDA launch on the card: B3
    for "hint", B1 for "cpick" and "all", B4 for "cidr"."""
    with _kind_lock:
        return dict(_BY_KIND)


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
                # installs are rare: when tracing is on, EVERY install
                # gets its own trace — _recompile's phase spans
                # (compile / upload / swap) attach through the bound
                # context
                itid = trace.new_trace_id() if trace.enabled() else 0
                with trace.bind(itid):
                    matcher._install(args)
                if itid:
                    trace.record_span(
                        itid, "install", "install", int(t0 * 1e9),
                        int((time.monotonic() - t0) * 1e9),
                        matcher=getattr(matcher, "_kind", "?"))
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


def _fused_stat(fd: Optional[dict]) -> dict:
    """Packed-table state for the operator surfaces: availability,
    device bytes, serving kernel tier."""
    if fd is None:
        return {"available": False}
    dev = next(iter(fd.values())).device
    return {"available": True, "kernel": fused_kernel_name(dev),
            "packed_bytes": int(sum(v.numel() * v.element_size()
                                    for v in fd.values()))}


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
    qd = _upload_q(q, fd["pk_meta"].device)
    slots = qd.pop("slots")
    from ..ops import fused_cuda as FC
    note_launch(kind="cpick", fused=True)
    _FUSED_DISP[0] += 1
    return FC.fused_classify_pick(fd, qd, mdev, slots)


def fused_dispatch_all(hm, hsnap: tuple, cm, csnap: tuple, mm,
                       msnap: tuple, hints, addrs: Sequence[bytes],
                       ips: Sequence[bytes],
                       ports: Optional[Sequence[int]] = None,
                       pad_to: Optional[int] = None):
    """The full fused sweep: hint verdict + Maglev pick + CIDR/LPM
    route, ONE launch, int32 [B, 3] (verdict, pick, route): the CUDA
    kernel's route column on the card, the plain tier on the CPU.
    Route queries carry no ACL port gate (route-table semantics,
    ports=None in CidrMatcher.dispatch_snap); `ports` are the Maglev
    source ports. None when either packed table is missing (the host
    backend, an empty table, VPROXY_TPU_FUSED=0 on the CPU) — callers
    take the op chain."""
    if not hints or len(hints) != len(addrs) or len(hints) != len(ips):
        return None
    fd = hsnap[5] if len(hsnap) > 5 else None
    cfd = csnap[6] if len(csnap) > 6 else None
    if fd is None or cfd is None or not hsnap[2] or not csnap[1]:
        return None
    mtab, mdev = msnap[0], msnap[1]
    if mtab is None or mdev is None:
        return None
    note_serving()
    q = _fused_hint_q(hsnap[0], hints, pad_to)
    cap = q["hostb"].shape[0]
    q["slots"] = _fused_slots(mtab, ips, ports, cap)
    a16, fam, _ = _cidr_q(addrs, None, cap)
    q["a16"], q["fam"] = a16, fam
    qd = _upload_q(q, fd["pk_meta"].device)
    slots, a16, fam = qd.pop("slots"), qd.pop("a16"), qd.pop("fam")
    from ..ops import fused_cuda as FC
    note_launch(kind="all", fused=True)
    _FUSED_DISP[0] += 1
    return FC.fused_classify_pick(fd, qd, mdev, slots, cfd, a16, fam, None)


# A batch's host phases on the dispatch path are spans of the trace bound
# on the calling thread (ClassifyService binds the batch's first sampled
# request; none is bound with tracing off, and each site then costs a
# thread-local read and one check): engine/encode (the queries' encode,
# pad rows included, `batch` = the real queries), engine/flow_slots (the
# Maglev slots on the host) and engine/upload (the batch's query arrays
# to the serving device: `copies`, `bytes`).

def _cidr_q(addrs: Sequence[bytes], ports: Optional[Sequence[int]],
            cap: Optional[int]) -> tuple:
    """Encoded CIDR queries padded to `cap` rows: -> (a16 u8 [cap, 16],
    fam i32 [cap], port i32 [cap] or None). Pad rows carry family -1,
    which matches no group. The engine/encode span."""
    tid = trace.current_id()
    sp = trace.Span(tid, "engine", "encode") if tid else None
    a16, fam = T.encode_ips(addrs)
    p = None if ports is None else np.asarray(ports, np.int32)
    if cap and cap > a16.shape[0]:
        k = cap - a16.shape[0]
        a16 = np.concatenate([a16, np.zeros((k, 16), a16.dtype)])
        fam = np.concatenate([fam, np.full(k, -1, fam.dtype)])
        if p is not None:
            p = np.concatenate([p, np.zeros(k, p.dtype)])
    if sp:
        sp.end(batch=len(addrs))
    return a16, fam, p


def _fused_hint_q(tab, hints, pad_to: Optional[int]) -> dict:
    """The cuckoo encode of a hint batch, padded to `pad_to` rows: the
    engine/encode span."""
    tid = trace.current_id()
    sp = trace.Span(tid, "engine", "encode") if tid else None
    q = H.encode_hint_queries(hints, tab, pad_to=pad_to or 0)
    if pad_to and q["hostb"].shape[0] < pad_to:
        q = _pad_hint_q(q, pad_to, _PAD_CUCKOO)
    if sp:
        sp.end(batch=len(hints))
    return q


def _fused_slots(mtab, ips, ports, cap: int) -> np.ndarray:
    """Host-side Maglev slots (maglev.flow_slots — THE one copy of the
    slot-hash contract, so fused picks are bit-identical to every
    other pick plane); pad rows ride slot 0 and are sliced off by the
    caller. The engine/flow_slots span."""
    from .maglev import flow_slots
    tid = trace.current_id()
    sp = trace.Span(tid, "engine", "flow_slots") if tid else None
    slots = flow_slots(len(mtab), ips, ports)
    if cap > len(slots):
        slots = np.concatenate([slots, np.zeros(cap - len(slots),
                                                np.int64)])
    if sp:
        sp.end(batch=len(ips))
    return slots


def _upload_q(q: dict, device) -> dict:
    """tables_from_reference of one batch's query arrays: the
    engine/upload span."""
    tid = trace.current_id()
    sp = trace.Span(tid, "engine", "upload") if tid else None
    qd = tables_from_reference(q, device)
    if sp:
        sp.end(copies=len(q), bytes=sum(v.nbytes for v in q.values()))
    return qd


def _with_slots(q: dict, pick, cap: int) -> dict:
    """An encoded hint batch with its Maglev column's flow slots
    (`pick`: (mtab, device table, ips, ports), or None: `q` as it is)
    as q["slots"], padded to `cap` rows (_fused_slots), so they go up
    with the probe arrays."""
    if pick is not None:
        q = dict(q)
        q["slots"] = _fused_slots(pick[0], pick[2], pick[3], cap)
    return q


def _dense_table(arrays: dict, device):
    """A dense table's arrays on the serving device as the reference
    publishes them (its engine._to_device): the 2-D float32 bit-plane
    weights in bfloat16 (exact: every weight is -1, 0 or 1), so the
    published bytes are the reference's; the rest as they are."""
    from ..ops.dense_cuda import DenseTable
    dev = default_device(device)
    active = arrays.get("active")
    return DenseTable({
        k: (_bf16_planes(v, active) if v.dtype == np.float32 and v.ndim == 2
            else torch.from_numpy(np.ascontiguousarray(v))).to(dev)
        for k, v in arrays.items()})


def _bf16_planes(w: np.ndarray, active) -> torch.Tensor:
    """Bit-plane weights [K, N] float32 -> bfloat16 (exact). `active`: a
    hint table's rule flags (None for a cidr table). When under half its
    rules are active, only their columns (N / cap of them a rule) are
    converted, into zeros whose pages stay untouched: an inactive rule's
    columns are zero, so a few live rules among many inactive ones (a
    sparse rule list) cost their own columns, not all N."""
    if active is None:
        return torch.from_numpy(w).to(torch.bfloat16)
    live = np.flatnonzero(active)
    if live.size * 2 >= active.shape[0]:
        return torch.from_numpy(w).to(torch.bfloat16)
    per = w.shape[1] // active.shape[0]
    cols = (live[:, None] * per + np.arange(per)).reshape(-1)
    out = torch.from_numpy(np.zeros(w.shape, np.uint16)).view(torch.bfloat16)
    out[:, torch.from_numpy(cols)] = torch.from_numpy(
        np.ascontiguousarray(w[:, cols])).to(torch.bfloat16)
    return out


class _StackDev(dict):
    """A sharded matcher's published table: this rank's shards of the
    stacked arrays on the serving device (name -> [S, ...] tensor; the
    plain version's input, and what published_table_bytes counts), and
    on the card `kernel`, B8's prepared stack (ops/sharded_cuda.py: the
    packed cuckoo layout beside them, or these fingerprint arrays)."""

    kernel = None


def _card_upload(device, matcher: str, fn):
    """fn() -> its result (a batch's tensors on `device`). On the card a
    failure is the card's, never the host's: KernelError."""
    try:
        return fn()
    except MemoryError:
        raise
    except Exception as e:
        if device.type == "cpu":
            raise
        from ..ops.fused_cuda import KernelError
        raise KernelError(f"{matcher} batch upload failed: {e!r}") from e


class HintMatcher:
    """Device-backed (or host) Upstream/DNS hint matcher."""

    _kind = "hint"

    def __init__(self, rules: Sequence[HintRule] = (),
                 backend: Optional[str] = None, payload=None, device=None,
                 mesh=None):
        self.backend = _check_backend(backend or default_backend())
        self.device = default_device(device) \
            if self.backend in DEVICE_BACKENDS else None
        if mesh is not None and self.device is not None:
            self.device = mesh.device  # the mesh's slots live there
        self._rules: list[HintRule] = list(rules)
        self._dev: Optional[dict] = None
        self._tab = None  # hash-path table meta
        self._caps: Optional[dict] = None
        self._mesh = mesh  # sharded backends only (lazily defaulted)
        self._fn = None    # sharded: the mesh's hint fn
        self._pick_fn = None  # sharded: its classify+pick fn
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
        self._cksum = None  # (pub-tuple, crc32) cache — see checksum()
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
        itid = trace.current_id()  # nonzero only under a traced install
        t_ph = time.monotonic_ns() if itid else 0
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
        elif self.backend == "torch-fp":
            from ..ops import fphash as FP
            try:
                self._tab = FP.compile_hint_fp(self._rules, caps=self._caps)
            except H.CapsExceeded:
                # the update outgrew the reused shapes: a fresh build
                self._tab = FP.compile_hint_fp(self._rules)
            self._caps = self._tab.caps
            self._dev = tables_from_reference(self._tab.arrays, self.device)
            if self.device.type != "cpu":
                # checked once per publish, and B6 built: a build
                # failure stops the publish (KernelError)
                from ..ops import fphash_cuda as FPC
                self._dev = FPC.prepare_hint_table(self._dev)
        elif self.backend in SHARDED_BACKENDS:
            self._recompile_sharded()
        elif self.backend == "torch-dense":
            # the cap is reused while the rules fit, as the reference's
            cap = self._dev["active"].shape[0] if self._dev is not None \
                else None
            if cap is not None and len(self._rules) > cap:
                cap = None  # outgrew capacity: the compiler picks a bucket
            from ..ops import dense_cuda as DC
            from ..ops.matchers import table_arrays
            arrays = table_arrays(T.compile_hint_rules(self._rules, cap=cap))
            self._dev = _dense_table(arrays, self.device)
            if self.device.type != "cpu":
                # the packed layout B9 reads, checked once per publish,
                # and B9 built: a build failure stops the publish
                self._dev.packed = DC.prepare_hint(tables_from_reference(
                    DC.pack_dense_hint_table(arrays), self.device))
        idx = None
        # small tables answer lone queries with the linear oracle, so
        # the index build only pays for itself past SMALL_TABLE
        if len(self._rules) > SMALL_TABLE:
            from .index import HintIndex
            idx = HintIndex(self._rules)
        _install_phase(itid, "compile", t_ph, matcher="hint",
                       rules=len(self._rules))
        t_ph = time.monotonic_ns() if itid else 0
        # the standby upload lands BEFORE the publish swap: the install
        # thread pays the transfer wait, never a serving thread
        sync(self.device)
        _install_phase(itid, "upload", t_ph, matcher="hint")
        time.sleep(0)  # preemption point between compile and publish
        t_ph = time.monotonic_ns() if itid else 0
        self._pub = (self._tab, self._dev, list(self._rules), self._payload,
                     idx, fused_dev)
        self.generation += 1
        with _gen_lock:
            _GENERATION[0] += 1
        _install_phase(itid, "swap", t_ph, matcher="hint",
                       generation=self.generation)

    def _recompile_sharded(self) -> None:
        """The sharded backends' compile: S contiguous rule slices under
        one unified caps dict (reused across updates; an update that
        outgrows them rebuilds), this rank's shards uploaded, and on the
        card B8's stack prepared (the packed cuckoo layout, or the
        fingerprint arrays themselves), which also builds B8."""
        from ..ops import fphash as FP
        from ..ops import sharded_cuda as SC
        from ..parallel import mesh as M
        if self._mesh is None:
            self._mesh = default_mesh(self.device)
        shards = self._mesh.shape["rules"]
        fp = self.backend == "torch-fp-sharded"
        compile_sharded = FP.compile_hint_fp_sharded if fp \
            else H.compile_hint_hash_sharded
        try:
            self._tab = compile_sharded(self._rules, shards, caps=self._caps)
        except H.CapsExceeded:
            # the update outgrew the reused shapes: a fresh build
            self._tab = compile_sharded(self._rules, shards)
        self._caps = self._tab.shards[0].caps
        dev = _StackDev(M.shard_hash_table(self._tab, self._mesh))
        if self.device.type != "cpu":
            dev.kernel = SC.prepare_fp_hint(dev) if fp else SC.prepare_hint(
                M.shard_hash_table(self._tab, self._mesh,
                                   SC.pack_hint_sharded(self._tab.arrays)))
        self._dev = dev
        # memory-lean: the stacked host copy is dead weight once the
        # device holds the shards
        M.release_host(self._tab)

    def fused_stat(self) -> dict:
        """Fused-dispatch state for the operator surfaces: packed-table
        availability, device bytes, serving kernel tier."""
        return _fused_stat(self._pub[5])

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

    def checksum(self) -> int:
        """u32 checksum of the published rule generation: the cluster
        replication gate compares it across hosts, so it is the
        reference's (crc32 over the rule reprs, independent of the
        caps-growth history); cached per published generation."""
        pub = self._pub
        cached = self._cksum
        if cached is not None and cached[0] is pub:
            return cached[1]
        import zlib
        v = zlib.crc32("\n".join(map(repr, pub[2])).encode())
        self._cksum = (pub, v)
        return v

    def snapshot(self) -> tuple:
        """One consistent (table, device, rules, payload, index, fused)
        generation."""
        return self._pub

    @staticmethod
    def snap_payload(snap: tuple):
        return snap[3]

    def oracle_snap(self, snap: tuple, hint: Hint) -> int:
        return oracle.search(snap[2], hint)

    def oracle_one(self, hint: Hint) -> int:
        return self.oracle_snap(self._pub, hint)

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
                      pad_to: Optional[int] = None, sync: bool = True):
        """Encode + submit one batch against the snapshotted table
        generation: an int32 [cap] device tensor (to_host() it to
        block). pad_to: target batch shape (a pad_batch bucket); only
        the real hints are encoded, pad rows are invalid-probe fills.
        On the card, ONE launch of B3's CUDA kernel (ops/fused_cuda.py
        hint_match: B1's hint fold without the Maglev take) over the
        snapshot's packed table, or KernelError; CPU tensors take the
        torch tier (hashmatch.hint_hash_match). A "torch-fp" matcher
        launches B6 instead (_dispatch_fp), a "torch-dense" one B9
        (_dispatch_dense), a sharded one B8 (_dispatch_sharded: sync
        pulls its answer to the host before returning, [:len(hints)],
        the reference's contract; the other backends ignore it)."""
        note_serving()
        tab, dev, rules = snap[0], snap[1], snap[2]
        if not rules or not hints:
            return np.full(len(hints), -1, np.int32)
        if self.backend == "host":
            return np.array([oracle.search(rules, h) for h in hints],
                            np.int32)
        note_launch(kind="hint")
        if self.backend == "torch-fp":
            return self._dispatch_fp(tab, dev, hints, pad_to)
        if self.backend == "torch-dense":
            return self._dispatch_dense(dev, hints, pad_to)
        if self.backend in SHARDED_BACKENDS:
            return self._dispatch_sharded(tab, dev, hints, pad_to, sync)
        q = self._upload(lambda: _fused_hint_q(tab, hints, pad_to))
        if self.device.type == "cpu":
            idx, _ = H.hint_hash_match(dev, q)
            return idx
        from ..ops import fused_cuda as FC
        idx, _ = FC.hint_match(snap[5], q)
        return idx

    def dispatch_pick_snap(self, snap: tuple, msnap: tuple,
                           hints: Sequence[Hint], ips: Sequence[bytes],
                           ports: Optional[Sequence[int]] = None,
                           pad_to: Optional[int] = None, sync: bool = True):
        """ONE launch answering a classify+pick batch on an unfused
        device backend ("torch-fp", "torch-dense", "torch-sharded",
        "torch-fp-sharded"): the backend's hint kernel (B6, B9 or B8)
        with its Maglev column (B5's take folded in), against the
        snapshot pair (snap, msnap: a MaglevMatcher's). The flow slots
        (maglev.flow_slots, the one slot-hash contract; pad rows slot
        0) go up with the batch's probe arrays. -> int32 [cap, 2]
        (verdict, pick) rows on the device (to_host() to block); a
        sharded batch with `sync` is pulled here, [:len(hints)] (see
        dispatch_snap). CPU tensors take each kernel's plain version.
        None where there is no such launch (the "host" and "torch"
        backends, no rules, no Maglev table): callers take the
        two-dispatch chain."""
        if self.backend not in PICK_BACKENDS or not hints or \
                len(hints) != len(ips):
            return None
        tab, dev, rules = snap[0], snap[1], snap[2]
        mtab, mdev = msnap[0], msnap[1]
        if not rules or mtab is None or mdev is None:
            return None
        note_serving()
        note_launch(kind="cpick")
        pick = (mtab, mdev, ips, ports)
        if self.backend == "torch-fp":
            return self._dispatch_fp(tab, dev, hints, pad_to, pick)
        if self.backend == "torch-dense":
            return self._dispatch_dense(dev, hints, pad_to, pick)
        return self._dispatch_sharded(tab, dev, hints, pad_to, sync, pick)

    def _dispatch_fp(self, tab, dev, hints, pad_to: Optional[int],
                     pick=None):
        """A "torch-fp" batch: the fingerprint encode (pad rows zero:
        no probe is live), then B6 on the card, the plain tier on the
        CPU. The member mode is resolved per dispatch, as the reference
        resolves it (checked; both compute the one function its three
        lowerings agree on). `pick` (mtab, device table, ips, ports):
        the batch's Maglev column -> int32 [cap, 2] (fphash_cuda
        hint_fp_pick)."""
        from ..ops import fphash as FP
        from ..ops import fphash_cuda as FPC
        mode = FP.default_member_mode()

        def encode():
            tid = trace.current_id()
            sp = trace.Span(tid, "engine", "encode") if tid else None
            q = FP.encode_hint_queries_fp(hints, tab)
            if pad_to and pad_to > len(hints):
                q = _pad_hint_q(q, pad_to, {})
            if sp:
                sp.end(batch=len(hints))
            return _with_slots(q, pick, q["hp_slot"].shape[0])
        q = self._upload(encode)
        if pick is not None:
            return FPC.hint_fp_pick(dev, q, pick[1], q.pop("slots"), mode)
        if self.device.type == "cpu":
            return FP.hint_fp_match(dev, q, mode)[0]
        return FPC.hint_fp_cuda(dev, q)[0]

    def _dispatch_sharded(self, tab, dev, hints, pad_to: Optional[int],
                          sync: bool, pick=None):
        """A sharded batch: padded to a multiple of the mesh's query
        shards, the single-pass sharded encode (the fingerprint one pads
        with empty Hint()s), this rank's shards' probe arrays uploaded
        (and `pick`'s flow slots, as _dispatch_fp), then B8 on the card
        (one launch), the plain version on the CPU."""
        from ..ops import fphash as FP
        from ..parallel import mesh as M
        n = len(hints)
        cap = pad_batch(max(n, pad_to or 0), M.query_shards(self._mesh))
        fp = self.backend == "torch-fp-sharded"

        def encode():
            tid = trace.current_id()
            sp = trace.Span(tid, "engine", "encode") if tid else None
            if fp:
                q = FP.encode_hint_queries_fp_sharded(
                    list(hints) + [Hint()] * (cap - n), tab)
            else:
                q = H.encode_hint_queries_sharded(hints, tab, pad_to=cap)
            if sp:
                sp.end(batch=n)
            return q

        def upload():
            q = M.shard_hint_queries_sharded(encode(), self._mesh)
            if pick is None:
                return q, None
            return q, torch.from_numpy(_fused_slots(
                pick[0], pick[2], pick[3], cap)).to(self.device)
        q, slots = _card_upload(self.device, "hint", upload)
        table = dev if self.device.type == "cpu" else dev.kernel
        kernel = FP.hint_fp_match if fp else None
        if pick is not None:
            if self._pick_fn is None:
                self._pick_fn = M.make_sharded_pick_fn(self._mesh, kernel)
            out = self._pick_fn(table, q, tab.shard_size, pick[1], slots)
        else:
            if self._fn is None:
                self._fn = M.make_sharded_hint_fn(self._mesh, kernel)
            out = self._fn(table, q, tab.shard_size)
        return to_host(out)[:n] if sync else out

    def _dispatch_dense(self, dev, hints, pad_to: Optional[int],
                        pick=None):
        """A "torch-dense" batch: pad rows as empty Hint()s, the
        reference's encode, then B9 on the card, the plain tier on the
        CPU (matchers.hint_dense; with `pick`, as _dispatch_fp,
        matchers.hint_dense_pick -> int32 [cap, 2])."""
        from ..ops import matchers as MT
        n = len(hints)
        if pad_to and pad_to > n:
            hints = list(hints) + [Hint()] * (pad_to - n)

        def encode():
            tid = trace.current_id()
            sp = trace.Span(tid, "engine", "encode") if tid else None
            q = T.encode_hints(hints)
            if sp:
                sp.end(batch=n)
            return _with_slots(q, pick, len(hints))
        q = self._upload(encode)
        if pick is not None:
            return MT.hint_dense_pick(dev, q, pick[1], q.pop("slots"))
        return MT.hint_dense(dev, q)[0]

    def _upload(self, encode) -> dict:
        """encode() -> the batch's tensors on the serving device
        (_card_upload, _upload_q)."""
        return _card_upload(self.device, "hint", lambda: (
            _upload_q(encode(), self.device)))


class CidrMatcher:
    """Device-backed ordered first-match CIDR matcher (routes / ACL)."""

    _kind = "cidr"

    def __init__(self, networks: Sequence = (),
                 backend: Optional[str] = None,
                 acl: Optional[Sequence[AclRule]] = None, payload=None,
                 device=None, mesh=None):
        self.backend = _check_backend(backend or default_backend())
        self.device = default_device(device) \
            if self.backend in DEVICE_BACKENDS else None
        if mesh is not None and self.device is not None:
            self.device = mesh.device  # the mesh's slots live there
        self._nets = list(networks)
        self._acl = list(acl) if acl is not None else None
        self._dev: Optional[dict] = None
        self._caps: Optional[dict] = None
        self._tab = None   # sharded backends: the stacked table's meta
        self._mesh = mesh  # sharded backends only (lazily defaulted)
        self._fns: dict = {}  # sharded: the mesh's fns keyed by with_port
        self.generation = 0  # bumps on every publish (atomic swap)
        # (dev, nets, acl, payload, tab, index, fused) — one atomic
        # generation (see HintMatcher._pub for the why); `tab` is the
        # sharded backends' stacked-table meta (None otherwise);
        # `fused` the packed table the CUDA kernels read
        self._pub: tuple = (None, [], None, payload, None, None, None)
        self._payload = payload
        self._cksum = None  # (pub-tuple, crc32) cache — see checksum()
        self._recompile()
        with _gen_lock:
            _MATCHERS.add(self)

    def set_networks(self, networks: Sequence,
                     acl: Optional[Sequence[AclRule]] = None,
                     payload=None, wait: bool = True) -> None:
        """Install a new generation via the background TableInstaller
        (see HintMatcher.set_rules — same standby-swap contract)."""
        t = TableInstaller.get().submit(
            self, (list(networks),
                   list(acl) if acl is not None else None, payload))
        if wait:
            t.ev.wait()
            if t.exc is not None:
                raise t.exc

    def _install(self, args: tuple) -> None:
        """See HintMatcher._install — transactional standby compile."""
        networks, acl, payload = args
        old = (self._nets, self._acl, self._payload, self._tab, self._dev,
               self._caps)
        self._nets = list(networks)
        self._acl = list(acl) if acl is not None else None
        self._payload = payload
        try:
            self._recompile()
        except BaseException:
            (self._nets, self._acl, self._payload, self._tab, self._dev,
             self._caps) = old
            raise

    def published_table_bytes(self) -> int:
        dev = self._pub[0]
        if not dev:
            return 0
        return int(sum(v.numel() * v.element_size() for v in dev.values()))

    def _recompile(self) -> None:
        itid = trace.current_id()  # nonzero only under a traced install
        t_ph = time.monotonic_ns() if itid else 0
        fused_dev = None
        if self.backend == "torch":
            tab = H.compile_cidr_hash(self._nets, acl=self._acl,
                                      caps=self._caps)
            self._caps = tab.caps
            self._dev = tables_from_reference(tab.arrays, self.device)
            on_card = self.device.type != "cpu"
            # the CUDA kernels read the packed layout, so a matcher on
            # the card packs whatever VPROXY_TPU_FUSED says
            if on_card or fused_enabled():
                from ..ops import fused as F
                fused_dev = tables_from_reference(
                    F.pack_cidr_table(tab.arrays), self.device)
            if on_card:
                # checked once per publish, and the kernel built: a
                # build failure stops the publish (KernelError)
                from ..ops import cidr_cuda as CC
                fused_dev = CC.prepare_table(fused_dev)
        elif self.backend == "torch-fp":
            from ..ops import fphash as FP
            try:
                tab = FP.compile_cidr_fp(self._nets, acl=self._acl,
                                         caps=self._caps)
            except H.CapsExceeded:
                tab = FP.compile_cidr_fp(self._nets, acl=self._acl)
            self._caps = tab.caps
            self._dev = tables_from_reference(tab.arrays, self.device)
            if self.device.type != "cpu":
                # checked once per publish, and B7 built (KernelError)
                from ..ops import fphash_cuda as FPC
                self._dev = FPC.prepare_cidr_table(self._dev)
        elif self.backend in SHARDED_BACKENDS:
            self._recompile_sharded()
        elif self.backend == "torch-dense":
            cap = self._dev["allow"].shape[0] if self._dev is not None \
                else None
            if cap is not None and len(self._nets) > cap:
                cap = None
            from ..ops import dense_cuda as DC
            from ..ops.matchers import table_arrays
            arrays = table_arrays(T.compile_cidr_rules(self._nets, cap=cap,
                                                       acl=self._acl))
            self._dev = _dense_table(arrays, self.device)
            if self.device.type != "cpu":
                # checked once per publish, and B9 built (KernelError)
                self._dev.packed = DC.prepare_cidr(tables_from_reference(
                    DC.pack_dense_cidr_table(arrays), self.device))
        idx = None
        if len(self._nets) > SMALL_TABLE:  # see HintMatcher._recompile
            from .index import CidrIndex
            idx = CidrIndex(self._nets, acl=self._acl)
        _install_phase(itid, "compile", t_ph, matcher="cidr",
                       rules=len(self._nets))
        t_ph = time.monotonic_ns() if itid else 0
        sync(self.device)  # the standby upload lands before the swap
        _install_phase(itid, "upload", t_ph, matcher="cidr")
        time.sleep(0)  # preemption point between compile and publish
        t_ph = time.monotonic_ns() if itid else 0
        self._pub = (self._dev, list(self._nets),
                     None if self._acl is None else list(self._acl),
                     self._payload, self._tab, idx, fused_dev)
        self.generation += 1
        with _gen_lock:
            _GENERATION[0] += 1
        _install_phase(itid, "swap", t_ph, matcher="cidr",
                       generation=self.generation)

    def _recompile_sharded(self) -> None:
        """See HintMatcher._recompile_sharded: each shard's ACL window
        follows its rule slice."""
        from ..ops import fphash as FP
        from ..ops import sharded_cuda as SC
        from ..parallel import mesh as M
        if self._mesh is None:
            self._mesh = default_mesh(self.device)
        shards = self._mesh.shape["rules"]
        fp = self.backend == "torch-fp-sharded"
        compile_sharded = FP.compile_cidr_fp_sharded if fp \
            else H.compile_cidr_hash_sharded
        try:
            self._tab = compile_sharded(self._nets, shards, acl=self._acl,
                                        caps=self._caps)
        except H.CapsExceeded:
            self._tab = compile_sharded(self._nets, shards, acl=self._acl)
        self._caps = self._tab.shards[0].caps
        dev = _StackDev(M.shard_hash_table(self._tab, self._mesh))
        if self.device.type != "cpu":
            dev.kernel = SC.prepare_fp_cidr(dev) if fp else SC.prepare_cidr(
                M.shard_hash_table(self._tab, self._mesh,
                                   SC.pack_cidr_sharded(self._tab.arrays)))
        self._dev = dev
        M.release_host(self._tab)

    def fused_stat(self) -> dict:
        """Packed cidr-table state (see HintMatcher.fused_stat)."""
        return _fused_stat(self._pub[6])

    def match(self, addrs: Sequence[bytes],
              ports: Optional[Sequence[int]] = None) -> np.ndarray:
        """-> int32 [B] first matching rule index (order = insert
        order), -1 for none."""
        snap = self._pub
        if self.backend == "host" and snap[1] and addrs:
            return np.array(
                [self.oracle_snap(snap, a, None if ports is None
                                  else ports[i])
                 for i, a in enumerate(addrs)], np.int32)
        return to_host(self.dispatch_snap(snap, addrs, ports))

    def _scan_one(self, addr: bytes, port: Optional[int]) -> int:
        return self.oracle_snap(self._pub, addr, port)

    def oracle_one(self, addr: bytes, port: Optional[int] = None) -> int:
        return self.oracle_snap(self._pub, addr, port)

    def match_one(self, addr: bytes, port: Optional[int] = None) -> int:
        # published-generation gate: see HintMatcher.match_one
        if self.backend != "host" and len(self._pub[1]) <= SMALL_TABLE:
            return self._scan_one(addr, port)
        return int(self.match([addr], None if port is None else [port])[0])

    # ---- ClassifyService API (rules/service.py) ----

    def size(self) -> int:
        return len(self._pub[1])

    def checksum(self) -> int:
        """u32 checksum of the published networks+ACL generation: the
        cluster replication gate compares it across nodes, so it is the
        reference's (crc32 of the reprs); cached per published
        generation."""
        snap = self._pub
        cached = self._cksum
        if cached is not None and cached[0] is snap:
            return cached[1]
        import zlib
        text = "\n".join(map(repr, snap[1]))
        if snap[2] is not None:
            text += "\n" + "\n".join(map(repr, snap[2]))
        v = zlib.crc32(text.encode())
        self._cksum = (snap, v)
        return v

    def snapshot(self) -> tuple:
        """One consistent (device, nets, acl, payload, tab, index,
        fused) generation."""
        return self._pub

    @staticmethod
    def snap_payload(snap: tuple):
        return snap[3]

    def oracle_snap(self, snap: tuple, addr: bytes,
                    port: Optional[int] = None) -> int:
        nets, acl = snap[1], snap[2]
        for j, net in enumerate(nets):
            if net.contains_ip(addr) and (
                    port is None or acl is None or
                    (acl[j].min_port <= port <= acl[j].max_port)):
                return j
        return -1

    def index_snap(self, snap: tuple, addr: bytes,
                   port: Optional[int] = None) -> int:
        """O(groups) host lookup against the snapshot's CidrIndex (same
        winner as oracle_snap); linear fallback without one."""
        note_serving()
        idx = snap[5]
        if idx is None:
            return self.oracle_snap(snap, addr, port)
        # route tables ignore ports entirely (oracle_snap's acl gate)
        return idx.lookup(addr, None if snap[2] is None else port)

    def dispatch_snap(self, snap: tuple, addrs: Sequence[bytes],
                      ports: Optional[Sequence[int]],
                      pad_to: Optional[int] = None, sync: bool = True):
        """Encode + submit one batch against the snapshotted table
        generation: an int32 [cap] tensor (to_host() it to block). On
        the card, ONE launch of the CIDR kernel (ops/cidr_cuda.py) over
        the packed table, of B7 (ops/fphash_cuda.py) on a "torch-fp"
        matcher, or of B9 (ops/dense_cuda.py) on a "torch-dense" one;
        CPU tensors take the torch tiers (hashmatch.cidr_hash_match,
        fphash.cidr_fp_match, matchers.cidr_first_match_chunked).
        pad_to: pad the encoded arrays to
        this batch bucket (family -1 marks pad rows — matches no
        group). A sharded matcher launches B8 (_dispatch_sharded); sync:
        see HintMatcher.dispatch_snap."""
        note_serving()
        dev, nets, acl = snap[0], snap[1], snap[2]
        if not nets or not addrs:
            return np.full(len(addrs), -1, np.int32)
        if self.backend == "host":
            return np.array(
                [self.oracle_snap(snap, a, None if ports is None
                                  else ports[i])
                 for i, a in enumerate(addrs)], np.int32)
        note_launch(kind="cidr")  # every branch below is one dispatch
        # route tables (acl=None) have zeroed port-range columns: the
        # port gate must be skipped entirely or every port>0 query misses
        a16, fam, p = _cidr_q(addrs, None if acl is None else ports,
                              pad_to)
        q = {"a16": a16, "fam": fam}
        if p is not None:
            q["port"] = p
        if self.backend in SHARDED_BACKENDS:
            return self._dispatch_sharded(snap, a16, fam, p, sync)
        q = _upload_q(q, self.device)
        if self.backend == "torch-fp":
            from ..ops import fphash_cuda as FPC
            return FPC.cidr_fp(dev, q["a16"], q["fam"], q.get("port"))
        if self.backend == "torch-dense":
            from ..ops import matchers as MT
            return MT.cidr_dense(dev, q["a16"], q["fam"], q.get("port"))
        if self.device.type == "cpu":
            return H.cidr_hash_match(dev, q["a16"], q["fam"], q.get("port"))
        from ..ops import cidr_cuda as CC
        return CC.cidr_first(snap[6], q["a16"], q["fam"], q.get("port"))

    def _dispatch_sharded(self, snap: tuple, a16: np.ndarray,
                          fam: np.ndarray, p: Optional[np.ndarray],
                          sync: bool):
        """A sharded batch: padded to a multiple of the mesh's query
        shards (family -1), uploaded, then B8 on the card, the plain
        version on the CPU."""
        from ..ops import fphash as FP
        from ..parallel import mesh as M
        dev, tab = snap[0], snap[4]
        n = a16.shape[0]
        cap = pad_batch(n, M.query_shards(self._mesh))
        if cap != n:
            a16 = np.concatenate([a16, np.zeros((cap - n, 16), a16.dtype)])
            fam = np.concatenate([fam, np.full(cap - n, -1, fam.dtype)])
            if p is not None:
                p = np.concatenate([p, np.zeros(cap - n, p.dtype)])
        a16d, famd, pd = _card_upload(self.device, "cidr", lambda: (
            M.shard_addr_queries(a16, fam, self._mesh, p)))
        with_port = p is not None
        fn = self._fns.get(with_port)
        if fn is None:
            fn = self._fns[with_port] = M.make_sharded_cidr_fn(
                self._mesh, with_port=with_port,
                kernel=FP.cidr_fp_match
                if self.backend == "torch-fp-sharded" else None)
        table = dev if self.device.type == "cpu" else dev.kernel
        out = fn(table, a16d, famd, pd, tab.shard_size) if with_port \
            else fn(table, a16d, famd, tab.shard_size)
        return to_host(out)[:n] if sync else out
