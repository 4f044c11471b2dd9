"""Shard slots for the sharded backends, on torch.distributed.

The port of `vproxy_tpu/parallel/mesh.py`. The reference lays the rule
tables over a JAX device mesh: each device of the "rules" axis holds a
contiguous slice of the rules compiled into its own table
(ops/hashmatch.py ShardedHashTable) and the winner rides pmax / pmin
collectives; query batches shard over "batch" (and "host"). Here a
mesh position is a **shard slot**, and the slots belong to the ranks
of the torch.distributed job (one process, one card: the process's
serving device, utils/torchenv.default_device), rank r holding the
slots [r * k, (r + 1) * k) of n = world * k. On one process every slot
lies on the process's device: `make_mesh(8, batch=2)` gives (batch 2,
rules 4), four rule shards stacked on one card, as the reference's
tests stack them on virtual CPU devices. B8 (ops/sharded_cuda.py)
then answers a batch over all of the process's shards in one launch
and decides the winner in the kernel.

Multi-host: `init_distributed()` brings up torch.distributed (the
reference's jax.distributed: the same VPROXY_TPU_DIST_* knobs, the same
bounded pre-flight probe of the coordinator), after which `make_mesh(
hosts=N)` lays out a (host, batch, rules) mesh where

* tables are REPLICATED across the "host" axis (each host holds the
  full rule set; updates are control-plane broadcasts),
* the "rules" shards stay WITHIN a host: a rank's rule shards are a
  contiguous range of its (host, batch) row, and where that row spans
  several ranks of a host, B8's 64-bit keys are reduced with one
  all_reduce(MAX) on that row's process group (`Mesh.group`);
* query batches shard over (host, batch): each rank classifies its own
  batch; no per-query traffic crosses hosts.

`put_many` / `to_local` keep the reference's names: the first puts a
dict of arrays on this rank's device (the rules-sharded keys sliced to
its shards), the second pulls an answer back to numpy.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..utils.torchenv import default_device


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() else None


def _world() -> tuple:
    """-> (rank, world size) of the torch.distributed job, (0, 1) when
    none is up."""
    dist = _dist()
    if dist is None or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout_s: Optional[float] = None,
                     device=None) -> bool:
    """torch.distributed multi-host bring-up; reads VPROXY_TPU_DIST_COORD
    (host:port), VPROXY_TPU_DIST_NPROC, VPROXY_TPU_DIST_PROCID when the
    args are absent. Returns False (no-op) when not configured —
    single-host deployments never pay for it. Must run before the first
    device use (main.py boots it first thing).

    The process group rides a TCP store at the coordinator (rank 0
    listens there), with NCCL when the serving device is CUDA and gloo
    on the CPU. Bring-up is BOUNDED (VPROXY_TPU_DIST_TIMEOUT_S, default
    120 s): an unreachable coordinator, a missing peer, or two
    processes booted with the same VPROXY_TPU_DIST_PROCID would
    otherwise hang the rendezvous forever with no hint which knob is
    wrong. An unreachable coordinator is caught by a bounded pre-flight
    TCP probe and raises a RuntimeError naming the env vars to check;
    other rendezvous failures surface through the store's timeout."""
    coordinator = coordinator or os.environ.get("VPROXY_TPU_DIST_COORD")
    if num_processes is None:
        num_processes = int(os.environ.get("VPROXY_TPU_DIST_NPROC", "0")
                            or 0)
    if process_id is None:
        process_id = int(os.environ.get("VPROXY_TPU_DIST_PROCID", "-1")
                         or -1)
    if not coordinator or num_processes <= 1 or process_id < 0:
        return False
    if timeout_s is None:
        timeout_s = float(os.environ.get("VPROXY_TPU_DIST_TIMEOUT_S",
                                         "120"))
    if process_id > 0:
        _preflight_coordinator(coordinator, num_processes, process_id,
                               timeout_s)
    import datetime

    import torch.distributed as dist
    dev = default_device(device)
    try:
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{coordinator}", world_size=num_processes,
            rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:
        raise RuntimeError(
            f"torch.distributed bring-up failed for process "
            f"{process_id}/{num_processes} against coordinator "
            f"{coordinator} within {timeout_s:.0f}s: {e!r}. Check "
            "VPROXY_TPU_DIST_COORD (is the coordinator host:port "
            "reachable, and running process id 0?), "
            "VPROXY_TPU_DIST_NPROC (are ALL processes booted?), and "
            "VPROXY_TPU_DIST_PROCID (ids must be unique in "
            f"[0, {num_processes})) — a duplicate or missing id leaves "
            "the rendezvous waiting forever; raise "
            "VPROXY_TPU_DIST_TIMEOUT_S for genuinely slow fleets."
        ) from e
    return True


def cpu_collectives_available() -> bool:
    """Can this torch run collectives between processes on the CPU (the
    gloo backend, which init_distributed picks there)? The reference's
    enable_cpu_collectives has nothing to select: torch.distributed
    takes its backend per process group."""
    dist = _dist()
    return dist is not None and dist.is_gloo_available()


def _preflight_coordinator(coordinator: str, num_processes: int,
                           process_id: int, timeout_s: float) -> None:
    """Bounded TCP probe of the coordinator before the rendezvous: the
    by-far-most-common misconfiguration — coordinator address wrong or
    process 0 not up — fails as a catchable error here."""
    import socket
    import time
    host, _, port = coordinator.rpartition(":")
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
    deadline = time.monotonic() + timeout_s
    last: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            socket.create_connection(
                (host, int(port)),
                timeout=max(0.5, min(5.0, deadline - time.monotonic()))
            ).close()
            return
        except OSError as e:
            last = e
            time.sleep(min(1.0, max(0.05, deadline - time.monotonic())))
    raise RuntimeError(
        f"torch.distributed coordinator {coordinator} unreachable after "
        f"{timeout_s:.0f}s (process {process_id}/{num_processes}): "
        f"{last!r}. Check VPROXY_TPU_DIST_COORD (must be the host:port "
        "where the VPROXY_TPU_DIST_PROCID=0 process runs, and that "
        "process must be up first), VPROXY_TPU_DIST_NPROC, and that "
        "every process has a unique VPROXY_TPU_DIST_PROCID in "
        f"[0, {num_processes}); raise VPROXY_TPU_DIST_TIMEOUT_S for "
        "genuinely slow fleets.")


class Mesh:
    """The slot layout of a (batch, rules) or (host, batch, rules) mesh
    and this rank's part of it.

    * `axis_names`, `shape` (axis -> size) and `devices` (the slot ids,
      shaped like the mesh) read as the reference's Mesh does;
    * `device`: this rank's serving device, where its slots live;
    * `rules_lo`, `rules_hi`: the rule shards this rank holds (the
      same range in every (host, batch) row it holds);
    * `rows`: the flattened (host, batch) rows this rank holds;
    * `group`: the process group of the ranks that share this rank's
      rows (its rules axis spans them), None when this rank holds
      every rule shard of its rows."""

    def __init__(self, slots: np.ndarray, axis_names: tuple, rank: int,
                 world: int, device: torch.device, group):
        self.devices = slots
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, slots.shape))
        self.rank, self.world, self.device, self.group = (rank, world,
                                                          device, group)
        rules = self.shape["rules"]
        flat = slots.reshape(-1, rules)
        k = slots.size // world
        mine = (flat >= rank * k) & (flat < (rank + 1) * k)
        self.rows = tuple(int(r) for r in np.nonzero(mine.any(axis=1))[0])
        cols = np.nonzero(mine[self.rows[0]])[0]
        self.rules_lo, self.rules_hi = int(cols[0]), int(cols[-1]) + 1

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}/{self.world}, "
                f"rules [{self.rules_lo}, {self.rules_hi}) on "
                f"{self.device})")


def make_mesh(n_devices: Optional[int] = None, batch: int = 1,
              hosts: int = 1, device=None) -> Mesh:
    """Mesh with axes (batch, rules) — or (host, batch, rules) when
    hosts > 1; "rules" gets the remaining slots. n_devices slots (default
    one per real device: one per rank of the job), laid out rank by rank
    as the reference's jax.devices() orders each process's devices
    first. Every rank must call it (a rules axis that spans ranks makes
    one process group per row, collectively). Raises ValueError when a
    rank's slots are not one contiguous range of rule shards in each of
    its rows."""
    rank, world = _world()
    n = world if n_devices is None else int(n_devices)
    if n % (batch * hosts) or n % world:
        raise ValueError(f"{n} slots do not split over batch {batch} x "
                         f"hosts {hosts} and {world} ranks")
    rules = n // (batch * hosts)
    shape = (hosts, batch, rules) if hosts > 1 else (batch, rules)
    names = ("host", "batch", "rules") if hosts > 1 else ("batch", "rules")
    slots = np.arange(n).reshape(shape)
    flat = slots.reshape(-1, rules)
    k = n // world
    owners = flat // k  # the rank of every slot
    for r in range(world):
        rows = np.nonzero((owners == r).any(axis=1))[0]
        spans = {tuple(np.nonzero(owners[row] == r)[0]) for row in rows}
        if len(spans) != 1:
            raise ValueError(f"rank {r}'s slots cover different rule "
                             f"shards in its rows: {sorted(spans)}")
        span = spans.pop()
        if span != tuple(range(span[0], span[-1] + 1)):
            raise ValueError(f"rank {r}'s rule shards are not contiguous")
    group = None
    if world > 1:
        dist = _dist()
        seen = []
        for row in range(flat.shape[0]):  # the same order on every rank
            ranks = sorted({int(o) for o in owners[row]})
            if len(ranks) > 1 and ranks not in seen:
                seen.append(ranks)
                g = dist.new_group(ranks)
                if rank in ranks:
                    group = g
    return Mesh(slots, names, rank, world, default_device(device), group)


def batch_axes(mesh: Mesh) -> tuple:
    """Every mesh axis except "rules" carries query batches."""
    return tuple(a for a in mesh.axis_names if a != "rules")


def query_shards(mesh: Mesh) -> int:
    """Total batch-axis size (the pad multiple for query batches)."""
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def put_many(mesh: Mesh, arrs: dict, sharded=()) -> dict:
    """numpy arrays -> tensors on this rank's device: the keys in
    `sharded` have the rules axis first and keep this rank's shards
    [rules_lo, rules_hi); the others go whole."""
    out = {}
    for k, v in arrs.items():
        if k in sharded:
            v = v[mesh.rules_lo: mesh.rules_hi]
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device)
    return out


def to_local(arr) -> np.ndarray:
    """This rank's answer as numpy (each rank computes only its own
    batch, so there is nothing to gather)."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def shard_hash_table(stab, mesh: Mesh, arrays: Optional[dict] = None
                     ) -> dict:
    """Ship a ShardedHashTable's stacked arrays (or `arrays`, a stacked
    layout derived from it) to this rank's device: its shards
    [rules_lo, rules_hi) of every array (tables replicate across the
    host and batch axes). Paced per key (ops.cuckoo.coop_yield): a
    standby install's upload of multi-MB arrays under the GIL would
    otherwise show up in serving p99."""
    from ..ops.cuckoo import coop_yield
    out = {}
    for k, v in (stab.arrays if arrays is None else arrays).items():
        coop_yield()
        out[k] = torch.from_numpy(np.ascontiguousarray(
            v[mesh.rules_lo: mesh.rules_hi])).to(mesh.device)
    return out


def release_host(stab) -> None:
    """Drop a ShardedHashTable's stacked HOST arrays after the device
    upload (the standby-swap memory-lean contract): each array is
    replaced by a zero-size stub that keeps ndim and dtype. A 1M-rule
    generation would otherwise live in host RAM for as long as the
    matcher keeps its published snapshot."""
    stab.arrays = {k: np.empty((0,) * v.ndim, v.dtype)
                   for k, v in stab.arrays.items()}


def shard_hint_queries_sharded(q: dict, mesh: Mesh):
    """Stacked per-shard hint encodings -> an ops.sharded_cuda
    ShardQueries on this rank's device: a key every shard shares (the
    single-pass encoder's zero-stride broadcast views) goes once as
    [B, ...]; a per-shard key keeps this rank's shards as [S, B, ...]."""
    from ..ops.sharded_cuda import ShardQueries
    out, stacked = ShardQueries(), set()
    for k, v in q.items():
        if v.strides[0] == 0:
            v = v[0].copy()  # the broadcast's base row (read-only view)
        else:
            v = v[mesh.rules_lo: mesh.rules_hi]
            stacked.add(k)
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device)
    out.stacked = frozenset(stacked)
    return out


def shard_addr_queries(addr: np.ndarray, fam: np.ndarray, mesh: Mesh,
                       port: Optional[np.ndarray] = None):
    """An address batch on this rank's device: -> (a16, fam, port or
    None)."""
    arrs = {"a": addr, "f": fam}
    if port is not None:
        arrs["p"] = port
    out = put_many(mesh, arrs)
    return out["a"], out["f"], out.get("p")


def make_sharded_hint_fn(mesh: Mesh, kernel=None):
    """-> fn(stacked_table, stacked_queries, shard_size) -> int32 [B]
    global hint-rule index (-1 none) for the engine's sharded backends.
    `kernel` is the per-shard matcher: None (or the cuckoo
    `hint_hash_match`) or fphash's `hint_fp_match`; both share the
    (idx, level) contract. On the card the table is B8's prepared stack
    (ops/sharded_cuda.prepare_hint / prepare_fp_hint) and one launch
    answers the batch over this rank's shards; CPU tensors take the
    plain version. shard_size is a run-time argument, so a rule-count
    change within the same caps reuses everything. Winner: the highest
    level, then the least global index among its shards
    (Upstream.java:187)."""
    from ..ops import fphash as FP
    from ..ops import sharded_cuda as SC
    fp = kernel is FP.hint_fp_match

    def fn(table: dict, q: dict, shard_size: int):
        return SC.hint_sharded(table, q, int(shard_size), mesh.rules_lo,
                               fp=fp, group=mesh.group)
    return fn


def make_sharded_pick_fn(mesh: Mesh, kernel=None):
    """-> fn(stacked_table, stacked_queries, shard_size, mtab, slots) ->
    int32 [B, 2] (global hint-rule index, -1 none; Maglev pick) for a
    classify+pick batch of the engine's sharded backends: the hint fn's
    answer and B5's take in ONE launch of B8 on the card (its Maglev
    column: the pick is this rank's own, only the keys cross ranks),
    the plain version on CPU tensors. `kernel` as make_sharded_hint_fn
    takes it."""
    from ..ops import fphash as FP
    from ..ops import sharded_cuda as SC
    fp = kernel is FP.hint_fp_match

    def fn(table: dict, q: dict, shard_size: int, mtab, slots):
        return SC.hint_pick_sharded(table, q, int(shard_size), mtab, slots,
                                    mesh.rules_lo, fp=fp, group=mesh.group)
    return fn


def make_sharded_cidr_fn(mesh: Mesh, with_port: bool, kernel=None):
    """-> fn(stacked_table, a16, fam, [port,] shard_size) -> int32 [B]
    global first-match index (-1 none): the least global index over the
    shards (insert order is kept across contiguous rule slices).
    `kernel`: None (the cuckoo `cidr_hash_match`) or fphash's
    `cidr_fp_match`."""
    from ..ops import fphash as FP
    from ..ops import sharded_cuda as SC
    fp = kernel is FP.cidr_fp_match

    if with_port:
        def fn(table, a16, fam, port, shard_size):
            return SC.cidr_sharded(table, a16, fam, port, int(shard_size),
                                   mesh.rules_lo, fp=fp, group=mesh.group)
    else:
        def fn(table, a16, fam, shard_size):
            return SC.cidr_sharded(table, a16, fam, None, int(shard_size),
                                   mesh.rules_lo, fp=fp, group=mesh.group)
    return fn


def make_sharded_classify(mesh: Mesh, hint_stab, route_stab, acl_stab):
    """-> fn(ht, rt, at, hq, a16, fam, port) -> int32 [B, 3] global
    (hint idx, route idx, acl idx), -1 for no match: the full cuckoo
    classify over this rank's shards, ONE launch of B8 on the card.
    The shard sizes come from the three tables (the reference closes
    over them the same way). `fn.shapes` records every distinct table
    shape it served: caps-reusing updates keep it at one (the
    reference's no-retrace contract)."""
    from ..ops import sharded_cuda as SC
    sizes = (hint_stab.shard_size, route_stab.shard_size,
             acl_stab.shard_size)

    def fn(ht, rt, at, hq, a16, fam, port):
        a16, fam, port = (torch.as_tensor(x).to(mesh.device)
                          for x in (a16, fam, port))
        fn.shapes.add(tuple(tuple(v.shape) for t in (ht, rt, at)
                            for v in t.values()))
        return SC.classify_sharded(ht, rt, at, hq, a16, fam, port, sizes,
                                   mesh.rules_lo, group=mesh.group)
    fn.shapes = set()
    return fn
