"""Maglev consistent-hash backend selection (Eisenbud et al., NSDI'16).

The port of `vproxy_tpu/rules/maglev.py`; the table compiler and the
hash contract are copies, so tables and picks are bit-identical:

* **build_table()** — the permutation-fill algorithm: each backend gets
  an (offset, skip) permutation of the M (prime) slots from two FNV-1a
  hashes of its identity, and backends claim slots in a weighted turn
  order. -> int32 slot->backend table.
* **flow_hash()/flow_slots()/pick()** — THE hash contract shared by
  every pick plane: FNV-1a 64 over the raw address bytes, plus the port
  as two big-endian bytes when per-connection spread is wanted
  (`port=None` = source affinity).
* **MaglevMatcher** — the device plane: the table rides the engine's
  double-buffered generation installs (rules/engine.py TableInstaller)
  and `dispatch_snap` answers a batch with a clamped device take.
* **classify_and_pick()/FusedPair** — one batched dispatch answering
  verdict AND pick from one snapshot pair: the fused one-launch program
  (rules/engine.fused_dispatch) where the hint matcher publishes packed
  tables, else the two-dispatch chain.

Metrics: vproxy_maglev_table_builds_total, vproxy_maglev_build_ms,
vproxy_maglev_remap_fraction. Knob: VPROXY_TPU_MAGLEV_M (65537, must be
prime).
"""
from __future__ import annotations

import math
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.torchenv import (default_device, sync, tables_from_reference,
                              to_host)

FNV64_OFFSET = 0xCBF29CE484222325
FNV64_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1

DEFAULT_M = int(os.environ.get("VPROXY_TPU_MAGLEV_M", "65537"))
# the table size of the per-group tables (a server group's, an accept
# lane's): the shared knob keeps its name
GROUP_M = int(os.environ.get("VPROXY_TPU_MAGLEV_GROUP_M", "4099"))

_TURN_CAP = 4096  # weighted turn-order bound (weights renormalized past it)


def fnv64(data: bytes) -> int:
    """FNV-1a 64 — the shared hash of every maglev plane (vproxy_tpu's
    C lanes implement the same loop)."""
    h = FNV64_OFFSET
    for b in data:
        h = ((h ^ b) * FNV64_PRIME) & _MASK64
    return h


def flow_hash(ip: bytes, port: Optional[int] = None) -> int:
    """The flow key hash: raw address bytes (4 for v4, 16 for v6, as
    utils/ip.parse_ip produces and as they sit in a sockaddr), plus the
    port as two big-endian bytes when per-connection spread is wanted.
    port=None is SOURCE AFFINITY: every connection from one client
    address lands on one backend."""
    if port is None:
        return fnv64(ip)
    return fnv64(ip + bytes((port >> 8 & 0xFF, port & 0xFF)))


def flow_slots(m: int, ips: Sequence[bytes],
               ports: Optional[Sequence[int]] = None) -> np.ndarray:
    """Host-side Maglev table slots for a batch — THE one copy of the
    slot-hash contract every pick plane (device gather, fused program,
    host pick) derives from; a per-element None port is source
    affinity. -> int64 [len(ips)]."""
    return np.fromiter(
        (flow_hash(ip, None if ports is None else ports[i]) % m
         for i, ip in enumerate(ips)), np.int64, len(ips))


def _turns(weights: Sequence[int]) -> list[int]:
    """Weighted turn order for the fill loop: the reference's
    subtract-sum WRR sequence (components/lanes._wrr_seq semantics),
    gcd-reduced and capped — each backend takes turns claiming slots in
    proportion to its weight, which is what makes slot ownership track
    weight share."""
    if not weights:
        return []
    if len(set(weights)) == 1:
        return list(range(len(weights)))
    g = 0
    for w in weights:
        g = math.gcd(g, w)
    if g > 1:
        weights = [w // g for w in weights]
    total = sum(weights)
    if total > _TURN_CAP:
        weights = [max(1, (w * _TURN_CAP) // total) for w in weights]
        total = sum(weights)
    if total > _TURN_CAP:
        return list(range(len(weights)))
    cur = list(weights)
    seq: list[int] = []
    while True:
        idx = max(range(len(cur)), key=lambda i: (cur[i], -i))
        seq.append(idx)
        cur[idx] -= total
        if all(w == 0 for w in cur):
            return seq
        for i in range(len(cur)):
            cur[i] += weights[i]


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in range(2, int(n ** 0.5) + 1):
        if n % p == 0:
            return False
    return True


def build_table(entries: Sequence[tuple[str, int]],
                m: Optional[int] = None) -> np.ndarray:
    """Compile the slot→backend lookup table.

    entries: (identity, weight) per backend, weight > 0; identity is
    whatever names the backend stably across rebuilds (ip:port for
    servers, node ids for cluster peers) — a backend keeps its
    permutation, and therefore most of its slots, across resizes.
    Returns int32[m]; every slot owned (m prime, skip ∈ [1, m-1], so
    each permutation covers the whole table). An empty entry list
    returns an all -1 table.
    """
    if m is None:
        m = DEFAULT_M
    if m < 3 or not _is_prime(m):
        raise ValueError(f"maglev table size {m} must be a prime >= 3")
    t0 = time.monotonic()
    n = len(entries)
    # plain-list fill: numpy scalar loads/stores are ~30x a list's in
    # this loop, and group-size builds run under the group lock on a
    # health edge — the list fill keeps that window ~100µs, not ~5ms
    tab = [-1] * m
    if n:
        cur, skips = [], []
        for name, _w in entries:
            b = name.encode() if isinstance(name, str) else bytes(name)
            cur.append(fnv64(b"o:" + b) % m)
            skips.append(fnv64(b"s:" + b) % (m - 1) + 1)
        turns = _turns([max(1, int(w)) for _, w in entries])
        filled = 0
        while filled < m:
            for i in turns:
                # next unclaimed slot in backend i's permutation —
                # walked incrementally (slot += skip mod m): slots
                # behind cur[i] were claimed when this permutation
                # passed them, so the next free one is always ahead
                sl = cur[i]
                sk = skips[i]
                while tab[sl] >= 0:
                    sl += sk
                    if sl >= m:
                        sl -= m
                tab[sl] = i
                sl += sk
                cur[i] = sl - m if sl >= m else sl
                filled += 1
                if filled >= m:
                    break
    table = np.asarray(tab, np.int32)
    _builds_total().incr()
    _build_ms().observe((time.monotonic() - t0) * 1e3)
    return table


def remap_fraction(old: Optional[np.ndarray], new: np.ndarray,
                   old_names: Optional[Sequence[str]] = None,
                   new_names: Optional[Sequence[str]] = None) -> float:
    """Fraction of slots whose OWNER changed between two builds — the
    churn a resize actually caused. With name lists the comparison is
    by identity (indexes shift when a backend leaves); without, by raw
    index (valid only for same-membership rebuilds). Records the
    vproxy_maglev_remap_fraction gauge."""
    if old is None or len(old) != len(new):
        f = 1.0
    else:
        if old_names is not None and new_names is not None:
            o = np.array([old_names[i] if 0 <= i < len(old_names) else ""
                          for i in old], dtype=object)
            nw = np.array([new_names[i] if 0 <= i < len(new_names) else ""
                           for i in new], dtype=object)
            f = float(np.mean(o != nw))
        else:
            f = float(np.mean(old != new))
    _remap_gauge().set(f)
    return f


def pick(table: np.ndarray, ip: bytes, port: Optional[int] = None) -> int:
    """O(1) host-side pick: slot = flow_hash % M. -1 = empty table."""
    return int(table[flow_hash(ip, port) % len(table)])


# ------------------------------------------------------------ metrics

def _builds_total():
    from ..utils.metrics import GlobalInspection
    return GlobalInspection.get().get_counter(
        "vproxy_maglev_table_builds_total")


def _build_ms():
    # pre-registered (reservoir config included) in
    # GlobalInspection.__init__ — this resolves to that instance
    from ..utils.metrics import GlobalInspection
    return GlobalInspection.get().get_histogram("vproxy_maglev_build_ms")


def _remap_gauge():
    from ..utils.metrics import GlobalInspection
    return GlobalInspection.get().get_gauge("vproxy_maglev_remap_fraction")


# ------------------------------------------------------ device plane


def _device_take(dev_table, slots: np.ndarray):
    """Device gather of the pick column at host-computed slots, clamped
    like jnp.take(mode="clip"): the slots' copy to the table's device,
    then B5 (ops/take_cuda.py, csrc/maglev_take.cu) on the card, torch
    indexing (its plain version) on the CPU. `calls` counts the
    calls."""
    from ..ops import take_cuda as TC
    _device_take.calls += 1
    s = torch.from_numpy(np.asarray(slots, np.int64)).to(dev_table.device)
    return TC.take(dev_table, s)


_device_take.calls = 0


class MaglevMatcher:
    """Device-backed per-generation Maglev table, published through the
    SAME double-buffer machinery as the hint matchers: set_backends
    enqueues on the process-wide TableInstaller (standby build + device
    upload off the mutation path, then ONE atomic pub-tuple swap), so a
    table rebuild never stalls a serving dispatch."""

    _kind = "maglev"

    def __init__(self, entries: Sequence[tuple[str, int]] = (),
                 m: Optional[int] = None, payload=None, device=None):
        self.m = m or DEFAULT_M
        self.device = default_device(device)
        self._entries: list = list(entries)
        self._payload = payload
        self.generation = 0
        self.last_remap = 0.0  # fraction of slots the last install moved
        # (np table, device table, entries, payload) — one atomic tuple
        # so a reader never pairs one generation's table with another's
        # entry list
        self._pub: tuple = (None, None, [], payload)
        self._recompile()
        from . import engine as E
        with E._gen_lock:
            E._MATCHERS.add(self)

    # ---------------------------------------------------------- install

    def set_backends(self, entries: Sequence[tuple[str, int]],
                     payload=None, wait: bool = True) -> None:
        """Install a new backend generation via the background
        TableInstaller (same standby-swap contract as
        HintMatcher.set_rules)."""
        from .engine import TableInstaller
        t = TableInstaller.get().submit(self, (list(entries), payload))
        if wait:
            t.ev.wait()
            if t.exc is not None:
                raise t.exc

    def _install(self, args: tuple) -> None:
        entries, payload = args
        old = (self._entries, self._payload)
        self._entries = list(entries)
        self._payload = payload
        try:
            self._recompile()
        except BaseException:
            self._entries, self._payload = old
            raise

    def _recompile(self) -> None:
        from . import engine as E
        tab = build_table(self._entries, self.m)
        prev = self._pub[0]
        if prev is None or not self._pub[2]:
            # first build, or empty->populated: an all -1 table owned
            # no flows, so "100% of slots changed owner" would misread
            # a bring-up as total churn
            self.last_remap = 0.0
        else:
            prev_names = [name for name, _ in self._pub[2]] or None
            names = [name for name, _ in self._entries] or None
            self.last_remap = remap_fraction(prev, tab, prev_names, names)
        dev = tables_from_reference({"table": tab}, self.device)
        if self.device.type != "cpu":
            # B5 built: a build failure stops the publish (KernelError)
            from ..ops import take_cuda as TC
            TC._lib()
        sync(self.device)  # the upload lands before the publish swap
        time.sleep(0)  # preemption point between compile and publish
        self._pub = (tab, dev["table"], list(self._entries), self._payload)
        self.generation += 1
        with E._gen_lock:
            E._GENERATION[0] += 1

    def published_table_bytes(self) -> int:
        dev = self._pub[1]
        return 0 if dev is None else dev.numel() * dev.element_size()

    # ------------------------------------------------------------ reads

    def snapshot(self) -> tuple:
        return self._pub

    @staticmethod
    def snap_payload(snap: tuple):
        return snap[3]

    def size(self) -> int:
        return len(self._pub[2])

    def checksum(self) -> int:
        """u32 checksum of the published (name, weight) entries, the
        reference's crc32."""
        import zlib
        return zlib.crc32(
            "\n".join(f"{n}:{w}" for n, w in self._pub[2]).encode())

    def pick_one(self, ip: bytes, port: Optional[int] = None) -> int:
        return self.pick_snap(self._pub, ip, port)

    def pick_snap(self, snap: tuple, ip: bytes,
                  port: Optional[int] = None) -> int:
        tab = snap[0]
        if tab is None or not snap[2]:
            return -1
        return pick(tab, ip, port)

    def dispatch_snap(self, snap: tuple, ips: Sequence[bytes],
                      ports: Optional[Sequence[int]] = None):
        """Batched device picks against one snapshotted generation
        (a device tensor; to_host() to block). Slots are hashed
        host-side with the one slot-hash contract (flow_slots)."""
        tab, dev = snap[0], snap[1]
        if tab is None or not snap[2] or not len(ips):
            return np.full(len(ips), -1, np.int32)
        slots = flow_slots(len(tab), ips, ports)
        from . import engine as E
        E.note_launch()
        return _device_take(dev, slots)

    def match(self, ips: Sequence[bytes],
              ports: Optional[Sequence[int]] = None) -> np.ndarray:
        return to_host(self.dispatch_snap(self._pub, ips, ports))


def classify_and_pick(hint_matcher, maglev: MaglevMatcher, hints,
                      ips: Sequence[bytes],
                      ports: Optional[Sequence[int]] = None):
    """ONE batched dispatch answering BOTH questions: match verdicts
    from the hint matcher and backend picks from the maglev table
    against one atomic snapshot pair. On a "torch" matcher with packed
    tables published (the default) this is the FUSED one-launch program
    (rules/engine.fused_dispatch); other backends keep the two-dispatch
    submit. -> (verdicts int32[B], picks int32[B], hint_payload,
    maglev_payload)."""
    from . import engine as E
    hsnap = hint_matcher.snapshot()
    msnap = maglev.snapshot()
    out = E.fused_dispatch(hint_matcher, hsnap, maglev, msnap, hints,
                           ips, ports)
    if out is not None:
        arr = to_host(out)[: len(hints)]
        return (np.ascontiguousarray(arr[:, 0]),
                np.ascontiguousarray(arr[:, 1]),
                hint_matcher.snap_payload(hsnap),
                maglev.snap_payload(msnap))
    if getattr(hint_matcher, "backend", None) == "host":
        v = np.array([hint_matcher.oracle_snap(hsnap, h) for h in hints],
                     np.int32)
    else:
        v = hint_matcher.dispatch_snap(hsnap, hints)  # async device call
    p = maglev.dispatch_snap(msnap, ips, ports)       # overlaps the first
    return (to_host(v), to_host(p),
            hint_matcher.snap_payload(hsnap), maglev.snap_payload(msnap))


class FusedPair:
    """A (HintMatcher, MaglevMatcher) pair presented through the
    matcher interface the dispatch consumers speak (ClassifyService):
    snapshot() is the atomic snapshot PAIR, dispatch_snap() is the fused
    one-launch (verdict, pick) batch, and index_snap() is the host fast
    lane (O(probes) hint index + O(1) maglev table read) for inline
    lone queries and degraded serving. Payloads ride as (hint_payload,
    maglev_payload)."""

    def __init__(self, hint_matcher, maglev: MaglevMatcher):
        self.hm = hint_matcher
        self.mm = maglev

    @property
    def backend(self) -> str:
        return self.hm.backend

    @property
    def device(self):
        return self.hm.device

    def size(self) -> int:
        return self.hm.size()

    @property
    def generation(self) -> int:
        return self.hm.generation + self.mm.generation

    def snapshot(self) -> tuple:
        return (self.hm.snapshot(), self.mm.snapshot())

    @staticmethod
    def snap_payload(snap: tuple):
        hsnap, msnap = snap
        return (hsnap[3], msnap[3])

    def index_snap(self, snap: tuple, payload: tuple) -> tuple:
        """(verdict, pick) from the host planes — the same winners as
        the fused program."""
        hsnap, msnap = snap
        hint, ip, port = payload
        return (self.hm.index_snap(hsnap, hint),
                self.mm.pick_snap(msnap, ip, port))

    def dispatch_snap(self, snap: tuple, payloads, pad_to=None):
        """One fused launch for a batch of (hint, ip, port) payloads;
        an int32 [cap, 2] device tensor. Falls back to the two-dispatch
        chain when the fused path is unavailable for this snapshot."""
        from . import engine as E
        hsnap, msnap = snap
        hints = [p[0] for p in payloads]
        ips = [p[1] for p in payloads]
        ports = [p[2] for p in payloads]
        if all(p is None for p in ports):
            ports = None
        out = E.fused_dispatch(self.hm, hsnap, self.mm, msnap, hints,
                               ips, ports, pad_to=pad_to)
        if out is not None:
            return out
        v = self.hm.dispatch_snap(hsnap, hints, pad_to=pad_to)
        p = self.mm.dispatch_snap(msnap, ips, ports)
        return _LazyPairRows(v, p, len(hints))


class _LazyPairRows:
    """FusedPair's unfused-fallback result: both dispatches are already
    submitted; the device->host pull happens when the CONSUMER asks
    (to_host / np.asarray), preserving the service dispatcher's double
    buffering exactly like the fused path's device tensor does."""

    def __init__(self, v, p, n: int):
        self._v, self._p, self._n = v, p, n

    def __array__(self, dtype=None, copy=None):
        n = self._n
        out = np.stack([to_host(self._v)[:n].astype(np.int32),
                        to_host(self._p)[:n].astype(np.int32)],
                       axis=1)
        return out if dtype is None else out.astype(dtype)
