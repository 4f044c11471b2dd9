"""Host-side cuckoo hash tables for the classify() fast path.

The dense matmul matchers (ops/matchers.py) vectorize the reference's
linear scans (Upstream.java:187, RouteTable.java:44) — correct, but
O(rules) FLOPs per query. These tables give the O(1) path: each rule key
(reversed host, uri prefix, masked CIDR bytes) lives in exactly one of
two cuckoo slots, so a query resolves with 2 gather probes per candidate
position. Slots carry (bucket_start, bucket_count) into a rule-index
array so multiple rules sharing one key (same host, different uri/port;
same CIDR, different port range) stay distinguishable.

Hashes are salted FNV-1a. Collision quality only affects build success —
the device kernels byte-verify every probed key, so matching is exact
regardless of hash behavior. Build retries with fresh salts on a cuckoo
cycle and doubles capacity if salts alone cannot place all keys.

Query-side helpers compute rolling (prefix) hashes so one numpy pass
yields the hash of every dot-suffix of a host / every prefix of a uri —
the probe positions for suffix-rule and uri-prefix-rule matching.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

FNV64_OFFSET = np.uint64(14695981039346656037)
FNV64_PRIME = np.uint64(1099511628211)
FNV32_OFFSET = np.uint32(2166136261)
FNV32_PRIME = np.uint32(16777619)

_M64 = (1 << 64) - 1
_FNV64_OFFSET_I = int(FNV64_OFFSET)
_FNV64_PRIME_I = int(FNV64_PRIME)


class _Pacer(threading.local):
    """Per-thread build pacing. ratio=0 (every thread by default):
    coop_yield() is a bare GIL yield. The engine's background
    TableInstaller sets ratio=r around a standby compile: each yield
    then sleeps ~r x the work time since the previous yield, capping
    the installer's CPU/GIL duty at 1/(1+r) — what keeps serving-thread
    p99 flat through an install on a shared interpreter (cooperative
    yields alone still leave a full-speed compile about half the
    GIL)."""

    ratio = 0.0
    last = 0.0


_PACER = _Pacer()


def set_build_pacing(ratio: float) -> None:
    """Set THIS thread's build pacing (0 = none). The installer calls
    this; foreground builds (matcher __init__) stay unpaced."""
    _PACER.ratio = max(0.0, ratio)
    _PACER.last = 0.0


def coop_yield() -> None:
    """Cooperative scheduling point for table-build hot loops (call
    every ~0.1-0.3ms of work): lets GIL waiters in immediately, and
    applies the thread's build pacing when one is set."""
    r = _PACER.ratio
    if not r:
        time.sleep(0)
        return
    now = time.perf_counter()
    last = _PACER.last
    if last:
        time.sleep(min(0.005, (now - last) * r))
    else:
        time.sleep(0)
    _PACER.last = time.perf_counter()


def fnv64(key: bytes, salt: int) -> np.uint64:
    """Bit-identical to the original np.uint64 form, computed on python
    ints (one masked multiply per byte instead of a numpy scalar
    round-trip — less build-time GIL hold, the table-compile cost AND
    contention source for background standby installs)."""
    h = (_FNV64_OFFSET_I ^ int(salt)) & _M64
    for b in key:
        h = ((h ^ b) * _FNV64_PRIME_I) & _M64
    return np.uint64(h)


def rolling_fnv64(qbytes: np.ndarray, salt: int) -> np.ndarray:
    """uint8 [B, L] -> uint64 [B, L+1]; column p = hash of row prefix [:p].

    Vectorized across the batch: L sequential steps of [B] ops.
    """
    b, l = qbytes.shape
    out = np.empty((b, l + 1), dtype=np.uint64)
    h = np.full(b, FNV64_OFFSET ^ np.uint64(salt), dtype=np.uint64)
    out[:, 0] = h
    with np.errstate(over="ignore"):
        for p in range(l):
            h = (h ^ qbytes[:, p].astype(np.uint64)) * FNV64_PRIME
            out[:, p + 1] = h
    return out


def rolling_fnv64_multi(qbytes: np.ndarray, salts) -> np.ndarray:
    """uint8 [B, L], salts [S] -> uint64 [S, B, L+1]; out[s, :, p] =
    rolling_fnv64(qbytes, salts[s])[:, p]. One pass over the byte
    columns serves every salt — the sharded encoder's way to hash a
    query batch for S per-shard tables without S sequential passes."""
    b, l = qbytes.shape
    salts = np.asarray(salts, np.uint64)
    s = salts.shape[0]
    out = np.empty((s, b, l + 1), dtype=np.uint64)
    h = np.ascontiguousarray(
        np.broadcast_to(FNV64_OFFSET ^ salts[:, None], (s, b)))
    out[:, :, 0] = h
    with np.errstate(over="ignore"):
        qb = qbytes.astype(np.uint64)
        for p in range(l):
            h = (h ^ qb[None, :, p]) * FNV64_PRIME
            out[:, :, p + 1] = h
    return out


def fnv32_masked(key16: np.ndarray, salt: int) -> np.ndarray:
    """uint8 [..., 16] -> uint32 [...]; must match the device-side FNV-32
    in ops/hashmatch.py bit for bit (u32 wraparound multiply)."""
    h = np.full(key16.shape[:-1], FNV32_OFFSET ^ np.uint32(salt), np.uint32)
    with np.errstate(over="ignore"):
        for p in range(16):
            h = (h ^ key16[..., p].astype(np.uint32)) * FNV32_PRIME
    return h


def _pow2_at_least(n: int) -> int:
    c = 1
    while c < n:
        c <<= 1
    return c


@dataclass
class CuckooTable:
    """One built table. Keys byte-verified at probe time; `slot_of` maps
    key -> slot for build-side tests."""

    cap: int  # power of two
    salt1: int
    salt2: int
    used: np.ndarray  # [cap] bool
    key_len: np.ndarray  # [cap] int32
    key_bytes: np.ndarray  # [cap, key_slot] uint8 (zero-padded)
    bucket_start: np.ndarray  # [cap] int32
    bucket_count: np.ndarray  # [cap] int32
    slot_of: dict  # key bytes -> slot


class CuckooBuildError(Exception):
    pass


def _try_build(keys: list[bytes], cap: int, salt1: int, salt2: int,
               hasher) -> dict | None:
    """Place every key into one of its two slots; None on cycle.

    Cooperatively yields every few keys (~0.1ms of work): builds run
    on the engine's background installer while serving threads fight
    for the GIL — an unyielding build inflates dispatch p99; at this
    granularity it is invisible."""
    slot_key: list[bytes | None] = [None] * cap
    mask = cap - 1
    for ki, key in enumerate(keys):
        if not (ki & 3):
            coop_yield()
        cur = key
        # standard cuckoo insertion with bounded kicks
        h = int(hasher(cur, salt1)) & mask
        for kick in range(max(64, 8 * len(keys).bit_length() * 4)):
            if slot_key[h] is None:
                slot_key[h] = cur
                cur = None
                break
            slot_key[h], cur = cur, slot_key[h]
            h1 = int(hasher(cur, salt1)) & mask
            h2 = int(hasher(cur, salt2)) & mask
            h = h2 if h == h1 else h1
        if cur is not None:
            return None
    return {k: i for i, k in enumerate(slot_key) if k is not None}


def build_cuckoo(buckets: dict[bytes, list[int]], key_slot: int,
                 cap: int | None = None, hasher=fnv64,
                 bucket_items: np.ndarray | None = None,
                 salt_base: int = 0) -> tuple[CuckooTable, np.ndarray]:
    """buckets: key bytes -> sorted rule indices sharing that key.

    Returns (table, bucket_array): bucket_array is the concatenated
    int32 rule indices; slots point into it via (start, count).
    """
    keys = sorted(buckets.keys())
    n = len(keys)
    # a caller-supplied cap (shape reuse across rule updates) may be too
    # small for the new key count — enforce load factor <= 0.5 up front
    cap = max(cap or 4, 4, _pow2_at_least(2 * n))
    placement = None
    salt1 = salt2 = 0
    for attempt in range(64):
        salt1 = salt_base * 131 + attempt * 2 + 1
        salt2 = salt_base * 131 + attempt * 2 + 2
        placement = _try_build(keys, cap, salt1, salt2, hasher)
        if placement is not None:
            break
        if attempt and attempt % 8 == 0:
            cap <<= 1  # salts alone not enough: grow
    if placement is None:
        raise CuckooBuildError(f"cuckoo build failed for {n} keys")

    used = np.zeros(cap, bool)
    key_len = np.zeros(cap, np.int32)
    key_bytes = np.zeros((cap, key_slot), np.uint8)
    bstart = np.zeros(cap, np.int32)
    bcount = np.zeros(cap, np.int32)
    flat: list[int] = []
    for ki, k in enumerate(keys):
        if not (ki & 15):
            coop_yield()  # cooperative: see _try_build
        s = placement[k]
        used[s] = True
        key_len[s] = len(k)
        if len(k) > key_slot:
            raise CuckooBuildError(f"key longer than slot: {len(k)} > {key_slot}")
        key_bytes[s, : len(k)] = np.frombuffer(k, np.uint8)
        bstart[s] = len(flat)
        items = sorted(buckets[k])
        bcount[s] = len(items)
        flat.extend(items)
    bucket = np.asarray(flat, np.int32) if flat else np.zeros(0, np.int32)
    return CuckooTable(cap=cap, salt1=salt1, salt2=salt2, used=used,
                       key_len=key_len, key_bytes=key_bytes,
                       bucket_start=bstart, bucket_count=bcount,
                       slot_of=placement), bucket


def probe_slots(hashes1: np.ndarray, hashes2: np.ndarray, cap: int):
    """uint64 hash arrays -> int32 slot indices (cap is a power of two)."""
    mask = np.uint64(cap - 1)
    return ((hashes1 & mask).astype(np.int32),
            (hashes2 & mask).astype(np.int32))
