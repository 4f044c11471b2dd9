"""B8: the sharded winner reduction, its hand-written CUDA kernel and
its plain version.

Replaces `vproxy_tpu/parallel/mesh.py` `make_sharded_hint_fn`,
`make_sharded_cidr_fn` and `make_sharded_classify`: the per-shard
matcher of every rule shard of a ShardedHashTable (ops/hashmatch.py,
ops/fphash.py) and the winner across the shards (hint: the highest
level, then the least global index `shard * shard_size + idx`, -1 when
the best level is 0; CIDR: the least global index, -1 for none).
csrc/sharded_match.cu's note gives the bound and the design; this
module packs and checks the stacked tables, builds the kernel with nvcc
(fused_cuda.build_library), loads it with ctypes and launches it on
PyTorch's current stream.

* `hint_sharded`, `cidr_sharded` and `classify_sharded` are the entries
  parallel/mesh.py's functions serve with. CPU tensors take the plain
  version (`hint_keys_plain` / `cidr_keys_plain` + `finish_plain`: per
  shard the package's plain
  `hint_hash_match` / `hint_fp_match` / `cidr_hash_match` /
  `cidr_fp_match`, then the reduction in torch ops); CUDA tensors
  launch B8 (`sharded_cuda`), which raises KernelError unless it
  launched. Where the rules axis spans ranks (a process group), the
  64-bit keys go through one all_reduce(MAX) before the last pass
  (`finish_cuda` / `finish_plain`).
* The reduction is one max over int64 keys per (query, column): hint
  (level << 32) | (BIG - gidx) when the level is above 0, else 0; CIDR
  BIG - gidx. The answer is BIG - (key & 0xffffffff), -1 for key 0.
* `pack_hint_sharded` / `pack_cidr_sharded` pack the stacked cuckoo
  tables shard by shard (ops/fused.py) under one key set, so the packed
  stack keeps a fixed per-shard stride; `prepare_*` check a stacked
  table once on the card and cache its per-shard strides.
* `hint_pick_sharded` is the classify+pick entry: the hint answer and
  the Maglev pick in int32 [B, 2] rows, ONE launch of B8 with its
  Maglev column on the card (B5's take folded in), the plain version
  (`hint_pick_plain`: the plain keys, `finish_plain`, then
  take_cuda.take_plain) on the CPU. The pick depends on no rule shard:
  the kernel writes it rank-locally, and across ranks only the keys
  ride the all_reduce.
* `sharded_cuda.launches` counts B8's launches (`pick_launches` those
  with the Maglev column), `finish_cuda.launches` the last passes of
  the cross-rank form.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from . import cidr_cuda as CC
from . import fphash_cuda as FPC
from . import fused as F
from . import fused_cuda as FC
from . import take_cuda as TC
from .fused_cuda import KernelError, card_entry

SOURCE = os.path.join(os.path.dirname(FC.SOURCE), "sharded_match.cu")
HEADERS = (FC.HINT_HEADER, FC.CIDR_HEADER, FPC.HEADER_HINT,
           FPC.HEADER_CIDR)
BIG = 1 << 30  # the reference's sentinel: global indices stay below it

# per-shard strides, in the order of the pointers the kernel moves
# (csrc/sharded_match.cu `hint_at` / `cidr_at` / `fp_hint_at` /
# `fp_cidr_at`)
HASH_STRIDED = FC._PTRS[:FC._PTRS.index("wu_idx") + 1]
CIDR_STRIDED = tuple(CC.TABLE_DTYPES)
FPH_STRIDED = (*FPC.HINT_TABLE, *FPC.HINT_QUERY)
FPC_STRIDED = tuple(FPC.CIDR_TABLE)


class _CidrTable(ctypes.Structure):
    """Mirror of `cidr::Table` (csrc/cidr_first.cuh)."""
    _fields_ = [(n, ctypes.c_void_p) for n in CC.TABLE_DTYPES] + \
        [(n, ctypes.c_int) for n in CC.TABLE_INTS]


class _ShardedHashArgs(ctypes.Structure):
    """Mirror of `struct ShardedHashArgs` (csrc/sharded_match.cu)."""
    _fields_ = [("h", FC._FusedArgs), ("c", _CidrTable * 2),
                ("a16", ctypes.c_void_p), ("fam", ctypes.c_void_p),
                ("cport", ctypes.c_void_p * 2), ("keys", ctypes.c_void_p),
                ("out", ctypes.c_void_p),
                ("hstride", ctypes.c_longlong * len(HASH_STRIDED)),
                ("cstride", (ctypes.c_longlong * len(CIDR_STRIDED)) * 2),
                ("b", ctypes.c_int), ("ncols", ctypes.c_int),
                ("s0", ctypes.c_int), ("np", ctypes.c_int),
                ("smem_words", ctypes.c_int), ("size", ctypes.c_int * 3)]


class _ShardedFpArgs(ctypes.Structure):
    """Mirror of `struct ShardedFpArgs` (csrc/sharded_match.cu)."""
    _fields_ = [("h", FPC._FpHintArgs), ("c", FPC._FpCidrArgs),
                ("keys", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("hstride", ctypes.c_longlong * len(FPH_STRIDED)),
                ("cstride", ctypes.c_longlong * len(FPC_STRIDED)),
                ("b", ctypes.c_int), ("ncols", ctypes.c_int),
                ("s0", ctypes.c_int), ("smem_words", ctypes.c_int),
                ("size", ctypes.c_int * 2)]


class _ShardedPickArgs(ctypes.Structure):
    """Mirror of `struct ShardedPickArgs` (csrc/sharded_match.cu): the
    Maglev column of B8's PICK instances."""
    _fields_ = [("mtab", ctypes.c_void_p), ("mslots", ctypes.c_void_p),
                ("pick", ctypes.c_void_p), ("m", ctypes.c_int),
                ("ostride", ctypes.c_int)]


def build() -> str:
    """Compile csrc/sharded_match.cu (with the four routine headers it
    includes) once; -> the shared library's path."""
    return FC.build_library(SOURCE, "libsharded",
                            f"layout {F.PACK_LAYOUT_V}", HEADERS)


_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """Build (first use) and load the library. -> the ctypes handle, its
    ABI checked against the ctypes mirrors."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            path = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelError(f"cannot load {path}: {e}") from e
            for kind, args in (("hash", _ShardedHashArgs),
                               ("fp", _ShardedFpArgs),
                               ("pick", _ShardedPickArgs)):
                size = getattr(lib, f"vproxy_sharded_{kind}_args_size")
                size.restype, size.argtypes = ctypes.c_int, []
                if size() != ctypes.sizeof(args):
                    raise KernelError(
                        f"{args.__name__} ABI drift: C {size()} B, ctypes "
                        f"{ctypes.sizeof(args)} B")
            lib.vproxy_sharded_hash.restype = ctypes.c_int
            lib.vproxy_sharded_hash.argtypes = [
                ctypes.POINTER(_ShardedHashArgs),
                ctypes.POINTER(_ShardedPickArgs), ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.vproxy_sharded_fp.restype = ctypes.c_int
            lib.vproxy_sharded_fp.argtypes = [
                ctypes.POINTER(_ShardedFpArgs),
                ctypes.POINTER(_ShardedPickArgs), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
            lib.vproxy_sharded_finish.restype = ctypes.c_int
            lib.vproxy_sharded_finish.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            _LIB = lib
        return _LIB


# ------------------------------------------------------------- packing

def pack_hint_sharded(arrays: dict) -> dict:
    """Stacked HashHintTable arrays [S, ...] -> the packed layout
    (ops/fused.py pack_hint_table) of every shard, stacked. Every shard
    keeps the uri half when any shard has a uri rule, so all shards
    share one key set and shape (a shard without uri rules matches none
    through it)."""
    n = arrays["r_active"].shape[0]
    uri = bool((arrays["r_uri_kind"] > 0).any())
    per = [F.pack_hint_table({k: v[s] for k, v in arrays.items()}, uri=uri)
           for s in range(n)]
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


def pack_cidr_sharded(arrays: dict) -> dict:
    """Stacked HashCidrTable arrays [S, ...] -> the packed layout
    (ops/fused.py pack_cidr_table) of every shard, stacked."""
    n = arrays["s_used"].shape[0]
    per = [F.pack_cidr_table({k: v[s] for k, v in arrays.items()})
           for s in range(n)]
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


# ------------------------------------------------- stacked tables, queries

class ShardedTable(dict):
    """A stacked table on the card (name -> tensor [S, ...]) checked for
    B8: `kind` ("hint", "cidr", "fp_hint", "fp_cidr"), `shards` (S),
    `device`, `base` (shard 0's table as its unsharded kernel prepares
    it: the launch arguments' table half) and `strides` (name ->
    elements per shard)."""


class ShardQueries(dict):
    """A hint batch for S shards (name -> tensor): the keys in `stacked`
    are [S, B, ...], one encoding per shard; the others [B, ...], the
    one encoding every shard shares."""

    stacked: frozenset = frozenset()


def shard_view(d: dict, j: int, stacked=None) -> dict:
    """Shard j's view of a stacked dict: the `stacked` keys (all when
    None) indexed at j, the rest as they are."""
    keys = d.keys() if stacked is None else stacked
    return {k: (v[j] if k in keys else v) for k, v in d.items()}


def _stack_check(t: dict, what: str) -> tuple:
    """-> (S, device, strides) of a stacked table; raises ValueError
    unless every array is a contiguous [S, ...] tensor on one CUDA
    device."""
    first = next(iter(t.values()))
    s, dev = first.shape[0], first.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    if s <= 0:
        raise ValueError(f"{what}: no shards")
    for k, v in t.items():
        if v.device != dev or v.dim() < 1 or v.shape[0] != s or \
                not v.is_contiguous():
            raise ValueError(f"{what}: {k} must be a contiguous [S={s}, ...]"
                             f" tensor on {dev}")
    return s, dev, {k: int(v[0].numel()) for k, v in t.items()}


def _sharded(t: dict, kind: str, base, strides: dict, s: int, dev):
    st = ShardedTable(t)
    st.kind, st.base, st.strides, st.shards, st.device = (kind, base,
                                                           strides, s, dev)
    return st


def prepare_hint(t: dict) -> ShardedTable:
    """Check a stacked packed hint table (pack_hint_sharded's, on the
    card) once for B8 and build + load the library. Raises ValueError
    on a bad table (before any build), KernelError when the library
    cannot be built or loaded."""
    if isinstance(t, ShardedTable):
        return t
    s, dev, strides = _stack_check(t, "sharded hint kernel")
    _lib()
    base = FC.prepare_table(shard_view(t, 0), build_kernel=False)
    # every shard's rows as aligned as the base: the compare word
    # divides the per-shard strides of the byte tables too
    base.word = base.args.word = FC.word_bytes(
        base.hw, base.uw,
        *(v for k in ("pk_bytes", "pk_hkey", "pk_ukey") if k in t
          for v in (t[k].data_ptr(), strides[k])))
    return _sharded(t, "hint", base, strides, s, dev)


def prepare_cidr(t: dict) -> ShardedTable:
    """Check a stacked packed cidr table (pack_cidr_sharded's) once for
    B8 (see prepare_hint)."""
    if isinstance(t, ShardedTable):
        return t
    s, dev, strides = _stack_check(t, "sharded cidr kernel")
    _lib()
    base = CC.prepare_table(shard_view(t, 0), build_kernel=False)
    return _sharded(t, "cidr", base, strides, s, dev)


def prepare_fp_hint(t: dict) -> ShardedTable:
    """Check a stacked FpHintTable's arrays once for B8."""
    if isinstance(t, ShardedTable):
        return t
    s, dev, strides = _stack_check(t, "sharded fp hint kernel")
    _lib()
    base = FPC.prepare_hint_table(shard_view(t, 0), build_kernel=False)
    return _sharded(t, "fp_hint", base, strides, s, dev)


def prepare_fp_cidr(t: dict) -> ShardedTable:
    """Check a stacked FpCidrTable's arrays once for B8."""
    if isinstance(t, ShardedTable):
        return t
    s, dev, strides = _stack_check(t, "sharded fp cidr kernel")
    _lib()
    base = FPC.prepare_cidr_table(shard_view(t, 0), build_kernel=False)
    return _sharded(t, "fp_cidr", base, strides, s, dev)


# ------------------------------------------------------ the plain version

def _hint_key(level: torch.Tensor, idx: torch.Tensor, s: int,
              size: int) -> torch.Tensor:
    g = s * size + idx.long()
    lvl = torch.where(idx >= 0, level.long(), torch.zeros_like(g))
    return torch.where(lvl > 0, (lvl << 32) | (BIG - g),
                       torch.zeros_like(g))


def _cidr_key(idx: torch.Tensor, s: int, size: int) -> torch.Tensor:
    g = s * size + idx.long()
    return torch.where(idx >= 0, BIG - g, torch.zeros_like(g))


def hint_keys_plain(t: dict, q: dict, size: int, s0: int = 0,
                    fp: bool = False) -> torch.Tensor:
    """The plain version's keys of a hint batch: per local shard j (the
    global shard s0 + j) the plain single-shard matcher
    (hashmatch.hint_hash_match on the raw cuckoo arrays, or
    fphash.hint_fp_match), its (idx, level) turned into keys, the max
    over the shards. -> int64 [B]."""
    from . import fphash as FP
    from . import hashmatch as H
    n = next(iter(t.values())).shape[0]
    stacked = getattr(q, "stacked", None)
    keys = None
    for j in range(n):
        tj, qj = shard_view(t, j), shard_view(q, j, stacked)
        idx, lvl = FP.hint_fp_match(tj, qj) if fp else \
            H.hint_hash_match(tj, qj)
        k = _hint_key(lvl, idx, s0 + j, size)
        keys = k if keys is None else torch.maximum(keys, k)
    return keys


def cidr_keys_plain(t: dict, a16, fam, port, size: int, s0: int = 0,
                    fp: bool = False) -> torch.Tensor:
    """The plain version's keys of an address batch: per local shard the
    plain first match (hashmatch.cidr_hash_match, or
    fphash.cidr_fp_match), the max of BIG - gidx. -> int64 [B]."""
    from . import fphash as FP
    from . import hashmatch as H
    n = next(iter(t.values())).shape[0]
    keys = None
    for j in range(n):
        tj = shard_view(t, j)
        li = FP.cidr_fp_match(tj, a16, fam, port) if fp else \
            H.cidr_hash_match(tj, a16, fam, port)
        k = _cidr_key(li, s0 + j, size)
        keys = k if keys is None else torch.maximum(keys, k)
    return keys


def finish_plain(keys: torch.Tensor) -> torch.Tensor:
    """Keys -> int32 answers: BIG - (key & 0xffffffff), -1 for 0."""
    return torch.where(keys > 0, BIG - (keys & 0xFFFFFFFF),
                       torch.full_like(keys, -1)).to(torch.int32)


def hint_pick_plain(t: dict, q: dict, size: int, mtab: torch.Tensor,
                    slots: torch.Tensor, s0: int = 0, fp: bool = False,
                    group=None) -> torch.Tensor:
    """The plain version of B8 with its Maglev column: the plain keys
    (reduced across the ranks of `group`), finish_plain, and B5's plain
    take (take_cuda.take_plain) of this rank's slots -> int32 [B, 2]."""
    from .take_cuda import take_plain
    v = finish_plain(_reduce(hint_keys_plain(t, q, size, s0, fp), group))
    return torch.stack([v, take_plain(mtab, slots).to(torch.int32)], dim=1)


# ------------------------------------------------------------- the kernel

def _strides(t: ShardedTable, names: tuple, into) -> None:
    for i, k in enumerate(names):
        into[i] = t.strides.get(k, 0)


def _query_strides(q: ShardQueries, names: tuple, into) -> None:
    for i, k in enumerate(names):
        if k in q and k in q.stacked:
            into[i] = int(q[k][0].numel())


def _check_shards(t: ShardedTable, s: int) -> None:
    if t.shards != s:
        raise ValueError(f"sharded kernel: {t.kind} table has {t.shards} "
                         f"shards, the launch {s}")


def _pick_args(pick, b: int, dev):
    """The Maglev column's launch argument: `pick` (mtab, slots, out) ->
    a _ShardedPickArgs by reference (the picks to out's column 1, rows of
    2 ints), or None."""
    if pick is None:
        return None
    mtab, slots, out = pick
    TC.check_column(mtab, slots, b, dev, "sharded kernel")
    return ctypes.byref(_ShardedPickArgs(
        mtab=mtab.data_ptr(), mslots=slots.data_ptr(),
        pick=out[:, 1].data_ptr(), m=mtab.shape[0], ostride=2))


def _launch_hash(hint, cidr, b: int, ncols: int, s: int, s0: int, keys,
                 out, dev, layout: int, pick=None) -> None:
    a = _ShardedHashArgs()
    if hint is not None:
        t, q, size = hint
        if t.kind != "hint":
            raise ValueError(f"sharded kernel: a {t.kind} table in the "
                             "cuckoo hint column")
        _check_shards(t, s)
        q0 = shard_view(q, 0, q.stacked)
        for k in q.stacked:
            if q[k].shape[0] != s:
                raise ValueError(f"sharded kernel: {k} holds "
                                 f"{q[k].shape[0]} shards, want {s}")
        h = FC._query_args(t.base, q0)
        if h.b != b:
            raise ValueError(f"sharded kernel: hint batch {h.b}, want {b}")
        h.out, h.m = None, 0
        a.h = h
        _strides(t, HASH_STRIDED, a.hstride)
        _query_strides(q, HASH_STRIDED, a.hstride)
        a.size[0] = size
    col = 0 if hint is None else 1
    a16_fam = None
    for i, (t, a16, fam, port, size) in enumerate(cidr):
        if t.kind != "cidr":
            raise ValueError(f"sharded kernel: a {t.kind} table in a "
                             "cuckoo cidr column")
        _check_shards(t, s)
        CC.check_queries(t.base, a16, fam, port, b)
        if a16_fam is not None and (a16, fam) != a16_fam:
            raise ValueError("sharded kernel: the cidr columns read one "
                             "address batch")
        a16_fam = (a16, fam)
        a.c[i] = _CidrTable(**t.base.ptrs, **t.base.ints)
        a.cport[i] = None if port is None else port.data_ptr()
        _strides(t, CIDR_STRIDED, a.cstride[i])
        a.size[col + i] = size
    if a16_fam is not None:
        a.a16, a.fam = a16_fam[0].data_ptr(), a16_fam[1].data_ptr()
    a.keys = None if keys is None else keys.data_ptr()
    a.out = None if out is None else out.data_ptr()
    a.b, a.ncols, a.s0 = b, ncols, s0
    uri = hint is not None and hint[0].base.uri
    err = (_LIB or _lib()).vproxy_sharded_hash(
        ctypes.byref(a), _pick_args(pick, b, dev), s, layout, int(uri),
        dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise KernelError(f"sharded kernel launch failed: CUDA error {err}")


def _launch_fp(hint, cidr, b: int, ncols: int, s: int, s0: int, keys, out,
               dev, layout: int, pick=None) -> None:
    a = _ShardedFpArgs()
    if len(cidr) > 1:
        raise ValueError("sharded kernel: the fingerprint form answers one "
                         "cidr column")
    if hint is not None:
        t, q, size = hint
        if t.kind != "fp_hint":
            raise ValueError(f"sharded kernel: a {t.kind} table in the fp "
                             "hint column")
        _check_shards(t, s)
        for k in q.stacked:
            if q[k].shape[0] != s:
                raise ValueError(f"sharded kernel: {k} holds "
                                 f"{q[k].shape[0]} shards, want {s}")
        h = FPC._hint_args(t.base, shard_view(q, 0, q.stacked))
        if h.b != b:
            raise ValueError(f"sharded kernel: hint batch {h.b}, want {b}")
        h.out_stride = 1
        a.h = h
        _strides(t, FPH_STRIDED, a.hstride)
        _query_strides(q, FPH_STRIDED, a.hstride)
        a.size[0] = size
    if cidr:
        t, a16, fam, port, size = cidr[0]
        if t.kind != "fp_cidr":
            raise ValueError(f"sharded kernel: a {t.kind} table in the fp "
                             "cidr column")
        _check_shards(t, s)
        FC._check("a16", a16, dev, torch.uint8)
        FC._check("fam", fam, dev, torch.int32)
        if port is not None:
            FC._check("port", port, dev, torch.int32)
        if tuple(a16.shape) != (b, 16) or tuple(fam.shape) != (b,) or (
                port is not None and tuple(port.shape) != (b,)):
            raise ValueError(f"sharded kernel: want a16 [{b}, 16], fam "
                             f"[{b}], port [{b}]")
        a.c = FPC._FpCidrArgs(
            a16=a16.data_ptr(), fam=fam.data_ptr(),
            port=None if port is None else port.data_ptr(), out=None, b=b,
            out_stride=1, **t.base.ptrs, **t.base.ints)
        _strides(t, FPC_STRIDED, a.cstride)
        a.size[0 if hint is None else 1] = size
    a.keys = None if keys is None else keys.data_ptr()
    a.out = None if out is None else out.data_ptr()
    a.b, a.ncols, a.s0 = b, ncols, s0
    err = (_LIB or _lib()).vproxy_sharded_fp(
        ctypes.byref(a), _pick_args(pick, b, dev), s, layout,
        dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise KernelError(f"sharded kernel launch failed: CUDA error {err}")


# B8's layouts (csrc/sharded_match.cu `Layout`): the launcher's choice
# by the batch, a query's shards over several warps, one warp a query
# over every shard
LAYOUTS = {"auto": 0, "split": 1, "interleaved": 2}


@card_entry("sharded kernel")
def sharded_cuda(hint=None, cidr: Sequence = (), s0: int = 0,
                 finish: bool = True, layout: str = "auto", pick=None,
                 out=None):
    """Launch B8 once over every local shard: `hint` a (ShardedTable,
    ShardQueries, shard_size) column or None, `cidr` up to two (the
    fingerprint form: one) (ShardedTable, a16, fam, port or None,
    shard_size) columns after it; s0 the global index of the tables'
    first shard; `layout` one of LAYOUTS ("auto" on every path; the
    others for the checks and timings that hold both). -> int32 [B,
    ncols] answers, or with finish=False the int64 [B, ncols] keys (for
    a reduction across ranks, then finish_cuda). `pick` (mtab int32
    [M], slots int64 [B]), with a hint column alone: the Maglev column,
    -> int32 [B, 2] (answer, pick) rows; with finish=False the keys, the
    picks written into column 1 of `out` (int32 [B, 2], which
    finish_cuda(keys, out) completes). CUDA tensors only; raises
    KernelError unless it launched (card_entry)."""
    if layout not in LAYOUTS:
        raise ValueError(f"sharded kernel: layout {layout!r}, want one of "
                         f"{sorted(LAYOUTS)}")
    tabs = ([hint[0]] if hint is not None else []) + [c[0] for c in cidr]
    if not tabs:
        raise ValueError("sharded kernel: no column")
    for t in tabs:
        if not isinstance(t, ShardedTable):
            raise ValueError("sharded kernel: tables must be prepared "
                             "(ops/sharded_cuda.prepare_*)")
    dev, s = tabs[0].device, tabs[0].shards
    fp = tabs[0].kind.startswith("fp_")
    if any(t.kind.startswith("fp_") != fp or t.device != dev for t in tabs):
        raise ValueError("sharded kernel: one family and one device a "
                         "launch")
    sizes = ([hint[2]] if hint is not None else []) + [c[4] for c in cidr]
    if s0 < 0 or (s0 + s) * max(sizes) > BIG:
        raise ValueError("sharded kernel: global indices reach 2^30")
    b = (hint[1]["hp_slot"].shape[-2] if fp else hint[1]["hostb"].shape[0]) \
        if hint is not None else cidr[0][1].shape[0]
    ncols = len(tabs)
    if pick is not None:
        if hint is None or cidr:
            raise ValueError("sharded kernel: a Maglev column goes beside "
                             "the hint column alone")
        if finish:
            out = torch.empty((b, 2), dtype=torch.int32, device=dev)
        elif out is None:
            raise ValueError("sharded kernel: keys with a Maglev column "
                             "want `out` for the picks")
        FC._check("out", out, dev, torch.int32)
        if tuple(out.shape) != (b, 2):
            raise ValueError(f"sharded kernel: out {tuple(out.shape)}, "
                             f"want ({b}, 2)")
        pick = (*pick, out)
    # every (query, column) is written once: no fill before the launch
    res = out if finish and pick is not None else torch.empty(
        (b, ncols), device=dev,
        dtype=torch.int32 if finish else torch.int64)
    (_launch_fp if fp else _launch_hash)(
        hint, list(cidr), b, ncols, s, s0, None if finish else res,
        res if finish else None, dev, LAYOUTS[layout], pick)
    sharded_cuda.launches += 1
    if pick is not None:
        sharded_cuda.pick_launches += 1
    return res


sharded_cuda.launches = 0  # every launch
sharded_cuda.pick_launches = 0  # of which: with the Maglev column


@card_entry("sharded finish kernel")
def finish_cuda(keys: torch.Tensor, out=None) -> torch.Tensor:
    """B8's last pass after a cross-rank reduction: int64 keys (any
    shape, contiguous, CUDA) -> int32 answers of the same shape; or,
    keys [B, 1] with `out` int32 [B, 2] (its picks in column 1, B8's
    Maglev column), the answers into column 0 of `out` (-> out)."""
    if keys.device.type != "cuda" or keys.dtype != torch.int64 or \
            not keys.is_contiguous():
        raise ValueError("sharded finish: keys must be a contiguous int64 "
                         "CUDA tensor")
    ncols = keys.shape[-1] if keys.dim() else 1
    if out is None:
        out = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
        ostride = ncols
    else:
        FC._check("out", out, keys.device, torch.int32)
        if keys.dim() != 2 or ncols != 1 or \
                tuple(out.shape) != (keys.shape[0], 2):
            raise ValueError(f"sharded finish: keys {tuple(keys.shape)} "
                             f"into out {tuple(out.shape)}, want [B, 1] "
                             f"into [B, 2]")
        ostride = 2
    err = (_LIB or _lib()).vproxy_sharded_finish(
        keys.data_ptr(), out.data_ptr(), keys.numel(), ncols, ostride,
        keys.device.index or 0,
        torch.cuda.current_stream(keys.device).cuda_stream)
    if err:
        raise KernelError(f"sharded finish launch failed: CUDA error {err}")
    finish_cuda.launches += 1
    return out


finish_cuda.launches = 0  # every launch


# ------------------------------------------------------------- the entries

def _reduce(keys: torch.Tensor, group) -> torch.Tensor:
    """The keys of every rank of the rules axis: one all_reduce(MAX) on
    the group (a no-op without one)."""
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(keys, op=dist.ReduceOp.MAX, group=group)
    return keys


def _on_card(t: dict) -> bool:
    return next(iter(t.values())).device.type != "cpu"


def hint_sharded(t: dict, q: dict, size: int, s0: int = 0, fp: bool = False,
                 group=None) -> torch.Tensor:
    """The sharded hint answer, int32 [B]: CPU tensors take the plain
    version (raw stacked arrays), CUDA tensors B8 (a prepared
    ShardedTable). `group`: the process group of the rules axis when it
    spans ranks."""
    if not _on_card(t):
        return finish_plain(_reduce(hint_keys_plain(t, q, size, s0, fp),
                                    group))
    if group is None:
        return sharded_cuda((t, q, size), s0=s0)[:, 0]
    keys = sharded_cuda((t, q, size), s0=s0, finish=False)
    return finish_cuda(_reduce(keys, group))[:, 0]


def hint_pick_sharded(t: dict, q: dict, size: int, mtab: torch.Tensor,
                      slots: torch.Tensor, s0: int = 0, fp: bool = False,
                      group=None) -> torch.Tensor:
    """The sharded hint answer and the Maglev pick of a classify+pick
    batch, int32 [B, 2]: CPU tensors take the plain version
    (hint_pick_plain), CUDA tensors ONE launch of B8 with its Maglev
    column. Across the ranks of `group` only the keys are reduced; each
    rank's picks are its own."""
    if not _on_card(t):
        return hint_pick_plain(t, q, size, mtab, slots, s0, fp, group)
    if group is None:
        return sharded_cuda((t, q, size), s0=s0, pick=(mtab, slots))
    b = slots.shape[0]
    out = torch.empty((b, 2), dtype=torch.int32, device=slots.device)
    keys = sharded_cuda((t, q, size), s0=s0, finish=False,
                        pick=(mtab, slots), out=out)
    return finish_cuda(_reduce(keys, group), out)


def cidr_sharded(t: dict, a16, fam, port, size: int, s0: int = 0,
                 fp: bool = False, group=None) -> torch.Tensor:
    """The sharded first match, int32 [B] (see hint_sharded)."""
    if not _on_card(t):
        return finish_plain(_reduce(
            cidr_keys_plain(t, a16, fam, port, size, s0, fp), group))
    col = [(t, a16, fam, port, size)]
    if group is None:
        return sharded_cuda(cidr=col, s0=s0)[:, 0]
    keys = sharded_cuda(cidr=col, s0=s0, finish=False)
    return finish_cuda(_reduce(keys, group))[:, 0]


def classify_sharded(ht: dict, rt: dict, at: dict, hq: dict, a16, fam,
                     port, sizes: tuple, s0: int = 0,
                     group=None) -> torch.Tensor:
    """Hint, route and ACL answers of one batch on the cuckoo tables,
    int32 [B, 3]: on the card ONE launch of B8 (three columns), on the
    CPU the plain version. `sizes`: the three tables' shard sizes."""
    if not _on_card(ht):
        keys = torch.stack([
            hint_keys_plain(ht, hq, sizes[0], s0),
            cidr_keys_plain(rt, a16, fam, None, sizes[1], s0),
            cidr_keys_plain(at, a16, fam, port, sizes[2], s0)], dim=1)
        return finish_plain(_reduce(keys.contiguous(), group))
    cols = [(rt, a16, fam, None, sizes[1]), (at, a16, fam, port, sizes[2])]
    if group is None:
        return sharded_cuda((ht, hq, sizes[0]), cols, s0=s0)
    keys = sharded_cuda((ht, hq, sizes[0]), cols, s0=s0, finish=False)
    return finish_cuda(_reduce(keys, group))
