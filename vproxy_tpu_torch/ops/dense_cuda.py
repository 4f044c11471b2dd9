"""The hand-written CUDA kernels of the dense backend (B9).

csrc/dense_match.cu replaces `vproxy_tpu/ops/matchers.py`
`hint_match(_chunked)` and `cidr_first_match(_chunked)` (the bit-plane
product of `ops/bitmatch.py` and the level / first-match reductions) by
a masked word compare; its note gives the bound and the design. This
module packs the layout it reads, builds it with nvcc
(fused_cuda.build_library: sm_90a, content-keyed into _build/), loads
it with ctypes and launches it on PyTorch's current stream.

* `pack_dense_hint_table` / `pack_dense_cidr_table` derive the packed
  layout from the reference's arrays (ops/tables.py) when a matcher
  publishes: per bit m = (W != 0), v = (W < 0), packed most significant
  bit first as np.unpackbits reads them, into little-endian 32-bit
  words. Hint: the active rules grouped by (host chunks, uri chunks,
  port gate) into tiles of TILE rows, each rule's live chunks only
  (only the active rules' columns of the weights are read), and the
  64-bit key's index field where the last live rule lies past
  NARROW_RULES; cidr: per family the valid patterns in ascending rule
  order. The packing is host work at publish (a stable sort of the
  rules).
* `hint_rows` reads a hint layout back row by row (the tests' torch
  form of the kernel and the bound's word counts use it).
* `DenseTable` is what a "torch-dense" matcher publishes: the
  reference's arrays (the plain tier's, and what published_table_bytes
  counts) with the kernel's layout beside them as `packed`.
* `prepare_hint` / `prepare_cidr` check a packed layout once and build
  + load the library, so a build failure stops a publish; the wrappers
  take only a layout prepared so.
* `hint_pattern_words` / `cidr_slot_words` read back from a layout the
  words with a mask bit of each pattern: the words a query must compare
  (chip_smoke.py's bound counts them).
* `hint_dense_cuda` and `cidr_dense_cuda` are the kernel wrappers
  (ops/matchers.py `hint_dense` / `hint_dense_pick` / `cidr_dense` /
  `classify_dense` are the entries); each counts the launches it made
  in `launches`. With a Maglev column (`mtab`, `slots`) B9's hint is
  one launch answering a classify+pick batch's (verdict, pick) rows:
  B5's take folded in (`hint_dense_cuda.pick_launches` counts those).
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from . import fused_cuda as FC
from . import take_cuda as TC
from .fused_cuda import KernelError, card_entry
from .tables import HOST_SLOT, MAX_URI, V4, V6

SOURCE = os.path.join(os.path.dirname(FC.SOURCE), "dense_match.cu")

HOST_WORDS = (HOST_SLOT + 3) // 4  # 17: 66 bytes padded to 68
URI_WORDS = MAX_URI // 4           # 32
# packed host word j holds the query's word HOST_ORDER[j]: the word of
# the length byte first, so every pattern's live words are a prefix
HOST_ORDER = [HOST_WORDS - 1] + list(range(HOST_WORDS - 1))
TILE = 32                 # hint rows a tile (csrc/dense_match.cu)
CTILE = 64                # cidr entries a tile
HC_MAX, UC_MAX = 5, 8     # host chunks (20 words >= 17), uri chunks (32)
# the 32-bit hint key holds 20 bits of rule index; a table whose last
# live rule lies past NARROW_RULES takes the 64-bit key's instances,
# whose index field holds 31 bits (every index an int32 rule list has)
NARROW_RULES = 1 << 20
IDX_MASK = NARROW_RULES - 1
WIDE_MASK = (1 << 31) - 1
WIDE_CODE = 1 << 17       # a tile code's flag: the table's key is wide
# a mask bit on the host slot's padding byte 67 (the length byte's
# word, packed first): the query's byte is 0, the value bit 1, so an
# absent exact or suffix pattern carrying it never matches
POISON = 1 << 31
MAX_THREADS = 128         # queries per block, at most
CIDR_Q = 4                # cidr queries a thread past 4 x MAX_THREADS
# blocks a launch aims for: two waves of the blocks an SM holds (4 for
# a hint block of Q = 2 at <= 128 registers); a cidr launch of one
# query a thread many more (ranges of a tile or two: its blocks hold a
# few queries of each family, and more of them hide the tiles' latency)
TARGET_BLOCKS = {1: 132 * 16, 2: 132 * 8, "cidr": 132 * 8,
                 "cidr1": 132 * 32}


class DenseTable(dict):
    """A published dense table: the reference's arrays as tensors, with
    `packed`, the kernel's layout (a PreparedDense), on the card."""

    packed = None


class PreparedDense(dict):
    """A packed layout (the dict of tensors) checked for its kernel, with
    `device` and its launch sizes cached: hint `n_tiles`, `stage_vec`
    (the largest tile, uint4s) and `wide` (the 64-bit key); cidr `n4`
    and `n6`."""

    wide = False


def _planes(w: np.ndarray, nbytes: int) -> tuple:
    """Bit-plane weights [nbytes*8, N] -> (mask, value) uint8 [N,
    nbytes], bits most significant first."""
    m = np.packbits(w != 0, axis=0).T
    v = np.packbits(w < 0, axis=0).T
    assert m.shape[1] == nbytes
    return m, v


def _words(b: np.ndarray, nwords: int) -> np.ndarray:
    """uint8 [N, L] -> uint32 [N, nwords], little-endian, zero-padded."""
    out = np.zeros((b.shape[0], nwords * 4), np.uint8)
    out[:, :b.shape[1]] = b
    return out.view("<u4")


def _live_words(m: np.ndarray) -> np.ndarray:
    """Mask words [N, W] -> the live prefix of each row: the last word
    with a mask bit, plus one (0 for none)."""
    nz = m != 0
    return np.where(nz.any(axis=1),
                    m.shape[1] - np.argmax(nz[:, ::-1], axis=1), 0)


def _n_live(rows_live: np.ndarray) -> int:
    nz = np.flatnonzero(rows_live)
    return int(nz[-1]) + 1 if nz.size else 0


def _tile_vec(hc, uc):
    """uint4s of a hint tile: TILE meta rows, host and uri chunks."""
    return TILE * (1 + 3 * hc + 2 * uc)


def pack_dense_hint_table(arrays: dict) -> dict:
    """A compiled HintTable's arrays (tables.compile_hint_rules) -> the
    B9 hint layout (numpy int32): `rows` [R, 4], the tiles one after
    another, each TILE meta rows (the index field, port, uri level on a
    match | on a miss << 10 | host wildcard << 20, 1; a pad row is 0),
    then per row its host chunks (exact masks, suffix masks, values of 4
    words in HOST_ORDER), then its uri chunks (masks, values of 4
    words); `tiles` [T, 4], per tile its first row, host chunks | uri
    chunks << 8 | gated << 16 | WIDE_CODE (the table's key is 64-bit),
    0, 0. The index field is IDX_MASK - rule, or WIDE_MASK - rule when
    the last live rule lies past NARROW_RULES (then every tile carries
    WIDE_CODE). Only the active rules' columns of the weights are read.
    The active rules are grouped by those three (stable: ascending rule
    order within a group); an absent exact or suffix pattern, and every
    pad row of a tile with host chunks, carries the POISON bit. Raises
    ValueError for an exact and a suffix pattern whose values differ
    where both mask (tables.compile_hint_rules never makes one)."""
    n = _n_live(arrays["active"])
    live = np.flatnonzero(arrays["active"][:n])
    wide = n > NARROW_RULES
    cols = np.stack([2 * live, 2 * live + 1], axis=1).reshape(-1)
    hm, hv = _planes(arrays["host_w"][:, cols], HOST_SLOT)
    pad = np.zeros((live.size, 4 * HC_MAX - HOST_WORDS), np.uint32)
    hm = _words(hm, HOST_WORDS)[:, HOST_ORDER]
    hv = _words(hv, HOST_WORDS)[:, HOST_ORDER]
    me, ms, ve, vs = hm[0::2], hm[1::2], hv[0::2], hv[1::2]
    if np.any((ve & ms) != (vs & me)):
        raise ValueError("dense hint layout: an exact and a suffix "
                         "pattern differ where both mask")
    me, ms, v = (np.concatenate([x, pad], 1) for x in (me, ms, ve | vs))
    hvalid = arrays["host_valid"][live]
    held = hvalid.any(axis=1)
    for col, m in ((0, me), (1, ms)):
        m[held & ~hvalid[:, col], 0] |= POISON
    v[held & ~hvalid.all(axis=1), 0] |= POISON
    um, uv = _planes(arrays["uri_w"][:, live], MAX_URI)
    um, uv = _words(um, URI_WORDS), _words(uv, URI_WORDS)
    hc = -(-_live_words(me | ms) // 4)
    uc = -(-_live_words(um) // 4)
    port = arrays["port"][live].astype(np.int32)
    wild = arrays["uri_wild"][live].astype(np.uint32)
    hit = np.maximum(np.where(arrays["uri_valid"][live],
                              arrays["uri_score"][live], 0), wild)
    meta = np.stack([(WIDE_MASK if wide else IDX_MASK) -
                     live.astype(np.uint32),
                     port.view(np.uint32),
                     hit.astype(np.uint32) | wild << 10 |
                     arrays["host_wild"][live].astype(np.uint32) << 20,
                     np.ones(live.size, np.uint32)], axis=1)
    gated = (port != 0).astype(np.int64)
    # positions into the live rules, grouped; ascending rule order within
    # a group (live is ascending)
    order = np.lexsort((live, gated, uc, hc))
    rows, tiles, off = [], [], 0
    keys = np.stack([hc[order], uc[order], gated[order]], axis=1)
    cuts = np.flatnonzero(np.any(keys[1:] != keys[:-1], axis=1)) + 1
    flag = WIDE_CODE if wide else 0
    for grp in np.split(order, cuts) if order.size else []:
        h, u, g = int(hc[grp[0]]), int(uc[grp[0]]), int(gated[grp[0]])
        nt = -(-grp.size // TILE)
        rm = np.zeros((nt * TILE, 4), np.uint32)
        rm[:grp.size] = meta[grp]
        rh = np.zeros((nt * TILE, h, 3, 4), np.uint32)
        for k, x in enumerate((me, ms, v)):
            rh[:grp.size, :, k] = x[grp, :4 * h].reshape(grp.size, h, 4)
        if h:
            rh[grp.size:, 0, :, 0] = POISON  # pad rows: no pattern holds
        ru = np.zeros((nt * TILE, u, 2, 4), np.uint32)
        for k, x in enumerate((um, uv)):
            ru[:grp.size, :, k] = x[grp, :4 * u].reshape(grp.size, u, 4)
        blob = np.concatenate([rm.reshape(nt, TILE, 4),
                               rh.reshape(nt, TILE * h * 3, 4),
                               ru.reshape(nt, TILE * u * 2, 4)], axis=1)
        rows.append(blob.reshape(-1, 4))
        tv = _tile_vec(h, u)
        for i in range(nt):
            tiles.append((off + i * tv, h | u << 8 | g << 16 | flag, 0, 0))
        off += nt * tv
    rows = np.concatenate(rows) if rows else np.zeros((0, 4), np.uint32)
    return {"rows": np.ascontiguousarray(rows.view(np.int32)),
            "tiles": np.array(tiles, np.int32).reshape(-1, 4)}


def pack_dense_cidr_table(arrays: dict) -> dict:
    """A compiled CidrTable's arrays (tables.compile_cidr_rules) -> the
    B9 cidr layout (numpy int32), per family the valid pattern slots in
    ascending (rule, slot) order: `v4` [n4, 4] (mask and value of the
    address's last word, rule, min port | max port << 16), `v6` [n6, 3,
    4] (4 mask words, 4 value words, (rule, ports, 0, 0)). Raises
    ValueError for an IPv4 pattern that masks a word but the last
    (tables.compile_cidr_rules never makes one)."""
    valid = arrays["valid"].reshape(-1, 3)
    n = _n_live(valid.any(axis=1))
    m, v = _planes(arrays["w"][:, :3 * n], 16)
    m, v = _words(m, 4).reshape(n, 3, 4), _words(v, 4).reshape(n, 3, 4)
    fam = arrays["family"].reshape(-1, 3)[:n]
    ports = (arrays["min_port"][:n].astype(np.uint32) & 0xFFFF) | \
        arrays["max_port"][:n].astype(np.uint32) << 16
    r4, s4 = np.nonzero(valid[:n] & (fam == V4))
    if np.any(m[r4, s4, :3] != 0):
        raise ValueError("dense cidr layout: an IPv4 pattern masks more "
                         "than its last word")
    v4 = np.stack([m[r4, s4, 3], v[r4, s4, 3], r4.astype(np.uint32),
                   ports[r4]], axis=1).reshape(-1, 4)
    r6, s6 = np.nonzero(valid[:n] & (fam == V6))
    v6 = np.zeros((r6.size, 3, 4), np.uint32)
    v6[:, 0], v6[:, 1] = m[r6, s6], v[r6, s6]
    v6[:, 2, 0], v6[:, 2, 1] = r6, ports[r6]
    return {"v4": np.ascontiguousarray(v4.view(np.int32)),
            "v6": np.ascontiguousarray(v6.view(np.int32))}


def packed_of(table: dict, hint: bool) -> dict:
    """A published DenseTable's packed layout: its `packed` on the card;
    on the CPU (none published) packed here from its arrays, as
    tensors."""
    if table.packed is not None:
        return table.packed
    pack = pack_dense_hint_table if hint else pack_dense_cidr_table
    live = table["active"].cpu().numpy() if hint else None
    return {k: torch.from_numpy(v) for k, v in pack(
        {k: _host_planes(v, live) if v.dtype == torch.bfloat16 else
         v.cpu().numpy() for k, v in table.items()}).items()}


def _host_planes(w: torch.Tensor, active) -> np.ndarray:
    """Published bf16 planes [K, N] -> float32 numpy (exact). With a hint
    table's `active` flags only the active rules' columns (N / cap a
    rule: all the hint packer reads) are converted, into zeros whose
    pages stay untouched."""
    if active is None:
        return w.float().cpu().numpy()
    per = w.shape[1] // active.shape[0]
    cols = (np.flatnonzero(active)[:, None] * per +
            np.arange(per)).reshape(-1)
    out = np.zeros(tuple(w.shape), np.float32)
    out[:, cols] = w[:, torch.from_numpy(cols).to(w.device)].float().cpu(
        ).numpy()
    return out


def hint_rows(p: dict) -> dict:
    """A packed hint layout (tensors) read back row by row, in tile
    order: `meta` int32 [N, 4], `me` / `ms` / `v` int32 [N, 20] (host
    words in HOST_ORDER, zero past the row's chunks), `um` / `uv` int32
    [N, 32] (uri words), `code` int32 [N] (its tile's host chunks | uri
    chunks << 8 | gated << 16 | WIDE_CODE), `rule` int64 [N] (the rule
    index its meta row carries, -1 for a pad row)."""
    rows, tiles = p["rows"], p["tiles"]
    dev = rows.device
    out = {k: [] for k in ("meta", "me", "ms", "v", "um", "uv", "code")}
    for t in tiles.tolist():
        h, u = t[1] & 0xFF, (t[1] >> 8) & 0xFF
        blob = rows[t[0]:t[0] + _tile_vec(h, u)]
        out["meta"].append(blob[:TILE])
        host = blob[TILE:TILE * (1 + 3 * h)].reshape(TILE, h, 3, 4)
        uri = blob[TILE * (1 + 3 * h):].reshape(TILE, u, 2, 4)
        for k, name in enumerate(("me", "ms", "v")):
            x = torch.zeros(TILE, 4 * HC_MAX, dtype=torch.int32, device=dev)
            x[:, :4 * h] = host[:, :, k].reshape(TILE, -1)
            out[name].append(x)
        for k, name in enumerate(("um", "uv")):
            x = torch.zeros(TILE, URI_WORDS, dtype=torch.int32, device=dev)
            x[:, :4 * u] = uri[:, :, k].reshape(TILE, -1)
            out[name].append(x)
        out["code"].append(torch.full((TILE,), t[1], dtype=torch.int32,
                                      device=dev))
    if not out["meta"]:
        return {"meta": rows.new_zeros((0, 4)),
                **{k: rows.new_zeros((0, 4 * HC_MAX)) for k in
                   ("me", "ms", "v")},
                **{k: rows.new_zeros((0, URI_WORDS)) for k in ("um", "uv")},
                "code": rows.new_zeros(0),
                "rule": rows.new_zeros(0, dtype=torch.int64)}
    r = {k: torch.cat(v) for k, v in out.items()}
    mask = torch.where((r["code"] & WIDE_CODE) != 0, WIDE_MASK, IDX_MASK)
    r["rule"] = torch.where(r["meta"][:, 3] == 1,
                            mask.long() - r["meta"][:, 0].long(), -1)
    return r


def _mask_words(m: torch.Tensor) -> torch.Tensor:
    """int32 mask words [..., W] -> int64 [...]: the words with a bit."""
    return (m != 0).sum(-1)


def hint_pattern_words(p: dict) -> dict:
    """A packed hint layout (tensors) -> per packed row, int64 [N]:
    `host`, the words with a mask bit of its exact and of its suffix
    pattern, summed; `uri`, those of its uri prefix; 0 for a pattern the
    rule does not hold (the POISON bit marks it) and for a pad row.
    Beside them `active` (bool [N]: a rule, not a pad row) and `port`
    (int32 [N]). A word without a mask bit (the suffix's length-byte
    word, a pattern's tail) needs no compare."""
    r = hint_rows(p)

    def held(m):
        return torch.where((m[:, 0] & POISON) != 0, 0, _mask_words(m))
    return {"active": r["meta"][:, 3] == 1, "port": r["meta"][:, 1],
            "host": held(r["me"]) + held(r["ms"]),
            "uri": _mask_words(r["um"])}


def cidr_slot_words(p: dict) -> dict:
    """A packed cidr layout (tensors) -> `words`, int64 [n, 2]: per rule
    (up to the last with a pattern) the mask words with a bit of its
    valid slots of each family (column 0 IPv4, 1 IPv6: an IPv4 slot
    masks one word, a v6 /48 two); `min_port` / `max_port`, int32 [n]
    (0 for a rule with no pattern)."""
    v4, v6 = p["v4"], p["v6"]
    r4, r6 = v4[:, 2].long(), v6[:, 2, 0].long()
    n = int(max(r4.max() if r4.numel() else -1,
                r6.max() if r6.numel() else -1)) + 1
    words = torch.zeros((n, 2), dtype=torch.int64, device=v4.device)
    words[:, 0].index_add_(0, r4, (v4[:, 0] != 0).long())
    words[:, 1].index_add_(0, r6, _mask_words(v6[:, 0]))
    ports = torch.zeros(n, dtype=torch.int64, device=v4.device)
    ports[r4] = v4[:, 3].long() & 0xFFFFFFFF
    ports[r6] = v6[:, 2, 1].long() & 0xFFFFFFFF
    return {"words": words, "min_port": (ports & 0xFFFF).int(),
            "max_port": (ports >> 16).int()}


class _DenseHintArgs(ctypes.Structure):
    """Mirror of `struct DenseHintArgs` (pointers, then ints)."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "q_host", "q_uri", "has_host", "has_uri", "port", "rows", "tiles",
        "key", "done", "out_idx", "out_level")] + \
        [(n, ctypes.c_int) for n in ("b", "n_tiles", "threads", "split",
                                     "stage_vec", "q")]


class _DensePickArgs(ctypes.Structure):
    """Mirror of `struct DensePickArgs` (pointers, then ints): the Maglev
    column of the hint kernel's PICK instances."""
    _fields_ = [(n, ctypes.c_void_p) for n in ("mtab", "slots",
                                               "out_pick")] + \
        [(n, ctypes.c_int) for n in ("m", "ostride")]


class _DenseCidrArgs(ctypes.Structure):
    """Mirror of `struct DenseCidrArgs` (pointers, then ints)."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "a16", "fam", "port", "v4", "v6", "out")] + \
        [(n, ctypes.c_int) for n in ("b", "n4", "n6", "q", "split4",
                                     "split6")]


def build() -> str:
    """Compile csrc/dense_match.cu once; -> the shared library's path."""
    return FC.build_library(SOURCE, "libdense", "dense")


_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """Build (first use) and load the library. -> the ctypes handle,
    its ABI checked against the ctypes mirrors."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            path = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelError(f"cannot load {path}: {e}") from e
            for kind, args in (("hint", _DenseHintArgs),
                               ("cidr", _DenseCidrArgs),
                               ("pick", _DensePickArgs)):
                size = getattr(lib, f"vproxy_dense_{kind}_args_size")
                size.restype, size.argtypes = ctypes.c_int, []
                if size() != ctypes.sizeof(args):
                    raise KernelError(f"{args.__name__} ABI drift: C "
                                      f"{size()} B, ctypes "
                                      f"{ctypes.sizeof(args)} B")
            lib.vproxy_dense_hint.restype = ctypes.c_int
            lib.vproxy_dense_hint.argtypes = [
                ctypes.POINTER(_DenseHintArgs),
                ctypes.POINTER(_DensePickArgs), ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.vproxy_dense_cidr.restype = ctypes.c_int
            lib.vproxy_dense_cidr.argtypes = [
                ctypes.POINTER(_DenseCidrArgs), ctypes.c_int,
                ctypes.c_void_p]
            _LIB = lib
        return _LIB


_HINT_SHAPES = {"rows": (4,), "tiles": (4,)}
_CIDR_SHAPES = {"v4": (4,), "v6": (3, 4)}


def _prepare(p: dict, shapes: dict, what: str) -> PreparedDense:
    if isinstance(p, PreparedDense):
        return p
    dev = next(iter(p.values())).device
    if dev.type == "cpu":  # the plain tier's, never the kernel's
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    for k, tail in shapes.items():
        if k not in p:
            raise ValueError(f"{what}: missing {k!r}")
        FC._check(k, p[k], dev, torch.int32)
        if tuple(p[k].shape[1:]) != tail:
            raise ValueError(f"{what}: {k} must be [n, "
                             f"{', '.join(map(str, tail))}], got "
                             f"{tuple(p[k].shape)}")
    _lib()
    return PreparedDense(p)


def _tile_table(p: dict) -> torch.Tensor:
    """A hint layout's tile table on the host (int64), copied once at
    publish."""
    return p["tiles"].cpu().long()


def prepare_hint(p: dict) -> PreparedDense:
    """Check a packed hint layout (pack_dense_hint_table, uploaded) once
    for the kernel: every tile's chunk counts and rows inside `rows`
    (read back from the tile table at publish), and build + load the
    library. -> a PreparedDense (`p` itself when it already is one).
    Raises KernelError when the library cannot be built or loaded,
    ValueError on a bad layout."""
    if isinstance(p, PreparedDense):
        return p
    t = _prepare(p, _HINT_SHAPES, "dense hint kernel")
    tiles = _tile_table(p)
    hc, uc = tiles[:, 1] & 0xFF, (tiles[:, 1] >> 8) & 0xFF
    vec = _tile_vec(hc, uc)
    if bool(((hc > HC_MAX) | (uc > UC_MAX) | (tiles[:, 0] < 0) |
             (tiles[:, 0] + vec > p["rows"].shape[0])).any()):
        raise ValueError("dense hint kernel: a tile lies outside its rows")
    wide = (tiles[:, 1] & WIDE_CODE) != 0
    if bool(wide.any()) and not bool(wide.all()):
        raise ValueError("dense hint kernel: tiles disagree on the key "
                         "width")
    t.device, t.n_tiles = p["rows"].device, int(tiles.shape[0])
    t.stage_vec = int(vec.max()) if tiles.shape[0] else TILE
    t.wide = bool(wide.any())
    return t


def prepare_cidr(p: dict) -> PreparedDense:
    """The same for a packed cidr layout (pack_dense_cidr_table)."""
    if isinstance(p, PreparedDense):
        return p
    t = _prepare(p, _CIDR_SHAPES, "dense cidr kernel")
    t.device, t.n4, t.n6 = p["v4"].device, p["v4"].shape[0], \
        p["v6"].shape[0]
    return t


def hint_grid(b: int, n_tiles: int) -> tuple:
    """-> (threads per block, queries per thread Q, query tiles, tiles
    per range) of a hint launch over b queries and n_tiles tiles: Q = 2
    above MAX_THREADS queries, blocks of up to 4 warps, and tile ranges
    cut so the launch has at most TARGET_BLOCKS[Q] blocks."""
    q = 1 if b <= MAX_THREADS else 2
    threads = min(MAX_THREADS, 32 * -(-max(b, 1) // (32 * q)))
    tiles = -(-b // (threads * q))
    ranges = max(1, min(TARGET_BLOCKS[q] // max(tiles, 1), n_tiles))
    return threads, q, tiles, max(1, -(-n_tiles // ranges))


def _cidr_shape(b: int, q: int, n4: int, n6: int) -> tuple:
    threads = min(MAX_THREADS, 32 * -(-max(b, 1) // (32 * q)))
    tiles = -(-b // (threads * q))
    ranges = max(1, TARGET_BLOCKS["cidr1" if q == 1 else "cidr"] //
                 max(tiles, 1))
    per = max(1, -(-(n4 + 4 * n6) // ranges))
    split4 = CTILE * max(1, -(-per // CTILE))
    split6 = CTILE * max(1, -(-per // (4 * CTILE)))
    return q, threads, tiles, split4, split6, -(-n4 // split4)


def cidr_grid(b: int, n4: int, n6: int) -> tuple:
    """-> (queries per thread Q, threads per block, query tiles, IPv4
    entries per range, IPv6 entries per range, IPv4 ranges) of a cidr
    launch: ranges of whole CTILE tiles cut so the launch has at most
    about TARGET_BLOCKS["cidr"] blocks at Q = CIDR_Q (["cidr1"] at
    Q = 1), an IPv6 entry counted as four IPv4 ones (its words). Q is
    CIDR_Q past CIDR_Q x MAX_THREADS queries, and up to them too when
    that launch still has a block a scheduler (132 x 4: a large table);
    else 1 (a small batch or table: more blocks, each with less work,
    hide the tiles' latency)."""
    wide = _cidr_shape(b, CIDR_Q, n4, n6)
    blocks = wide[2] * (wide[5] + -(-n6 // wide[4]))
    if b > CIDR_Q * MAX_THREADS or (b > MAX_THREADS and blocks >= 132 * 4):
        return wide
    return _cidr_shape(b, 1, n4, n6)


def grid(b: int, p: PreparedDense) -> tuple:
    """The launch shape of a batch of b over a prepared layout
    (hint_grid or cidr_grid)."""
    if "tiles" in p:
        return hint_grid(b, p.n_tiles)
    return cidr_grid(b, p.n4, p.n6)


def _packed(table: dict, what: str) -> PreparedDense:
    p = getattr(table, "packed", None)
    if not isinstance(p, PreparedDense):
        raise ValueError(f"{what}: the table has no prepared packed "
                         f"layout (a DenseTable published on the card)")
    return p


def _launch(kind: str, a, dev: torch.device, *hint_args) -> None:
    """Launch B9's `kind` kernel; a hint launch also takes (its Maglev
    column's _DensePickArgs or None, the wide flag)."""
    err = getattr(_LIB or _lib(), f"vproxy_dense_{kind}")(
        ctypes.byref(a), *hint_args, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise KernelError(f"dense {kind} kernel launch failed: CUDA error "
                          f"{err}")


@card_entry("dense hint kernel")
def hint_dense_cuda(table: dict, q: dict, mtab=None, slots=None):
    """Launch B9 over a hint batch: same contract as
    matchers.hint_match_chunked on encode_hints' arrays (host uint8
    [B, 66], uri uint8 [B, 128], has_host / has_uri bool [B], port int32
    [B]), CUDA tensors only. -> (idx, level), int32 [B] views of one
    [B, 2] output; with a Maglev column (`mtab` int32 [M], `slots` int64
    [B]) -> int32 [B, 2] rows (rule index, mtab[clamp(slot, 0, M - 1)]),
    matchers.hint_dense_pick_plain's. `table` is a DenseTable with its
    packed layout (prepare_hint's); a wide layout launches the 64-bit
    key's instances. Raises KernelError unless it launched
    (card_entry)."""
    p = _packed(table, "dense hint kernel")
    dev = p.device
    b = q["host"].shape[0]
    for k, dtype, shape in (("host", torch.uint8, (b, HOST_SLOT)),
                            ("uri", torch.uint8, (b, MAX_URI)),
                            ("has_host", torch.bool, (b,)),
                            ("has_uri", torch.bool, (b,)),
                            ("port", torch.int32, (b,))):
        FC._check(k, q[k], dev, dtype)
        if tuple(q[k].shape) != shape:
            raise ValueError(f"dense hint kernel: {k} has shape "
                             f"{tuple(q[k].shape)}, want {shape}")
    threads, qn, tiles, split = hint_grid(b, p.n_tiles)
    # one fill: the per-query keys (8 bytes each when wide), then the
    # tiles' tickets
    kw = 2 if p.wide else 1
    scratch = torch.zeros(kw * b + tiles, dtype=torch.int32, device=dev)
    a = _DenseHintArgs(
        q_host=q["host"].data_ptr(), q_uri=q["uri"].data_ptr(),
        has_host=q["has_host"].data_ptr(), has_uri=q["has_uri"].data_ptr(),
        port=q["port"].data_ptr(), rows=p["rows"].data_ptr(),
        tiles=p["tiles"].data_ptr(), key=scratch.data_ptr(),
        done=scratch.data_ptr() + 4 * kw * b, b=b, n_tiles=p.n_tiles,
        threads=threads, split=split, stage_vec=p.stage_vec, q=qn)
    if mtab is not None:
        TC.check_column(mtab, slots, b, dev, "dense hint kernel")
        out = torch.empty((b, 2), dtype=torch.int32, device=dev)
        a.out_idx = out[:, 0].data_ptr()
        pick = _DensePickArgs(mtab=mtab.data_ptr(), slots=slots.data_ptr(),
                              out_pick=out[:, 1].data_ptr(),
                              m=mtab.shape[0], ostride=2)
        _launch("hint", a, dev, ctypes.byref(pick), int(p.wide))
        hint_dense_cuda.launches += 1
        hint_dense_cuda.pick_launches += 1
        return out
    out = torch.empty((2, b), dtype=torch.int32, device=dev)
    a.out_idx, a.out_level = out[0].data_ptr(), out[1].data_ptr()
    _launch("hint", a, dev, None, int(p.wide))
    hint_dense_cuda.launches += 1
    return out[0], out[1]


hint_dense_cuda.launches = 0  # every launch
hint_dense_cuda.pick_launches = 0  # of which: with the Maglev column


@card_entry("dense cidr kernel")
def cidr_dense_cuda(table: dict, a16, fam, port=None):
    """Launch B9 over an address batch: same contract as
    matchers.cidr_first_match_chunked (a16 uint8 [B, 16], fam int32
    [B], port int32 [B] or None for no port gate), CUDA tensors only.
    -> int32 [B], -1 for none. `table` is a DenseTable with its packed
    layout (prepare_cidr's). Raises KernelError unless it launched
    (card_entry)."""
    p = _packed(table, "dense cidr kernel")
    dev, b = p.device, a16.shape[0]
    FC._check("a16", a16, dev, torch.uint8)
    FC._check("fam", fam, dev, torch.int32)
    if port is not None:
        FC._check("port", port, dev, torch.int32)
    if tuple(a16.shape) != (b, 16) or tuple(fam.shape) != (b,) or (
            port is not None and tuple(port.shape) != (b,)):
        raise ValueError(
            f"dense cidr kernel: want a16 [{b}, 16], fam [{b}], port [{b}];"
            f" got {tuple(a16.shape)}, {tuple(fam.shape)}, "
            f"{None if port is None else tuple(port.shape)}")
    q, _, _, split4, split6, _ = cidr_grid(b, p.n4, p.n6)
    out = torch.full((b,), -1, dtype=torch.int32, device=dev)
    a = _DenseCidrArgs(
        a16=a16.data_ptr(), fam=fam.data_ptr(),
        port=None if port is None else port.data_ptr(),
        v4=p["v4"].data_ptr(), v6=p["v6"].data_ptr(), out=out.data_ptr(),
        b=b, n4=p.n4, n6=p.n6, q=q, split4=split4, split6=split6)
    _launch("cidr", a, dev)
    cidr_dense_cuda.launches += 1
    return out


cidr_dense_cuda.launches = 0  # every launch
