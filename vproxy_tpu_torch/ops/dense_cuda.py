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
  words, one row per live rule (rules past the last live one never
  match and are left out), with the per-rule columns in one int4.
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
  (ops/matchers.py `hint_dense` / `cidr_dense` / `classify_dense` are
  the entries); each counts the launches it made in `launches`.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from . import fused_cuda as FC
from .fused_cuda import KernelError, card_entry
from .tables import HOST_SLOT, MAX_URI, V6

SOURCE = os.path.join(os.path.dirname(FC.SOURCE), "dense_match.cu")

HOST_WORDS = (HOST_SLOT + 3) // 4  # 17: 66 bytes padded to 68
URI_WORDS = MAX_URI // 4           # 32
# packed host word j holds the query's word HOST_ORDER[j]: the word of
# the length byte first, so every pattern's live words are a prefix
HOST_ORDER = [HOST_WORDS - 1] + list(range(HOST_WORDS - 1))
# hint meta column 0: flags, then the live word counts (exact, suffix,
# uri) in bits 8-15, 16-23, 24-31
F_ACTIVE, F_EXACT, F_SUFFIX, F_HWILD, F_URI, F_UWILD = 1, 2, 4, 8, 16, 32
TARGET_BLOCKS = 132 * 16  # blocks a launch aims for: 16 per SM
MIN_SPLIT = 32            # rules per block, at least: one staged tile
MAX_THREADS = 128         # queries per block, at most


class DenseTable(dict):
    """A published dense table: the reference's arrays as tensors, with
    `packed`, the kernel's layout (a PreparedDense), on the card."""

    packed = None


class PreparedDense(dict):
    """A packed layout (the dict of tensors) checked for its kernel, with
    `device` and `n` (its live rule rows) cached."""


def _planes(w: np.ndarray, nbytes: int) -> tuple:
    """Bit-plane weights [nbytes*8, N] -> (mask, value) uint8 [N,
    nbytes], bits most significant first."""
    m = np.packbits(w != 0, axis=0).T
    v = np.packbits(w < 0, axis=0).T
    assert m.shape[1] == nbytes
    return m, v


def _words(b: np.ndarray, nwords: int) -> np.ndarray:
    """uint8 [N, L] -> int32 [N, nwords], little-endian, zero-padded."""
    out = np.zeros((b.shape[0], nwords * 4), np.uint8)
    out[:, :b.shape[1]] = b
    return out.view("<i4")


def _live_words(m: np.ndarray) -> np.ndarray:
    """int32 mask words [N, W] -> the live prefix of each row: the last
    word with a mask bit, plus one (0 for none)."""
    nz = m != 0
    return np.where(nz.any(axis=1),
                    m.shape[1] - np.argmax(nz[:, ::-1], axis=1), 0)


def _n_live(rows_live: np.ndarray) -> int:
    nz = np.flatnonzero(rows_live)
    return int(nz[-1]) + 1 if nz.size else 0


def pack_dense_hint_table(arrays: dict) -> dict:
    """A compiled HintTable's arrays (tables.compile_hint_rules) -> the
    B9 hint layout (numpy): hrows int32 [n, 17, 4] (per host word, in
    HOST_ORDER: exact mask, exact value, suffix mask, suffix value),
    urows int32 [n, 16, 4] (per two uri words: mask, value, mask,
    value), meta int32 [n, 4] (flags | live word counts, uri score,
    port, 0); n = the last active rule + 1."""
    n = _n_live(arrays["active"])
    hm, hv = _planes(arrays["host_w"][:, :2 * n], HOST_SLOT)
    hm = _words(hm, HOST_WORDS)[:, HOST_ORDER]
    hv = _words(hv, HOST_WORDS)[:, HOST_ORDER]
    me, ms, ve, vs = hm[0::2], hm[1::2], hv[0::2], hv[1::2]
    um, uv = _planes(arrays["uri_w"][:, :n], MAX_URI)
    um, uv = _words(um, URI_WORDS), _words(uv, URI_WORDS)
    hvalid = arrays["host_valid"][:n]
    flags = (arrays["active"][:n] * F_ACTIVE | hvalid[:, 0] * F_EXACT |
             hvalid[:, 1] * F_SUFFIX | arrays["host_wild"][:n] * F_HWILD |
             arrays["uri_valid"][:n] * F_URI |
             arrays["uri_wild"][:n] * F_UWILD).astype(np.int32)
    meta = np.zeros((n, 4), np.int32)
    meta[:, 0] = (flags | _live_words(me) << 8 | _live_words(ms) << 16 |
                  _live_words(um) << 24)
    meta[:, 1] = arrays["uri_score"][:n]
    meta[:, 2] = arrays["port"][:n]
    return {
        "hrows": np.ascontiguousarray(np.stack([me, ve, ms, vs], axis=-1)),
        "urows": np.ascontiguousarray(np.stack(
            [um[:, 0::2], uv[:, 0::2], um[:, 1::2], uv[:, 1::2]], axis=-1)),
        "meta": meta}


def pack_dense_cidr_table(arrays: dict) -> dict:
    """A compiled CidrTable's arrays (tables.compile_cidr_rules) -> the
    B9 cidr layout (numpy): rows int32 [n, 6, 4] (per pattern slot: its
    4 mask words, then its 4 value words), meta int32 [n, 4] (slot s
    valid at bit s and V6 at bit 3 + s, min port, max port, 0); n = the
    last rule with a valid slot + 1."""
    valid = arrays["valid"].reshape(-1, 3)
    n = _n_live(valid.any(axis=1))
    m, v = _planes(arrays["w"][:, :3 * n], 16)
    m, v = _words(m, 4).reshape(n, 3, 4), _words(v, 4).reshape(n, 3, 4)
    fam = arrays["family"].reshape(-1, 3)[:n]
    flags = np.zeros(n, np.int32)
    for s in range(3):
        flags |= valid[:n, s].astype(np.int32) << s
        flags |= (fam[:, s] == V6).astype(np.int32) << (3 + s)
    meta = np.zeros((n, 4), np.int32)
    meta[:, 0] = flags
    meta[:, 1] = arrays["min_port"][:n]
    meta[:, 2] = arrays["max_port"][:n]
    return {"rows": np.ascontiguousarray(
        np.stack([m, v], axis=2).reshape(n, 6, 4)), "meta": meta}


def packed_of(table: dict, hint: bool) -> dict:
    """A published DenseTable's packed layout: its `packed` on the card;
    on the CPU (none published) packed here from its arrays, as
    tensors."""
    if table.packed is not None:
        return table.packed
    pack = pack_dense_hint_table if hint else pack_dense_cidr_table
    return {k: torch.from_numpy(v) for k, v in pack(
        {k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
         for k, v in table.items()}).items()}


def _mask_words(m: torch.Tensor) -> torch.Tensor:
    """int32 mask words [..., W] -> int64 [...]: the words with a bit."""
    return (m != 0).sum(-1)


def hint_pattern_words(p: dict) -> dict:
    """A packed hint layout (tensors) -> per rule row, int64 [n]:
    `host`, the words with a mask bit of its exact and of its suffix
    pattern, summed; `uri`, those of its uri prefix; 0 for a pattern the
    rule does not hold and for an inactive rule. Beside them `active`
    (bool [n]) and `port` (int32 [n]). A word without a mask bit (the
    suffix's length-byte word, a pattern's tail) needs no compare."""
    flags = p["meta"][:, 0].long() & 0xFF
    active = (flags & F_ACTIVE) != 0

    def held(bit, words):
        return torch.where(active & ((flags & bit) != 0), words, 0)
    hr, ur = p["hrows"], p["urows"]
    return {"active": active, "port": p["meta"][:, 2],
            "host": held(F_EXACT, _mask_words(hr[..., 0])) +
            held(F_SUFFIX, _mask_words(hr[..., 2])),
            "uri": held(F_URI, _mask_words(ur[..., 0]) +
                        _mask_words(ur[..., 2]))}


def cidr_slot_words(p: dict) -> dict:
    """A packed cidr layout (tensors) -> `words`, int64 [n, 3]: per rule
    row and pattern slot, the mask words with a bit (an IPv4 slot masks
    one word, a v6 /48 two), 0 for an invalid slot; `v6`, bool [n, 3],
    the slot's family; `min_port` / `max_port`, int32 [n]."""
    x = p["meta"][:, 0].long()
    s = torch.arange(3, device=x.device)
    valid = ((x[:, None] >> s) & 1) == 1
    words = _mask_words(p["rows"].reshape(-1, 3, 2, 4)[:, :, 0])
    return {"words": torch.where(valid, words, 0),
            "v6": ((x[:, None] >> (3 + s)) & 1) == 1,
            "min_port": p["meta"][:, 1], "max_port": p["meta"][:, 2]}


class _DenseHintArgs(ctypes.Structure):
    """Mirror of `struct DenseHintArgs` (pointers, then ints)."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "q_host", "q_uri", "has_host", "has_uri", "port", "hrows",
        "urows", "meta", "key", "done", "out_idx", "out_level")] + \
        [(n, ctypes.c_int) for n in ("b", "n", "threads", "split")]


class _DenseCidrArgs(ctypes.Structure):
    """Mirror of `struct DenseCidrArgs` (pointers, then ints)."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "a16", "fam", "port", "rows", "meta", "out")] + \
        [(n, ctypes.c_int) for n in ("b", "n", "threads", "split")]


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
                               ("cidr", _DenseCidrArgs)):
                size = getattr(lib, f"vproxy_dense_{kind}_args_size")
                size.restype, size.argtypes = ctypes.c_int, []
                fn = getattr(lib, f"vproxy_dense_{kind}")
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.POINTER(args), ctypes.c_int,
                               ctypes.c_void_p]
                if size() != ctypes.sizeof(args):
                    raise KernelError(f"{args.__name__} ABI drift: C "
                                      f"{size()} B, ctypes "
                                      f"{ctypes.sizeof(args)} B")
            _LIB = lib
        return _LIB


_HINT_SHAPES = {"hrows": (HOST_WORDS, 4), "urows": (URI_WORDS // 2, 4),
                "meta": (4,)}
_CIDR_SHAPES = {"rows": (6, 4), "meta": (4,)}


def _prepare(p: dict, shapes: dict, what: str) -> PreparedDense:
    if isinstance(p, PreparedDense):
        return p
    _lib()
    dev = p["meta"].device
    if dev.type == "cpu":  # the plain tier's, never the kernel's
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    n = p["meta"].shape[0]
    for k, tail in shapes.items():
        if k not in p:
            raise ValueError(f"{what}: missing {k!r}")
        FC._check(k, p[k], dev, torch.int32)
        if tuple(p[k].shape) != (n, *tail):
            raise ValueError(f"{what}: {k} must be [{n}, "
                             f"{', '.join(map(str, tail))}], got "
                             f"{tuple(p[k].shape)}")
    t = PreparedDense(p)
    t.device, t.n = dev, n
    return t


def prepare_hint(p: dict) -> PreparedDense:
    """Check a packed hint layout (pack_dense_hint_table, uploaded) once
    for the kernel, and build + load the library. -> a PreparedDense
    (`p` itself when it already is one). Raises KernelError when the
    library cannot be built or loaded, ValueError on a bad layout."""
    return _prepare(p, _HINT_SHAPES, "dense hint kernel")


def prepare_cidr(p: dict) -> PreparedDense:
    """The same for a packed cidr layout (pack_dense_cidr_table)."""
    return _prepare(p, _CIDR_SHAPES, "dense cidr kernel")


def grid(b: int, n: int) -> tuple:
    """-> (threads per block, query tiles, rule range per block) of a
    launch over b queries and n live rules: blocks of up to 4 warps of
    queries, and rule ranges of at least MIN_SPLIT rules cut so the
    launch has about TARGET_BLOCKS blocks."""
    threads = min(MAX_THREADS, 32 * -(-max(b, 1) // 32))
    tiles = -(-b // threads)
    splits = max(1, min(-(-TARGET_BLOCKS // max(tiles, 1)),
                        -(-n // MIN_SPLIT)))
    return threads, tiles, max(1, -(-n // splits))


def _packed(table: dict, what: str) -> PreparedDense:
    p = getattr(table, "packed", None)
    if not isinstance(p, PreparedDense):
        raise ValueError(f"{what}: the table has no prepared packed "
                         f"layout (a DenseTable published on the card)")
    return p


def _launch(kind: str, a, dev: torch.device) -> None:
    err = getattr(_LIB or _lib(), f"vproxy_dense_{kind}")(
        ctypes.byref(a), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise KernelError(f"dense {kind} kernel launch failed: CUDA error "
                          f"{err}")


@card_entry("dense hint kernel")
def hint_dense_cuda(table: dict, q: dict):
    """Launch B9 over a hint batch: same contract as
    matchers.hint_match_chunked on encode_hints' arrays (host uint8
    [B, 66], uri uint8 [B, 128], has_host / has_uri bool [B], port int32
    [B]), CUDA tensors only. -> (idx, level), int32 [B] views of one
    [B, 2] output. `table` is a DenseTable with its packed layout
    (prepare_hint's).
    Raises KernelError unless it launched (card_entry)."""
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
    threads, tiles, split = grid(b, p.n)
    # one fill: the per-query keys, then the tiles' tickets
    scratch = torch.zeros(b + tiles, dtype=torch.int64, device=dev)
    out = torch.empty((2, b), dtype=torch.int32, device=dev)
    a = _DenseHintArgs(
        q_host=q["host"].data_ptr(), q_uri=q["uri"].data_ptr(),
        has_host=q["has_host"].data_ptr(), has_uri=q["has_uri"].data_ptr(),
        port=q["port"].data_ptr(), hrows=p["hrows"].data_ptr(),
        urows=p["urows"].data_ptr(), meta=p["meta"].data_ptr(),
        key=scratch.data_ptr(), done=scratch.data_ptr() + 8 * b,
        out_idx=out[0].data_ptr(), out_level=out[1].data_ptr(),
        b=b, n=p.n, threads=threads, split=split)
    _launch("hint", a, dev)
    hint_dense_cuda.launches += 1
    return out[0], out[1]


hint_dense_cuda.launches = 0  # every launch


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
    threads, _, split = grid(b, p.n)
    out = torch.full((b,), -1, dtype=torch.int32, device=dev)
    a = _DenseCidrArgs(
        a16=a16.data_ptr(), fam=fam.data_ptr(),
        port=None if port is None else port.data_ptr(),
        rows=p["rows"].data_ptr(), meta=p["meta"].data_ptr(),
        out=out.data_ptr(), b=b, n=p.n, threads=threads, split=split)
    _launch("cidr", a, dev)
    cidr_dense_cuda.launches += 1
    return out


cidr_dense_cuda.launches = 0  # every launch
