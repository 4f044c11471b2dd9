"""The hand-written CUDA kernel of the fused classify+pick contract.

Replaces `vproxy_tpu/ops/fused_pallas.py` `_fused_kernel`: packed hint
table + encoded query batch + Maglev column/slots -> int32 [B, 2]
(verdict, pick) in ONE launch; with a packed cidr table and an address
batch, int32 [B, 3] (verdict, pick, route), the 3-column contract of
`vproxy_tpu/ops/fused.py` `fused_classify_pick` with `ct`. Without a
Maglev column the same kernel is B3, `vproxy_tpu/ops/hashmatch.py`
`hint_hash_match`: (rule index, level) per query. The kernel is
csrc/fused_classify_pick.cu (its header note gives the bound and the
design); this module builds it with nvcc into a shared library with a
plain C interface, loads it with ctypes and launches it on PyTorch's
current stream.

* `fused_classify_pick` is the entry the engine serves with: CPU tensors
  take the plain torch tier (ops/fused.py), everything else the kernel.
  There is no fallback: every failure to serve CUDA tensors (a build,
  load or launch failure, a table or batch the kernel cannot take, the
  card out of memory for the output) raises KernelError, which the
  serving layers never fail over to the host (`card_entry`).
* `prepare_table` checks a packed table once and caches the table's
  half of the launch arguments; the engine calls it when a CUDA
  matcher publishes (which also builds the library, so a build failure
  stops the publish). Per call only the query batch is checked.
* `fused_classify_pick_cuda` is the kernel wrapper; its `launches`
  attribute counts the launches it made, `route_launches` those of
  them with the route column.
* `hint_match` is B3's entry (HintMatcher.dispatch_snap on the card):
  CPU tensors take the plain tier (fused._hint_verdict_packed, equal to
  hashmatch.hint_hash_match), CUDA tensors `hint_match_cuda`, which
  launches the kernel in its verdict-only mode (a null Maglev column:
  no pick, the level in column 1) and counts in its own `launches`.
* `word_bytes` picks the word the kernel compares byte windows in.
* `build_library()` compiles a kernel source at first use into a
  directory .gitignore lists, under a file lock per library (concurrent
  processes build it once), keyed by the content of the source and the
  headers it includes, the flags and the packed layout version;
  `build()` is this kernel's (ops/cidr_cuda.py builds B4 with it too).
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from . import fused as F

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "fused_classify_pick.cu")
CIDR_HEADER = os.path.join(_PKG, "csrc", "cidr_first.cuh")
BUILD_DIR = os.path.join(_PKG, "_build")
CUDA_DEFAULT = "/usr/local/cuda"  # the toolkit's usual prefix
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_PTRS = ("hostb", "urib", "hlen", "ulen", "port", "has_host", "has_uri",
         "hp_len", "hp_slot1", "hp_slot2", "up_len", "up_slot1",
         "up_slot2", "slots", "pk_meta", "pk_bytes", "pk_hslot", "pk_hkey",
         "pk_uslot", "pk_ukey", "hb_items", "ub_items", "wh_idx", "wu_idx",
         "mtab", "out",
         # the route column: the address batch, then the packed cidr
         # table (ops/cidr_cuda.py TABLE_DTYPES order)
         "a16", "cfam", "cport", "pk_cslot", "pk_cmeta", "s_key",
         "cb_items", "g_fam", "g_mask", "g_off", "g_capmask", "g_salt1",
         "g_salt2")
_INTS = ("b", "hw", "uw", "pk_w", "ukw", "maxp", "lw", "bh", "bu",
         "n_hb", "n_ub", "n_wh", "n_wu", "r_cap", "m", "word",
         "c_ct", "c_rcap", "c_cb", "c_g", "c_bk")
WORDS = (16, 8, 4, 1)  # the kernel's compare words, widest first


class _FusedArgs(ctypes.Structure):
    """Mirror of `struct FusedArgs` in the .cu (pointers, then ints)."""
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + \
        [(n, ctypes.c_int) for n in _INTS]


# the one dtype each argument must have, table half and query half
_TABLE_DTYPES = {
    "pk_meta": torch.int32, "pk_bytes": torch.uint8,
    "pk_hslot": torch.int32, "pk_hkey": torch.uint8,
    "pk_uslot": torch.int32, "pk_ukey": torch.uint8,
    "hb_items": torch.int32, "ub_items": torch.int32,
    "wh_idx": torch.int32, "wu_idx": torch.int32,
}
_URI_ONLY = ("pk_uslot", "pk_ukey", "ub_items", "wu_idx")
_QUERY_DTYPES = {
    "hostb": torch.uint8, "urib": torch.uint8, "hlen": torch.int32,
    "ulen": torch.int32, "port": torch.int32, "has_host": torch.bool,
    "has_uri": torch.bool, "hp_len": torch.int32,
    "hp_slot1": torch.int32, "hp_slot2": torch.int32,
    "up_len": torch.int32, "up_slot1": torch.int32,
    "up_slot2": torch.int32,
}


class KernelError(RuntimeError):
    """A CUDA kernel of the port (this one, or the CIDR kernel of
    ops/cidr_cuda.py) cannot serve: nvcc is missing or failed, the
    library does not load or does not match its ctypes mirror, or a
    launch was refused. Never answered by a fallback."""


def card_entry(what: str):
    """Decorator of a kernel wrapper (CUDA tensors only): whatever keeps
    it from serving, a table or batch it cannot take (ValueError), no
    card memory for the output (torch's OutOfMemoryError) or a refused
    launch, raises KernelError, so no caller can take it for a fault the
    host may answer. MemoryError (the host's) passes through."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except (KernelError, MemoryError):
                raise
            except Exception as e:
                raise KernelError(f"{what} cannot serve: {e!r}") from e
        return run
    return wrap


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "",
              os.path.join(CUDA_DEFAULT, "bin", "nvcc")]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on "
                      "PATH): the fused CUDA kernel cannot be built")


def build_library(source: str, stem: str, key: str,
                  headers: tuple = ()) -> str:
    """Compile one .cu (and the headers it includes, which key the
    build too) for sm_90a once; -> the shared library's path,
    `<BUILD_DIR>/<stem>_<content hash>.so`. nvcc's output (ptxas
    register and shared memory report included) is kept beside it as
    <lib>.log. Each library has its own lock file, so processes build
    one library once and different libraries at the same time. Raises
    KernelError when nvcc is missing or the compile fails."""
    src = b""
    for path in (source, *headers):
        with open(path, "rb") as f:
            src += f.read()
    tag = hashlib.sha256(
        src + f"{' '.join(NVCC_FLAGS)} {key}".encode()).hexdigest()
    lib = os.path.join(BUILD_DIR, f"{stem}_{tag[:16]}.so")
    if os.path.exists(lib):
        return lib
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".{stem}.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)  # one process builds, others wait
        if os.path.exists(lib):
            return lib
        tmp = f"{lib}.{os.getpid()}.tmp"
        r = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, source],
                           capture_output=True, text=True)
        with open(lib + ".log", "w") as log:
            log.write(r.stdout + r.stderr)
        if r.returncode != 0:
            raise KernelError(f"nvcc failed ({r.returncode}) on "
                              f"{os.path.basename(source)}:\n"
                              f"{r.stderr[-4000:]}")
        os.replace(tmp, lib)
    return lib


def build() -> str:
    """Compile csrc/fused_classify_pick.cu (with the CIDR routine it
    includes) once; -> the shared library's path (build_library)."""
    return build_library(SOURCE, "libfused", f"layout {F.PACK_LAYOUT_V}",
                         (CIDR_HEADER,))


_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    """Build (first use) and load the library. -> the ctypes handle."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            path = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelError(f"cannot load {path}: {e}") from e
            lib.vproxy_fused_args_size.restype = ctypes.c_int
            lib.vproxy_fused_args_size.argtypes = []
            fn = lib.vproxy_fused_classify_pick
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(_FusedArgs), ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            size = lib.vproxy_fused_args_size()
            if size != ctypes.sizeof(_FusedArgs):
                raise KernelError(f"FusedArgs ABI drift: C {size} B, "
                                  f"ctypes {ctypes.sizeof(_FusedArgs)} B")
            _LIB = lib
        return _LIB


def _check(name: str, v, dev, dtype) -> None:
    if v.device != dev or v.dtype != dtype or not v.is_contiguous():
        raise ValueError(f"fused kernel: {name} must be a contiguous "
                         f"{dtype} tensor on {dev}, got {v.dtype} on "
                         f"{v.device}")


def word_bytes(hw: int, uw: int = 0, *addrs: int) -> int:
    """The word the kernel compares byte windows in: the widest of
    WORDS that divides the host window `hw`, the uri window `uw` (0 for
    a uri-free table) and every base address in `addrs`, so each table
    row, key row and window splits into whole aligned words. hw 32 with
    uw 16 gives 16 bytes, hw 16 with uw 8 gives 8, and hw 65 (a 64-byte
    host rule plus its boundary byte) gives 1."""
    return next(w for w in WORDS
                if all(v % w == 0 for v in (hw, uw, *addrs)))


class PackedTable(dict):
    """A packed table (the dict of tensors) checked for the kernel, with
    the table's half of the launch arguments cached: `args` (table
    pointers and sizes), `uri`, `hw`, `uw`, `word`, `device`."""


def prepare_table(ht: dict) -> PackedTable:
    """Check a packed table once for the kernel (device, dtypes,
    contiguity, widths) and build + load the library. -> a PackedTable
    (`ht` itself when it already is one). Raises KernelError when the
    library cannot be built or loaded, ValueError on a bad table."""
    if isinstance(ht, PackedTable):
        return ht
    _lib()
    dev = ht["pk_meta"].device
    if dev.type == "cpu":  # the plain tier's, never the kernel's
        raise ValueError(f"fused CUDA kernel needs CUDA tensors, got "
                         f"{dev}")
    uri = "pk_uslot" in ht
    for k, want in _TABLE_DTYPES.items():
        if k in ht:
            _check(k, ht[k], dev, want)
        elif uri or k not in _URI_ONLY:
            raise ValueError(f"fused kernel: missing {k!r}")
    hw = ht["pk_hsplit"].shape[0]
    pk_w = ht["pk_bytes"].shape[1]
    uw = ht["pk_ukey"].shape[1] if uri else 0
    if ht["pk_hkey"].shape[1] != hw or pk_w != hw + uw:
        raise ValueError("fused kernel: packed byte widths disagree "
                         f"(hw {hw}, uw {uw}, pk_bytes {pk_w})")
    rows = [("pk_meta", 8), ("pk_hslot", 4)] + ([("pk_uslot", 4)] if uri
                                                 else [])
    for k, w in rows:
        if ht[k].dim() != 2 or ht[k].shape[1] != w:
            raise ValueError(f"fused kernel: {k} must be [n, {w}], got "
                             f"{tuple(ht[k].shape)}")
    t = PackedTable(ht)
    t.word = word_bytes(hw, uw, *(ht[k].data_ptr() for k in
                                  ("pk_bytes", "pk_hkey", "pk_ukey")
                                  if k in ht))
    t.uri, t.hw, t.uw, t.device = uri, hw, uw, dev
    t.args = _FusedArgs(**{k: ht[k].data_ptr() for k in _TABLE_DTYPES
                           if k in ht})
    a = t.args
    a.hw, a.uw, a.pk_w, a.ukw = hw, uw, pk_w, uw
    a.bh = ht["bh_iota"].shape[0]
    a.bu = ht["bu_iota"].shape[0] if uri else 0
    a.n_hb, a.n_wh = ht["hb_items"].shape[0], ht["wh_idx"].shape[0]
    a.n_ub = ht["ub_items"].shape[0] if uri else 0
    a.n_wu = ht["wu_idx"].shape[0] if uri else 0
    a.r_cap = ht["pk_meta"].shape[0]
    a.word = t.word
    return t


def fused_classify_pick(ht: dict, q: dict, mtab, slots, ct=None, a16=None,
                        fam=None, port=None):
    """The fused entry: the plain tier for CPU tensors, the CUDA kernel
    for everything else (which raises unless it launched). With a
    packed cidr table `ct` and the address batch (a16, fam, port or
    None) the answer gains the route column: [B, 3]."""
    if ht["pk_meta"].device.type == "cpu":
        return F.fused_classify_pick(ht, q, mtab, slots, ct, a16, fam, port)
    return fused_classify_pick_cuda(ht, q, mtab, slots, ct, a16, fam, port)


def _query_args(t: PackedTable, q: dict) -> _FusedArgs:
    """Check an encoded query batch against a prepared table. -> the
    launch arguments with the table and query halves set."""
    dev = t.device
    for k, want in _QUERY_DTYPES.items():
        _check(k, q[k], dev, want)
    b, hw = q["hostb"].shape
    uw = q["urib"].shape[1]
    maxp = q["hp_slot1"].shape[1]
    lw = q["up_slot1"].shape[1]
    if hw != t.hw or (t.uri and uw != t.uw):
        raise ValueError(f"fused kernel: query windows (hw {hw}, uw {uw}) "
                         f"differ from the packed table's (hw {t.hw}, uw "
                         f"{t.uw})")
    for k, w in (("hlen", None), ("ulen", None), ("port", None),
                 ("has_host", None), ("has_uri", None), ("hp_len", maxp),
                 ("hp_slot2", maxp), ("up_len", lw), ("up_slot2", lw)):
        shape = (b,) if w is None else (b, w)
        if tuple(q[k].shape) != shape:
            raise ValueError(f"fused kernel: {k} has shape "
                             f"{tuple(q[k].shape)}, want {shape}")
    a = _FusedArgs.from_buffer_copy(t.args)
    for k in _QUERY_DTYPES:
        setattr(a, k, q[k].data_ptr())
    a.b, a.uw, a.maxp, a.lw = b, uw, maxp, lw
    return a


def _launch(t: PackedTable, a: _FusedArgs, what: str) -> None:
    err = (_LIB or _lib()).vproxy_fused_classify_pick(
        ctypes.byref(a), int(t.uri), t.device.index or 0,
        torch.cuda.current_stream(t.device).cuda_stream)
    if err:
        raise KernelError(f"{what} launch failed: CUDA error {err}")


@card_entry("fused kernel")
def fused_classify_pick_cuda(ht: dict, q: dict, mtab, slots, ct=None,
                             a16=None, fam=None, port=None):
    """Launch the fused kernel: same contract as
    fused.fused_classify_pick, CUDA tensors only. -> int32 [B, 2], or
    [B, 3] with a cidr table `ct` (best a cidr_cuda.PackedCidrTable;
    a plain dict is checked on every call). `ht` is best a PackedTable
    (prepare_table); a plain dict is prepared on every call. Raises
    KernelError unless it launched (card_entry)."""
    t = prepare_table(ht)
    dev = t.device
    a = _query_args(t, q)
    b = a.b
    _check("slots", slots, dev, torch.int64)
    _check("mtab", mtab, dev, torch.int32)
    if tuple(slots.shape) != (b,) or mtab.dim() != 1:
        raise ValueError(f"fused kernel: slots must be [{b}] and mtab "
                         f"1-D, got {tuple(slots.shape)} and "
                         f"{tuple(mtab.shape)}")
    out = torch.empty((b, 2 if ct is None else 3), dtype=torch.int32,
                      device=dev)
    if ct is not None:
        from . import cidr_cuda as CC
        c = ct if isinstance(ct, CC.PackedCidrTable) \
            else CC.prepare_table(ct, build_kernel=False)
        if c.device != dev:
            raise ValueError(f"fused kernel: cidr table on {c.device}, "
                             f"hint table on {dev}")
        CC.check_queries(c, a16, fam, port, b)
        for k, v in c.ptrs.items():
            setattr(a, k, v)
        a.a16, a.cfam = a16.data_ptr(), fam.data_ptr()
        a.cport = None if port is None else port.data_ptr()
        (a.c_ct, a.c_rcap, a.c_cb, a.c_g, a.c_bk) = (
            c.ints[k] for k in CC.TABLE_INTS)
    a.slots, a.mtab, a.out = (slots.data_ptr(), mtab.data_ptr(),
                              out.data_ptr())
    a.m = mtab.shape[0]
    _launch(t, a, "fused kernel")
    fused_classify_pick_cuda.launches += 1
    if ct is not None:
        fused_classify_pick_cuda.route_launches += 1
    return out


fused_classify_pick_cuda.launches = 0  # every launch
fused_classify_pick_cuda.route_launches = 0  # of which [B, 3] launches


def hint_match(ht: dict, q: dict):
    """B3's entry: the hint verdict of every query over a packed table.
    -> (rule index int32 [B], -1 for none; level int32 [B], 0 where the
    index is -1), bit for bit `hashmatch.hint_hash_match`. CPU tensors
    take the plain tier (fused._hint_verdict_packed); CUDA tensors
    launch the kernel (hint_match_cuda), which raises unless it
    launched."""
    if ht["pk_meta"].device.type == "cpu":
        return F._hint_verdict_packed(ht, q)
    return hint_match_cuda(ht, q)


@card_entry("hint kernel")
def hint_match_cuda(ht: dict, q: dict):
    """Launch the kernel in its verdict-only mode (B3): no Maglev column
    or slots, so the launch never reads either and writes (index, level)
    per query. CUDA tensors only. -> (idx, level), int32 [B] views of
    one [B, 2] output. `ht` is best a PackedTable (prepare_table).
    Raises KernelError unless it launched (card_entry)."""
    t = prepare_table(ht)
    a = _query_args(t, q)
    out = torch.empty((a.b, 2), dtype=torch.int32, device=t.device)
    a.out, a.m = out.data_ptr(), 0
    _launch(t, a, "hint kernel")
    hint_match_cuda.launches += 1
    return out[:, 0], out[:, 1]


hint_match_cuda.launches = 0  # every launch
