"""The hand-written CUDA kernel of the CIDR first match (B4).

Replaces `vproxy_tpu/ops/hashmatch.py` `cidr_hash_match`: a packed cidr
table (ops/fused.py pack_cidr_table) + an address batch (+ ports, for
an ACL) -> int32 [B], the first matching rule of each query, -1 for
none, in ONE launch. The kernel is csrc/cidr_first.cu over the routine
in csrc/cidr_first.cuh (their notes give the bound and the design),
which the route column of the fused kernel (ops/fused_cuda.py) shares.
This module builds it with nvcc, as ops/fused_cuda.py builds the fused
kernel, loads it with ctypes and launches it on PyTorch's current
stream.

* `cidr_first` is the entry a CIDR matcher serves with: CPU tensors
  take the plain torch tier (ops/fused.py `_cidr_first_packed`),
  everything else the kernel. There is no fallback: every failure to
  serve CUDA tensors raises KernelError (fused_cuda.card_entry).
* `prepare_table` checks a packed cidr table once and caches the
  table's half of the launch arguments; a CUDA CidrMatcher calls it
  when it publishes (which also builds the library, so a build failure
  stops the publish). The fused kernel's route column checks its cidr
  table with the same function, without building this library.
* `cidr_first_cuda` is the kernel wrapper; its `launches` attribute
  counts the launches it made.
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import fused as F
from . import fused_cuda as FC
from .fused_cuda import KernelError, card_entry

SOURCE = os.path.join(os.path.dirname(FC.SOURCE), "cidr_first.cu")

# the packed cidr table as both kernels read it: name -> dtype, in the
# order of the pointers of `cidr::Table` (csrc/cidr_first.cuh)
TABLE_DTYPES = {
    "pk_cslot": torch.int32, "pk_cmeta": torch.int32,
    "s_key": torch.uint8, "cb_items": torch.int32,
    "g_fam": torch.int32, "g_mask": torch.uint8, "g_off": torch.int32,
    "g_capmask": torch.int32, "g_salt1": torch.uint32,
    "g_salt2": torch.uint32,
}
TABLE_INTS = ("ct", "r_cap", "cb", "g", "bk")
# row arrays read as one 16-byte load per row
_ROWS16 = ("pk_cslot", "pk_cmeta", "s_key", "g_mask")

_PTRS = ("a16", "fam", "port", *TABLE_DTYPES, "out")
_INTS = ("b", *TABLE_INTS)


class _CidrArgs(ctypes.Structure):
    """Mirror of `struct CidrArgs` in csrc/cidr_first.cu (pointers, then
    ints)."""
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + \
        [(n, ctypes.c_int) for n in _INTS]


def build() -> str:
    """Compile csrc/cidr_first.cu once; -> the shared library's path
    (fused_cuda.build_library: sm_90a, into _build/, locked, keyed by
    the sources' content)."""
    return FC.build_library(SOURCE, "libcidr",
                            f"layout {F.PACK_LAYOUT_V}", (FC.CIDR_HEADER,))


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
            lib.vproxy_cidr_args_size.restype = ctypes.c_int
            lib.vproxy_cidr_args_size.argtypes = []
            fn = lib.vproxy_cidr_first
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(_CidrArgs), ctypes.c_int,
                           ctypes.c_void_p]
            size = lib.vproxy_cidr_args_size()
            if size != ctypes.sizeof(_CidrArgs):
                raise KernelError(f"CidrArgs ABI drift: C {size} B, "
                                  f"ctypes {ctypes.sizeof(_CidrArgs)} B")
            _LIB = lib
        return _LIB


class PackedCidrTable(dict):
    """A packed cidr table (the dict of tensors) checked for the
    kernels, with `ptrs` (name -> data pointer, TABLE_DTYPES order),
    `ints` (name -> size, TABLE_INTS) and `device` cached."""


def _aligned16(v: torch.Tensor) -> bool:
    return v.data_ptr() % 16 == 0


def prepare_table(ct: dict, build_kernel: bool = True) -> PackedCidrTable:
    """Check a packed cidr table once for the kernels (device, dtypes,
    contiguity, shapes, 16-byte rows aligned) and, with `build_kernel`,
    build + load this module's library. -> a PackedCidrTable (`ct`
    itself when it already is one). Raises KernelError when the library
    cannot be built or loaded, ValueError on a bad table."""
    if build_kernel:
        _lib()
    if isinstance(ct, PackedCidrTable):
        return ct
    dev = ct["pk_cslot"].device
    if dev.type != "cuda":
        raise ValueError(f"cidr CUDA kernel needs CUDA tensors, got {dev}")
    for k, want in TABLE_DTYPES.items():
        if k not in ct:
            raise ValueError(f"cidr kernel: missing {k!r}")
        FC._check(k, ct[k], dev, want)
    n_ct, r_cap = ct["pk_cslot"].shape[0], ct["pk_cmeta"].shape[0]
    g = ct["g_fam"].shape[0]
    shapes = {"pk_cslot": (n_ct, 4), "pk_cmeta": (r_cap, 4),
              "s_key": (n_ct, 16), "g_mask": (g, 16), "g_off": (g,),
              "g_capmask": (g,), "g_salt1": (g,), "g_salt2": (g,),
              "cb_items": (ct["cb_items"].shape[0],)}
    for k, want in shapes.items():
        if tuple(ct[k].shape) != want:
            raise ValueError(f"cidr kernel: {k} has shape "
                             f"{tuple(ct[k].shape)}, want {want}")
    if min(n_ct, r_cap, g, ct["cb_items"].shape[0]) <= 0:
        raise ValueError("cidr kernel: empty table arrays")
    for k in _ROWS16:
        if not _aligned16(ct[k]):
            raise ValueError(f"cidr kernel: {k} is not 16-byte aligned")
    t = PackedCidrTable(ct)
    t.device = dev
    t.ptrs = {k: ct[k].data_ptr() for k in TABLE_DTYPES}
    t.ints = {"ct": n_ct, "r_cap": r_cap, "cb": ct["cb_items"].shape[0],
              "g": g, "bk": ct["bk_iota"].shape[0]}
    return t


def check_queries(t: PackedCidrTable, a16, fam, port, b: int) -> None:
    """The address batch of B queries for table `t`: a16 u8 [B, 16]
    (16-byte aligned), fam i32 [B], port i32 [B] or None."""
    FC._check("a16", a16, t.device, torch.uint8)
    FC._check("fam", fam, t.device, torch.int32)
    if port is not None:
        FC._check("port", port, t.device, torch.int32)
    if tuple(a16.shape) != (b, 16) or tuple(fam.shape) != (b,) or (
            port is not None and tuple(port.shape) != (b,)):
        raise ValueError(
            f"cidr kernel: want a16 [{b}, 16], fam [{b}], port [{b}]; got "
            f"{tuple(a16.shape)}, {tuple(fam.shape)}, "
            f"{None if port is None else tuple(port.shape)}")
    if not _aligned16(a16):
        raise ValueError("cidr kernel: a16 is not 16-byte aligned")


def cidr_first(ct: dict, a16, fam, port=None):
    """The CIDR entry: the plain tier for CPU tensors, the CUDA kernel
    for everything else (which raises unless it launched)."""
    if ct["pk_cslot"].device.type == "cpu":
        return F._cidr_first_packed(ct, a16, fam, port)
    return cidr_first_cuda(ct, a16, fam, port)


@card_entry("cidr kernel")
def cidr_first_cuda(ct: dict, a16, fam, port=None):
    """Launch the B4 kernel: same contract as fused._cidr_first_packed,
    CUDA tensors only. -> int32 [B]. `ct` is best a PackedCidrTable
    (prepare_table); a plain dict is prepared on every call."""
    t = ct if isinstance(ct, PackedCidrTable) else prepare_table(ct)
    b = a16.shape[0]
    check_queries(t, a16, fam, port, b)
    out = torch.empty(b, dtype=torch.int32, device=t.device)
    a = _CidrArgs(a16=a16.data_ptr(), fam=fam.data_ptr(),
                  port=None if port is None else port.data_ptr(),
                  out=out.data_ptr(), b=b, **t.ptrs, **t.ints)
    err = (_LIB or _lib()).vproxy_cidr_first(
        ctypes.byref(a), t.device.index or 0,
        torch.cuda.current_stream(t.device).cuda_stream)
    if err:
        raise KernelError(f"cidr kernel launch failed: CUDA error {err}")
    cidr_first_cuda.launches += 1
    return out


cidr_first_cuda.launches = 0
