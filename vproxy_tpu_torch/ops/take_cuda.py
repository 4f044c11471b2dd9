"""The hand-written CUDA kernel of the Maglev take (B5).

csrc/maglev_take.cu replaces `vproxy_tpu/rules/maglev.py` `_device_take`
(`jnp.take(table, slots, mode="clip")`): a Maglev pick column + int64
flow slots -> int32 picks, the slots clipped to the table. Its note
gives the bound and the design. This module builds it with nvcc
(fused_cuda.build_library: sm_90a, content-keyed into _build/), loads
it with ctypes and launches it on PyTorch's current stream.

* `take` is the entry (rules/maglev.py `_device_take` calls it): CPU
  tensors take the plain version (`take_plain`, torch indexing), every
  other tensor the kernel, which raises KernelError unless it launched
  (fused_cuda.card_entry). No fallback.
* `maglev_take_cuda` is the kernel wrapper; its `launches` attribute
  counts the launches it made.

Since B6, B8 and B9 carry the take as their Maglev column (every
classify+pick batch of the unfused backends is one launch of its hint
kernel), B5 serves standalone Maglev batches (MaglevMatcher.dispatch_snap
/ match) and the "host" backend's two-dispatch chain. `check_column`
checks a Maglev column for those kernels' wrappers.
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import fused_cuda as FC
from .fused_cuda import KernelError, card_entry

SOURCE = os.path.join(os.path.dirname(FC.SOURCE), "maglev_take.cu")


def build() -> str:
    """Compile csrc/maglev_take.cu once; -> the shared library's path."""
    return FC.build_library(SOURCE, "libtake", "take")


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
            fn = lib.vproxy_maglev_take
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p]
            _LIB = lib
        return _LIB


def take_plain(mtab: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """The plain version: mtab[clamp(slots, 0, M - 1)] by torch
    indexing."""
    return mtab[slots.clamp(0, mtab.shape[0] - 1)]


def check_column(mtab: torch.Tensor, slots: torch.Tensor, b: int,
                 dev: torch.device, what: str) -> None:
    """A Maglev column for a kernel of `b` rows on `dev`: mtab int32
    [M > 0], slots int64 [b], contiguous. Raises ValueError."""
    FC._check("mtab", mtab, dev, torch.int32)
    FC._check("slots", slots, dev, torch.int64)
    if mtab.dim() != 1 or mtab.shape[0] == 0 or tuple(slots.shape) != (b,):
        raise ValueError(f"{what}: the Maglev column wants mtab [M > 0] "
                         f"and slots [{b}], got {tuple(mtab.shape)} and "
                         f"{tuple(slots.shape)}")


def take(mtab: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """B5's entry: int32 [B] picks. CPU tensors take the plain version;
    CUDA tensors launch the kernel (maglev_take_cuda), which raises
    unless it launched."""
    if mtab.device.type == "cpu":
        return take_plain(mtab, slots)
    return maglev_take_cuda(mtab, slots)


@card_entry("maglev take kernel")
def maglev_take_cuda(mtab: torch.Tensor, slots: torch.Tensor
                     ) -> torch.Tensor:
    """Launch B5: same contract as take_plain, CUDA tensors only: mtab
    int32 [M] (M > 0), slots int64 [B], both contiguous on one device.
    -> int32 [B]. Raises KernelError unless it launched (card_entry)."""
    dev = mtab.device
    if dev.type == "cpu":  # the plain version's, never the kernel's
        raise ValueError(f"maglev take kernel needs CUDA tensors, got "
                         f"{dev}")
    lib = _LIB or _lib()
    FC._check("mtab", mtab, dev, torch.int32)
    FC._check("slots", slots, dev, torch.int64)
    if mtab.dim() != 1 or mtab.shape[0] == 0 or slots.dim() != 1:
        raise ValueError(f"maglev take kernel: mtab must be [M > 0] and "
                         f"slots [B], got {tuple(mtab.shape)} and "
                         f"{tuple(slots.shape)}")
    b = slots.shape[0]
    out = torch.empty(b, dtype=torch.int32, device=dev)
    err = lib.vproxy_maglev_take(
        mtab.data_ptr(), mtab.shape[0], slots.data_ptr(), b,
        out.data_ptr(), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise KernelError(f"maglev take kernel launch failed: CUDA error "
                          f"{err}")
    maglev_take_cuda.launches += 1
    return out


maglev_take_cuda.launches = 0  # every launch
