"""Device selection and host<->device moves for the torch engine.

* `default_device()` is CUDA. Without a GPU it raises, unless the caller
  asked for the CPU: an explicit `device="cpu"` argument, or
  VPROXY_TPU_TORCH_DEVICE=cpu (the CPU parity tests set it). It never
  silently runs on the CPU.
* `tables_from_reference()` uploads a dict of numpy table arrays (a
  compiled hint table's `arrays`, its packed dict, a Maglev table) with
  the key set and dtypes kept, so both packages score the same table.
* `to_host()` is the one explicit device->host pull: `np.asarray()` on a
  CUDA tensor raises, and a raise on the dispatch path would quietly
  fail every batch over to the host index.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def default_device(device: DeviceLike = None) -> torch.device:
    """The serving device: `device` when given, else
    VPROXY_TPU_TORCH_DEVICE, else cuda. Raises when that is cuda and no
    GPU is present."""
    if device is None:
        device = os.environ.get("VPROXY_TPU_TORCH_DEVICE", "cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' or set "
            "VPROXY_TPU_TORCH_DEVICE=cpu to run on the CPU")
    return dev


def tables_from_reference(arrays: dict, device: DeviceLike
                          ) -> dict[str, torch.Tensor]:
    """numpy arrays -> tensors on `device`, same keys and dtypes (uint8,
    int32, bool, int64 stay what they are)."""
    dev = default_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrays.items()}


def to_host(x) -> np.ndarray:
    """Tensor (any device) or array-like -> numpy, blocking on the
    device work that produces it."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def sync(device: Optional[torch.device]) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
