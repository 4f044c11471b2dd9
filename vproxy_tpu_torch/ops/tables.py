"""Shared table-shape constants of the rule compilers.

The part of `vproxy_tpu/ops/tables.py` the hash path reads: the host/uri
byte limits, the address-family codes, the capacity padding rule and the
address encoder of CIDR queries (`encode_ips`). The dense bit-plane
compilers wait for the dense backend.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..utils.ip import to16

MAX_HOST = 64  # max host/domain byte length in device tables
MAX_URI = 128  # max uri prefix byte length

V4, V6 = 0, 1

MATCH_CHUNK = 8192  # rules per scan step in the chunked matchers


def _pad_cap(n: int, bucket: int = 256) -> int:
    # big tables pad to a multiple of MATCH_CHUNK so the scanned matchers
    # can slice even chunks
    if n > MATCH_CHUNK:
        bucket = MATCH_CHUNK
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def encode_ips(addrs: Sequence[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """-> (addr16 [B,16] uint8, family [B] i32)."""
    b = len(addrs)
    # all-v4 fast path (the switch burst, LB accept batches): one buffer
    # reshape instead of a python loop
    if b and all(len(a) == 4 for a in addrs):
        out = np.zeros((b, 16), dtype=np.uint8)
        out[:, 12:] = np.frombuffer(b"".join(addrs),
                                    dtype=np.uint8).reshape(b, 4)
        return out, np.full(b, V4, dtype=np.int32)
    out = np.zeros((b, 16), dtype=np.uint8)
    fam = np.zeros(b, dtype=np.int32)
    for i, a in enumerate(addrs):
        out[i] = np.frombuffer(to16(a), dtype=np.uint8)
        fam[i] = V4 if len(a) == 4 else V6
    return out, fam
