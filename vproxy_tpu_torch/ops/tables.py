"""Shared table-shape constants of the rule compilers.

The part of `vproxy_tpu/ops/tables.py` the hash path reads: the host/uri
byte limits, the address-family codes and the capacity padding rule. The
dense bit-plane compilers wait for the dense backend.
"""
from __future__ import annotations

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
