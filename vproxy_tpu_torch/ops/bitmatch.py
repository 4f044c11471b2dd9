"""Masked-equality matching as a matrix product (the dense backend's
plain tier).

The port's copy of `vproxy_tpu/ops/bitmatch.py`. Every rule-match site
reduces to: does a query byte string equal a rule byte string under a
per-rule byte mask? Bytes become bit-planes (values in {0,1}) and

    popcount((q XOR r) AND m) = sum_k q_k*m_k + r_k*m_k - 2*q_k*r_k*m_k
                              = q . (m - 2*r*m) + sum(r*m)

so a [B, K] x [K, N] product + bias gives the per-(query, rule) mismatch
count; a pattern matches iff its count is zero. The hand-written kernel
of this backend (csrc/dense_match.cu, B9) computes the same predicate as
a masked word compare instead; this product is its plain version.
"""
from __future__ import annotations

import numpy as np
import torch


def compile_patterns(values: np.ndarray, masks: np.ndarray):
    """Compile pattern bytes into matmul weights.

    values, masks: uint8 [N, L] (mask is 0x00/0xff per byte; partial-byte
    masks from CIDR prefixes are also supported bit-wise).
    Returns (W [L*8, N] float32, c [N] float32).
    """
    assert values.shape == masks.shape
    n, l = values.shape
    vb = np.unpackbits(values, axis=1).astype(np.float32)  # [N, L*8]
    mb = np.unpackbits(masks, axis=1).astype(np.float32)
    w = (mb - 2.0 * vb * mb).T  # [L*8, N]
    c = (vb * mb).sum(axis=1)  # [N]
    return np.ascontiguousarray(w), np.ascontiguousarray(c)


def unpack_bits(q: torch.Tensor) -> torch.Tensor:
    """uint8 [..., L] -> float32 [..., L*8] bit-planes (MSB first,
    matching np.unpackbits)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=q.device)
    bits = (q[..., None] >> shifts) & 1  # [..., L, 8]
    return bits.reshape(*q.shape[:-1], q.shape[-1] * 8).to(torch.float32)


def mismatch_counts(q_bits: torch.Tensor, w: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
    """[B, K] x [K, N] + [N] -> [B, N] float32 mismatch counts (exact).

    The product is taken with float32 operands into a float32 result.
    A bf16 result (what `torch.matmul` returns for bf16 operands) would
    be wrong: the products reach 528 (host planes) and 1,024 (uri
    planes) before the bias, past bf16's exact integers (256), and a
    rounded q.w can land on -c and report a match that is not there.
    TF32 is allowed on purpose: the operands are in {-1, 0, 1} and
    {0, 1}, exact in TF32's 10-bit mantissa, every product is exact,
    and the tensor cores accumulate in float32, where every partial sum
    (an integer of magnitude <= 1,024) is exact too. The flag is the
    process's, so it is set for this product only and restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.matmul(q_bits.to(torch.float32),
                            w.to(torch.float32)) + c
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
