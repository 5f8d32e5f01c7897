"""Symmetric quantization and the int4 pack layout, on tensors.

Counterpart of ``how_to_optimize_gemm_tpu/ops/quant.py``, bit-exact with
it: the same scales and bytes for the same float32 input.

- Symmetric, zero-point-free: ``q = round(x / scale)`` clamped to
  ``±(2^(bits-1) - 1)`` (the value -128 is never produced), with
  ``scale = max(amax, 1e-8) / qmax``. ``torch.round`` rounds half to
  even, as the reference does.
- int4 packing, two weights per byte in blocks of ``block_k`` K rows:
  rows ``[0, block_k/2)`` of a block go to the LOW nibble in offset
  binary (``u = q + 8``), rows ``[block_k/2, block_k)`` to the HIGH
  nibble in two's complement, of the same ``block_k/2`` packed rows.
"""
from __future__ import annotations

import torch


def quantize_symmetric(x: torch.Tensor, axis: int | None, bits: int = 8):
    """Returns ``(q, scale)``: q int8, scale float32 shaped for broadcast
    along ``axis`` (None = one scale for the whole tensor)."""
    qmax = float(2 ** (bits - 1) - 1)
    if axis is None:
        amax = x.abs().max()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    amax = torch.clamp_min(amax.to(torch.float32), 1e-8)
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not IEEE division
    scale = amax / torch.full_like(amax, qmax)
    q =torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def pack_int4(q: torch.Tensor, block_k: int) -> torch.Tensor:
    """(K, N) int8 values in [-7, 7] -> (K // 2, N) int8 packed bytes.

    K must be a multiple of ``block_k`` (pad first), ``block_k`` even."""
    k, n = q.shape
    if k % block_k or block_k % 2:
        raise ValueError(f"K={k} must be a multiple of even block_k={block_k}")
    qb = q.reshape(k // block_k, block_k, n)
    lo = (qb[:, : block_k // 2] + 8).to(torch.uint8)
    hi = qb[:, block_k // 2:].to(torch.uint8) & 0xF
    packed = lo | (hi << 4)
    return packed.view(torch.int8).reshape(k // 2, n)


def unpack_int4(packed: torch.Tensor, block_k: int) -> torch.Tensor:
    """Inverse of ``pack_int4``: (K // 2, N) bytes -> (K, N) int8."""
    k2, n = packed.shape
    k = k2 * 2
    pb = packed.reshape(k // block_k, block_k // 2, n)
    lo = (pb & 0xF) - 8      # offset-binary low nibble
    hi = pb >> 4             # arithmetic shift sign-extends the high nibble
    return torch.cat([lo, hi], dim=1).reshape(k, n)
