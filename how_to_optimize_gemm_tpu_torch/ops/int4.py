"""W4A8 GEMMs: int8 activations x packed int4 weights.

Counterpart: ``how_to_optimize_gemm_tpu/ops/pallas_int4.py``
(``PACK_BLOCK``, ``prepare_w4a8``, ``mmult_q_w4a8``, ``mmult_q_w4a8_noc``,
``mmult_w4a8_fused_noc``). W is decoded from nibbles packed two per byte
in 512-row pack blocks (``ops/quant.py``).

- ``mmult_q_w4a8`` (rung 07b, K3, ``csrc/w4a8_gemm.cu``):
  ``C = f32(QA @ W as int32) * sa[i] * sw[j] + C``, IN PLACE on ``c`` as
  the reference aliases C into its output.
- ``mmult_q_w4a8_noc`` (the serving linear at m > 64, kernel
  ``w4a8_gemm_noc``): ``y = f32(QA @ W as int32) * sa[i] * sw[j]``.
- ``mmult_w4a8_fused_noc`` (the serving linear at m <= 64, kernel
  ``w4a8_gemv_fq``): the same with the activation quantization of float
  rows done on the card, ``quantize_symmetric(x, axis=1)`` first.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (``*_ref``) only for CPU tensors; each kernel equals its plain
version bit for bit (exact int32 sums, the epilogue in the same order).
"""
from __future__ import annotations

import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import bounds, quant
from how_to_optimize_gemm_tpu_torch.ops.int8 import (
    ALIGN, require_cuda, check_operands, dequant_epilogue, int_matmul_exact)

# K rows per pack block: rows [g*512, g*512+256) of W live in the low
# nibbles and [g*512+256, g*512+512) in the high nibbles of packed rows
# [g*256, (g+1)*256).
PACK_BLOCK = 512


def prepare_w4a8(a: torch.Tensor, b: torch.Tensor):
    """A -> int8 per row; B -> int4 per column, zero-padded to whole pack
    blocks and packed. Returns ``(qa, sa, packed, sw, kdim)``."""
    qa, sa = quant.quantize_symmetric(a, axis=1)          # (M,K) int8
    kdim = b.shape[0]
    bp = bounds.pad_dim(b, 0, PACK_BLOCK)
    qw, sw = quant.quantize_symmetric(bp, axis=0, bits=4)
    packed = quant.pack_int4(qw, PACK_BLOCK)
    return qa, sa, packed, sw, kdim


def mmult_q_w4a8_ref(qa, sa, packed, sw, c):
    """Plain version of K3, out of place: ``dequant(QA @ W) + C``."""
    w = quant.unpack_int4(packed, PACK_BLOCK)[: qa.shape[1]]
    return dequant_epilogue(int_matmul_exact(qa, w), sa, sw, c)


def mmult_q_w4a8(qa, sa, packed, sw, c):
    """C = (QA_int8 @ W4) * sa * sw + C, IN PLACE on ``c`` (returned).

    qa (M, K) int8, packed (Kp/2, N) int8 with Kp a multiple of 512 and
    K <= Kp, sa (M, 1), sw (1, N), c (M, N) float32."""
    if c.device.type == "cpu":
        c.copy_(mmult_q_w4a8_ref(qa, sa, packed, sw, c))
        return c
    require_cuda("mmult_q_w4a8", c)
    m, n = c.shape
    _check_packed("mmult_q_w4a8", packed, qa.shape[1], n)
    qa = bounds.pad_dim(qa, 1, ALIGN)
    packed = bounds.pad_dim(packed, 1, ALIGN)
    check_operands("mmult_q_w4a8", qa, sa, packed, sw, c)
    if m and n:
        ka = qa.shape[1]
        _build.launch("w4a8_gemm", c.device, qa, packed, sa, sw, c, c,
                      m, n, ka, ka, packed.shape[1], n)
    return c


def mmult_q_w4a8_noc_ref(qa, sa, packed, sw):
    """Plain version of ``mmult_q_w4a8_noc``: ``f32(QA @ W) * sa * sw``."""
    w = quant.unpack_int4(packed, PACK_BLOCK)[: qa.shape[1]]
    return int_matmul_exact(qa, w).to(torch.float32) * sa * sw


def _check_packed(name: str, packed: torch.Tensor, k: int, n: int) -> int:
    """Kp of ``packed``; raises unless it holds K rows of N columns."""
    kp = packed.shape[0] * 2
    if packed.shape[1] != n or kp % PACK_BLOCK or k > kp:
        raise ValueError(f"{name}: packed {tuple(packed.shape)} does not "
                         f"hold K={k} rows in {PACK_BLOCK}-row blocks of "
                         f"N={n} columns")
    return kp


def mmult_q_w4a8_noc(qa, sa, packed, sw):
    """y = f32(QA_int8 @ W4 as int32) * sa * sw, a fresh (M, N) float32.

    qa (M, K) int8, sa (M, 1), packed (Kp/2, N) int8 with Kp a multiple
    of 512 and K <= Kp, sw (1, N) float32. No C is read or added."""
    if qa.device.type == "cpu":
        return mmult_q_w4a8_noc_ref(qa, sa, packed, sw)
    require_cuda("mmult_q_w4a8_noc", qa)
    m, k = qa.shape
    n = sw.shape[-1]
    _check_packed("mmult_q_w4a8_noc", packed, k, n)
    qa = bounds.pad_dim(qa, 1, ALIGN)
    packed = bounds.pad_dim(packed, 1, ALIGN)
    out = torch.empty((m, n), dtype=torch.float32, device=qa.device)
    check_operands("mmult_q_w4a8_noc", qa, sa, packed, sw, out)
    if m and n:
        ka = qa.shape[1]
        _build.launch("w4a8_gemm_noc", out.device, qa, packed, sa, sw, None,
                      out, m, n, ka, ka, packed.shape[1], n)
    return out


# The fused-quant GEMV serves decode widths only, as in the reference.
GEMV_MAX_M = 64


def mmult_w4a8_fused_noc_ref(x, packed, sw):
    """Plain version of ``mmult_w4a8_fused_noc``: quantize the rows of x
    (``quantize_symmetric(x, axis=1)``), then ``mmult_q_w4a8_noc_ref``."""
    qa, sa = quant.quantize_symmetric(x.to(torch.float32), axis=1)
    return mmult_q_w4a8_noc_ref(qa, sa, packed, sw)


def mmult_w4a8_fused_noc(x, packed, sw):
    """y = quantize(x) @ dequant(W4), fp32: the W4A8 decode linear with
    the activation quantization fused into the kernel.

    x (m, K) float with m <= 64, packed (Kp/2, N) int8, sw (1, N) float32.
    The kernel pads x with zero columns to Kp (as the reference does),
    which changes no row maximum."""
    m, k = x.shape
    if m > GEMV_MAX_M:
        raise ValueError(f"mmult_w4a8_fused_noc: m={m} > {GEMV_MAX_M}; the "
                         "fused-quant GEMV is the decode-width form")
    if x.device.type == "cpu":
        return mmult_w4a8_fused_noc_ref(x, packed, sw)
    require_cuda("mmult_w4a8_fused_noc", x)
    n = sw.shape[-1]
    kp = _check_packed("mmult_w4a8_fused_noc", packed, k, n)
    x = bounds.pad_dim(x.to(torch.float32).contiguous(), 1, kp)
    packed = bounds.pad_dim(packed, 1, ALIGN)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    qa = torch.empty((m, kp), dtype=torch.int8, device=x.device)
    sa = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    check_operands("mmult_w4a8_fused_noc", qa, sa, packed, sw, out)
    if m and n:
        _build.launch("w4a8_gemv_fq", out.device, x, packed, sw, qa, sa, out,
                      m, n, kp, packed.shape[1])
    return out
