"""The vendor bars: rungs 01, 01b and 06v, the library's own matmuls.

Counterpart of ``how_to_optimize_gemm_tpu/ops/xla_dot.py`` (``mmult``,
``mmult_bf16``, ``mmult_int8``), where the reference also calls its
vendor's dot outside Pallas. Here each is one library product (cuBLAS on
the card) and the same epilogue as the hand-written rungs it is measured
against. These are the only rungs that call a library matmul.

- ``mmult`` (01): ``C' = A @ B + C`` in fp32 at full fp32 accuracy
  (``fp32_matmul``: TF32 off for the product only);
- ``mmult_bf16`` (01b): the same on bf16 operands with fp32 output:
  ``torch.mm(..., out_dtype=float32)``, bf16 tensor cores on the card;
- ``mmult_int8`` (06v): ``torch._int_mm`` and the rank-1 dequant.

``fp32_matmul`` is also the port's one place for "an fp32 product at
full fp32 on the card": the fp32 and bf16 linears and the fp32 plain
versions call it, and under autograd its gradient's two products are
fp32 products too.
"""
from __future__ import annotations

import torch

from how_to_optimize_gemm_tpu_torch.ops import bounds
from how_to_optimize_gemm_tpu_torch.ops.int8 import dequant_epilogue


def _matmul_highest(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(x, w)`` with TF32 off (``allow_tf32`` False,
    float32 matmul precision "highest") for this product only.

    The reference's fp32 dot carries its precision per call and changes
    no global state; so does this: both flags are restored afterwards,
    also when the product raises. ``allow_tf32`` is restored first,
    since setting it also sets the precision. When the caller set
    ``allow_tf32`` after the precision, PyTorch's backends disagree and
    the precision cannot be read (it raises); then only ``allow_tf32``,
    the flag cuBLAS reads, is turned off and restored."""
    matmul = torch.backends.cuda.matmul
    allow_tf32 = matmul.allow_tf32
    try:
        precision = torch.get_float32_matmul_precision()
    except RuntimeError:
        precision = None
    matmul.allow_tf32 = False
    if precision is not None:
        torch.set_float32_matmul_precision("highest")
    try:
        return torch.matmul(x, w)
    finally:
        matmul.allow_tf32 = allow_tf32
        if precision is not None:
            torch.set_float32_matmul_precision(precision)


class _Fp32Matmul(torch.autograd.Function):
    """``torch.matmul(x, w)`` whose gradients are fp32 products too: the
    backward runs under whatever flags are set when it runs, so each of
    its products goes through ``_matmul_highest`` as the forward's does.
    x (..., M, K) or (..., K); w (K, N), or batched (..., K, N) with
    batch dims broadcast against x's (the MoE dispatch path's expert,
    dispatch and combine products), each gradient summed back to its
    operand's shape."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _matmul_highest(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _matmul_highest(g, w.transpose(-1, -2)).sum_to_size(
                x.shape)
        if ctx.needs_input_grad[1]:
            if w.dim() == 2:
                dw = _matmul_highest(x.reshape(-1, x.shape[-1]).t(),
                                     g.reshape(-1, g.shape[-1]))
            else:
                dw = _matmul_highest(x.transpose(-1, -2), g).sum_to_size(
                    w.shape)
        return dx, dw


def fp32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(x, w)`` for x (..., K) and w (K, N), or batched x
    (..., M, K) and w (..., K, N), with TF32 off for this product only,
    and for the two products of its gradient (``_matmul_highest``)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Fp32Matmul.apply(x, w)
    return _matmul_highest(x, w)


def mmult(a, b, c):
    """Rung 01: ``C' = A @ B + C`` in fp32, a fresh output."""
    return fp32_matmul(a, b) + c


def mmult_bf16(a16, b16, c):
    """Rung 01b: ``C' = A_bf16 @ B_bf16 + C`` with fp32 sums, a fresh
    output. On the card one bf16 tensor-core product with fp32 output;
    for CPU tensors (no CPU kernel takes ``out_dtype``) the fp32 product
    of the bf16 values, each of which fp32 holds exactly."""
    if a16.is_cuda:
        return torch.mm(a16, b16, out_dtype=torch.float32) + c
    return fp32_matmul(a16.to(torch.float32), b16.to(torch.float32)) + c


def mmult_int8(qa, sa, qb, sb, c):
    """Rung 06v: ``C' = f32(QA @ QB as int32) * sa * sb + C``, a fresh
    output.

    ``torch._int_mm`` on CUDA needs M > 16 and K, N multiples of 8, so
    the operands are zero-padded (exact) and the product cropped."""
    m, n = c.shape
    if qa.shape[0] <= 16:
        qa = bounds.pad_dim(qa, 0, 32)
    qa = bounds.pad_dim(qa, 1, 8)
    qb = bounds.pad_dim(bounds.pad_dim(qb, 0, 8), 1, 8)
    acc = bounds.crop(torch._int_mm(qa, qb), m, n)
    return dequant_epilogue(acc, sa, sb, c)
