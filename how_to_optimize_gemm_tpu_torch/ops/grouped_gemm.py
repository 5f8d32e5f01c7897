"""Grouped (ragged) GEMM: the MoE expert compute, forward.

Counterpart: ``how_to_optimize_gemm_tpu/ops/pallas_grouped_gemm.py``
(``_pick_block``, ``grouped_matmul``). The rows of x are expert-sorted and
each expert's segment is padded to a multiple of ``bt`` rows; block i of
``bt`` rows multiplies expert ``block_expert[i]``'s stack:

    y[i*bt:(i+1)*bt] = (x[i*bt:(i+1)*bt] @ w[block_expert[i]]) (* s[e, 0])

Stacks: dense (fp32 or bf16, no scales), int8 with per-(expert, column)
scales (E, 1, f), or nibble-packed int4 (``packed4=True``: (E, d/2, f)
bytes of ``quant.pack_int4`` with block_k = d) with scales. The product is
taken in fp32 (the reference converts the stack to x's dtype, fp32 in the
model, inside the kernel).

On CUDA tensors ``grouped_matmul`` launches the hand-written kernel
``grouped_gemm`` (``csrc/grouped_gemm.cu``) for every stack kind or raises;
on CPU tensors it runs its plain version ``grouped_matmul_ref`` (one
``vendor.fp32_matmul`` per block, TF32 off). The kernel's bf16, int8 and
int4 instances split x into bf16 hi + lo for the tensor cores (about 2^-17
relative to the fp32 product) and sum in their own order; its fp32
instance is FFMA. Forward only: the kernel has no backward, so a call on a
tensor that requires grad raises with grad mode on
(``_build.require_no_grad``). The reference's VMEM-budget block width
(``_auto_bf``) is a TPU constant and has no counterpart; the kernel tiles
128 x 128 and needs ``bt`` a multiple of 128 on the card.
"""
from __future__ import annotations

import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import bounds, quant
from how_to_optimize_gemm_tpu_torch.ops.int8 import ALIGN, require_cuda
from how_to_optimize_gemm_tpu_torch.ops.vendor import fp32_matmul

KERNEL = "grouped_gemm"
# the kernel's row tile: bt must be a multiple of it on the card
TILE_ROWS = 128
# the kernel's stack kinds (csrc/grouped_gemm.cu)
_KINDS = {torch.bfloat16: 0, torch.int8: 1, "int4": 2, torch.float32: 3}


def _pick_block(dim: int, cap: int) -> int:
    """Largest 128-multiple divisor of ``dim`` that is <= cap; the whole
    dim when it already fits or when no aligned divisor exists."""
    if dim <= cap:
        return dim
    b = (cap // 128) * 128
    while b >= 128:
        if dim % b == 0:
            return b
        b -= 128
    return dim


def _check_layout(x, w, block_expert, scales, bt: int, packed4: bool):
    """Raise on operands the reference's ``_gmm_call`` asserts against."""
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"grouped_matmul: x {tuple(x.shape)} must be 2-D "
                         f"and w {tuple(w.shape)} 3-D")
    tp, d = x.shape
    e, dw, f = w.shape
    if dw != (d // 2 if packed4 else d) or (packed4 and d % 2):
        raise ValueError(f"grouped_matmul: x {tuple(x.shape)} vs w "
                         f"{tuple(w.shape)} (packed4={packed4})")
    if tp % bt or tuple(block_expert.shape) != (tp // bt,):
        raise ValueError(f"grouped_matmul: {tp} rows in blocks of {bt} vs "
                         f"block_expert {tuple(block_expert.shape)}")
    if packed4 and scales is None:
        raise ValueError("grouped_matmul: packed4 requires scales (E, 1, f)")
    if scales is not None and tuple(scales.shape) != (e, 1, f):
        raise ValueError(f"grouped_matmul: scales {tuple(scales.shape)} vs "
                         f"({e}, 1, {f})")


def _expert_weight(w, e: int, packed4: bool) -> torch.Tensor:
    """Expert ``e``'s stack as fp32 (d, f); packed nibbles decoded."""
    we = w[e]
    if packed4:
        we = quant.unpack_int4(we, 2 * we.shape[0])
    return we.to(torch.float32)


def grouped_matmul_ref(x, w, block_expert, scales=None, *, bt: int = 128,
                       packed4: bool = False) -> torch.Tensor:
    """Plain version of ``grouped_matmul``: per bt-row block, the fp32
    product with its expert's stack (``vendor.fp32_matmul``, TF32 off),
    times the expert's scales. Each expert's stack is converted once."""
    _check_layout(x, w, block_expert, scales, bt, packed4)
    tp, _ = x.shape
    x = x.to(torch.float32)
    y = torch.empty((tp, w.shape[2]), dtype=torch.float32, device=x.device)
    experts = [int(e) for e in block_expert.tolist()]
    for e in sorted(set(experts)):
        we = _expert_weight(w, e, packed4)
        for i in (i for i, be in enumerate(experts) if be == e):
            rows = slice(i * bt, (i + 1) * bt)
            yi = fp32_matmul(x[rows], we)
            y[rows] = yi if scales is None else yi * scales[e]
    return y


def grouped_matmul(x, w, block_expert, scales=None, *, bt: int = 128,
                   packed4: bool = False) -> torch.Tensor:
    """Ragged ``y[i*bt:(i+1)*bt] = x[i*bt:(i+1)*bt] @ w[block_expert[i]]``,
    a fresh (Tp, f) float32, forward only.

    x (Tp, d) expert-sorted rows (segments bt-aligned, zero-padded), float
    (converted to fp32); w (E, d, f) fp32, bf16 or int8, or (E, d/2, f)
    packed int4 bytes with ``packed4``; block_expert (Tp // bt,) ints;
    scales (E, 1, f) float32, applied per output column (required with
    ``packed4``). On the card: kernel ``grouped_gemm``, bt a multiple of
    128."""
    _check_layout(x, w, block_expert, scales, bt, packed4)
    _build.require_no_grad(KERNEL, x, w, scales)
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w, block_expert, scales, bt=bt,
                                  packed4=packed4)
    require_cuda(KERNEL, x)
    kind = _KINDS.get("int4" if packed4 else w.dtype)
    if kind is None or (packed4 and w.dtype != torch.int8):
        raise TypeError(f"{KERNEL}: no kernel for a {w.dtype} stack "
                        f"(packed4={packed4})")
    if bt % TILE_ROWS:
        raise ValueError(f"{KERNEL}: bt={bt} is not a multiple of the "
                         f"kernel's {TILE_ROWS}-row tile")
    tp, d = x.shape
    f = w.shape[2]
    for t in (w, block_expert, scales):
        if t is not None and t.device != x.device:
            raise ValueError(f"{KERNEL}: tensors on {t.device} and "
                             f"{x.device}")
    if scales is not None and scales.dtype != torch.float32:
        raise TypeError(f"{KERNEL}: scales must be float32, got "
                        f"{scales.dtype}")
    # rows of x and of the stack on 16-byte boundaries: zero columns
    x = bounds.pad_dim(x.to(torch.float32).contiguous(), 1, 4)
    w = bounds.pad_dim(w.contiguous(), 2, 4)
    be = block_expert.to(torch.int32).contiguous()
    s = None if scales is None else scales.contiguous()
    for t in (x, w):
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{KERNEL}: operands not {ALIGN}-byte aligned")
    out = torch.empty((tp, f), dtype=torch.float32, device=x.device)
    if tp and f:
        _build.launch(KERNEL, x.device, x, w, be, s, out, tp, f, d,
                      x.shape[1], w.shape[2], bt, kind)
    return out
