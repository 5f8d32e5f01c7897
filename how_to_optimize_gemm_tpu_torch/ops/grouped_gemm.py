"""Grouped (ragged) GEMM: the MoE expert compute, forward and backward.

Counterpart: ``how_to_optimize_gemm_tpu/ops/pallas_grouped_gemm.py``
(``_pick_block``, ``grouped_matmul`` and its custom VJPs ``_gmm_dense``,
``_gmm_q8``, ``_gmm_q4``). The rows of x are expert-sorted and each
expert's segment is padded to a multiple of ``bt`` rows; block i of ``bt``
rows multiplies expert ``block_expert[i]``'s stack:

    y[i*bt:(i+1)*bt] = (x[i*bt:(i+1)*bt] @ w[block_expert[i]]) (* s[e, 0])

Stacks: dense (fp32 or bf16, no scales), int8 with per-(expert, column)
scales (E, 1, f), or nibble-packed int4 (``packed4=True``: (E, d/2, f)
bytes of ``quant.pack_int4`` with block_k = d) with scales. The product is
taken in fp32 (the reference converts the stack to x's dtype, fp32 in the
model, inside the kernel).

``grouped_matmul`` is differentiable, as the reference's: two autograd
functions mirror its custom VJPs. A dense stack (``_GmmDense``) gets dx
from the transposed product on the stack as it lies
(``grouped_matmul_t``, no transposed copy) and dW from the segment sum of
each expert's per-block products (``grouped_dw``, fp32, rounded to the
stack's dtype). An int8 or packed int4 stack trains QLoRA-style
(``_GmmScaled``, the reference's ``_gmm_q8`` and ``_gmm_q4``): the stack
is frozen, dx takes the scales folded into dy's rows into
``grouped_matmul_t`` (int8) or ``grouped_matmul_t4`` (packed), and the
scales' gradient is the per-expert sum of dy * u over each expert's rows,
u = x @ W recomputed without scales. That sum is plain PyTorch, as the
reference leaves it to XLA, and deterministic: each block's rows, then
each expert's blocks through one product with the one-hot block map.

Kernels: on CUDA tensors ``grouped_gemm`` (``csrc/grouped_gemm.cu``; its
packed instance without scales is the unscaled recompute, the reference's
``_kernel_q4_noscale``), ``grouped_gemm_t`` and ``grouped_gemm_t4``
(``csrc/grouped_gemm_t.cu``) and ``grouped_dw`` (``csrc/grouped_dw.cu``),
or a raise; on CPU tensors their plain versions (``*_ref``: one
``vendor.fp32_matmul`` per block, for dW per expert, TF32 off). The bf16,
int8 and int4 products split their fp32 operand into bf16 hi + lo for the
tensor cores (about 2^-17 relative to the fp32 product) and sum in their
own order, all three on ``wgmma`` after the pre-pass ``split_bf16``
(``csrc/split_bf16.cu``: x for the forward, dy for dx, x and dy for dW,
as two bf16 planes; two products a tile for the forward and dx, hi.hi +
hi.lo + lo.hi for dW). The dense backward splits dy once and gives the
same planes to dx and dW. The fp32-stack products are FFMA. The
reference's VMEM-budget block width (``_auto_bf``) is a TPU constant and
has no counterpart; the kernels tile 128 x 128 and the products need
``bt`` a multiple of 128 on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import bounds, quant
from how_to_optimize_gemm_tpu_torch.ops.int8 import ALIGN, require_cuda
from how_to_optimize_gemm_tpu_torch.ops.vendor import fp32_matmul

KERNEL = "grouped_gemm"
KERNEL_T = "grouped_gemm_t"
KERNEL_T4 = "grouped_gemm_t4"
KERNEL_DW = "grouped_dw"
KERNEL_SPLIT = "split_bf16"
# the kernels' row tile: bt must be a multiple of it on the card
TILE_ROWS = 128
# the kernels' stack kinds (csrc/grouped_gemm.cu, grouped_gemm_t.cu)
_KINDS = {torch.bfloat16: 0, torch.int8: 1, "int4": 2, torch.float32: 3}
# the stack's rows (the forward's and dx's), in elements of each kind,
# padded to a multiple of: 16 bytes for the tensor maps of kinds 0-2, 4
# floats for the FFMA kernels' loads
_STACK_PITCH = {0: 8, 1: 16, 2: 16, 3: 4}
# split_bf16's planes: rows of a multiple of 8 bf16 (16 bytes)
_SPLIT_PITCH = 8


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


def _check_blocks(name: str, rows: torch.Tensor, block_expert, bt: int):
    tp = rows.shape[0]
    if tp % bt or tuple(block_expert.shape) != (tp // bt,):
        raise ValueError(f"{name}: {tp} rows in blocks of {bt} vs "
                         f"block_expert {tuple(block_expert.shape)}")


def _check_layout(x, w, block_expert, scales, bt: int, packed4: bool):
    """Raise on operands the reference's ``_gmm_call`` asserts against."""
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"grouped_matmul: x {tuple(x.shape)} must be 2-D "
                         f"and w {tuple(w.shape)} 3-D")
    d = x.shape[1]
    e, dw, f = w.shape
    if dw != (d // 2 if packed4 else d) or (packed4 and d % 2):
        raise ValueError(f"grouped_matmul: x {tuple(x.shape)} vs w "
                         f"{tuple(w.shape)} (packed4={packed4})")
    _check_blocks("grouped_matmul", x, block_expert, bt)
    if scales is not None and tuple(scales.shape) != (e, 1, f):
        raise ValueError(f"grouped_matmul: scales {tuple(scales.shape)} vs "
                         f"({e}, 1, {f})")


def _check_bt(name: str, bt: int) -> None:
    if bt % TILE_ROWS:
        raise ValueError(f"{name}: bt={bt} is not a multiple of the "
                         f"kernel's {TILE_ROWS}-row tile")


def _check_card(name: str, bt: int, x, *others) -> None:
    """The card's conditions shared by every kernel: CUDA tensors on one
    device, bt a multiple of the row tile."""
    require_cuda(name, x)
    _check_bt(name, bt)
    for t in others:
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{x.device}")


def _aligned(name: str, *tensors) -> None:
    for t in tensors:
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name}: operands not {ALIGN}-byte aligned")


def _expert_weight(w, e: int, packed4: bool) -> torch.Tensor:
    """Expert ``e``'s stack as fp32 (rows, f); packed nibbles decoded
    (block_k = the rows)."""
    we = w[e]
    if packed4:
        we = quant.unpack_int4(we, 2 * we.shape[0])
    return we.to(torch.float32)


def _blocks_of(block_expert):
    """{expert: [its block indices]} in block order."""
    blocks: dict[int, list[int]] = {}
    for i, e in enumerate(block_expert.tolist()):
        blocks.setdefault(int(e), []).append(i)
    return blocks


def grouped_matmul_ref(x, w, block_expert, scales=None, *, bt: int = 128,
                       packed4: bool = False) -> torch.Tensor:
    """Plain version of ``grouped_matmul``'s forward: per bt-row block, the
    fp32 product with its expert's stack (``vendor.fp32_matmul``, TF32
    off), times the expert's scales when given. Each expert's stack is
    converted once. A packed stack without scales is the backward's
    unscaled recompute."""
    _check_layout(x, w, block_expert, scales, bt, packed4)
    x = x.to(torch.float32)
    y = torch.empty((x.shape[0], w.shape[2]), dtype=torch.float32,
                    device=x.device)
    for e, blocks in _blocks_of(block_expert).items():
        we = _expert_weight(w, e, packed4)
        for i in blocks:
            rows = slice(i * bt, (i + 1) * bt)
            yi = fp32_matmul(x[rows], we)
            y[rows] = yi if scales is None else yi * scales[e]
    return y


def split_bf16_ref(x) -> torch.Tensor:
    """Plain version of ``split_bf16``: (2, rows, ldo) bf16, hi =
    bf16(x) and lo = bf16(x - hi) (round to nearest even; x - hi is exact
    in fp32), columns from x's up to ldo (a multiple of 8) zeros."""
    if x.dim() != 2:
        raise ValueError(f"{KERNEL_SPLIT}: x {tuple(x.shape)} must be 2-D")
    rows, cols = x.shape
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    out = torch.zeros((2, rows, bounds.round_up(cols, _SPLIT_PITCH)),
                      dtype=torch.bfloat16, device=x.device)
    out[0, :, :cols] = hi
    out[1, :, :cols] = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return out


def split_bf16(x) -> torch.Tensor:
    """x (rows, cols) float as two bf16 planes for the tensor cores, hi
    then lo, |x - hi - lo| <= 2^-17 |x|: the operand of the forward's and
    dW's kernels and of rung 16's (``tuned.mmult_fp32_bt``). Kernel ``split_bf16`` on the card (bit for bit its plain
    version), the plain version on the CPU."""
    if x.device.type == "cpu":
        return split_bf16_ref(x)
    require_cuda(KERNEL_SPLIT, x)
    if x.dim() != 2:
        raise ValueError(f"{KERNEL_SPLIT}: x {tuple(x.shape)} must be 2-D")
    x = x.to(torch.float32).contiguous()
    rows, cols = x.shape
    _aligned(KERNEL_SPLIT, x)
    ldo = bounds.round_up(cols, _SPLIT_PITCH)
    out = torch.empty((2, rows, ldo), dtype=torch.bfloat16, device=x.device)
    if out.numel():
        _build.launch(KERNEL_SPLIT, x.device, x, out, rows, cols, cols, ldo)
    return out


def _stack_kind(w, packed4: bool, scales=None) -> int:
    """The stack kind of the forward's and dx's kernels for ``w``; raises
    on what the card has no kernel for (a stack type without a kind,
    non-fp32 scales)."""
    kind = _KINDS.get("int4" if packed4 else w.dtype)
    if kind is None or (packed4 and w.dtype != torch.int8):
        raise TypeError(f"grouped GEMM: no kernel for a {w.dtype} stack "
                        f"(packed4={packed4})")
    if scales is not None and scales.dtype != torch.float32:
        raise TypeError(f"{KERNEL}: scales must be float32, got "
                        f"{scales.dtype}")
    return kind


def _stack_operand(w, kind: int) -> torch.Tensor:
    """The stack as the forward and dx kernels read it: contiguous, rows
    padded with zero columns to ``_STACK_PITCH`` (a multiple of 16 bytes
    for the tensor maps). At widths that are already multiples -- Mixtral's --
    this is ``w`` itself, never a copy."""
    return bounds.pad_dim(w.contiguous(), 2, _STACK_PITCH[kind])


def _gmm(x, w, block_expert, scales, bt: int, packed4: bool):
    """The forward product, outside autograd: kernel ``grouped_gemm`` on
    the card (kinds 0-2 after ``split_bf16`` of x), its plain version on
    the CPU. ``scales`` may be None with ``packed4`` (the unscaled
    recompute of the packed backward)."""
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w, block_expert, scales, bt=bt,
                                  packed4=packed4)
    _check_card(KERNEL, bt, x, w, block_expert, scales)
    kind = _stack_kind(w, packed4, scales)
    tp, d = x.shape
    out = torch.empty((tp, w.shape[2]), dtype=torch.float32,
                      device=x.device)
    if not out.numel():
        return out
    # kind 3: rows of x on 16-byte boundaries, zero columns
    a = (bounds.pad_dim(x.to(torch.float32).contiguous(), 1, 4)
         if kind == 3 else split_bf16(x))
    s = None if scales is None else scales.contiguous()
    _launch_forward(a, _stack_operand(w, kind),
                    block_expert.to(torch.int32).contiguous(), s, out, d,
                    bt, kind)
    return out


def _launch_forward(a, w, be, s, out, d: int, bt: int, kind: int) -> None:
    """Kernel ``grouped_gemm`` into ``out`` (Tp, f) on operands already in
    its form: ``a`` x's bf16 planes (``split_bf16``, kinds 0-2) or x
    padded to 4 floats a row (kind 3), ``w`` the ``_stack_operand``, ``be``
    int32. ``_gmm``'s last step; also what a caller times to read the
    kernel without the split."""
    _aligned(KERNEL, a, w)
    _build.launch(KERNEL, out.device, a, w, be, s, out, out.shape[0],
                  out.shape[1], d, a.shape[-1], w.shape[2], bt, w.shape[0],
                  kind)


def _segment_sum(v: torch.Tensor, block_expert, e: int, bt: int):
    """(E, f) fp32 sums of the rows (Tp, f) of ``v`` over each expert's
    blocks, in a fixed order: each block's bt rows, then each expert's
    block sums through one product with the one-hot (blocks, E) map (no
    atomics: the same bits on every run)."""
    nb = block_expert.shape[0]
    sums = v.to(torch.float32).reshape(nb, bt, v.shape[1]).sum(1)
    onehot = F.one_hot(block_expert.to(torch.int64), e).to(torch.float32)
    return fp32_matmul(onehot.t(), sums)


class _GmmDense(torch.autograd.Function):
    """``y = x @ w[be]`` on a dense stack (the reference's ``_gmm_dense``):
    dx by the transposed product on the stack in place, dW by the
    per-expert segment sum of the block products, rounded to w's dtype."""

    @staticmethod
    def forward(ctx, x, w, block_expert, bt):
        ctx.bt = bt
        ctx.save_for_backward(x, w, block_expert)
        return _gmm(x, w, block_expert, None, bt, False)

    @staticmethod
    def backward(ctx, dy):
        x, w, be = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad[:2]
        # on the card, dy's bf16 planes split once for both products (an
        # fp32 stack's dx takes dy itself)
        dys = (split_bf16(dy) if dy.device.type != "cpu" and (
            need_dw or (need_dx and w.dtype != torch.float32)) else None)
        dx = _t(dy, w, be, ctx.bt, False, dys).to(x.dtype) if need_dx else None
        dw = (_dw(x, dy, be, w.shape[0], ctx.bt, dys).to(w.dtype) if need_dw
              else None)
        return dx, dw, None, None


class _GmmScaled(torch.autograd.Function):
    """``y = (x @ w[be]) * s[be]`` on an int8 or packed int4 stack (the
    reference's ``_gmm_q8`` and ``_gmm_q4``), QLoRA-style: the stack is
    frozen; dx is the transposed product of dy * s[row's expert] on the
    stack as it lies, ds the per-expert sum of dy * u with u = x @ w[be]
    recomputed without scales."""

    @staticmethod
    def forward(ctx, x, w, scales, block_expert, bt, packed4):
        ctx.bt, ctx.packed4 = bt, packed4
        ctx.save_for_backward(x, w, scales, block_expert)
        return _gmm(x, w, block_expert, scales, bt, packed4)

    @staticmethod
    def backward(ctx, dy):
        x, w, scales, be = ctx.saved_tensors
        bt, nb = ctx.bt, be.shape[0]
        dy = dy.to(torch.float32)
        dx = ds = None
        if ctx.needs_input_grad[0]:
            rows = dy.reshape(nb, bt, dy.shape[1]) * scales[be.to(torch.int64)]
            product = grouped_matmul_t4 if ctx.packed4 else grouped_matmul_t
            dx = product(rows.reshape(dy.shape), w, be, bt=bt).to(x.dtype)
        if ctx.needs_input_grad[2]:
            u = _gmm(x, w, be, None, bt, ctx.packed4)
            ds = _segment_sum(dy * u, be, scales.shape[0], bt)[:, None, :]
            ds = ds.to(scales.dtype)
        return dx, None, ds, None, None, None


def grouped_matmul(x, w, block_expert, scales=None, *, bt: int = 128,
                   packed4: bool = False) -> torch.Tensor:
    """Ragged ``y[i*bt:(i+1)*bt] = x[i*bt:(i+1)*bt] @ w[block_expert[i]]``,
    a fresh (Tp, f) float32, differentiable (see the module docstring).

    x (Tp, d) expert-sorted rows (segments bt-aligned, zero-padded), float
    (converted to fp32); w (E, d, f) fp32, bf16 or int8, or (E, d/2, f)
    packed int4 bytes with ``packed4``; block_expert (Tp // bt,) ints,
    sorted for a dense stack's dW; scales (E, 1, f) float32, applied per
    output column (required with ``packed4``). On the card: kernel
    ``grouped_gemm`` (its backward ``grouped_gemm_t``, ``grouped_gemm_t4``,
    ``grouped_dw``), bt a multiple of 128."""
    _check_layout(x, w, block_expert, scales, bt, packed4)
    if packed4 and scales is None:
        raise ValueError("grouped_matmul: packed4 requires scales (E, 1, f)")
    if scales is None:
        return _GmmDense.apply(x, w, block_expert, bt)
    return _GmmScaled.apply(x, w, scales, block_expert, bt, packed4)


# ------------------------------------------------------------- backward

def _check_t_layout(name: str, dy, w, block_expert, bt: int):
    if dy.dim() != 2 or w.dim() != 3 or w.shape[2] != dy.shape[1]:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} vs w "
                         f"{tuple(w.shape)}: the stack's last dim is the "
                         "contraction")
    _check_blocks(name, dy, block_expert, bt)


def _t_ref(dy, w, block_expert, bt: int, packed4: bool) -> torch.Tensor:
    dy = dy.to(torch.float32)
    dout = w.shape[1] * (2 if packed4 else 1)
    out = torch.empty((dy.shape[0], dout), dtype=torch.float32,
                      device=dy.device)
    for e, blocks in _blocks_of(block_expert).items():
        we = _expert_weight(w, e, packed4)
        for i in blocks:
            rows = slice(i * bt, (i + 1) * bt)
            out[rows] = fp32_matmul(dy[rows], we.t())
    return out


def grouped_matmul_t_ref(dy, w, block_expert, *, bt: int = 128):
    """Plain version of ``grouped_matmul_t``: per block, the fp32 product
    of dy's rows with the transpose of its expert's stack."""
    _check_t_layout(KERNEL_T, dy, w, block_expert, bt)
    return _t_ref(dy, w, block_expert, bt, False)


def grouped_matmul_t4_ref(dy, w, block_expert, *, bt: int = 128):
    """Plain version of ``grouped_matmul_t4``: the same on the stack's
    nibbles unpacked with block_k = dout."""
    _check_t_layout(KERNEL_T4, dy, w, block_expert, bt)
    return _t_ref(dy, w, block_expert, bt, True)


def _t(dy, w, block_expert, bt: int, packed4: bool, dys=None):
    """The transposed product, outside autograd: kernel ``grouped_gemm_t``
    (``grouped_gemm_t4`` on a packed stack) on the card, on dy's bf16
    planes (``split_bf16``; ``dys`` where the caller split dy already) or,
    on an fp32 stack, on dy itself; its plain version on the CPU."""
    if dy.device.type == "cpu":
        return _t_ref(dy, w, block_expert, bt, packed4)
    _check_card(KERNEL_T4 if packed4 else KERNEL_T, bt, dy, w,
                block_expert)
    kind = _stack_kind(w, packed4)
    tp, f = dy.shape
    out = torch.empty((tp, w.shape[1] * (2 if packed4 else 1)),
                      dtype=torch.float32, device=dy.device)
    if not out.numel():
        return out
    if kind == 3:
        # rows of dy on 16-byte boundaries, zero columns
        a = bounds.pad_dim(dy.to(torch.float32).contiguous(), 1, 4)
    else:
        a = split_bf16(dy) if dys is None else dys
    _launch_t(a, _stack_operand(w, kind),
              block_expert.to(torch.int32).contiguous(), out, f, bt, kind)
    return out


def _launch_t(a, w, be, out, k: int, bt: int, kind: int) -> None:
    """Kernel ``grouped_gemm_t`` (kind 2: ``grouped_gemm_t4``) into
    ``out`` (Tp, dout) on operands already in its form: ``a`` dy's bf16
    planes (``split_bf16``, kinds 0-2) or dy padded to 4 floats a row (kind
    3), ``w`` the ``_stack_operand``, ``be`` int32, ``k`` dy's width.
    ``_t``'s last step; also what a caller times to read the kernel
    without the split."""
    name = KERNEL_T4 if kind == 2 else KERNEL_T
    _aligned(name, a, w)
    _build.launch(name, out.device, a, w, be, out, out.shape[0],
                  out.shape[1], k, a.shape[-1], w.shape[2], bt, w.shape[0],
                  *(() if kind == 2 else (kind,)))


def grouped_matmul_t(dy, w, block_expert, *, bt: int = 128):
    """Ragged ``dx[i*bt:(i+1)*bt] = dy[i*bt:(i+1)*bt] @ w[be[i]]^T``, a
    fresh (Tp, dout) float32: dy (Tp, f) float, w (E, dout, f) fp32, bf16
    or int8 contracted over its last dim in place. Kernel
    ``grouped_gemm_t`` on the card after ``split_bf16`` of dy (bt a
    multiple of 128), the plain version on the CPU."""
    _check_t_layout(KERNEL_T, dy, w, block_expert, bt)
    return _t(dy, w, block_expert, bt, False)


def grouped_matmul_t4(dy, w, block_expert, *, bt: int = 128):
    """``grouped_matmul_t`` on a packed int4 stack (E, dout/2, f) int8
    bytes (``quant.pack_int4`` with block_k = dout): output column n <
    dout/2 reads the low nibbles of packed row n, the rest the high
    nibbles of row n - dout/2. Kernel ``grouped_gemm_t4`` on the card."""
    _check_t_layout(KERNEL_T4, dy, w, block_expert, bt)
    return _t(dy, w, block_expert, bt, True)


def _check_dw_layout(x, dy, block_expert, bt: int):
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"{KERNEL_DW}: x {tuple(x.shape)} vs dy "
                         f"{tuple(dy.shape)}")
    _check_blocks(KERNEL_DW, x, block_expert, bt)


def grouped_dw_ref(x, dy, block_expert, e: int, *, bt: int = 128):
    """Plain version of ``grouped_dw``: for each expert the segment sum of
    its blocks' products ``x_i^T dy_i``, taken as one fp32 product over
    the rows of all its blocks; zeros for an expert with no block."""
    _check_dw_layout(x, dy, block_expert, bt)
    x, dy = x.to(torch.float32), dy.to(torch.float32)
    out = torch.zeros((e, x.shape[1], dy.shape[1]), dtype=torch.float32,
                      device=x.device)
    for ei, blocks in _blocks_of(block_expert).items():
        rows = torch.cat([torch.arange(i * bt, (i + 1) * bt)
                          for i in blocks]).to(x.device)
        out[ei] = fp32_matmul(x[rows].t(), dy[rows])
    return out


def grouped_dw(x, dy, block_expert, e: int, *, bt: int = 128):
    """``dW[e] = sum over e's blocks i of x_i^T dy_i``, a fresh (E, d, f)
    float32 (zeros for an expert with no block): x (Tp, d) and dy (Tp, f)
    float, block_expert sorted (the layout's). Kernel ``grouped_dw`` on
    the card after ``split_bf16`` of x and dy (one tile of dW a block of
    threads, no atomics), the plain version on the CPU."""
    _check_dw_layout(x, dy, block_expert, bt)
    return _dw(x, dy, block_expert, e, bt)


def _dw(x, dy, block_expert, e: int, bt: int, dys=None):
    """``grouped_dw`` without the layout check; ``dys`` dy's bf16 planes
    where the caller split dy already."""
    if x.device.type == "cpu":
        return grouped_dw_ref(x, dy, block_expert, e, bt=bt)
    _check_card(KERNEL_DW, bt, x, dy, block_expert)
    d, f = x.shape[1], dy.shape[1]
    if not x.shape[0]:
        return torch.zeros((e, d, f), dtype=torch.float32, device=x.device)
    # every tile written, an expert with no block's as zeros
    out = torch.empty((e, d, f), dtype=torch.float32, device=x.device)
    if out.numel():
        _launch_dw(split_bf16(x), split_bf16(dy) if dys is None else dys,
                   block_expert.to(torch.int32).contiguous(), out, bt)
    return out


def _launch_dw(xs, dys, be, out, bt: int) -> None:
    """Kernel ``grouped_dw`` into ``out`` (E, d, f) on x's and dy's bf16
    planes (``split_bf16``) and ``be`` int32: ``grouped_dw``'s last step;
    also what a caller times to read the kernel without the splits."""
    e, d, f = out.shape
    _build.launch(KERNEL_DW, out.device, xs, dys, be, out, be.shape[0], d,
                  f, e, xs.shape[2], dys.shape[2], bt)
