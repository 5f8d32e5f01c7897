"""bf16 and fp32 GEMMs of the ladder: rungs 04, 05, 15 and 16.

Counterpart: ``how_to_optimize_gemm_tpu/ops/pallas_tuned.py`` (``mmult``,
``mmult_bf16``, ``prepare_bf16_bt``, ``mmult_bf16_bt``,
``prepare_fp32_bt``, ``mmult_fp32_bt``). Each computes ``A @ B + C`` with
fp32 sums:

- ``mmult`` (rung 04, kernel ``fp32_gemm_nn``) on fp32 A (M, K) and B
  (K, N) at full fp32 accuracy: the accumulator is seeded with C, as the
  reference's ``_make_kernel`` does; a fresh output;
- ``mmult_bf16`` (rung 05, ``bf16_gemm_nn``) on bf16 ones: the tensor
  cores' accumulators are seeded with C, as the reference's
  ``_make_kernel`` does; a fresh output;
- ``mmult_bf16_bt`` (rung 15, ``bf16_gemm_nt``) and ``mmult_fp32_bt``
  (rung 16, ``fp32_gemm_nt``) on B packed transposed offline, (N, K)
  (``prepare_bf16_bt``, ``prepare_fp32_bt``): the accumulator starts at 0
  and C is added at the flush, IN PLACE on ``c``, as the reference aliases
  C into its output. Rung 16 splits A and BT into bf16 hi + lo planes
  (``grouped_gemm.split_bf16``) inside the call and takes hi.hi + hi.lo +
  lo.hi on the tensor cores.

The reference's VMEM block choosers are not ported: rungs 05, 15 and 16
run one ``wgmma`` kernel (``csrc/gemm_wgmma.cuh``) on fixed tiles walked
by a persistent grid (``NT_TILE``, ``FP32_NT_TILE``, ``nt_tile_walk``),
rung 04 128 x 128 FFMA tiles. Each wrapper launches its kernel for CUDA
tensors and runs its plain version (``*_ref``) only for CPU tensors.
Products of bf16 values are exact in fp32, and every kernel sums in
another order than its plain version (the tensor cores, or one fmaf chain
over K), so the two agree to rounding; rung 16 also drops lo.lo (below
2^-16 of each product).
"""
from __future__ import annotations

import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import bounds
from how_to_optimize_gemm_tpu_torch.ops.grouped_gemm import split_bf16
from how_to_optimize_gemm_tpu_torch.ops.int8 import ALIGN, require_cuda
from how_to_optimize_gemm_tpu_torch.ops.vendor import fp32_matmul


# the wgmma kernel's output tile (rows, columns) for rungs 15 and 05
# (csrc/bf16_gemm_nt.cu, bf16_gemm_nn.cu) and for rung 16
# (csrc/fp32_gemm_nt.cu), and the row tiles of a group of its walk
# (csrc/gemm_wgmma.cuh)
NT_TILE = (128, 256)
FP32_NT_TILE = (128, 128)
NT_GROUP_M = 8


def nt_tile_walk(m: int, n: int, blocks: int, tile=NT_TILE) -> list:
    """The (row, column) origins of the output tiles that each block of
    the ``wgmma`` kernel's persistent grid computes, in order, for an (m,
    n) output in ``tile``-sized tiles (``NT_TILE``: rungs 15 and 05;
    ``FP32_NT_TILE``: rung 16): the kernel launches ``min(blocks, tiles)``
    blocks (one an SM), block i taking tiles i, i + blocks, ...; tile t
    lies in group t // (NT_GROUP_M x column tiles) of NT_GROUP_M row tiles
    (fewer in the last group), the row tile fastest inside a group, so
    that the blocks running at once share a few rows of A and the columns
    of B in L2."""
    tm, tn = tile
    num_m, num_n = -(-m // tm), -(-n // tn)
    per_group = NT_GROUP_M * num_n

    def origin(t):
        first = t // per_group * NT_GROUP_M
        gm = min(num_m - first, NT_GROUP_M)
        r = t % per_group
        return (first + r % gm) * tm, (r // gm) * tn
    tiles = num_m * num_n
    return [[origin(t) for t in range(i, tiles, blocks)]
            for i in range(min(blocks, tiles))]


def prepare_bf16_bt(a: torch.Tensor, b: torch.Tensor):
    """Offline pack of rung 15: A to bf16, B transposed to a contiguous
    (N, K) bf16."""
    return (a.to(torch.bfloat16),
            b.to(torch.bfloat16).t().contiguous())


def prepare_fp32_bt(a: torch.Tensor, b: torch.Tensor):
    """Offline pack of rung 16: B transposed to a contiguous (N, K)."""
    return a, b.t().contiguous()


def mmult_ref(a, b, c):
    """Plain version of rung 04: ``C + A @ B`` in fp32, a fresh output."""
    return c + fp32_matmul(a, b)


def mmult_bf16_ref(a16, b16, c):
    """Plain version of rung 05: ``C + A @ B`` on bf16 values, fp32
    sums."""
    return c + fp32_matmul(a16.to(torch.float32), b16.to(torch.float32))


def mmult_bf16_bt_ref(a16, bt16, c):
    """Plain version of rung 15, out of place: ``A @ BT^T + C``."""
    return fp32_matmul(a16.to(torch.float32),
                       bt16.to(torch.float32).t()) + c


def mmult_fp32_bt_ref(a, bt, c):
    """Plain version of rung 16, out of place: ``A @ BT^T + C``."""
    return fp32_matmul(a, bt.t()) + c


def check_gemm(name: str, a, b, c, out, dtype, bt: bool,
               align: bool = True):
    """Check the operands of a GEMM kernel (shapes, dtypes, one device,
    contiguous) and return (a, b), zero-padded with ``align`` (see
    ``launch_gemm``)."""
    m, n = c.shape
    k = a.shape[1] if a.dim() == 2 else -1
    b_shape = (n, k) if bt else (k, n)
    if a.dim() != 2 or a.shape[0] != m or tuple(b.shape) != b_shape:
        raise ValueError(f"{name}: a {tuple(a.shape)}, b {tuple(b.shape)} "
                         f"and c {tuple(c.shape)} do not match (b as "
                         f"{'(N, K)' if bt else '(K, N)'})")
    if align:
        per_row = ALIGN // dtype.itemsize
        a = bounds.pad_dim(a, 1, per_row)
        b = bounds.pad_dim(b, 1, per_row)
        if not bt:
            b = bounds.pad_dim(b, 0, per_row)
    for t, dt in ((a, dtype), (b, dtype), (c, torch.float32),
                  (out, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if t.device != c.device:
            raise ValueError(f"{name}: tensors on {t.device} and {c.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if align:
        for t in (a, b):
            if t.data_ptr() % ALIGN:
                raise ValueError(f"{name}: operand not {ALIGN}-byte "
                                 "aligned")
    return a, b


def launch_gemm(name: str, kernel: str, a, b, c, out, dtype, bt: bool,
                align: bool = True, extra: tuple = ()):
    """Check the operands, launch ``kernel`` on (a, b, c, out, M, N, K,
    lda, ldb, ldc, *extra) and return ``out``.

    align: zero-pad K (and an N-major B's columns) so that every row
    starts on a 16-byte boundary (exact: zeros add nothing), for kernels
    that stage rows by 16-byte loads; without it the operands are passed
    as they lie."""
    a, b = check_gemm(name, a, b, c, out, dtype, bt, align)
    m, n = c.shape
    if m and n:
        kp = a.shape[1]
        _build.launch(kernel, c.device, a, b, c, out, m, n, kp, kp,
                      b.shape[1], n, *extra)
    return out


def mmult(a, b, c):
    """Rung 04: ``C' = C + A @ B`` in fp32 at full fp32 accuracy, a fresh
    (M, N) output (kernel ``fp32_gemm_nn``); ``c`` is not modified."""
    if c.device.type == "cpu":
        return mmult_ref(a, b, c)
    require_cuda("mmult", c)
    return launch_gemm("mmult", "fp32_gemm_nn", a, b, c,
                       torch.empty_like(c), torch.float32, bt=False)


def mmult_bf16(a, b, c):
    """Rung 05: ``C' = C + A_bf16 @ B_bf16`` with fp32 sums, a fresh
    (M, N) output (kernel ``bf16_gemm_nn``, its accumulators seeded with
    C); ``c`` is not modified. A and B are cast to bf16 as the reference's
    ``mmult_bf16`` does (no copy when they already are)."""
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if c.device.type == "cpu":
        return mmult_bf16_ref(a, b, c)
    require_cuda("mmult_bf16", c)
    return launch_gemm("mmult_bf16", "bf16_gemm_nn", a, b, c,
                       torch.empty_like(c), torch.bfloat16, bt=False)


def mmult_bf16_bt(a16, bt16, c):
    """Rung 15: ``C = A_bf16 @ BT_bf16^T + C`` with fp32 sums, BT (N, K).

    IN PLACE: the result is written into ``c``, which is returned
    (kernel ``bf16_gemm_nt``)."""
    if c.device.type == "cpu":
        c.copy_(mmult_bf16_bt_ref(a16, bt16, c))
        return c
    require_cuda("mmult_bf16_bt", c)
    return launch_gemm("mmult_bf16_bt", "bf16_gemm_nt", a16, bt16, c, c,
                       torch.bfloat16, bt=True)


def mmult_fp32_bt(a, bt, c):
    """Rung 16: ``C = A @ BT^T + C`` on fp32 operands, BT (N, K), within
    FP32_REL of the fp32 product. IN PLACE on ``c``, which is returned. On
    the card A and BT are split into bf16 hi + lo planes (kernel
    ``split_bf16``, twice) and kernel ``fp32_gemm_nt`` takes hi.hi + hi.lo
    + lo.hi: bf16x3, XLA's Precision.HIGH, not the six passes of the
    reference's HIGHEST."""
    if c.device.type == "cpu":
        c.copy_(mmult_fp32_bt_ref(a, bt, c))
        return c
    require_cuda("mmult_fp32_bt", c)
    a, bt = check_gemm("mmult_fp32_bt", a, bt, c, c, torch.float32,
                       bt=True, align=False)
    m, n = c.shape
    if m and n and a.shape[1]:
        a2, b2 = split_bf16(a), split_bf16(bt)
        k = a2.shape[2]
        _build.launch("fp32_gemm_nt", c.device, a2, b2, c, c, m, n, k, k, k,
                      n)
    return c
