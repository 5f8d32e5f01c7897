"""int4-weight GEMMs: W4A8 (int8 activations) and W4A16 (bf16 ones).

Counterpart: ``how_to_optimize_gemm_tpu/ops/pallas_int4.py``
(``PACK_BLOCK``, ``prepare_w4a8``, ``mmult_q_w4a8``, ``mmult_q_w4a8_noc``,
``mmult_w4a8_fused_noc``, ``mmult_q_noc``). W is decoded from nibbles
packed two per byte in 512-row pack blocks (``ops/quant.py``).

- ``mmult_q_w4a8`` (rung 07b, K3, ``csrc/w4a8_gemm.cu``: the kernel of
  ``mmult_q_w4a8_noc`` below with C added in its epilogue):
  ``C = f32(QA @ W as int32) * sa[i] * sw[j] + C``, IN PLACE on ``c`` as
  the reference aliases C into its output.
- ``mmult_q_w4a8_noc`` (the serving linear at m > 64, kernel
  ``w4a8_gemm_noc``, int8 ``wgmma`` on tiles of 64 or 128 tokens x 256
  columns, the token tile chosen by the kernel's launcher): ``y = f32(QA
  @ W as int32) * sa[i] * sw[j]``.
- ``mmult_w4a8_fused_noc`` (the serving linear at m <= 64, kernel
  ``w4a8_gemv_fq``): the same with the activation quantization of float
  rows done on the card, ``quantize_symmetric(x, axis=1)`` first.
- ``mmult_q_noc`` (W4A16, the int4 serving linear):
  ``y = (A_bf16 @ W) * sw[j]`` with fp32 sums; kernel ``w4a16_gemv`` at
  m <= 64 (the W4A8 GEMV's cluster walk with bf16 products,
  ``w4a16_gemv_plan``), ``w4a16_gemm_noc`` above (bf16 ``wgmma`` with the
  decoded weights in registers, the W4A8 GEMM's walk).
- ``mmult_q`` (rung 07, W4A16, kernel ``w4a16_gemm``: the prefill GEMM's
  bf16 ``wgmma`` body, ``csrc/w4a16_wgmma.cuh``, with C added in place by
  tensor-map reductions): ``C = (A_bf16 @ W) * sw[j] + C``, IN PLACE on
  ``c``; ``prepare`` makes its operands.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (``*_ref``) only for CPU tensors. The W4A8 kernels equal their
plain versions bit for bit (exact int32 sums, the epilogue in the same
order). The W4A16 kernels' products are exact in fp32 but summed in
another order (the GEMM's by the tensor cores), so they agree with
their plain versions to rounding: within 2e-5 of max |y| on the card's
tests. Both W4A16 serving kernels sum in a fixed order: two calls, and a
CUDA graph's replays, give the same bits.
"""
from __future__ import annotations

import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import bounds, quant
from how_to_optimize_gemm_tpu_torch.ops.int8 import (
    ALIGN, require_cuda, check_operands, dequant_epilogue, int_matmul_exact)
from how_to_optimize_gemm_tpu_torch.ops.vendor import fp32_matmul

# K rows per pack block: rows [g*512, g*512+256) of W live in the low
# nibbles and [g*512+256, g*512+512) in the high nibbles of packed rows
# [g*256, (g+1)*256).
PACK_BLOCK = 512


def _pack_weights(b: torch.Tensor):
    """B -> int4 per column, zero-padded to whole pack blocks and packed:
    ``(packed, sw, kdim)``."""
    kdim = b.shape[0]
    bp = bounds.pad_dim(b, 0, PACK_BLOCK)
    qw, sw = quant.quantize_symmetric(bp, axis=0, bits=4)
    return quant.pack_int4(qw, PACK_BLOCK), sw, kdim


def prepare_w4a8(a: torch.Tensor, b: torch.Tensor):
    """A -> int8 per row; B -> packed int4 per column. Returns
    ``(qa, sa, packed, sw, kdim)``."""
    qa, sa = quant.quantize_symmetric(a, axis=1)          # (M,K) int8
    return (qa, sa, *_pack_weights(b))


def prepare(a: torch.Tensor, b: torch.Tensor):
    """Rung 07 (W4A16): A -> bf16; B -> packed int4 per column. Returns
    ``(a16, packed, sw, kdim)``."""
    return (a.to(torch.bfloat16), *_pack_weights(b))


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
    of 512 and K <= Kp, sw (1, N) float32. No C is read or added. One
    launch at every m; the kernel reads each packed byte once per tile,
    both nibbles in one stage."""
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
# Its walk (csrc/w4a8_gemv_fq.cu, names in brackets): clusters of blocks
# that share a slab of GEMV_SLAB output columns (SLAB) and up to
# GEMV_ROWS rows of x (ROWS; more rows take more row groups of the grid)
# and split the slab's K in stages of GEMV_STAGE_ROWS packed rows
# (PACK_ROWS), which a ring of GEMV_RING stages (ST) streams; at most
# GEMV_MAX_CLUSTER blocks a cluster (MAX_CLUSTER), the int32 sums 16 times
# the true ones (Kp at most GEMV_MAX_KP), a block's shared memory at most
# GEMV_SMEM, three blocks an SM by the kernel's register bound, an SM's
# shared memory GEMV_SM_SMEM (1 KB of it reserved a block).
GEMV_SLAB = 128
GEMV_ROWS = 8
GEMV_STAGE_ROWS = 128
GEMV_RING = 4
GEMV_MAX_CLUSTER = 8
GEMV_MAX_KP = 131072
GEMV_SMEM = 232448
GEMV_BLOCKS_PER_SM = 3
GEMV_SM_SMEM = 233472
_GEMV_ROW_PAD = 16
_SMS: dict = {}


def gemv_stages(k: int) -> int:
    """Stages of K rows: pack block b's halves h with K rows from
    512 b + 128 h below k (stage s's low nibbles are K rows 512 (s // 2) +
    128 (s % 2) .., its high nibbles the same + 256)."""
    rest = k % PACK_BLOCK
    return 2 * (k // PACK_BLOCK) + (2 if rest > 128 else 1 if rest else 0)


def gemv_smem(rows: int, spc: int, cluster: int) -> int:
    """Dynamic shared memory of a block: the 1024-byte alignment, the ring,
    ``rows`` rows of quantized x holding ``spc`` stages' K rows, then the
    cluster's partials of its 1 / cluster share of the slab's sums."""
    return (1024 + GEMV_RING * GEMV_SLAB * GEMV_STAGE_ROWS
            + rows * (spc * 2 * GEMV_STAGE_ROWS + _GEMV_ROW_PAD)
            + 4 * cluster * -(-rows * GEMV_SLAB // cluster))


def gemv_plan(m: int, k: int, n: int, sms: int, smem=gemv_smem) -> int:
    """The cluster of the fused GEMV at (m, k, n) on ``sms`` SMs: 1 to 8
    blocks, each with a stage at least, the smallest whose slabs take two
    blocks an SM, else the largest that keeps one row group's blocks in
    one wave (GEMV_BLOCKS_PER_SM an SM, fewer where shared memory holds
    fewer), at most 2 where m takes more than one row group (their blocks
    fill the card: on an H100 clusters of 2 were the fastest at m = 16 and
    64 on five of the six 7B shapes); grown further until a block's shared
    memory fits (it does up to Kp = GEMV_MAX_KP). ``smem(rows, spc,
    cluster)``: a block's dynamic shared memory (the W4A16 GEMV's walk
    passes its own, ``w4a16_gemv_plan``)."""
    stages = gemv_stages(k)
    slabs = -(-n // GEMV_SLAB)
    rows = min(m, GEMV_ROWS)

    def fits(cluster):
        return smem(rows, -(-stages // cluster), cluster) <= GEMV_SMEM

    def one_wave(cluster):
        size = smem(rows, -(-stages // cluster), cluster)
        per_sm = min(GEMV_BLOCKS_PER_SM, GEMV_SM_SMEM // (size + 1024))
        return slabs * cluster <= per_sm * sms

    cap = GEMV_MAX_CLUSTER if m <= GEMV_ROWS else 2
    cluster = 1
    while (cluster < cap and 2 * cluster <= stages
           and slabs * cluster < 2 * sms and one_wave(2 * cluster)):
        cluster *= 2
    while not fits(cluster):
        cluster *= 2
    return cluster


def _sm_count(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def mmult_w4a8_fused_noc_ref(x, packed, sw):
    """Plain version of ``mmult_w4a8_fused_noc``: quantize the rows of x
    (``quantize_symmetric(x, axis=1)``), then ``mmult_q_w4a8_noc_ref``."""
    qa, sa = quant.quantize_symmetric(x.to(torch.float32), axis=1)
    return mmult_q_w4a8_noc_ref(qa, sa, packed, sw)


def mmult_w4a8_fused_noc(x, packed, sw):
    """y = quantize(x) @ dequant(W4), fp32: the W4A8 decode linear with
    the activation quantization fused into the kernel.

    x (m, K) float with m <= 64, packed (Kp/2, N) int8, sw (1, N) float32.
    One launch and one allocation (out): the kernel reads x at its own K
    and counts the columns up to Kp as zeros (the reference's pad, which
    changes no row maximum); ``gemv_plan`` sizes its clusters."""
    m, k = x.shape
    if m > GEMV_MAX_M:
        raise ValueError(f"mmult_w4a8_fused_noc: m={m} > {GEMV_MAX_M}; the "
                         "fused-quant GEMV is the decode-width form")
    if x.device.type == "cpu":
        return mmult_w4a8_fused_noc_ref(x, packed, sw)
    name = "mmult_w4a8_fused_noc"
    require_cuda(name, x)
    n = sw.shape[-1]
    kp = _check_packed(name, packed, k, n)
    if kp > GEMV_MAX_KP:
        raise ValueError(f"{name}: Kp={kp} > {GEMV_MAX_KP}")
    if x.dtype != torch.float32 or x.stride(1) != 1:
        x = x.to(torch.float32).contiguous()
    packed = bounds.pad_dim(packed, 1, ALIGN)
    if tuple(sw.shape) != (1, n) or sw.dtype != torch.float32 \
            or packed.dtype != torch.int8:
        raise TypeError(f"{name}: expected int8 packed and float32 sw (1, "
                        f"{n}); got {packed.dtype}, {sw.dtype} "
                        f"{tuple(sw.shape)}")
    for t in (packed, sw):
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if packed.data_ptr() % ALIGN:
        raise ValueError(f"{name}: packed not {ALIGN}-byte aligned")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        _build.launch("w4a8_gemv_fq", out.device, x, packed, sw, out, m, n,
                      k, x.stride(0), kp, packed.shape[1],
                      gemv_plan(m, k, n, _sm_count(x.device)))
    return out


# ------------------------------------------------------------------ W4A16

# The W4A16 decode GEMV (csrc/w4a16_gemv.cu) walks the fused W4A8 GEMV's
# clusters, slabs, stages, ring and row groups (the GEMV_* constants
# above); its rows of A are bf16, 256 K rows a stage in 64-byte groups
# (GROUP_BYTES) and a pad of W4A16_GEMV_ROW_PAD bytes a row (ROW_PAD), and
# the partials meet in the ring. It serves Kp up to W4A16_GEMV_MAX_KP,
# where 8 rows of A fit a block's shared memory at clusters of 8 (larger
# K takes the GEMM).
W4A16_GEMV_GROUP_BYTES = 64
W4A16_GEMV_ROW_PAD = 16
W4A16_GEMV_MAX_KP = 65536


def w4a16_gemv_smem(rows: int, spc: int, cluster: int = 1) -> int:
    """Dynamic shared memory of a W4A16 GEMV block: the 1024-byte
    alignment, the ring, then ``rows`` rows of A holding ``spc`` stages'
    K rows (``cluster`` sizes nothing: the partials use the ring)."""
    return (1024 + GEMV_RING * GEMV_SLAB * GEMV_STAGE_ROWS
            + rows * (spc * 8 * W4A16_GEMV_GROUP_BYTES + W4A16_GEMV_ROW_PAD))


def w4a16_gemv_plan(m: int, k: int, n: int, sms: int) -> int:
    """The cluster of the W4A16 GEMV at (m, k, n): ``gemv_plan``'s rule on
    its blocks' shared memory."""
    return gemv_plan(m, k, n, sms, w4a16_gemv_smem)


def mmult_q_noc_ref(a, packed, sw):
    """Plain version of ``mmult_q_noc``: ``(f32(A) @ f32(W)) * sw``, every
    product exact in fp32, the sums in PyTorch's order."""
    w = quant.unpack_int4(packed, PACK_BLOCK)[: a.shape[1]]
    return fp32_matmul(a.to(torch.float32), w.to(torch.float32)) * sw


def mmult_q_ref(a16, packed, sw, c):
    """Plain version of rung 07, out of place: ``(A @ W) * sw + C``, the
    reference's flush order."""
    return mmult_q_noc_ref(a16, packed, sw) + c


def _w4a16_operands(name: str, a, packed, sw, n: int):
    """Raise on what the W4A16 kernels do not take; returns ``(kp,
    packed)`` with the packed pitch padded to 16 bytes."""
    k = a.shape[1]
    kp = _check_packed(name, packed, k, n)
    if a.dtype != torch.bfloat16 or packed.dtype != torch.int8 \
            or sw.dtype != torch.float32:
        raise TypeError(f"{name}: expected bf16 a, int8 packed, "
                        f"float32 sw; got {a.dtype}, {packed.dtype}, "
                        f"{sw.dtype}")
    if tuple(sw.shape) != (1, n):
        raise ValueError(f"{name}: sw {tuple(sw.shape)} vs (1, {n})")
    for t in (packed, sw):
        if t.device != a.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    packed = bounds.pad_dim(packed, 1, ALIGN)
    if packed.data_ptr() % ALIGN:
        raise ValueError(f"{name}: packed not {ALIGN}-byte aligned")
    return kp, packed


def _rows_aligned(name: str, a):
    """A contiguous with rows starting on 16-byte boundaries: K padded to
    8 bf16 with zero columns."""
    a = bounds.pad_dim(a.contiguous(), 1, ALIGN // 2)
    if a.data_ptr() % ALIGN:
        raise ValueError(f"{name}: a not {ALIGN}-byte aligned")
    return a


def mmult_q_noc(a, packed, sw):
    """y = (A @ dequant(W4)) in fp32, a fresh (M, N) float32: the W4A16
    serving linear (int4 weights, bf16 activations).

    a (M, K) bf16, packed (Kp/2, N) int8 with Kp a multiple of 512 and
    K <= Kp (columns of A past K count as zero), sw (1, N) float32. m <= 64
    launches ``w4a16_gemv`` (on a's rows as they lie where they are
    contiguous; ``w4a16_gemv_plan`` sizes its clusters), larger m (or Kp
    past ``W4A16_GEMV_MAX_KP``) ``w4a16_gemm_noc``: one launch a call,
    after the pads of a packed pitch that is no 16-byte multiple and, for
    the GEMM, of rows of A that are not."""
    if a.device.type == "cpu":
        return mmult_q_noc_ref(a, packed, sw)
    require_cuda("mmult_q_noc", a)
    m, k = a.shape
    n = sw.shape[-1]
    kp, packed = _w4a16_operands("mmult_q_noc", a, packed, sw, n)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if not (m and n):
        return out
    if m <= GEMV_MAX_M and kp <= W4A16_GEMV_MAX_KP:
        if a.stride(1) != 1:
            a = a.contiguous()
        lda = a.stride(0) if m > 1 else k   # a row's stride is not read
        _build.launch("w4a16_gemv", a.device, a, packed, sw, out, m, n, k,
                      lda, kp, packed.shape[1],
                      w4a16_gemv_plan(m, k, n, _sm_count(a.device)))
    else:
        a = _rows_aligned("mmult_q_noc", a)
        ka = a.shape[1]
        _build.launch("w4a16_gemm_noc", a.device, a, packed, sw, out, m, n,
                      ka, ka, packed.shape[1], n)
    return out


def mmult_q(a16, packed, sw, c):
    """Rung 07: C = (A_bf16 @ dequant(W4)) * sw + C with fp32 sums, IN
    PLACE on ``c`` (returned), as the reference aliases C into its output.

    a16 (M, K) bf16, packed (Kp/2, N) int8 with Kp a multiple of 512 and
    K <= Kp, sw (1, N), c (M, N) float32. Kernel ``w4a16_gemm`` at every
    m, as the reference's rung runs one kernel."""
    if c.device.type == "cpu":
        c.copy_(mmult_q_ref(a16, packed, sw, c))
        return c
    require_cuda("mmult_q", c)
    m, n = c.shape
    if a16.dim() != 2 or a16.shape[0] != m:
        raise ValueError(f"mmult_q: a {tuple(a16.shape)} vs c "
                         f"{tuple(c.shape)}")
    _, packed = _w4a16_operands("mmult_q", a16, packed, sw, n)
    if c.dtype != torch.float32 or c.device != a16.device \
            or not c.is_contiguous():
        raise ValueError(f"mmult_q: c must be a contiguous float32 tensor "
                         f"on {a16.device}")
    a = _rows_aligned("mmult_q", a16)
    if m and n:
        ka = a.shape[1]
        _build.launch("w4a16_gemm", c.device, a, packed, sw, c, c, m, n, ka,
                      ka, packed.shape[1], n)
    return c
