"""The hand-pipeline record's streaming rungs 08-11 on hand-built rings.

Counterpart of ``how_to_optimize_gemm_tpu/ops/pallas_manual_dma.py``'s
first four rungs. Each computes ``C' = f32(QA @ QB as int32) * sa[i] *
sb[j] + C`` into a fresh output (``c`` is not modified, as the reference's
rungs 08-11 alias nothing) and adds one idea to the rung before it:

- ``mmult_q`` (rung 08, kernel ``int8_dma_nn``, B (K, N)): rung 06's tile
  on a two-slot K-loop ring tracked per slot by mbarriers, chunk t+1's
  copies issued before chunk t is waited on;
- ``mmult_q_fat`` (rung 09, ``int8_fat_nn``, B (K, N)): the largest C tile
  a block holds (``fat_tile``), C fetched at each tile's start and awaited
  at its flush, the output stored by bulk copies that drain during the next
  tile's K loop; a persistent kernel;
- ``mmult_q_packed`` (rung 10, ``int8_fat_nt``, B^T (N, K) from
  ``int8.prepare_packed``): rung 09 with both operands K-major and two C/out
  buffers, the reference's accumulator ping-pong;
- ``mmult_q_strip`` (rung 11, ``int8_strip_nt``, B^T): rung 10 with each A
  chunk read once per thread-block cluster of ``CLUSTER`` tiles along N and
  multicast to all of them, the card's form of a resident A strip.

The kernels are in ``csrc/int8_dma_nn.cu``, ``csrc/int8_fat.cu`` (09 and 10)
and ``csrc/int8_strip_nt.cu`` on ``csrc/manual_dma.cuh``. Each wrapper
launches its kernel for CUDA tensors and runs its plain version
(``*_ref``: exact int32 products, then the rank-1 dequant epilogue plus C)
only for CPU tensors; the kernels equal their plain versions bit for bit.
"""
from __future__ import annotations

import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import bounds, int8

# H100: the shared memory one block may use (227 KB), registers a thread
SMEM_BLOCK = 232_448
MAX_REGS = 255
THREADS = 256
# the fat kernels' tiling (csrc/manual_dma.cuh): 8 warps, 2 on M x 4 on N,
# 64-byte K chunks in a two-slot ring, rows padded to 80 bytes
BM = 128
BK = 64
LDS = BK + 16
SLOTS = 2
# registers a thread needs beside its accumulators: fragments, addresses,
# the B chunk staged through registers (rung 09)
REG_OVERHEAD = 64
CLUSTER = 4            # rung 11's blocks sharing an A chunk
ALIGN = int8.ALIGN     # K rows start on 16-byte boundaries
C_ALIGN = 4            # C/out rows are bulk-copied: pitch a multiple of 16 B


def fat_smem_bytes(bm: int, bn: int, buffers: int) -> int:
    """Shared memory of the fat kernel at a bm x bn tile with ``buffers``
    C/out buffers: the (A, B) ring, the fp32 buffers (rows padded by 32
    bytes) and the mbarriers (csrc/manual_dma.cuh, ``FatLayout``)."""
    return (SLOTS * (bm + bn) * LDS + buffers * bm * (4 * bn + 32)
            + 8 * (2 * SLOTS + buffers))


def fat_regs(bm: int, bn: int) -> int:
    """Registers a thread: its share of the int32 accumulators and the
    rest (``REG_OVERHEAD``)."""
    return bm * bn // THREADS + REG_OVERHEAD


def fat_tile(buffers: int) -> tuple[int, int]:
    """The largest (bm, bn) C tile, bm = 128 (two warps of 64 rows) and bn
    a multiple of 128 (four warps), whose ring and ``buffers`` C/out
    buffers fit a block's shared memory and whose accumulators fit the
    register file: (128, 256) with one buffer, (128, 128) with two."""
    fits = [bn for bn in (512, 384, 256, 128)
            if fat_smem_bytes(BM, bn, buffers) <= SMEM_BLOCK
            and fat_regs(BM, bn) <= MAX_REGS]
    if not fits:
        raise ValueError(f"no fat tile fits {buffers} buffers")
    return BM, fits[0]


# rung 09's tile: one C/out buffer (the reference's fixed 1024 x 1024)
FAT_BM, FAT_BN = fat_tile(1)


def choose_blocks_fat(m: int, n: int, k: int) -> tuple[int, int, int]:
    """(bm, bn, bk) of rungs 10 and 11 (two C/out buffers): bn the
    least-waste multiple of 128 under ``fat_tile(2)``'s cap (the
    reference's rule, ``bounds._least_waste``), bk the kernel's 64-byte K
    chunk (K is zero-padded to a multiple of 16)."""
    bm, cap = fat_tile(2)
    bn = bounds._least_waste(bounds.round_up(n, 128), cap, 128)
    return bm, bn, BK


def mmult_q_ref(qa, sa, qb, sb, c):
    """Plain version of rungs 08 and 09: a fresh ``dequant(QA @ QB) + C``
    with B (K, N)."""
    return int8.mmult_q_ref(qa, sa, qb, sb, c)


def mmult_q_packed_ref(qa, sa, qbt, sb, c):
    """Plain version of rungs 10 and 11: a fresh ``dequant(QA @ QBT^T) +
    C`` with B packed transposed (N, K)."""
    return int8.mmult_q_bt_ref(qa, sa, qbt, sb, c)


mmult_q_fat_ref = mmult_q_ref
mmult_q_strip_ref = mmult_q_packed_ref


def _operands(name: str, qa, sa, b, sb, c, packed: bool):
    """Shapes checked, K (and B's rows) padded to 16 bytes; raise on what
    the kernels do not take."""
    m, n = c.shape
    k = qa.shape[1]
    want = (n, k) if packed else (k, n)
    if tuple(b.shape) != want:
        raise ValueError(f"{name}: b {tuple(b.shape)} vs {want}")
    qa = bounds.pad_dim(qa, 1, ALIGN)
    b = (bounds.pad_dim(b, 1, ALIGN) if packed
         else bounds.pad_dim(bounds.pad_dim(b, 0, ALIGN), 1, ALIGN))
    int8.check_operands(name, qa, sa, b, sb, c)
    return qa, b


def _launch(kernel: str, qa, b, sa, sb, c, pad_c: bool):
    """A fresh output. pad_c: the kernel bulk-copies rows of C and out,
    so both get a row pitch that is a multiple of 16 bytes (C is copied
    only when N is not a multiple of 4) and 16-byte aligned bases."""
    m, n = c.shape
    if pad_c:
        c = bounds.pad_dim(c, 1, C_ALIGN)
        if c.data_ptr() % 16:
            raise ValueError(f"{kernel}: c not 16-byte aligned")
    out = torch.empty_like(c)
    if m and n:
        kp = qa.shape[1]
        _build.launch(kernel, c.device, qa, b, sa, sb, c, out, m, n, kp, kp,
                      b.shape[1], c.shape[1])
    return out if out.shape[1] == n else out[:, :n].contiguous()


def mmult_q(qa, sa, qb, sb, c):
    """Rung 08: C' = dequant(QA @ QB) + C, a fresh (M, N) float32.

    qa (M, K) int8, sa (M, 1), qb (K, N) int8, sb (1, N), c (M, N)
    float32; ``c`` is not modified."""
    if c.device.type == "cpu":
        return mmult_q_ref(qa, sa, qb, sb, c)
    int8.require_cuda("manual_dma.mmult_q", c)
    qa, qb = _operands("manual_dma.mmult_q", qa, sa, qb, sb, c, False)
    return _launch("int8_dma_nn", qa, qb, sa, sb, c, False)


def mmult_q_fat(qa, sa, qb, sb, c):
    """Rung 09: rung 08's function on the persistent fat-tile kernel
    (``FAT_BM`` x ``FAT_BN`` tiles). Operands as ``mmult_q``."""
    if c.device.type == "cpu":
        return mmult_q_fat_ref(qa, sa, qb, sb, c)
    int8.require_cuda("mmult_q_fat", c)
    qa, qb = _operands("mmult_q_fat", qa, sa, qb, sb, c, False)
    return _launch("int8_fat_nn", qa, qb, sa, sb, c, True)


def mmult_q_packed(qa, sa, qbt, sb, c):
    """Rung 10: C' = dequant(QA @ QBT^T) + C with B packed transposed
    (N, K) (``int8.prepare_packed``), a fresh (M, N) float32; tiles of
    ``choose_blocks_fat``."""
    if c.device.type == "cpu":
        return mmult_q_packed_ref(qa, sa, qbt, sb, c)
    int8.require_cuda("mmult_q_packed", c)
    qa, qbt = _operands("mmult_q_packed", qa, sa, qbt, sb, c, True)
    return _launch("int8_fat_nt", qa, qbt, sa, sb, c, True)


def mmult_q_strip(qa, sa, qbt, sb, c):
    """Rung 11: rung 10 with each A chunk shared by a cluster of
    ``CLUSTER`` blocks along N. Operands as ``mmult_q_packed``."""
    if c.device.type == "cpu":
        return mmult_q_strip_ref(qa, sa, qbt, sb, c)
    int8.require_cuda("mmult_q_strip", c)
    qa, qbt = _operands("mmult_q_strip", qa, sa, qbt, sb, c, True)
    return _launch("int8_strip_nt", qa, qbt, sa, sb, c, True)


def mmult(a, b, c):
    """Full path (quantize + rung 08) on float32 inputs."""
    qa, sa, qb, sb = int8.prepare(a, b)
    return mmult_q(qa, sa, qb, sb, c)
