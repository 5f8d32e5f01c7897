"""The hand-pipeline record's rungs 08-13 on hand-built rings.

Counterpart of ``how_to_optimize_gemm_tpu/ops/pallas_manual_dma.py``. Each
rung computes ``C' = f32(QA @ QB as int32) * sa[i] * sb[j] + C`` into a
fresh output (``c`` is not modified, as the reference's rungs 08-13 alias
nothing) and adds one idea to the rung before it:

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
  multicast to all of them, the card's form of a resident A strip;
- ``mmult_q_resident`` (rung 12, ``int8_resident_nt``, B^T): rung 10's walk
  with both operands held in the L2, the card's on-chip store of their
  size: prefetched once, every chunk copied under evict_last, C and the
  output under evict_first;
- ``mmult_q_tiled_resident`` (rung 13, ``int8_pretile`` then
  ``int8_tiled_resident_nt``): rung 12 on operands repacked once
  (``pretile``) into the ring slot's exact image, one bulk copy a chunk.

Rungs 12 and 13 take rung 11 (``mmult_q_strip``) when their resident bytes
exceed the L2 budget (``fits_resident``), the reference's rule above its
VMEM budget. The kernels are in ``csrc/int8_dma_nn.cu``, ``csrc/int8_fat.cu``
(09 and 10), ``csrc/int8_strip_nt.cu`` and ``csrc/int8_resident.cu`` (12,
13 and the repack) on ``csrc/manual_dma.cuh``. Each wrapper launches its
kernel for CUDA tensors and runs its plain version (``*_ref``: exact int32
products, then the rank-1 dequant epilogue plus C; ``pretile_ref``) only for
CPU tensors; the kernels equal their plain versions bit for bit.
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
# rungs 12 and 13 stay resident while their bytes fit this much of the L2
# (``int8.l2_budget``: a share of the card's L2; this constant, derived for
# the H100 SXM's 50 MiB, holds where there is no card)
RESIDENT_BUDGET = int(int8.L2_SHARE * int8.L2_BYTES)


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
mmult_q_resident_ref = mmult_q_packed_ref
mmult_q_tiled_resident_ref = mmult_q_packed_ref


def resident_bytes(m: int, n: int, k: int, tiled: bool) -> int:
    """The L2 bytes rungs 12 (``tiled`` False) and 13 keep resident: the
    reference's ``mp * kp + np * kp`` on the card's tiles (rows rounded up
    to BM, K to BK), rung 13's slot images with their rows padded to LDS
    bytes. The reference adds its VMEM tile buffers, which live in shared
    memory here."""
    rows = bounds.round_up(m, BM) + bounds.round_up(n, BM)
    return rows * bounds.round_up(k, BK) * (LDS if tiled else BK) // BK


def fits_resident(m: int, n: int, k: int, *, tiled: bool,
                  budget: int = RESIDENT_BUDGET) -> bool:
    """The reference's route rule (``pallas_manual_dma.py:873-876``,
    ``:1030-1033``) in its L2 form: True while rung 12's (13's) resident
    bytes fit ``budget``; above it the rung takes rung 11."""
    return resident_bytes(m, n, k, tiled) <= budget


def pretile_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``pretile``: (rows, K) int8 -> (ceil(rows / BM),
    ceil(K / BK), BM, LDS), chunk (t, kt) the ring slot's image of rows
    t * BM.. and K bytes kt * BK..: zero-padded to whole tiles and chunks,
    each row padded by LDS - BK zero bytes."""
    rows, k = x.shape
    tiles, nk = -(-rows // BM), -(-k // BK)
    full = torch.nn.functional.pad(x, (0, nk * BK - k, 0, tiles * BM - rows))
    img = full.reshape(tiles, BM, nk, BK).permute(0, 2, 1, 3)
    return torch.nn.functional.pad(img, (0, LDS - BK)).contiguous()


def pretile(x: torch.Tensor) -> torch.Tensor:
    """Rung 13's repack (kernel ``int8_pretile``): ``pretile_ref``'s image
    of a contiguous int8 (rows, K), K a multiple of 16, in fresh scratch."""
    if x.device.type == "cpu":
        return pretile_ref(x)
    int8.require_cuda("pretile", x)
    rows, k = x.shape
    if (x.dtype != torch.int8 or not x.is_contiguous() or k % ALIGN
            or x.data_ptr() % ALIGN):
        raise ValueError(f"pretile: takes a contiguous, 16-byte aligned "
                         f"int8 (rows, K), K a multiple of {ALIGN}")
    tiles, nk = -(-rows // BM), -(-k // BK)
    out = torch.empty((tiles, nk, BM, LDS), dtype=torch.int8,
                      device=x.device)
    if out.numel():
        _build.launch("int8_pretile", x.device, x, out, rows, k, k, tiles,
                      nk)
    return out


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


def _launch(kernel: str, qa, b, sa, sb, c, pad_c: bool, k_ld=None):
    """A fresh output. pad_c: the kernel bulk-copies rows of C and out,
    so both get a row pitch that is a multiple of 16 bytes (C is copied
    only when N is not a multiple of 4) and 16-byte aligned bases. k_ld:
    (K, lda, ldb) when qa and b are not the row-major operands (rung 13's
    images); else qa's width and the row pitches."""
    m, n = c.shape
    if pad_c:
        c = bounds.pad_dim(c, 1, C_ALIGN)
        if c.data_ptr() % 16:
            raise ValueError(f"{kernel}: c not 16-byte aligned")
    out = torch.empty_like(c)
    if m and n:
        k, lda, ldb = k_ld or (qa.shape[1], qa.shape[1], b.shape[1])
        _build.launch(kernel, c.device, qa, b, sa, sb, c, out, m, n, k, lda,
                      ldb, c.shape[1])
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


def mmult_q_resident(qa, sa, qbt, sb, c):
    """Rung 12: rung 10's function with A and B^T kept in the L2, a fresh
    (M, N) float32; rung 11 (``mmult_q_strip``) when the operands do not
    fit the card's budget (``fits_resident``). Operands as
    ``mmult_q_packed``."""
    m, n = c.shape
    if not fits_resident(m, n, qa.shape[1], tiled=False,
                         budget=int8.l2_budget(c.device)):
        return mmult_q_strip(qa, sa, qbt, sb, c)
    if c.device.type == "cpu":
        return mmult_q_resident_ref(qa, sa, qbt, sb, c)
    int8.require_cuda("mmult_q_resident", c)
    qa, qbt = _operands("mmult_q_resident", qa, sa, qbt, sb, c, True)
    return _launch("int8_resident_nt", qa, qbt, sa, sb, c, True)


def mmult_q_tiled_resident(qa, sa, qbt, sb, c):
    """Rung 13: rung 12 on operands repacked once into slot images
    (``pretile``, scratch freed after the call), a fresh (M, N) float32;
    rung 11 above the budget. Operands as ``mmult_q_packed``."""
    m, n = c.shape
    if not fits_resident(m, n, qa.shape[1], tiled=True,
                         budget=int8.l2_budget(c.device)):
        return mmult_q_strip(qa, sa, qbt, sb, c)
    if c.device.type == "cpu":
        return mmult_q_tiled_resident_ref(qa, sa, qbt, sb, c)
    int8.require_cuda("mmult_q_tiled_resident", c)
    qa, qbt = _operands("mmult_q_tiled_resident", qa, sa, qbt, sb, c, True)
    kp = qa.shape[1]
    return _launch("int8_tiled_resident_nt", pretile(qa), pretile(qbt), sa,
                   sb, c, True, (kp, LDS, LDS))


def mmult(a, b, c):
    """Full path (quantize + rung 08) on float32 inputs."""
    qa, sa, qb, sb = int8.prepare(a, b)
    return mmult_q(qa, sa, qb, sb, c)
