"""The rung registry: each rung under its stable name.

Counterpart of ``how_to_optimize_gemm_tpu/ops/registry.py``, with every
rung of it (00 to 18) under the same names, gates, byte widths and
regression flags. Each rung
carries the timed entry point ``run(*prepared, c)`` (returns ``A@B + C``
in float32), the untimed ``prepare(a, b)`` (cast, quantize and pack), and
``effective(prepared)``: the float32 operands the kernel actually
consumed, which the oracle multiplies in fp64, so quantization error
never masks an indexing bug.

Rungs 07, 07b, 14, 15, 16, 17 and 18 accumulate into ``c`` in place;
callers that need C afterwards keep a copy (``harness/driver.run_sweep``
does).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from how_to_optimize_gemm_tpu_torch.ops import (hand_pipeline, int4, int8,
                                               k_blocked, manual_dma,
                                               mn_tile, naive, quant, tuned,
                                               vendor)


@dataclasses.dataclass(frozen=True)
class Rung:
    name: str
    dtype: str                        # operand dtype family
    run: Callable[..., torch.Tensor]  # (*prepared, c) -> fp32 C  (timed)
    prepare: Callable[[torch.Tensor, torch.Tensor], tuple]  # untimed
    effective: Callable[[tuple], tuple]  # prepared -> (a_eff, b_eff) fp32
    gate_rel: float                   # max |C-Cref| / max|Cref| allowed
    doc: str
    regression: bool = False          # honest negative result, kept
    bytes_per_input_elt: float = 4.0  # for roofline/bandwidth accounting
    # Per-operand byte widths when A and B are stored in different
    # dtypes: in_bytes = m*k*bytes_a + k*n*bytes_b.
    bytes_a: float | None = None
    bytes_b: float | None = None
    # the arithmetic the kernel computes in, for the roofline's ceiling;
    # None = the family of ``dtype`` (harness/profiling.py)
    compute_dtype: str | None = None


def _identity_prepare(a, b):
    return a, b


def _identity_effective(ops):
    return ops[0].to(torch.float32), ops[1].to(torch.float32)


def _bf16_prepare(a, b):
    return a.to(torch.bfloat16), b.to(torch.bfloat16)


def _bf16_bt_effective(ops):
    a16, bt16 = ops
    return a16.to(torch.float32), bt16.t().to(torch.float32)


def _fp32_bt_effective(ops):
    a, bt = ops
    return a, bt.t()


def _int4_effective(ops):
    a16, packed, sw, kdim = ops
    wq = quant.unpack_int4(packed, block_k=int4.PACK_BLOCK)[:kdim]
    return a16.to(torch.float32), quant.dequantize(wq, sw)


def _int8_effective(ops):
    qa, sa, qb, sb = ops
    return quant.dequantize(qa, sa), quant.dequantize(qb, sb)


def _packed_effective(ops):
    qa, sa, qbt, sb = ops
    return quant.dequantize(qa, sa), quant.dequantize(qbt.t(), sb)


def _w4a8_effective(ops):
    qa, sa, packed, sw, kdim = ops
    wq = quant.unpack_int4(packed, block_k=int4.PACK_BLOCK)[:kdim]
    return quant.dequantize(qa, sa), quant.dequantize(wq, sw)


LADDER: dict[str, Rung] = {}


def _register(rung: Rung) -> Rung:
    LADDER[rung.name] = rung
    return rung


_register(Rung(
    name="00_naive_vpu", dtype="fp32",
    run=naive.mmult,
    prepare=_identity_prepare, effective=_identity_effective,
    gate_rel=1e-4,
    doc="naive: one thread per output, its own fmaf chain over K from C, "
        "A and B read from global memory (MMult_cuda_1/2 analogue; "
        "kernel naive_gemm)"))

_register(Rung(
    name="01_xla_fp32", dtype="fp32",
    run=vendor.mmult,
    prepare=_identity_prepare, effective=_identity_effective,
    gate_rel=1e-4,
    doc="fp32 vendor bar: the library's fp32 matmul (cuBLAS, TF32 off) "
        "+ C"))

_register(Rung(
    name="01b_xla_bf16", dtype="bf16",
    run=vendor.mmult_bf16,
    prepare=_bf16_prepare, effective=_identity_effective,
    gate_rel=1e-3, bytes_per_input_elt=2.0,
    doc="bf16 vendor bar: the library's bf16 matmul with fp32 output "
        "(torch.mm out_dtype=float32) + C"))

_register(Rung(
    name="02_pallas_mn_tile", dtype="fp32",
    run=mn_tile.mmult,
    prepare=_identity_prepare, effective=_identity_effective,
    gate_rel=1e-4,
    doc="one 32x32 C tile a block, one output a thread, K tiles of 32 "
        "staged in shared memory, + C at the end (cuda_3; kernel "
        "fp32_gemm_mn_tile)"))

_register(Rung(
    name="03_pallas_k_blocked", dtype="fp32",
    run=k_blocked.mmult,
    prepare=_identity_prepare, effective=_identity_effective,
    gate_rel=1e-4,
    doc="128x128 block, 8x8 register accumulator a thread seeded with C, "
        "K steps of 8 staged by synchronous loads (cuda_9; kernel "
        "fp32_gemm_k_blocked)"))

_register(Rung(
    name="03b_pallas_small_blocks", dtype="fp32",
    run=k_blocked.mmult_small,
    prepare=_identity_prepare, effective=_identity_effective,
    gate_rel=1e-4, regression=True,
    doc="REGRESSION (kept honestly, like cuda_6/4x4_15/vk_3): rung 03 at "
        "half the block edge (64x64, kernel fp32_gemm_k_blocked): more "
        "blocks, half the reuse of each staged tile. On an NVIDIA H100 "
        "80GB HBM3 at 700 W (chip_smoke.py) slower than 03 at p=2048 and "
        "4096 (19,962 and 27,686 vs 32,516 and 34,413 GFLOPS), faster at "
        "1024 (16,603 vs 12,517), where 03's 64 blocks leave SMs idle"))

_register(Rung(
    name="04_pallas_tuned_fp32", dtype="fp32",
    run=tuned.mmult,
    prepare=_identity_prepare, effective=_identity_effective,
    gate_rel=1e-4,
    doc="fp32 operands at bf16x3 precision (XLA's HIGH, within 1e-5 of "
        "the fp32 product; the reference's HIGHEST is six bf16 passes), "
        "sums seeded with C: A and B split into bf16 hi + lo and hi.hi + "
        "hi.lo + lo.hi on rung 15's wgmma kernel with B read N-major "
        "(kernels split_bf16, fp32_gemm_nn)"))

_register(Rung(
    name="05_pallas_bf16", dtype="bf16",
    run=tuned.mmult_bf16,
    prepare=_bf16_prepare, effective=_identity_effective,
    gate_rel=1e-3, bytes_per_input_elt=2.0,
    doc="bf16 operands, fp32 accumulation seeded with C; rung 15's "
        "persistent wgmma kernel with B (K,N) read N-major by tensor map "
        "(kernel bf16_gemm_nn)"))

_register(Rung(
    name="06v_xla_int8", dtype="int8",
    run=vendor.mmult_int8,
    prepare=int8.prepare, effective=_int8_effective,
    gate_rel=1e-4, bytes_per_input_elt=1.0,
    doc="int8 vendor bar: the library's int8 matmul (torch._int_mm) + "
        "dequant, the line the hand kernels are measured against"))

_register(Rung(
    name="06_pallas_int8", dtype="int8",
    run=int8.mmult_q,
    prepare=int8.prepare, effective=_int8_effective,
    gate_rel=1e-4, bytes_per_input_elt=1.0,
    doc="int8 symmetric [-127,127], int32 acc, fused rank-1 dequant; "
        "B (K,N) transposed into shared memory (kernel int8_gemm_nn)"))

_register(Rung(
    name="07b_pallas_w4a8", dtype="int4",
    run=lambda qa, sa, packed, sw, kdim, c: int4.mmult_q_w4a8(
        qa, sa, packed, sw, c),
    prepare=int4.prepare_w4a8, effective=_w4a8_effective,
    gate_rel=1e-4, bytes_per_input_elt=0.75,
    bytes_a=1.0, bytes_b=0.5, compute_dtype="int8",
    doc="W4A8: int8 activations x int4 weights decoded to s8 on their way "
        "into shared memory, int8 tensor-core product, C in place "
        "(kernel w4a8_gemm)"))

_register(Rung(
    name="08_manual_dma_int8", dtype="int8",
    run=manual_dma.mmult_q,
    prepare=int8.prepare, effective=_int8_effective,
    gate_rel=1e-4, bytes_per_input_elt=1.0,
    doc="rung 06's tile on a hand-built K-loop ring: two shared-memory "
        "slots tracked per slot by mbarriers (cp.async arrivals, "
        "try_wait.parity), chunk t+1 issued before chunk t is waited on, "
        "no block barrier in the K loop (kernel int8_dma_nn). On an NVIDIA "
        "H100 80GB HBM3 at 700 W (harness/ab.py, 5 rounds) it beats 06 "
        "every round: 242.4k and 308.0k GFLOPS at p=2048 and 4096 against "
        "228.2k and 284.8k"))

_register(Rung(
    name="09_fat_tile_int8", dtype="int8",
    run=manual_dma.mmult_q_fat,
    prepare=int8.prepare, effective=_int8_effective,
    gate_rel=1e-4, bytes_per_input_elt=1.0,
    doc="the largest C tile a block holds (128x256: 227 KB of shared "
        "memory, 255 registers), persistent; C bulk-copied in at each "
        "tile's start and awaited at the flush, the output staged in the "
        "same buffer and bulk-copied out during the next tile's K loop "
        "(kernel int8_fat_nn). On an NVIDIA H100 80GB HBM3 at 700 W "
        "(harness/ab.py) it beats 08 every round: 269.1k and 318.9k GFLOPS "
        "at p=2048 and 4096 against 240.9k and 309.9k"))

_register(Rung(
    name="10_packed_fat_int8", dtype="int8",
    run=manual_dma.mmult_q_packed,
    prepare=int8.prepare_packed, effective=_packed_effective,
    gate_rel=1e-4, bytes_per_input_elt=1.0,
    doc="rung 09 on B packed transposed offline (N,K): both operands "
        "K-major into shared memory as they are, and two C/out buffers "
        "(the accumulator ping-pong), which cap the tile at 128x128 "
        "(kernel int8_fat_nt). A LOSS on Hopper (kept, like 03b): on an "
        "NVIDIA H100 80GB HBM3 at 700 W (harness/ab.py) it loses every "
        "round to 09 (228.0k and 273.9k GFLOPS at p=2048 and 4096 against "
        "269.4k and 320.0k) and to 14 (245.8k and 340.4k): the second "
        "buffer costs the fat tile, and the tile's reuse is what pays"))

_register(Rung(
    name="11_strip_resident_int8", dtype="int8",
    run=manual_dma.mmult_q_strip,
    prepare=int8.prepare_packed, effective=_packed_effective,
    gate_rel=1e-4, bytes_per_input_elt=1.0,
    doc="rung 10 + the A strip's reuse: a cluster of 4 blocks along N "
        "multicasts each A chunk to all of them, so A is read once per "
        "cluster, not once per tile (kernel int8_strip_nt). A LOSS on "
        "Hopper (kept): on an NVIDIA H100 80GB HBM3 at 700 W "
        "(harness/ab.py) it loses every round to 10, 67.7k and 95.9k GFLOPS "
        "at p=2048 and 4096 against 227.7k and 274.4k: a slot is refilled "
        "only when all 32 warps of the cluster have released it, and A "
        "comes as one-row 64-byte bulk copies; the A bytes it saves never "
        "bound an MMA-bound kernel"))

_register(Rung(
    name="12_resident_int8", dtype="int8",
    run=manual_dma.mmult_q_resident,
    prepare=int8.prepare_packed, effective=_packed_effective,
    gate_rel=1e-4, bytes_per_input_elt=1.0, regression=True,
    doc="REGRESSION (kept, as the reference keeps it): rung 10's walk with "
        "A and B^T held in the L2, the card's on-chip store of their size "
        "(a block's 227 KB holds no 16 MB operand): prefetched once, every "
        "chunk under evict_last, C and out under evict_first (kernel "
        "int8_resident_nt); rung 11 when the operands exceed the L2 "
        "budget. On an NVIDIA H100 80GB HBM3 at 700 W (harness/ab.py, 5 "
        "rounds) it beats 11 every round, 233.3k and 278.0k GFLOPS at "
        "p=2048 and 4096 against 67.5k and 96.0k, but is rung 10's speed "
        "(0.508 against 0.511 ms at 4096, chip_smoke.py) and loses to 14: "
        "an MMA-issue-bound kernel gains nothing from bytes kept on chip"))

_register(Rung(
    name="13_tiled_resident_int8", dtype="int8",
    run=manual_dma.mmult_q_tiled_resident,
    prepare=int8.prepare_packed, effective=_packed_effective,
    gate_rel=1e-4, bytes_per_input_elt=1.0,
    doc="REGRESSION (kept; the flag unset, as in the reference): rung 12 on "
        "operands repacked once into the ring slot's exact image (kernels "
        "int8_pretile, int8_tiled_resident_nt), one 10 KB bulk copy a "
        "chunk. On an NVIDIA H100 80GB HBM3 at 700 W (harness/ab.py, 5 "
        "rounds) it beats 12 every round at p=4096 (286.0k against 277.7k "
        "GFLOPS) and loses every round at 2048 (143.4k against 229.9k: "
        "three launches and two scratch allocations a call), and loses "
        "to 14 at both"))

_register(Rung(
    name="14_packed_alias_int8", dtype="int8",
    run=int8.mmult_q_bt,
    prepare=int8.prepare_packed, effective=_packed_effective,
    gate_rel=1e-4, bytes_per_input_elt=1.0,
    doc="rung 06 + B packed transposed offline (N,K) + C accumulated in "
        "place (kernel int8_gemm_nt)"))


_register(Rung(
    name="17_hand_pipeline_int8", dtype="int8",
    run=hand_pipeline.mmult_q_bt_hand,
    prepare=int8.prepare_packed, effective=_packed_effective,
    gate_rel=1e-4, bytes_per_input_elt=1.0, regression=True,
    doc="REGRESSION (kept): rung 14's tile math under a hand stream "
        "schedule: one producer warp keeps a ring of 3 chunk slots full "
        "for 8 MMA warps, persistent, the next tile's copies issued ahead "
        "(kernel int8_hand_pipe_nt; b_buffers 2-4, a_lookahead). On an "
        "NVIDIA H100 80GB HBM3 at 700 W (harness/ab.py, 5 rounds) it loses "
        "every round to 14 in every knob: 168.5k and 213.6k GFLOPS at "
        "p=2048 and 4096 against 249.5k and 337.9k, the best knob "
        "(b_buffers=4) 169.4k and 214.9k: one block an SM, 8 MMA warps "
        "against 14's 16"))

_register(Rung(
    name="18_ragged_m_int8", dtype="int8",
    run=int8.mmult_q_bt_ragged,
    prepare=int8.prepare_packed, effective=_packed_effective,
    gate_rel=1e-4, bytes_per_input_elt=1.0, regression=True,
    doc="REGRESSION in the reference (its flag kept): rung 14's tile "
        "walked over a ragged-M strip plan (a tall head and one shorter "
        "tail, no padding, one B^T read a strip) in one persistent launch, "
        "N-major within a strip (kernel int8_ragged_nt). On an NVIDIA H100 "
        "80GB HBM3 at 700 W (harness/ab.py, 5 rounds) a tie with 14: 0-5-0 "
        "at p=2048 (249.9k against 249.4k GFLOPS) and 3-2-0 at 4096 (337.1k "
        "against 335.3k), with the plan memoized; computed afresh each "
        "call it lost 0-0-5 at 2048 to the host"))

_register(Rung(
    name="15_packed_alias_bf16", dtype="bf16",
    run=tuned.mmult_bf16_bt,
    prepare=tuned.prepare_bf16_bt, effective=_bf16_bt_effective,
    gate_rel=1e-3, bytes_per_input_elt=2.0,
    doc="the bf16 summit: rung 14's recipe (B packed transposed offline "
        "(N,K) + C accumulated in place) on bf16 operands (kernel "
        "bf16_gemm_nt)"))

_register(Rung(
    name="16_packed_alias_fp32", dtype="fp32",
    run=tuned.mmult_fp32_bt,
    prepare=tuned.prepare_fp32_bt, effective=_fp32_bt_effective,
    gate_rel=1e-4,
    doc="the fp32 summit: rung 14's recipe on fp32 operands at bf16x3 "
        "precision (XLA's HIGH, within 1e-5 of the fp32 product; the "
        "reference's HIGHEST is six bf16 passes), A and BT split into "
        "bf16 hi + lo and hi.hi + hi.lo + lo.hi on rung 15's wgmma "
        "kernel (kernels split_bf16, fp32_gemm_nt)"))

_register(Rung(
    name="07_pallas_int4", dtype="int4",
    run=lambda a16, packed, sw, kdim, c: int4.mmult_q(a16, packed, sw, c),
    prepare=int4.prepare, effective=_int4_effective,
    gate_rel=1e-3, bytes_per_input_elt=1.25,
    bytes_a=2.0, bytes_b=0.5,
    doc="W4A16: bf16 activations x int4 weights decoded to bf16 on their "
        "way into shared memory, fp32 sums, * sw + C in place (kernel "
        "w4a16_gemm)"))


def get(name: str) -> Rung:
    if name not in LADDER:
        raise KeyError(
            f"unknown rung {name!r}; available: {sorted(LADDER)}")
    return LADDER[name]


def names() -> list[str]:
    return sorted(LADDER)
