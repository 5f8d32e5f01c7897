"""The rung registry: each rung under its stable name.

Counterpart of ``how_to_optimize_gemm_tpu/ops/registry.py``, with its
rungs 01, 01b, 04, 05, 06v, 06, 07, 07b, 14, 15 and 16 under the same
names, gates and byte widths. Each rung carries the timed entry point
``run(*prepared, c)`` (returns ``A@B + C`` in float32), the untimed
``prepare(a, b)`` (cast, quantize and pack), and ``effective(prepared)``:
the float32 operands the kernel actually consumed, which the oracle
multiplies in fp64, so quantization error never masks an indexing bug.

Rungs 07, 07b, 14, 15 and 16 accumulate into ``c`` in place; callers
that need C afterwards keep a copy (``harness/driver.run_sweep`` does).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from how_to_optimize_gemm_tpu_torch.ops import int4, int8, quant, tuned, vendor


@dataclasses.dataclass(frozen=True)
class Rung:
    name: str
    dtype: str                        # operand dtype family
    run: Callable[..., torch.Tensor]  # (*prepared, c) -> fp32 C  (timed)
    prepare: Callable[[torch.Tensor, torch.Tensor], tuple]  # untimed
    effective: Callable[[tuple], tuple]  # prepared -> (a_eff, b_eff) fp32
    gate_rel: float                   # max |C-Cref| / max|Cref| allowed
    doc: str
    bytes_per_input_elt: float = 4.0  # for bandwidth accounting
    # Per-operand byte widths when A and B are stored in different
    # dtypes: in_bytes = m*k*bytes_a + k*n*bytes_b.
    bytes_a: float | None = None
    bytes_b: float | None = None


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
    name="04_pallas_tuned_fp32", dtype="fp32",
    run=tuned.mmult,
    prepare=_identity_prepare, effective=_identity_effective,
    gate_rel=1e-4,
    doc="fp32 at full fp32 accuracy, accumulator seeded with C: "
        "register-blocked FFMA, 128x128 tiles (kernel fp32_gemm_nn)"))

_register(Rung(
    name="05_pallas_bf16", dtype="bf16",
    run=tuned.mmult_bf16,
    prepare=_bf16_prepare, effective=_identity_effective,
    gate_rel=1e-3, bytes_per_input_elt=2.0,
    doc="bf16 operands, fp32 accumulation seeded with C; B (K,N) read "
        "with ldmatrix.trans (kernel bf16_gemm_nn)"))

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
    bytes_a=1.0, bytes_b=0.5,
    doc="W4A8: int8 activations x int4 weights decoded to s8 on their way "
        "into shared memory, int8 tensor-core product, C in place "
        "(kernel w4a8_gemm)"))

_register(Rung(
    name="14_packed_alias_int8", dtype="int8",
    run=int8.mmult_q_bt,
    prepare=int8.prepare_packed, effective=_packed_effective,
    gate_rel=1e-4, bytes_per_input_elt=1.0,
    doc="rung 06 + B packed transposed offline (N,K) + C accumulated in "
        "place (kernel int8_gemm_nt)"))


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
    doc="the fp32 summit: rung 14's recipe at full fp32 accuracy (kernel "
        "fp32_gemm_nt, FFMA)"))

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
