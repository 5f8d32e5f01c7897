"""Quantizable linear layers: the bridge from the GEMM kernels to the model.

Counterpart: ``how_to_optimize_gemm_tpu/models/linear.py``
(``make_linear``, ``linear_kind``, ``apply_linear``). W is (d_in, d_out)
and y = x @ W in fp32. A linear is a plain dict whose key names carry its
kind, as in the reference: ``{"fp32_w"}``, ``{"bf16_w"}``,
``{"int8_qw", "int8_sw"}``, ``{"int4_packed", "int4_sw", "int4_kdim"}``,
``{"w4a8_packed", "w4a8_sw", "w4a8_kdim"}``.

Routes of ``apply_linear`` (m = rows of x). ``kernels`` is the
counterpart of the reference's ``use_pallas``: None takes the kernel
routes on the card and the reference's off-TPU emulation on the CPU;
True on the CPU takes the kernel routes through the kernels' plain
versions (``utils/device.kernel_routes_for``).

- fp32: ``vendor.fp32_matmul``: TF32 off for the product only, as the
  reference's fp32 dot carries its precision per call.
- bf16: the operands rounded to bf16, then an fp32 ``fp32_matmul`` (the
  reference's ``preferred_element_type=float32``).
- int8: rows of x quantized; on the kernel routes at m >= 256
  ``int8.mmult_q_noc`` (kernel ``int8_gemm_noc``); otherwise an exact
  integer product (``int8.int_matmul``: the library's int8 product on
  the card, as the reference runs XLA's int8 dot there) and the dequant
  epilogue.
- int4 (W4A16): on the kernel routes ``int4.mmult_q_noc`` at every m on
  bf16 x (kernel ``w4a16_gemv`` at m <= 64, ``w4a16_gemm_noc`` above);
  otherwise W dequantized to bf16, then an fp32 product (the reference's
  emulation).
- w4a8: m <= 64 through ``mmult_w4a8_fused_noc`` (kernel
  ``w4a8_gemv_fq``), else the rows quantized and ``mmult_q_w4a8_noc``
  (kernel ``w4a8_gemm_noc``); on the CPU their plain versions, which are
  the reference's emulation bit for bit.
"""
from __future__ import annotations

import torch

from how_to_optimize_gemm_tpu_torch.ops import bounds, int4, int8, quant
from how_to_optimize_gemm_tpu_torch.ops.vendor import fp32_matmul
from how_to_optimize_gemm_tpu_torch.utils.device import kernel_routes_for

INT4_BLOCK_K = int4.PACK_BLOCK
KINDS = ("fp32", "bf16", "int8", "int4", "w4a8")
# the kinds with kernel routes (fp32 and bf16 have one route everywhere)
QUANTIZED_KINDS = ("int8", "int4", "w4a8")
# the reference's routing threshold (models/linear.py:90); the w4a8 one
# (:119) is int4.GEMV_MAX_M
INT8_KERNEL_MIN_M = 256


def make_linear(w: torch.Tensor, kind: str = "bf16") -> dict:
    """A dense (d_in, d_out) fp32 weight in format ``kind``."""
    if kind == "fp32":
        return {"fp32_w": w.to(torch.float32)}
    if kind == "bf16":
        return {"bf16_w": w.to(torch.bfloat16)}
    if kind == "int8":
        qw, sw = quant.quantize_symmetric(w, axis=0)
        return {"int8_qw": qw, "int8_sw": sw}
    if kind in ("int4", "w4a8"):
        kdim = w.shape[0]
        wp = bounds.pad_dim(w, 0, INT4_BLOCK_K)
        qw, sw = quant.quantize_symmetric(wp, axis=0, bits=4)
        packed = quant.pack_int4(qw, INT4_BLOCK_K)
        return {f"{kind}_packed": packed, f"{kind}_sw": sw,
                f"{kind}_kdim": torch.tensor(kdim, dtype=torch.int32,
                                             device=w.device)}
    raise ValueError(f"unknown linear kind {kind!r}")


def linear_kind(lin: dict) -> str:
    for k in lin:
        return k.split("_")[0]
    raise ValueError("empty linear")


def apply_linear(lin: dict, x: torch.Tensor, kernels=None) -> torch.Tensor:
    """y = x @ dequant(W): x (..., d_in) of any float dtype, y fp32.

    kernels: see the module docstring (False on the card raises for the
    quantized kinds; fp32 and bf16 have one route on every device)."""
    kind = linear_kind(lin)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    m = x2.shape[0]
    if kind in QUANTIZED_KINDS:
        kernels = kernel_routes_for(x2, kernels)
    if kind == "fp32":
        y = fp32_matmul(x2.to(torch.float32), lin["fp32_w"])
    elif kind == "bf16":
        y = fp32_matmul(x2.to(torch.bfloat16).to(torch.float32),
                         lin["bf16_w"].to(torch.float32))
    elif kind == "int8":
        qa, sa = quant.quantize_symmetric(x2.to(torch.float32), axis=1)
        if kernels and m >= INT8_KERNEL_MIN_M:
            y = int8.mmult_q_noc(qa, sa, lin["int8_qw"], lin["int8_sw"])
        else:
            acc = int8.int_matmul(qa, lin["int8_qw"])
            y = acc.to(torch.float32) * sa * lin["int8_sw"]
    elif kind == "int4":
        if kernels:
            y = int4.mmult_q_noc(x2.to(torch.bfloat16), lin["int4_packed"],
                                 lin["int4_sw"])
        else:
            wq = quant.unpack_int4(lin["int4_packed"], INT4_BLOCK_K)
            w = (wq.to(torch.float32) * lin["int4_sw"]).to(torch.bfloat16)
            y = fp32_matmul(x2.to(torch.bfloat16).to(torch.float32),
                             w[:x2.shape[-1]].to(torch.float32))
    elif kind == "w4a8":
        if m <= int4.GEMV_MAX_M:
            y = int4.mmult_w4a8_fused_noc(x2.to(torch.float32),
                                          lin["w4a8_packed"],
                                          lin["w4a8_sw"])
        else:
            qa, sa = quant.quantize_symmetric(x2.to(torch.float32), axis=1)
            y = int4.mmult_q_w4a8_noc(qa, sa, lin["w4a8_packed"],
                                      lin["w4a8_sw"])
    else:
        raise ValueError(kind)
    return y.reshape(*lead, y.shape[-1])
