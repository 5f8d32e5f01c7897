"""Rungs 03 and 03b: K blocking with a register accumulator seeded with C.

Counterpart of ``how_to_optimize_gemm_tpu/ops/pallas_k_blocked.py``
(``mmult``, kernel ``_kernel``): a (M/bm, N/bn, K/bk) grid, K innermost,
an fp32 VMEM scratch accumulator set to C at the first K step and flushed
at the last; 256-cubed blocks for rung 03, 128-cubed for 03b (the
reference's documented regression). ``mmult`` launches
``csrc/fp32_gemm_k_blocked.cu``: one BLOCK x BLOCK C tile a block, K
pipelined in steps of 32 through a ``cp.async`` ring of fp32 stages, A
and B split inside the kernel into bf16 hi + lo and multiplied by
``mma.sync`` as three bf16 products (bf16x3, XLA's Precision.HIGH,
within FP32_REL of the fp32 product), the sums seeded with C and the
tensor cores' partials added in every 128 K. ``BLOCK`` is 128 for rung
03 and ``SMALL_BLOCK`` (64, half the edge) for 03b.

The wrapper launches its kernel for CUDA tensors and runs its plain
version (``k_blocked_ref``) only for CPU tensors.
"""
from __future__ import annotations

import torch

from how_to_optimize_gemm_tpu_torch.ops.int8 import require_cuda
from how_to_optimize_gemm_tpu_torch.ops.tuned import launch_gemm
from how_to_optimize_gemm_tpu_torch.ops.vendor import fp32_matmul

BLOCK = 128
SMALL_BLOCK = 64


def k_blocked_ref(a, b, c):
    """Plain version of rungs 03 and 03b: ``C + A @ B`` in fp32, a fresh
    output."""
    return c + fp32_matmul(a, b)


def mmult(a, b, c, block: int = BLOCK):
    """Rung 03 (``block`` 128) or 03b (64): ``C' = C + A @ B`` in fp32, a
    fresh (M, N) output (kernel ``fp32_gemm_k_blocked``); ``c`` is not
    modified."""
    if block not in (BLOCK, SMALL_BLOCK):
        raise ValueError(f"k_blocked.mmult: block {block} is neither "
                         f"{BLOCK} nor {SMALL_BLOCK}")
    if c.device.type == "cpu":
        return k_blocked_ref(a, b, c)
    require_cuda("k_blocked.mmult", c)
    return launch_gemm("k_blocked.mmult", "fp32_gemm_k_blocked", a, b, c,
                       torch.empty_like(c), torch.float32, bt=False,
                       extra=(block,))


def mmult_small(a, b, c):
    """Rung 03b: ``mmult`` at half the block edge."""
    return mmult(a, b, c, block=SMALL_BLOCK)
