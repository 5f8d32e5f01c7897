"""Rung 02, one C tile a block: the ladder's first tiled kernel.

Counterpart of ``how_to_optimize_gemm_tpu/ops/pallas_mn_tile.py``
(``mmult``, kernel ``_kernel``): a (M/128, N/128) grid, one (128, 128) C
tile per program from full-K strips of A and B in VMEM, one dot at
Precision.HIGHEST on the MXU, then + C. ``mmult`` launches
``csrc/fp32_gemm_mn_tile.cu``: one 128 x 128 C tile a block of 8 warps,
K walked in steps of 32 (a full-K strip does not fit a Hopper block's
shared memory) by synchronous loads, A and B split inside the kernel
into bf16 hi + lo and multiplied by ``mma.sync`` as three bf16 products
(bf16x3, XLA's Precision.HIGH, within FP32_REL of the fp32 product),
nothing overlapped. The sums start at 0 and C is added once at the end,
the reference's order. The wrapper zero-pads K and B's rows to 16-byte
multiples (exact: zeros add nothing).

The wrapper launches its kernel for CUDA tensors and runs its plain
version (``mn_tile_ref``) only for CPU tensors.
"""
from __future__ import annotations

import torch

from how_to_optimize_gemm_tpu_torch.ops.int8 import require_cuda
from how_to_optimize_gemm_tpu_torch.ops.tuned import launch_gemm
from how_to_optimize_gemm_tpu_torch.ops.vendor import fp32_matmul


def mn_tile_ref(a, b, c):
    """Plain version of rung 02: ``A @ B + C`` in fp32, a fresh output."""
    return fp32_matmul(a, b) + c


def mmult(a, b, c):
    """Rung 02: ``C' = A @ B + C`` in fp32, a fresh (M, N) output (kernel
    ``fp32_gemm_mn_tile``); ``c`` is not modified."""
    if c.device.type == "cpu":
        return mn_tile_ref(a, b, c)
    require_cuda("mn_tile.mmult", c)
    return launch_gemm("mn_tile.mmult", "fp32_gemm_mn_tile", a, b, c,
                       torch.empty_like(c), torch.float32, bt=False)
