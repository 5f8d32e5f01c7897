"""Port parity: the int8 serving linear without C against the JAX package's.

The same numpy operands go through ``pallas_int8.mmult_q_noc`` (Pallas in
interpret mode, as the JAX package's own tests run it) and the port's
``int8.mmult_q_noc`` on the CPU (its plain version). Tolerance: none, the
outputs must be EQUAL: the int32 sums are exact and both apply
``(float(acc) * sa) * sb`` with each product rounded. Shapes are ragged
(no dimension a tile multiple) on both sides of the reference's m <= 64
decode blocks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.ops import pallas_int8 as jint8
from how_to_optimize_gemm_tpu.ops import quant as jquant
from how_to_optimize_gemm_tpu_torch.ops import int8, quant

torch.set_num_threads(1)


def _operands(m, k, n, seed):
    """x with an all-zero row (the 1e-8 scale floor) and a row of exact
    .5 ties after scaling; both quantized by each package."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if m > 2:
        x[1] = 0.0
        x[2] = np.round(rng.uniform(-120, 120, k)) + 0.5
        x[2, 0] = 127.0
    w = rng.standard_normal((k, n)).astype(np.float32)
    jops = (*jquant.quantize_symmetric(jnp.asarray(x), axis=1),
            *jquant.quantize_symmetric(jnp.asarray(w), axis=0))
    ops = (*quant.quantize_symmetric(torch.from_numpy(x), axis=1),
           *quant.quantize_symmetric(torch.from_numpy(w), axis=0))
    for j, t in zip(jops, ops):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    return jops, ops


@pytest.mark.parametrize("m,k,n", [(1, 40, 9), (5, 72, 136), (64, 300, 200),
                                   (65, 700, 130), (300, 1100, 72)])
def test_noc_equals_jax(m, k, n):
    jops, ops = _operands(m, k, n, m + k + n)
    ref = np.asarray(jint8.mmult_q_noc(*jops, interpret=True))
    out = int8.mmult_q_noc(*ops)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_noc_is_the_k1_epilogue_without_c():
    """mmult_q_noc equals K1's plain version on a zero C: the no-C kernel
    is K1's template with the "+ C" compiled out."""
    _, ops = _operands(70, 96, 48, 1)
    zero = torch.zeros((70, 48))
    assert torch.equal(int8.mmult_q_noc(*ops), int8.mmult_q_ref(*ops, zero))


def test_int_matmul_is_exact_on_the_cpu():
    """The linear's product below the kernel widths is the exact integer
    product (on the CPU always the fp64 one)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(-127, 128, (3, 40), dtype=np.int8))
    y = torch.from_numpy(rng.integers(-127, 128, (40, 24), dtype=np.int8))
    ref = x.to(torch.int64) @ y.to(torch.int64)
    got = int8.int_matmul(x, y)
    assert got.dtype == torch.int32
    assert torch.equal(got.to(torch.int64), ref)


def test_noc_refuses_other_devices():
    """The plain version runs only for CPU tensors; other devices go to the
    kernel or raise (here: no CUDA, meta tensors)."""
    meta = dict(device="meta")
    with pytest.raises(RuntimeError):
        int8.mmult_q_noc(torch.zeros((4, 32), dtype=torch.int8, **meta),
                         torch.zeros((4, 1), **meta),
                         torch.zeros((32, 16), dtype=torch.int8, **meta),
                         torch.zeros((1, 16), **meta))
