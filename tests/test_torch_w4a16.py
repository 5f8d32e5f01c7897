"""Port parity: the W4A16 serving linear and the int8/int4 linear routes
against the JAX package's.

- ``int4.mmult_q_noc`` (the port's plain version on the CPU) against
  ``pallas_int4.mmult_q_noc`` in interpret mode, on the GEMV side
  (m <= 64: the reference's pack-algebra kernel ``_kernel_noc_gemv``) and
  the GEMM side (m > 64: ``_kernel_noc``), with K = 700, which is not a
  multiple of the 512-row pack block. Both compute exact products (bf16 A
  times weights in [-8, 7]) summed in fp32, in other orders:
  tolerance 1e-5 of max |y|.
- ``linear.apply_linear`` for int8 and int4 weights with ``kernels=None``
  (the reference's emulation on the CPU) against the JAX
  ``use_pallas=False``, and with ``kernels=True`` (the kernels' plain
  versions) against ``use_pallas=True`` (the Pallas kernels in interpret
  mode): int8 EQUAL on both routes (exact int32 sums, the same epilogue),
  int4 within 1e-5 of max |y|. m = 300 takes the int8 kernel route
  (m >= 256).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.models import linear as jlinear
from how_to_optimize_gemm_tpu.ops import pallas_int4 as jint4
from how_to_optimize_gemm_tpu_torch import convert
from how_to_optimize_gemm_tpu_torch.models import linear
from how_to_optimize_gemm_tpu_torch.ops import int4

torch.set_num_threads(1)

K, N = 700, 136
REL = 1e-5


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=REL * np.abs(ref).max())


@pytest.fixture(scope="module")
def weights():
    """(JAX packed, JAX sw, port packed, port sw) of one random W: the
    port's pack is the JAX bytes."""
    w = np.random.default_rng(1).standard_normal((K, N)).astype(np.float32)
    jlin = jlinear.make_linear(jnp.asarray(w), "int4")
    lin = linear.make_linear(torch.from_numpy(w), "int4")
    assert lin["int4_packed"].shape == (1024 // 2, N)
    for key in lin:
        ref = convert.params_from_jax(np.asarray(jlin[key]), "cpu")
        assert torch.equal(lin[key], ref), key
    return jlin["int4_packed"], jlin["int4_sw"], lin["int4_packed"], \
        lin["int4_sw"]


@pytest.mark.parametrize("m", [1, 5, 64, 65, 130])
def test_w4a16_noc_equals_jax(weights, m):
    jpacked, jsw, packed, sw = weights
    rng = np.random.default_rng(m)
    a = jnp.asarray(rng.standard_normal((m, K)), jnp.bfloat16)
    ref = np.asarray(jint4.mmult_q_noc(a, jpacked, jsw, interpret=True))
    ta = convert.params_from_jax(np.asarray(a), "cpu")
    out = int4.mmult_q_noc(ta, packed, sw)
    assert out.dtype == torch.float32 and out.shape == (m, N)
    _close(out.numpy(), ref)


def test_w4a16_plain_version_ignores_weight_rows_past_k(weights):
    """A has K columns, the pack Kp rows: rows >= K count as zero, so a
    pack whose padding rows hold nonzero nibbles gives the same y."""
    _, _, packed, sw = weights
    a = torch.randn((3, K), generator=torch.Generator().manual_seed(0))
    a = a.to(torch.bfloat16)
    # pack block 1 (packed rows 256..511) holds K rows 512..767 in its low
    # nibbles and 768..1023 in its high ones; rows 512..699 are live
    dirty = packed.clone()
    dirty[444:] = 0x77
    dirty[256:444] = (packed[256:444] & 0x0F) | 0x70
    assert not torch.equal(dirty, packed)
    assert torch.equal(int4.mmult_q_noc(a, dirty, sw),
                       int4.mmult_q_noc(a, packed, sw))


@pytest.mark.parametrize("m", [3, 65, 300])
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("kernels", [None, True])
def test_apply_linear_routes_match_jax(kind, m, kernels):
    rng = np.random.default_rng(m)
    w = rng.standard_normal((K, N)).astype(np.float32) / 8
    x = rng.standard_normal((m, K)).astype(np.float32)
    jlin = jlinear.make_linear(jnp.asarray(w), kind)
    lin = convert.params_from_jax({k: np.asarray(v) for k, v in jlin.items()},
                                  "cpu")
    ref = np.asarray(jlinear.apply_linear(jlin, jnp.asarray(x),
                                          use_pallas=bool(kernels)))
    got = linear.apply_linear(lin, torch.from_numpy(x), kernels).numpy()
    assert got.dtype == np.float32 and got.shape == (m, N)
    if kind == "int8":
        np.testing.assert_array_equal(got, ref)
    else:
        _close(got, ref)


def test_kernels_false_is_the_default_route_on_the_cpu():
    lin = linear.make_linear(torch.ones((16, 8)), "int4")
    x = torch.ones((2, 16))
    assert torch.equal(linear.apply_linear(lin, x, False),
                       linear.apply_linear(lin, x))


def test_w4a16_noc_refuses_other_devices(weights):
    """The plain version runs only for CPU tensors; other devices go to the
    kernels or raise (here: no CUDA, meta tensors)."""
    meta = dict(device="meta")
    with pytest.raises(RuntimeError):
        int4.mmult_q_noc(torch.zeros((4, K), dtype=torch.bfloat16, **meta),
                         torch.zeros((512, N), dtype=torch.int8, **meta),
                         torch.zeros((1, N), **meta))
