"""Port parity: the W4A8 serving linears (no C) against the JAX package's.

The same numpy operands go through ``pallas_int4.mmult_q_w4a8_noc`` and
``mmult_w4a8_fused_noc`` (Pallas in interpret mode, as the JAX package's
own tests run them) and through the port's ``mmult_q_w4a8_noc`` and
``mmult_w4a8_fused_noc`` on the CPU (their plain versions). Tolerance:
none, the outputs must be EQUAL: the integer sums are exact and both
apply ``(float(acc) * sa) * sw`` with each product rounded.

K = 700 is padded to two 512-row pack blocks; the rows of x hold an
all-zero row (the 1e-8 scale floor) and a row of exact .5 ties (scale 1,
rounded half to even).

One disagreement inside the JAX package: under ``jit`` XLA on the CPU
rewrites the scale's ``amax / 127.0`` into ``amax * (1 / 127)``, so the
fused kernel (jitted) and the eager ``quantize_symmetric`` give scales
one ulp apart on some rows. The port divides (IEEE, as the eager
reference does), so its fused linear equals the JAX fused kernel on
every row where the two scales agree, and equals eager
``quantize_symmetric`` + ``mmult_q_w4a8_noc`` on every row.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.ops import pallas_int4 as jint4
from how_to_optimize_gemm_tpu.ops import quant as jquant
from how_to_optimize_gemm_tpu_torch.ops import int4, quant

torch.set_num_threads(1)

K, N = 700, 384


def _x(m, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, K)).astype(np.float32)
    if m > 1:
        x[1] = 0.0
    if m > 2:
        x[2] = np.round(rng.uniform(-120, 120, K)) + 0.5
        x[2, 0] = 127.0
    return x


@pytest.fixture(scope="module")
def weights():
    """(JAX packed, JAX sw, port packed, port sw) of one random W."""
    w = np.random.default_rng(1).standard_normal((K, N)).astype(np.float32)
    _, _, jpacked, jsw, _ = jint4.prepare_w4a8(jnp.zeros((1, K)),
                                               jnp.asarray(w))
    _, _, packed, sw, kdim = int4.prepare_w4a8(torch.zeros((1, K)),
                                               torch.from_numpy(w))
    assert kdim == K and packed.shape == (1024 // 2, N)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    return jpacked, jsw, packed, sw


@pytest.mark.parametrize("m", [1, 5, 64, 100])
def test_noc_equals_jax(weights, m):
    jpacked, jsw, packed, sw = weights
    x = _x(m, m)
    jqa, jsa = jquant.quantize_symmetric(jnp.asarray(x), axis=1)
    ref = np.asarray(jint4.mmult_q_w4a8_noc(jqa, jsa, jpacked, jsw,
                                            interpret=True))
    qa, sa = quant.quantize_symmetric(torch.from_numpy(x), axis=1)
    np.testing.assert_array_equal(qa.numpy(), np.asarray(jqa))
    np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa))
    out = int4.mmult_q_w4a8_noc(qa, sa, packed, sw)
    assert out.dtype == torch.float32 and out.shape == (m, N)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("m", [1, 5, 64])
def test_fused_noc_equals_jax(weights, m):
    jpacked, jsw, packed, sw = weights
    x = _x(m, 10 + m)
    fused = np.asarray(jint4.mmult_w4a8_fused_noc(
        jnp.asarray(x), jpacked, jsw, interpret=True))
    jqa, jsa = jquant.quantize_symmetric(jnp.asarray(x), axis=1)
    eager = np.asarray(jint4.mmult_q_w4a8_noc(jqa, jsa, jpacked, jsw,
                                              interpret=True))
    out = int4.mmult_w4a8_fused_noc(torch.from_numpy(x), packed, sw)
    assert out.shape == (m, N)
    np.testing.assert_array_equal(out.numpy(), eager)
    # rows where XLA's reciprocal form of the scale is not IEEE division
    amax = np.maximum(np.abs(x).max(axis=1), np.float32(1e-8))
    recip = amax * (np.float32(1) / np.float32(127)) != amax / np.float32(127)
    np.testing.assert_array_equal(out.numpy()[~recip], fused[~recip])
    np.testing.assert_allclose(out.numpy()[recip], fused[recip], rtol=3e-7,
                               atol=0)
    # the fused form is quantize + the no-C product, bit for bit
    qa, sa = quant.quantize_symmetric(torch.from_numpy(x), axis=1)
    assert torch.equal(out, int4.mmult_q_w4a8_noc(qa, sa, packed, sw))


def test_fused_noc_refuses_prefill_widths(weights):
    _, _, packed, sw = weights
    with pytest.raises(ValueError):
        int4.mmult_w4a8_fused_noc(torch.zeros((65, K)), packed, sw)


@pytest.mark.parametrize("fn", ["noc", "fused"])
def test_wrappers_refuse_other_devices(weights, fn):
    """The plain versions run only for CPU tensors; other devices go to
    the kernel or raise (here: no CUDA, meta tensors)."""
    meta = dict(device="meta")
    packed = torch.zeros((512, N), dtype=torch.int8, **meta)
    sw = torch.zeros((1, N), **meta)
    with pytest.raises(RuntimeError):
        if fn == "noc":
            int4.mmult_q_w4a8_noc(torch.zeros((4, K), dtype=torch.int8,
                                              **meta),
                                  torch.zeros((4, 1), **meta), packed, sw)
        else:
            int4.mmult_w4a8_fused_noc(torch.zeros((4, K), **meta), packed,
                                      sw)
