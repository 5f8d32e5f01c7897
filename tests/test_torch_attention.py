"""Port parity: flash attention against the JAX package's.

The same numpy q, k and v (rounded to bf16) go through
``pallas_attention.flash_attention`` (Pallas in interpret mode) and the
port's ``flash_attention`` on the CPU (its plain version), at the same key
block: the reference's default (min(512, round_up(T, 128))), 64, and the
card kernel's tiles (``attention.KERNEL_BQ`` queries by
``attention.KERNEL_BK`` keys; the key tile sets where p rounds to bf16). Shapes (B, H, KVH, S, T, D): MHA and GQA (rep 2 and 4),
D 64 and 128, S and T that are no block multiple, queries that are the
last 37 of 300 positions, each causal and not; and T = 8300 > 8192, the
reference's multi-strip case.

Tolerance: one bf16 ulp an element, |port - jax| <= ulp(jax) + 1e-6 with
ulp(x) = 2 ** (floor(log2 |x|) - 7), the spacing of bf16 at x (2**-8 * |x|
is only half of it at the bottom of each binade). Both walk the same key
blocks with the same fp32 online softmax and round p and the output to
bf16; their fp32 dot products sum in another order, which can move a value
across a bf16 rounding boundary: up to 7 of 131,072 outputs differ here,
by one ulp, or by less than 1e-8 at outputs near 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.ops import pallas_attention as jattn
from how_to_optimize_gemm_tpu_torch import _build, convert
from how_to_optimize_gemm_tpu_torch.ops import attention

torch.set_num_threads(1)

SHAPES = [(1, 4, 2, 64, 64, 64), (2, 4, 4, 100, 100, 128),
          (1, 8, 2, 128, 128, 128), (1, 2, 1, 37, 300, 64)]


def _inputs(b, h, kvh, s, t, d, seed):
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.standard_normal((b, h, s, d)), jnp.bfloat16)
    k, v = (jnp.asarray(rng.standard_normal((b, kvh, t, d)), jnp.bfloat16)
            for _ in "kv")
    return q, k, v


def _torch(x):
    return convert.params_from_jax(np.asarray(x), "cpu")


def _assert_within_one_ulp(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float32)
    diff = np.abs(got.float().numpy() - ref)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(diff <= ulp + 1e-6), float(diff.max())
    return float(diff.max())


@pytest.mark.parametrize("block", [
    None, 64, (attention.KERNEL_BQ, attention.KERNEL_BK)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_attention_matches_jax(shape, causal, block):
    """block: one block for queries and keys, or (bq, bk)."""
    bq, bk = block if isinstance(block, tuple) else (block, block)
    q, k, v = _inputs(*shape, seed=sum(shape))
    ref = jattn.flash_attention(q, k, v, causal=causal, bq=bq, bk=bk,
                                interpret=True)
    got = attention.flash_attention(_torch(q), _torch(k), _torch(v),
                                    causal=causal, bq=bq, bk=bk)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    print(f"{shape} causal={causal} block={block}: max |port - jax| = "
          f"{_assert_within_one_ulp(got, ref):.3e}")


def test_multi_strip_long_context_matches_jax():
    """T = 8300: the reference streams K/V in two strips of 8192 keys and
    carries its softmax state across them; the port walks one loop."""
    q, k, v = _inputs(1, 2, 2, 16, 8300, 64, seed=5)
    ref = jattn.flash_attention(q, k, v, causal=False, interpret=True)
    got = attention.flash_attention(_torch(q), _torch(k), _torch(v),
                                    causal=False)
    _assert_within_one_ulp(got, ref)


def test_default_block_follows_the_reference():
    assert attention.default_block(4096) == 512
    assert attention.default_block(300) == 384
    assert attention.default_block(64) == 128


@pytest.mark.parametrize("pack_heads", [False, True])
def test_mha_flash_matches_jax(pack_heads):
    """The model layout, q (B, S, H, D) float32 rounded to bf16 by the
    wrapper, k, v (B, T, KVH, D) bf16 -> (B, S, H * D) float32; d 64 and
    an even KVH, so pack_heads=True takes the head-packed view."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 100, 4, 64)).astype(np.float32)
    k, v = (jnp.asarray(rng.standard_normal((2, 100, 2, 64)), jnp.bfloat16)
            for _ in "kv")
    ref = jattn.mha_flash(jnp.asarray(q), k, v, causal=True,
                          pack_heads=pack_heads, interpret=True)
    got = attention.mha_flash(torch.from_numpy(q), _torch(k), _torch(v),
                              causal=True, pack_heads=pack_heads)
    assert got.shape == (2, 100, 256) and got.dtype == torch.float32
    _assert_within_one_ulp(got, ref)


@pytest.mark.parametrize("causal", [True, False])
def test_row_ulp_rule_passes_another_block_and_refuses_a_skipped_tile(
        causal):
    """The card's check (attention.bf16_row_ulps <= 2): the plain version
    at key blocks of 128 against 64 reads 1 ulp here (sums in another
    order flip a rounding); with one 64-key tile of 512 keys dropped the
    last 64 rows read over 100 ulps."""
    q, k, v = (_torch(x) for x in _inputs(1, 4, 2, 256, 512, 128, seed=13))
    ref = attention.flash_attention_ref(q, k, v, causal=causal, bk=64)
    other = attention.flash_attention_ref(q, k, v, causal=causal, bk=128)
    assert float(attention.bf16_row_ulps(other, ref).max()) <= 2
    keep = torch.cat([torch.arange(128), torch.arange(192, 512)])
    faulty = attention.flash_attention_ref(
        q[:, :, -64:], k[:, :, keep], v[:, :, keep], causal=causal, bk=64)
    assert float(attention.bf16_row_ulps(faulty, ref[:, :, -64:]).min()) > 2


def test_packed_view_equals_plain_view():
    """The head-packed view computes the same function: its zero band
    cancels the other head's scores exactly."""
    q, k, v = (_torch(x) for x in _inputs(1, 4, 2, 70, 90, 64, seed=11))
    plain = attention.flash_attention(q, k, v, causal=True)
    packed = attention.flash_attention_packed(q, k, v, causal=True)
    assert torch.equal(plain, packed)


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    q, k, v = (_torch(x) for x in _inputs(1, 2, 1, 20, 50, 128, seed=3))
    before = dict(_build.LAUNCHES)
    got = attention.flash_attention(q, k, v)
    assert _build.LAUNCHES == before            # no kernel launch counted
    assert torch.equal(got, attention.flash_attention_ref(q, k, v))
    # the model's layout: transposed views of (B, S, H, D) tensors
    qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    assert torch.equal(attention.flash_attention(qt, kt, vt), got)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = (_torch(x) for x in _inputs(1, 2, 1, 20, 50, 64, seed=4))
    q96 = torch.zeros((1, 2, 20, 96), dtype=torch.bfloat16)
    k96 = torch.zeros((1, 1, 50, 96), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="d in"):
        attention.flash_attention(q96, k96, k96)
    with pytest.raises(ValueError, match="S=50 > T=20"):
        attention.flash_attention(k.expand(1, 2, 50, 64).contiguous(),
                                  q[:, :1], q[:, :1], causal=True)
    with pytest.raises(TypeError):
        attention.flash_attention(q.float(), k, v)
    with pytest.raises(ValueError):
        attention.flash_attention(q, k, v[:, :, :40])
    wide = torch.zeros((1, 2, 20, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_attention(wide[..., ::2], k, v)
    # off the CPU the kernel's tiles are fixed: KERNEL_BQ queries by
    # KERNEL_BK keys (meta tensors reach the check without a card)
    qm, km = (x.to("meta") for x in (q, k))
    for tiles in ({"bq": attention.KERNEL_BQ // 2},
                  {"bk": attention.KERNEL_BK // 2},
                  {"bq": attention.KERNEL_BQ, "bk": 512}):
        with pytest.raises(ValueError, match="tiles"):
            attention.flash_attention(qm, km, km, **tiles)
    with pytest.raises(RuntimeError, match="CUDA"):   # then the device
        attention.flash_attention(qm, km, km, bq=attention.KERNEL_BQ,
                                  bk=attention.KERNEL_BK)
    # not causal, S > T is a plain cross-attention
    out = attention.flash_attention(k.expand(1, 2, 50, 64).contiguous(),
                                    q[:, :1], q[:, :1], causal=False)
    assert out.shape == (1, 2, 50, 64)


def test_wrapper_refuses_other_devices():
    x = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError):
        attention.flash_attention(x, x, x)
