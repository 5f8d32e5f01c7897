"""Port parity: length-aware decode attention against the JAX package's.

The same numpy q and bf16 caches go through
``pallas_decode_attention.decode_attention`` (Pallas in interpret mode)
and the port's ``decode_attention`` on the CPU (its plain version), at a
fused-head (v4) width, kvh=2 rep=2 d=128, and a per-slot (v3) width,
kvh=16 d=128, with T=256, bk=128 and lengths {1, 129, 256}.

Tolerance: both walk the same chunks with an fp32 online softmax; they
differ in summation order and in exp, and a p that lands on a bf16
rounding boundary can round the other way before the PV product (one
such flip moves an output by about p * |v| * 2^-8; the largest
difference seen here is 7.6e-5, at the v3 width). The JAX package holds
this kernel to atol 3e-2 (``tests/test_decode_attention.py``); the port
is held to 5e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.ops import pallas_decode_attention as jda
from how_to_optimize_gemm_tpu_torch import convert
from how_to_optimize_gemm_tpu_torch.models import llama
from how_to_optimize_gemm_tpu_torch.ops import decode_attention as da

torch.set_num_threads(1)

T, D, BK = 256, 128, 128
LENGTHS = [1, 129, 256]
ATOL = 5e-4


def _inputs(kvh, rep, seed):
    rng = np.random.default_rng(seed)
    b = len(LENGTHS)
    q = rng.standard_normal((b, kvh * rep, D)).astype(np.float32)
    k, v = (jnp.asarray(rng.standard_normal((b, T, kvh, D)), jnp.bfloat16)
            for _ in "kv")
    return q, k, v


@pytest.mark.parametrize("kvh,rep", [(2, 2), (16, 1)])
def test_decode_attention_matches_jax(kvh, rep):
    q, k, v = _inputs(kvh, rep, kvh)
    lengths = np.asarray(LENGTHS, np.int32)
    ref = np.asarray(jda.decode_attention(jnp.asarray(q), k, v,
                                          jnp.asarray(lengths), bk=BK,
                                          interpret=True))
    tk, tv = (convert.params_from_jax(np.asarray(x), "cpu") for x in (k, v))
    got = da.decode_attention(torch.from_numpy(q), tk, tv,
                              torch.from_numpy(lengths), bk=BK)
    assert got.shape == (len(LENGTHS), kvh * rep * D)
    assert got.dtype == torch.float32
    err = float(np.max(np.abs(got.numpy() - ref)))
    print(f"kvh={kvh} rep={rep}: max |port - jax| = {err:.3e}")
    assert err < ATOL, err


def test_block_choice_follows_the_reference():
    """The reference wrapper's chunk: bk capped by its 6 MB budget for
    two ping-pong chunks of K and V, then the largest 128-multiple that
    divides T."""
    assert da.pick_block(4096, 32, 128, 2) == 128        # Llama-2-7B
    assert da.pick_block(4096, 8, 128, 2) == 512         # GQA kvh=8
    assert da.pick_block(256, 2, 128, 2, bk=128) == 128
    assert da.pick_block(2048, 4, 64, 2, bk=384) == 256  # 384 does not divide
    assert da.pick_block(100, 2, 64, 2) == 100           # no 128-multiple


def test_matches_eager_masked_attention():
    """The chunk walk computes the eager masked attention the model runs
    on the CPU (``llama._attention``), to the JAX test's atol 3e-2."""
    q, k, v = _inputs(2, 2, 3)
    tk, tv = (convert.params_from_jax(np.asarray(x), "cpu") for x in (k, v))
    tq = torch.from_numpy(q)
    lengths = torch.tensor(LENGTHS)
    valid = torch.arange(T)[None, None, :] < lengths[:, None, None]
    eager = llama._attention(tq[:, None], tk, tv, valid)[:, 0]
    got = da.decode_attention(tq, tk, tv, lengths, bk=BK)
    assert float((got - eager).abs().max()) < 3e-2


def test_zero_length_slot_is_zero():
    q, k, v = _inputs(2, 1, 4)
    tk, tv = (convert.params_from_jax(np.asarray(x), "cpu") for x in (k, v))
    got = da.decode_attention(torch.from_numpy(q), tk, tv,
                              torch.tensor([0, 5, 0]), bk=BK)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(got[2], torch.zeros_like(got[2]))


def test_decode_attention_refuses_other_devices():
    q = torch.zeros((1, 2, D), device="meta")
    c = torch.zeros((1, T, 2, D), dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError):
        da.decode_attention(q, c, c, torch.ones(1, dtype=torch.int32,
                                                device="meta"))
