"""Port parity: the KV8 cache (int8 values, fp32 scales per (token, head))
against the JAX package's.

- ``llama.quantize_kv``: the same int8 bytes and fp32 scales as the JAX
  ``quantize_kv`` (EQUAL), zero rows (the 1e-8 floor) and .5 ties
  included.
- ``decode_attention_q8`` (the port's plain version on the CPU) against
  ``pallas_decode_attention.decode_attention_q8`` in interpret mode, at a
  GQA width (kvh 2, rep 2, d 64: the reference's fused-head v4 kernel) and
  a wide-MHA width (kvh 16, d 128, kvh * d > 1024: its per-slot v3
  kernel), T = 256, bk = 128, lengths 1, 129 and T. Both walk the same
  chunks with an fp32 online softmax and differ in summation order and
  exp; a p * sv that lands on a bf16 rounding boundary can round the other
  way before the PV product: atol 5e-4, as for the bf16 cache.
- ``llama._attention_kv8`` against the JAX one (its off-TPU fp32 form):
  within 1e-5 of max |out| (fp32 sums in another order).
- a KV8 ``decode_step`` against JAX's, from the same weights and a cache
  the JAX model filled (``convert.kv_cache_from_jax``): logits to
  rtol = atol = 2e-4 (the model tests' bound); the caches' int8 values
  at most one step apart (k and v differ by ulps before quantization) and
  their scales within 1e-5.

The port's scales are (B, T, KVH); the reference's are lane-padded to
(B, T, 128), and the tests crop them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.models import llama as jllama
from how_to_optimize_gemm_tpu.ops import pallas_decode_attention as jda
from how_to_optimize_gemm_tpu_torch import convert
from how_to_optimize_gemm_tpu_torch.models import llama
from how_to_optimize_gemm_tpu_torch.ops import decode_attention as da

torch.set_num_threads(1)

T, BK = 256, 128
LENGTHS = [1, 129, T]
ATOL = 5e-4
TOL = dict(rtol=2e-4, atol=2e-4)
CFG = dict(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq=32)


def _kv(shape, seed):
    """Random K/V rows with an all-zero row and a row of .5 ties."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 0] = np.round(rng.uniform(-120, 120, shape[-1])) + 0.5
    x[0, 1, 0, 0] = 127.0
    return x


def test_quantize_kv_is_the_jax_bytes():
    x = _kv((2, 5, 3, 64), 0)
    jq, js = jllama.quantize_kv(jnp.asarray(x))
    q, s = llama.quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == (2, 5, 3)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(s[0, 0, 0]) == np.float32(1e-8) / np.float32(127)


def _q8_cache(kvh, d, seed):
    """(JAX qk, sk, qv, sv) with (B, T, 128) scales, and the port's."""
    b = len(LENGTHS)
    entry = []
    for i in range(2):
        q, s = jllama.quantize_kv(jnp.asarray(_kv((b, T, kvh, d),
                                                  seed + i)))
        entry += [q, jnp.pad(s, ((0, 0), (0, 0), (0, 128 - kvh)))]
    return entry, convert.kv_cache_from_jax([entry], "cpu")[0]


@pytest.mark.parametrize("kvh,rep,d", [(2, 2, 64), (16, 1, 128)])
def test_decode_attention_q8_matches_jax(kvh, rep, d):
    jentry, entry = _q8_cache(kvh, d, kvh)
    assert entry[1].shape == (len(LENGTHS), T, kvh)
    q = np.random.default_rng(d).standard_normal(
        (len(LENGTHS), kvh * rep, d)).astype(np.float32)
    lengths = np.asarray(LENGTHS, np.int32)
    ref = np.asarray(jda.decode_attention_q8(
        jnp.asarray(q), *jentry, jnp.asarray(lengths), bk=BK,
        interpret=True))
    got = da.decode_attention_q8(torch.from_numpy(q), *entry,
                                 torch.from_numpy(lengths), bk=BK)
    assert got.shape == (len(LENGTHS), kvh * rep * d)
    assert got.dtype == torch.float32
    err = float(np.max(np.abs(got.numpy() - ref)))
    print(f"kvh={kvh} rep={rep} d={d}: max |port - jax| = {err:.3e}")
    assert err < ATOL, err


def test_decode_attention_q8_matches_eager_kv8_attention():
    """The chunk walk computes the eager KV8 attention the model runs off
    the kernel routes, up to the bf16 rounding of p * sv (the JAX
    package's decode-attention bound, atol 3e-2)."""
    _, entry = _q8_cache(2, 64, 3)
    q = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (len(LENGTHS), 4, 64)).astype(np.float32))
    lengths = torch.tensor(LENGTHS)
    valid = torch.arange(T)[None, None, :] < lengths[:, None, None]
    eager = llama._attention_kv8(q[:, None], *entry, valid)[:, 0]
    got = da.decode_attention_q8(q, *entry, lengths, bk=BK)
    assert float((got - eager).abs().max()) < 3e-2


def test_attention_kv8_matches_jax():
    jentry, entry = _q8_cache(2, 64, 7)
    rng = np.random.default_rng(8)
    q = rng.standard_normal((len(LENGTHS), 3, 4, 64)).astype(np.float32)
    pos = np.asarray(LENGTHS) - 3
    valid = np.arange(T)[None, None, :] <= (pos[:, None] + np.arange(3))[
        ..., None]                                   # (B, S, T)
    ref = np.asarray(jllama._attention_kv8(jnp.asarray(q), *jentry,
                                           jnp.asarray(valid)))
    got = llama._attention_kv8(torch.from_numpy(q), *entry,
                               torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.fixture(scope="module", params=["fp32", "w4a8"])
def model(request):
    jcfg = jllama.LlamaConfig(**CFG, weight_kind=request.param)
    cfg = llama.LlamaConfig(**CFG, weight_kind=request.param)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    return jcfg, jparams, cfg, params


def test_kv8_decode_step_matches_jax(model):
    """JAX admits two slots' prompts into its KV8 cache; both packages
    then decode from that cache on their default CPU routes."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(2)
    b, s = 2, 8
    jcache = jllama.init_kv_cache(jcfg, b, quantized=True)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    zeros = np.zeros(b, np.int32)
    _, jcache = jllama.decode_step(
        jparams, jcfg, jcache, jnp.asarray(tokens), jnp.asarray(zeros),
        use_pallas=False, write_mask=jnp.ones(b, bool), prefill_self=True,
        logit_idx=jnp.asarray(zeros + s - 1))
    cache = convert.kv_cache_from_jax(jax.tree.map(np.asarray, jcache),
                                      "cpu")
    assert [c.dtype for c in cache[0]] == [torch.int8, torch.float32] * 2
    pos = np.asarray([s, 5], np.int32)
    for _ in range(4):
        tok = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        jl, jcache = jllama.decode_step(jparams, jcfg, jcache,
                                        jnp.asarray(tok), jnp.asarray(pos),
                                        use_pallas=False)
        tl, cache = llama.decode_step(params, cfg, cache,
                                      torch.from_numpy(tok),
                                      torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pos = pos + 1
    for jentry, entry in zip(convert.kv_cache_from_jax(
            jax.tree.map(np.asarray, jcache), "cpu"), cache):
        for i, (jc, c) in enumerate(zip(jentry, entry)):
            if i % 2 == 0:
                assert int((jc.int() - c.int()).abs().max()) <= 1
            else:
                torch.testing.assert_close(c, jc, rtol=1e-5, atol=0)


def test_kv8_kernel_routes_on_the_cpu(model):
    """kernel_routes=True writes the KV8 cache through kv_update's plain
    version and decodes through decode_attention_q8's: the first layer's
    cache rows are the eager route's bytes, and the logits move by the
    bf16 rounding of p * sv and w4a8 activation quantization only (5% of
    their largest value, the bf16 cache's bound)."""
    _, _, cfg, params = model
    rng = np.random.default_rng(4)
    caches = [llama.init_kv_cache(cfg, 2, quantized=True, device="cpu")
              for _ in range(2)]
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 5)))
    pos = torch.tensor([0, 0], dtype=torch.int32)
    outs = []
    for cache, routes in zip(caches, (None, True)):
        llama.decode_step(params, cfg, cache, tokens, pos, prefill_self=True,
                          kernel_routes=routes)
        logits, _ = llama.decode_step(params, cfg, cache, tokens[:, :1],
                                      pos + 5, kernel_routes=routes)
        outs.append(logits)
    assert float((outs[0] - outs[1]).abs().max()) \
        < 5e-2 * float(outs[0].abs().max())
    for c0, c1 in zip(caches[0][0], caches[1][0]):
        assert torch.equal(c0, c1)


def test_kv8_cache_layout():
    cfg = dataclasses.replace(llama.LlamaConfig(**CFG), n_layers=1)
    (qk, sk, qv, sv), = llama.init_kv_cache(cfg, 3, quantized=True,
                                             device="cpu")
    assert qk.shape == qv.shape == (3, cfg.max_seq, 2, cfg.d_head)
    assert sk.shape == sv.shape == (3, cfg.max_seq, 2)
    assert qk.dtype == torch.int8 and sv.dtype == torch.float32
    with pytest.raises(ValueError):
        convert.kv_cache_from_jax([(np.zeros(1),) * 3], "cpu")


def test_step_bytes_counts_the_kv8_cache():
    """The step profiler's bound reads a KV8 cache row as D int8 values
    and one fp32 scale per head, against 2 D bytes for bf16."""
    from how_to_optimize_gemm_tpu_torch.harness import serve_profile
    cfg = llama.LlamaConfig(**CFG, weight_kind="w4a8")
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    bf16 = serve_profile.step_bytes(params, cfg, 3, 9)
    kv8 = serve_profile.step_bytes(params, cfg, 3, 9, "int8")
    rows = 2 * cfg.n_layers * 3 * 10 * cfg.n_kv_heads
    assert bf16 - kv8 == rows * (cfg.d_head - 4)


def test_decode_attention_q8_refuses_other_devices():
    meta = dict(device="meta")
    q = torch.zeros((1, 2, 64), **meta)
    c = torch.zeros((1, T, 2, 64), dtype=torch.int8, **meta)
    s = torch.zeros((1, T, 2), **meta)
    with pytest.raises(RuntimeError):
        da.decode_attention_q8(q, c, s, c, s,
                               torch.ones(1, dtype=torch.int32, **meta))
