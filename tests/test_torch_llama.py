"""Port parity: the quantized linear and the Llama decoder against the JAX
package's, on the CPU.

The JAX side runs as its own model tests run it (``use_pallas=False``:
its XLA formulations); the port runs its plain routes, which are those
formulations. Weights come from the JAX ``init_params`` through
``convert.params_from_jax``, so both packages hold the same bytes.

Tolerances:
- ``apply_linear``: int8 and w4a8 EQUAL (exact integer sums, the same
  epilogue); fp32, bf16 and int4 within 1e-5 of max |y| (fp32 sums in
  another order);
- model logits: rtol = atol = 2e-4, the JAX package's own bound for
  decode against forward (``tests/test_llama.py``). Both run the same
  fp32 ops; XLA and PyTorch differ by ulps in rsqrt, pow, exp and
  summation order, and a w4a8 activation that lands within an ulp of a
  rounding boundary can quantize one step apart.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.models import linear as jlinear
from how_to_optimize_gemm_tpu.models import llama as jllama
from how_to_optimize_gemm_tpu_torch import convert
from how_to_optimize_gemm_tpu_torch.models import linear, llama

torch.set_num_threads(1)

CFG = dict(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq=32)
TOL = dict(rtol=2e-4, atol=2e-4)


def _cfgs(kind):
    return (jllama.LlamaConfig(**CFG, weight_kind=kind),
            llama.LlamaConfig(**CFG, weight_kind=kind))


@pytest.fixture(scope="module", params=["fp32", "w4a8"])
def model(request):
    jcfg, cfg = _cfgs(request.param)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    return jcfg, jparams, cfg, params


# ---------------------------------------------------------------- linear

@pytest.mark.parametrize("m", [3, 100])
@pytest.mark.parametrize("kind", linear.KINDS)
def test_apply_linear_matches_jax(kind, m):
    rng = np.random.default_rng(m)
    w = rng.standard_normal((72, 40)).astype(np.float32) / 8
    x = rng.standard_normal((m, 72)).astype(np.float32)
    jlin = jlinear.make_linear(jnp.asarray(w), kind)
    lin = linear.make_linear(torch.from_numpy(w), kind)
    assert list(lin) == list(jlin) and linear.linear_kind(lin) == kind
    for key in lin:          # the port's own weights are the JAX bytes
        ref = convert.params_from_jax(np.asarray(jlin[key]), "cpu")
        assert lin[key].dtype == ref.dtype and torch.equal(lin[key], ref)
    ref = np.asarray(jlinear.apply_linear(jlin, jnp.asarray(x),
                                          use_pallas=False))
    got = linear.apply_linear(lin, torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (m, 40)
    if kind in ("int8", "w4a8"):
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_apply_linear_keeps_leading_dims():
    lin = linear.make_linear(torch.ones((16, 8)), "w4a8")
    assert linear.apply_linear(lin, torch.ones((2, 3, 16))).shape == (2, 3, 8)
    with pytest.raises(ValueError):
        linear.make_linear(torch.ones((4, 4)), "fp8")


# ----------------------------------------------------------------- model

def test_params_tree_matches_jax(model):
    """params_from_jax is a tree map: the same nesting and keys, each leaf
    the same dtype, shape and bytes (packed int4 included)."""
    _, jparams, _, params = model
    assert jax.tree.structure(params) == jax.tree.structure(jparams)
    for leaf, jleaf in zip(jax.tree.leaves(params), jax.tree.leaves(jparams)):
        assert tuple(leaf.shape) == jleaf.shape
        assert str(leaf.dtype).removeprefix("torch.") == str(jleaf.dtype)
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      np.asarray(jleaf, np.float32))


def test_forward_matches_jax(model):
    jcfg, jparams, cfg, params = model
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8))
    ref = np.asarray(jllama.forward(jparams, jcfg, jnp.asarray(tokens),
                                    use_pallas=False))
    got = llama.forward(params, cfg, torch.from_numpy(tokens)).numpy()
    assert got.shape == (2, 8, cfg.vocab)
    np.testing.assert_allclose(got, ref, **TOL)


def test_decode_step_matches_jax(model):
    """A masked bucketed prefill (one slot admitted at position 0) and
    then single-token steps at per-slot positions, on bf16 caches."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(2)
    b, s = 2, 8
    jcache = jllama.init_kv_cache(jcfg, b)
    cache = llama.init_kv_cache(cfg, b, device="cpu")
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    mask = np.asarray([True, False])
    pos = np.asarray([0, 3], np.int32)
    lidx = np.asarray([5, 0], np.int32)
    jl, jcache = jllama.decode_step(
        jparams, jcfg, jcache, jnp.asarray(tokens), jnp.asarray(pos),
        use_pallas=False, write_mask=jnp.asarray(mask), prefill_self=True,
        logit_idx=jnp.asarray(lidx))
    tl, cache = llama.decode_step(
        params, cfg, cache, torch.from_numpy(tokens), torch.from_numpy(pos),
        write_mask=torch.from_numpy(mask), prefill_self=True,
        logit_idx=torch.from_numpy(lidx))
    assert tl.shape == (b, 1, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    pos = np.asarray([6, 0], np.int32)
    for step in range(4):
        tok = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        jl, jcache = jllama.decode_step(jparams, jcfg, jcache,
                                        jnp.asarray(tok), jnp.asarray(pos),
                                        use_pallas=False)
        tl, cache = llama.decode_step(params, cfg, cache,
                                      torch.from_numpy(tok),
                                      torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pos = pos + 1
    for jkv, kv in zip(jcache, cache):       # bf16 rows, one ulp apart
        for jc, c in zip(jkv, kv):
            assert c.dtype == torch.bfloat16
            np.testing.assert_allclose(c.float().numpy(),
                                       np.asarray(jc, np.float32),
                                       rtol=1e-2, atol=1e-2)


def test_decode_matches_forward(model):
    """Step-by-step decode with the cache equals the full forward (the
    JAX package's own check, on the port)."""
    _, _, cfg, params = model
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, 6)))
    full = llama.forward(params, cfg, tokens)
    cache = llama.init_kv_cache(cfg, 1, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(tokens.shape[1]):
        logits, cache = llama.decode_step(params, cfg, cache,
                                          tokens[:, t:t + 1], t)
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full, **TOL)


def test_init_params_is_seeded_and_shaped():
    cfg = llama.LlamaConfig(**CFG, weight_kind="w4a8")
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    a, b = (llama.init_params(g, cfg, "cpu") for g in gens)
    assert torch.equal(a["layers"][1]["w_down"]["w4a8_packed"],
                       b["layers"][1]["w_down"]["w4a8_packed"])
    lin = a["layers"][0]["w_down"]
    assert lin["w4a8_packed"].shape == (512 // 2, cfg.d_model)
    assert int(lin["w4a8_kdim"]) == cfg.d_ff
    assert a["lm_head"]["fp32_w"].dtype == torch.float32


@pytest.mark.parametrize("what", ["moe", "kv8", "table", "lora"])
def test_unported_parts_raise(model, what):
    _, _, cfg, params = model
    tokens = torch.zeros((1, 1), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if what == "moe":
            llama.init_params(torch.Generator(), dataclasses.replace(
                cfg, n_experts=4), "cpu")
        elif what == "kv8":
            llama.init_kv_cache(cfg, 1, quantized=True, device="cpu")
        else:
            cache = llama.init_kv_cache(cfg, 1, device="cpu")
            kw = ({"table": torch.zeros((1, 1))} if what == "table"
                  else {"lora": {}})
            llama.decode_step(params, cfg, cache, tokens, 0, **kw)


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = llama.LlamaConfig(**CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.init_kv_cache(cfg, 1)


def test_kernel_routes_on_the_cpu(model):
    """kernel_routes=True takes the kernel routes on the CPU through the
    kernels' plain versions (the reference's use_pallas=True in interpret
    mode). The two routes are the reference's own: the eager one rounds q
    to bf16 before the scores, the kernel keeps it in fp32, and the JAX
    package holds the two attentions to atol 3e-2. Through two layers
    and w4a8 activation quantization that moves these logits by up to
    1.6% of their largest value (4.2% at Llama-2-7B width, two layers);
    the bound here is 5%. The first layer's cache rows, which no
    attention output feeds, are the same bytes."""
    _, _, cfg, params = model
    rng = np.random.default_rng(4)
    caches = [llama.init_kv_cache(cfg, 2, device="cpu") for _ in range(2)]
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
    (k0, v0), (k1, v1) = caches[0][0], caches[1][0]
    assert torch.equal(k0, k1) and torch.equal(v0, v1)
    assert llama.kernel_routes_for(tokens, None) is False
    assert llama.kernel_routes_for(tokens, True) is True
