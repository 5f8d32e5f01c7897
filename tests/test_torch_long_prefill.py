"""Port parity: prompts of 512 tokens or more through the flash route.

The model's causal self-attention over s >= 512 tokens with d_head 64 or
128 takes ``flash_attention`` on the kernel routes, as the reference runs
its Pallas flash kernel there. On the CPU the port's kernel routes
(``kernel_routes=True``) run the kernels' plain versions and the JAX side
runs ``use_pallas=True`` with Pallas in interpret mode, on the same fp32
weights (``convert.params_from_jax``), d_head 64 and GQA rep 2:

- ``decode_step(prefill_self=True)`` at s = 512 on each cache kind (bf16,
  KV8, paged bf16, paged KV8): the flash route runs on the fresh bf16 k
  and v, never on the quantized or pooled cache, in both packages;
- ``forward`` at s = 512;
- the engine: two prompts of 520 and 700 tokens admitted in one dispatch
  at bucket 1,024, without chunking.

Tolerances: logits within 2e-3 x max |logit| (measured: 3.6e-4 of it at
s = 512 on one host, 9.7e-4 on the KV8 kinds on another). XLA and PyTorch
sum the fp32 linears in other orders, which moves k and v by fp32 ulps.
The first layer's cache rows, which no attention feeds, are one rounding
step apart at most: a bf16 ulp (12 of 262,144 K elements), an int8 step
(1 element of 262,144), and for a KV8 scale the sum-order difference of
its row's largest element. The KV8 quantizer itself is exact
(``test_kv8_quantizer_is_exact_on_the_jax_rows``: the JAX side's own fp32
rows give its int8 values and scales bit for bit), so a scale, amax / 127,
moves only as amax does. Two fp32 sums of the same K = 256 products in
different orders differ by at most about (K - 1) x 2^-24 of the sum of
the products' magnitudes (the recursive-summation bound), and a row's
largest element is of that sum's order, so a first-layer scale is held to
K_SUM_REL = 256 x 2^-24 = 1.5e-5 of itself (measured 2.7e-7 on one host,
1.0037e-6 on another, where the earlier bound of 1e-6 failed). Every
later layer's rows come after an attention whose bf16 roundings of p can
flip between the two packages, so they are held to the flips' reach: an
int8 step, bf16 rows within 1e-2 and KV8 scales within 2e-3 of the
largest element (measured 3.5e-3 and 7.4e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.models import llama as jllama
from how_to_optimize_gemm_tpu_torch import _build, convert
from how_to_optimize_gemm_tpu_torch.models import llama
from how_to_optimize_gemm_tpu_torch.parallel import serving

torch.set_num_threads(1)

CFG = dict(vocab=64, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=256, max_seq=1024, weight_kind="fp32")
S = 512
PAGE = 128
LOGIT_REL = 2e-3
# later layers' cache rows, relative to the largest row element
ROW_REL = {torch.bfloat16: 1e-2, torch.float32: 2e-3}
# first-layer KV8 scales: the fp32 sum-order bound of a K = d_model dot
K_SUM_REL = CFG["d_model"] * 2.0 ** -24


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig(**CFG)
    cfg = llama.LlamaConfig(**CFG)
    jparams = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    assert cfg.d_head == 64 and llama._route_flash(True, S, cfg.d_head)
    return jcfg, jparams, cfg, params


def _caches(jcfg, kind, b):
    """The JAX cache of ``kind``, the port's copy of it and the block
    tables (None for a contiguous cache)."""
    quantized = kind.endswith("kv8")
    if kind.startswith("paged"):
        np_max = jcfg.max_seq // PAGE
        jcache = jllama.init_paged_kv_cache(jcfg, b * np_max + 1, PAGE,
                                            quantized=quantized)
        table = np.arange(1, b * np_max + 1, dtype=np.int32).reshape(
            b, np_max)
    else:
        jcache = jllama.init_kv_cache(jcfg, b, quantized=quantized)
        table = None
    cache = convert.kv_cache_from_jax(jax.tree.map(np.asarray, jcache),
                                      "cpu")
    return jcache, cache, table


@pytest.mark.parametrize("kind", ["bf16", "kv8", "paged", "paged-kv8"])
def test_prefill_self_takes_flash_and_matches_jax(model, kind, monkeypatch):
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(5)
    b = 2
    tokens = rng.integers(0, cfg.vocab, (b, S)).astype(np.int32)
    pos = np.zeros(b, np.int32)
    lidx = np.asarray([S - 1, 300], np.int32)
    mask = np.ones(b, bool)
    jcache, cache, table = _caches(jcfg, kind, b)
    jkw = {} if table is None else {"table": jnp.asarray(table)}
    kw = {} if table is None else {"table": torch.from_numpy(table)}
    jl, jcache = jllama.decode_step(
        jparams, jcfg, jcache, jnp.asarray(tokens), jnp.asarray(pos),
        use_pallas=True, write_mask=jnp.asarray(mask), prefill_self=True,
        logit_idx=jnp.asarray(lidx), **jkw)
    calls = []
    mha = llama.mha_flash

    def counting(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return mha(*args, **kwargs)
    monkeypatch.setattr(llama, "mha_flash", counting)
    tl, cache = llama.decode_step(
        params, cfg, cache, torch.from_numpy(tokens), torch.from_numpy(pos),
        write_mask=torch.from_numpy(mask), prefill_self=True,
        logit_idx=torch.from_numpy(lidx), kernel_routes=True, **kw)
    assert calls == [(b, S, cfg.n_heads, cfg.d_head)] * cfg.n_layers
    ref = np.asarray(jl)
    err = float(np.abs(tl.numpy() - ref).max())
    scale = float(np.abs(ref).max())
    print(f"{kind}: max |port - jax| logits = {err:.3e} of {scale:.3e}")
    assert err <= LOGIT_REL * scale
    jrows = convert.kv_cache_from_jax(jax.tree.map(np.asarray, jcache),
                                      "cpu")
    for li, (jentry, entry) in enumerate(zip(jrows, cache)):
        for jc, c in zip(jentry, entry):
            assert c.dtype == jc.dtype and c.shape == jc.shape
            diff = (c.float() - jc.float()).abs()
            top = float(jc.float().abs().max())
            if c.dtype == torch.int8:
                assert float(diff.max()) <= 1.0
            elif li == 0 and c.dtype == torch.bfloat16:
                ulp = torch.exp2(torch.floor(torch.log2(
                    jc.float().abs().clamp_min(1e-30))) - 7)
                assert bool((diff <= ulp + 1e-6).all())
            elif li == 0:
                assert bool((diff <= K_SUM_REL * jc.float().abs()).all())
            else:
                assert float(diff.max()) <= ROW_REL[c.dtype] * top
            print(f"{kind} layer {li} {c.dtype}: {int(diff.count_nonzero())}"
                  f" of {diff.numel()} differ, max {float(diff.max()):.3e} "
                  f"of {top:.3e}")


@pytest.mark.parametrize("kind", ["kv8", "paged-kv8"])
def test_kv8_quantizer_is_exact_on_the_jax_rows(model, kind, monkeypatch):
    """The port's ``quantize_kv`` on the fp32 k and v rows the JAX side
    quantizes in its own prefill (recorded as it runs) gives the JAX
    side's int8 values and scales bit for bit, in every layer. So the
    first layer's caches differ only as far as the two packages' fp32
    projections do."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(5)
    b = 2
    tokens = rng.integers(0, cfg.vocab, (b, S)).astype(np.int32)
    jcache, _, table = _caches(jcfg, kind, b)
    jkw = {} if table is None else {"table": jnp.asarray(table)}
    recorded = []
    jquantize = jllama.quantize_kv

    def recording(x):
        q, scale = jquantize(x)
        recorded.append((np.array(x), np.array(q), np.array(scale)))
        return q, scale
    monkeypatch.setattr(jllama, "quantize_kv", recording)
    jllama.decode_step(
        jparams, jcfg, jcache, jnp.asarray(tokens),
        jnp.zeros(b, jnp.int32), use_pallas=True,
        write_mask=jnp.ones(b, bool), prefill_self=True,
        logit_idx=jnp.asarray([S - 1, 300], jnp.int32), **jkw)
    assert len(recorded) == 2 * cfg.n_layers     # k and v of each layer
    for x, jq, jscale in recorded:
        assert x.dtype == np.float32 and x.shape == (b, S, cfg.n_kv_heads,
                                                     cfg.d_head)
        q, scale = llama.quantize_kv(torch.from_numpy(x))
        assert torch.equal(q, torch.from_numpy(jq))
        assert scale.dtype == torch.float32
        assert torch.equal(scale.view(torch.int32),
                           torch.from_numpy(jscale).view(torch.int32))


def test_forward_takes_flash_and_matches_jax(model):
    jcfg, jparams, cfg, params = model
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (2, S))
    ref = np.asarray(jllama.forward(jparams, jcfg, jnp.asarray(tokens),
                                    use_pallas=True))
    got = llama.forward(params, cfg, torch.from_numpy(tokens),
                        kernel_routes=True).numpy()
    err = float(np.abs(got - ref).max())
    print(f"forward: max |port - jax| = {err:.3e}")
    assert err <= LOGIT_REL * float(np.abs(ref).max())
    # below 512 tokens, and off the kernel routes, the eager attention
    assert not llama._route_flash(True, S - 1, cfg.d_head)
    assert not llama._route_flash(False, S, cfg.d_head)
    assert not llama._route_flash(True, S, 96)
    assert not llama._route_flash(True, 4096, 32)


def test_engine_admits_long_prompts_in_one_dispatch(model):
    """Prompts of 520 and 700 tokens on 2 slots: one admission dispatch
    of (2, 1024) with prefill_self, no chunks; each first token is the
    argmax of the JAX prefill of the same padded batch."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in (520, 700)]
    eng = serving.ServingEngine(cfg, params, batch_slots=2, device="cpu",
                                kernel_routes=True)
    steps = []
    step = eng.step

    def recording(tokens, pos, **kw):
        steps.append((tuple(tokens.shape), kw.get("prefill_self", False)))
        return step(tokens, pos, **kw)
    eng.step = recording
    before = dict(_build.LAUNCHES)
    done = eng.run([serving.Request(uid=i, prompt=p, max_new=3)
                    for i, p in enumerate(prompts)])
    assert _build.LAUNCHES == before          # plain versions on the CPU
    assert steps[0] == ((2, 1024), True)
    assert all(shape[1] == 1 and not self_attn
               for shape, self_attn in steps[1:])
    padded = np.zeros((2, 1024), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    jcache = jllama.init_kv_cache(jcfg, 2)
    jl, _ = jllama.decode_step(
        jparams, jcfg, jcache, jnp.asarray(padded), jnp.zeros(2, jnp.int32),
        use_pallas=True, write_mask=jnp.ones(2, bool), prefill_self=True,
        logit_idx=jnp.asarray([519, 699], jnp.int32))
    first = np.argmax(np.asarray(jl)[:, 0], axis=-1)
    assert [r.out[0] for r in done] == first.tolist()
    assert all(r.done and len(r.out) == 3 for r in done)
