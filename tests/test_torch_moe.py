"""Port parity: the MoE layer (routing, quantized stacks, the dispatch,
ragged and dense paths) and the Mixtral-shaped model and engine against
the JAX package's, on the CPU.

The JAX side runs as its own tests run it (``use_pallas=False`` for the
model; the ragged path's grouped GEMM in interpret mode). Weights come
from the JAX side through ``convert.params_from_jax`` (the same bytes);
inputs are numpy arrays from a seed.

Tolerances:
- the routing layout, the dispatch one-hots and the quantized stacks:
  EQUAL; the combine weights and aux: AUX_RTOL (softmax and sums in
  another order);
- MoE outputs: MOE_REL of max |y| (fp32 products summed in another
  order; measured up to 4e-7);
- model logits: rtol = atol = 2e-4, the bound of ``test_torch_llama.py``;
- greedy streams: IDENTICAL.

Routing near-ties: a router probability computed in another order can
move by a few fp32 ulps, and where a token's k-th and (k+1)-th
probabilities lie closer than that, the two sides may pick different
experts. ``_compare_routed`` allows that only for such tokens (JAX's gap
within TIE_BOUND) and compares every other token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.models import llama as jllama
from how_to_optimize_gemm_tpu.parallel import moe as jmoe
from how_to_optimize_gemm_tpu.parallel import serving as jserving
from how_to_optimize_gemm_tpu_torch import convert
from how_to_optimize_gemm_tpu_torch.models import llama
from how_to_optimize_gemm_tpu_torch.parallel import moe, serving

torch.set_num_threads(1)

AUX_RTOL = 1e-5
MOE_REL = 1e-5
TOL = dict(rtol=2e-4, atol=2e-4)
# a probability gap that fp32 sums in another order can close: a few ulps
# of probabilities below 1
TIE_BOUND = 1e-6
D, F, E = 16, 40, 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _layer(kind: str, seed: int = 5, swiglu: bool = True):
    """A JAX MoE layer of ``kind`` (fp32, int8, int4) and its port copy."""
    p = jmoe.init_moe_params(jax.random.PRNGKey(seed), D, F, E,
                             swiglu=swiglu)
    if kind != "fp32":
        p = jmoe.quantize_moe(p, bits=8 if kind == "int8" else 4)
    return p, convert.params_from_jax(_np(p), "cpu")


def _x(t: int, seed: int = 6) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((t, D)).astype(
        np.float32)


def _jax_choice(jparams, x: np.ndarray, k: int):
    logits = jnp.asarray(x) @ jparams["router"].astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    return np.asarray(jax.lax.top_k(probs, k + 1)[0]), np.asarray(
        jax.lax.top_k(probs, k)[1])


def _compare_routed(got, ref, jparams, params, x, k: int, rel=MOE_REL):
    """Rows of tokens routed to the same experts on both sides within rel
    of max |ref|; a token routed otherwise must be a near-tie on the JAX
    side. Returns the number of such tokens."""
    probs, jchoice = _jax_choice(jparams, x, k)
    _, _, choice = moe._top_k_gates(params, torch.from_numpy(x), k)
    same = np.array([set(a) == set(b) for a, b in
                     zip(choice.numpy(), jchoice)])
    gap = probs[:, k - 1] - probs[:, k]
    assert (gap[~same] <= TIE_BOUND).all(), gap[~same]
    err = np.abs(got[same] - ref[same]).max(initial=0.0)
    assert err <= rel * np.abs(ref).max(), err
    return int((~same).sum())


# ---------------------------------------------------------------- stacks

@pytest.mark.parametrize("stack_dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_moe_bytes_equal_jax(bits, stack_dtype):
    p = jmoe.init_moe_params(jax.random.PRNGKey(1), D, F, E,
                             dtype=stack_dtype, swiglu=True)
    ref = _np(jmoe.quantize_moe(p, bits=bits))
    got = moe.quantize_moe(convert.params_from_jax(_np(p), "cpu"), bits)
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        assert got[name].dtype == convert._tensor(r, "cpu").dtype, name
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      np.asarray(r, np.float32), name)
    deq = moe.dequantize_moe(got)
    jdeq = _np(jmoe.dequantize_moe(jmoe.quantize_moe(p, bits=bits)))
    for name in ("w_in", "w_out", "w_gate"):
        np.testing.assert_array_equal(deq[name].numpy(), jdeq[name])


def test_quantize_moe_refuses_another_width():
    _, p8 = _layer("int8")
    again = moe.quantize_moe(p8, 8)
    assert all(again[k] is p8[k] for k in p8)
    with pytest.raises(ValueError, match="already quantized at 8-bit"):
        moe.quantize_moe(p8, 4)
    with pytest.raises(ValueError, match="bits"):
        moe.quantize_moe(p8, 2)


def test_convert_carries_moe_trees():
    """params_from_jax on MoE layers: int8 and packed int4 bytes identical,
    bf16 stacks and router bit for bit; to_device keeps them."""
    for dtype, bits in ((jnp.float32, 8), (jnp.float32, 4),
                        (jnp.bfloat16, None)):
        jp = jmoe.init_moe_params(jax.random.PRNGKey(4), D, F, E,
                                  dtype=dtype, swiglu=True)
        if bits:
            jp = jmoe.quantize_moe(jp, bits)
        got = convert.to_device(
            convert.params_from_jax({"layers": [{"moe": _np(jp)}]}, "cpu"),
            "cpu")["layers"][0]["moe"]
        assert sorted(got) == sorted(jp)
        for name, r in _np(jp).items():
            r = np.asarray(r)
            if r.dtype.name == "bfloat16":
                assert got[name].dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    got[name].view(torch.int16).numpy(), r.view(np.int16))
            else:
                assert got[name].dtype == convert._tensor(r, "cpu").dtype
                np.testing.assert_array_equal(got[name].numpy(), r)


# --------------------------------------------------------------- routing

@pytest.mark.parametrize("capacity", [1, 3, 64])
def test_route_matches_jax(capacity):
    """Dispatch and combine at capacity 1 (most choices drop), 3 and
    64 (none does), with padding tokens masked out."""
    rng = np.random.default_rng(capacity)
    logits = rng.standard_normal((12, E)).astype(np.float32)
    valid = np.arange(12) < 10
    jd, jc, ja = jmoe._route(jnp.asarray(logits), 2, capacity,
                             valid=jnp.asarray(valid))
    d, c, a = moe._route(torch.from_numpy(logits), 2, capacity,
                         valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=AUX_RTOL)
    np.testing.assert_allclose(float(a), float(ja), rtol=AUX_RTOL)
    assert not d[10:].any()                  # padding takes no capacity


def test_route_first_choices_queue_first():
    """At capacity 1 an expert's one slot goes to the first token whose
    FIRST choice it is, before any token's second choice."""
    logits = torch.tensor([[0.0, 5.0, 4.0, -9.0],     # 1 first, 2 second
                           [0.0, 3.0, 6.0, -9.0],     # 2 first, 1 second
                           [7.0, 0.0, 0.0, -9.0]])    # 0 first
    disp, comb, _ = moe._route(logits, 2, 1)
    assert disp[0, 1, 0] == 1 and disp[1, 2, 0] == 1 and disp[2, 0, 0] == 1
    assert disp[0, 2].sum() == 0 and disp[1, 1].sum() == 0
    assert float(disp.sum()) == 3.0
    assert torch.all((comb > 0) == (disp > 0))


def test_ragged_layout_equals_jax():
    """Expert 2 receives no token: it still owns one block."""
    rng = np.random.default_rng(7)
    t, k, bt = 37, 2, 8
    flat = rng.choice([0, 1, 3], t * k).astype(np.int32)
    ref = jmoe._ragged_layout(jnp.asarray(flat), t, E, k, bt)
    got = moe._ragged_layout(torch.from_numpy(flat), t, E, k, bt)
    assert got[4] == ref[4]
    for g, r in zip(got[:4], ref[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert 2 in got[3].tolist()


# ----------------------------------------------------------------- paths

@pytest.mark.parametrize("kind", ["fp32", "int8", "int4"])
def test_moe_ffn_local_matches_jax(kind):
    """The dispatch path in chunks of 16 with capacity factor 1: tokens
    drop, and the same ones on both sides."""
    jp, p = _layer(kind)
    x = _x(40)
    ref, jaux = jmoe.moe_ffn_local(jp, jnp.asarray(x), k=2,
                                   capacity_factor=1.0, chunk=16,
                                   return_aux=True)
    got, aux = moe.moe_ffn_local(p, torch.from_numpy(x), k=2,
                                 capacity_factor=1.0, chunk=16,
                                 return_aux=True)
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() <= MOE_REL * np.abs(ref).max()
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)


@pytest.mark.parametrize("kind", ["fp32", "int8", "int4"])
def test_moe_ffn_ragged_matches_jax_and_dense(kind):
    """The ragged path (blocks of 8, the JAX grouped GEMM in interpret
    mode) against JAX's, and against the port's dense oracle: dropless by
    construction."""
    jp, p = _layer(kind)
    x = _x(50)
    ref, jaux = jmoe.moe_ffn_ragged(jp, jnp.asarray(x), k=2, bt=8,
                                    return_aux=True)
    got, aux = moe.moe_ffn_ragged(p, torch.from_numpy(x), k=2, bt=8,
                                  return_aux=True)
    _compare_routed(got.numpy(), np.asarray(ref), jp, p, x, 2)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)
    assert float(aux) >= 1.0 - 1e-5
    dense = moe.moe_ffn_dense(p, torch.from_numpy(x), k=2).numpy()
    assert np.abs(got.numpy() - dense).max() <= MOE_REL * np.abs(dense).max()


def test_moe_ffn_dense_matches_jax_and_relu_experts():
    for swiglu in (True, False):
        jp, p = _layer("fp32", seed=8, swiglu=swiglu)
        x = _x(20, seed=9)
        ref = np.asarray(jmoe.moe_ffn_dense(jp, jnp.asarray(x), k=2))
        got = moe.moe_ffn_dense(p, torch.from_numpy(x), k=2).numpy()
        _compare_routed(got, ref, jp, p, x, 2)
        local = moe.moe_ffn_local(p, torch.from_numpy(x), k=2,
                                  capacity_factor=E / 2).numpy()
        assert np.abs(local - got).max() <= MOE_REL * np.abs(got).max()


def test_routing_near_ties_are_the_only_disagreements():
    """Two experts with identical router columns tie exactly for every
    token: the rule lets such tokens differ and still holds the rest."""
    jp, p = _layer("fp32", seed=10)
    router = np.asarray(jp["router"]).copy()
    router[:, 3] = router[:, 2]
    jp = {**jp, "router": jnp.asarray(router)}
    p = {**p, "router": torch.from_numpy(router)}
    x = _x(30, seed=11)
    ref = np.asarray(jmoe.moe_ffn_dense(jp, jnp.asarray(x), k=1))
    got = moe.moe_ffn_dense(p, torch.from_numpy(x), k=1).numpy()
    _compare_routed(got, ref, jp, p, x, 1)
    probs, _ = _jax_choice(jp, x, 1)
    assert (probs[:, 0] == probs[:, 1]).any()
    with pytest.raises(AssertionError):    # a real difference is caught
        _compare_routed(got + 1.0, ref, jp, p, x, 1)


def test_mesh_moe_is_not_ported():
    _, p = _layer("fp32")
    with pytest.raises(NotImplementedError, match="A12"):
        moe.moe_ffn(p, torch.zeros((4, D)), mesh=object())


# ----------------------------------------------------------------- model

_MCFG = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq=32, n_experts=4)
# (weight kind, moe_ragged_min_tokens): the default (decode and short
# prompts take the dispatch path) and 0 (every step takes the ragged one)
MODELS = [(kind, mt) for kind in ("fp32", "int8", "w4a8")
          for mt in (None, 0)]


@pytest.fixture(scope="module", params=MODELS,
                ids=[f"{k}-min{m}" for k, m in MODELS])
def mixtral(request):
    kind, min_tokens = request.param
    extra = dict(weight_kind=kind, moe_ragged=True,
                 moe_ragged_min_tokens=min_tokens)
    jcfg = jllama.LlamaConfig(**_MCFG, **extra)
    jparams = jllama.init_params(jax.random.PRNGKey(9), jcfg)
    params = convert.params_from_jax(_np(jparams), "cpu")
    return jcfg, jparams, llama.LlamaConfig(**_MCFG, **extra), params


def test_mixtral_preset_matches_jax():
    for kind in ("bf16", "int8", "w4a8"):
        assert dataclasses.asdict(llama.mixtral_8x7b(kind)) == \
            dataclasses.asdict(jllama.mixtral_8x7b(kind))
    assert llama.mixtral_8x7b().weight_kind == "bf16"


def test_forward_logits_and_aux_match_jax(mixtral):
    jcfg, jparams, cfg, params = mixtral
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12))
    ref, jaux = jllama.forward(jparams, jcfg, jnp.asarray(tokens),
                               use_pallas=False, return_moe_aux=True)
    got, aux = llama.forward(params, cfg, torch.from_numpy(tokens),
                             return_moe_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)


def test_decode_step_matches_jax(mixtral):
    """A masked admission prefill and single-token steps, bf16 cache."""
    jcfg, jparams, cfg, params = mixtral
    rng = np.random.default_rng(2)
    jcache = jllama.init_kv_cache(jcfg, 2)
    cache = llama.init_kv_cache(cfg, 2, device="cpu")
    tokens = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    mask = np.asarray([True, False])
    pos = np.zeros(2, np.int32)
    jl, jcache = jllama.decode_step(
        jparams, jcfg, jcache, jnp.asarray(tokens), jnp.asarray(pos),
        use_pallas=False, write_mask=jnp.asarray(mask), prefill_self=True)
    tl, cache = llama.decode_step(
        params, cfg, cache, torch.from_numpy(tokens), torch.from_numpy(pos),
        write_mask=torch.from_numpy(mask), prefill_self=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    pos = np.asarray([8, 0], np.int32)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jcache = jllama.decode_step(jparams, jcfg, jcache,
                                        jnp.asarray(tok), jnp.asarray(pos),
                                        use_pallas=False)
        tl, cache = llama.decode_step(params, cfg, cache,
                                      torch.from_numpy(tok),
                                      torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pos = pos + 1


PROMPTS = [[3, 5, 7], [11, 2], [40, 41, 42, 43], [9, 1, 8, 20, 21]]
MAX_NEW = [5, 7, 4, 6]


def _requests(mod):
    return [mod.Request(uid=i, prompt=list(p), max_new=n)
            for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW))]


def test_engine_streams_equal_jax(mixtral):
    """More requests than slots: admissions, releases and refills."""
    jcfg, jparams, cfg, params = mixtral
    ref = jserving.ServingEngine(jcfg, jparams, batch_slots=2,
                                 use_pallas=False).run(_requests(jserving))
    done = serving.ServingEngine(cfg, params, batch_slots=2,
                                 device="cpu").run(_requests(serving))
    assert [r.out for r in done] == [j.out for j in ref]
    assert all(r.done and len(r.out) == r.max_new for r in done)


@pytest.mark.parametrize("cache_kind", ["bf16", "int8"])
def test_paged_engine_streams_equal_jax(cache_kind):
    extra = dict(weight_kind="int8", moe_ragged=True,
                 moe_ragged_min_tokens=0)
    jcfg = jllama.LlamaConfig(**_MCFG, **extra)
    jparams = jllama.init_params(jax.random.PRNGKey(4), jcfg)
    params = convert.params_from_jax(_np(jparams), "cpu")
    kw = dict(batch_slots=2, cache_kind=cache_kind, paged=True, page=8)
    ref = jserving.ServingEngine(jcfg, jparams, use_pallas=False,
                                 **kw).run(_requests(jserving))
    done = serving.ServingEngine(llama.LlamaConfig(**_MCFG, **extra),
                                 params, device="cpu",
                                 **kw).run(_requests(serving))
    assert [r.out for r in done] == [j.out for j in ref]


def test_route_choice_follows_the_reference(monkeypatch):
    """_mlp: ragged from moe_ragged_min_tokens routed copies (default
    2 x E x 128), the dispatch path below it with cf = max(cf, E / k)."""
    cfg = llama.LlamaConfig(**_MCFG, weight_kind="fp32", moe_ragged=True)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    calls = []
    real_local, real_ragged = moe.moe_ffn_local, moe.moe_ffn_ragged
    monkeypatch.setattr(moe, "moe_ffn_local", lambda *a, **kw: (
        calls.append(("local", kw["capacity_factor"]))
        or real_local(*a, **kw)))
    monkeypatch.setattr(moe, "moe_ffn_ragged", lambda *a, **kw: (
        calls.append(("ragged", a[1].shape[0])) or real_ragged(*a, **kw)))
    layer = params["layers"][0]
    y = torch.randn((1, 512, cfg.d_model), generator=torch.Generator())
    for s, c in ((511, "local"), (512, "ragged")):
        calls.clear()
        llama._mlp(layer, cfg, y[:, :s], False)
        assert calls[0][0] == c, (s, calls)
    assert calls == [("ragged", 512)]
    calls.clear()
    llama._mlp(layer, dataclasses.replace(cfg, moe_ragged=False,
                                          moe_dropless=False),
               torch.zeros((1, 3, cfg.d_model)), False)
    assert calls == [("local", 2.0)]


def test_init_params_draws_moe_stacks_in_the_weight_kind():
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    for kind, keys in (("fp32", {"w_in"}), ("bf16", {"w_in"}),
                       ("int8", {"w_in_q", "w_in_s"}),
                       ("w4a8", {"w_in_q4", "w_in_s"})):
        cfg = llama.LlamaConfig(**_MCFG, weight_kind=kind)
        a, b = (llama.init_params(g, cfg, "cpu") for g in gens)
        m = a["layers"][0]["moe"]
        assert keys <= set(m) and "w_gate" not in a["layers"][0]
        name = sorted(keys)[0]
        assert torch.equal(m[name], b["layers"][0]["moe"][name])
        if kind == "w4a8":
            assert m["w_in_q4"].shape == (E, cfg.d_model // 2, cfg.d_ff)
        assert m["router"].shape == (cfg.d_model, E)


# ------------------------------------------------------------------ CLIs

def test_serving_cli_serves_moe_on_the_cpu(capsys):
    stats = serving.main(["--device", "cpu", "--d-model", "32",
                          "--n-heads", "4", "--n-kv-heads", "2",
                          "--n-layers", "1", "--max-seq", "64",
                          "--n-experts", "4", "--moe-top-k", "2",
                          "--moe-ragged", "--d-ff", "40", "--slots", "2",
                          "--requests", "3", "--prompt-len", "8",
                          "--max-new", "3", "--weight-kind", "int8"])
    assert stats["tokens"] == 9
    assert "tok/s" in capsys.readouterr().out


def test_moe_bench_runs_on_the_cpu(capsys):
    from how_to_optimize_gemm_tpu_torch.parallel import moe_bench
    moe_bench.main(["--device", "cpu", "--t", "64", "--d", "32", "--f",
                    "48", "--e", "4", "--tp", "512", "--batch", "4",
                    "--repeats", "1"])
    out = capsys.readouterr().out
    for label in ("grouped_matmul", "ragged", "dispatch", "dense",
                  "trainable leaves"):
        assert label in out
    r = moe_bench.main(["train", "--device", "cpu", "--t", "64", "--d", "32",
                        "--f", "48", "--e", "4", "--repeats", "1"])
    assert r["custom"]["train int8"]["stacks_unchanged"]
    assert "trainable leaves" in capsys.readouterr().out


def test_moe_bench_default_parts_are_the_references():
    """No part named runs kernel, prefill, decode and train, as the
    reference's ``moe_bench.main`` does (ROADMAP C.13)."""
    import inspect

    from how_to_optimize_gemm_tpu.parallel import moe_bench as jmoe_bench
    from how_to_optimize_gemm_tpu_torch.parallel import moe_bench
    assert moe_bench.PARTS == ("kernel", "prefill", "decode", "train")
    assert ('default=["kernel", "prefill", "decode", "train"]'
            in inspect.getsource(jmoe_bench.main))
