"""Port parity: the continuous-batching engine against the JAX package's.

The same requests (more than the slots, so slots are released and
refilled) go through the JAX ``ServingEngine(use_pallas=False)`` and the
port's ``ServingEngine`` on the CPU, both greedy, on the same weights
(``convert.params_from_jax``). Tolerance: none, the token streams must be
IDENTICAL, for fp32, w4a8, int8 and int4 weights over a bf16 cache and
for w4a8 weights over the KV8 cache (``cache_kind="int8"``).
"""
import jax
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.models import llama as jllama
from how_to_optimize_gemm_tpu.parallel import serving as jserving
from how_to_optimize_gemm_tpu_torch import convert
from how_to_optimize_gemm_tpu_torch.models import llama
from how_to_optimize_gemm_tpu_torch.parallel import serving

torch.set_num_threads(1)

CFG = dict(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq=32)
PROMPTS = [[3, 5, 7], [11, 2], [40, 41, 42, 43], [9], [60, 1, 33]]
MAX_NEW = [6, 9, 4, 7, 5]


def _requests(mod, n=len(PROMPTS)):
    return [mod.Request(uid=i, prompt=list(PROMPTS[i]), max_new=MAX_NEW[i])
            for i in range(n)]


# (weight kind, cache kind) of each engine pair
ENGINES = {"fp32": ("fp32", "bf16"), "w4a8": ("w4a8", "bf16"),
           "int8": ("int8", "bf16"), "int4": ("int4", "bf16"),
           "w4a8-kv8": ("w4a8", "int8")}


@pytest.fixture(scope="module", params=list(ENGINES))
def engines(request):
    kind, cache_kind = ENGINES[request.param]
    jcfg = jllama.LlamaConfig(**CFG, weight_kind=kind)
    cfg = llama.LlamaConfig(**CFG, weight_kind=kind)
    jparams = jllama.init_params(jax.random.PRNGKey(7), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    jeng = jserving.ServingEngine(jcfg, jparams, batch_slots=2,
                                  use_pallas=False, cache_kind=cache_kind)
    ref = jeng.run(_requests(jserving))

    def port(**kw):
        kw.setdefault("cache_kind", cache_kind)
        return serving.ServingEngine(cfg, params, batch_slots=2,
                                     device="cpu", **kw)
    return ref, port, cfg


def test_token_streams_equal_jax(engines):
    ref, port, _ = engines
    done = port().run(_requests(serving))
    for r, j in zip(done, ref):
        assert r.done and len(r.out) == r.max_new
        assert r.out == j.out, (r.uid, r.out, j.out)


@pytest.mark.parametrize("window", [1, 3])
def test_stream_does_not_depend_on_the_window(engines, window):
    ref, port, _ = engines
    done = port().run(_requests(serving), window=window)
    assert [r.out for r in done] == [j.out for j in ref]


def test_run_stream_equals_run(engines):
    ref, port, _ = engines
    reqs = _requests(serving)
    got = {r.uid: [] for r in reqs}
    for uid, tok in port().run_stream(reqs):
        got[uid].append(tok)
    assert [got[j.uid] for j in ref] == [j.out for j in ref]


def test_eos_and_latency_bookkeeping(engines):
    ref, port, _ = engines
    eos = ref[0].out[2]
    done = port().run(_requests(serving, 2), eos_id=eos)
    assert done[0].out == ref[0].out[:3]
    for r in done:
        assert r.done and r.t_submit <= r.t_first <= r.t_done
    stats = serving.summarize(done, 1.0)
    assert stats["tokens"] == sum(len(r.out) for r in done)


def test_sampled_engine_gives_valid_tokens(engines):
    _, port, cfg = engines
    eng = port(sample=serving.make_sampler(temperature=1.5, top_k=8),
               seed=3)
    done = eng.run(_requests(serving, 2))
    assert all(0 <= t < cfg.vocab for r in done for t in r.out)


def test_filter_logits_matches_jax():
    logits = np.random.default_rng(0).standard_normal((3, 50)).astype(
        np.float32)
    for kw in (dict(top_k=5), dict(top_p=0.7), dict(min_p=0.2),
               dict(temperature=0.7, top_k=10, top_p=0.9)):
        ref = np.asarray(jserving.filter_logits(logits, **kw))
        got = serving.filter_logits(torch.from_numpy(logits), **kw).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kw", [dict(lora={}), dict(mesh=object())])
def test_unported_options_raise(engines, kw):
    _, port, _ = engines
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port(**kw)


@pytest.mark.parametrize("call", ["lookahead", "run_spec",
                                  "run_spec_lookup"])
def test_unported_modes_raise(engines, call):
    _, port, _ = engines
    eng = port()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if call == "lookahead":
            eng.run(_requests(serving, 1), lookahead=2)
        else:
            getattr(eng, call)(_requests(serving, 1))


def test_engine_cache_kinds():
    cfg = llama.LlamaConfig(**CFG, weight_kind="w4a8")
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    eng = serving.ServingEngine(cfg, params, device="cpu", cache_kind="int8")
    assert [c.dtype for c in eng.cache[0]] == [torch.int8, torch.float32] * 2
    with pytest.raises(ValueError):
        serving.ServingEngine(cfg, params, device="cpu", cache_kind="fp8")


def test_make_requests_is_seeded():
    a = serving.make_requests(8, 32, 4, seed=0, prompt_len_max=256)
    b = serving.make_requests(8, 32, 4, seed=0, prompt_len_max=256)
    assert [r.prompt for r in a] == [r.prompt for r in b]
    assert all(32 <= len(r.prompt) <= 256 for r in a)
    assert all(1 <= t < 30000 for r in a for t in r.prompt)


@pytest.mark.parametrize("kinds", [("w4a8", "bf16"), ("int8", "bf16"),
                                   ("int4", "bf16"), ("w4a8", "int8")])
def test_cli_runs_on_the_cpu_when_asked(capsys, kinds):
    stats = serving.main(["--weight-kind", kinds[0], "--cache-kind",
                          kinds[1], "--d-model", "64",
                          "--n-heads", "4", "--n-kv-heads", "2",
                          "--n-layers", "1", "--max-seq", "64",
                          "--requests", "3", "--slots", "2",
                          "--prompt-len", "4", "--prompt-len-max", "9",
                          "--max-new", "5", "--device", "cpu"])
    assert stats["tokens"] == 15
    assert "tok/s" in capsys.readouterr().out
