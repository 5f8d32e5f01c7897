"""Port parity: the paged engine against the JAX package's.

Each case of the reference's ``tests/test_paged_serving.py`` (but the mesh
and ``decode_tokens_per_sec`` ones, not ported) runs on the JAX
``ServingEngine(use_pallas=False)`` and on the port's ``ServingEngine`` on
the CPU, greedy, on the same weights (``convert.params_from_jax``), for
fp32, w4a8, int8 and int4 weights over bf16 page pools and for w4a8
weights over KV8 pools. Tolerance: none, the token streams must be
IDENTICAL; so must the allocator's counts after the run (free list,
cached pages, refcounts, prefix hits), which the reference's tests
assert.

Cases: the paged engine (and its free list and tables after the run),
a pool smaller than the slots' reach (cache_pages=6), preemption
(cache_pages=4, window 4), a pool too small for one request
(RuntimeError), window invariance, the prefix cache (16 hit tokens,
a mixed hit and fresh batch, LRU eviction in a 3-page pool), and chunked
prefill (chunks of 4, 8 and 64, with and without the paged pool and the
prefix cache). Last, an engine call the reference gets wrong (ROADMAP
C.4): a prefix-hit suffix whose bucket padding passes the block table.
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
PROMPTS = [[3, 5, 7], [11, 2], [40, 41, 42, 43]]
SHARED = list(range(1, 17))                       # two pages of 8
PREFIX_PROMPTS = [SHARED + [20], [40, 41, 42], SHARED + [30]]

# (weight kind, cache kind) of each engine pair
ENGINES = {"fp32": ("fp32", "bf16"), "w4a8": ("w4a8", "bf16"),
           "int8": ("int8", "bf16"), "int4": ("int4", "bf16"),
           "w4a8-kv8": ("w4a8", "int8")}


class Pair:
    """The JAX and the port engine factories on one model."""

    def __init__(self, kind, cache_kind):
        self.jcfg = jllama.LlamaConfig(**CFG, weight_kind=kind)
        self.cfg = llama.LlamaConfig(**CFG, weight_kind=kind)
        self.jparams = jllama.init_params(jax.random.PRNGKey(7), self.jcfg)
        self.params = convert.params_from_jax(
            jax.tree.map(np.asarray, self.jparams), "cpu")
        self.cache_kind = cache_kind

    def engines(self, slots=2, **kw):
        jeng = jserving.ServingEngine(self.jcfg, self.jparams,
                                      batch_slots=slots, use_pallas=False,
                                      cache_kind=self.cache_kind, **kw)
        eng = serving.ServingEngine(self.cfg, self.params, batch_slots=slots,
                                    device="cpu", cache_kind=self.cache_kind,
                                    **kw)
        return jeng, eng

    def port_run(self, prompts, max_new, slots=2, **kw):
        """The port's engine alone -> its outs."""
        eng = serving.ServingEngine(self.cfg, self.params, batch_slots=slots,
                                    device="cpu", cache_kind=self.cache_kind,
                                    **kw)
        return [r.out for r in eng.run([
            serving.Request(uid=i, prompt=list(p), max_new=max_new)
            for i, p in enumerate(prompts)])]

    def run(self, prompts, max_new, slots=2, window=8, **kw):
        """Both engines serve the prompts -> (JAX outs, port outs, port
        engine)."""
        jeng, eng = self.engines(slots, **kw)
        ref = jeng.run([jserving.Request(uid=i, prompt=list(p),
                                         max_new=max_new)
                        for i, p in enumerate(prompts)], window=window)
        done = eng.run([serving.Request(uid=i, prompt=list(p),
                                        max_new=max_new)
                        for i, p in enumerate(prompts)], window=window)
        assert all(r.done and len(r.out) == max_new for r in done)
        return [r.out for r in ref], [r.out for r in done], eng, jeng


@pytest.fixture(scope="module", params=list(ENGINES))
def pair(request):
    return Pair(*ENGINES[request.param])


def _accounting(eng, jeng):
    """No live slot holds pages: every page is free or cached, every
    refcount is 0, and the counts are the reference's."""
    assert not any(eng.slot_pages)
    assert (eng.table_np == 0).all()
    assert len(eng._free) + len(eng._cached) == eng.n_pages - 1
    if eng.prefix_cache:
        assert (eng._refcount == 0).all()
    assert (len(eng._free), len(eng._cached), eng.prefix_hit_tokens) == (
        len(jeng._free), len(jeng._cached), jeng.prefix_hit_tokens)


def test_paged_engine_equals_jax(pair):
    ref, got, eng, jeng = pair.run(PROMPTS, 6, paged=True, page=8)
    assert got == ref
    assert len(eng._free) == eng.n_pages - 1
    _accounting(eng, jeng)
    assert pair.port_run(PROMPTS, 6) == got    # the contiguous engine's


def test_pool_below_the_slots_reach_serves(pair):
    prompts = [[i + 1, i + 2] for i in range(4)]
    ref, got, eng, jeng = pair.run(prompts, 4, paged=True, page=8,
                                   cache_pages=6)
    assert got == ref
    assert len(eng._free) == 5
    _accounting(eng, jeng)


def test_preemption_keeps_the_stream(pair, monkeypatch):
    """Two slots of 3 + 16 tokens need 6 pages; the pool has 3. The
    newest slot is preempted and resumes by recompute."""
    preempted = []
    original = serving.ServingEngine._preempt_newest

    def counting(self, protect, queue):
        ok = original(self, protect, queue)
        preempted.append(ok)
        return ok
    monkeypatch.setattr(serving.ServingEngine, "_preempt_newest", counting)
    ref, got, eng, jeng = pair.run([[3, 5, 7], [11, 2]], 16, window=4,
                                   paged=True, page=8, cache_pages=4)
    assert got == ref
    assert any(preempted)
    assert len(eng._free) == 3
    _accounting(eng, jeng)


def test_pool_too_small_raises(pair):
    _, eng = pair.engines(slots=1, paged=True, page=8, cache_pages=3)
    with pytest.raises(RuntimeError, match="pages"):
        eng.run([serving.Request(uid=0, prompt=list(range(1, 18)),
                                 max_new=8)])


def test_window_invariance(pair):
    prompts = [[9, 8, 7], [1, 2, 3, 4]]
    ref, got, _, _ = pair.run(prompts, 5, window=4, paged=True, page=8)
    assert got == ref
    _, eng = pair.engines(paged=True, page=8)
    one = eng.run([serving.Request(uid=i, prompt=list(p), max_new=5)
                   for i, p in enumerate(prompts)], window=1)
    assert [r.out for r in one] == ref


def test_prefix_cache_reuses_pages(pair):
    """The second prompt attaches the first one's two full pages (16
    tokens) and prefills one token."""
    prompts = [SHARED + [20], SHARED + [30]]
    jeng, eng = pair.engines(slots=1, paged=True, page=8, prefix_cache=True)
    for i, p in enumerate(prompts):
        ref = jeng.run([jserving.Request(uid=i, prompt=list(p),
                                         max_new=5)])[0].out
        got = eng.run([serving.Request(uid=i, prompt=list(p),
                                       max_new=5)])[0].out
        assert got == ref, (i, got, ref)
    assert eng.prefix_hit_tokens == 16
    _accounting(eng, jeng)


def test_prefix_cache_mixed_batch(pair):
    """A hit and a fresh prompt in one admission pass."""
    ref, got, eng, jeng = pair.run(PREFIX_PROMPTS, 4, paged=True, page=8,
                                   prefix_cache=True)
    assert got == ref
    assert eng.prefix_hit_tokens >= 16
    _accounting(eng, jeng)


def test_prefix_cache_lru_eviction(pair):
    """A 3-page pool: cached prefixes are evicted when a request needs
    live pages."""
    jeng, eng = pair.engines(slots=1, paged=True, page=8, cache_pages=4,
                             prefix_cache=True)
    for i in range(6):
        p = list(range(1, 10)) + [20 + i]
        ref = jeng.run([jserving.Request(uid=i, prompt=list(p),
                                         max_new=3)])[0].out
        got = eng.run([serving.Request(uid=i, prompt=list(p),
                                       max_new=3)])[0].out
        assert got == ref, (i, got, ref)
    _accounting(eng, jeng)


CHUNK_MODES = {"contiguous": dict(), "paged+prefix": dict(
    paged=True, page=8, prefix_cache=True)}


@pytest.mark.parametrize("mode", sorted(CHUNK_MODES))
@pytest.mark.parametrize("chunk", [4, 8, 64])
def test_chunked_prefill_equals_jax(pair, chunk, mode):
    """Chunks smaller than, equal to and larger than the prompts; the
    stream equals whole-prompt admission's."""
    prompts = ([[3, 5, 7, 9, 2, 4, 6, 1, 8], [11, 2], list(range(1, 14))]
               if mode == "contiguous" else PREFIX_PROMPTS)
    kw = CHUNK_MODES[mode]
    ref, got, eng, jeng = pair.run(prompts, 6, prefill_chunk=chunk, **kw)
    assert got == ref
    assert pair.port_run(prompts, 6, **kw) == got
    if kw:
        assert eng.prefix_hit_tokens >= 16
        _accounting(eng, jeng)


def test_native_allocator_serves_the_same_stream():
    p = Pair("fp32", "bf16")
    ref, got, _, jeng = p.run(PREFIX_PROMPTS, 4, paged=True, page=8,
                              prefix_cache=True)
    _, eng = p.engines(paged=True, page=8, prefix_cache=True,
                       alloc_backend="native")
    done = eng.run([serving.Request(uid=i, prompt=list(q), max_new=4)
                    for i, q in enumerate(PREFIX_PROMPTS)])
    assert [r.out for r in done] == ref == got
    assert (eng.alloc.free_pages, eng.alloc.cached_pages,
            eng.prefix_hit_tokens) == (len(jeng._free), len(jeng._cached),
                                       jeng.prefix_hit_tokens)


def test_padding_past_the_table_keeps_live_rows():
    """ROADMAP C.4: the second prompt (25 tokens) attaches one cached
    page and prefills 17 tokens from position 8 in a 32-token bucket, so
    positions 32 .. 39 pass the 32-position table. The reference clips
    them into the slot's last page over live positions 24 .. 31 and its
    stream leaves its contiguous engine's; the port sends them to the
    trash page and keeps the contiguous stream."""
    p = Pair("fp32", "bf16")
    first = list(range(1, 9)) + [50]
    second = list(range(1, 9)) + [(7 * i) % 60 + 2 for i in range(17)]
    outs = {}
    for label, kw in (("contiguous", {}), ("paged", dict(
            paged=True, page=8, prefix_cache=True))):
        jeng, eng = p.engines(slots=1, **kw)
        outs[label] = [
            (jeng.run([jserving.Request(uid=i, prompt=list(q),
                                        max_new=4)])[0].out,
             eng.run([serving.Request(uid=i, prompt=list(q),
                                      max_new=4)])[0].out)
            for i, q in enumerate((first, second))]
        if kw:
            assert eng.prefix_hit_tokens == jeng.prefix_hit_tokens == 8
    (jc1, pc1), (jc2, pc2) = outs["contiguous"]
    (jp1, pp1), (jp2, pp2) = outs["paged"]
    assert jc1 == pc1 == jp1 == pp1 and jc2 == pc2
    assert pp2 == pc2
    assert jp2 != jc2


@pytest.mark.parametrize("flags", [
    ["--paged", "--page", "8", "--prefix-cache", "--prefill-chunk", "4"],
    ["--paged", "--page", "8", "--cache-pages", "5", "--alloc-backend",
     "native", "--cache-kind", "int8"]])
def test_cli_serves_paged_on_the_cpu(capsys, flags):
    stats = serving.main(["--weight-kind", "w4a8", "--d-model", "64",
                          "--n-heads", "4", "--n-kv-heads", "2",
                          "--n-layers", "1", "--max-seq", "64",
                          "--requests", "3", "--slots", "2",
                          "--prompt-len", "4", "--prompt-len-max", "12",
                          "--max-new", "5", "--device", "cpu", *flags])
    assert stats["tokens"] == 15
    assert "paged pool" in capsys.readouterr().out
