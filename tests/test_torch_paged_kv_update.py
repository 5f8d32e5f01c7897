"""Port parity: the paged KV-pool write against the JAX package's.

The same numpy pool and rows go through ``pallas_kv_update.paged_kv_update``
(Pallas in interpret mode) and the port's ``paged_kv_update`` on the CPU
(its plain version), for bf16 value rows, int8 value rows and fp32 scale
rows, one or four rows a slot, with and without a write mask, with rows
aimed at the trash page 0 (which both skip). The port's scale rows are
(KVH,); the reference pads them to 128 lanes, so its pool and rows are
padded and its result cropped. Tolerance: none, the pools must be EQUAL,
byte for byte.

``llama._update_paged_cache`` is held to the JAX ``_update_paged_cache``
on both routes: ``use_pallas=False`` (an indexing write that sends masked
slots and unallocated chunks to page 0) and the kernel route. Where bucket
padding passes the table, the reference clips it into the slot's last
page and overwrites live rows there; the port sends it to page 0 (ROADMAP
C.4), which a test shows. The last test holds what the paged engine
hands the kernel's wrapper: rows of the pool's dtype, contiguous, and
int32 contiguous pages and offsets, so that on the card the call launches
the kernel alone.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.models import llama as jllama
from how_to_optimize_gemm_tpu.ops import pallas_kv_update as jkvu
from how_to_optimize_gemm_tpu_torch import convert
from how_to_optimize_gemm_tpu_torch.models import llama
from how_to_optimize_gemm_tpu_torch.ops import kv_update
from how_to_optimize_gemm_tpu_torch.parallel import serving

torch.set_num_threads(1)

NP, PS, KVH, D, B = 6, 16, 2, 128, 3
LANES = 128


def _pool_and_rows(kind, s, seed):
    """(JAX pool, JAX rows, port pool, port rows) of one row kind; the
    JAX scale pool and rows are padded to 128 lanes."""
    rng = np.random.default_rng(seed)
    if kind == "fp32 scales":
        pool = rng.random((NP, PS, KVH)).astype(np.float32)
        new = rng.random((B, s, KVH)).astype(np.float32)
        pad = ((0, 0), (0, 0), (0, LANES - KVH))
        return (jnp.asarray(np.pad(pool, pad)), jnp.asarray(np.pad(new, pad)),
                torch.from_numpy(pool), torch.from_numpy(new))
    if kind == "int8":
        pool = rng.integers(-127, 128, (NP, PS, KVH, D), dtype=np.int8)
        new = rng.integers(-127, 128, (B, s, KVH, D), dtype=np.int8)
        return (jnp.asarray(pool), jnp.asarray(new), torch.from_numpy(pool),
                torch.from_numpy(new))
    pool = jnp.asarray(rng.standard_normal((NP, PS, KVH, D)), jnp.bfloat16)
    new = rng.standard_normal((B, s, KVH, D)).astype(np.float32)
    return (pool, jnp.asarray(new),
            convert.params_from_jax(np.asarray(pool), "cpu"),
            torch.from_numpy(new))


def _port_array(x, kind):
    x = np.asarray(x)
    if kind == "fp32 scales":
        x = np.ascontiguousarray(x[..., :KVH])
    return convert.params_from_jax(x, "cpu")


# (pages, offsets) of each slot's rows: distinct live (page, offset)
# pairs, and rows on the trash page 0
ROWS = {1: ([[3], [0], [5]], [[7], [2], [15]]),
        4: ([[1, 1, 4, 0], [2, 2, 2, 2], [0, 5, 5, 3]],
            [[14, 15, 0, 3], [0, 1, 2, 3], [9, 10, 11, 12]])}


@pytest.mark.parametrize("mask", [None, [True, False, True]])
@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("kind", ["bf16", "int8", "fp32 scales"])
def test_paged_kv_update_equals_jax(kind, s, mask):
    jpool, jnew, pool, new = _pool_and_rows(kind, s, s)
    pages = np.asarray(ROWS[s][0], np.int32)
    offs = np.asarray(ROWS[s][1], np.int32)
    wm = None if mask is None else np.asarray(mask)
    ref = jkvu.paged_kv_update(jpool, jnew, jnp.asarray(pages),
                               jnp.asarray(offs),
                               None if wm is None else jnp.asarray(wm),
                               interpret=True)
    before = pool.clone()
    got = kv_update.paged_kv_update(pool, new, torch.from_numpy(pages),
                                    torch.from_numpy(offs),
                                    None if wm is None
                                    else torch.from_numpy(wm))
    assert got is pool                              # in place
    assert torch.equal(got, _port_array(ref, kind))
    assert torch.equal(got[0], before[0])           # the trash page
    assert not torch.equal(got, before)


def _table():
    """Slot 0 holds pages 2, 4; slot 1 pages 1, 3, 5; slot 2 page 0
    (nothing allocated): np_max 3, 48 positions a slot."""
    return np.asarray([[2, 4, 0], [1, 3, 5], [0, 0, 0]], np.int32)


@pytest.mark.parametrize("kernel_route", [False, True])
@pytest.mark.parametrize("pos,s,mask", [
    ([5, 30, 0], 1, None),
    ([15, 14, 3], 4, [True, False, True]),     # crosses a page boundary
    (0, 12, None),                             # scalar position
    ([16, 20, 1], 12, [True, True, False]),
])
def test_update_paged_cache_equals_jax(pos, s, mask, kernel_route):
    """Positions inside the table; at most one slot writes page 0, so no
    two rows share a (page, offset). The kernel route takes at most 8
    rows (the reference's), so s = 12 runs the indexing write on both."""
    jpool, jnew, pool, new = _pool_and_rows("bf16", s, 11)
    table = _table()
    jpos = jnp.asarray(pos, jnp.int32)
    wm = None if mask is None else np.asarray(mask)
    ref = jllama._update_paged_cache(
        jpool, jnew, jpos, jnp.asarray(table),
        None if wm is None else jnp.asarray(wm), use_pallas=kernel_route)
    tpos = pos if isinstance(pos, int) else torch.tensor(pos)
    got = llama._update_paged_cache(
        pool, new, tpos, torch.from_numpy(table),
        None if wm is None else torch.from_numpy(wm), kernels=kernel_route)
    assert torch.equal(got, _port_array(ref, "bf16"))


def test_padding_past_the_table_goes_to_the_trash_page():
    """A 12-token window at position 40 of a 48-position table: rows at
    48 .. 51 pass the table. The reference clips their chunk to the last
    one and writes them over offsets 0 .. 3 of the slot's last page (page
    5), which hold its live positions 32 .. 35; the port writes them to
    page 0 and keeps those rows (ROADMAP C.4)."""
    jpool, jnew, pool, new = _pool_and_rows("bf16", 12, 12)
    table = _table()
    pos = np.asarray([0, 40, 0], np.int32)
    wm = np.asarray([False, True, False])
    ref = np.asarray(jllama._update_paged_cache(
        jpool, jnew, jnp.asarray(pos), jnp.asarray(table), jnp.asarray(wm),
        use_pallas=False))
    before = pool.clone()
    got = llama._update_paged_cache(pool, new, torch.from_numpy(pos),
                                    torch.from_numpy(table),
                                    torch.from_numpy(wm))
    rows = new[1].to(torch.bfloat16)
    assert torch.equal(got[5, 8:16], rows[:8])           # positions 40..47
    assert torch.equal(got[5, :8], before[5, :8])        # 32..39 kept
    assert torch.equal(_port_array(ref, "bf16")[5, :4], rows[8:12])


# a tiny model for the engine (tests/test_torch_paged_serving.py's)
CFG = dict(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq=32)
PROMPTS = [[3, 5, 7], [11, 2], [40, 41, 42, 43]]


@pytest.mark.parametrize("cache_kind", ["bf16", "int8"])
def test_engine_hands_the_kernel_its_rows_as_they_lie(cache_kind,
                                                      monkeypatch):
    """The paged engine on its kernel route (on the CPU the wrappers' plain
    versions), over a bf16 pool and a KV8 pool's values and scales: every
    ``paged_kv_update`` call gets new rows of the pool's dtype, contiguous,
    (B, S) int32 contiguous pages and offsets, and no mask, so on the card
    the wrapper converts nothing and launches its kernel alone."""
    cfg = llama.LlamaConfig(**CFG, weight_kind="w4a8")
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    calls = []
    real = llama.paged_kv_update

    def record(pool, new, pages, offs, write_mask=None):
        calls.append((new.dtype == pool.dtype, new.is_contiguous(),
                      pages.dtype, offs.dtype, pages.is_contiguous(),
                      offs.is_contiguous(), tuple(pages.shape) ==
                      tuple(new.shape[:2]), write_mask))
        return real(pool, new, pages, offs, write_mask)
    monkeypatch.setattr(llama, "paged_kv_update", record)
    eng = serving.ServingEngine(cfg, params, batch_slots=2, device="cpu",
                                cache_kind=cache_kind, paged=True,
                                kernel_routes=True)
    eng.run([serving.Request(uid=i, prompt=list(p), max_new=4)
             for i, p in enumerate(PROMPTS)])
    pools = 2 * (2 if cache_kind == "int8" else 1)   # K and V (and scales)
    assert len(calls) >= pools * CFG["n_layers"] * 3
    assert set(calls) == {(True, True, torch.int32, torch.int32, True, True,
                           True, None)}
