"""Port parity: the in-place KV-cache write against the JAX package's.

The same numpy cache and rows go through ``pallas_kv_update.kv_update``
(Pallas in interpret mode) and the port's ``kv_update`` on the CPU (its
plain version). Tolerance: none, the caches must be EQUAL, byte for byte.
The port's ``llama._update_cache`` is also held to the JAX
``_update_cache`` (``use_pallas=False``) on its indexing branches, whose
edge semantics differ from the kernel's (a window's start is clamped
rather than its rows dropped). ``paged_kv_update``'s plain version is
held to the JAX ``paged_kv_update`` (interpret mode) at S = 8 with int32
and int64 pages and offsets, a trash-page row and a masked slot (EQUAL),
and on a row past the pool's last page, which the port skips and the
JAX kernel in interpret mode writes to the clamped last page.
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

torch.set_num_threads(1)

B, T, KVH, D = 3, 64, 2, 128


def _cache_and_rows(s, seed, dtype=jnp.bfloat16):
    rng = np.random.default_rng(seed)
    cache = jnp.asarray(rng.standard_normal((B, T, KVH, D)), dtype)
    new = rng.standard_normal((B, s, KVH, D)).astype(np.float32)
    port_cache = convert.params_from_jax(np.asarray(cache), "cpu")
    return cache, new, port_cache


CASES = {
    # slot positions: in range, negative, past T, crossing T
    "in_range": [0, 17, T - 4],
    "edges": [-2, T - 2, T],
    "far": [-9, 5, T + 3],
}


@pytest.mark.parametrize("mask", [None, [True, False, True]])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("s", [1, 4])
def test_kv_update_equals_jax(s, case, mask):
    cache, new, port_cache = _cache_and_rows(s, s)
    pos = np.asarray(CASES[case], np.int32)
    wm = None if mask is None else np.asarray(mask)
    ref = jkvu.kv_update(cache, jnp.asarray(new), jnp.asarray(pos),
                         None if wm is None else jnp.asarray(wm),
                         interpret=True)
    got = kv_update.kv_update(port_cache, torch.from_numpy(new),
                              torch.from_numpy(pos),
                              None if wm is None else torch.from_numpy(wm))
    assert got is port_cache                     # in place
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, convert.params_from_jax(np.asarray(ref), "cpu"))


def test_kv_update_scalar_position():
    cache, new, port_cache = _cache_and_rows(2, 5)
    ref = jkvu.kv_update(cache, jnp.asarray(new), 5, interpret=True)
    got = kv_update.kv_update(port_cache, torch.from_numpy(new), 5)
    assert torch.equal(got, convert.params_from_jax(np.asarray(ref), "cpu"))


@pytest.mark.parametrize("pos,mask", [
    (7, None),                                    # scalar: clamped start
    ([-1, T - 3, 2], None),                       # S > 1: wrap + clamp
    ([-1, T - 3, 2], [True, False, True]),
])
def test_update_cache_indexing_branch_equals_jax(pos, mask):
    """S = 12 rows (over the kernel's 8): the reference's
    dynamic_update_slice, whose start wraps once if negative and is then
    clamped to [0, T - S]."""
    cache, new, port_cache = _cache_and_rows(12, 7)
    jpos = jnp.asarray(pos, jnp.int32)
    wm = None if mask is None else np.asarray(mask)
    ref = jllama._update_cache(cache, jnp.asarray(new), jpos,
                               None if wm is None else jnp.asarray(wm),
                               use_pallas=False)
    tpos = pos if isinstance(pos, int) else torch.tensor(pos,
                                                         dtype=torch.int32)
    got = llama._update_cache(port_cache, torch.from_numpy(new), tpos,
                              None if wm is None else torch.from_numpy(wm))
    assert torch.equal(got, convert.params_from_jax(np.asarray(ref), "cpu"))


def test_update_cache_scatter_branch_equals_jax():
    """S = 1 with per-slot positions: the reference's scatter, where a
    negative position wraps once and one still out of range is dropped."""
    cache, new, port_cache = _cache_and_rows(1, 8)
    pos = np.asarray([-1, T, -T - 1], np.int32)
    ref = jllama._update_cache(cache, jnp.asarray(new), jnp.asarray(pos),
                               use_pallas=False)
    got = llama._update_cache(port_cache, torch.from_numpy(new),
                              torch.from_numpy(pos))
    assert torch.equal(got, convert.params_from_jax(np.asarray(ref), "cpu"))


def test_kv_update_refuses_other_devices():
    cache = torch.zeros((B, T, KVH, D), dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError):
        kv_update.kv_update(cache, torch.zeros((B, 1, KVH, D),
                                               device="meta"), 0)


# paged_kv_update's plain version against the JAX kernel (interpret mode)
# at S = 8, the most rows the engine's kernel route takes: a bf16 pool of
# NP pages of PS rows, a trash-page row and a masked slot skipped by both
NP, PS = 5, 16


def _paged(dtype, seed):
    rng = np.random.default_rng(seed)
    pool = jnp.asarray(rng.standard_normal((NP, PS, KVH, D)), jnp.bfloat16)
    new = rng.standard_normal((B, 8, KVH, D)).astype(np.float32)
    # slot b's rows on page b + 1 at offsets 2 b .. 2 b + 7; slot 1's row 3
    # on the trash page
    pages = np.repeat(np.arange(1, B + 1), 8).reshape(B, 8).astype(dtype)
    pages[1, 3] = 0
    offs = (np.arange(8)[None] + 2 * np.arange(B)[:, None]).astype(dtype)
    return pool, new, pages, offs


@pytest.mark.parametrize("mask", [None, [True, False, True]])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_paged_kv_update_ref_equals_jax_at_eight_rows(dtype, mask):
    """int32 or int64 (B, 8) pages and offsets (JAX takes them as int32):
    EQUAL, page 0 left as it was."""
    pool, new, pages, offs = _paged(dtype, 3)
    wm = None if mask is None else np.asarray(mask)
    ref = jkvu.paged_kv_update(pool, jnp.asarray(new),
                               jnp.asarray(pages.astype(np.int32)),
                               jnp.asarray(offs.astype(np.int32)),
                               None if wm is None else jnp.asarray(wm),
                               interpret=True)
    port = convert.params_from_jax(np.asarray(pool), "cpu")
    before = port.clone()
    got = kv_update.paged_kv_update_ref(
        port, torch.from_numpy(new), torch.from_numpy(pages),
        torch.from_numpy(offs), None if wm is None else torch.from_numpy(wm))
    assert got is port
    assert torch.equal(got, convert.params_from_jax(np.asarray(ref), "cpu"))
    assert torch.equal(got[0], before[0])
    assert torch.equal(kv_update.paged_kv_update(
        before.clone(), torch.from_numpy(new), torch.from_numpy(pages),
        torch.from_numpy(offs), None if wm is None else torch.from_numpy(wm)),
        got)


def test_paged_kv_update_ref_skips_a_row_past_np():
    """A row aimed at page NP (no engine call makes one): the port skips it
    and keeps every page; the JAX kernel in interpret mode clamps the page
    to NP - 1 and writes there (on the TPU the copy would run past the
    pool). Every other row EQUAL."""
    pool, new, pages, offs = _paged(np.int32, 4)
    pages[2, 7] = NP
    ref = np.asarray(jkvu.paged_kv_update(
        pool, jnp.asarray(new), jnp.asarray(pages), jnp.asarray(offs),
        interpret=True))
    port = convert.params_from_jax(np.asarray(pool), "cpu")
    before = port.clone()
    got = kv_update.paged_kv_update_ref(port, torch.from_numpy(new),
                                        torch.from_numpy(pages),
                                        torch.from_numpy(offs))
    ref = convert.params_from_jax(ref, "cpu")
    clamped = (NP - 1, int(offs[2, 7]))
    assert torch.equal(ref[clamped],
                       torch.from_numpy(new[2, 7]).to(torch.bfloat16))
    assert torch.equal(got[clamped], before[clamped])
    got[clamped] = ref[clamped]
    assert torch.equal(got, ref)
