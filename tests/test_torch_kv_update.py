"""Port parity: the in-place KV-cache write against the JAX package's.

The same numpy cache and rows go through ``pallas_kv_update.kv_update``
(Pallas in interpret mode) and the port's ``kv_update`` on the CPU (its
plain version). Tolerance: none, the caches must be EQUAL, byte for byte.
The port's ``llama._update_cache`` is also held to the JAX
``_update_cache`` (``use_pallas=False``) on its indexing branches, whose
edge semantics differ from the kernel's (a window's start is clamped
rather than its rows dropped).
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
