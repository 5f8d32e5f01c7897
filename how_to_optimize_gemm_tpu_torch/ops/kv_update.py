"""In-place row writes into a KV cache: contiguous (kernel ``kv_update``)
and paged (kernel ``paged_kv_update``).

Counterpart: ``how_to_optimize_gemm_tpu/ops/pallas_kv_update.py``.

- ``kv_update`` (kernel ``_kernel_contig``): ``cache`` (B, T, *rest) gets
  ``new`` (B, S, *rest), cast to the cache's dtype, at per-slot start
  positions ``pos``: row i of slot b lands at ``cache[b, pos[b] + i]``.
  Rows with ``pos[b] + i`` outside [0, T) are dropped one by one.
- ``paged_kv_update`` (kernel ``_kernel_paged``): ``pool`` (NP, PS,
  *rest) gets ``new`` (B, S, *rest) at physical (page, offset) pairs:
  row i of slot b lands at ``pool[pages[b, i], offs[b, i]]``. Rows whose
  page is 0 (the trash page: masked slots, unallocated chunks) are
  skipped rather than written, as the TPU kernel skips them; so are rows
  outside [1, NP) x [0, PS), which no engine call produces.

In both, slots whose ``write_mask`` entry is False keep their rows, and
the write is IN PLACE on the cache or pool, which is returned; nothing
else of it is read or copied. The TPU's ``kernel_supported`` layout rule
(128-lane rows, sublane packing) is a Mosaic rule and has no counterpart:
the CUDA kernels copy any row width (bf16 values, int8 values, fp32 scale
rows of KVH).

Each wrapper launches its kernel (``csrc/kv_update.cu``,
``csrc/paged_kv_update.cu``) for CUDA tensors and runs its plain version
(``*_ref``) only for CPU tensors; kernel and plain version write the same
bytes.
"""
from __future__ import annotations

import math

import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops.int8 import require_cuda


def _slot_vector(x, b: int, device, dtype) -> torch.Tensor:
    """A scalar or (B,) position / mask as a (B,) tensor on ``device``."""
    t = torch.as_tensor(x, device=device)
    if t.dim() == 0:
        t = t.expand(b)
    if tuple(t.shape) != (b,):
        raise ValueError(f"expected a scalar or ({b},), got {tuple(t.shape)}")
    return t.to(dtype)


def kv_update_ref(cache, new, pos, write_mask=None):
    """Plain version of ``kv_update``: the same rows, written in place
    with tensor indexing."""
    b, t = cache.shape[:2]
    posv = _slot_vector(pos, b, cache.device, torch.int64)
    mask = (torch.ones(b, dtype=torch.bool, device=cache.device)
            if write_mask is None
            else _slot_vector(write_mask, b, cache.device, torch.bool))
    new = new.to(cache.dtype)
    for i in range(new.shape[1]):
        p = posv + i
        rows = (mask & (p >= 0) & (p < t)).nonzero()[:, 0]
        cache[rows, p[rows]] = new[rows, i]
    return cache


def kv_update(cache, new, pos, write_mask=None):
    """cache[b, pos[b] + i] = new[b, i] for each in-range row of each
    unmasked slot, IN PLACE; returns ``cache``.

    cache (B, T, *rest) contiguous, new (B, S, *rest) of any float dtype
    (cast to the cache's), pos an int or (B,) ints, write_mask None or
    (B,) bools."""
    if cache.device.type == "cpu":
        return kv_update_ref(cache, new, pos, write_mask)
    require_cuda("kv_update", cache)
    b, t = cache.shape[:2]
    s = new.shape[1]
    if new.shape[0] != b or new.shape[2:] != cache.shape[2:]:
        raise ValueError(f"kv_update: new {tuple(new.shape)} does not fit "
                         f"cache {tuple(cache.shape)}")
    if not cache.is_contiguous():
        raise ValueError("kv_update: the cache must be contiguous")
    if new.device != cache.device:
        raise ValueError(f"kv_update: new rows on {new.device}, cache on "
                         f"{cache.device}")
    new = new.to(cache.dtype).contiguous()
    posv = _slot_vector(pos, b, cache.device, torch.int32)
    mask = (None if write_mask is None
            else _slot_vector(write_mask, b, cache.device, torch.int32))
    row_bytes = math.prod(cache.shape[2:]) * cache.element_size()
    if b and s and row_bytes:
        _build.launch("kv_update", cache.device, cache, new, posv, mask,
                      b, t, s, row_bytes)
    return cache


def paged_kv_update_ref(pool, new, pages, offs, write_mask=None):
    """Plain version of ``paged_kv_update``: the same rows, written in
    place with tensor indexing (no two live rows share a (page, offset)
    in an engine call)."""
    n_pages, ps = pool.shape[:2]
    pages = torch.as_tensor(pages, device=pool.device).to(torch.int64)
    offs = torch.as_tensor(offs, device=pool.device).to(torch.int64)
    live = (pages > 0) & (pages < n_pages) & (offs >= 0) & (offs < ps)
    if write_mask is not None:
        live &= _slot_vector(write_mask, pages.shape[0], pool.device,
                             torch.bool)[:, None]
    pool[pages[live], offs[live]] = new.to(pool.dtype)[live]
    return pool


def paged_kv_update(pool, new, pages, offs, write_mask=None):
    """pool[pages[b, i], offs[b, i]] = new[b, i] for every row whose page
    is not 0 of every unmasked slot, IN PLACE; returns ``pool``.

    pool (NP, PS, *rest) contiguous, new (B, S, *rest) of any float dtype
    (cast to the pool's), pages and offs (B, S) ints, write_mask None or
    (B,) bools. With ``new`` of the pool's dtype and contiguous, pages and
    offs contiguous int32 and no mask (the engine's call,
    ``llama._write_paged``) the call launches the kernel and nothing
    else."""
    if pool.device.type == "cpu":
        return paged_kv_update_ref(pool, new, pages, offs, write_mask)
    require_cuda("paged_kv_update", pool)
    b, s = new.shape[:2]
    n_pages, ps = pool.shape[:2]
    if new.shape[2:] != pool.shape[2:] or tuple(pages.shape) != (b, s) \
            or tuple(offs.shape) != (b, s):
        raise ValueError(f"paged_kv_update: new {tuple(new.shape)}, pages "
                         f"{tuple(pages.shape)}, offs {tuple(offs.shape)} do "
                         f"not fit pool {tuple(pool.shape)}")
    if not pool.is_contiguous():
        raise ValueError("paged_kv_update: the pool must be contiguous")
    for x in (new, pages, offs):
        if x.device != pool.device:
            raise ValueError(f"paged_kv_update: an operand on {x.device}, "
                             f"pool on {pool.device}")
    # each a no-op (no launch) on what already has that dtype and layout
    new = new.to(pool.dtype).contiguous()
    pages = pages.to(torch.int32).contiguous()
    offs = offs.to(torch.int32).contiguous()
    mask = (None if write_mask is None
            else _slot_vector(write_mask, b, pool.device, torch.int32))
    row_bytes = math.prod(pool.shape[2:]) * pool.element_size()
    if b and s and row_bytes:
        _build.launch("paged_kv_update", pool.device, pool, new, pages, offs,
                      mask, b, s, n_pages, ps, row_bytes)
    return pool
