"""In-place row writes into a contiguous KV cache (kernel ``kv_update``).

Counterpart: ``how_to_optimize_gemm_tpu/ops/pallas_kv_update.py``
(``kv_update``, kernel ``_kernel_contig``). ``cache`` (B, T, *rest) gets
``new`` (B, S, *rest), cast to the cache's dtype, at per-slot start
positions ``pos``: row i of slot b lands at ``cache[b, pos[b] + i]``.
Rows with ``pos[b] + i`` outside [0, T) are dropped one by one, and slots
whose ``write_mask`` entry is False keep their rows. The write is IN
PLACE on ``cache``, which is returned; nothing else of the cache is read
or copied.

The TPU's ``kernel_supported`` layout rule (128-lane rows, sublane
packing) is a Mosaic rule and has no counterpart: the CUDA kernel copies
any row width.

``kv_update`` launches ``csrc/kv_update.cu`` for CUDA tensors and runs its
plain version ``kv_update_ref`` only for CPU tensors; both write the same
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
