"""Carry the reference's operands and weights into the port.

This module imports no JAX: its inputs are the JAX package's outputs
already converted to numpy arrays (``np.asarray`` on each leaf).

- ``from_jax_prepared`` takes a ladder rung's ``Rung.prepare`` output
  and returns the port's prepared tuple for the same rung;
- ``params_from_jax`` takes a ``models/llama.init_params`` tree (every
  weight kind: fp32, bf16, int8, packed int4 and w4a8 linears) and
  returns the port's tree;
- ``kv_cache_from_jax`` takes a ``models/llama.init_kv_cache`` cache,
  bf16 or KV8, and returns the port's; ``paged_cache_from_jax`` does the
  same for an ``init_paged_kv_cache`` pool;
- ``to_device`` moves a port tree to another device.

Layouts and dtypes are kept (packed int4 bytes are copied byte for
byte), so both packages can be run on identical operands.
"""
from __future__ import annotations

import numpy as np
import torch

# Prepared-tuple dtypes per rung; ``int`` marks a Python int kept as is.
_F32, _BF16 = (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)
_LAYOUTS = {
    "00_naive_vpu": _F32,
    "01_xla_fp32": _F32,
    "02_pallas_mn_tile": _F32,
    "03_pallas_k_blocked": _F32,
    "03b_pallas_small_blocks": _F32,
    "01b_xla_bf16": _BF16,
    "04_pallas_tuned_fp32": _F32,
    "05_pallas_bf16": _BF16,
    "15_packed_alias_bf16": _BF16,
    "16_packed_alias_fp32": _F32,
    "07_pallas_int4": (torch.bfloat16, torch.int8, torch.float32, int),
    "06v_xla_int8": (torch.int8, torch.float32, torch.int8, torch.float32),
    "06_pallas_int8": (torch.int8, torch.float32, torch.int8, torch.float32),
    "14_packed_alias_int8": (torch.int8, torch.float32, torch.int8,
                             torch.float32),
    **dict.fromkeys(("08_manual_dma_int8", "09_fat_tile_int8",
                     "10_packed_fat_int8", "11_strip_resident_int8",
                     "12_resident_int8", "13_tiled_resident_int8",
                     "17_hand_pipeline_int8", "18_ragged_m_int8"),
                    (torch.int8, torch.float32, torch.int8, torch.float32)),
    "07b_pallas_w4a8": (torch.int8, torch.float32, torch.int8,
                        torch.float32, int),
}

# numpy dtype names (bf16 arrays carry ml_dtypes' ``bfloat16``)
_NUMPY = {torch.int8: "int8", torch.float32: "float32",
          torch.bfloat16: "bfloat16"}


def from_jax_prepared(rung_name: str, arrays, device) -> tuple:
    """Reference rung ``rung_name``'s prepared operands (numpy arrays,
    and ``kdim`` as an int for 07 and 07b) -> the port's prepared tuple on
    ``device``, bf16 arrays bit for bit. Raises on a dtype the port's rung
    does not take."""
    if rung_name not in _LAYOUTS:
        raise KeyError(f"no layout for rung {rung_name!r}; "
                       f"available: {sorted(_LAYOUTS)}")
    layout = _LAYOUTS[rung_name]
    if len(arrays) != len(layout):
        raise ValueError(f"{rung_name}: expected {len(layout)} operands, "
                         f"got {len(arrays)}")
    out = []
    for x, dt in zip(arrays, layout):
        if dt is int:
            out.append(int(x))
            continue
        x = np.asarray(x)
        if x.dtype.name != _NUMPY[dt]:
            raise TypeError(f"{rung_name}: expected {_NUMPY[dt]}, "
                            f"got {x.dtype}")
        out.append(_tensor(x, device))
    return tuple(out)


def _tensor(x: np.ndarray, device) -> torch.Tensor:
    """One numpy leaf as a tensor of the same dtype (bf16 arrays, whose
    numpy dtype is ml_dtypes' ``bfloat16``, keep their bits)."""
    if x.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(x.view(np.uint16), copy=True))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def params_from_jax(tree, device):
    """A JAX ``llama.init_params`` tree with numpy leaves -> the port's
    tree on ``device``: the same nesting and key names, each leaf a
    tensor of the same dtype and shape."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return _tensor(np.asarray(tree), device)


def kv_cache_from_jax(cache, device) -> list:
    """A JAX contiguous KV cache with numpy leaves -> the port's cache on
    ``device``: per layer (k, v) bf16 (B, T, KVH, D) as they are, or KV8
    (qk, sk, qv, sv) with the scales cropped from the reference's
    (B, T, 128) lanes to the port's (B, T, KVH). Only the trailing axes
    matter, so a paged pool converts the same way
    (``paged_cache_from_jax``)."""
    out = []
    for entry in cache:
        entry = [np.asarray(x) for x in entry]
        if len(entry) == 4:
            kvh = entry[0].shape[2]
            entry = [x if i % 2 == 0 else x[..., :kvh]
                     for i, x in enumerate(entry)]
        elif len(entry) != 2:
            raise ValueError(f"a cache entry of {len(entry)} arrays is "
                             "neither (k, v) nor (qk, sk, qv, sv)")
        out.append(tuple(_tensor(np.ascontiguousarray(x), device)
                         for x in entry))
    return out


def paged_cache_from_jax(pools, device) -> list:
    """A JAX ``init_paged_kv_cache`` pool with numpy leaves -> the port's
    on ``device``: per layer (k_pool, v_pool) bf16 (NP, PS, KVH, D) as
    they are, or KV8 (qk, sk, qv, sv) with the scales cropped from
    (NP, PS, 128) lanes to (NP, PS, KVH)."""
    return kv_cache_from_jax(pools, device)


def to_device(tree, device):
    """A nested dict / list tree of tensors, each moved to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)
