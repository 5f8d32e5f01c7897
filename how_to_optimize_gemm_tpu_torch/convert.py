"""Carry the reference's operands and weights into the port.

This module imports no JAX: its inputs are the JAX package's outputs
already converted to numpy arrays (``np.asarray`` on each leaf).

- ``from_jax_prepared`` takes a ladder rung's ``Rung.prepare`` output
  and returns the port's prepared tuple for the same rung;
- ``params_from_jax`` takes a ``models/llama.init_params`` tree and
  returns the port's tree;
- ``to_device`` moves a port tree to another device.

Layouts and dtypes are kept (packed int4 bytes are copied byte for
byte), so both packages can be run on identical operands.
"""
from __future__ import annotations

import numpy as np
import torch

# Prepared-tuple dtypes per rung; ``int`` marks a Python int kept as is.
_LAYOUTS = {
    "06v_xla_int8": (torch.int8, torch.float32, torch.int8, torch.float32),
    "06_pallas_int8": (torch.int8, torch.float32, torch.int8, torch.float32),
    "14_packed_alias_int8": (torch.int8, torch.float32, torch.int8,
                             torch.float32),
    "07b_pallas_w4a8": (torch.int8, torch.float32, torch.int8,
                        torch.float32, int),
}

_NUMPY = {torch.int8: np.int8, torch.float32: np.float32}


def from_jax_prepared(rung_name: str, arrays, device) -> tuple:
    """Reference rung ``rung_name``'s prepared operands (numpy arrays,
    and ``kdim`` as an int for 07b) -> the port's prepared tuple on
    ``device``. Raises on a dtype the port's rung does not take."""
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
        if x.dtype != _NUMPY[dt]:
            raise TypeError(f"{rung_name}: expected {_NUMPY[dt]}, "
                            f"got {x.dtype}")
        out.append(torch.from_numpy(np.array(x, copy=True)).to(device))
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


def to_device(tree, device):
    """A nested dict / list tree of tensors, each moved to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)
