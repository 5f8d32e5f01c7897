"""Checkpoint save and restore for model parameters and the train state.

Counterpart: ``how_to_optimize_gemm_tpu/models/checkpoint.py``: the same
flat ``.npz`` layout, one array per leaf under its slash-joined path
(``layers/0/wq/bf16_w``), bf16 stored as its uint16 bits under the key
with ``__bf16`` appended (npz has no bf16). A file written by the JAX
package's ``save_params`` therefore loads into the port's tree of the
same model (``load_params``), every weight kind included.

``save_train_state`` / ``load_train_state`` add the AdamW state of
``parallel/training.TrainState``: per trainable leaf, in the order of
``split_trainable``, its ``exp_avg``, ``exp_avg_sq`` and ``step``, and the
step counter; resuming from them continues a run bit for bit. The JAX
package stores optax's state instead, which the port does not read.
"""
from __future__ import annotations

import pathlib
from typing import Any

import numpy as np
import torch

_BF16 = "__bf16"


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            out[prefix[:-1] + _BF16] = t.view(torch.int16).numpy().view(
                np.uint16)
        else:
            out[prefix[:-1]] = t.numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def save_params(path, params: dict[str, Any]) -> None:
    """Write the tree ``params`` (dicts and lists of tensors) to ``path``
    (np.savez appends ``.npz`` when it is missing)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **_flatten(params))


def _tensor(flat: dict, key: str, like) -> torch.Tensor:
    if key + _BF16 in flat:
        bits = np.ascontiguousarray(flat[key + _BF16]).view(np.int16)
        t = torch.from_numpy(bits).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(flat[key]))
    want = (like if isinstance(like, torch.Tensor)
            else torch.from_numpy(np.asarray(like)))
    if t.shape != want.shape or t.dtype != want.dtype:
        raise ValueError(f"checkpoint mismatch at {key}: {tuple(t.shape)}/"
                         f"{t.dtype} vs {tuple(want.shape)}/{want.dtype}")
    return t.to(want.device)


def load_params(path, like: dict[str, Any]) -> dict[str, Any]:
    """Restore into the structure of ``like``: a new tree whose tensors
    have ``like``'s shapes, dtypes (checked) and devices."""
    path = pathlib.Path(path)
    if not path.exists() and path.with_suffix(".npz").exists():
        path = path.with_suffix(".npz")
    with np.load(path, allow_pickle=False) as npz:
        flat = dict(npz)

    def rebuild(node, prefix=""):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, f"{prefix}{i}/")
                              for i, v in enumerate(node))
        return _tensor(flat, prefix[:-1], node)

    return rebuild(like)


def _adamw_state(state) -> dict[str, list]:
    """Per trainable leaf, AdamW's exp_avg, exp_avg_sq and step (zeros
    before the first step, when the optimizer holds none yet)."""
    floats = state.opt_state.param_groups[0]["params"]
    out = {"exp_avg": [], "exp_avg_sq": [], "step": []}
    for p in floats:
        st = state.opt_state.state.get(p) or {}
        out["exp_avg"].append(st.get("exp_avg", torch.zeros_like(p)))
        out["exp_avg_sq"].append(st.get("exp_avg_sq", torch.zeros_like(p)))
        out["step"].append(st.get("step", torch.tensor(0.0)))
    return out


def save_train_state(path, state) -> None:
    """Full resume checkpoint of ``parallel/training.TrainState``: params,
    the AdamW state and the step counter."""
    save_params(path, {"params": state.params,
                       "opt_state": _adamw_state(state),
                       "step": np.int64(state.step)})


def load_train_state(path, like):
    """Restore a checkpoint of ``save_train_state`` INTO ``like`` (a
    TrainState of the same model and optimizer): its parameters are
    overwritten in place, so the optimizer keeps holding them, and the
    optimizer's state and the step are replaced. Returns ``like``."""
    opt = like.opt_state
    tree = load_params(path, {"params": like.params,
                              "opt_state": _adamw_state(like),
                              "step": np.int64(like.step)})

    def copy(dst, src):
        if isinstance(dst, dict):
            for k in dst:
                copy(dst[k], src[k])
        elif isinstance(dst, (list, tuple)):
            for d, s in zip(dst, src):
                copy(d, s)
        else:
            with torch.no_grad():
                dst.copy_(src)

    copy(like.params, tree["params"])
    saved = tree["opt_state"]
    for i, p in enumerate(opt.param_groups[0]["params"]):
        opt.state[p] = {"step": saved["step"][i],
                        "exp_avg": saved["exp_avg"][i],
                        "exp_avg_sq": saved["exp_avg_sq"][i]}
    like.step = int(tree["step"])
    return like
