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

``save_params`` writes with ``np.savez`` from one host copy per leaf.
``load_params`` reads the same archive without np.load's serial copies,
which took 45 s for a 20 GB train state beside an NVIDIA H100 80GB HBM3
at 700.00 W (``chip_smoke.py``'s T-moe checkpoint; 2 s this way): it
reads the central directory, then every stored entry's bytes straight
from its offset in the file into a pinned buffer, checks each entry's
CRC-32 (a mismatch raises ``zipfile.BadZipFile``, as np.load's would)
and copies them into tensors on ``like``'s device, in ``LOAD_WORKERS``
threads; a compressed or Fortran-ordered entry (not written by either
package) goes through numpy's own reader.
"""
from __future__ import annotations

import concurrent.futures
import math
import os
import pathlib
import struct
import zipfile
import zlib
from typing import Any

import numpy as np
import torch

_BF16 = "__bf16"
CHUNK = 64 << 20        # bytes read at a time
LOAD_WORKERS = 8


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


def _npz_path(path) -> pathlib.Path:
    """np.savez's rule: ``.npz`` appended when the name lacks it."""
    path = os.fspath(path)
    return pathlib.Path(path if path.endswith(".npz") else path + ".npz")


class _Entry:
    """One stored ``.npy`` entry of the archive: its array's dtype and
    shape, and where its bytes lie in the file (None: read it through
    numpy)."""

    def __init__(self, f, zi: zipfile.ZipInfo):
        self.zi = zi
        self.offset = None
        if zi.compress_type != zipfile.ZIP_STORED:
            return
        f.seek(zi.header_offset)
        local = f.read(30)
        name_len, extra_len = struct.unpack("<HH", local[26:30])
        start = zi.header_offset + 30 + name_len + extra_len
        f.seek(start)
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        self.shape, fortran, self.dtype = read(f)
        if fortran and len(self.shape) > 1:
            return
        self.header_len = f.tell() - start
        self.nbytes = math.prod(self.shape) * self.dtype.itemsize
        if self.header_len + self.nbytes != zi.file_size:
            raise zipfile.BadZipFile(f"{zi.filename}: size mismatch")
        self.offset = start


def _check(key: str, shape, dtype: torch.dtype, like) -> None:
    want = (like if isinstance(like, torch.Tensor)
            else torch.from_numpy(np.asarray(like)))
    if tuple(shape) != tuple(want.shape) or dtype != want.dtype:
        raise ValueError(f"checkpoint mismatch at {key}: {tuple(shape)}/"
                         f"{dtype} vs {tuple(want.shape)}/{want.dtype}")


def _device_of(like) -> torch.device:
    return like.device if isinstance(like, torch.Tensor) else torch.device(
        "cpu")


def _read_into(path, entry: _Entry, dest: torch.Tensor, pinned) -> None:
    """Read one stored entry's bytes into ``dest`` (any device), checking
    the entry's CRC-32 over its header and data."""
    raw = dest.reshape(-1).view(torch.uint8)
    with open(path, "rb", buffering=0) as f:
        f.seek(entry.offset)
        crc = zlib.crc32(f.read(entry.header_len))
        for off in range(0, entry.nbytes, CHUNK):
            n = min(CHUNK, entry.nbytes - off)
            host = raw[off:off + n] if pinned is None else pinned[:n]
            view = memoryview(host.numpy())
            got = 0
            while got < n:
                k = f.readinto(view[got:])
                if not k:
                    raise zipfile.BadZipFile(f"{entry.zi.filename}: "
                                             "truncated")
                got += k
            crc = zlib.crc32(view, crc)
            if pinned is not None:
                raw[off:off + n].copy_(host)
    if crc != entry.zi.CRC:
        raise zipfile.BadZipFile(f"Bad CRC-32 for file {entry.zi.filename}")


def _rebuild(node, leaf, prefix: str = ""):
    """``node``'s structure with each leaf replaced by leaf(key, leaf).
    A module-level function: a nested one that calls itself is a reference
    cycle, which would keep everything its closure holds (the loaded
    tensors) alive until the cyclic collector runs."""
    if isinstance(node, dict):
        return {k: _rebuild(v, leaf, f"{prefix}{k}/") for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, leaf, f"{prefix}{i}/")
                          for i, v in enumerate(node))
    return leaf(prefix[:-1], node)


def load_params(path, like: dict[str, Any]) -> dict[str, Any]:
    """Restore into the structure of ``like``: a new tree whose tensors
    have ``like``'s shapes, dtypes (checked) and devices."""
    path = pathlib.Path(path)
    if not path.exists() and _npz_path(path).exists():
        path = _npz_path(path)
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        entries = {zi.filename[:-4]: _Entry(f, zi) for zi in zf.infolist()
                   if zi.filename.endswith(".npy")}
        jobs = []

        def leaf(key: str, node):
            bf16 = key + _BF16 in entries
            entry = entries[key + _BF16] if bf16 else entries[key]
            if entry.offset is None:       # numpy's reader
                with zf.open(entry.zi) as g:
                    arr = np.lib.format.read_array(g)
                t = (torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16) if bf16 else torch.from_numpy(arr))
                _check(key, t.shape, t.dtype, node)
                return t.to(_device_of(node))
            dtype = (torch.bfloat16 if bf16 else
                     torch.from_numpy(np.empty(0, entry.dtype)).dtype)
            _check(key, entry.shape, dtype, node)
            dest = torch.empty(entry.shape, dtype=dtype,
                               device=_device_of(node))
            jobs.append((entry, dest))
            return dest

        tree = _rebuild(like, leaf)
    cuda = any(dest.is_cuda for _, dest in jobs)
    slots = ([torch.empty(CHUNK, dtype=torch.uint8, pin_memory=True)
              for _ in range(LOAD_WORKERS)] if cuda else [])
    free = list(range(len(slots)))

    def work(job):
        entry, dest = job
        slot = free.pop() if dest.is_cuda else None
        try:
            _read_into(path, entry, dest,
                       None if slot is None else slots[slot])
        finally:
            if slot is not None:
                free.append(slot)

    # the largest entries first, so that no thread is left with one at the end
    jobs.sort(key=lambda job: -job[0].nbytes)
    with concurrent.futures.ThreadPoolExecutor(LOAD_WORKERS) as pool:
        for done in pool.map(work, jobs):
            pass
    if cuda:
        torch.cuda.synchronize()
    return tree


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
