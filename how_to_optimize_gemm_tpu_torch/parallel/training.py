"""AdamW training of the Llama model: the step, the loop, checkpoint and
bit-exact resume, and the training soak.

Counterpart: ``how_to_optimize_gemm_tpu/parallel/training.py``. The
reference's optax chain ``clip_by_global_norm(clip)`` then
``adamw(lr, weight_decay=0.01)`` is ``clip_by_global_norm`` below (a copy
of optax's: the global norm of the gradients, with no epsilon, and
``g / norm * clip`` when it is not below ``clip``) and
``torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay)``,
whose update is optax's to rounding. Its moments take each parameter's
dtype (bf16 for bf16 weights), as optax's do.

Only the float leaves train (``split_trainable``, ``is_float_leaf``): the
integer leaves of quantized linears are frozen, and on the CPU their float
scales train through the emulation (on the card ``llama.loss_fn`` refuses
quantized linears, ROADMAP A15). MoE trees train on every device: the
router and dense expert stacks take their gradients, an int8 or packed
int4 stack stays frozen while its fp32 scales train (the grouped GEMM's
backward, ``ops/grouped_gemm.py``), and checkpoints carry the whole tree.
Unlike the reference's pure functions,
the optimizer updates the parameter tensors of the tree in place, and
``init_train_state`` marks them as requiring grad. The step keeps no
state of its own between calls, so a run resumed from a checkpoint
(``models/checkpoint.save_train_state``) reproduces its losses bit for
bit on the same device.

Not ported: the dp/tp mesh (``mesh=`` raises NotImplementedError, ROADMAP
A12).

``soak_main`` (``python -m how_to_optimize_gemm_tpu_torch.parallel.training``)
trains the reference soak's model (the TinyLlama-1.1B shape: vocab 32,000,
d_model 2,048, 22 layers, 32 query heads and 4 KV heads of 64, d_ff
5,632; bf16 linears, fp32 embedding and lm head) from random weights
(seed 0) on a learnable synthetic stream (``_affine_batch``), on the card
unless ``--device cpu``; artifacts and checkpoints go under
``outputs/gpu/``. MFU is 6 x parameters x tokens/s against the H100 SXM
data sheet's dense bf16 peak (``harness/profiling.PEAK_BF16_FLOPS``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
from typing import Any

import numpy as np
import torch

from how_to_optimize_gemm_tpu_torch.harness.profiling import (
    PEAK_BF16_FLOPS, _short)
from how_to_optimize_gemm_tpu_torch.models import checkpoint, llama
from how_to_optimize_gemm_tpu_torch.utils.device import default_device

MESH_TODO = "the dp/tp mesh is not ported yet (ROADMAP A12)"


@dataclasses.dataclass
class TrainState:
    """params: the model tree, whose float leaves are the optimizer's
    parameters (updated in place); opt_state: the torch AdamW over them;
    step: optimizer steps taken."""
    params: Any
    opt_state: torch.optim.AdamW
    step: int


def is_float_leaf(leaf) -> bool:
    """True for trainable (floating) dtypes, bf16 included (the reference's
    ``dtype.kind`` trap froze every bf16 weight)."""
    return torch.is_floating_point(leaf)


def _leaves(tree) -> list:
    """The tree's tensors in the reference's flatten order (dict keys
    sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _replace(tree, new: dict):
    """A copy of the tree's structure with the tensors in ``new`` (by id)
    replaced."""
    if isinstance(tree, dict):
        return {k: _replace(v, new) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replace(v, new) for v in tree)
    return new.get(id(tree), tree)


def split_trainable(params):
    """(float_leaves, rebuild): the float leaves in flatten order, and
    ``rebuild(new_floats)`` giving a tree with them in their places and
    every other leaf (the frozen integer ones) shared."""
    floats = [x for x in _leaves(params) if is_float_leaf(x)]

    def rebuild(float_leaves):
        return _replace(params, {id(old): new for old, new
                                 in zip(floats, float_leaves)})

    return floats, rebuild


def sgd_update(floats, grads, lr):
    """Plain SGD on the float leaves, each in its own dtype (bf16 weights
    take bf16 updates)."""
    return [(p - lr * g.to(p.dtype)).to(p.dtype)
            for p, g in zip(floats, grads)]


def global_norm(grads) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum over leaves, in order, of each
    leaf's sum of squares in its own dtype."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_by_global_norm(grads, max_norm: float) -> list:
    """optax.clip_by_global_norm: the gradients as they are when their
    global norm is below ``max_norm``, else each ``g / norm * max_norm``
    (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
            for g in grads]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The reference's ``make_optimizer``: clip, then AdamW."""
    lr: float = 3e-4
    weight_decay: float = 0.01
    clip: float = 1.0

    def init(self, floats) -> torch.optim.AdamW:
        return torch.optim.AdamW(floats, lr=self.lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=self.weight_decay)


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.01,
                   clip: float = 1.0) -> Optimizer:
    return Optimizer(lr, weight_decay, clip)


def init_train_state(params, optimizer: Optimizer, mesh=None) -> TrainState:
    """The state at step 0 over ``params``, whose float leaves are marked
    as requiring grad."""
    if mesh is not None:
        raise NotImplementedError(MESH_TODO)
    floats, _ = split_trainable(params)
    for f in floats:
        f.requires_grad_(True)
    return TrainState(params=params, opt_state=optimizer.init(floats),
                      step=0)


def make_train_step(cfg, optimizer: Optimizer, mesh=None,
                    remat: bool = False, flash_train: bool = False):
    """step_fn(state, tokens) -> (state, loss): the loss and its gradients
    over the float leaves, global-norm clipping, one AdamW step."""
    if mesh is not None:
        raise NotImplementedError(MESH_TODO)

    def step(state: TrainState, tokens: torch.Tensor):
        floats = state.opt_state.param_groups[0]["params"]
        loss = llama.loss_fn(state.params, cfg, tokens, remat, flash_train)
        grads = torch.autograd.grad(loss, floats, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(floats, grads)]
        for p, g in zip(floats, clip_by_global_norm(grads, optimizer.clip)):
            p.grad = g
        del grads
        state.opt_state.step()
        for p in floats:
            p.grad = None
        state.step += 1
        return state, loss.detach()

    return step


def train(cfg, params, tokens_iter, n_steps: int, mesh=None,
          lr: float = 3e-4, remat: bool = False,
          checkpoint_dir: str | None = None, checkpoint_every: int = 0,
          resume_from: str | None = None):
    """Iterate ``tokens_iter`` for ``n_steps`` steps in all; checkpoints
    carry the whole train state, so ``resume_from`` continues a run bit
    for bit (resuming at step k runs ``n_steps - k`` more). Returns
    (state, losses)."""
    optimizer = make_optimizer(lr)
    state = init_train_state(params, optimizer, mesh)
    if resume_from is not None:
        state = checkpoint.load_train_state(resume_from, state)
    step_fn = make_train_step(cfg, optimizer, mesh, remat)
    losses = []
    for i in range(state.step, n_steps):
        state, loss = step_fn(state, next(tokens_iter))
        losses.append(float(loss))
        if (checkpoint_dir and checkpoint_every
                and (i + 1) % checkpoint_every == 0):
            checkpoint.save_train_state(
                f"{checkpoint_dir}/step_{i + 1:06d}", state)
    return state, losses


# ----------------------------------------------------------- soak CLI

def _affine_batch(rng: np.random.Generator, batch: int, seq: int,
                  vocab: int, a: int = 7, c: int = 31,
                  noise: float = 0.02) -> np.ndarray:
    """Learnable synthetic stream: x[t+1] = (a * x[t] + c) % vocab with a
    little token noise, so the loss falls towards the noise's entropy
    instead of sitting at ln(vocab)."""
    x = np.empty((batch, seq), np.int64)
    x[:, 0] = rng.integers(0, vocab, batch)
    for t in range(1, seq):
        x[:, t] = (a * x[:, t - 1] + c) % vocab
    flip = rng.random((batch, seq)) < noise
    x[flip] = rng.integers(0, vocab, int(flip.sum()))
    return x.astype(np.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile_step(step_fn, state, tokens, top: int = 12) -> dict:
    """One more step on the card under ``torch.profiler``: its wall time
    (profiler on), the device time summed over its kernels, their share
    of the wall time, and the ``top`` kernels by device time. A user
    annotation's range on the device (``Optimizer.step#AdamW.step``) spans
    kernels that are counted already, and is left out."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        step_fn(state, tokens)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels: dict[str, list] = {}
    for ev in prof.key_averages():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        us = getattr(ev, "device_time_total", None)
        us = ev.cuda_time_total if us is None else us
        k = kernels.setdefault(_short(ev.key), [0.0, 0])
        k[0] += us / 1e3
        k[1] += ev.count
    device_ms = sum(ms for ms, _ in kernels.values())
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy": device_ms / wall_ms if wall_ms else None,
            "kernels": [{"name": n, "ms": ms, "count": c}
                        for n, (ms, c) in rows]}


def soak_main(argv=None) -> dict:
    """Training soak: N AdamW steps of the soak's model on the card, the
    loss curve, steady-state tokens/s, step time, MFU and peak memory, a
    mid-run checkpoint and, with --resume-from, a bit-exact check of the
    continued losses against the first run's artifact. Returns the
    artifact it writes."""
    ap = argparse.ArgumentParser(description=soak_main.__doc__)
    ap.add_argument("--d-model", type=int, default=2048)
    ap.add_argument("--n-layers", type=int, default=22)
    ap.add_argument("--d-ff", type=int, default=5632)
    ap.add_argument("--n-heads", type=int, default=32)
    ap.add_argument("--n-kv-heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--flash-train", action="store_true")
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--ckpt-dir", default="outputs/gpu/train_soak_ckpt")
    ap.add_argument("--artifact", default="outputs/gpu/train_soak.json")
    ap.add_argument("--resume-from", default=None,
                    help="checkpoint path; continues and checks that the "
                         "losses equal the artifact's tail bit for bit")
    ap.add_argument("--sync-every", type=int, default=25,
                    help="wait for the device every N steps and record the "
                         "time")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--profile", action="store_true",
                    help="on the card, after the run, profile one more "
                         "step (not in the loss curve) with torch.profiler: "
                         "device time by kernel")
    args = ap.parse_args(argv)
    device = default_device(args.device)

    cfg = llama.LlamaConfig(
        vocab=args.vocab, d_model=args.d_model, n_layers=args.n_layers,
        n_heads=args.n_heads, n_kv_heads=args.n_kv_heads, d_ff=args.d_ff,
        max_seq=args.seq, weight_kind="bf16")
    gen = torch.Generator(device=device).manual_seed(0)
    params = llama.init_params(gen, cfg, device)
    nparams = sum(x.numel() for x in _leaves(params))
    optimizer = make_optimizer(args.lr)
    state = init_train_state(params, optimizer)
    start_step = 0
    if args.resume_from:
        state = checkpoint.load_train_state(args.resume_from, state)
        start_step = state.step
        print(f"# resumed from {args.resume_from} at step {start_step}")
    step_fn = make_train_step(cfg, optimizer, remat=args.remat,
                              flash_train=args.flash_train)

    # step i's batch is a function of i alone, so a resumed run replays
    # the same tokens
    def batch_at(i):
        return torch.from_numpy(_affine_batch(
            np.random.default_rng(1234 + i), args.batch, args.seq,
            args.vocab)).to(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # the first step is a warm-up, outside the timed window
    state, loss0 = step_fn(state, batch_at(start_step))
    _sync(device)
    losses = [loss0]
    marks = []
    ckpt_s = 0.0
    t0 = time.perf_counter()
    for i in range(start_step + 1, args.steps):
        state, loss = step_fn(state, batch_at(i))
        losses.append(loss)
        if args.sync_every and (i + 1) % args.sync_every == 0:
            _sync(device)
            marks.append((i + 1, time.perf_counter() - t0 - ckpt_s))
        if (args.checkpoint_every and (i + 1) % args.checkpoint_every == 0
                and (i + 1) < args.steps):
            _sync(device)
            c0 = time.perf_counter()
            p = f"{args.ckpt_dir}/step_{i + 1:06d}"
            checkpoint.save_train_state(p, state)
            ckpt_s += time.perf_counter() - c0
            print(f"# checkpoint @ step {i + 1} -> {p}")
    _sync(device)
    wall = time.perf_counter() - t0 - ckpt_s
    losses = [float(x) for x in losses]

    n_timed = args.steps - start_step - 1
    toks = args.batch * args.seq
    tps = n_timed * toks / wall if n_timed else 0.0
    step_ms = 1e3 * wall / n_timed if n_timed else None
    on_card = device.type == "cuda"
    # MFU: 6 x parameters x tokens/s against the card's bf16 peak; no
    # device metric comes from a CPU run
    mfu = 6.0 * nparams * tps / PEAK_BF16_FLOPS if on_card else None
    peak_gb = (torch.cuda.max_memory_allocated(device) / 1e9 if on_card
               else None)
    profile = None
    if args.profile and on_card:
        profile = _profile_step(step_fn, state, batch_at(args.steps))
        print(f"# profiled step: wall {profile['wall_ms']:.1f} ms, device "
              f"{profile['device_ms']:.1f} ms (busy {profile['busy']:.2f})")
        for k in profile["kernels"]:
            print(f"#   {k['ms']:10.3f} ms  {k['count']:6d}  {k['name']}")
    print(f"# {n_timed} steps in {wall:.3f} s (checkpoints excluded) = "
          f"{tps:,.1f} tok/s, step {step_ms} ms, loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}, MFU "
          + (f"{mfu * 100:.2f}% of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16"
             if on_card else "not measured (CPU)")
          + (f", peak {peak_gb:.2f} GB" if on_card else ""))

    art = {
        "config": {k: getattr(args, k) for k in
                   ("d_model", "n_layers", "d_ff", "n_heads", "n_kv_heads",
                    "vocab", "seq", "batch", "steps", "lr", "remat",
                    "flash_train")},
        "device": (torch.cuda.get_device_name(device) if on_card
                   else "cpu"),
        "n_params": nparams,
        "start_step": start_step, "losses": losses,
        "tokens_per_s": tps, "mfu_pct": None if mfu is None else mfu * 100,
        "step_ms": step_ms, "wall_s": wall, "checkpoint_s": ckpt_s,
        "peak_gb": peak_gb, "sync_marks": marks, "profile": profile,
    }
    path = pathlib.Path(args.artifact)
    if args.resume_from:
        prior = json.loads(path.read_text())
        tail = prior["losses"][start_step - prior["start_step"]:]
        same = np.array_equal(np.asarray(tail, np.float64),
                              np.asarray(losses, np.float64))
        art["bitexact_resume_vs"] = str(path)
        art["bitexact_resume"] = bool(same)
        path = path.with_suffix(".resume.json")
        first = next((i for i, (a, b) in enumerate(zip(tail, losses))
                      if a != b), None)
        print(f"# resume bit-exact vs artifact: {same}"
              + ("" if same else f" (first difference at {first})"))
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(art) + "\n")
    print(f"# artifact -> {path}")
    return art


if __name__ == "__main__":
    soak_main()
