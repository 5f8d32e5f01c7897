"""Serving: prefill + windowed decode with continuous batching.

Counterpart: ``how_to_optimize_gemm_tpu/parallel/serving.py``
(``Request``, ``filter_logits``, ``make_sampler``, ``ServingEngine``) and
the flow of ``examples/serve.py`` (``main``). The engine keeps one slot
per concurrent request over a contiguous bf16 KV cache:

1. admission fills every empty slot from the queue in one masked prefill
   (``_admit``): the prompts, padded to a power-of-two bucket, go through
   ``llama.decode_step`` as one (slots, bucket) batch whose write mask
   selects the admitted slots; each admitted slot samples its first token;
2. decode runs in windows of ``window`` steps (``_run_steps``): a Python
   loop of ``decode_step`` calls on the device with one host read of the
   window's tokens at its end. Slots that finish mid-window produce extra
   tokens that are dropped; the greedy stream does not depend on the
   window;
3. a finished slot is released and refilled by the next admission.

Not ported yet, each raising ``NotImplementedError``: paged caches and
the prefix cache (ROADMAP A9, B14-paged, B17), LoRA (A8), meshes (A12),
chunked prefill and ``lookahead > 1`` (A9), speculative decoding
(``run_spec*``, A9), and the KV8 cache (B16).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from how_to_optimize_gemm_tpu_torch.models import llama
from how_to_optimize_gemm_tpu_torch.models.linear import KINDS
from how_to_optimize_gemm_tpu_torch.utils.device import default_device


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    adapter: int = -1       # LoRA adapter id (-1 = base model)
    # host wall clock, filled by the engine
    t_submit: float = 0.0   # run() saw the request
    t_first: float = 0.0    # first token produced (TTFT = t_first-t_submit)
    t_done: float = 0.0


def filter_logits(logits: torch.Tensor, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 0.0,
                  min_p: float = 0.0) -> torch.Tensor:
    """Temperature and the composable support filters on (..., V) logits:
    top_k keeps the k largest, top_p in (0, 1) the smallest prefix of the
    sorted distribution whose mass reaches p, min_p in (0, 1) the tokens
    with probability >= min_p x the top one's (k, then p, then min_p);
    dropped entries become -1e30."""
    scaled = logits.to(torch.float32) / temperature
    if top_k:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, -1e30)
    if 0.0 < top_p < 1.0:
        srt = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        thresh = torch.where(keep, srt, torch.full_like(srt, float("inf")))
        thresh = thresh.amin(dim=-1, keepdim=True)
        scaled = scaled.masked_fill(scaled < thresh, -1e30)
    if 0.0 < min_p < 1.0:
        probs = torch.softmax(scaled, dim=-1)
        pmax = probs.amax(dim=-1, keepdim=True)
        scaled = scaled.masked_fill(probs < min_p * pmax, -1e30)
    return scaled


def make_sampler(temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 0.0, min_p: float = 0.0):
    """Sampler: logits (B, V) and a ``torch.Generator`` on their device ->
    (B,) int32 tokens. temperature <= 0 means greedy (argmax, the first
    of equal maxima)."""
    def sample(logits: torch.Tensor, generator: torch.Generator):
        logits = logits.to(torch.float32)
        if temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(
            filter_logits(logits, temperature, top_k, top_p, min_p), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)
    return sample


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class ServingEngine:
    """Slot-based continuous batching over ``llama.decode_step``."""

    def __init__(self, cfg: llama.LlamaConfig, params: dict,
                 batch_slots: int = 4, sample: Callable | None = None,
                 cache_kind: str = "bf16", device=None, *, mesh=None,
                 paged: bool = False, prefix_cache: bool = False,
                 lora=None, prefill_chunk: int | None = None, seed: int = 0,
                 kernel_routes: bool | None = None):
        """params: an ``llama.init_params`` tree on ``device`` (the card
        unless ``device="cpu"`` is asked for). sample: a ``make_sampler``
        sampler, greedy by default; ``seed`` seeds its generator.
        kernel_routes: ``llama.decode_step``'s (True on the CPU runs the
        kernels' plain versions)."""
        if mesh is not None:
            _not_ported("a tensor-parallel mesh", "A12")
        if paged or prefix_cache:
            _not_ported("the paged KV cache and the prefix cache",
                        "A9, B14-paged, B17")
        if lora is not None:
            _not_ported("LoRA serving", "A8")
        if prefill_chunk is not None:
            _not_ported("chunked prefill", "A9")
        if cache_kind != "bf16":
            _not_ported(f"the {cache_kind} KV cache (KV8)", "B16")
        self.cfg = cfg
        self.kernel_routes = kernel_routes
        self.batch = batch_slots
        self.params = params
        self.device = default_device(device)
        self.sample = sample or make_sampler(temperature=0.0)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.cache = llama.init_kv_cache(cfg, batch_slots,
                                         device=self.device)
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, np.int32)
        self.slot_tok = np.zeros(batch_slots, np.int32)
        self._eos_id: int | None = None

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def step(self, tokens: torch.Tensor, pos: torch.Tensor, **kw):
        """One ``decode_step`` on the engine's cache -> logits."""
        logits, self.cache = llama.decode_step(
            self.params, self.cfg, self.cache, tokens, pos,
            kernel_routes=self.kernel_routes, **kw)
        return logits

    # ------------------------------------------------------------- admin
    @staticmethod
    def _bucket(n: int) -> int:
        """Prompt lengths padded to powers of two, as the reference does
        to bound its compiled prefill shapes."""
        p = 1
        while p < n:
            p *= 2
        return p

    def _dispatch_prefill(self, group) -> dict[int, torch.Tensor]:
        """Prefill one admission group [(slot, req)] in one masked,
        whole-prompt step -> {slot: logits (1, vocab) of its last
        position}."""
        lens = [(s, req, len(req.prompt) + len(req.out)) for s, req in group]
        c = min(self._bucket(max(n for _, _, n in lens)), self.cfg.max_seq)
        tokens = np.zeros((self.batch, c), np.int32)
        pos = self.slot_pos.copy()
        mask = np.zeros(self.batch, bool)
        lidx = np.zeros(self.batch, np.int32)
        for s, req, n in lens:
            tokens[s, :n] = req.prompt + req.out
            pos[s] = 0
            mask[s] = True
            lidx[s] = n - 1
        logits = self.step(self._tensor(tokens), self._tensor(pos),
                           write_mask=self._tensor(mask), prefill_self=True,
                           logit_idx=self._tensor(lidx))
        return {s: logits[s] for s, _, _ in lens}

    def _release(self, s: int) -> None:
        self.slot_req[s] = None
        self.slot_pos[s] = 0
        self.slot_tok[s] = 0

    def _admit(self, queue: list[Request]) -> None:
        """Fill every empty slot from the queue with one masked prefill;
        each admitted slot samples its first token."""
        n_empty = sum(1 for r in self.slot_req if r is None)
        for req in queue[:n_empty]:
            if len(req.prompt) + len(req.out) >= self.cfg.max_seq:
                raise ValueError(
                    f"request {req.uid}: prompt length "
                    f"{len(req.prompt) + len(req.out)} >= max_seq "
                    f"{self.cfg.max_seq} (no room to generate)")
        admitted = []
        for s in range(self.batch):
            if self.slot_req[s] is None and queue:
                req = queue.pop(0)
                if req.adapter != -1:
                    _not_ported("LoRA adapters", "A8")
                self.slot_req[s] = req
                admitted.append((s, req))
        if not admitted:
            return
        logits_of = self._dispatch_prefill(admitted)
        for s, req in admitted:
            self.slot_pos[s] = len(req.prompt) + len(req.out)
            tok = int(self.sample(logits_of[s], self.generator)[0])
            if not req.t_first:
                req.t_first = time.perf_counter()
            self.slot_tok[s] = tok
            req.out.append(tok)
            if (len(req.out) >= req.max_new
                    or (self._eos_id is not None and tok == self._eos_id)):
                req.done = True
                req.t_done = time.perf_counter()
                self._release(s)

    # -------------------------------------------------------------- run
    def _decode_window(self, w: int) -> np.ndarray:
        """w decode steps from the slots' current tokens and positions ->
        (w, B) sampled tokens, read from the device once."""
        tokens = self._tensor(self.slot_tok.reshape(-1, 1))
        pos = self._tensor(self.slot_pos)
        toks = []
        for _ in range(w):
            logits = self.step(tokens, pos)
            nxt = self.sample(logits[:, -1, :], self.generator)
            toks.append(nxt)
            tokens = nxt[:, None]
            pos = pos + 1
        return torch.stack(toks).cpu().numpy()

    def run(self, requests: list[Request], eos_id: int | None = None,
            window: int = 8, lookahead: int = 1) -> list[Request]:
        """Serve all requests to completion; returns them with ``.out``."""
        for _ in self._run_steps(requests, eos_id, window, lookahead):
            pass
        return requests

    def run_stream(self, requests: list[Request],
                   eos_id: int | None = None, window: int = 8,
                   lookahead: int = 1):
        """``run`` as a generator of (uid, token), in per-request order,
        one window's worth per engine step."""
        seen = {r.uid: 0 for r in requests}
        for _ in self._run_steps(requests, eos_id, window, lookahead):
            for r in requests:
                while seen[r.uid] < len(r.out):
                    yield r.uid, r.out[seen[r.uid]]
                    seen[r.uid] += 1

    def run_spec(self, *args, **kwargs):
        _not_ported("speculative decoding (run_spec)", "A9")

    def run_spec_lookup(self, *args, **kwargs):
        _not_ported("prompt-lookup speculative decoding (run_spec_lookup)",
                    "A9")

    def _run_steps(self, requests, eos_id=None, window: int = 8,
                   lookahead: int = 1):
        """The synchronous engine loop as a generator: yields after
        admission and after every decode window."""
        if lookahead != 1:
            _not_ported("pipelined decode bursts (lookahead > 1)", "A9")
        queue = list(requests)
        now = time.perf_counter()
        for r in queue:
            r.t_submit = now
        self._eos_id = eos_id
        self._admit(queue)
        yield
        while any(r is not None for r in self.slot_req):
            active = [int(self.slot_pos[s]) for s in range(self.batch)
                      if self.slot_req[s] is not None]
            w = max(1, min(window, self.cfg.max_seq - 1 - max(active)))
            w = 1 << (w.bit_length() - 1)     # the reference's power of 2
            toks = self._decode_window(w)
            for s in range(self.batch):
                req = self.slot_req[s]
                if req is None:
                    continue
                for i in range(w):
                    self.slot_pos[s] += 1
                    tok = int(toks[i, s])
                    req.out.append(tok)
                    hit_eos = eos_id is not None and tok == eos_id
                    full = self.slot_pos[s] + 1 >= self.cfg.max_seq
                    if len(req.out) >= req.max_new or hit_eos or full:
                        req.done = True
                        req.t_done = time.perf_counter()
                        self._release(s)
                        break
                    self.slot_tok[s] = tok
            self._admit(queue)
            yield


# ------------------------------------------------------------------ CLI

def make_requests(n: int, prompt_len: int, max_new: int, seed: int = 0,
                  prompt_len_max: int | None = None) -> list[Request]:
    """n requests of random token ids in [1, 30000) from numpy's
    ``default_rng(seed)``; prompt lengths uniform in [prompt_len,
    prompt_len_max] (all ``prompt_len`` when that is None)."""
    rng = np.random.default_rng(seed)
    hi = prompt_len if prompt_len_max is None else prompt_len_max
    lens = rng.integers(prompt_len, hi + 1, n)
    return [Request(uid=i, prompt=rng.integers(1, 30000, int(lens[i])).tolist(),
                    max_new=max_new) for i in range(n)]


def summarize(done: list[Request], seconds: float) -> dict:
    """Tokens/s over the run, TTFT p50 and max, and the decode-only rate
    (tokens after each first one, over first-token to last-done)."""
    ntok = sum(len(r.out) for r in done)
    ttfts = sorted(r.t_first - r.t_submit for r in done if r.t_first)
    t0s = [r.t_first for r in done if r.t_first]
    t1s = [r.t_done for r in done if r.t_done]
    dec_tok = sum(max(len(r.out) - 1, 0) for r in done)
    dec_dt = max(t1s) - min(t0s) if t0s and t1s else 0.0
    return {"tokens": ntok, "seconds": seconds, "tok_per_s": ntok / seconds,
            "ttft_p50_ms": ttfts[len(ttfts) // 2] * 1e3,
            "ttft_max_ms": ttfts[-1] * 1e3,
            "decode_tok_per_s": dec_tok / dec_dt if dec_dt > 0 else None}


def main(argv=None):
    """Serve random requests on a random-weight model and print tokens/s,
    TTFT p50/max and the decode-only rate. Runs on the card unless
    ``--device cpu``."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--preset", default=None, choices=["llama2_7b"],
                    help="the model's proportions (else the --d-model ... "
                         "flags)")
    ap.add_argument("--weight-kind", default="int8", choices=KINDS)
    ap.add_argument("--cache-kind", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--d-model", type=int, default=2048)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="depth (default: the preset's, else 8)")
    ap.add_argument("--n-heads", type=int, default=16)
    ap.add_argument("--n-kv-heads", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=2048)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--prompt-len-max", type=int, default=None,
                    help="draw prompt lengths uniformly in [--prompt-len, "
                         "this]")
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--window", type=int, default=8,
                    help="decode steps per host read of the tokens")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    if args.preset == "llama2_7b":
        cfg = llama.llama2_7b(args.weight_kind)
    else:
        cfg = llama.LlamaConfig(
            vocab=32000, d_model=args.d_model, n_layers=8,
            n_heads=args.n_heads, n_kv_heads=args.n_kv_heads,
            d_ff=args.d_model * 11 // 4, max_seq=args.max_seq,
            weight_kind=args.weight_kind)
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    device = default_device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = llama.init_params(gen, cfg, device)
    eng = ServingEngine(cfg, params, batch_slots=args.slots,
                        sample=make_sampler(args.temperature, top_k=40),
                        cache_kind=args.cache_kind, device=device,
                        seed=args.seed)

    def run():
        reqs = make_requests(args.requests, args.prompt_len, args.max_new,
                             args.seed, args.prompt_len_max)
        return eng.run(reqs, window=args.window)

    run()                          # first use builds the kernels
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = run()
    stats = summarize(done, time.perf_counter() - t0)
    for r in done[:2]:
        print(f"request {r.uid}: {r.out[:8]}...")
    dec = stats["decode_tok_per_s"]
    steady = f"; decode-only {dec:.0f} tok/s" if dec else ""
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"{stats['tokens']} tokens in {stats['seconds']:.2f}s = "
          f"{stats['tok_per_s']:.0f} tok/s; TTFT "
          f"p50={stats['ttft_p50_ms']:.0f} ms "
          f"max={stats['ttft_max_ms']:.0f} ms{steady} ({name})")
    return stats


if __name__ == "__main__":
    main()
