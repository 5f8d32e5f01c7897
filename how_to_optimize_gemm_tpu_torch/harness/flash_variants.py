"""Variant builds of the port's wgmma kernels and of the paged KV8 decode
attention, timed against each other on the card in one process.

A variant is a copy of the port's ``csrc/`` under
``build/flash_variants/<group>/<name>/`` with textual substitutions applied
(each must match exactly once, so a variant that no longer fits the source
fails), or another tree's ``csrc/`` given with ``--tree NAME=DIR[:BK]`` (a
parent commit unpacked by ``git archive``; for the forward group its key
tile BK). Four groups of kernels, one a run (``--group``):

- ``forward``: ``flash_attention`` at the 7B prefill row (B 4, H = KVH = 32,
  D 128, S = T = 4,096, causal, (B, S, H, D) views) and
  ``flash_attention_fwd_lse`` at the soak's shape (B 8, H 32, KVH 4,
  S 1,024, D 64, causal, views), each output held to its plain version at
  the variant's key tile (``bf16_row_ulps``; ``row_rel_err`` and the lse's
  max abs);
- ``dkv``: ``flash_attention_bwd_dkv`` at the soak's shape, at the 7B
  training row (B 2, H = KVH = 32, S 2,048, D 128, causal) and at T-moe's
  (B 2, H 32, KVH 8, S 1,025, D 128, causal), dk and dv held to the plain
  version (``row_rel_err``); SDPA's whole backward beside them, timed as
  the difference of two graph replays (forward and backward, forward);
- ``gemm``: ``bf16_gemm_nt`` (rung 15), ``fp32_gemm_nt`` (rung 16) and
  ``fp32_gemm_nn`` (rung 04: each its wrapper with the two splits, and the
  kernel alone on planes split beforehand) and ``bf16_gemm_nn`` (rung 05)
  at M = N = K = 4,096 and 2,048, each held to its plain version relative
  to max |plain|, two calls bit-equal, rungs 05's and 04's C unchanged;
  01b's two calls (15, 05) and 01's (16, 04) beside them. An older tree's
  ``fp32_gemm_nt`` or ``fp32_gemm_nn`` (the FFMA kernels before the split
  route) takes fp32 operands and is launched on them;
- ``paged``: ``paged_decode_attention_q8`` on the split walk at the
  smoke's two shapes (the 7B KV8 pool: 4 slots, 32 heads of 128, pages
  of 384, lengths 1, 300, 1,000 and 4,096; kvh 3, rep 2, D 32, pages of
  96), held to its plain version; the variant ``scales_once`` (wrong
  answers, a timing probe) reads every key's scales at the page's first
  row, which times what the per-key scale reads cost. This tree only:
  an older tree's kernel takes other arguments.

Each variant's ptxas lines (registers, spills) are printed after the
build; the cases run as CUDA-graph replays in rounds that walk the
variants forwards and then backwards.

    python -m how_to_optimize_gemm_tpu_torch.harness.flash_variants \\
        [--group forward|dkv|gemm|paged] [--variants shipped ...] \\
        [--tree parent=build/parent/how_to_optimize_gemm_tpu_torch/csrc:64]
"""
from __future__ import annotations

import argparse
import pathlib
import shutil

import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import (attention, grouped_gemm,
                                               paged_attention, tuned,
                                               vendor)
from how_to_optimize_gemm_tpu_torch.utils.timing import time_calls

OUT_DIR = _build.BUILD_DIR.parent / "flash_variants"
_BODY = "flash_wgmma.cuh"
# name -> ((file, old, new), ...), and the key tile where it differs
_BK128 = (_BODY, "constexpr int BK = 64; ", "constexpr int BK = 128;")
_SETMAXNREG = (
    (_BODY, "  if (threadIdx.x < 128) {\n",
     "  if (threadIdx.x < 128) {\n"
     "    asm volatile(\"setmaxnreg.dec.sync.aligned.u32 24;\\n\");\n"),
    (_BODY, "  } else {\n    consume<D, kSplit>",
     "  } else {\n"
     "    asm volatile(\"setmaxnreg.inc.sync.aligned.u32 240;\\n\");\n"
     "    consume<D, kSplit>"))
# a consumer's products in turn with its softmax: a turn issues S, then
# P V follows the softmax (only S or P live at once besides O)
_SERIAL = (
    (_BODY, """  wait_full(0);
  turn();
  qk(0);
  pass(0);
  wg::wgmma_wait<0>();
  softmax(0);
  sm.rescale<D>(o, s, pa);
  for (int j = 1; j < my_n; ++j) {
    wait_full(j);
    turn();
    qk(j);
    pv(j - 1);
    pass(j);
    wg::wgmma_wait<1>();
    softmax(j);
    wg::wgmma_wait<0>();
    pv_done(j - 1);
    sm.rescale<D>(o, s, pa);
  }
  turn();
  pv(my_n - 1);
  pass(my_n);
""", """  for (int j = 0; j < my_n; ++j) {
    wait_full(j);
    turn();
    if (j > 0) {
      wg::wgmma_wait<0>();
      pv_done(j - 1);
    }
    qk(j);
    pass(j);
    wg::wgmma_wait<0>();
    softmax(j);
    sm.rescale<D>(o, s, pa);
    pv(j);
  }
  turn();
  pass(my_n);
"""),)
FORWARD_VARIANTS = {
    "shipped": (),
    # 128-key tiles (FA3's choice): S, P and O spill at D 128
    "bk128": (_BK128,),
    # the same with the producer's registers handed to the consumers
    # (setmaxnreg 24 / 240)
    "bk128_setmaxnreg": (_BK128, *_SETMAXNREG),
    # the same compiled for 256 threads a block, where ptxas gives the
    # consumers 240 registers; a launch of 384 threads is refused
    "bk128_lb256": (_BK128, *_SETMAXNREG,
                    (_BODY, "__launch_bounds__(THREADS, 1)",
                     "__launch_bounds__(256, 1)")),
    # no overlap within a consumer, at 64- and 128-key tiles
    "serial": _SERIAL,
    "bk128_serial": (_BK128, *_SERIAL),
    # the consumers do not take turns at the tensor cores
    "no_pingpong": (
        (_BODY, "auto turn = [&] { wg::bar_sync(BAR_TURN + cw, 256); };",
         "auto turn = [&] {};"),
        (_BODY, "if (cw == 0 || t < n) wg::bar_arrive(BAR_TURN + (cw ^ 1), "
         "256);", "(void)t;"),
        (_BODY, "if (cw == 1) wg::bar_arrive(BAR_TURN, 256);", "")),
    # exp as expf on scores in natural units
    "expf": (
        (_BODY, 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
         "y = expf(x);"),
        (_BODY, "constexpr float LOG2E = 1.4426950408889634f;",
         "constexpr float LOG2E = 1.0f;"),
        (_BODY, "constexpr float LN2 = 0.6931471805599453f;",
         "constexpr float LN2 = 1.0f;")),
    # o left as it is where neither of a thread's rows moved its max
    # (alpha = 1: o * 1 is o)
    "rescale_skip": (
        (_BODY, "    for (int i = 0; i < D / 2; ++i)\n      o[i] = ",
         "    for (int i = 0; i < D / 2; ++i)\n      if (alpha[0] != 1.0f || "
         "alpha[1] != 1.0f) o[i] = "),),
    # diagnostics, other functions: fwd_lse without q's lo product; both
    # kernels without their output stores (a condition the compiler cannot
    # see is always true)
    "diag_hi_only": ((_BODY, "    if (kSplit)\n      wg::Wgmma<BK>",
                      "    if (false)\n      wg::Wgmma<BK>"),),
    "diag_no_store": ((_BODY, "if (row >= p.S) continue;",
                       "if (row >= p.S || p.causal < 5) continue;"),),
}
KEY_TILE = dict.fromkeys(("bk128", "bk128_setmaxnreg", "bk128_lb256",
                          "bk128_serial"), 128)

_DKV = "flash_attention_bwd_dkv.cu"
_NC = "  static constexpr int NC = D == 64 ? 2 : 1;      // consumer warpgroups"
_QT = "  static constexpr int QT = 64;                   // queries a step"
DKV_VARIANTS = {
    "shipped": (),
    # at D 128 two consumers (128-key blocks of 384 threads, 168 registers
    # a thread) on 32-query steps: dk and dv take 128, and it spills
    "d128_two_consumers": (
        (_DKV, _NC, "  static constexpr int NC = 2;"),
        (_DKV, _QT, "  static constexpr int QT = D == 64 ? 64 : 32;")),
    # one consumer at both D (64-key blocks of 256 threads)
    "one_consumer": ((_DKV, _NC, "  static constexpr int NC = 1;"),),
    # 32-query steps at both D
    "qt32": ((_DKV, _QT, "  static constexpr int QT = 32;"),),
    # exp as expf on scores in natural units
    "expf": (
        (_DKV, 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
         "y = expf(x);"),
        (_DKV, "constexpr float LOG2E = 1.4426950408889634f;",
         "constexpr float LOG2E = 1.0f;")),
}

_GEMM = "bf16_gemm_nt.cu"
_FP32 = "fp32_gemm_nt.cu"
_NN = "bf16_gemm_nn.cu"
_FP32_NN = "fp32_gemm_nn.cu"
_GW = "gemm_wgmma.cuh"
_TILE128 = (_GEMM, "constexpr int BN = 256; ", "constexpr int BN = 128;")
_CH = "  static constexpr int CH = 4; "


def _fp32_chunk(stages: int, source: str = _FP32):
    return ((source, _CH, f"  static constexpr int CH = {stages}; "),)


GEMM_VARIANTS = {
    "shipped": (),
    # the loop in wgmma.cuh's consume() shape: the accumulators fenced
    # before every stage's products, the last stage's wait, fence and
    # releases on a branch of their own; ptxas serializes its products (its
    # note C7518)
    "consume_shape": (
        (_GW, """        // (acc unfenced: the group before still writes it)
        wg::wgmma_fence();""", """        wg::fence_regs(acc);
        wg::wgmma_fence();"""),
        (_GW, """        wg::wgmma_wait<1>();
        if (prev >= 0) wg::release(ring, prev);
        prev = s;
      }
      wg::wgmma_wait<0>();
      wg::fence_regs(acc);
      wg::release(ring, prev);
""", """        if (kq + 1 == kend) {
          wg::wgmma_wait<0>();
          wg::fence_regs(acc);
          if (prev >= 0) wg::release(ring, prev);
          wg::release(ring, s);
        } else {
          wg::wgmma_wait<1>();
          if (prev >= 0) wg::release(ring, prev);
          prev = s;
        }
      }
""")),
    # each consumer thread adds C to its sums (or stores them) itself, as
    # it does where the tensor-map unit cannot (out's rows no 16-byte
    # multiple)
    "register_epilogue": ((_GW, "  int tma_out = (P::SEED_C || c == out) && ",
                           "  int tma_out = false && "),),
    # rung 15 on 128 x 128 tiles, the straight sum
    "tile128": (_TILE128,),
    # the same with partial sums of 16 stages (K 1,024) added into a
    # second fp32 array
    "tile128_chunk16": (_TILE128, (_GEMM, "constexpr int CH = 0; ",
                                   "constexpr int CH = 16;")),
    # rung 16's partial sums of 1, 2, 8 and 16 stages, and its straight sum
    "fp32_ch1": _fp32_chunk(1),
    "fp32_ch2": _fp32_chunk(2),
    "fp32_ch8": _fp32_chunk(8),
    "fp32_ch16": _fp32_chunk(16),
    "fp32_straight": _fp32_chunk(0),
    # rung 04's partial sums (seeded with C) of 1, 2, 8 and 16 stages, and
    # its straight sum (C in the wgmma accumulators)
    "nn_ch1": _fp32_chunk(1, _FP32_NN),
    "nn_ch2": _fp32_chunk(2, _FP32_NN),
    "nn_ch8": _fp32_chunk(8, _FP32_NN),
    "nn_ch16": _fp32_chunk(16, _FP32_NN),
    "nn_straight": _fp32_chunk(0, _FP32_NN),
}
_PAGED = "paged_decode_attention_q8.cu"
_DA = "decode_attention.cuh"
PAGED_VARIANTS = {
    "shipped": (),
    # the split walk's scale reads, K's and V's, at the page's first row
    "scales_once": (
        (_DA, "              s_k[u] = sk[scale_b + (size_t)(j0 + u) * KVH];",
         "              s_k[u] = sk[scale_b];"),
        (_DA, "operand = __fmul_rn(p, sv[scale_b + (size_t)j * KVH]);",
         "operand = __fmul_rn(p, sv[scale_b]);")),
}
# the headers the variants may change besides the groups' sources
HEADERS = (_BODY, _GW, _DA)

GROUPS = {
    "forward": (("flash_attention.cu", "flash_attention_fwd_lse.cu"),
                FORWARD_VARIANTS),
    "dkv": ((_DKV,), DKV_VARIANTS),
    "gemm": ((_GEMM, _FP32, _NN, _FP32_NN), GEMM_VARIANTS),
    "paged": ((_PAGED,), PAGED_VARIANTS),
}


def prepare(group: str, name: str, subs) -> pathlib.Path:
    """The port's csrc/ copied under OUT_DIR/group/name with ``subs``
    applied."""
    dst = OUT_DIR / group / name / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst)
    for file, old, new in subs:
        path = dst / file
        text = path.read_text()
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} occurs "
                             f"{text.count(old)} times in {file}")
        path.write_text(text.replace(old, new))
    return dst


def use(csrc: pathlib.Path, sources) -> None:
    """Point the build at ``csrc`` (the next launch loads its library)."""
    _build.CSRC = csrc
    for src in sources:
        _build._LIBS.pop(src, None)


def build(trees: dict, sources) -> None:
    """The group's sources of every tree, one nvcc each, all at once (a
    source whose library another tree already builds -- the same text and
    headers -- once); then each build's ptxas lines."""
    started, libs = [], set()
    for csrc in trees.values():
        use(csrc, sources)
        for src in sources:
            if _build._lib_path(src) not in libs:
                libs.add(_build._lib_path(src))
                started.append((csrc, src, _build._start_build(src)))
    for csrc, src, s in started:
        if s is not None:
            use(csrc, sources)
            _build._finish_build(src, s)
    kernels = [k for k, spec in _build.KERNELS.items()
               if spec.source in sources]
    for name, csrc in trees.items():
        use(csrc, sources)
        for kernel in kernels:
            lines = [ln for ln in _build.build_log(kernel).splitlines()
                     if "Compiling" in ln or "registers" in ln
                     or "spill" in ln or "arning" in ln
                     or "Performance" in ln]
            print(f"[{name}] {kernel} build:\n  " + "\n  ".join(lines))


def _views(b, n, heads, d, gen, dtype):
    return torch.randn((b, n, heads, d), generator=gen, device="cuda").to(
        dtype).transpose(1, 2)


def forward_cases(gen, tiles):
    """{case: fn}, {key tile: plain outputs}, and the check of a variant."""
    q, k, v = (_views(4, 4096, 32, 128, gen, torch.bfloat16) for _ in "qkv")
    tq = _views(8, 1024, 32, 64, gen, torch.float32)
    tk, tv = (_views(8, 1024, 4, 64, gen, torch.bfloat16) for _ in "kv")
    cases = {
        "flash_attention": lambda: attention.flash_attention(q, k, v),
        "flash_attention_fwd_lse": lambda: attention.flash_attention_fwd_lse(
            tq, tk, tv)}
    refs = {bk: (attention.flash_attention_ref(q, k, v, bk=bk),
                 attention.flash_attention_fwd_lse_ref(tq, tk, tv, bk=bk))
            for bk in sorted(set(tiles.values()))}

    def check(name):
        out = cases["flash_attention"]()
        o2, lse = cases["flash_attention_fwd_lse"]()
        ref, (ref2, ref_lse) = refs[tiles[name]]
        return (f"key tile {tiles[name]}: flash_attention "
                f"{float(attention.bf16_row_ulps(out, ref).max()):.3f} bf16 "
                f"ulps of its row's max |plain|; fwd_lse out "
                f"{float(attention.row_rel_err(o2, ref2).max()):.3e} of its "
                f"row's max, lse {float((lse - ref_lse).abs().max()):.3e}")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = {
        "flash_attention": lambda: sdpa(q, k, v, is_causal=True),
        "flash_attention_fwd_lse": lambda: sdpa(
            tq.to(torch.bfloat16), tk, tv, is_causal=True, enable_gqa=True)}
    return cases, check, {c: time_calls(fn, graph=True) * 1e3
                          for c, fn in library.items()}


# (B, H, KVH, S, D): the soak's row, the 7B training row, T-moe's row
DKV_SHAPES = ((8, 32, 4, 1024, 64), (2, 32, 32, 2048, 128),
              (2, 32, 8, 1025, 128))


def sdpa_backward_ms(q16, k, v, do16, causal: bool = True) -> float:
    """SDPA's whole backward (dq, dk, dv) on bf16 operands as CUDA-graph
    replays: the replay of its forward and backward less the replay of its
    forward (the backward cannot be captured without the forward that
    records it)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = q16.shape[1] != k.shape[1]
    qb, kb, vb = (x.detach().requires_grad_() for x in (q16, k, v))

    def fwd():
        return sdpa(qb, kb, vb, is_causal=causal, enable_gqa=gqa)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (qb, kb, vb), do16)
    return (time_calls(fwd_bwd, graph=True)
            - time_calls(fwd, graph=True)) * 1e3


def dkv_cases(gen, tiles):
    cases, refs, library = {}, {}, {}
    for b, h, kvh, s, d in DKV_SHAPES:
        q, do = (_views(b, s, h, d, gen, torch.float32) for _ in "qd")
        k, v = (_views(b, s, kvh, d, gen, torch.bfloat16) for _ in "kv")
        out, lse = attention.flash_attention_fwd_lse_ref(q, k, v, bk=64)
        args = (q, k, v, do, lse, (do * out).sum(dim=-1))
        case = f"dkv B={b} H={h} KVH={kvh} S={s} D={d}"
        cases[case] = (lambda a=args: attention.flash_attention_bwd_dkv(*a))
        refs[case] = attention.flash_attention_bwd_dkv_ref(*args)
        library[case] = sdpa_backward_ms(q.to(torch.bfloat16), k, v,
                                         do.to(torch.bfloat16))

    def check(name):
        rel = attention.row_rel_err
        parts = []
        for case, fn in cases.items():
            dk, dv = fn()
            again = fn()
            same = torch.equal(dk, again[0]) and torch.equal(dv, again[1])
            ek = float(rel(dk, refs[case][0]).max())
            ev = float(rel(dv, refs[case][1]).max())
            parts.append(f"{case}: dk {ek:.3e}, dv {ev:.3e} of the row's "
                         f"max, repeat {'equal' if same else 'DIFFERS'}")
        return "; ".join(parts)
    return cases, check, library


def _split_route(source: str = _FP32) -> bool:
    """Whether the tree in use computes rung 16 (``source`` ``_FP32_NN``:
    rung 04) from split bf16 planes (this tree); an older tree's kernel
    takes the fp32 operands (the FFMA kernel before the split route)."""
    marker = "split_nmajor_map" if source == _FP32_NN else "split_map"
    return marker in (_build.CSRC / source).read_text()


def fp32_bt(a, bt, c):
    """Rung 16 on the tree in use: its wrapper, or the older trees' direct
    launch on fp32 operands."""
    if _split_route():
        return tuned.mmult_fp32_bt(a, bt, c)
    return tuned.launch_gemm("mmult_fp32_bt", "fp32_gemm_nt", a, bt, c, c,
                             torch.float32, bt=True)


def fp32_product(a2, b2, a, bt, c):
    """Rung 16's kernel alone on planes split beforehand (an older tree:
    its kernel on the fp32 operands)."""
    if not _split_route():
        return fp32_bt(a, bt, c)
    m, n = c.shape
    k = a2.shape[2]
    _build.launch("fp32_gemm_nt", c.device, a2, b2, c, c, m, n, k, k, k, n)
    return c


def fp32_nn(a, b, c):
    """Rung 04 on the tree in use: its wrapper, or the older trees' direct
    launch on fp32 operands (a fresh output)."""
    if _split_route(_FP32_NN):
        return tuned.mmult(a, b, c)
    return tuned.launch_gemm("mmult", "fp32_gemm_nn", a, b, c,
                             torch.empty_like(c), torch.float32, bt=False)


def fp32_nn_product(a2, b2, a, b, c):
    """Rung 04's kernel alone on planes split beforehand, into a fresh
    output (an older tree: its kernel on the fp32 operands)."""
    if not _split_route(_FP32_NN):
        return fp32_nn(a, b, c)
    m, n = c.shape
    out = torch.empty_like(c)
    _build.launch("fp32_gemm_nn", c.device, a2, b2, c, out, m, n,
                  a.shape[1], a2.shape[2], b2.shape[2], n)
    return out


def gemm_cases(gen, tiles):
    """Rungs 15, 16 and 04 (the wrapper with its splits, and the kernel
    alone on planes split beforehand) and 05 at 4,096 and 2,048; each held
    to its plain version relative to max |plain|, two calls bit-equal,
    rungs 05's and 04's C left as it was; 01b's two calls (rungs 15 and
    05) and 01's (16 and 04) beside them."""
    cases, rows, library = {}, {}, {}
    for p in (4096, 2048):
        a, b, c = (torch.rand((p, p), generator=gen, device="cuda") * 2 - 1
                   for _ in "abc")
        a16, bt16 = tuned.prepare_bf16_bt(a, b)
        b16 = b.to(torch.bfloat16)
        bt = b.t().contiguous()
        a2, b2 = grouped_gemm.split_bf16(a), grouped_gemm.split_bf16(bt)
        bn2 = grouped_gemm.split_bf16(b)
        # name: (run(c), plain(c), library(c)), each on a C of its own
        for name, row in {
                "bf16_gemm_nt": (
                    lambda c, a16=a16, bt16=bt16:
                    tuned.mmult_bf16_bt(a16, bt16, c),
                    lambda c, a16=a16, bt16=bt16:
                    tuned.mmult_bf16_bt_ref(a16, bt16, c),
                    lambda c, a16=a16, bt16=bt16:
                    vendor.mmult_bf16(a16, bt16.t(), c)),
                "fp32_gemm_nt": (
                    lambda c, a=a, bt=bt: fp32_bt(a, bt, c),
                    lambda c, a=a, bt=bt: tuned.mmult_fp32_bt_ref(a, bt, c),
                    lambda c, a=a, bt=bt: vendor.mmult(a, bt.t(), c)),
                "fp32_gemm_nt alone": (
                    lambda c, a2=a2, b2=b2, a=a, bt=bt:
                    fp32_product(a2, b2, a, bt, c), None, None),
                "fp32_gemm_nn": (
                    lambda c, a=a, b=b: fp32_nn(a, b, c),
                    lambda c, a=a, b=b: tuned.mmult_ref(a, b, c),
                    lambda c, a=a, b=b: vendor.mmult(a, b, c)),
                "fp32_gemm_nn alone": (
                    lambda c, a2=a2, bn2=bn2, a=a, b=b:
                    fp32_nn_product(a2, bn2, a, b, c), None, None),
                "bf16_gemm_nn": (
                    lambda c, a16=a16, b16=b16: tuned.mmult_bf16(a16, b16, c),
                    lambda c, a16=a16, b16=b16:
                    tuned.mmult_bf16_ref(a16, b16, c),
                    lambda c, a16=a16, b16=b16:
                    vendor.mmult_bf16(a16, b16, c))}.items():
            case = f"{name} p={p}"
            run, plain, lib = row
            work = c.clone()
            cases[case] = lambda run=run, work=work: run(work)
            if plain is not None:
                rows[case] = (run, plain, c)
            if lib is not None:
                library[case] = time_calls(lambda lib=lib, c=c: lib(c),
                                           graph=True) * 1e3

    def check(name):
        parts = []
        for case, (run, plain, c) in rows.items():
            ref = plain(c)
            cin = c.clone()
            out = run(cin)
            again = run(c.clone())
            err = float((out - ref).abs().max() / ref.abs().max())
            same = torch.equal(out, again)
            kept = ("" if out.data_ptr() == cin.data_ptr() else
                    f", C {'unchanged' if torch.equal(cin, c) else 'CHANGED'}")
            parts.append(f"{case}: {err:.3e} of max |plain|, repeat "
                         f"{'equal' if same else 'DIFFERS'}{kept}")
        return "; ".join(parts)
    return cases, check, library


def paged_cases(gen, tiles):
    """The paged KV8 kernel at the smoke's two shapes over shuffled block
    tables, each held to its plain version (max abs)."""
    from how_to_optimize_gemm_tpu_torch.models import llama
    cases, refs = {}, {}
    for kvh, rep, d, ps, lens in ((32, 1, 128, 384, [1, 300, 1000, 4096]),
                                  (3, 2, 32, 96, [1, 999, 1000, 517])):
        np_max = -(-max(lens) // ps)
        n_pages = len(lens) * np_max + 1
        free = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
                + 1).tolist()
        table = torch.zeros((len(lens), np_max), dtype=torch.int32)
        for b, n in enumerate(lens):
            for c in range(-(-n // ps)):
                table[b, c] = free.pop()
        q = torch.randn((len(lens), kvh * rep, d), generator=gen,
                        device="cuda")
        pools = []
        for _ in "kv":
            pools += llama.quantize_kv(torch.randn(
                (n_pages, ps, kvh, d), generator=gen, device="cuda"))
        args = (q, *pools, table.cuda(),
                torch.tensor(lens, dtype=torch.int32, device="cuda"))
        case = f"paged_decode_attention_q8 kvh={kvh} rep={rep} d={d} ps={ps}"
        cases[case] = (lambda a=args:
                       paged_attention.paged_decode_attention_q8(*a))
        refs[case] = paged_attention.paged_decode_attention_q8_ref(*args)

    def check(name):
        return "; ".join(f"{case}: max|kernel - plain| "
                         f"{float((fn() - refs[case]).abs().max()):.3e}"
                         for case, fn in cases.items())
    return cases, check, {}


CASES = {"forward": forward_cases, "dkv": dkv_cases, "gemm": gemm_cases,
         "paged": paged_cases}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--group", choices=sorted(GROUPS), default="forward")
    ap.add_argument("--variants", nargs="*", default=None,
                    help="the group's variants to build (default: all)")
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR[:BK], another tree's csrc (and the "
                         "forward's key tile)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: needs a CUDA device")
    sources, variants = GROUPS[args.group]
    trees, tiles = {}, {}
    for name in (list(variants) if args.variants is None else args.variants):
        trees[name] = prepare(args.group, name, variants[name])
        tiles[name] = KEY_TILE.get(name, attention.KERNEL_BK)
    for spec in args.tree:
        name, rest = spec.split("=", 1)
        path, _, bk = rest.partition(":")
        trees[name] = pathlib.Path(path).resolve()
        tiles[name] = int(bk) if bk else attention.KERNEL_BK
    build(trees, sources)

    gen = torch.Generator("cuda").manual_seed(0)
    print(f"card: {torch.cuda.get_device_name(0)}")
    cases, check, library = CASES[args.group](gen, tiles)
    for name, csrc in list(trees.items()):
        use(csrc, sources)
        try:
            print(f"[{name}] {check(name)}")
        except RuntimeError as e:   # a launch the driver refuses
            print(f"[{name}] {e}; not timed")
            del trees[name]
    order = list(trees)
    times = {(n, c): [] for n in order for c in cases}
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            use(trees[name], sources)
            for case, fn in cases.items():
                times[name, case].append(time_calls(fn, graph=True) * 1e3)
    for case in cases:
        lib = library.get(case)
        print(f"{case}: library "
              + ("none" if lib is None else f"{lib:.4f} ms"))
        for name in order:
            ms = ", ".join(f"{t:.4f}" for t in times[name, case])
            print(f"  [{name}] {ms} ms")


if __name__ == "__main__":
    main()
