"""Variant builds of the flash forward kernels, timed against each other
on the card in one process.

A variant is a copy of the port's ``csrc/`` under
``build/flash_variants/<name>/`` with textual substitutions applied (each
must match exactly once, so a variant that no longer fits the source
fails), or another tree's ``csrc/`` given with ``--tree NAME=DIR:BK`` (a
parent commit unpacked by ``git archive``, its key tile BK). For each,
``flash_attention`` at the 7B prefill row (B 4, H = KVH = 32, D 128,
S = T = 4,096, causal, (B, S, H, D) views) and ``flash_attention_fwd_lse``
at the soak's shape (B 8, H 32, KVH 4, S 1,024, D 64, causal, views), as
CUDA-graph replays, in rounds that walk the variants forwards and then
backwards; each output held to its plain version at the variant's key
tile (``bf16_row_ulps``; ``row_rel_err`` and the lse's max abs).

    python -m how_to_optimize_gemm_tpu_torch.harness.flash_variants \\
        [--variants shipped bk128 no_pingpong expf ...] \\
        [--tree parent=build/parent/how_to_optimize_gemm_tpu_torch/csrc:64]
"""
from __future__ import annotations

import argparse
import pathlib
import shutil

import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import attention
from how_to_optimize_gemm_tpu_torch.utils.timing import time_calls

SOURCES = ("flash_attention.cu", "flash_attention_fwd_lse.cu")
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
VARIANTS = {
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


def prepare(name: str, subs) -> pathlib.Path:
    """The port's csrc/ copied under OUT_DIR/name with ``subs`` applied."""
    dst = OUT_DIR / name / "csrc"
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


def use(csrc: pathlib.Path) -> None:
    """Point the build at ``csrc`` (the next launch loads its library)."""
    _build.CSRC = csrc
    for src in SOURCES:
        _build._LIBS.pop(src, None)


def build(trees: dict) -> None:
    """Both flash sources of every tree, one nvcc each, all at once."""
    started = []
    for csrc in trees.values():
        use(csrc)
        started += [(csrc, src, _build._start_build(src)) for src in SOURCES]
    for csrc, src, s in started:
        if s is not None:
            use(csrc)
            _build._finish_build(src, s)
    for name, csrc in trees.items():
        use(csrc)
        for kernel in ("flash_attention", "flash_attention_fwd_lse"):
            lines = [ln for ln in _build.build_log(kernel).splitlines()
                     if "flash" in ln or "registers" in ln or "arning" in ln]
            print(f"[{name}] {kernel} build:\n  " + "\n  ".join(lines))


def _views(b, n, heads, d, gen, dtype):
    return torch.randn((b, n, heads, d), generator=gen, device="cuda").to(
        dtype).transpose(1, 2)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR:BK, another tree's csrc and key tile")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: needs a CUDA device")
    trees, tiles = {}, {}
    for name in args.variants:
        trees[name] = prepare(name, VARIANTS[name])
        tiles[name] = KEY_TILE.get(name, attention.KERNEL_BK)
    for spec in args.tree:
        name, rest = spec.split("=", 1)
        path, bk = rest.rsplit(":", 1)
        trees[name], tiles[name] = pathlib.Path(path).resolve(), int(bk)
    build(trees)

    gen = torch.Generator("cuda").manual_seed(0)
    q, k, v = (_views(4, 4096, 32, 128, gen, torch.bfloat16) for _ in "qkv")
    tq = _views(8, 1024, 32, 64, gen, torch.float32)
    tk, tv = (_views(8, 1024, 4, 64, gen, torch.bfloat16) for _ in "kv")
    cases = {
        "flash_attention": lambda: attention.flash_attention(q, k, v),
        "flash_attention_fwd_lse": lambda: attention.flash_attention_fwd_lse(
            tq, tk, tv)}
    refs = {}
    for bk in sorted(set(tiles.values())):
        refs[bk] = (attention.flash_attention_ref(q, k, v, bk=bk),
                    attention.flash_attention_fwd_lse_ref(tq, tk, tv, bk=bk))
    print(f"card: {torch.cuda.get_device_name(0)}")
    for name, csrc in list(trees.items()):
        use(csrc)
        try:
            out = cases["flash_attention"]()
            o2, lse = cases["flash_attention_fwd_lse"]()
        except RuntimeError as e:   # a launch the driver refuses
            print(f"[{name}] {e}; not timed")
            del trees[name]
            continue
        ref, (ref2, ref_lse) = refs[tiles[name]]
        print(f"[{name}] key tile {tiles[name]}: flash_attention "
              f"{float(attention.bf16_row_ulps(out, ref).max()):.3f} bf16 "
              f"ulps of its row's max |plain|; fwd_lse out "
              f"{float(attention.row_rel_err(o2, ref2).max()):.3e} of its "
              f"row's max, lse {float((lse - ref_lse).abs().max()):.3e}")
    order = list(trees)
    times = {(n, c): [] for n in order for c in cases}
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            use(trees[name])
            for case, fn in cases.items():
                times[name, case].append(time_calls(fn, graph=True) * 1e3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = {"flash_attention": time_calls(
               lambda: sdpa(q, k, v, is_causal=True), graph=True) * 1e3,
           "flash_attention_fwd_lse": time_calls(
               lambda: sdpa(tq.to(torch.bfloat16), tk, tv, is_causal=True,
                            enable_gqa=True), graph=True) * 1e3}
    for case in cases:
        print(f"{case}: SDPA {lib[case]:.4f} ms")
        for name in order:
            ms = ", ".join(f"{t:.4f}" for t in times[name, case])
            print(f"  [{name}] {ms} ms")


if __name__ == "__main__":
    main()
