"""Interleaved same-session A/B protocol: a hand rung against the vendor
in turns, on one card.

Counterpart of ``how_to_optimize_gemm_tpu/harness/ab.py``:

1. Both rungs are prepared and gated against an fp64 oracle of their
   effective operands on the device (``_prep``) before anything is timed.
2. Rounds then strictly interleave: round r times one CUDA-event window of
   chained calls of A (each output the next call's C, about ``WINDOW_S``
   of device time) and then one of B, the order flipping every round, so
   slow drift (clocks, temperature, power) cancels instead of biasing the
   rung that goes first.
3. The verdict is per round: a rung wins round r if its per-call time
   beat the other's in that round; a round is a tie when the two differ
   by less than ``tie_rel`` (default 0.5%). Wins, ties and losses over the
   rounds and each rung's median make "faster, slower, tied" a statement
   of one session on one card.
4. Every session appends to ``<artifact_dir>/ab_<a>_vs_<b>.json``, with
   the card's name and power limit; re-running accumulates sessions in
   the same artifact. The default directory is the port's outputs,
   ``outputs/gpu``: an H100 session never joins the TPU sessions under
   ``outputs/``.

Hygiene, the reference's rule: a reading above the data-sheet ceiling of
the rung's compute type (``harness/profiling.H100_PEAKS``) is a broken
session, not speed, and raises.

Not ported: ``--tuned`` (the autotune bank, ``harness/autotune.py``)
raises NotImplementedError (ROADMAP A18).

CLI::

    python -m how_to_optimize_gemm_tpu_torch.harness.ab \\
        --a 15_packed_alias_bf16 --b 01b_xla_bf16 --p 2048 4096 --rounds 5
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time

import torch

from how_to_optimize_gemm_tpu_torch.harness.profiling import H100_PEAKS
from how_to_optimize_gemm_tpu_torch.ops import registry
from how_to_optimize_gemm_tpu_torch.utils.device import (card_line,
                                                         default_device)
from how_to_optimize_gemm_tpu_torch.utils.matrices import make_abc
from how_to_optimize_gemm_tpu_torch.utils.timing import time_chained

DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / "outputs" / "gpu"
TUNED_TODO = ("ab --tuned (the autotune bank, harness/autotune.py) is not "
              "ported yet (ROADMAP A18)")
WINDOW_S = 0.1   # device seconds of one timed window


@dataclasses.dataclass
class ABResult:
    p: int
    rounds: int
    a_gflops: list[float]        # per-round, interleaved
    b_gflops: list[float]
    wins_a: int
    wins_b: int
    ties: int
    a_median: float
    b_median: float


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _prep(rung_name: str, m: int, n: int, k: int, seed: int = 0,
          tuned: bool = False, device=None):
    """Prepare one rung, gate it on the device, and return (window, iters):
    window() times ``iters`` chained calls and returns the seconds a call."""
    if tuned:
        raise NotImplementedError(TUNED_TODO)
    rung = registry.get(rung_name)
    dev = default_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    a, b, c = make_abc(gen, m, n, k, dev)
    prepared = rung.prepare(a, b)
    out = rung.run(*prepared, c.clone())
    ae, be = rung.effective(prepared)
    ref = ae.double() @ be.double() + c.double()
    rel = float((out.double() - ref).abs().max()
                / ref.abs().max().clamp_min(1e-30))
    if rel > max(rung.gate_rel, 1e-5):
        raise RuntimeError(f"{rung_name} gate trip at p={m}: {rel:.2e}")
    per_call = time_chained(rung.run, prepared, c, inner_iters=2,
                            outer_repeats=1, warmup=1)
    iters = max(1, int(WINDOW_S / per_call))
    state = [c.clone()]

    def window() -> float:
        cc = state[0]
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                cc = rung.run(*prepared, cc)
            end.record()
            end.synchronize()
            sec = start.elapsed_time(end) * 1e-3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                cc = rung.run(*prepared, cc)
            sec = time.perf_counter() - t0
        state[0] = cc
        return sec / iters
    return window, iters


def _ceiling_gflops(rung_name: str) -> float:
    rung = registry.get(rung_name)
    return H100_PEAKS[rung.compute_dtype or rung.dtype][0]


def ab_at_size(rung_a: str, rung_b: str, p: int, *, rounds: int = 7,
               tie_rel: float = 0.005, tuned: bool = False,
               verbose: bool = True, device=None) -> ABResult:
    win_a, _ = _prep(rung_a, p, p, p, tuned=tuned, device=device)
    win_b, _ = _prep(rung_b, p, p, p, tuned=tuned, device=device)
    flops = 2.0 * p * p * p
    ceilings = {rung_a: _ceiling_gflops(rung_a),
                rung_b: _ceiling_gflops(rung_b)}
    # one unrecorded interleaved warm round
    win_a()
    win_b()
    a_g, b_g, wins_a, wins_b, ties = [], [], 0, 0, 0
    for r in range(rounds):
        if r % 2:                      # flip the order every round
            tb = win_b()
            ta = win_a()
        else:
            ta = win_a()
            tb = win_b()
        a_g.append(flops / ta / 1e9)
        b_g.append(flops / tb / 1e9)
        for name, g in ((rung_a, a_g[-1]), (rung_b, b_g[-1])):
            if g > ceilings[name]:
                raise RuntimeError(
                    f"broken session: {name} read {g:.1f} GFLOPS at p={p}, "
                    f"above its data-sheet ceiling {ceilings[name]:.1f}")
        if abs(ta - tb) < tie_rel * min(ta, tb):
            ties += 1
            tag = "tie"
        elif ta < tb:
            wins_a += 1
            tag = rung_a
        else:
            wins_b += 1
            tag = rung_b
        if verbose:
            print(f"  p={p} round {r}: {rung_a} {a_g[-1]:.1f} | "
                  f"{rung_b} {b_g[-1]:.1f} GFLOPS -> {tag}", flush=True)
    return ABResult(p, rounds, a_g, b_g, wins_a, wins_b, ties,
                    _median(a_g), _median(b_g))


def run_protocol(rung_a: str, rung_b: str, sizes: list[int], *,
                 rounds: int = 7, tie_rel: float = 0.005,
                 tuned: bool = False, artifact_dir=DEFAULT_DIR,
                 verbose: bool = True, device=None) -> list[ABResult]:
    """The protocol at every size; appends one session to the artifact."""
    if tuned:
        raise NotImplementedError(TUNED_TODO)
    dev = default_device(device)
    results = [ab_at_size(rung_a, rung_b, p, rounds=rounds, tie_rel=tie_rel,
                          verbose=verbose, device=dev)
               for p in sizes]
    path = pathlib.Path(artifact_dir) / f"ab_{rung_a}_vs_{rung_b}.json"
    data = json.loads(path.read_text()) if path.exists() else {
        "a": rung_a, "b": rung_b, "tie_rel": tie_rel, "sessions": []}
    data["sessions"].append({
        "when": time.strftime("%Y-%m-%d %H:%M UTC", time.gmtime()),
        "device": (card_line(dev.index or 0) if dev.type == "cuda"
                   else "cpu"),
        "rounds": rounds,
        "tuned": tuned,
        "sizes": [dataclasses.asdict(r) for r in results],
    })
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=1) + "\n")
    if verbose:
        for r in results:
            print(f"p={r.p}: {rung_a} median {r.a_median:.1f} vs "
                  f"{rung_b} {r.b_median:.1f} GFLOPS | "
                  f"{r.wins_a}-{r.ties}-{r.wins_b} (W-T-L for "
                  f"{rung_a})", flush=True)
        print(f"appended session to {path}")
    return results


def main(argv=None) -> list[ABResult]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", required=True, choices=registry.names())
    ap.add_argument("--b", required=True, choices=registry.names())
    ap.add_argument("--p", type=int, nargs="+", default=[3584, 4096])
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--tie-rel", type=float, default=0.005)
    ap.add_argument("--tuned", action="store_true",
                    help="the autotune bank (not ported: raises)")
    ap.add_argument("--artifact-dir", default=str(DEFAULT_DIR))
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)
    return run_protocol(args.a, args.b, args.p, rounds=args.rounds,
                        tie_rel=args.tie_rel, tuned=args.tuned,
                        artifact_dir=args.artifact_dir, device=args.device)


if __name__ == "__main__":
    main()
