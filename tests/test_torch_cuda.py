"""The hand-written Hopper kernels against their plain versions, on the card.

Every test here needs a CUDA device and nvcc and skips without them (the
``cuda`` marker). This file imports no JAX, so it also runs on a machine
without it; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: each int8 GEMM kernel must EQUAL its plain version (exact
int32 accumulation, the same epilogue order), and the ladder's kernels
stay under their rung's gate_rel against an fp64 oracle of the effective
operands. The float ladder kernels' and the serving kernels' tolerances
are stated above their tests.
"""
import ctypes

import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu_torch import _build, convert
from how_to_optimize_gemm_tpu_torch.harness import profiling
from how_to_optimize_gemm_tpu_torch.harness.driver import run_sweep
from how_to_optimize_gemm_tpu_torch.harness.parameters import SweepConfig
from how_to_optimize_gemm_tpu_torch.ops import (attention, decode_attention,
                                               hand_pipeline, int4, int8,
                                               k_blocked,
                                               kv_update, manual_dma,
                                               mn_tile, naive,
                                               paged_attention, registry,
                                               tuned, vendor)

pytestmark = pytest.mark.cuda

# (M, N, K): aligned, nothing aligned (K=72 and K=1100 rows are not
# 16-byte multiples), two pack blocks, odd tiny edges, a full sweep size.
SHAPES = [(256, 256, 256), (200, 136, 72), (128, 384, 1024),
          (1000, 1032, 1100), (1000, 1032, 3584), (17, 9, 40), (1, 1, 1),
          (4096, 4096, 4096)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        _build.nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda")


def _abc(shape, seed, device):
    m, n, k = shape
    rng = np.random.default_rng(seed)
    a, b, c = (torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
               .to(device) for s in ((m, k), (k, n), (m, n)))
    return a, b, c


# The float ladder kernels: products of bf16 values (and of int4 weights
# decoded to bf16) are exact in fp32, and the tensor cores sum them in
# another order than the plain version: within W4A16_REL of max |plain|.
# The FFMA kernels sum one fmaf chain over K, the plain version in
# cuBLAS's fp32 order, and rung 16 three bf16 products of split operands
# (lo.lo dropped): within FP32_REL of max |plain|.
W4A16_REL = 2e-5
FP32_REL = 1e-5
CASES = {
    # kernel: (rung that prepares its operands, wrapper, plain version,
    # tolerance relative to max |plain|: 0 is EQUAL)
    "int8_gemm_nn": ("06_pallas_int8", int8.mmult_q, int8.mmult_q_ref, 0.0),
    "int8_gemm_nt": ("14_packed_alias_int8", int8.mmult_q_bt,
                     int8.mmult_q_bt_ref, 0.0),
    "w4a8_gemm": ("07b_pallas_w4a8", int4.mmult_q_w4a8,
                  int4.mmult_q_w4a8_ref, 0.0),
    "bf16_gemm_nt": ("15_packed_alias_bf16", tuned.mmult_bf16_bt,
                     tuned.mmult_bf16_bt_ref, W4A16_REL),
    "bf16_gemm_nn": ("05_pallas_bf16", tuned.mmult_bf16,
                     tuned.mmult_bf16_ref, W4A16_REL),
    "fp32_gemm_nt": ("16_packed_alias_fp32", tuned.mmult_fp32_bt,
                     tuned.mmult_fp32_bt_ref, FP32_REL),
    "fp32_gemm_nn": ("04_pallas_tuned_fp32", tuned.mmult, tuned.mmult_ref,
                     FP32_REL),
    "w4a16_gemm": ("07_pallas_int4", int4.mmult_q, int4.mmult_q_ref,
                   W4A16_REL),
    # the hand-pipeline record (rungs 08-11): fresh outputs, EQUAL
    "int8_dma_nn": ("08_manual_dma_int8", manual_dma.mmult_q,
                    manual_dma.mmult_q_ref, 0.0),
    "int8_fat_nn": ("09_fat_tile_int8", manual_dma.mmult_q_fat,
                    manual_dma.mmult_q_fat_ref, 0.0),
    "int8_fat_nt": ("10_packed_fat_int8", manual_dma.mmult_q_packed,
                    manual_dma.mmult_q_packed_ref, 0.0),
    "int8_strip_nt": ("11_strip_resident_int8", manual_dma.mmult_q_strip,
                      manual_dma.mmult_q_strip_ref, 0.0),
    # rungs 12 and 13 (fresh outputs), 17 and 18 (in place): EQUAL
    "int8_resident_nt": ("12_resident_int8", manual_dma.mmult_q_resident,
                         manual_dma.mmult_q_resident_ref, 0.0),
    "int8_tiled_resident_nt": ("13_tiled_resident_int8",
                               manual_dma.mmult_q_tiled_resident,
                               manual_dma.mmult_q_tiled_resident_ref, 0.0),
    "int8_hand_pipe_nt": ("17_hand_pipeline_int8",
                          hand_pipeline.mmult_q_bt_hand, int8.mmult_q_bt_ref,
                          0.0),
    "int8_ragged_nt": ("18_ragged_m_int8", int8.mmult_q_bt_ragged,
                       int8.mmult_q_bt_ref, 0.0),
}


def _operands(prepared):
    """The kernel's operands: 07's and 07b's prepare add kdim."""
    return [x for x in prepared if isinstance(x, torch.Tensor)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kernel", sorted(CASES))
def test_kernel_equals_plain_version(cuda, kernel, shape):
    rung_name, wrapper, plain, tol = CASES[kernel]
    rung = registry.get(rung_name)
    a, b, c = _abc(shape, SHAPES.index(shape), cuda)
    prepared = rung.prepare(a, b)
    ops = _operands(prepared)
    before = _build.LAUNCHES[kernel]
    out = wrapper(*ops, c.clone())
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == before + 1
    ref = plain(*ops, c)
    assert out.shape == c.shape
    err = float((out - ref).abs().max())
    if tol == 0.0:
        assert torch.equal(out, ref), err
    else:
        scale = float(ref.abs().max())
        print(f"{kernel} {shape}: max|kernel - plain| = {err:.3e} of "
              f"max|y| {scale:.3e}")
        assert err <= tol * scale, err / scale
    ae, be = rung.effective(prepared)
    oracle = ae.double() @ be.double() + c.double()
    rel = float((out.double() - oracle).abs().max()
                / oracle.abs().max().clamp_min(1e-30))
    assert rel < rung.gate_rel, rel


def test_in_place_kernels_write_c(cuda):
    """Rungs 14, 07b, 07, 15, 16, 17 and 18 write the result into C
    itself (N = 262: not a multiple of 4, C's rows stored by thread)."""
    a, b, c = _abc((300, 262, 520), 1, cuda)
    for kernel in ("int8_gemm_nt", "w4a8_gemm", "w4a16_gemm",
                   "bf16_gemm_nt", "fp32_gemm_nt", "int8_hand_pipe_nt",
                   "int8_ragged_nt"):
        rung_name, wrapper, plain, tol = CASES[kernel]
        ops = _operands(registry.get(rung_name).prepare(a, b))
        c2 = c.clone()
        out = wrapper(*ops, c2)
        assert out.data_ptr() == c2.data_ptr(), kernel
        ref = plain(*ops, c)
        assert float((c2 - ref).abs().max()) <= tol * float(
            ref.abs().max()), kernel


# More tiles than the persistent grid holds, and not a multiple of it
# (rung 09: 16 x 9 tiles of 128 x 256; 10 and 12: 16 x 17 of 128 x 128,
# some blocks 3 tiles; 11: 16 x 5
# cluster tiles of 2 x 256 columns, the last with one live block); 9 K
# chunks (K a multiple of
# 16, not of 64), over four times the ring's two slots; N not a multiple
# of 4 (C's rows padded for the bulk copies); M not a multiple of 128.
WALK_SHAPES = [(2001, 2102, 520), (4096, 4096, 4096)]


@pytest.mark.parametrize("shape", WALK_SHAPES)
@pytest.mark.parametrize("kernel", ["int8_dma_nn", "int8_fat_nn",
                                    "int8_fat_nt", "int8_strip_nt",
                                    "int8_resident_nt",
                                    "int8_tiled_resident_nt",
                                    "int8_hand_pipe_nt", "int8_ragged_nt"])
def test_hand_pipelines_wrap_rings_and_walks(cuda, kernel, shape):
    """Every ring slot and C/out buffer wraps at least twice and the
    persistent walk covers each tile once: EQUAL to the plain version,
    two calls alike, C unchanged (rungs 08-13) or the result (17, 18)."""
    rung_name, wrapper, plain, _ = CASES[kernel]
    a, b, c = _abc(shape, 3, cuda)
    ops = _operands(registry.get(rung_name).prepare(a, b))
    c0 = c.clone()
    out = wrapper(*ops, c.clone())
    again = wrapper(*ops, c.clone())
    run_on_c = wrapper(*ops, c)
    torch.cuda.synchronize()
    ref = plain(*ops, c0)
    assert torch.equal(out, ref), float((out - ref).abs().max())
    assert torch.equal(again, out)
    in_place = kernel in ("int8_hand_pipe_nt", "int8_ragged_nt")
    assert torch.equal(c, ref if in_place else c0)
    assert (run_on_c.data_ptr() == c.data_ptr()) is in_place


# Rung 15's wgmma kernel (persistent, one block an SM, 128 x 256 tiles, K
# stages of 64): a walk over more tiles than the H100's 132 SMs and no
# multiple of them (144), fewer rows than a consumer's 64, K no multiple
# of 64, a single row of tiles, tiny edges; C's rows of 16-byte multiples
# (N 520, 5000) take the epilogue that hands the sums to tensor-map
# reductions, the others (N 2102, 9, 257) each thread's own adds; within
# W4A16_REL of the plain version, two calls bit-equal.
NT_SHAPES = [(2001, 2102, 520), (33, 520, 1000), (40, 5000, 1000),
             (17, 9, 40), (129, 257, 72)]


@pytest.mark.parametrize("shape", NT_SHAPES)
def test_bf16_gemm_nt_edges_and_walk(cuda, shape):
    _, wrapper, plain, tol = CASES["bf16_gemm_nt"]
    a, b, c = _abc(shape, 5, cuda)
    ops = _operands(registry.get("15_packed_alias_bf16").prepare(a, b))
    out = wrapper(*ops, c.clone())
    again = wrapper(*ops, c.clone())
    torch.cuda.synchronize()
    ref = plain(*ops, c)
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    assert torch.equal(out, again)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lengths = {len(w) for w in tuned.nt_tile_walk(shape[0], shape[1], sms)}
    if shape == NT_SHAPES[0]:
        assert max(lengths) > 1 and len(lengths) > 1


# Rungs 16, 04 and 05 on rung 15's wgmma body (csrc/gemm_wgmma.cuh):
# rungs 16 and 04 (128 x 128 tiles, A and BT -- rung 04: B as it lies --
# split into bf16 planes by two split_bf16 launches, three products a
# stage, partial sums every CH stages; rung 04's seeded with C) within
# FP32_REL and rung 05 (128 x 256 tiles, B read N-major) within W4A16_REL
# of max |plain|, at 4,096, 2,048, the unaligned shape and K no multiple of
# the 64-value stage; two calls bit-equal; rung 16 writes C in place, rungs
# 04 and 05 leave it as it was. At K 4,096 rungs 16 and 04 are within
# FP32_REL / 2 of the fp64 product.
REBUILT_SHAPES = [(4096, 4096, 4096), (2048, 2048, 2048),
                  (1000, 1032, 1100), (520, 392, 1000)]


@pytest.mark.parametrize("shape", REBUILT_SHAPES)
@pytest.mark.parametrize("kernel", ["fp32_gemm_nt", "bf16_gemm_nn",
                                    "fp32_gemm_nn"])
def test_rebuilt_fp32_and_nn_kernels(cuda, kernel, shape):
    rung_name, wrapper, plain, tol = CASES[kernel]
    a, b, c = _abc(shape, 31, cuda)
    ops = _operands(registry.get(rung_name).prepare(a, b))
    before = dict(_build.LAUNCHES)
    cin = c.clone()
    out = wrapper(*ops, cin)
    torch.cuda.synchronize()
    counts = {k: _build.LAUNCHES[k] - before[k]
              for k in (kernel, "split_bf16")}
    fp32 = kernel.startswith("fp32")
    assert counts == {kernel: 1, "split_bf16": 2 if fp32 else 0}
    again = wrapper(*ops, c.clone())
    ref = plain(*ops, c)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= tol * scale
    assert torch.equal(out, again)
    if fp32 and shape[2] == 4096:
        a_, b_ = ops
        b_ = b_.t() if kernel == "fp32_gemm_nt" else b_
        oracle = a_.double() @ b_.double() + c.double()
        rel = float((out.double() - oracle).abs().max()
                    / oracle.abs().max())
        assert rel < FP32_REL / 2, rel
    if kernel == "fp32_gemm_nt":
        assert out.data_ptr() == cin.data_ptr()
    else:
        assert out.data_ptr() != cin.data_ptr() and torch.equal(cin, c)


@pytest.mark.parametrize("b_buffers", hand_pipeline.B_BUFFERS)
@pytest.mark.parametrize("a_lookahead", [False, True])
@pytest.mark.parametrize("shape", [(2001, 2102, 520), (17, 9, 40),
                                   (4096, 4096, 4096)])
def test_hand_pipeline_equals_rung_14(cuda, b_buffers, a_lookahead, shape):
    """Every built instance of rung 17 (K2's body at ring depth b_buffers,
    with or without lookahead) equals int8_gemm_nt's output bit for bit
    (the reference's test_bit_identical_to_rung14) and the plain version,
    in one launch of its own kernel."""
    a, b, c = _abc(shape, 4, cuda)
    ops = int8.prepare_packed(a, b)
    want = int8.mmult_q_bt(*ops, c.clone())
    before = dict(_build.LAUNCHES)
    got = hand_pipeline.mmult_q_bt_hand(*ops, c.clone(), b_buffers=b_buffers,
                                        a_lookahead=a_lookahead)
    torch.cuda.synchronize()
    assert (_build.LAUNCHES["int8_hand_pipe_nt"]
            == before["int8_hand_pipe_nt"] + 1)
    assert _build.LAUNCHES["int8_gemm_nt"] == before["int8_gemm_nt"]
    assert torch.equal(got, want)
    assert torch.equal(got, int8.mmult_q_bt_ref(*ops, c))


# Rung 11 on K2's body in clusters of manual_dma.CLUSTER blocks along N,
# into a fresh output through C loaded by tensor map: N's 256-column tiles
# one past a multiple of the cluster (the last cluster's surplus block
# copies zeros and stores nothing), rows fewer than a consumer's 64 and
# past a multiple of 128, K no multiple of the 128-byte stage, C's rows no
# 16-byte multiple (the wrapper pads them) and 4,096.
STRIP_SHAPES = [(300, 262, 520), (129, 520, 1100), (1, 300, 16),
                (1000, 1032, 1100), (200, 256 * (2 * manual_dma.CLUSTER + 1),
                                     200), (4096, 4096, 4096)]


@pytest.mark.parametrize("shape", STRIP_SHAPES)
def test_strip_cluster_equals_plain_version(cuda, shape):
    """EQUAL, C unchanged, two calls bit-equal, one launch; the kernel's
    cluster is manual_dma.CLUSTER blocks and the card runs some at once."""
    a, b, c = _abc(shape, 8, cuda)
    ops = int8.prepare_packed(a, b)
    kept = c.clone()
    before = dict(_build.LAUNCHES)
    out = manual_dma.mmult_q_strip(*ops, c)
    again = manual_dma.mmult_q_strip(*ops, c)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["int8_strip_nt"] == before["int8_strip_nt"] + 2
    assert torch.equal(c, kept)
    assert torch.equal(out, manual_dma.mmult_q_strip_ref(*ops, c))
    assert torch.equal(again, out)
    size, active = manual_dma.strip_clusters()
    assert size == manual_dma.CLUSTER and active >= 1


# Rungs 10, 12 and 13 on K2's body as a ping-pong (csrc/int8_fat.cu,
# int8_resident.cu on gemm_wgmma.cuh; 13 fed by 1-D bulk copies of
# int8_pretile's stage images): each consumer warpgroup computes
# whole 128 x 128 tiles, the two taking a block's tiles in turn. Rows fewer
# than a product's 64 and past a multiple of 128, K no multiple of the
# 128-byte stage, C's rows no 16-byte multiple (the wrapper pads them), the
# walk wrapping the grid (WALK: some blocks take 3 tiles, some 2) and
# 4,096; "odd" is 3 x the card's SMs tiles: every block takes three,
# consumer 0 two of them.
PINGPONG_SHAPES = [(300, 262, 520), (129, 520, 1100), (1, 300, 16),
                   (2001, 2102, 520), "odd", (4096, 4096, 4096)]
PINGPONG = {"int8_fat_nt": manual_dma.mmult_q_packed,
            "int8_resident_nt": manual_dma.mmult_q_resident,
            "int8_tiled_resident_nt": manual_dma.mmult_q_tiled_resident}


@pytest.mark.parametrize("shape", PINGPONG_SHAPES)
@pytest.mark.parametrize("kernel", sorted(PINGPONG))
def test_pingpong_equals_plain_version(cuda, kernel, shape):
    """EQUAL, C unchanged, two calls bit-equal, one launch of its own
    kernel a call (rungs 12 and 13 stay resident at every shape here;
    13's two repacks a call)."""
    if shape == "odd":
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        tm, tn = manual_dma.PINGPONG_TILE
        shape = (3 * tm, sms * tn, 520)
    a, b, c = _abc(shape, 9, cuda)
    ops = int8.prepare_packed(a, b)
    kept = c.clone()
    before = dict(_build.LAUNCHES)
    out = PINGPONG[kernel](*ops, c)
    again = PINGPONG[kernel](*ops, c)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == before[kernel] + 2
    assert _build.LAUNCHES["int8_strip_nt"] == before["int8_strip_nt"]
    assert (_build.LAUNCHES["int8_pretile"] - before["int8_pretile"]
            == (4 if kernel == "int8_tiled_resident_nt" else 0))
    assert torch.equal(c, kept)
    assert torch.equal(out, manual_dma.mmult_q_packed_ref(*ops, c))
    assert torch.equal(again, out)


def test_k2_right_after_rung_12(cuda):
    """K2 right after rung 12 at 4,096 (whose operands' L2 lines rung 12
    set back to evict_normal): both EQUAL to the plain version."""
    a, b, c = _abc((4096, 4096, 4096), 10, cuda)
    ops = int8.prepare_packed(a, b)
    res = manual_dma.mmult_q_resident(*ops, c)
    k2 = int8.mmult_q_bt(*ops, c.clone())
    torch.cuda.synchronize()
    ref = int8.mmult_q_bt_ref(*ops, c)
    assert torch.equal(res, ref)
    assert torch.equal(k2, ref)


def test_k2_right_after_rung_13(cuda):
    """K2 right after rung 13 at 4,096 (whose images' L2 lines rung 13 set
    back to evict_normal): both EQUAL to the plain version."""
    a, b, c = _abc((4096, 4096, 4096), 11, cuda)
    ops = int8.prepare_packed(a, b)
    tiled = manual_dma.mmult_q_tiled_resident(*ops, c)
    k2 = int8.mmult_q_bt(*ops, c.clone())
    torch.cuda.synchronize()
    ref = int8.mmult_q_bt_ref(*ops, c)
    assert torch.equal(tiled, ref)
    assert torch.equal(k2, ref)


@pytest.mark.parametrize("shape,cap", [((4096, 1024, 520), 1664),
                                       ((640, 256, 256), 256),
                                       ((2001, 2102, 520), 512)])
def test_ragged_plans_on_the_card(cuda, shape, cap):
    """Rung 18 on a two-piece plan (the reference's 4096 at cap 1664, and
    the CPU tests' 640 at cap 256) and on a uniform one: one launch of its
    own kernel, EQUAL to the plain version."""
    a, b, c = _abc(shape, 5, cuda)
    ops = int8.prepare_packed(a, b)
    before = dict(_build.LAUNCHES)
    out = int8.mmult_q_bt_ragged(*ops, c.clone(), cap=cap)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["int8_ragged_nt"] == before["int8_ragged_nt"] + 1
    assert _build.LAUNCHES["int8_gemm_nt"] == before["int8_gemm_nt"]
    assert torch.equal(out, int8.mmult_q_bt_ref(*ops, c))


# K2 and rung 18 on gemm_wgmma.cuh's int8 instance (128 x 256 tiles, K
# stages of 128 bytes, one block an SM): M under a consumer's 64 rows, one
# past it and three row tiles; N of 262 (C's rows no 16-byte multiple:
# each thread adds C), 520 and 1,032 (the tensor-map reduction adds it);
# K of one 16-byte chunk, no multiple of the stage, and 4,112 (33 stages,
# the ring wrapping eight times): EQUAL to the plain version, in place,
# one launch of the kernel's own a call.
INT8_WGMMA = {"int8_gemm_nt": int8.mmult_q_bt,
              "int8_ragged_nt": int8.mmult_q_bt_ragged}


@pytest.mark.parametrize("k", [16, 520, 4112])
@pytest.mark.parametrize("n", [262, 520, 1032])
@pytest.mark.parametrize("m", [1, 65, 300])
@pytest.mark.parametrize("kernel", sorted(INT8_WGMMA))
def test_int8_wgmma_edges(cuda, kernel, m, n, k):
    a, b, c = _abc((m, n, k), m + n + k, cuda)
    ops = int8.prepare_packed(a, b)
    before = dict(_build.LAUNCHES)
    cin = c.clone()
    out = INT8_WGMMA[kernel](*ops, cin)
    torch.cuda.synchronize()
    assert {name: _build.LAUNCHES[name] - before[name]
            for name in INT8_WGMMA} == {
                name: int(name == kernel) for name in INT8_WGMMA}
    assert out.data_ptr() == cin.data_ptr()
    ref = int8.mmult_q_bt_ref(*ops, c)
    assert torch.equal(out, ref), float((out - ref).abs().max())


@pytest.mark.parametrize("shape", [(2001, 2102, 520), (4096, 4096, 4096)])
@pytest.mark.parametrize("kernel", sorted(INT8_WGMMA))
def test_int8_wgmma_walks_wrap_the_grid(cuda, kernel, shape):
    """At 2001 x 2102 the 144 tiles wrap the one-block-an-SM grid (each
    block 1 or 2 tiles; the card's SMs from its properties); at 4,096 512
    tiles: EQUAL to the plain version, two calls bit-equal."""
    m, n, _ = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lengths = {len(w) for w in tuned.nt_tile_walk(m, n, sms, int8.NT_TILE)}
    assert len(lengths) > 1 or max(lengths) > 1
    a, b, c = _abc(shape, 22, cuda)
    ops = int8.prepare_packed(a, b)
    out = INT8_WGMMA[kernel](*ops, c.clone())
    again = INT8_WGMMA[kernel](*ops, c.clone())
    torch.cuda.synchronize()
    assert torch.equal(out, int8.mmult_q_bt_ref(*ops, c))
    assert torch.equal(out, again)


@pytest.mark.parametrize("n", [264, 262])
@pytest.mark.parametrize("kernel", sorted(INT8_WGMMA))
def test_int8_wgmma_keeps_subnormals(cuda, kernel, n):
    """sa = 2^-120 and sb = 2^-30 passed to the kernel directly make
    v = (acc x 2^-120) x 2^-30 subnormal for 2 <= |acc| < 2^23, and C holds
    subnormals of both signs, so v + C is subnormal too: the dequant's
    products and the add of C (N 264: the tensor-map reduction; 262: each
    thread's __fadd_rn) keep them, EQUAL to the plain version."""
    m, k = 300, 520
    rng = np.random.default_rng(21)
    qa, qbt = (torch.from_numpy(rng.integers(-127, 128, s).astype(np.int8))
               .to(cuda) for s in ((m, k), (n, k)))
    sa = torch.full((m, 1), 2.0 ** -120, device=cuda)
    sb = torch.full((1, n), 2.0 ** -30, device=cuda)
    c = torch.from_numpy((rng.integers(-2 ** 20, 2 ** 20, (m, n))
                          * 2.0 ** -149).astype(np.float32)).to(cuda)
    out = INT8_WGMMA[kernel](qa, sa, qbt, sb, c.clone())
    ref = int8.mmult_q_bt_ref(qa, sa, qbt, sb, c)
    torch.cuda.synchronize()
    tiny = ref.abs() < torch.finfo(torch.float32).tiny
    assert float(tiny.float().mean()) > 0.9
    assert float((ref[tiny] != 0).float().mean()) > 0.9
    assert torch.equal(out, ref), int((out != ref).sum())


@pytest.mark.parametrize("shape", [(1000, 1104), (2102, 528), (1, 16),
                                   (4096, 4096), (300, 1104)])
def test_pretile_equals_plain_version(cuda, shape):
    """Byte for byte (the swizzled stage images, zeros past the rows and
    K; 300 rows: a tile count that is odd); K must be a multiple of 16
    (the wrappers pad it)."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    got = manual_dma.pretile(x.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), manual_dma.pretile_ref(x))
    with pytest.raises(ValueError):
        manual_dma.pretile(x[:, :-8].contiguous().to(cuda))


def test_resident_rungs_stay_resident_at_4096(cuda):
    """At p = 4096 rungs 12 and 13 launch their own kernels, not rung 11's:
    the card's L2 budget holds their operands."""
    a, b, c = _abc((4096, 4096, 4096), 7, cuda)
    ops = int8.prepare_packed(a, b)
    for kernel in ("int8_resident_nt", "int8_tiled_resident_nt"):
        before = dict(_build.LAUNCHES)
        CASES[kernel][1](*ops, c)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[kernel] == before[kernel] + 1
        assert _build.LAUNCHES["int8_strip_nt"] == before["int8_strip_nt"]


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    a, b, c = _abc((64, 64, 64), 2, cuda)
    qa, sa, qb, sb = int8.prepare(a, b)
    with pytest.raises(ValueError):
        int8.mmult_q(qa, sa, qb, sb, c.t())        # non-contiguous C
    with pytest.raises(TypeError):
        int8.mmult_q(qa.float(), sa, qb, sb, c)    # wrong dtype
    with pytest.raises(ValueError):
        int8.mmult_q(qa, sa, qb[:32], sb, c)       # K mismatch


@pytest.mark.parametrize("name", registry.names())
def test_rung_sweep_on_card(cuda, name):
    rows = run_sweep(name, SweepConfig(pfirst=256, plast=768, pinc=512,
                                       nrepeats=2, warmup=1),
                     verbose=False, device=cuda)
    assert all(r.kernel_rel < registry.get(name).gate_rel for r in rows)


# The fp32 rungs below 04, against the plain version's cuBLAS fp32
# product: within FP32_REL of max |plain|. Rung 00 runs one fmaf chain
# over K for each output; rungs 02, 03 and 03b three bf16 products of
# operands split inside the kernel (bf16x3: hi.hi + hi.lo + lo.hi, XLA's
# Precision.HIGH) with fp32 sums, whose partials of 128 K are added in
# fp32: within FP32_REL / 2 at K 4,096, as rung 04 is held. Two calls are
# bit-equal. (rung, kernel, wrapper, plain version)
BASE_RUNGS = {
    "00_naive_vpu": ("naive_gemm", naive.mmult, naive.naive_ref),
    "02_pallas_mn_tile": ("fp32_gemm_mn_tile", mn_tile.mmult,
                          mn_tile.mn_tile_ref),
    "03_pallas_k_blocked": ("fp32_gemm_k_blocked", k_blocked.mmult,
                            k_blocked.k_blocked_ref),
    "03b_pallas_small_blocks": ("fp32_gemm_k_blocked",
                                k_blocked.mmult_small,
                                k_blocked.k_blocked_ref),
}
# K and N rows not 16-byte multiples; p = 1024; edges smaller than one
# block (and than a warp); one block edge and a bit; a long K
BASE_SHAPES = [(999, 1030, 1101), (1024, 1024, 1024), (17, 9, 40),
               (130, 260, 300), (256, 256, 4096)]
# the split rungs' rule at K >= LONG_K
LONG_K = 4096


@pytest.mark.parametrize("shape", BASE_SHAPES)
@pytest.mark.parametrize("rung_name", sorted(BASE_RUNGS))
def test_ladder_base_kernels_equal_plain_version(cuda, rung_name, shape):
    kernel, wrapper, plain = BASE_RUNGS[rung_name]
    a, b, c = _abc(shape, 50 + BASE_SHAPES.index(shape), cuda)
    c_in = c.clone()
    before = _build.LAUNCHES[kernel]
    out = wrapper(a, b, c)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == before + 1
    assert torch.equal(c, c_in)                  # a fresh output
    ref = plain(a, b, c)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"{rung_name} {shape}: max|kernel - plain| = {err:.3e} of "
          f"max|y| {scale:.3e}")
    split = rung_name != "00_naive_vpu"
    tol = FP32_REL / 2 if split and shape[2] >= LONG_K else FP32_REL
    assert err <= tol * scale, err / scale
    oracle = a.double() @ b.double() + c.double()
    rel = float((out.double() - oracle).abs().max() / oracle.abs().max())
    assert rel < registry.get(rung_name).gate_rel, rel
    assert torch.equal(wrapper(a, b, c), out)    # two calls bit-equal


def _edge_values(n, seed):
    """n fp32 values: signed zeros, fp32 subnormals, the largest values
    whose bf16 rounding stays finite, and normals over 2^-100 .. 2^100."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 2.0 ** rng.integers(-100, 100, n))
    x = x.astype(np.float32)
    bits = np.array([0x80000000, 0x00000001, 0x80000001, 0x007FFFFF,
                     0x00012345, 0x7F7F7FFF, 0xFF7F7FFF, 0x7F7F0000],
                    dtype=np.uint32)
    x[:bits.size] = bits.view(np.float32)
    x[bits.size] = 0.0
    return torch.from_numpy(x)


@pytest.mark.parametrize("rung_name", ["02_pallas_mn_tile",
                                       "03_pallas_k_blocked",
                                       "03b_pallas_small_blocks"])
def test_ladder_split_in_kernel_holds_edge_values(cuda, rung_name):
    """Each operand's split inside the kernel, read through an identity:
    out = X @ I + 0 (A's split) and I @ X + 0 (B's) is hi + lo of X, which
    is X within 2^-17 |x| where |x| >= 2^-117 (zeros exact, the largest
    finite-rounding values included) and within 2^-134 (half the smallest
    bf16 subnormal) below it."""
    _, wrapper, _ = BASE_RUNGS[rung_name]
    k = 256
    x = _edge_values(k * 96, 5).reshape(96, k)
    eye = torch.eye(k)
    for a, b, want in ((x, eye, x), (eye, x.t().contiguous(),
                                     x.t().contiguous())):
        a, b = a.to(cuda), b.to(cuda)
        c = torch.zeros((a.shape[0], b.shape[1]), device=cuda)
        got = wrapper(a, b, c).cpu().double()
        want = want.double()
        err = (got - want).abs()
        big = want.abs() >= 2.0 ** -117
        print(f"{rung_name}: max rel {float((err / want.abs())[big].max())}"
              f", max abs below 2^-117 {float(err[~big].max())}")
        assert torch.all(err[big] <= 2.0 ** -17 * want.abs()[big])
        assert torch.all(err[~big] <= 2.0 ** -134)


def test_k_blocked_refuses_other_blocks(cuda):
    a, b, c = _abc((64, 64, 64), 4, cuda)
    with pytest.raises(ValueError):
        k_blocked.mmult(a, b, c, block=32)
    with pytest.raises(ValueError):
        naive.mmult(a, b[:32], c)                  # K mismatch


# ---------------------------------------------------------------- serving
# The four serving kernels. Kernels w4a8_gemm_noc, w4a8_gemv_fq and
# kv_update must EQUAL their plain versions (exact int32 sums and the same
# epilogue order; byte copies). decode_attention sums in another order
# than its plain version, and p is rounded to bf16 after an exp that may
# differ by an ulp, which can flip one bf16 rounding: atol 2e-3 on outputs
# of magnitude ~1.

def _w4a8_weights(k, n, seed, device):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    _, _, packed, sw, _ = int4.prepare_w4a8(torch.zeros((1, k)), w)
    return packed.to(device), sw.to(device)


def _activations(m, k, seed, device):
    """Rows of x with an all-zero row (the 1e-8 scale floor) and one row
    of exact .5 ties after scaling (amax 127 gives scale 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if m > 1:
        x[1] = 0.0
    if m > 2:
        x[2] = np.round(rng.uniform(-120, 120, k)) + 0.5
        x[2, 0] = 127.0
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("m,n,k", [(65, 384, 700), (200, 136, 72),
                                   (1, 9, 40), (1024, 1032, 1100),
                                   (300, 4096, 4096)])
def test_w4a8_gemm_noc_equals_plain_version(cuda, m, n, k):
    x = _activations(m, k, m + n, cuda)
    qa, sa = int4.quant.quantize_symmetric(x, axis=1)
    packed, sw = _w4a8_weights(k, n, k, cuda)
    before = _build.LAUNCHES["w4a8_gemm_noc"]
    out = int4.mmult_q_w4a8_noc(qa, sa, packed, sw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["w4a8_gemm_noc"] == before + 1
    ref = int4.mmult_q_w4a8_noc_ref(qa, sa, packed, sw)
    assert out.shape == (m, n)
    assert torch.equal(out, ref), float((out - ref).abs().max())


# The wgmma kernel's edges: m at the 64- and 128-token tiles' borders,
# K = 256 (one stage whose high nibbles meet only zero columns), 512 (both
# nibbles of one pack block in two stages) and 768 (a second block's low
# half), N ragged and past one 256-column tile, and the two 7B shapes at
# m = 1,024; each call one launch, EQUAL to the plain version. The cases
# take both token tiles, as the kernel's own count of its launches of each
# tile reads on the card (w4a8_gemm_noc_tile_launches).
W4A8_EDGES = [(64, 520, 512), (65, 520, 768), (128, 136, 256),
              (256, 1032, 768), (257, 1032, 256), (257, 11008, 768),
              (1024, 11008, 4096), (1024, 4096, 11008)]


def _w4a8_tile_launches():
    fn = _build.c_function("w4a8_gemm_noc.cu", "w4a8_gemm_noc_tile_launches",
                           (ctypes.c_int,))
    return {bt: fn(bt) for bt in (64, 128)}


def _w4a8_edge_call(m, n, k, device):
    """One w4a8_gemm_noc call at an edge: its output, its plain
    version's and the token tile the kernel launched."""
    x = _activations(m, k, 3 * m + n, device)
    qa, sa = int4.quant.quantize_symmetric(x, axis=1)
    packed, sw = _w4a8_weights(k, n, k + 1, device)
    before, tiles = _build.LAUNCHES["w4a8_gemm_noc"], _w4a8_tile_launches()
    out = int4.mmult_q_w4a8_noc(qa, sa, packed, sw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["w4a8_gemm_noc"] == before + 1
    after = _w4a8_tile_launches()
    moved = [bt for bt in after if after[bt] != tiles[bt]]
    assert len(moved) == 1 and after[moved[0]] == tiles[moved[0]] + 1, (
        tiles, after)
    ref = int4.mmult_q_w4a8_noc_ref(qa, sa, packed, sw)
    return out, ref, moved[0], (qa, sa, packed, sw)


def test_w4a8_edges_take_both_token_tiles(cuda):
    tiles = {_w4a8_edge_call(m, n, k, cuda)[2] for m, n, k in W4A8_EDGES}
    assert tiles == {64, 128}


@pytest.mark.parametrize("m,n,k", W4A8_EDGES)
def test_w4a8_gemm_noc_wgmma_edges(cuda, m, n, k):
    out, ref, _, args = _w4a8_edge_call(m, n, k, cuda)
    assert out.shape == (m, n)
    assert torch.equal(out, ref), float((out - ref).abs().max())
    assert torch.equal(int4.mmult_q_w4a8_noc(*args), out)


# The fused GEMV is one kernel a call (the quantization inside it), EQUAL
# to its plain version: K = 700 and 11,008 not multiples of 512, N = 1000
# and 384 not of the 128-column slab, m from 1 to 64 (16: one full row
# tile; 64: four). At N = 1000 the packed rows are no 16-byte multiple,
# which the tensor map needs: the wrapper pads them first (a fill and a
# copy), as it always has.
@pytest.mark.parametrize("m", [1, 4, 5, 16, 64])
@pytest.mark.parametrize("n,k", [(384, 700), (1000, 4096), (4096, 11008)])
def test_w4a8_gemv_fq_equals_plain_version(cuda, m, n, k):
    x = _activations(m, k, 7 * m + k, cuda)
    packed, sw = _w4a8_weights(k, n, n, cuda)
    before = _build.LAUNCHES["w4a8_gemv_fq"]
    out = int4.mmult_w4a8_fused_noc(x, packed, sw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["w4a8_gemv_fq"] == before + 1
    # the kernels the card ran for one call (LAUNCHES counts Python calls)
    kernels = profiling.call_profile(
        lambda: int4.mmult_w4a8_fused_noc(x, packed, sw)).kernels
    assert sum("gemv_fq" in name for name in kernels) == 1, kernels
    assert len(kernels) == 1 or n % 16, kernels
    ref = int4.mmult_w4a8_fused_noc_ref(x, packed, sw)
    assert out.shape == (m, n)
    assert torch.equal(out, ref), float((out - ref).abs().max())


# From a CUDA graph, replayed on new x in place: the same bits as an eager
# call (no workspace, counter or atomic carries over between calls).
@pytest.mark.parametrize("m,n,k", [(4, 11008, 4096), (64, 4096, 11008),
                                   (5, 1000, 700)])
def test_w4a8_gemv_fq_graph_replays(cuda, m, n, k):
    packed, sw = _w4a8_weights(k, n, k + n, cuda)
    x = _activations(m, k, 1, cuda)
    int4.mmult_w4a8_fused_noc(x, packed, sw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = int4.mmult_w4a8_fused_noc(x, packed, sw)
    for seed in (2, 3, 4):
        x.copy_(_activations(m, k, seed, cuda))
        graph.replay()
        torch.cuda.synchronize()
        ref = int4.mmult_w4a8_fused_noc_ref(x, packed, sw)
        assert torch.equal(replayed, ref), float((replayed - ref).abs().max())
        assert torch.equal(replayed, int4.mmult_w4a8_fused_noc(x, packed, sw))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("rest", [(2, 128), (3, 5)])
def test_kv_update_equals_plain_version(cuda, dtype, s, rest):
    b, t = 4, 64
    rng = np.random.default_rng(s)
    cache = torch.from_numpy(
        rng.standard_normal((b, t, *rest)).astype(np.float32)).to(
            device=cuda, dtype=dtype)
    new = torch.from_numpy(
        rng.standard_normal((b, s, *rest)).astype(np.float32)).to(cuda)
    pos = torch.tensor([0, t - 2, -2, 17], dtype=torch.int32, device=cuda)
    mask = torch.tensor([True, True, True, False], device=cuda)
    for wm in (None, mask):
        got = cache.clone()
        before = _build.LAUNCHES["kv_update"]
        out = kv_update.kv_update(got, new, pos, wm)
        torch.cuda.synchronize()
        assert out.data_ptr() == got.data_ptr()
        assert _build.LAUNCHES["kv_update"] == before + 1
        ref = kv_update.kv_update_ref(cache.clone(), new, pos, wm)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("kvh,rep,d", [(2, 2, 128), (16, 1, 128),
                                       (4, 4, 64), (8, 4, 128), (3, 2, 32)])
def test_decode_attention_matches_plain_version(cuda, kvh, rep, d):
    b, t = 4, 256
    rng = np.random.default_rng(kvh * rep * d)
    q = torch.from_numpy(rng.standard_normal((b, kvh * rep, d)).astype(
        np.float32)).to(cuda)
    k, v = (torch.from_numpy(rng.standard_normal((b, t, kvh, d)).astype(
        np.float32)).to(device=cuda, dtype=torch.bfloat16) for _ in "kv")
    lengths = torch.tensor([1, 129, 256, 0], dtype=torch.int32,
                           device=cuda)
    bk = 128
    # rows past each slot's last live chunk are never read: NaN there
    # must not reach the output
    for c in (k, v):
        c[0, bk:] = float("nan")
        c[3] = float("nan")
    before = _build.LAUNCHES["decode_attention"]
    out = decode_attention.decode_attention(q, k, v, lengths, bk=bk)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode_attention"] == before + 1
    ref = decode_attention.decode_attention_ref(q, k, v, lengths, bk=bk)
    assert out.shape == (b, kvh * rep * d)
    assert torch.isfinite(out).all()
    err = float((out - ref).abs().max())
    print(f"decode_attention kvh={kvh} rep={rep} d={d}: max|kernel - "
          f"plain| = {err}")
    assert err < 2e-3, err


# The split walk: T = 1,024 at the reference's chunk (bk 128 at kvh 4 and
# 8, 512 at kvh 2: splits of 2 and 1 chunks, split_plan), slots of length
# 0, 1, a split's last key, the next split's first and T. Within 2e-3 of
# the plain version as above (p rounded against a split's running max);
# one launch a call, the same bits over repeats and from a CUDA graph's
# replay, the workspace's counters back at 0.
@pytest.mark.parametrize("kvh,rep,d", [(4, 2, 128), (2, 4, 128),
                                       (8, 1, 64), (3, 2, 32)])
def test_decode_attention_splits_long_slots(cuda, kvh, rep, d):
    t = 1024
    bk = decode_attention.pick_block(t, kvh, d, 2)
    per, splits = decode_attention.split_plan(t, bk)
    assert splits > 1
    lens = [0, 1, per * bk, per * bk + 1, t]
    rng = np.random.default_rng(kvh * rep + d)
    q = torch.from_numpy(rng.standard_normal((len(lens), kvh * rep, d))
                         .astype(np.float32)).to(cuda)
    k, v = (torch.from_numpy(rng.standard_normal((len(lens), t, kvh, d))
                             .astype(np.float32)).to(device=cuda,
                                                     dtype=torch.bfloat16)
            for _ in "kv")
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)

    def call():
        return decode_attention.decode_attention(q, k, v, lengths)

    before = _build.LAUNCHES["decode_attention"]
    out = call()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode_attention"] == before + 1
    counters = decode_attention._WORKSPACE[out.device][0]
    assert not counters.any()
    ref = decode_attention.decode_attention_ref(q, k, v, lengths)
    err = float((out - ref).abs().max())
    print(f"decode_attention split kvh={kvh} rep={rep} d={d} bk={bk}: "
          f"max|kernel - plain| = {err}")
    assert err < 2e-3, err
    assert not out[0].any()
    assert torch.equal(call(), out)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, out)
    assert not counters.any()


# Slice 3's kernels. int8_gemm_noc must EQUAL its plain version (exact
# int32 sums, the same epilogue). The W4A16 kernels' products are exact in
# fp32 but summed in another order (by the tensor cores for the GEMM, whose
# fp32 adds do not round as IEEE does): within W4A16_REL of max |y|.
# decode_attention_q8 as decode_attention: atol 2e-3.


@pytest.mark.parametrize("m,n,k", [(256, 256, 256), (300, 136, 72),
                                   (1, 9, 40), (1000, 1032, 1100),
                                   (1024, 11008, 4096)])
def test_int8_gemm_noc_equals_plain_version(cuda, m, n, k):
    x = _activations(m, k, m + n, cuda)
    qa, sa = int8.quant.quantize_symmetric(x, axis=1)
    w = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (k, n)).astype(np.float32)).to(cuda)
    qb, sb = int8.quant.quantize_symmetric(w, axis=0)
    before = _build.LAUNCHES["int8_gemm_noc"]
    out = int8.mmult_q_noc(qa, sa, qb, sb)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["int8_gemm_noc"] == before + 1
    ref = int8.mmult_q_noc_ref(qa, sa, qb, sb)
    assert out.shape == (m, n)
    assert torch.equal(out, ref), float((out - ref).abs().max())


# The int8 prefill GEMMs on w4a8_wgmma.cuh's int8 wgmma body:
# int8_gemm_noc (plain int8 weights) and K3 w4a8_gemm (packed weights, C
# added in place in the epilogue). Each case is one launch of one token
# tile (the kernel's own count, *_tile_launches), EQUAL to the plain
# version and to a second call: m at 65 and 128 (64-token tiles), the 7B
# shapes at m = 1,024 and 4,096 tokens at K = 1,100 (128-token tiles, more
# tiles than the persistent grid), K not a multiple of 128 (700, 1,100),
# N not a multiple of 4 (262: C and out by each thread) and ragged past a
# 256-column tile.
WGMMA_S8_EDGES = [(65, 384, 700), (128, 262, 1100), (300, 1032, 4096),
                  (1024, 11008, 4096), (1024, 4096, 11008),
                  (4096, 4096, 1100)]


def _tile_launches(source, name):
    fn = _build.c_function(source, name, (ctypes.c_int,))
    return {bt: fn(bt) for bt in (64, 128)}


def _one_tile_launch(kernel, source, call):
    """call() once: its output and the token tile it launched (one launch
    of the wrapper's kernel, of one tile)."""
    name = f"{kernel}_tile_launches"
    before, tiles = _build.LAUNCHES[kernel], _tile_launches(source, name)
    out = call()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == before + 1
    after = _tile_launches(source, name)
    moved = [bt for bt in after if after[bt] != tiles[bt]]
    assert len(moved) == 1 and after[moved[0]] == tiles[moved[0]] + 1, (
        tiles, after)
    return out, moved[0]


def _int8_noc_case(m, n, k, device):
    x = _activations(m, k, m + 2 * n, device)
    qa, sa = int8.quant.quantize_symmetric(x, axis=1)
    w = torch.from_numpy(np.random.default_rng(k + n).standard_normal(
        (k, n)).astype(np.float32)).to(device)
    qb, sb = int8.quant.quantize_symmetric(w, axis=0)
    return qa, sa, qb, sb


def _w4a8_c_case(m, n, k, device):
    x = _activations(m, k, m + 3 * n, device)
    qa, sa = int4.quant.quantize_symmetric(x, axis=1)
    packed, sw = _w4a8_weights(k, n, k + 2 * n, device)
    c = torch.from_numpy(np.random.default_rng(m * n).uniform(
        -1, 1, (m, n)).astype(np.float32)).to(device)
    return qa, sa, packed, sw, c


@pytest.mark.parametrize("m,n,k", WGMMA_S8_EDGES)
def test_int8_gemm_noc_wgmma_edges(cuda, m, n, k):
    args = _int8_noc_case(m, n, k, cuda)
    out, _ = _one_tile_launch("int8_gemm_noc", "int8_gemm_noc.cu",
                              lambda: int8.mmult_q_noc(*args))
    ref = int8.mmult_q_noc_ref(*args)
    assert out.shape == (m, n)
    assert torch.equal(out, ref), float((out - ref).abs().max())
    assert torch.equal(int8.mmult_q_noc(*args), out)


@pytest.mark.parametrize("m,n,k", WGMMA_S8_EDGES)
def test_w4a8_gemm_wgmma_edges(cuda, m, n, k):
    qa, sa, packed, sw, c = _w4a8_c_case(m, n, k, cuda)
    work = c.clone()
    out, _ = _one_tile_launch(
        "w4a8_gemm", "w4a8_gemm.cu",
        lambda: int4.mmult_q_w4a8(qa, sa, packed, sw, work))
    assert out.data_ptr() == work.data_ptr()
    ref = int4.mmult_q_w4a8_ref(qa, sa, packed, sw, c)
    assert torch.equal(work, ref), float((work - ref).abs().max())
    again = int4.mmult_q_w4a8(qa, sa, packed, sw, c.clone())
    assert torch.equal(again, work)


def test_int8_wgmma_kernels_take_both_token_tiles(cuda):
    """token_tile picks 64 where its tiles take no more rounds of the grid
    (65 tokens) and 128 elsewhere (a 4 x 256 admission), for both
    kernels."""
    for kernel, source, case, call in (
            ("int8_gemm_noc", "int8_gemm_noc.cu", _int8_noc_case,
             int8.mmult_q_noc),
            ("w4a8_gemm", "w4a8_gemm.cu", _w4a8_c_case, int4.mmult_q_w4a8)):
        taken = {_one_tile_launch(kernel, source,
                                  lambda a=case(m, n, k, cuda): call(*a))[1]
                 for m, n, k in ((65, 384, 700), (1024, 11008, 4096))}
        assert taken == {64, 128}, kernel


@pytest.mark.parametrize("m,n,k", [(1024, 11008, 4096), (65, 262, 700)])
def test_int8_wgmma_kernels_graph_replays(cuda, m, n, k):
    """From a CUDA graph, replayed on new QA in place (and, for K3, on C
    reset before each replay): the same bits as an eager call."""
    qa, sa, qb, sb = _int8_noc_case(m, n, k, cuda)
    wqa, wsa, packed, sw, c = _w4a8_c_case(m, n, k, cuda)
    work = c.clone()
    int8.mmult_q_noc(qa, sa, qb, sb)
    int4.mmult_q_w4a8(wqa, wsa, packed, sw, c.clone())
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = int8.mmult_q_noc(qa, sa, qb, sb)
        int4.mmult_q_w4a8(wqa, wsa, packed, sw, work)
    for seed in (2, 3):
        x = _activations(m, k, seed, cuda)
        q, s_ = int8.quant.quantize_symmetric(x, axis=1)
        qa.copy_(q)
        sa.copy_(s_)
        wqa.copy_(q)
        wsa.copy_(s_)
        work.copy_(c)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, int8.mmult_q_noc(qa, sa, qb, sb))
        assert torch.equal(
            work, int4.mmult_q_w4a8(wqa, wsa, packed, sw, c.clone()))
        assert torch.equal(work, int4.mmult_q_w4a8_ref(wqa, wsa, packed, sw,
                                                       c))


@pytest.mark.parametrize("m,k,n", [(1, 40, 8), (3, 4096, 4096),
                                   (17, 72, 136), (100, 1100, 1032),
                                   (5, 70, 30)])
def test_int_matmul_equals_exact_product(cuda, m, k, n):
    """The int8 linear's product below the kernel widths (torch._int_mm
    with k and n zero-padded to multiples of 8 and the rows to 32): the
    int32 accumulators equal the fp64 product's."""
    rng = np.random.default_rng(m * k)
    x = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    y = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    got = int8.int_matmul(x.to(cuda), y.to(cuda))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, int8.int_matmul_exact(x.to(cuda), y.to(cuda)))


def _w4a16_case(m, n, k, seed, device):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    packed, sw = _w4a8_weights(k, n, seed + 1, device)
    return a.to(device=device, dtype=torch.bfloat16), packed, sw


# The W4A16 pair (the GEMV at m <= 64, the GEMM above): one kernel a call
# on the card (torch.profiler's kernels; besides it only the pads of a
# packed pitch that is no 16-byte multiple and, for the GEMM, of rows of A
# that are not), within W4A16_REL of the plain version.
@pytest.mark.parametrize("m,n,k", [(1, 9, 40), (4, 11008, 4096),
                                   (4, 4096, 11008), (5, 1032, 1100),
                                   (16, 11008, 4096), (64, 11008, 4096),
                                   (64, 384, 700), (65, 384, 700),
                                   (300, 136, 72), (1000, 1032, 1100),
                                   (1024, 11008, 4096), (1024, 4096, 11008)])
def test_w4a16_kernels_match_plain_version(cuda, m, n, k):
    a, packed, sw = _w4a16_case(m, n, k, m + n + k, cuda)
    name = "w4a16_gemv" if m <= int4.GEMV_MAX_M else "w4a16_gemm_noc"
    before = _build.LAUNCHES[name]
    out = int4.mmult_q_noc(a, packed, sw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    kernels = profiling.call_profile(
        lambda: int4.mmult_q_noc(a, packed, sw)).kernels
    assert sum("w4a16" in kernel for kernel in kernels) == 1, kernels
    padded = n % 16 or (m > int4.GEMV_MAX_M and k % 8)
    assert len(kernels) == 1 or padded, kernels
    ref = int4.mmult_q_noc_ref(a, packed, sw)
    assert out.shape == (m, n)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"{name} m={m} n={n} k={k}: max|kernel - plain| = {err:.3e} "
          f"of max|y| {scale:.3e}")
    assert err <= W4A16_REL * scale, err / scale


# Both W4A16 serving kernels sum in a fixed order (no workspace, counter
# or atomic): two calls give the same bits, and a CUDA graph replayed on
# new A in place gives an eager call's bits.
@pytest.mark.parametrize("m,n,k", [(4, 11008, 4096), (64, 4096, 11008),
                                   (5, 1032, 1100), (1024, 11008, 4096),
                                   (300, 136, 72)])
def test_w4a16_kernels_are_deterministic_and_replay(cuda, m, n, k):
    a, packed, sw = _w4a16_case(m, n, k, 1, cuda)
    first = int4.mmult_q_noc(a, packed, sw)
    assert torch.equal(first, int4.mmult_q_noc(a, packed, sw))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = int4.mmult_q_noc(a, packed, sw)
    for seed in (2, 3):
        rng = np.random.default_rng(seed)
        a.copy_(torch.from_numpy(rng.standard_normal((m, k)).astype(
            np.float32)))
        graph.replay()
        torch.cuda.synchronize()
        eager = int4.mmult_q_noc(a, packed, sw)
        assert torch.equal(replayed, eager)
        ref = int4.mmult_q_noc_ref(a, packed, sw)
        err = float((replayed - ref).abs().max())
        assert err <= W4A16_REL * float(ref.abs().max()), err


def _w4a16_tile_launches():
    fn = _build.c_function("w4a16_gemm_noc.cu",
                           "w4a16_gemm_noc_tile_launches", (ctypes.c_int,))
    return {bt: fn(bt) for bt in (64, 128)}


def test_w4a16_gemm_noc_takes_both_token_tiles(cuda):
    """The GEMM's token tile (w4a8_wgmma.cuh's token_tile): 64 where its
    tiles take no more rounds of the grid (a 65-token chunk), else 128 (a
    4 x 256 admission at 4,096 -> 11,008); each EQUAL to itself again and
    within W4A16_REL of the plain version."""
    taken = set()
    for m, n, k in ((65, 384, 700), (1024, 11008, 4096)):
        a, packed, sw = _w4a16_case(m, n, k, 5, cuda)
        before = _w4a16_tile_launches()
        out = int4.mmult_q_noc(a, packed, sw)
        torch.cuda.synchronize()
        after = _w4a16_tile_launches()
        moved = [bt for bt in after if after[bt] != before[bt]]
        assert len(moved) == 1 and after[moved[0]] == before[moved[0]] + 1
        taken.add(moved[0])
        ref = int4.mmult_q_noc_ref(a, packed, sw)
        assert float((out - ref).abs().max()) <= W4A16_REL * float(
            ref.abs().max())
    assert taken == {64, 128}


# The ladder's K1 (int8_gemm_nn, rung 06) and rung 07 (w4a16_gemm) on the
# prefill bodies: K1 on w4a8_wgmma.cuh's plain int8 instance with C read
# into a fresh output (C's boxes loaded by tensor map into the staging
# where its rows are 16-byte multiples, else read by each thread), EQUAL to
# the plain version with C left as it was; rung 07 on w4a16_wgmma.cuh with
# C added in place (by tensor-map reductions, or by each thread at N 2,102
# and 262), within W4A16_REL of max |plain|. Each case is one launch of one
# token tile (the kernel's own count, *_tile_launches): WALK's 2001 x 2102
# (144 tiles of 128 x 256 wrap the grid; N no multiple of 4), 4,096 (512
# tiles), 64-token tiles at 65 rows, K of 700 and 1,100 (no multiple of
# 128), N of 262 and 1,032 (ragged past a 256-column tile).
LADDER_C_EDGES = [(2001, 2102, 520), (4096, 4096, 4096), (65, 384, 700),
                  (300, 1032, 1100), (128, 262, 1100)]


def _c(m, n, seed, device):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, (m, n)).astype(np.float32)).to(device)


@pytest.mark.parametrize("m,n,k", LADDER_C_EDGES)
def test_int8_gemm_nn_wgmma_edges(cuda, m, n, k):
    a, b, c = _abc((m, n, k), m + n + k, cuda)
    ops = int8.prepare(a, b)
    kept = c.clone()
    out, _ = _one_tile_launch("int8_gemm_nn", "int8_gemm_nn.cu",
                              lambda: int8.mmult_q(*ops, c))
    assert out.data_ptr() != c.data_ptr()
    assert torch.equal(c, kept)
    ref = int8.mmult_q_ref(*ops, c)
    assert torch.equal(out, ref), float((out - ref).abs().max())
    assert torch.equal(int8.mmult_q(*ops, c), out)


@pytest.mark.parametrize("m,n,k", LADDER_C_EDGES)
def test_w4a16_gemm_wgmma_edges(cuda, m, n, k):
    a, packed, sw = _w4a16_case(m, n, k, m + n + k, cuda)
    c = _c(m, n, k, cuda)
    work = c.clone()
    out, _ = _one_tile_launch("w4a16_gemm", "w4a16_gemm.cu",
                              lambda: int4.mmult_q(a, packed, sw, work))
    assert out.data_ptr() == work.data_ptr()
    ref = int4.mmult_q_ref(a, packed, sw, c)
    err = float((work - ref).abs().max())
    assert err <= W4A16_REL * float(ref.abs().max()), err
    assert torch.equal(int4.mmult_q(a, packed, sw, c.clone()), work)


def test_ladder_c_kernels_take_both_token_tiles(cuda):
    """token_tile picks 64 at 65 rows x 384 columns and 128 at a 1,024 x
    11,008 output, for K1 and rung 07 alike."""
    for m, n, k in ((65, 384, 700), (1024, 11008, 4096)):
        ops = int8.prepare(*_abc((m, n, k), 3, cuda)[:2])
        c = _c(m, n, 4, cuda)
        a, packed, sw = _w4a16_case(m, n, k, 5, cuda)
        taken = {_one_tile_launch("int8_gemm_nn", "int8_gemm_nn.cu",
                                  lambda: int8.mmult_q(*ops, c))[1],
                 _one_tile_launch("w4a16_gemm", "w4a16_gemm.cu",
                                  lambda: int4.mmult_q(a, packed, sw,
                                                       c.clone()))[1]}
        assert taken == {64 if m == 65 else 128}


# Rung 07 sums in a fixed order (the tensor-map reductions add each
# element of C once, in any order: one add each) and K1's C path waits on
# barriers whose phases run on across tiles: two calls give the same bits,
# and a CUDA graph replayed on new A (and C reset before each replay, for
# rung 07) gives an eager call's bits.
@pytest.mark.parametrize("m,n,k", [(1024, 11008, 4096), (300, 262, 1100),
                                   (65, 384, 700)])
def test_ladder_c_kernels_are_deterministic_and_replay(cuda, m, n, k):
    a, packed, sw = _w4a16_case(m, n, k, 1, cuda)
    ops = list(int8.prepare(*_abc((m, n, k), 6, cuda)[:2]))
    c = _c(m, n, 7, cuda)
    first = int4.mmult_q(a, packed, sw, c.clone())
    assert torch.equal(first, int4.mmult_q(a, packed, sw, c.clone()))
    assert torch.equal(int8.mmult_q(*ops, c), int8.mmult_q(*ops, c))
    torch.cuda.synchronize()
    work = c.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        int4.mmult_q(a, packed, sw, work)
        replayed = int8.mmult_q(*ops, c)
    for seed in (2, 3):
        rng = np.random.default_rng(seed)
        a.copy_(torch.from_numpy(rng.standard_normal((m, k)).astype(
            np.float32)))
        x = torch.from_numpy(rng.uniform(-1, 1, (m, k)).astype(
            np.float32)).to(cuda)
        qa, sa = int8.quant.quantize_symmetric(x, axis=1)
        ops[0].copy_(qa)
        ops[1].copy_(sa)
        work.copy_(c)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(work, int4.mmult_q(a, packed, sw, c.clone()))
        ref = int4.mmult_q_ref(a, packed, sw, c)
        err = float((work - ref).abs().max())
        assert err <= W4A16_REL * float(ref.abs().max()), err
        assert torch.equal(replayed, int8.mmult_q(*ops, c))
        assert torch.equal(replayed, int8.mmult_q_ref(*ops, c))


def test_float_wrappers_reject_what_the_kernels_do_not_take(cuda):
    a, b, c = _abc((64, 48, 32), 3, cuda)
    with pytest.raises(ValueError):
        tuned.mmult(a, b, c.t().contiguous().t())   # non-contiguous C
    with pytest.raises(TypeError):
        tuned.mmult_fp32_bt(a.to(torch.bfloat16), b.t().contiguous(), c)
    with pytest.raises(ValueError):
        tuned.mmult_bf16_bt(*tuned.prepare_bf16_bt(a, b[:, :40]), c)


def test_fp32_products_keep_the_callers_tf32_flag(cuda):
    """With TF32 turned on by the caller, the fp32 linear and rung 01 run
    at fp32 accuracy (TF32 would read ~1e-3) and leave the flag on."""
    from how_to_optimize_gemm_tpu_torch.models import linear
    flags = torch.backends.cuda.matmul
    saved = (flags.allow_tf32, torch.get_float32_matmul_precision())
    rng = np.random.default_rng(3)
    x, w, c = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((256, 1024), (1024, 512), (256, 512)))
    ref = x.double() @ w.double()
    try:
        flags.allow_tf32 = True
        y = linear.apply_linear(linear.make_linear(w.to(cuda), "fp32"),
                                x.to(cuda))
        assert flags.allow_tf32
        y01 = vendor.mmult(x.to(cuda), w.to(cuda), c.to(cuda))
        assert flags.allow_tf32
    finally:
        flags.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    for out, want in ((y, ref), (y01, ref + c.double())):
        rel = float((out.cpu().double() - want).abs().max()
                    / want.abs().max())
        assert rel < 1e-5, rel


@pytest.mark.parametrize("kvh,rep,d", [(2, 2, 128), (16, 1, 128),
                                       (4, 4, 64), (8, 4, 128), (3, 2, 32)])
def test_decode_attention_q8_matches_plain_version(cuda, kvh, rep, d):
    from how_to_optimize_gemm_tpu_torch.models import llama
    b, t = 4, 256
    rng = np.random.default_rng(kvh * rep * d)
    q = torch.from_numpy(rng.standard_normal((b, kvh * rep, d)).astype(
        np.float32)).to(cuda)
    cache = []
    for _ in "kv":
        x = torch.from_numpy(rng.standard_normal((b, t, kvh, d)).astype(
            np.float32)).to(cuda)
        cache += llama.quantize_kv(x)
    lengths = torch.tensor([1, 129, 256, 0], dtype=torch.int32,
                           device=cuda)
    bk = 128
    # rows past each slot's last live chunk are never read: garbage (and
    # NaN scales) there must not reach the output
    for c in cache:
        c[0, bk:] = float("nan") if c.is_floating_point() else 77
        c[3] = float("nan") if c.is_floating_point() else -77
    before = _build.LAUNCHES["decode_attention_q8"]
    out = decode_attention.decode_attention_q8(q, *cache, lengths, bk=bk)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode_attention_q8"] == before + 1
    ref = decode_attention.decode_attention_q8_ref(q, *cache, lengths, bk=bk)
    assert out.shape == (b, kvh * rep * d)
    assert torch.isfinite(out).all()
    err = float((out - ref).abs().max())
    print(f"decode_attention_q8 kvh={kvh} rep={rep} d={d}: max|kernel - "
          f"plain| = {err}")
    assert err < 2e-3, err


# decode_attention_q8 on the split walk: T = 1,024 at the reference's
# chunk for a 1-byte cache (bk 512, one chunk a split, two splits; bk 256
# at kvh 32, four), slots of length 0, 1, a split's last key, the next
# split's first and T. Within 2e-3 of the plain version (p * sv rounded
# against a split's running max); one launch a call, the same bits over
# repeats, the workspace's counters back at 0.
@pytest.mark.parametrize("kvh,rep,d", [(4, 2, 128), (2, 4, 128),
                                       (8, 1, 64), (3, 2, 32),
                                       (32, 1, 128)])
def test_decode_attention_q8_splits_long_slots(cuda, kvh, rep, d):
    from how_to_optimize_gemm_tpu_torch.models import llama
    t = 1024
    bk = decode_attention.pick_block(t, kvh, d, 1)
    per, splits = decode_attention.split_plan(t, bk)
    assert splits > 1
    lens = [0, 1, per * bk, per * bk + 1, t]
    rng = np.random.default_rng(kvh * rep + d + 1)
    q = torch.from_numpy(rng.standard_normal((len(lens), kvh * rep, d))
                         .astype(np.float32)).to(cuda)
    cache = []
    for _ in "kv":
        cache += llama.quantize_kv(torch.from_numpy(rng.standard_normal(
            (len(lens), t, kvh, d)).astype(np.float32)).to(cuda))
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)

    def call():
        return decode_attention.decode_attention_q8(q, *cache, lengths)

    before = _build.LAUNCHES["decode_attention_q8"]
    out = call()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode_attention_q8"] == before + 1
    assert not decode_attention._WORKSPACE[out.device][0].any()
    ref = decode_attention.decode_attention_q8_ref(q, *cache, lengths)
    err = float((out - ref).abs().max())
    print(f"decode_attention_q8 split kvh={kvh} rep={rep} d={d} bk={bk}: "
          f"max|kernel - plain| = {err}")
    assert err < 2e-3, err
    assert not out[0].any()
    assert torch.equal(call(), out)


# The KV8 kernel from a CUDA graph captured at the 7B cache's shape (kvh
# 32, T 4,096: bk 256, one chunk a split, 16 splits), replayed at other
# lengths: its plan and grid come from T and bk alone, so each replay
# equals an eager call at its lengths bit for bit, within 2e-3 of the
# plain version, the counters at 0.
def test_decode_attention_q8_graph_replays_at_other_lengths(cuda):
    from how_to_optimize_gemm_tpu_torch.models import llama
    kvh, rep, d, t = 32, 1, 128, 4096
    runs = [[1, 300, 1000, 4096], [0, 256, 257, 4095], [4096, 1, 0, 768]]
    rng = np.random.default_rng(45)
    q = torch.from_numpy(rng.standard_normal((4, kvh * rep, d)).astype(
        np.float32)).to(cuda)
    cache = []
    for _ in "kv":
        cache += llama.quantize_kv(torch.from_numpy(rng.standard_normal(
            (4, t, kvh, d)).astype(np.float32)).to(cuda))
    lengths = torch.tensor(runs[1], dtype=torch.int32, device=cuda)

    def call():
        return decode_attention.decode_attention_q8(q, *cache, lengths)
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = call()
    counters = decode_attention._WORKSPACE[q.device][0]
    for lens in runs:
        lengths.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert not counters.any()
        eager = call()
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager)
        assert not counters.any()
        ref = decode_attention.decode_attention_q8_ref(q, *cache, lengths)
        err = float((replayed - ref).abs().max())
        print(f"decode_attention_q8 replay at {lens}: max|kernel - "
              f"plain| = {err}")
        assert err < 2e-3, err


# Slice 4's kernels, over page pools through block tables.
# paged_kv_update must EQUAL its plain version (byte copies; trash-page and
# masked rows skipped by both). The paged attention kernels sum as the
# contiguous ones do: atol 2e-3 against their plain versions.

def _shuffled_table(lengths, ps, np_max, seed):
    """Pages 1 .. NP-1 handed out in a shuffled order; chunks past a
    slot's length stay 0."""
    rng = np.random.default_rng(seed)
    n_pages = len(lengths) * np_max + 1
    free = list(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((len(lengths), np_max), np.int32)
    for b, n in enumerate(lengths):
        for c in range(-(-n // ps)):
            table[b, c] = free.pop()
    return n_pages, table


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp32 scales", "odd"])
@pytest.mark.parametrize("s", [1, 4])
def test_paged_kv_update_equals_plain_version(cuda, kind, s):
    from how_to_optimize_gemm_tpu_torch.models import llama
    n_pages, ps, kvh, d, b = 16, 16, 4, 128, 3
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.standard_normal(
        (n_pages, ps, kvh, d)).astype(np.float32)).to(cuda)
    new = torch.from_numpy(rng.standard_normal(
        (b, s, kvh, d)).astype(np.float32)).to(cuda)
    if kind == "bf16":
        pool = x.to(torch.bfloat16)
    elif kind == "odd":                  # a 3 x 5 fp32 row: byte copies
        pool = x[:, :, 0, :15].reshape(n_pages, ps, 3, 5).contiguous()
        new = new[:, :, 0, :15].reshape(b, s, 3, 5)
    else:
        (pool, spool), (new, snew) = llama.quantize_kv(x), \
            llama.quantize_kv(new)
        if kind == "fp32 scales":
            pool, new = spool, snew
    perm = rng.permutation(np.arange(1, n_pages))
    pages = torch.from_numpy(perm[:b * s].reshape(b, s).astype(np.int32))
    pages[0, 0] = 0                                 # a trash-page row
    offs = torch.from_numpy(rng.integers(0, ps, (b, s)).astype(np.int32))
    if s > 1:
        pages[-1, -1] = n_pages                     # a row past NP
    mask = torch.tensor([True, False, True], device=cuda)
    pages, offs = pages.to(cuda), offs.to(cuda)
    # the engine's int32 tables, int64 ones, and views of wider ones
    wide = torch.stack([pages, offs], -1)
    tables = [(pages, offs), (pages.long(), offs.long()),
              (wide[..., 0], wide[..., 1])]
    assert not tables[2][0].is_contiguous()
    for (pg, of), wm in [(t, w) for t in tables for w in (None, mask)]:
        got = pool.clone()
        before = _build.LAUNCHES["paged_kv_update"]
        out = kv_update.paged_kv_update(got, new, pg, of, wm)
        torch.cuda.synchronize()
        assert out.data_ptr() == got.data_ptr()
        assert _build.LAUNCHES["paged_kv_update"] == before + 1
        ref = kv_update.paged_kv_update_ref(pool.clone(), new, pages, offs,
                                            wm)
        assert torch.equal(got, ref)
        assert torch.equal(got[0], pool[0])         # page 0 untouched
        assert not torch.equal(got, pool)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8,
                                   torch.float32])
def test_paged_kv_update_is_one_kernel_a_call(cuda, dtype):
    """The engine's call (int32 tables, rows of the pool's dtype, no
    mask) at the 7B pools' rows (bf16 values, KV8 values, KV8 scales):
    torch.profiler sees exactly one device kernel, the wrapper's."""
    row = (32,) if dtype == torch.float32 else (32, 128)
    pool = torch.zeros((9, 16, *row), dtype=dtype, device=cuda)
    new = torch.ones((4, 1, *row), dtype=dtype, device=cuda)
    pages = torch.tensor([[1], [3], [0], [8]], dtype=torch.int32,
                         device=cuda)
    offs = torch.tensor([[0], [5], [2], [15]], dtype=torch.int32,
                        device=cuda)
    kernels = profiling.call_profile(
        lambda: kv_update.paged_kv_update(pool, new, pages, offs)).kernels
    assert len(kernels) == 1 and "paged_kv_update" in kernels[0], kernels
    ref = kv_update.paged_kv_update_ref(torch.zeros_like(pool), new, pages,
                                        offs)
    assert torch.equal(pool, ref)


# (kvh, rep, d, page, lengths): GQA and wide widths, pages of 16 and 128,
# and KV8-sized pages whose table (np_max * PS = 288) passes a 256-token
# max_seq
PAGED_CASES = [(2, 2, 128, 16, [1, 40, 64, 0]),
               (32, 1, 128, 128, [1, 300, 512, 129]),
               (4, 4, 64, 16, [17, 64, 3, 33]),
               (3, 2, 32, 96, [1, 200, 256, 0]),
               (32, 1, 128, 384, [1, 300, 1000, 4096])]   # the 7B KV8 pool


def _nan_outside_the_tables(pools, table):
    """NaN (int8: 77) in page 0 and every page no table row holds: a
    kernel that reads one of them shows it."""
    unused = sorted(set(range(pools[0].shape[0])) - set(table.flatten())
                    | {0})
    for c in pools:
        c[unused] = float("nan") if c.is_floating_point() else 77


@pytest.mark.parametrize("kvh,rep,d,ps,lens", PAGED_CASES)
def test_paged_decode_attention_matches_plain_version(cuda, kvh, rep, d, ps,
                                                      lens):
    np_max = -(-max(lens) // ps) + 1
    n_pages, table = _shuffled_table(lens, ps, np_max, kvh + d)
    rng = np.random.default_rng(ps)
    q = torch.from_numpy(rng.standard_normal(
        (len(lens), kvh * rep, d)).astype(np.float32)).to(cuda)
    k, v = (torch.from_numpy(rng.standard_normal(
        (n_pages, ps, kvh, d)).astype(np.float32)).to(
            device=cuda, dtype=torch.bfloat16) for _ in "kv")
    _nan_outside_the_tables((k, v), table)
    table = torch.from_numpy(table).to(cuda)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = _build.LAUNCHES["paged_decode_attention"]
    out = paged_attention.paged_decode_attention(q, k, v, table, lengths)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["paged_decode_attention"] == before + 1
    assert not decode_attention._WORKSPACE[out.device][0].any()
    ref = paged_attention.paged_decode_attention_ref(q, k, v, table,
                                                     lengths)
    assert torch.isfinite(out).all()
    err = float((out - ref).abs().max())
    print(f"paged_decode_attention kvh={kvh} rep={rep} d={d} ps={ps}: "
          f"max|kernel - plain| = {err}")
    assert err < 2e-3, err


@pytest.mark.parametrize("kvh,rep,d,ps,lens", PAGED_CASES)
def test_paged_decode_attention_q8_matches_plain_version(cuda, kvh, rep, d,
                                                         ps, lens):
    from how_to_optimize_gemm_tpu_torch.models import llama
    np_max = -(-max(lens) // ps) + 1
    n_pages, table = _shuffled_table(lens, ps, np_max, kvh + d + 1)
    rng = np.random.default_rng(ps + 1)
    q = torch.from_numpy(rng.standard_normal(
        (len(lens), kvh * rep, d)).astype(np.float32)).to(cuda)
    pools = []
    for _ in "kv":
        pools += llama.quantize_kv(torch.from_numpy(rng.standard_normal(
            (n_pages, ps, kvh, d)).astype(np.float32)).to(cuda))
    _nan_outside_the_tables(pools, table)
    table = torch.from_numpy(table).to(cuda)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = _build.LAUNCHES["paged_decode_attention_q8"]
    out = paged_attention.paged_decode_attention_q8(q, *pools, table,
                                                    lengths)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["paged_decode_attention_q8"] == before + 1
    assert not decode_attention._WORKSPACE[out.device][0].any()
    ref = paged_attention.paged_decode_attention_q8_ref(q, *pools, table,
                                                        lengths)
    assert torch.isfinite(out).all()
    err = float((out - ref).abs().max())
    print(f"paged_decode_attention_q8 kvh={kvh} rep={rep} d={d} ps={ps}: "
          f"max|kernel - plain| = {err}")
    assert err < 2e-3, err


def _paged_case(kvh, rep, d, ps, lens, np_max, kv8, seed, device):
    """q, the pools (KV8: values and scales), the shuffled table and the
    lengths on the card."""
    n_pages, table = _shuffled_table(lens, ps, np_max, seed)
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal(
        (len(lens), kvh * rep, d)).astype(np.float32)).to(device)
    pools = []
    for _ in "kv":
        x = torch.from_numpy(rng.standard_normal(
            (n_pages, ps, kvh, d)).astype(np.float32)).to(device)
        pools += (list(_quantize(x)) if kv8 else [x.to(torch.bfloat16)])
    return (q, pools, torch.from_numpy(table).to(device),
            torch.tensor(lens, dtype=torch.int32, device=device))


def _quantize(x):
    from how_to_optimize_gemm_tpu_torch.models import llama
    return llama.quantize_kv(x)


# Rows of a slot's last page past its length, the trash page and the pages
# no table row holds are never read: NaN there (int8 values: 77, their
# scales NaN) leaves the output finite and bit-equal to the kernel's on the
# clean pools, within 2e-3 of the plain version on them. Pages of 128
# (the KV8 kernel's splits of two pages) and lengths ending inside a page.
@pytest.mark.parametrize("kv8", [False, True])
def test_paged_attention_never_reads_past_the_lengths(cuda, kv8):
    kvh, rep, d, ps, lens = 4, 2, 128, 128, [1, 200, 256, 0, 129, 300]
    np_max = -(-max(lens) // ps) + 1
    q, pools, table, lengths = _paged_case(kvh, rep, d, ps, lens, np_max,
                                           kv8, 41, cuda)
    name = "paged_decode_attention_q8" if kv8 else "paged_decode_attention"
    kernel = getattr(paged_attention, name)
    clean = kernel(q, *pools, table, lengths)
    ref = getattr(paged_attention, name + "_ref")(q, *pools, table, lengths)
    dirty = [c.clone() for c in pools]
    _nan_outside_the_tables(dirty, table.cpu().numpy())
    for b, n in enumerate(lens):
        if n % ps:
            page = int(table[b, n // ps])
            for c in dirty:
                c[page, n % ps:] = float("nan") if c.is_floating_point() \
                    else 77
    out = kernel(q, *dirty, table, lengths)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert torch.equal(out, clean)
    err = float((out - ref).abs().max())
    print(f"{name} past the lengths: max|kernel - plain| = {err}")
    assert err < 2e-3, err
    assert not decode_attention._WORKSPACE[out.device][0].any()


# Each paged kernel from a CUDA graph captured at its 7B pool's shape (KV8:
# one page of 384 a split, 11 splits; bf16: two pages of 128 a split, 16
# splits), replayed at other lengths: its plan and grid come from np_max
# and PS alone, so each replay equals an eager call at its lengths bit for
# bit, within 2e-3 of the plain version, the counters at 0.
@pytest.mark.parametrize("kv8", [True, False])
def test_paged_q8_graph_replays_at_other_lengths(cuda, kv8):
    kvh, rep, d = 32, 1, 128
    if kv8:
        ps, np_max = 384, 11
        runs = [[1, 300, 1000, 4096], [0, 384, 385, 4224], [4096, 1, 0, 768]]
    else:
        ps, np_max = 128, 32
        runs = [[1, 300, 1000, 4096], [0, 256, 257, 4096], [4096, 1, 0, 768]]
    q, pools, table, lengths = _paged_case(kvh, rep, d, ps, runs[1],
                                           np_max, kv8, 43, cuda)
    name = "paged_decode_attention_q8" if kv8 else "paged_decode_attention"
    kernel = getattr(paged_attention, name)
    plain = getattr(paged_attention, name + "_ref")

    def call():
        return kernel(q, *pools, table, lengths)
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = call()
    counters = decode_attention._WORKSPACE[q.device][0]
    for lens in runs:
        lengths.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert not counters.any()
        eager = call()
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager)
        assert not counters.any()
        ref = plain(q, *pools, table, lengths)
        err = float((replayed - ref).abs().max())
        print(f"{name} replay at {lens}: max|kernel - plain| = {err}")
        assert err < 2e-3, err


def test_paged_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((2, 4, 128), device=cuda)
    pool = torch.zeros((5, 16, 2, 128), dtype=torch.bfloat16, device=cuda)
    table = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    lengths = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):                  # an int64 table
        paged_attention.paged_decode_attention(q, pool, pool, table.long(),
                                               lengths)
    with pytest.raises(ValueError):                 # rep * PS > 8192
        big = torch.zeros((2, 8192, 1, 128), dtype=torch.bfloat16,
                          device=cuda)
        paged_attention.paged_decode_attention(q[:, :2], big, big, table,
                                               lengths)
    with pytest.raises(ValueError):                 # pages of another shape
        kv_update.paged_kv_update(pool, torch.zeros((2, 1, 2, 64),
                                                    device=cuda),
                                  table[:, :1], table[:, :1])


@pytest.mark.parametrize("kv8", [False, True])
def test_tiny_paged_engine_on_the_card(cuda, kv8):
    """The paged engine serves on the card with the prefix cache,
    chunked prefill and a pool small enough to preempt; every request
    completes and the paged kernels run."""
    from how_to_optimize_gemm_tpu_torch.models import llama
    from how_to_optimize_gemm_tpu_torch.parallel import serving
    cfg = llama.LlamaConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=512, max_seq=256,
                            weight_kind="w4a8")
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    on_card = convert.to_device(params, cuda)
    shared = list(range(1, 33))
    prompts = [shared + [40 + i] * (3 + 9 * i) for i in range(4)]
    before = dict(_build.LAUNCHES)
    eng = serving.ServingEngine(cfg, on_card, batch_slots=2, device=cuda,
                                cache_kind="int8" if kv8 else "bf16",
                                paged=True, page=16, cache_pages=9,
                                prefix_cache=True, prefill_chunk=24)
    done = eng.run([serving.Request(uid=i, prompt=p, max_new=40)
                    for i, p in enumerate(prompts)])
    assert all(r.done and len(r.out) == 40 for r in done)
    assert eng.prefix_hit_tokens > 0
    attn = "paged_decode_attention_q8" if kv8 else "paged_decode_attention"
    for k in ("paged_kv_update", attn, "w4a8_gemv_fq"):
        assert _build.LAUNCHES[k] > before[k], k
    assert not any(eng.slot_pages)


# ------------------------------------------------------------ model path

def test_unported_routes_raise_on_the_card(cuda):
    """The int8 and int4 linears take their kernels on the card (int8 at
    m >= 256, int4 at every m: the GEMV at m <= 64), and causal
    self-attention of 512 tokens or more takes the flash kernel; the
    kernel routes cannot be turned off on the card."""
    from how_to_optimize_gemm_tpu_torch.models import linear, llama
    w = torch.ones((16, 8), device=cuda)
    lin4 = linear.make_linear(w, "int4")
    lin8 = linear.make_linear(w, "int8")
    for lin, m, name in ((lin4, 2, "w4a16_gemv"),
                         (lin4, 100, "w4a16_gemm_noc"),
                         (lin8, 256, "int8_gemm_noc")):
        before = dict(_build.LAUNCHES)
        y = linear.apply_linear(lin, torch.ones((m, 16), device=cuda))
        torch.cuda.synchronize()
        assert y.shape == (m, 8)
        assert _build.LAUNCHES[name] == before[name] + 1, name
    before = dict(_build.LAUNCHES)
    assert linear.apply_linear(lin8, torch.ones((3, 16),
                                                device=cuda)).shape == (3, 8)
    assert _build.LAUNCHES == before     # the library's int8 product
    on_card = llama.kernel_routes_for(torch.ones(1, device=cuda))
    assert llama._route_flash(on_card, 512, 128)      # the flash kernel
    assert not llama._route_flash(on_card, 511, 128)
    with pytest.raises(ValueError):
        llama.kernel_routes_for(torch.ones(1, device=cuda), False)
    with pytest.raises(ValueError):
        linear.apply_linear(lin4, torch.ones((2, 16), device=cuda), False)


def _teacher_forced(params, cfg, device, tokens, forced, quantized=False):
    """Logits of a masked prefill of ``tokens`` and of decode steps fed
    ``forced``, on the kernel routes (the CPU: their plain versions)."""
    from how_to_optimize_gemm_tpu_torch.models import llama
    cache = llama.init_kv_cache(cfg, tokens.shape[0], quantized=quantized,
                                device=device)
    s = tokens.shape[1]
    pos = torch.zeros(tokens.shape[0], dtype=torch.int32, device=device)
    rows = [llama.decode_step(params, cfg, cache,
                              torch.from_numpy(tokens).to(device), pos,
                              prefill_self=True, logit_idx=pos + s - 1,
                              kernel_routes=True)[0][:, 0]]
    pos = pos + s
    for j in range(forced.shape[1]):
        f = torch.from_numpy(forced[:, j:j + 1]).to(device)
        rows.append(llama.decode_step(params, cfg, cache, f, pos,
                                      kernel_routes=True)[0][:, 0])
        pos = pos + 1
    return torch.stack(rows).float().cpu()


# the kernels each (weight kind, KV8?) must launch, beside kv_update
TINY_KERNELS = {
    ("fp32", False): ["decode_attention"],
    ("w4a8", False): ["decode_attention", "w4a8_gemm_noc", "w4a8_gemv_fq"],
    ("int8", False): ["decode_attention", "int8_gemm_noc"],
    ("int4", False): ["decode_attention", "w4a16_gemm_noc", "w4a16_gemv"],
    ("w4a8", True): ["decode_attention_q8", "w4a8_gemm_noc", "w4a8_gemv_fq"],
}


@pytest.mark.parametrize("kind,kv8", list(TINY_KERNELS))
def test_tiny_model_on_the_card_matches_its_cpu_kernel_routes(cuda, kind,
                                                              kv8):
    """Teacher-forced logits of a masked 128-token prefill (m = 256: the
    prefill-width linears, the int8 kernel's threshold included) and 4
    decode steps, the card (kernels) against the CPU on the same routes
    (their plain versions). Float32 ops summed in another order differ by
    about 1e-6 relative, which the model amplifies (bf16 cache and p
    roundings, int8 KV and activation quantization), so the bound is 3x
    what a 1e-6 relative perturbation of the embeddings does on the CPU.
    Then the engine serves on the card."""
    from how_to_optimize_gemm_tpu_torch.models import llama
    from how_to_optimize_gemm_tpu_torch.parallel import serving
    cfg = llama.LlamaConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=512, max_seq=256,
                            weight_kind=kind)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    on_card = convert.to_device(params, cuda)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 128)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    before = dict(_build.LAUNCHES)
    card = _teacher_forced(on_card, cfg, cuda, tokens, forced, kv8)
    for k in ["kv_update"] + TINY_KERNELS[kind, kv8]:
        assert _build.LAUNCHES[k] > before[k], k
    cpu = _teacher_forced(params, cfg, "cpu", tokens, forced, kv8)
    scale = float(cpu.abs().max())
    diff = float((card - cpu).abs().max())
    noise = torch.randn(params["embed"].shape,
                        generator=torch.Generator().manual_seed(1))
    moved = {**params, "embed": params["embed"] * (1 + 1e-6 * noise)}
    limit = 3 * float((_teacher_forced(moved, cfg, "cpu", tokens,
                                       forced, kv8) - cpu).abs().max())
    print(f"tiny model {kind} kv8={kv8}: max|card - cpu| = {diff} of "
          f"{scale} (limit {limit})")
    assert diff <= limit, diff
    eng = serving.ServingEngine(cfg, on_card, batch_slots=2, device=cuda,
                                cache_kind="int8" if kv8 else "bf16")
    done = eng.run([serving.Request(uid=i, prompt=[i + 1] * (5 + 7 * i),
                                    max_new=6) for i in range(3)])
    assert all(r.done and len(r.out) == 6 for r in done)


# ------------------------------------------------------------ flash prefill
# flash_attention sums in another order than its plain version (the
# tensor cores' fp32 sums, quad shuffles for the row sums), and an exp or
# a score one ulp apart (ex2.approx with log2(e) in the scale) can flip the
# bf16 rounding of p or of an output: in every row, max |kernel - plain|
# <= 2 bf16 ulps of that row's max |plain| (attention.bf16_row_ulps). The
# plain version walks the kernel's key tiles (attention.KERNEL_BK).
FLASH_ULPS = 2.0

# (B, H, KVH, S, T, D, causal): GQA rep 4 (the serving CLI's 16 heads over
# 4), D 64, the last 700 of 1000 positions, not causal, T = 9000 past the
# reference's 8192-key strip, and tails of one row and one key; then the
# edges of the 128 x 128 tiles: S of 1, 63, 130 and 700 against T of 9,000
# (a causal S < T offset), rep 1, 4 and 8, D 64 and 128, and one key tile
# walked (S = T = 100)
FLASH_CASES = [(2, 16, 4, 1024, 1024, 128, True),
               (1, 8, 8, 700, 1000, 64, True),
               (2, 4, 2, 700, 1000, 128, False),
               (1, 4, 4, 64, 9000, 128, False),
               (1, 4, 1, 129, 129, 64, True),
               (3, 2, 2, 1, 65, 128, True),
               (1, 8, 1, 1, 9000, 128, True),
               (2, 8, 8, 63, 9000, 64, True),
               (1, 8, 2, 130, 9000, 128, True),
               (1, 16, 2, 700, 9000, 64, True),
               (2, 8, 1, 130, 130, 64, False),
               (1, 4, 4, 100, 100, 128, True)]


def _flash_inputs(b, h, kvh, s, t, d, seed, device, model_layout=False):
    """bf16 q (B, H, S, D), k, v (B, KVH, T, D); with model_layout, views
    of (B, S, H, D) and (B, T, KVH, D) tensors, as mha_flash passes."""
    rng = np.random.default_rng(seed)

    def make(heads, n):
        x = torch.from_numpy(rng.standard_normal((b, n, heads, d)).astype(
            np.float32)).to(device=device, dtype=torch.bfloat16)
        x = x.transpose(1, 2)
        return x if model_layout else x.contiguous()
    return make(h, s), make(kvh, t), make(kvh, t)


@pytest.mark.parametrize("model_layout", [False, True])
@pytest.mark.parametrize("b,h,kvh,s,t,d,causal", FLASH_CASES)
def test_flash_attention_matches_plain_version(cuda, b, h, kvh, s, t, d,
                                               causal, model_layout):
    q, k, v = _flash_inputs(b, h, kvh, s, t, d, s + t + d, cuda,
                            model_layout)
    before = _build.LAUNCHES["flash_attention"]
    out = attention.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    assert out.stride() == q.stride() and out.dtype == torch.bfloat16
    ref = attention.flash_attention_ref(q, k, v, causal=causal,
                                        bk=attention.KERNEL_BK)
    assert torch.isfinite(out).all()
    err = float((out.float() - ref.float()).abs().max())
    ulps = float(attention.bf16_row_ulps(out, ref).max())
    print(f"flash_attention {(b, h, kvh, s, t, d, causal)}: max|kernel - "
          f"plain| = {err:.3e}, {ulps:.3f} bf16 ulps of its row's max")
    assert ulps <= FLASH_ULPS, ulps


def test_flash_forwards_repeat_their_bits(cuda):
    """Both forward kernels give the same bits on every call and in every
    CUDA-graph replay: a fixed tiling and a fixed order of sums, whatever
    the two consumer warpgroups' turns at the tensor cores."""
    q, k, v = _flash_inputs(2, 8, 2, 700, 1000, 128, 5, cuda, True)
    tq, tk, tv, _ = _train_inputs(2, 8, 2, 520, 64, 6, cuda)
    outs = {"fwd": attention.flash_attention(q, k, v),
            "lse": attention.flash_attention_fwd_lse(tq, tk, tv)}
    again = {"fwd": attention.flash_attention(q, k, v),
             "lse": attention.flash_attention_fwd_lse(tq, tk, tv)}
    graph, static = torch.cuda.CUDAGraph(), {}
    with torch.cuda.graph(graph):
        static["fwd"] = attention.flash_attention(q, k, v)
        static["lse"] = attention.flash_attention_fwd_lse(tq, tk, tv)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static["fwd"], outs["fwd"])
        for a, b in zip(static["lse"], outs["lse"]):
            assert torch.equal(a, b)
    assert torch.equal(again["fwd"], outs["fwd"])
    for a, b in zip(again["lse"], outs["lse"]):
        assert torch.equal(a, b)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _flash_inputs(1, 2, 1, 64, 64, 64, 0, cuda)
    with pytest.raises(ValueError):                 # the kernel's tiles
        attention.flash_attention(q, k, v, bk=512)
    with pytest.raises(ValueError):
        attention.flash_attention(q, k, v, bq=64)
    with pytest.raises(ValueError):                 # causal S > T
        attention.flash_attention(k.repeat(1, 2, 2, 1), q[:, :1], q[:, :1])
    with pytest.raises(TypeError):
        attention.flash_attention(q.float(), k, v)


def _prefill_cache(cfg, kind, b, device):
    """A cache of each kind for ``decode_step`` and its keyword arguments
    (a block table for the paged pools)."""
    from how_to_optimize_gemm_tpu_torch.models import llama
    quantized = kind.endswith("kv8")
    if not kind.startswith("paged"):
        return llama.init_kv_cache(cfg, b, quantized=quantized,
                                   device=device), {}
    page = 128
    np_max = cfg.max_seq // page
    cache = llama.init_paged_kv_cache(cfg, b * np_max + 1, page,
                                      quantized=quantized, device=device)
    table = torch.arange(1, b * np_max + 1, dtype=torch.int32,
                         device=device).reshape(b, np_max)
    return cache, {"table": table}


@pytest.mark.parametrize("kind", ["bf16", "kv8", "paged", "paged-kv8"])
def test_long_prefill_takes_flash_and_matches_cpu(cuda, kind):
    """An admission prefill of 512 tokens (2 slots, prefill_self) on each
    cache kind: the card launches flash_attention once per layer, and its
    last-position logits stay within 3x what a 1e-6 relative perturbation
    of the embeddings does to the CPU's kernel routes (their plain
    versions, flash included)."""
    from how_to_optimize_gemm_tpu_torch.models import llama
    cfg = llama.LlamaConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=512, max_seq=1024,
                            weight_kind="fp32")
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 512))

    def prefill(p, device):
        cache, kw = _prefill_cache(cfg, kind, 2, device)
        pos = torch.zeros(2, dtype=torch.int32, device=device)
        logits, _ = llama.decode_step(
            p, cfg, cache, torch.from_numpy(tokens).to(device), pos,
            prefill_self=True, logit_idx=pos + 511, kernel_routes=True, **kw)
        return logits.float().cpu()
    before = _build.LAUNCHES["flash_attention"]
    card = prefill(convert.to_device(params, cuda), cuda)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + cfg.n_layers
    cpu = prefill(params, "cpu")
    noise = torch.randn(params["embed"].shape,
                        generator=torch.Generator().manual_seed(1))
    moved = {**params, "embed": params["embed"] * (1 + 1e-6 * noise)}
    limit = 3 * float((prefill(moved, "cpu") - cpu).abs().max())
    diff = float((card - cpu).abs().max())
    print(f"prefill 512 {kind}: max|card - cpu| = {diff} (limit {limit})")
    assert diff <= limit, diff


# ---------------------------------------------------------- flash training
# The training attention's kernels against their plain versions (the
# forward at the kernel's key tiles, attention.KERNEL_BK_LSE, whose bf16 p
# depends on the block),
# each output per row over its own max |plain| (attention.row_rel_err, rows
# raised to 1% of the tensor's max): out within TRAIN_OUT_REL (p rounded to
# bf16 from scores of q split into two bf16 halves: one bf16 ulp of a row's
# top value), dq, dk and dv within TRAIN_GRAD_REL (fp32, the split operands'
# 2^-17 and sums in another order), lse within TRAIN_LSE_ATOL; the bounds of
# chip_smoke.py, set from readings on an H100.
TRAIN_OUT_REL = 8e-3
TRAIN_GRAD_REL = 2e-3
TRAIN_LSE_ATOL = 5e-5

# (B, H, KVH, S, D, causal): GQA rep 4 and 8 at D 64, rep 1 at D 128, S
# that is no tile multiple, three rows, and a non-causal tail of one key;
# then S of 2, 63 and 700 at D 128 and 64, rep 8 at D 128, and one key
# tile walked (S 100). (Not S = 1: its dq is 0 in exact arithmetic, ds =
# dp - delta cancelling in every row, so both sides are rounding noise and
# no row is a scale; the forward alone is held at S = 1 below.)
TRAIN_CASES = [(2, 8, 2, 256, 64, True), (1, 8, 1, 200, 64, True),
               (1, 4, 4, 200, 128, True), (1, 8, 2, 520, 128, False),
               (2, 4, 1, 130, 64, True), (1, 2, 2, 3, 64, True),
               (1, 2, 2, 65, 128, False), (1, 8, 1, 2, 128, True),
               (2, 4, 4, 63, 64, True), (1, 8, 1, 700, 128, True),
               (1, 16, 2, 700, 64, False), (1, 4, 2, 100, 128, True)]


def _train_inputs(b, h, kvh, s, d, seed, device):
    """q and do float32 (B, H, S, D), k and v bf16 (B, KVH, S, D), all
    views of (B, S, heads, D) tensors, as mha_flash_train passes them."""
    rng = np.random.default_rng(seed)

    def make(heads, dtype=torch.float32):
        x = rng.standard_normal((b, s, heads, d)).astype(np.float32)
        return torch.from_numpy(x).to(device=device,
                                      dtype=dtype).transpose(1, 2)
    return (make(h), make(kvh, torch.bfloat16), make(kvh, torch.bfloat16),
            make(h))


@pytest.mark.parametrize("b,h,kvh,s,d,causal", TRAIN_CASES)
def test_flash_train_kernels_match_plain_versions(cuda, b, h, kvh, s, d,
                                                  causal):
    q, k, v, do = _train_inputs(b, h, kvh, s, d, s + d + h, cuda)
    names = ("flash_attention_fwd_lse", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    before = {n: _build.LAUNCHES[n] for n in names}
    out, lse = attention.flash_attention_fwd_lse(q, k, v, causal=causal)
    ref_out, ref_lse = attention.flash_attention_fwd_lse_ref(
        q, k, v, causal=causal, bk=attention.KERNEL_BK_LSE)
    delta = (do * ref_out).sum(dim=-1)
    args = (q, k, v, do, ref_lse, delta)
    dq = attention.flash_attention_bwd_dq(*args, causal=causal)
    dk, dv = attention.flash_attention_bwd_dkv(*args, causal=causal)
    torch.cuda.synchronize()
    assert {n: _build.LAUNCHES[n] - before[n] for n in names} == \
        dict.fromkeys(names, 1)
    assert out.stride() == q.stride() and dq.stride() == q.stride()
    assert dk.dtype == dv.dtype == torch.float32 and dk.shape == k.shape
    ref_dq = attention.flash_attention_bwd_dq_ref(*args, causal=causal)
    ref_dk, ref_dv = attention.flash_attention_bwd_dkv_ref(*args,
                                                           causal=causal)
    rel = attention.row_rel_err
    errs = {"out": float(rel(out, ref_out).max()),
            "dq": float(rel(dq, ref_dq).max()),
            "dk": float(rel(dk, ref_dk).max()),
            "dv": float(rel(dv, ref_dv).max())}
    lse_err = float((lse - ref_lse).abs().max())
    print(f"flash train {(b, h, kvh, s, d, causal)}: {errs}, lse {lse_err}")
    for x in (out, lse, dq, dk, dv):
        assert torch.isfinite(x).all()
    assert errs["out"] <= TRAIN_OUT_REL
    assert max(errs["dq"], errs["dk"], errs["dv"]) <= TRAIN_GRAD_REL
    assert lse_err <= TRAIN_LSE_ATOL


@pytest.mark.parametrize("b,h,kvh,s,d,causal", [
    (1, 8, 1, 1, 128, True), (2, 4, 4, 1, 64, False), (1, 16, 2, 63, 128,
                                                       True),
    (1, 8, 8, 130, 64, True), (1, 4, 1, 700, 128, False)])
def test_flash_fwd_lse_edges_match_plain_version(cuda, b, h, kvh, s, d,
                                                 causal):
    """The training forward alone at the edges of its 128-row tiles (S of
    1 included), against its plain version at the kernel's key tile."""
    q, k, v, _ = _train_inputs(b, h, kvh, s, d, s + d + h + 1, cuda)
    out, lse = attention.flash_attention_fwd_lse(q, k, v, causal=causal)
    ref_out, ref_lse = attention.flash_attention_fwd_lse_ref(
        q, k, v, causal=causal, bk=attention.KERNEL_BK_LSE)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert float(attention.row_rel_err(out, ref_out).max()) <= TRAIN_OUT_REL
    assert float((lse - ref_lse).abs().max()) <= TRAIN_LSE_ATOL


# dK/dV's wgmma kernel (two consumers of 64 keys at D 64, one at D 128;
# 64-query steps): S of 130, 520 and 1,025, rep 1, 4 and 8, D 64 and 128,
# causal and not; within TRAIN_GRAD_REL of the plain version, and two
# calls bit-equal (no atomics: each key row's sum has one owner).
@pytest.mark.parametrize("b,h,kvh,s,d,causal", [
    (1, 8, 1, 1025, 64, False), (1, 16, 4, 1025, 128, True),
    (2, 4, 4, 130, 128, False), (1, 8, 8, 520, 64, True),
    (1, 8, 2, 130, 64, False), (1, 4, 1, 520, 128, True)])
def test_flash_bwd_dkv_edges_repeat_their_bits(cuda, b, h, kvh, s, d,
                                               causal):
    q, k, v, do = _train_inputs(b, h, kvh, s, d, s + d + h + 2, cuda)
    ref_out, lse = attention.flash_attention_fwd_lse_ref(
        q, k, v, causal=causal, bk=attention.KERNEL_BK_LSE)
    args = (q, k, v, do, lse, (do * ref_out).sum(dim=-1))
    dk, dv = attention.flash_attention_bwd_dkv(*args, causal=causal)
    dk2, dv2 = attention.flash_attention_bwd_dkv(*args, causal=causal)
    ref_dk, ref_dv = attention.flash_attention_bwd_dkv_ref(*args,
                                                           causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    rel = attention.row_rel_err
    assert float(rel(dk, ref_dk).max()) <= TRAIN_GRAD_REL
    assert float(rel(dv, ref_dv).max()) <= TRAIN_GRAD_REL


# dQ's wgmma kernel (a persistent grid of 128-query items, two consumers
# of 64 rows; 64-key tiles): S of 1, 63, 65, 130 and 1,025, rep 1, 4 and
# 8, D 64 and 128, causal and not; within TRAIN_GRAD_REL of the plain
# version, two calls bit-equal (no atomics: each query row's sum has one
# owner), and the rule refuses chip_smoke.py's planted dQ fault (the last
# 64 queries with one key tile before them skipped). At S = 1 the
# consistent delta cancels dp (dq is 0 in exact arithmetic, both sides
# rounding noise), so there delta is drawn at random: the kernel computes
# the same function of any delta.
@pytest.mark.parametrize("b,h,kvh,s,d,causal", [
    (1, 8, 1, 1, 64, True), (2, 4, 4, 1, 128, False),
    (1, 16, 4, 63, 128, True), (1, 8, 8, 63, 64, False),
    (2, 8, 2, 65, 64, True), (1, 8, 1, 65, 128, False),
    (2, 4, 1, 130, 64, True), (1, 8, 8, 130, 128, False),
    (1, 8, 1, 1025, 64, False), (1, 16, 4, 1025, 128, True),
    (1, 8, 8, 1025, 64, True)])
def test_flash_bwd_dq_edges_repeat_their_bits(cuda, b, h, kvh, s, d,
                                              causal):
    q, k, v, do = _train_inputs(b, h, kvh, s, d, s + d + h + 3, cuda)
    ref_out, lse = attention.flash_attention_fwd_lse_ref(
        q, k, v, causal=causal, bk=attention.KERNEL_BK_LSE)
    delta = (do * ref_out).sum(dim=-1)
    if s == 1:
        delta = torch.randn(delta.shape, device=cuda,
                            generator=torch.Generator(cuda).manual_seed(h))
    args = (q, k, v, do, lse, delta)
    dq = attention.flash_attention_bwd_dq(*args, causal=causal)
    dq2 = attention.flash_attention_bwd_dq(*args, causal=causal)
    ref = attention.flash_attention_bwd_dq_ref(*args, causal=causal)
    bk = attention.KERNEL_BK_LSE
    j0 = s // 2 // bk * bk
    keep = torch.cat([torch.arange(j0, device=cuda),
                      torch.arange(min(j0 + bk, s), s, device=cuda)])
    last = slice(max(s - bk, 0), s)
    fault = attention.flash_attention_bwd_dq_ref(
        q[:, :, last], k[:, :, keep], v[:, :, keep], do[:, :, last],
        lse[:, :, last], delta[:, :, last], causal=causal)
    torch.cuda.synchronize()
    assert torch.isfinite(dq).all() and torch.equal(dq, dq2)
    rel = attention.row_rel_err
    assert float(rel(dq, ref).max()) <= TRAIN_GRAD_REL
    assert float(rel(fault, ref[:, :, last]).max()) > TRAIN_GRAD_REL


def test_mha_flash_train_on_the_card_matches_the_cpu(cuda):
    """The autograd function end to end: mha_flash_train and its
    gradients on the card (the three kernels) against the CPU (the plain
    versions) on the same inputs; dk and dv come back in bf16, so a row
    may also differ by one bf16 rounding (2^-8)."""
    rng = np.random.default_rng(11)
    b, s, h, kvh, d = 1, 600, 8, 2, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, d)).astype(
        np.float32)) for n in (h, kvh, kvh))
    w = torch.from_numpy(rng.standard_normal((b, s, h * d)).astype(
        np.float32))
    res = {}
    for dev in ("cpu", cuda):
        xs = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        out = attention.mha_flash_train(*xs, causal=True)
        out.backward(w.to(dev))
        res[str(dev)] = [t.detach().cpu() for t in (out, *(x.grad
                                                           for x in xs))]
    rel = attention.row_rel_err
    cpu, card = res["cpu"], res[str(cuda)]
    assert float(rel(card[0], cpu[0]).max()) <= TRAIN_OUT_REL
    assert float(rel(card[1], cpu[1]).max()) <= TRAIN_GRAD_REL
    for i in (2, 3):
        assert float(rel(card[i], cpu[i]).max()) <= TRAIN_GRAD_REL + 2 ** -7


def test_training_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, k, v, _ = _train_inputs(1, 2, 1, 64, 64, 0, cuda)
    with pytest.raises(ValueError):                 # the kernels' tiles
        attention.flash_attention_fwd_lse(q, k, v, bk=512)
    with pytest.raises(ValueError):                 # the forward's key tile
        attention.flash_attention_fwd_lse(q, k, v, bk=attention.KERNEL_BQ)
    with pytest.raises(ValueError):                 # dK/dV's query tile
        attention.flash_attention_train(q, k, v, bq=attention.KERNEL_BQ)
    with pytest.raises(TypeError):                  # q stays float32
        attention.flash_attention_fwd_lse(q.to(torch.bfloat16), k, v)
    with pytest.raises(ValueError):                 # self-attention only
        attention.flash_attention_train(q, k[:, :, :32], v[:, :, :32])


def test_kernel_wrappers_refuse_gradients_on_the_card(cuda):
    """A kernel with no backward raises under autograd instead of
    returning an output that carries no gradient."""
    q, k, v, _ = _train_inputs(1, 2, 1, 64, 64, 1, cuda)
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        attention.flash_attention_fwd_lse(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        attention.flash_attention(q.to(torch.bfloat16), k, v)


def test_fp32_matmul_gradient_stays_fp32_under_tf32(cuda):
    """With TF32 turned on globally, fp32_matmul's gradients are fp32
    products (TF32 would read ~1e-3 against fp64) and the flag stays on."""
    flags = torch.backends.cuda.matmul
    saved = (flags.allow_tf32, torch.get_float32_matmul_precision())
    rng = np.random.default_rng(12)
    x0, w0, g0 = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((512, 1024), (1024, 256), (512, 256)))
    try:
        flags.allow_tf32 = True
        x, w = (t.to(cuda).requires_grad_() for t in (x0, w0))
        vendor.fp32_matmul(x, w).backward(g0.to(cuda))
        assert flags.allow_tf32
    finally:
        flags.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    for got, want in ((x.grad, g0.double() @ w0.double().t()),
                      (w.grad, x0.double().t() @ g0.double())):
        rel = float((got.cpu().double() - want).abs().max()
                    / want.abs().max())
        assert rel < 1e-5, rel


def test_loss_fn_refuses_quantized_weights_on_the_card(cuda):
    from how_to_optimize_gemm_tpu_torch.models import llama
    cfg = llama.LlamaConfig(vocab=64, d_model=64, n_layers=1, n_heads=1,
                            n_kv_heads=1, d_ff=64, max_seq=16,
                            weight_kind="int8")
    params = llama.init_params(torch.Generator(cuda).manual_seed(0), cfg,
                               cuda)
    tokens = torch.zeros((1, 9), dtype=torch.int64, device=cuda)
    with pytest.raises(NotImplementedError, match="A15"):
        llama.loss_fn(params, cfg, tokens)


def test_training_on_the_card_resumes_bit_exactly(cuda, tmp_path):
    """A small model through the flash kernels (s = 512, d_head 64, rep 2):
    4 AdamW steps with a checkpoint at 2, then resumed from it; the losses
    and the parameters equal the uninterrupted run's, and each kernel runs
    once a layer a step."""
    from how_to_optimize_gemm_tpu_torch.models import llama
    from how_to_optimize_gemm_tpu_torch.parallel import training
    cfg = llama.LlamaConfig(vocab=128, d_model=128, n_layers=2, n_heads=2,
                            n_kv_heads=1, d_ff=256, max_seq=513,
                            weight_kind="bf16")
    rng = np.random.default_rng(13)
    batches = [torch.from_numpy(rng.integers(0, 128, (2, 513))).to(cuda)
               for _ in range(4)]

    def run(resume=None):
        params = llama.init_params(torch.Generator(cuda).manual_seed(0),
                                   cfg, cuda)
        opt = training.make_optimizer(1e-3)
        state = training.init_train_state(params, opt)
        if resume:
            state = training.checkpoint.load_train_state(resume, state)
        step = training.make_train_step(cfg, opt, flash_train=True)
        losses = []
        for i in range(state.step, 4):
            state, loss = step(state, batches[i])
            losses.append(float(loss))
            if i == 1 and resume is None:
                training.checkpoint.save_train_state(tmp_path / "s2", state)
        return state, losses

    before = _build.LAUNCHES["flash_attention_bwd_dkv"]
    state, losses = run()
    assert _build.LAUNCHES["flash_attention_bwd_dkv"] == before + 8
    state2, losses2 = run(tmp_path / "s2")
    assert losses2 == losses[2:] and all(np.isfinite(losses))
    for a, b in zip(training._leaves(state.params),
                    training._leaves(state2.params)):
        assert torch.equal(a, b)


# The grouped GEMM (MoE): bf16, int8 and packed int4 stacks run on the
# bf16 tensor cores (wgmma) with x split into bf16 hi + lo by split_bf16
# (about 2^-17 relative per product) and the sums in the tensor cores'
# order: within GROUPED_REL of max |plain| (the mma.sync kernel before it
# read up to 3.4e-5 on an H100 at K = 14,336, 2.9e-6 at K <= 256). fp32
# stacks on FFMA: within FP32_REL. One block reading the neighbouring
# expert's stack reads above 1 of max |plain|.
GROUPED_REL = 1e-4
# (E, d, f, Tp): aligned, f not a multiple of 128 (nor of 4) with d not a
# multiple of 32, and a wider one
GROUPED_SHAPES = [(4, 256, 256, 512), (3, 36, 130, 384), (8, 512, 1408, 2048),
                  (2, 64, 198, 256)]


def _grouped_case(kind, shape, seed, device):
    from how_to_optimize_gemm_tpu_torch.ops import quant
    e, d, f, tp = shape
    gen = torch.Generator(device).manual_seed(seed)
    w = torch.randn((e, d, f), generator=gen, device=device) * d ** -0.5
    x = torch.randn((tp, d), generator=gen, device=device)
    # experts in order, the last one with no block
    nb = tp // 128
    be = torch.sort(torch.randint(0, max(e - 1, 1), (nb,), generator=gen,
                                  device=device)).values.to(torch.int32)
    if kind in ("fp32", "bf16"):
        return x, (w.to(torch.bfloat16) if kind == "bf16" else w), be, \
            None, False
    q, s = quant.quantize_symmetric(w, axis=1, bits=8 if kind == "int8"
                                    else 4)
    if kind == "int4":
        return x, quant.pack_int4(q, d), be, s, True
    return x, q, be, s, False


@pytest.mark.parametrize("shape", GROUPED_SHAPES)
@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8", "int4"])
def test_grouped_gemm_matches_plain_version(cuda, kind, shape):
    from how_to_optimize_gemm_tpu_torch.ops import grouped_gemm as gg
    x, w, be, s, packed4 = _grouped_case(kind, shape, 7, cuda)
    before = _build.LAUNCHES["grouped_gemm"]
    got = gg.grouped_matmul(x, w, be, s, packed4=packed4)
    assert _build.LAUNCHES["grouped_gemm"] == before + 1
    ref = gg.grouped_matmul_ref(x, w, be, s, packed4=packed4)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    tol = FP32_REL if kind == "fp32" else GROUPED_REL
    assert err <= tol * scale, (err / scale)
    # the same rule refuses block 0 reading the neighbouring expert
    wrong = be.clone()
    wrong[0] = (wrong[0] + 1) % w.shape[0]
    bad = gg.grouped_matmul_ref(x, w, wrong, s, packed4=packed4)
    assert float((got - bad).abs().max()) > tol * scale


def test_grouped_gemm_refuses_grad_and_small_blocks(cuda):
    """Autograd through the kernels (grouped_gemm's forward and the int8
    recompute, grouped_gemm_t) gives the gradients of autograd through the
    plain version on the card, within GROUPED_REL; blocks smaller than the
    kernel's tile and stacks it has no kernel for are refused."""
    from how_to_optimize_gemm_tpu_torch.ops import grouped_gemm as gg
    x, w, be, s, _ = _grouped_case("int8", (2, 64, 128, 256), 3, cuda)
    dy = torch.randn((x.shape[0], w.shape[2]), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(4))
    grads = []
    for fn in (gg.grouped_matmul, gg.grouped_matmul_ref):
        xg, sg = x.clone().requires_grad_(), s.clone().requires_grad_()
        fn(xg, w, be, sg).backward(dy)
        grads.append((xg.grad, sg.grad))
    for got, ref in zip(*grads):
        err = float((got - ref).abs().max())
        assert err <= GROUPED_REL * float(ref.abs().max()), err
    with pytest.raises(ValueError, match="multiple of"):
        gg.grouped_matmul(x, w, be.repeat_interleave(2), s, bt=64)
    with pytest.raises(TypeError, match="no kernel"):
        gg.grouped_matmul(x, w.to(torch.int16), be, s)


# The backward kernels: grouped_gemm_t and grouped_gemm_t4 take dy split
# into bf16 hi + lo by split_bf16, two wgmma products as the forward
# (GROUPED_REL; fp32 stacks FFMA, FP32_REL); grouped_dw takes x and dy
# split by split_bf16 into three bf16 wgmma products, hi.hi + hi.lo +
# lo.hi, its sums added into fp32 registers every 256 rows, against the
# plain version's cuBLAS fp32 product over the expert's rows (FP32_REL). A
# planted fault reads above its rule: block 0 reading the neighbouring
# expert's stack (dx), one of an expert's blocks left out of its sum (dW).
@pytest.mark.parametrize("shape", GROUPED_SHAPES)
@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8", "int4"])
def test_grouped_gemm_t_matches_plain_version(cuda, kind, shape):
    from how_to_optimize_gemm_tpu_torch.ops import grouped_gemm as gg
    _, w, be, _, packed4 = _grouped_case(kind, shape, 8, cuda)
    dy = torch.randn((shape[3], shape[2]), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(9))
    name = "grouped_gemm_t4" if packed4 else "grouped_gemm_t"
    fn = gg.grouped_matmul_t4 if packed4 else gg.grouped_matmul_t
    ref_fn = gg.grouped_matmul_t4_ref if packed4 else gg.grouped_matmul_t_ref
    before = _build.LAUNCHES[name]
    got = fn(dy, w, be)
    assert _build.LAUNCHES[name] == before + 1
    assert got.shape == (shape[3], shape[1])
    ref = ref_fn(dy, w, be)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    tol = FP32_REL if kind == "fp32" else GROUPED_REL
    assert float((got - ref).abs().max()) <= tol * scale
    wrong = be.clone()
    wrong[0] = (wrong[0] + 1) % w.shape[0]
    bad = ref_fn(dy, w, wrong)
    assert float((got - bad).abs().max()) > tol * scale


@pytest.mark.parametrize("shape", GROUPED_SHAPES)
def test_grouped_dw_matches_plain_version(cuda, shape):
    from how_to_optimize_gemm_tpu_torch.ops import grouped_gemm as gg
    x, w, be, _, _ = _grouped_case("fp32", shape, 10, cuda)
    dy = torch.randn((shape[3], shape[2]), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(11))
    before = _build.LAUNCHES["grouped_dw"]
    got = gg.grouped_dw(x, dy, be, w.shape[0])
    assert _build.LAUNCHES["grouped_dw"] == before + 1
    ref = gg.grouped_dw_ref(x, dy, be, w.shape[0])
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= FP32_REL * scale
    # the last expert owns no block: zeros; and one block left out of its
    # expert's sum is refused by the same rule
    assert not got[-1].any()
    e0 = int(be[0])
    bad = ref[e0] - gg.grouped_dw_ref(x[:128], dy[:128], be[:1],
                                      w.shape[0])[e0]
    assert float((got[e0] - bad).abs().max()) > FP32_REL * scale


# The kernels that share csrc/wgmma.cuh with the flash kernels and rung
# 15 (the MoE grouped products, forward, dx and dW), the flash backward's
# dQ kernel, rungs 15 and 05 (one wgmma body, gemm_wgmma.cuh) and rung 07
# (W4A16, w4a16_wgmma.cuh): SHA-256 digests of their outputs on fixed
# inputs, as the tree before each rebuild gave them on an H100 (NVIDIA
# H100 80GB HBM3); dK/dV's, rung 07's and dQ's as their wgmma kernels give
# them (their tensor cores sum in another order than the mma.sync kernels
# did). Rung 05 on wgmma, its
# accumulators seeded with C, gives the bits of the mma.sync kernel before
# it. Rung 16 and decode_attention (the bf16 split walk) as the tree
# before rung 04 and the paged KV8 kernel joined their templates gave
# them; rung 04's as its wgmma kernel gives them. The same sources and
# nvcc give the same bits; a digest that moves means a kernel's code
# moved.
SHARED_DIGESTS = {
    "grouped_gemm bf16": "1ef3e9f68a803cbf",
    "grouped_gemm_t bf16": "45356b182853332a",
    "grouped_gemm int8": "aae1bf7b9975fc05",
    "grouped_gemm_t int8": "3cc5af954ba0e893",
    "grouped_gemm int4": "bb7834b80eba8fa1",
    "grouped_gemm_t int4": "b632e42c32bbc2bc",
    "grouped_dw": "cfcc1f7fabba2333",
    "flash_attention_bwd_dq": "8cc13d53b23aad3e",
    "flash_attention_bwd_dkv": "bdd0004dac43a8f0",
    "bf16_gemm_nt": "9b459eb9c7cec971",
    "bf16_gemm_nn": "c60e016745fb0762",
    "w4a16_gemm": "f67f248fda56f4fb",
    "fp32_gemm_nt": "ac11ae8d979cada5",
    "fp32_gemm_nn": "02471e1e15245f4e",
    "decode_attention": "2e8ac53d6c0b4578"}


def _shared_digests(device) -> dict:
    """{kernel and case: the first 16 hex digits of its output's SHA-256}."""
    import hashlib
    from how_to_optimize_gemm_tpu_torch.ops import grouped_gemm as gg
    outs = {}
    for kind in ("bf16", "int8", "int4"):
        x, w, be, s, packed4 = _grouped_case(kind, (3, 36, 130, 384), 7,
                                             device)
        outs[f"grouped_gemm {kind}"] = gg.grouped_matmul(x, w, be, s,
                                                         packed4=packed4)
        x, w, be, s, packed4 = _grouped_case(kind, (4, 256, 256, 512), 8,
                                             device)
        dy = torch.randn((512, 256), device=device,
                         generator=torch.Generator(device).manual_seed(9))
        fn = gg.grouped_matmul_t4 if packed4 else gg.grouped_matmul_t
        outs[f"grouped_gemm_t {kind}"] = fn(dy, w, be)
    x, w, be, _, _ = _grouped_case("fp32", (4, 256, 256, 512), 10, device)
    dy = torch.randn((512, 256), device=device,
                     generator=torch.Generator(device).manual_seed(11))
    outs["grouped_dw"] = gg.grouped_dw(x, dy, be, w.shape[0])
    q, k, v, do = _train_inputs(2, 8, 2, 200, 128, 12, device)
    ref_out, lse = attention.flash_attention_fwd_lse_ref(q, k, v)
    args = (q, k, v, do, lse, (do * ref_out).sum(dim=-1))
    outs["flash_attention_bwd_dq"] = attention.flash_attention_bwd_dq(*args)
    dk, dv = attention.flash_attention_bwd_dkv(*args)
    outs["flash_attention_bwd_dkv"] = torch.cat([dk, dv])
    for name in ("bf16_gemm_nt", "bf16_gemm_nn", "w4a16_gemm",
                 "fp32_gemm_nt", "fp32_gemm_nn"):
        rung, wrapper, _, _ = CASES[name]
        a, b, c = _abc((1000, 1032, 1100), 13, device)
        outs[name] = wrapper(*_operands(registry.get(rung).prepare(a, b)),
                             c.clone())
    rng = np.random.default_rng(14)
    lens = [0, 1, 512, 513, 1024]
    q = torch.from_numpy(rng.standard_normal((5, 8, 128)).astype(
        np.float32)).to(device)
    k, v = (torch.from_numpy(rng.standard_normal((5, 1024, 4, 128)).astype(
        np.float32)).to(device=device, dtype=torch.bfloat16) for _ in "kv")
    outs["decode_attention"] = decode_attention.decode_attention(
        q, k, v, torch.tensor(lens, dtype=torch.int32, device=device))
    torch.cuda.synchronize()
    return {name: hashlib.sha256(t.contiguous().cpu().numpy().tobytes())
            .hexdigest()[:16] for name, t in outs.items()}


def test_shared_kernels_keep_their_bits(cuda):
    assert _shared_digests(cuda) == SHARED_DIGESTS


@pytest.mark.parametrize("shape", [(9216, 4096), (384, 36), (256, 130),
                                   (3, 1)])
def test_split_bf16_matches_plain_version(cuda, shape):
    """The forward's and dW's pre-pass: EQUAL to its plain version, zero
    columns to the planes' 8-value rows included; one launch a call."""
    from how_to_optimize_gemm_tpu_torch.ops import grouped_gemm as gg
    x = torch.randn(shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(21))
    before = _build.LAUNCHES["split_bf16"]
    got = gg.split_bf16(x)
    assert _build.LAUNCHES["split_bf16"] == before + 1
    assert torch.equal(got, gg.split_bf16_ref(x))


# int4 stacks at ragged shapes: d = 36 (every K tile straddles d/2 = 18),
# d = 200 (d/2 = 100: the first K tile is low nibbles only, the second
# straddles), f = 100 and 130 (not multiples of 16: the stack's rows are
# padded for the tensor map, the column edge masked).
@pytest.mark.parametrize("shape", [(2, 36, 100, 256), (3, 36, 130, 384),
                                   (3, 200, 100, 384), (2, 200, 130, 256)])
def test_grouped_gemm_int4_ragged_edges(cuda, shape):
    from how_to_optimize_gemm_tpu_torch.ops import grouped_gemm as gg
    x, w, be, s, packed4 = _grouped_case("int4", shape, 17, cuda)
    before = dict(_build.LAUNCHES)
    got = gg.grouped_matmul(x, w, be, s, packed4=packed4)
    assert {k: _build.LAUNCHES[k] - before[k]
            for k in ("grouped_gemm", "split_bf16")} == \
        {"grouped_gemm": 1, "split_bf16": 1}
    ref = gg.grouped_matmul_ref(x, w, be, s, packed4=packed4)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= GROUPED_REL * scale


def test_grouped_dw_one_expert_of_8192_rows(cuda):
    """dW's worst case for the tensor cores' sums: one expert owning 8,192
    rows (64 blocks), two light experts and an empty one, within FP32_REL
    of max |plain|; the kernel and its two splits launched once a call."""
    from how_to_optimize_gemm_tpu_torch.ops import grouped_gemm as gg
    gen = torch.Generator(cuda).manual_seed(23)
    be = torch.tensor([0] * 64 + [1, 2, 2], dtype=torch.int32, device=cuda)
    tp = be.shape[0] * 128
    x = torch.randn((tp, 512), generator=gen, device=cuda)
    dy = torch.randn((tp, 384), generator=gen, device=cuda)
    before = dict(_build.LAUNCHES)
    got = gg.grouped_dw(x, dy, be, 4)
    assert {k: _build.LAUNCHES[k] - before[k]
            for k in ("grouped_dw", "split_bf16")} == \
        {"grouped_dw": 1, "split_bf16": 2}
    ref = gg.grouped_dw_ref(x, dy, be, 4)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= FP32_REL * scale
    assert not got[3].any()


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_grouped_kernels_repeat_bit_for_bit(cuda, kind):
    """Two calls on the same inputs give the same bits: the forward on
    each stack kind and dW (no atomics, a fixed order of sums)."""
    from how_to_optimize_gemm_tpu_torch.ops import grouped_gemm as gg
    x, w, be, s, packed4 = _grouped_case(kind, (8, 512, 1408, 2048), 19,
                                         cuda)
    runs = [gg.grouped_matmul(x, w, be, s, packed4=packed4)
            for _ in range(2)]
    assert torch.equal(*runs)
    dy = torch.randn((x.shape[0], 1408), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(20))
    dws = [gg.grouped_dw(x, dy, be, 8) for _ in range(2)]
    assert torch.equal(*dws)


# dx at ragged widths: dout 36 (every int4 tile straddles dout/2 = 18),
# 200 (dout/2 = 100 inside the first tile) and 1,000 (500 inside the
# fourth), f not a multiple of 8 or of 128; within the rule above, one
# split of dy and one kernel launch a call, the same bits on a second call.
@pytest.mark.parametrize("shape", [(3, 36, 130, 384), (2, 200, 100, 256),
                                   (4, 1000, 520, 512)])
@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8", "int4"])
def test_grouped_gemm_t_ragged_dout(cuda, kind, shape):
    from how_to_optimize_gemm_tpu_torch.ops import grouped_gemm as gg
    _, w, be, _, packed4 = _grouped_case(kind, shape, 24, cuda)
    dy = torch.randn((shape[3], shape[2]), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(25))
    name = "grouped_gemm_t4" if packed4 else "grouped_gemm_t"
    fn = gg.grouped_matmul_t4 if packed4 else gg.grouped_matmul_t
    ref_fn = gg.grouped_matmul_t4_ref if packed4 else gg.grouped_matmul_t_ref
    before = dict(_build.LAUNCHES)
    got = fn(dy, w, be)
    assert {k: _build.LAUNCHES[k] - before[k]
            for k in (name, "split_bf16")} == \
        {name: 1, "split_bf16": 0 if kind == "fp32" else 1}
    ref = ref_fn(dy, w, be)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    tol = FP32_REL if kind == "fp32" else GROUPED_REL
    err = float((got - ref).abs().max())
    print(f"{name} {kind} {shape}: {err / scale:.3e} of max |plain|")
    assert err <= tol * scale, err / scale
    assert torch.equal(fn(dy, w, be), got)


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8", "int4"])
def test_grouped_matmul_autograd_on_the_card_matches_the_plain_version(
        cuda, kind):
    """dx and dW (dense stacks) or dx and ds (int8, packed int4) through
    the kernels against autograd through the plain version on the card;
    each backward kernel launched once, the forward twice for a scaled
    stack (its unscaled recompute); the integer stacks unchanged."""
    from how_to_optimize_gemm_tpu_torch.ops import grouped_gemm as gg
    x, w, be, s, packed4 = _grouped_case(kind, (4, 256, 384, 1024), 12,
                                         cuda)
    dy = torch.randn((x.shape[0], w.shape[2]), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(13))
    frozen = w.clone()
    t = "grouped_gemm_t4" if packed4 else "grouped_gemm_t"
    want = {"grouped_gemm": 1 if s is None else 2, t: 1,
            "grouped_dw": 1 if s is None else 0}
    grads, launched = [], []
    for fn in (gg.grouped_matmul, gg.grouped_matmul_ref):
        xg = x.clone().requires_grad_()
        pg = (w if s is None else s).clone().requires_grad_()
        stack, scales = (pg, None) if s is None else (w, pg)
        before = dict(_build.LAUNCHES)
        fn(xg, stack, be, scales, packed4=packed4).backward(dy)
        launched.append({k: _build.LAUNCHES[k] - before[k] for k in want})
        grads.append((xg.grad, pg.grad))
    # the plain version launches nothing
    assert launched == [want, dict.fromkeys(want, 0)]
    for got, ref in zip(*grads):
        assert got.dtype == ref.dtype
        # fp32 stacks FFMA; a bf16 stack's dW rounded to bf16 on both sides
        # (one bf16 ulp, 2^-7 of max at most)
        tol = (FP32_REL if kind == "fp32" else 2 ** -7
               if got.dtype == torch.bfloat16 else GROUPED_REL)
        err = float((got.float() - ref.float()).abs().max())
        assert err <= tol * float(ref.float().abs().max()), err
    assert torch.equal(w, frozen)


@pytest.mark.parametrize("stacks", ["bf16", "int8"])
def test_moe_training_on_the_card_resumes_bit_exactly(cuda, tmp_path,
                                                      stacks):
    """A small MoE model (bf16 linears; bf16 or int8 expert stacks) on the
    ragged path at every step: 4 AdamW steps with a checkpoint at 2, then
    resumed from it; the losses and the parameters equal the
    uninterrupted run's, the int8 stacks are unchanged, and each step
    launches the grouped GEMM's kernels three times a layer."""
    from how_to_optimize_gemm_tpu_torch.models import llama
    from how_to_optimize_gemm_tpu_torch.parallel import moe, training
    cfg = llama.LlamaConfig(vocab=128, d_model=128, n_layers=2, n_heads=2,
                            n_kv_heads=1, d_ff=256, max_seq=64,
                            weight_kind="bf16", n_experts=4, moe_ragged=True,
                            moe_ragged_min_tokens=0)
    rng = np.random.default_rng(14)
    batches = [torch.from_numpy(rng.integers(0, 128, (2, 41))).to(cuda)
               for _ in range(4)]

    def run(resume=None):
        params = llama.init_params(torch.Generator(cuda).manual_seed(0),
                                   cfg, cuda)
        if stacks == "int8":
            for layer in params["layers"]:
                layer["moe"] = moe.quantize_moe(layer["moe"], 8)
        opt = training.make_optimizer(1e-3)
        state = training.init_train_state(params, opt)
        if resume:
            state = training.checkpoint.load_train_state(resume, state)
        step = training.make_train_step(cfg, opt)
        losses = []
        for i in range(state.step, 4):
            state, loss = step(state, batches[i])
            losses.append(float(loss))
            if i == 1 and resume is None:
                training.checkpoint.save_train_state(tmp_path / "s2", state)
        return state, losses

    names = ("grouped_gemm", "grouped_gemm_t", "grouped_dw")
    before = {k: _build.LAUNCHES[k] for k in names}
    state, losses = run()
    per_step = {"grouped_gemm": 3 if stacks == "bf16" else 6,
                "grouped_gemm_t": 3,
                "grouped_dw": 3 if stacks == "bf16" else 0}
    assert {k: _build.LAUNCHES[k] - before[k] for k in names} == {
        k: 4 * cfg.n_layers * n for k, n in per_step.items()}
    state2, losses2 = run(tmp_path / "s2")
    assert losses2 == losses[2:] and all(np.isfinite(losses))
    for a, b in zip(training._leaves(state.params),
                    training._leaves(state2.params)):
        assert torch.equal(a, b)
    if stacks == "int8":
        fresh = moe.quantize_moe(llama.init_params(
            torch.Generator(cuda).manual_seed(0), cfg, cuda)["layers"][0][
                "moe"], 8)
        assert torch.equal(fresh["w_in_q"],
                           state.params["layers"][0]["moe"]["w_in_q"])


@pytest.mark.parametrize("kind", ["int8", "w4a8"])
def test_moe_model_on_the_card_launches_the_grouped_gemm(cuda, kind):
    """A small MoE model's ragged forward takes the kernel three times a
    layer and gives finite logits; one layer's ragged MoE on the card
    picks the CPU's experts for every token but near-ties (a top-k gap
    within 1e-5) and matches the CPU's output on the others within
    GROUPED_REL of max |y| (its three grouped GEMMs, fp32 glue)."""
    from how_to_optimize_gemm_tpu_torch.models import llama
    from how_to_optimize_gemm_tpu_torch.parallel import moe
    cfg = llama.LlamaConfig(vocab=128, d_model=128, n_layers=2, n_heads=2,
                            n_kv_heads=1, d_ff=256, max_seq=64,
                            weight_kind=kind, n_experts=4, moe_ragged=True,
                            moe_ragged_min_tokens=0)
    params = llama.init_params(torch.Generator(cuda).manual_seed(0), cfg,
                               cuda)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, 128, (2, 40))).to(cuda)
    before = _build.LAUNCHES["grouped_gemm"]
    logits = llama.forward(params, cfg, tokens)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["grouped_gemm"] == before + 3 * cfg.n_layers
    assert torch.isfinite(logits).all()
    layer = params["layers"][0]["moe"]
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (300, cfg.d_model)).astype(np.float32))
    got = moe.moe_ffn_ragged(layer, x.to(cuda)).cpu()
    ref = moe.moe_ffn_ragged(convert.to_device(layer, "cpu"), x)
    probs, _, choice = moe._top_k_gates(convert.to_device(layer, "cpu"), x, 2)
    _, _, card_choice = moe._top_k_gates(layer, x.to(cuda), 2)
    same = (torch.sort(card_choice.cpu(), -1).values
            == torch.sort(choice, -1).values).all(-1)
    top3 = torch.topk(probs, 3, -1).values
    assert ((top3[:, 1] - top3[:, 2])[~same] <= 1e-5).all()
    err = float((got - ref)[same].abs().max())
    assert err <= GROUPED_REL * float(ref.abs().max()), err


# ------------------------------------------------- the probes (B21, B22)
# Each probe kernel against its plain version at small shapes. EQUAL: the
# int8 chains and throughput (wrapping int32), the copies, the checksums,
# the VMEM copies, the latency sums and add_one. Within a bound: the bf16
# chain, n_iters x 2^-8 of max |plain| (fp32 sums in another order, then
# each acc rounded to bf16, where one difference may land on the
# neighbouring bf16); the 3xTF32 chain, n_iters x (S x 2^-24 + 2^-20) of
# the largest sum of |terms| (fp32 sums in another order, and the split's
# dropped lo x lo with the tf32 rounding of lo, about 2^-21 a product);
# bf16 throughput, n_iters x K x 2^-24 of the largest |x| @ |y|; exp,
# (n_iters + 4) x 2^-23 of |plain| (ex2.approx about 2 ulp a term, and
# each sum may round to the neighbouring float); FFMA, one ulp a step.

def _probe_rng(seed):
    return np.random.default_rng(seed)


def _counted(name, fn):
    before = _build.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1, name
    return out


@pytest.mark.parametrize("n_iters", [1, 4])
@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("dtype", ["int8", "bf16", "fp32"])
def test_mma_chain_equals_plain_version(cuda, dtype, size, n_iters):
    from how_to_optimize_gemm_tpu_torch.ops import probes
    rng = _probe_rng(size + n_iters)
    shape = (3, size, size)
    if dtype == "int8":
        x = torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8))
        y = torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8))
    else:
        x = torch.from_numpy((rng.uniform(0, 1, shape) * 2.0 / size)
                             .astype(np.float32))
        y = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
        if dtype == "bf16":
            x, y = x.to(torch.bfloat16), y.to(torch.bfloat16)
    x, y = x.to(cuda), y.to(cuda)
    out = _counted("mma_chain", lambda: probes.mxu_chain(x, y, n_iters))
    ref = probes.mxu_chain_ref(x, y, n_iters)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if dtype == "int8":
        assert torch.equal(out, ref)
        return
    err = float((out - ref).abs().max())
    if dtype == "bf16":
        assert err <= n_iters * 2.0 ** -8 * float(ref.abs().max()), err
    else:
        bound = float((x.abs() @ ref.abs()).max())
        assert err <= n_iters * (size * 2.0 ** -24 + 2.0 ** -20) * bound, err


def test_mma_chain_tile_alone_equals_the_batch(cuda):
    """A 2-D tile runs as one block, the same as the batch's first."""
    from how_to_optimize_gemm_tpu_torch.ops import probes
    x, y = probes.chain_inputs("bf16", 128, 2, cuda)
    both = probes.mxu_chain(x, y, 3)
    assert torch.equal(probes.mxu_chain(x[0], y[0], 3), both[0])


@pytest.mark.parametrize("dtype,k", [("int8", 128), ("int8", 256),
                                     ("bf16", 64), ("bf16", 512)])
def test_mma_throughput_equals_plain_version(cuda, dtype, k):
    from how_to_optimize_gemm_tpu_torch.ops import probes
    rng = _probe_rng(k)
    n_iters = 3
    if dtype == "int8":
        x = torch.from_numpy(rng.integers(-128, 128, (2, 64, k))
                             .astype(np.int8)).to(cuda)
        y = torch.from_numpy(rng.integers(-128, 128, (2, k, 64))
                             .astype(np.int8)).to(cuda)
    else:
        x = torch.from_numpy(rng.uniform(-1, 1, (2, 64, k)).astype(
            np.float32)).to(cuda).to(torch.bfloat16)
        y = torch.from_numpy(rng.uniform(-1, 1, (2, k, 64)).astype(
            np.float32)).to(cuda).to(torch.bfloat16)
    out = _counted("mma_throughput",
                   lambda: probes.mxu_throughput(x, y, n_iters))
    ref = probes.mxu_throughput_ref(x, y, n_iters)
    if dtype == "int8":
        assert torch.equal(out, ref)
    else:
        bound = float((x.float().abs() @ y.float().abs()).max())
        err = float((out - ref).abs().max())
        assert err <= n_iters * k * 2.0 ** -24 * bound, err


def test_exp_chain_equals_plain_version(cuda):
    from how_to_optimize_gemm_tpu_torch.ops import probes
    x = torch.from_numpy(_probe_rng(1).uniform(-2, 1, (5, 1000)).astype(
        np.float32)).to(cuda)
    n_iters = 16
    out = _counted("exp_chain", lambda: probes.vpu_exp(x, n_iters))
    ref = probes.vpu_exp_ref(x, n_iters)
    assert ((out - ref).abs() <= (n_iters + 4) * 2.0 ** -23
            * ref.abs()).all()


@pytest.mark.parametrize("dependent", [True, False])
def test_ffma_chain_equals_plain_version(cuda, dependent):
    from how_to_optimize_gemm_tpu_torch.ops import probes
    x = torch.from_numpy(_probe_rng(2).uniform(-1, 1, (7, 512)).astype(
        np.float32)).to(cuda)
    n_iters = 8
    out = _counted("ffma_chain",
                   lambda: probes.vpu_fma(x, n_iters, dependent))
    ref = probes.vpu_fma_ref(x, n_iters, dependent)
    steps = n_iters * (8 if dependent else 1) + 3
    assert ((out - ref).abs() <= steps * 2.0 ** -23
            * torch.maximum(ref.abs(), x.abs())).all()


def test_copy_grid_equals_plain_version(cuda):
    from how_to_optimize_gemm_tpu_torch.ops import probes
    x = torch.from_numpy(_probe_rng(3).standard_normal((1000, 36)).astype(
        np.float32)).to(cuda)
    out = _counted("copy_grid", lambda: probes.hbm_copy(x))
    assert torch.equal(out, probes.hbm_copy_ref(x))


@pytest.mark.parametrize("parent,rows,cols,reps", [
    (1024, 256, 512, 2), (1024, 512, 256, 1), (4096, 64, 4096, 3),
    (2048, 1024, 2048, 1)])
def test_tile_read_equals_plain_version(cuda, parent, rows, cols, reps):
    from how_to_optimize_gemm_tpu_torch.ops import probes
    x = torch.from_numpy(_probe_rng(parent + rows).integers(
        -128, 128, (parent, parent)).astype(np.int8)).to(cuda)
    out = _counted("tile_read",
                   lambda: probes.dma_chunk_checksum(x, rows, cols, reps))
    assert torch.equal(out, probes.dma_chunk_checksum_ref(x, rows, cols,
                                                          reps))
    with pytest.raises(ValueError, match="even count"):
        probes.dma_chunk_checksum(x, parent, parent, 1)


def test_smem_copy_equals_plain_version(cuda):
    from how_to_optimize_gemm_tpu_torch.ops import probes
    x = torch.from_numpy(_probe_rng(4).integers(-128, 128, (32, 2048))
                         .astype(np.int8)).to(cuda)
    out = _counted("smem_copy", lambda: probes.vmem_copy(x, 3))
    assert torch.equal(out, probes.vmem_copy_ref(x, 3))


@pytest.mark.parametrize("rows,cols,nsrc,n_iters", [(32, 128, 8, 64),
                                                    (8, 2048, 3, 10)])
def test_load_latency_equals_plain_version(cuda, rows, cols, nsrc, n_iters):
    from how_to_optimize_gemm_tpu_torch.ops import probes
    x = torch.from_numpy(_probe_rng(5).integers(
        -128, 128, (rows * nsrc, cols)).astype(np.int8)).to(cuda)
    for load in (True, False):
        out = _counted("load_latency", lambda: probes.dma_latency_sum(
            x, rows, n_iters, load))
        assert torch.equal(out, probes.dma_latency_sum_ref(x, rows, n_iters,
                                                           load))


@pytest.mark.parametrize("total_rows,cols,rows,nslots,reps", [
    (64, 128, 8, 4, 2), (72, 256, 4, 2, 1), (60, 512, 3, 3, 1),
    (4096, 2048, 2, 4, 1)])
def test_pipelined_copy_equals_plain_version(cuda, total_rows, cols, rows,
                                             nslots, reps):
    from how_to_optimize_gemm_tpu_torch.ops import probes
    x = torch.from_numpy(_probe_rng(6).standard_normal((total_rows, cols))
                         .astype(np.float32)).to(cuda)
    out, n = _counted("pipelined_copy", lambda: probes.manual_copy(
        x, rows, nslots, reps))
    ref, ref_n = probes.manual_copy_ref(x, rows, nslots, reps)
    assert torch.equal(out, ref) and torch.equal(n, ref_n)


def test_add_one_equals_plain_version_and_replays_from_a_graph(cuda):
    from how_to_optimize_gemm_tpu_torch.ops import dispatch_probe
    x = torch.from_numpy(_probe_rng(7).uniform(-300, 300, (8, 256)).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    out = _counted("add_one", lambda: dispatch_probe.add_one(x))
    assert torch.equal(out, dispatch_probe.add_one_ref(x))
    fn, args = dispatch_probe._make_chain("custom", 16, cuda)
    replay = dispatch_probe._graphed(fn, args)
    before = _build.LAUNCHES["add_one"]
    total = replay()
    torch.cuda.synchronize()
    assert float(total) == 8 * 256 * 17
    assert _build.LAUNCHES["add_one"] == before   # replays launch nothing
