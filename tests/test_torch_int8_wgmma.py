"""The int8 wgmma kernel of K2 and rung 18 (``csrc/gemm_wgmma.cuh``'s int8
instance: ``int8_gemm_nt``, ``int8_ragged_nt``) modelled on the CPU, against
the JAX package's ``pallas_int8.mmult_q_bt`` in interpret mode and the
port's plain version.

The model does what the kernel does, in numpy: it walks the output's
128 x 256 tiles in the kernel's order (K2's groups of row tiles, or rung
18's strip plan); for each consumer's 64 rows it takes each stage's
128-byte K lines of QA and QBT as the tensor-map copies deliver them (zero
past K, M and N), sums the four 32-byte-deep products of a stage in int32
stage by stage, places the sums in the threads' registers by the layout of
``wgmma.m64n256k32`` (warp w, lane 4 g + t: rows 16 w + g and 16 w + g +
8, columns 8 i + 2 t and 8 i + 2 t + 1), applies the dequant in the
registers in the kernel's order with sb staged 128 columns a pass, and
adds C: through the 32-column swizzled staging that the tensor-map
reduction reads where C's rows are 16-byte multiples, else by each thread.

Tolerances: the model EQUALS the port's plain version (``mmult_q_bt_ref``)
at (M, N, K) = (300, 262, 520), (129, 520, 1100) and (1, 300, 16), and
the JAX kernel in interpret mode on unit scales and a zero C, where the
reference's epilogue is exact (its int32 sums as fp32). With real scales
and C the JAX kernel is held within 1e-6 x max |ref|, the repository's
rule for it (tests/test_torch_hand_pipeline.py): XLA:CPU contracts
``x * sb + c`` into an FMA, which the kernel and the plain version never do
(measured: up to 3.8e-6 absolute, one ulp, at these shapes).

Beside it, the host-side pieces: the two walks on 128 x 256 tiles (every
tile exactly once; rung 18's in plan order, strip by strip, N-major within
a strip) at the plans ``ragged_m_plan`` gives for 4,096 and at the
smoke's walk shape, and the constants read from the kernel's sources. The
kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.ops import pallas_int8 as jint8
from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import int8, tuned

torch.set_num_threads(1)

H100_SMS = 132
LINE = 128          # bytes of a swizzled line: K bytes a stage
OUT_COLS = 32       # fp32 columns of an epilogue staging box
SB_COLS = 128       # columns of sb staged a pass
WALK = (2001, 2102, 520)
SHAPES = [(300, 262, 520), (129, 520, 1100), (1, 300, 16)]


def _const(source, name):
    src = (_build.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


# a consumer warpgroup's 128 threads and their 128 accumulators: warp w,
# lane 4 g + t; accumulator i = 4 j + 2 h + e at row 16 w + g + 8 h and
# column 8 j + 2 t + e of the consumer's 64 x 256
W, G, T, I = np.meshgrid(np.arange(4), np.arange(8), np.arange(4),
                         np.arange(128), indexing="ij")
J, H, E = I // 4, (I // 2) % 2, I % 2
ROW = 16 * W + G + 8 * H
COL = 8 * J + 2 * T + E


def swizzled_offset(r, col):
    """Byte offset of fp32 column ``col`` of row ``r`` in a staging box: the
    16-byte chunk's index within the row's 128-byte line XORed with r % 8
    (the kernel's flush_tma, and the map's 128-byte swizzle)."""
    return r * LINE + ((((col >> 2) ^ (r & 7)) << 4) | ((col & 3) << 2))


def consumer_sums(qa_lines, qbt_lines):
    """int32 sums of one consumer's 64 rows x 256 columns, stage by stage:
    each stage's four 32-byte-deep products (m64n256k32)."""
    acc = np.zeros((64, 256), np.int64)
    for st in range(qa_lines.shape[1] // LINE):
        a = qa_lines[:, st * LINE:(st + 1) * LINE]
        b = qbt_lines[:, st * LINE:(st + 1) * LINE]
        for k in range(LINE // 32):
            acc += a[:, 32 * k:32 * k + 32] @ b[:, 32 * k:32 * k + 32].T
    assert np.abs(acc).max() < 2 ** 31
    return acc.astype(np.int32)


def kernel_model(qa, sa, qbt, sb, c, walk):
    """C' as the kernel computes it from its operands (K as the wrapper
    pads it), tile by tile in ``walk``'s order: [(m0, n0), ...]."""
    m, k = qa.shape
    n = qbt.shape[0]
    bm, bn = int8.NT_TILE
    kp = -(-k // int8.ALIGN) * int8.ALIGN
    stages = -(-kp // LINE)
    # the maps' zero fill: rows past M or N, K past kp (the pad is zeros)
    qa_z = np.zeros((-(-m // bm) * bm, stages * LINE), np.int64)
    qa_z[:m, :k] = qa
    qbt_z = np.zeros((-(-n // bn) * bn, stages * LINE), np.int64)
    qbt_z[:n, :k] = qbt
    sa_z = np.zeros(qa_z.shape[0], np.float32)
    sa_z[:m] = sa[:, 0]
    sb_z = np.zeros(qbt_z.shape[0], np.float32)
    sb_z[:n] = sb[0]
    out = c.copy()
    tma = n % 4 == 0        # C's rows 16-byte multiples (C is out)
    for m0, n0 in walk:
        for cw in range(2):
            row0 = m0 + 64 * cw
            sums = consumer_sums(qa_z[row0:row0 + 64], qbt_z[n0:n0 + bn])
            regs = sums[ROW, COL]
            # dequant in the registers: a thread's two rows' sa, sb staged
            # SB_COLS columns a pass (SB_COLS / 2 accumulators a pass)
            s_row = sa_z[row0 + ROW]
            sbuf = sb_z[n0:n0 + bn].reshape(-1, SB_COLS)
            s_col = sbuf[I // (SB_COLS // 2),
                         8 * (J % (SB_COLS // 8)) + 2 * T + E]
            v = (regs.astype(np.float32) * s_row) * s_col
            rows, cols = row0 + ROW, n0 + COL
            if not tma:     # each thread adds its own elements
                live = (rows < m) & (cols < n)
                out[rows[live], cols[live]] = v[live] + c[rows[live],
                                                          cols[live]]
                continue
            # each OUT_COLS-column chunk through a swizzled staging box,
            # added into C by the tensor-map unit (rows < M, columns < N)
            for ch in range(bn // OUT_COLS):
                box = np.full(64 * OUT_COLS, np.nan, np.float32)
                mine = J // 4 == ch
                off = swizzled_offset(ROW[mine], COL[mine] - OUT_COLS * ch)
                assert len(set(off.tolist())) == off.size
                box[off // 4] = v[mine]
                r, cc = np.meshgrid(np.arange(64), np.arange(OUT_COLS),
                                    indexing="ij")
                vals = box[swizzled_offset(r, cc) // 4]
                assert not np.isnan(vals).any()
                gr, gc = row0 + r, n0 + OUT_COLS * ch + cc
                live = (gr < m) & (gc < n)
                out[gr[live], gc[live]] = c[gr[live], gc[live]] + vals[live]
    return out


def _operands(m, n, k, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    b = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    c = rng.uniform(-1, 1, (m, n)).astype(np.float32)
    a[0, :5] = [1.0, -1.0, 0.0, 0.5, -0.25]      # a row's extremes
    qa, sa, qbt, sb = (x.numpy() for x in int8.prepare_packed(
        torch.from_numpy(a), torch.from_numpy(b)))
    return qa, sa, qbt, sb, c


def k2_walk(m, n):
    return [t for block in tuned.nt_tile_walk(m, n, H100_SMS, int8.NT_TILE)
            for t in block]


def rung18_walk(m, n, cap):
    plan = int8.ragged_m_plan(-(-m // 128) * 128, cap)
    return [t for block in int8.ragged_walk(plan, n, H100_SMS)
            for t in block]


@pytest.mark.parametrize("walk", ["k2", "rung18"])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_model_equals_plain_version_and_jax(shape, walk):
    m, n, k = shape
    qa, sa, qbt, sb, c = _operands(m, n, k, SHAPES.index(shape))
    tiles = k2_walk(m, n) if walk == "k2" else rung18_walk(m, n, 256)
    got = kernel_model(qa, sa, qbt, sb, c, tiles)
    plain = int8.mmult_q_bt_ref(*(torch.from_numpy(x) for x in
                                  (qa, sa, qbt, sb, c))).numpy()
    np.testing.assert_array_equal(got, plain)
    jax_out = np.asarray(jint8.mmult_q_bt(
        *(jnp.asarray(x) for x in (qa, sa, qbt, sb, c)), interpret=True))
    scale = float(np.abs(jax_out).max())
    np.testing.assert_allclose(got, jax_out, rtol=0, atol=1e-6 * scale)
    # unit scales and a zero C: the reference's epilogue is its int32
    # sums as fp32, no rounding to contract, so the sums are held EQUAL
    ones_a, ones_b = np.ones_like(sa), np.ones_like(sb)
    zero = np.zeros_like(c)
    sums = kernel_model(qa, ones_a, qbt, ones_b, zero, tiles)
    jax_sums = np.asarray(jint8.mmult_q_bt(
        *(jnp.asarray(x) for x in (qa, ones_a, qbt, ones_b, zero)),
        interpret=True))
    np.testing.assert_array_equal(sums, jax_sums)


def test_kernel_model_keeps_subnormals():
    """The card test's subnormal case on the model: sa = 2^-120 and
    sb = 2^-30 make v = (acc x 2^-120) x 2^-30 subnormal for
    2 <= |acc| < 2^23, and C holds subnormals of both signs; the model,
    the plain version and numpy's fp32 agree, on both epilogues."""
    for m, n, k in ((130, 264, 160), (130, 262, 160)):
        qa, _, qbt, _, _ = _operands(m, n, k, 7)
        sa = np.full((m, 1), 2.0 ** -120, np.float32)
        sb = np.full((1, n), 2.0 ** -30, np.float32)
        rng = np.random.default_rng(8)
        c = (rng.integers(-2 ** 20, 2 ** 20, (m, n)) * 2.0 ** -149).astype(
            np.float32)
        got = kernel_model(qa, sa, qbt, sb, c, k2_walk(m, n))
        plain = int8.mmult_q_bt_ref(*(torch.from_numpy(x) for x in
                                      (qa, sa, qbt, sb, c))).numpy()
        np.testing.assert_array_equal(got, plain)
        tiny = np.abs(got) < np.finfo(np.float32).tiny
        assert tiny.mean() > 0.9 and (got[tiny] != 0).mean() > 0.9


def _plan_tile(plan, num_n, t):
    """int8_ragged_nt.cu's PlanWalk::tile, line by line."""
    (bm1, g1, _), (bm2, g2, off2) = plan[0], (
        plan[1] if len(plan) > 1 else (128, 0, 0))
    bm, row0 = bm1, 0
    head = g1 * (bm1 // 128) * num_n
    if t >= head:
        t, bm, row0 = t - head, bm2, off2 * bm2
    rt = bm // 128
    strip = t // (rt * num_n)
    u = t - strip * rt * num_n
    panel = u // rt
    return row0 + strip * bm + (u - panel * rt) * 128, panel * 256


PLANS = [(4096, 4096, 1664), (4096, 4096, 1792), (WALK[0], WALK[1], 512),
         (640, 256, 256), (300, 262, 1792)]


@pytest.mark.parametrize("m,n,cap", PLANS)
def test_walks_cover_every_tile_once(m, n, cap):
    """K2's grouped walk and rung 18's plan walk on 128 x 256 tiles each
    compute every output tile exactly once, the blocks' walks one apart at
    most; rung 18's tile order is the C walk's, strip by strip, and within
    a strip the strip's row tiles of one panel, then the next panel."""
    bm, bn = int8.NT_TILE
    expected = {(i * bm, j * bn) for i in range(-(-m // bm))
                for j in range(-(-n // bn))}
    plan = int8.ragged_m_plan(-(-m // 128) * 128, cap)
    for walk in (tuned.nt_tile_walk(m, n, H100_SMS, int8.NT_TILE),
                 int8.ragged_walk(plan, n, H100_SMS)):
        tiles = [t for block in walk for t in block]
        assert len(tiles) == len(expected) and set(tiles) == expected
        assert max(map(len, walk)) - min(map(len, walk)) <= 1
    # tile t of the launch is block t % blocks's (t // blocks)-th
    walk = int8.ragged_walk(plan, n, H100_SMS)
    order = [walk[t % H100_SMS][t // H100_SMS] for t in range(len(expected))]
    num_n = -(-n // bn)
    assert order == [_plan_tile(plan, num_n, t) for t in range(len(order))]
    pos = 0
    for strip_bm, strips, off in plan:
        for s in range(strips):
            row0 = (off + s) * strip_bm
            rows = min(strip_bm, -(-m // 128) * 128 - row0)
            want = [(row0 + r, p * bn) for p in range(num_n)
                    for r in range(0, rows, bm)]
            assert order[pos:pos + len(want)] == want
            pos += len(want)
    assert pos == len(order)


def test_walk_shape_wraps_the_grid():
    """At WALK the grouped walk takes more tiles than the card's SMs, and no
    multiple of them: 16 x 9 = 144 tiles, each block 1 or 2."""
    walk = tuned.nt_tile_walk(WALK[0], WALK[1], H100_SMS, int8.NT_TILE)
    assert sum(map(len, walk)) == 144 and {len(w) for w in walk} == {1, 2}


@pytest.mark.parametrize("source,struct", [("int8_gemm_nt.cu", "K2"),
                                           ("int8_ragged_nt.cu", "Rung18")])
def test_kernel_constants_match_the_host(source, struct):
    """The tile, ring and walk the host describes are the kernel's: BM and
    GROUP_M from the shared body, BN and the ring's stages from the
    instance (both int8 files name the same), its shared memory inside a
    block's 227 KB."""
    body = "gemm_wgmma.cuh"
    text = (_build.CSRC / source).read_text()
    assert f"struct {struct} {{" in text and "S8 = true;" in text
    assert int8.NT_TILE == (_const(body, "BM"), _const(source, "BN"))
    assert int8.STAGES == _const(source, "ST")
    assert tuned.NT_GROUP_M == _const(body, "GROUP_M")
    assert int8.STAGE_K == LINE and _const(body, "OUT_COLS") == OUT_COLS
    assert _const(body, "SB_COLS") == SB_COLS
    bm, bn = int8.NT_TILE
    stage = (bm + bn) * int8.STAGE_K
    smem = (int8.STAGES * stage + 2 * 2 * 64 * OUT_COLS * 4 + 2 * SB_COLS * 4
            + 16 * int8.STAGES + 1024)
    assert smem <= 232448, smem


def test_ragged_cap_moves_only_from_k_10544():
    """The 256-column panels move rung 18's default cap (1,792 or 1,536 to
    512) only where a wave's wider panels leave the L2 budget, K 10,544 to
    15,568; at K 4,096 it stays 1,792: (1,792 + 10 x 256) x 4,096 bytes is
    17.8 MB of the 45.9 MB budget."""
    budget = int8.l2_budget("cpu")
    moved = [kp for kp in range(16, 20000, 16)
             if int8.ragged_cap(kp, budget, 128)
             != int8.ragged_cap(kp, budget, 256)]
    assert (moved[0], moved[-1], len(moved)) == (10544, 15568, 315)
    assert (1792 + 10 * 256) * 4096 == 17_825_792 <= budget == 45_875_200
