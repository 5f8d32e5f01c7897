"""Rungs 10 and 12 on K2's int8 wgmma body as a ping-pong
(``csrc/gemm_wgmma.cuh``'s PINGPONG instance: ``int8_fat_nt``,
``int8_resident_nt``) modelled on the CPU.

The walk. A block takes the TM x BN tiles (TM the body's BM) of ``tuned.nt_tile_walk`` on that
tile, and consumer warpgroup cw takes the block's tiles j (its j-th) with
j % 2 == cw, each whole; the producer fills the ring in the block's tile
order, so tile j's stages are ring uses j x stages .. (j + 1) x stages - 1
and a consumer starts each of its tiles at use j x stages.

The sums and the epilogue. The model does what the kernel does, in numpy:
each consumer's TM / 64 products of m64nBNk32 a 32-byte K step (int32
sums in wgmma's accumulator layout), K2's dequant with sb staged SB_COLS
columns a pass, and the C_LOAD epilogue over the consumer's 64-row
products: C's boxes of 64 rows x 32 columns (zeros past M and N) into its
two swizzled buffers, box i in buffer i % 2, each thread's __fadd_rn of
its sums there, the box stored over a fresh output clipped at M and N, box
i + 2 loaded once box i's store has read the buffer; the load barriers'
phases are replayed across the consumer's tiles (each wait names the
parity of its own load).

The ring. One producer and two consumer warpgroups of 4 warps each are
replayed event by event, in orders drawn from a seed, on mbarriers with
the hardware's parity rule (a wait passes while the barrier's current phase
parity differs from the one named). Each consumer waits on full barriers
of its own, keeping a parity bit a slot; every wait must pass only once
the phase it names has completed, no slot may be refilled before the one
warpgroup that read it released it, and the replay must not stall. On one
full barrier shared by both consumers (the parity taken from the ring
use) a wait passes early: the model sees the fault.

Rung 12's L2 ranges. Before the walk every block prefetches 16 KB pieces
of A's and B^T's rows (piece i by block i % grid), and at its end its
consumers set 128-byte lines back to evict_normal (line i by block i %
grid): each range is covered once, and each block's share is its own.

Tolerances: the model EQUALS the port's plain version
(``mmult_q_packed_ref``) at (300, 262, 520), (129, 520, 1100), (1, 300,
16) and on walks that leave blocks an odd tile count; the JAX kernels
(``pallas_manual_dma.mmult_q_packed`` and ``mmult_q_resident`` in interpret
mode) on unit scales and a zero C EQUAL it, and with real scales and C are
within 1e-6 x max |ref| (XLA:CPU contracts ``x * sb + c`` into an FMA;
tests/test_torch_int8_wgmma.py). The constants are read from the kernels'
sources. The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.ops import pallas_manual_dma as jdma
from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import int8, manual_dma, tuned

torch.set_num_threads(1)

LINE = 128          # bytes of a swizzled line: K bytes a stage
H100_SMS = 132
SHAPES = [(300, 262, 520), (129, 520, 1100), (1, 300, 16)]


def _src(name):
    return (_build.CSRC / name).read_text()


def _const(source, name, kind="int"):
    if kind == "int":
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             _src(source))[1])
    return re.search(rf"constexpr bool {name} = (true|false);",
                     _src(source))[1] == "true"


BODY = "gemm_wgmma.cuh"
BN, ST = (_const("int8_fat.cu", k) for k in ("BN", "ST"))
TM = _const(BODY, "BM")   # rows a ping-pong tile
OUT_COLS = _const(BODY, "OUT_COLS")
SB_COLS = _const(BODY, "SB_COLS")
MH = TM // 64       # products of 64 rows a consumer takes each K step
NA = BN // 2        # accumulators a thread and product
NB = BN // OUT_COLS  # staging boxes a product
WARPS = 4           # a consumer warpgroup's warps: a slot's releases

# a consumer's 128 threads and a product's NA accumulators (warp w, lane
# 4 g + t; accumulator i = 4 j + 2 h + e at row 16 w + g + 8 h, column
# 8 j + 2 t + e of the product's 64 x BN)
W, G, T, I = np.meshgrid(np.arange(4), np.arange(8), np.arange(4),
                         np.arange(NA), indexing="ij")
J, H, E = I // 4, (I // 2) % 2, I % 2
ROW = 16 * W + G + 8 * H
COL = 8 * J + 2 * T + E


def swizzled(addr_row, col_chunk):
    """Byte address of 16-byte chunk ``col_chunk`` of the line at byte
    ``addr_row`` (a multiple of 128), the 128-byte swizzle."""
    return addr_row + ((col_chunk ^ ((addr_row >> 7) & 7)) << 4)


def staging_offset(r, col):
    """fp32 column ``col`` of row ``r`` of a staging box (flush_load)."""
    return swizzled(r * LINE, col >> 2) + ((col & 3) << 2)


def pingpong_walk(m, n, blocks):
    """[[(j, cw, m0, n0), ...] a block]: the block's tiles in its order,
    tile j taken by consumer j % 2."""
    return [[(j, j % 2, m0, n0) for j, (m0, n0) in enumerate(tiles)]
            for tiles in tuned.nt_tile_walk(m, n, blocks, (TM, BN))]


def _padded(qa, sa, qbt, sb, rows_to, cols_to):
    """The maps' zero fill: rows past M or N, K past the padded K."""
    m, k = qa.shape
    n = qbt.shape[0]
    kp = -(-k // int8.ALIGN) * int8.ALIGN
    stages = -(-kp // LINE)
    qa_z = np.zeros((rows_to, stages * LINE), np.int64)
    qa_z[:m, :k] = qa
    qbt_z = np.zeros((cols_to, stages * LINE), np.int64)
    qbt_z[:n, :k] = qbt
    sa_z = np.zeros(rows_to, np.float32)
    sa_z[:m] = sa[:, 0]
    sb_z = np.zeros(cols_to, np.float32)
    sb_z[:n] = sb[0]
    return qa_z, qbt_z, sa_z, sb_z


def product_sums(qa_lines, qbt_lines):
    """int32 sums of one 64-row product x BN columns, stage by stage: each
    stage's four 32-byte-deep products (m64nBNk32)."""
    acc = np.zeros((64, BN), np.int64)
    for st in range(qa_lines.shape[1] // LINE):
        a = qa_lines[:, st * LINE:(st + 1) * LINE]
        b = qbt_lines[:, st * LINE:(st + 1) * LINE]
        for k in range(LINE // 32):
            acc += a[:, 32 * k:32 * k + 32] @ b[:, 32 * k:32 * k + 32].T
    assert np.abs(acc).max() < 2 ** 31
    return acc.astype(np.int32)


class LoadBarriers:
    """A consumer's two C-load barriers: each load completes a phase, each
    wait names the parity gemm_wgmma.cuh's `phase` bits give it."""

    def __init__(self):
        self.loads = [0, 0]     # phases completed (the copies landed)
        self.waits = [0, 0]     # waits made
        self.phase = 0          # the kernel's bit mask

    def load(self, b):
        assert self.loads[b] == self.waits[b], "a buffer loaded twice"
        self.loads[b] += 1

    def wait(self, b):
        parity = (self.phase >> b) & 1
        self.phase ^= 1 << b
        assert self.loads[b] == self.waits[b] + 1
        assert parity == self.waits[b] & 1
        self.waits[b] += 1


def pingpong_model(qa, sa, qbt, sb, c, blocks=4):
    """C' as rungs 10 and 12 compute it, and the tiles each consumer
    stored: {(m0, n0): (block, cw)}."""
    m, _ = qa.shape
    n = qbt.shape[0]
    num_m, num_n = -(-m // TM), -(-n // BN)
    qa_z, qbt_z, sa_z, sb_z = _padded(qa, sa, qbt, sb, num_m * TM,
                                      num_n * BN)
    out = np.full_like(c, np.nan)       # fresh: every element written once
    stored = {}
    for blk, walk in enumerate(pingpong_walk(m, n, blocks)):
        bars = [LoadBarriers(), LoadBarriers()]   # across each one's tiles
        for j, cw, m0, n0 in walk:
            stored[m0, n0] = (blk, cw)
            bar = bars[cw]
            bar.load(0)                  # C's first two boxes, before the loop
            bar.load(1)
            v = []
            for h in range(MH):          # the dequant, sb staged a pass
                row0 = m0 + 64 * h
                regs = product_sums(qa_z[row0:row0 + 64],
                                    qbt_z[n0:n0 + BN])[ROW, COL]
                s_col = sb_z[n0:n0 + BN].reshape(-1, SB_COLS)[
                    I // (SB_COLS // 2), 8 * (J % (SB_COLS // 8)) + 2 * T + E]
                v.append((regs.astype(np.float32) * sa_z[row0 + ROW])
                         * s_col)
            for i in range(MH * NB):     # flush_load's boxes
                hm, ch = divmod(i, NB)
                bar.wait(i & 1)
                rr, cc = np.meshgrid(np.arange(64), np.arange(OUT_COLS),
                                     indexing="ij")
                gr, gc = m0 + 64 * hm + rr, n0 + OUT_COLS * ch + cc
                live = (gr < m) & (gc < n)
                box = np.zeros(64 * OUT_COLS, np.float32)   # C, zero fill
                box[staging_offset(rr, cc)[live] // 4] = c[gr[live],
                                                           gc[live]]
                mine = J // 4 == ch
                at = staging_offset(ROW[mine], COL[mine] - OUT_COLS * ch) // 4
                assert len(set(at.tolist())) == at.size
                box[at] = v[hm][mine] + box[at]
                assert np.isnan(out[gr[live], gc[live]]).all()
                out[gr[live], gc[live]] = box[staging_offset(rr, cc)[live]
                                              // 4]
                if i + 2 < MH * NB:
                    bar.load(i & 1)
    return out, stored


def _operands(m, n, k, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    b = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    c = rng.uniform(-1, 1, (m, n)).astype(np.float32)
    qa, sa, qbt, sb = (x.numpy() for x in int8.prepare_packed(
        torch.from_numpy(a), torch.from_numpy(b)))
    return qa, sa, qbt, sb, c


def _plain(qa, sa, qbt, sb, c):
    return manual_dma.mmult_q_packed_ref(
        *(torch.from_numpy(x) for x in (qa, sa, qbt, sb, c))).numpy()


# (shape, blocks): the three shapes on 4 blocks (9, 10 and 3 tiles: one
# block takes 3 at 9, two take 3 at 10), the first on the H100's 132 (one
# tile a block, consumer 1 idle), and 3 tiles on every block of 5
MODEL_CASES = [(s, 4) for s in SHAPES] + [(SHAPES[0], H100_SMS),
                                          ((300, 5 * BN, 100), 5)]


@pytest.mark.parametrize("shape,blocks", MODEL_CASES)
def test_pingpong_model_equals_plain_version(shape, blocks):
    qa, sa, qbt, sb, c = _operands(*shape, seed=sum(shape))
    got, stored = pingpong_model(qa, sa, qbt, sb, c, blocks)
    np.testing.assert_array_equal(got, _plain(qa, sa, qbt, sb, c))
    m, n, _ = shape
    assert set(stored) == {(i * TM, j * BN) for i in range(-(-m // TM))
                           for j in range(-(-n // BN))}


@pytest.mark.parametrize("jax_fn", [jdma.mmult_q_packed,
                                    jdma.mmult_q_resident])
def test_pingpong_model_holds_the_jax_kernels(jax_fn):
    """(200, 136, 72) through the JAX rung 10 and 12 kernels in interpret
    mode: EQUAL on unit scales and a zero C, within 1e-6 x max |ref| with
    real ones."""
    qa, sa, qbt, sb, c = _operands(200, 136, 72, 12)
    got, _ = pingpong_model(qa, sa, qbt, sb, c)
    ref = np.asarray(jax_fn(*(jnp.asarray(x) for x in (qa, sa, qbt, sb, c)),
                            interpret=True))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * float(np.abs(ref).max()))
    ones_a, ones_b, zero = np.ones_like(sa), np.ones_like(sb), np.zeros_like(c)
    sums, _ = pingpong_model(qa, ones_a, qbt, ones_b, zero)
    jsums = np.asarray(jax_fn(
        *(jnp.asarray(x) for x in (qa, ones_a, qbt, ones_b, zero)),
        interpret=True))
    np.testing.assert_array_equal(sums, jsums)


@pytest.mark.parametrize("m,n,blocks", [(4096, 4096, H100_SMS),
                                        (2001, 2102, H100_SMS),
                                        (300, 262, 4), (129, 520, 3),
                                        (384, BN * H100_SMS, H100_SMS)])
def test_walk_gives_each_consumer_its_parity_of_the_tiles(m, n, blocks):
    """Every tile once; a block's consumers alternate over its tiles,
    consumer 0 taking one more where the count is odd; each consumer
    starts tile j at the ring use the producer gave its first stage,
    j x stages."""
    walk = pingpong_walk(m, n, blocks)
    tiles = [(m0, n0) for w in walk for _, _, m0, n0 in w]
    assert len(tiles) == len(set(tiles)) == -(-m // TM) * -(-n // BN)
    stages = 9
    for w in walk:
        mine = [[t for t in w if t[1] == cw] for cw in (0, 1)]
        assert len(mine[0]) - len(mine[1]) == len(w) % 2
        q, first = 0, {}
        for j, _, _, _ in w:              # the producer's running count
            first[j] = q
            q += stages
        for cw in (0, 1):
            assert all(first[j] == j * stages for j, _, _, _ in mine[cw])
    if n == BN * H100_SMS:                # three tiles on every block
        assert {len(w) for w in walk} == {3}


class Barrier:
    """An mbarrier: `count` arrivals complete a phase; a wait on parity p
    passes while the current phase's parity differs from p."""

    def __init__(self, count):
        self.count, self.pending, self.done = count, count, 0

    def arrive(self):
        self.pending -= 1
        assert self.pending >= 0
        if self.pending == 0:
            self.done += 1
            self.pending = self.count

    def passes(self, phase, parity=None):
        """A wait for phase ``phase`` (naming parity ``parity``, by default
        phase & 1) passes now; it may not pass before that phase has
        completed."""
        parity = phase & 1 if parity is None else parity
        ok = (self.done & 1) != parity
        assert not ok or self.done > phase, "a wait passed early"
        return ok


def ring_replay(qa, sa, qbt, sb, c, blocks, seed, shared_full=False):
    """Rung 10's ring as events (gemm_wgmma.cuh's producer and its two
    consumer warpgroups, 4 warps each), one block at a time, the actors
    taking turns in an order drawn from ``seed``; returns C'.
    shared_full: both consumers wait on the ring's one full barrier a
    slot, naming the parity of the ring use (the fault)."""
    m, _ = qa.shape
    n = qbt.shape[0]
    num_m, num_n = -(-m // TM), -(-n // BN)
    qa_z, qbt_z, sa_z, sb_z = _padded(qa, sa, qbt, sb, num_m * TM,
                                      num_n * BN)
    stages = qa_z.shape[1] // LINE
    out = np.full_like(c, np.nan)
    rng = np.random.default_rng(seed)
    for walk in pingpong_walk(m, n, blocks):
        full = [[Barrier(1) for _ in range(ST)] for _ in range(2)]
        empty = [Barrier(WARPS) for _ in range(ST)]
        slots = [None] * ST
        released = [WARPS] * ST      # releases of each slot's last use
        owner = [None] * ST          # the consumer of each slot's last use
        total = len(walk) * stages

        def producer():
            for q in range(total):
                j = q // stages
                s = q % ST
                if q >= ST:
                    while not empty[s].passes(q // ST - 1):
                        yield False
                assert released[s] == WARPS, \
                    "a slot refilled before its warpgroup released it"
                _, cw, m0, n0 = walk[j]
                k0 = (q % stages) * LINE
                slots[s] = (q, qa_z[m0:m0 + TM, k0:k0 + LINE],
                            qbt_z[n0:n0 + BN, k0:k0 + LINE])
                released[s], owner[s] = 0, cw
                full[0 if shared_full else cw][s].arrive()  # bytes landed
                yield True

        acc = {}

        def consumer(cw, w):
            def release(s):
                assert owner[s] == cw, "a slot released by the other"
                released[s] += 1
                empty[s].arrive()
            fphase = 0               # bit s: the parity of my next wait
            uses = [0] * ST          # my waits on each of my barriers
            rows = np.concatenate([np.arange(64 * h + 16 * w,
                                             64 * h + 16 * w + 16)
                                   for h in range(MH)])
            mine = [t for t in walk if t[1] == cw]
            for j, _, _, _ in mine:
                q = j * stages
                sums = np.zeros((len(rows), BN), np.int64)
                prev = -1
                for _ in range(stages):
                    s = q % ST
                    if shared_full:
                        while not full[0][s].passes(q // ST):
                            yield False
                    else:
                        parity = (fphase >> s) & 1
                        assert parity == uses[s] & 1
                        while not full[cw][s].passes(uses[s], parity):
                            yield False
                        fphase ^= 1 << s
                        uses[s] += 1
                    tag, a, b = slots[s]
                    assert tag == q
                    sums += a[rows] @ b.T
                    if prev >= 0:    # the stage before's products done
                        release(prev)
                    prev = s
                    q += 1
                    yield True
                release(prev)
                acc[j, w] = (rows, sums)
                yield True

        actors = [producer()] + [consumer(cw, w) for cw in range(2)
                                 for w in range(WARPS)]
        idle = 0                     # steps since an actor last got on
        while actors:
            i = int(rng.integers(len(actors)))
            try:
                idle = 0 if next(actors[i]) else idle + 1
            except StopIteration:
                actors.pop(i)
                idle = 0
            assert idle <= 100 * len(actors), "the ring stalled"
        for j, _, m0, n0 in walk:
            sums = np.zeros((TM, BN), np.int64)
            for w in range(WARPS):
                rows, part = acc[j, w]
                sums[rows] = part
            v = (sums.astype(np.float32) * sa_z[m0:m0 + TM, None]) * sb_z[
                None, n0:n0 + BN]
            rows, cols = min(TM, m - m0), min(BN, n - n0)
            out[m0:m0 + rows, n0:n0 + cols] = (
                v[:rows, :cols] + c[m0:m0 + rows, n0:n0 + cols])
    return out


@pytest.mark.parametrize("blocks", [3, 4])
def test_ring_replay_equals_plain_version(blocks):
    """(129, 520, 1100), 10 tiles of 9 stages over a ring of ST, on 3
    blocks (4, 3 and 3 tiles) and on 4 (3, 3, 2 and 2): no early wait, no
    refill before the one warpgroup's releases, no stall; EQUAL to the
    plain version in every order tried."""
    qa, sa, qbt, sb, c = _operands(129, 520, 1100, 6)
    plain = _plain(qa, sa, qbt, sb, c)
    for seed in range(3):
        got = ring_replay(qa, sa, qbt, sb, c, blocks, seed)
        np.testing.assert_array_equal(got, plain)


def test_one_shared_full_barrier_lets_a_wait_pass_early():
    """Both consumers on one full barrier a slot, the parity taken from the
    ring use: consumer 1's first wait (use 1 of its slot, 9 stages over a
    ring of ST) passes on the slot's phase before last."""
    qa, sa, qbt, sb, c = _operands(129, 520, 1100, 6)
    with pytest.raises(AssertionError, match="early"):
        for seed in range(5):
            ring_replay(qa, sa, qbt, sb, c, 3, seed, shared_full=True)


def prefetch_pieces(nbytes, grid, threads):
    """l2_prefetch_grid: {piece: (block, thread, offset, bytes)}."""
    piece = 16384
    pieces = -(-nbytes // piece)
    got = {}
    for b in range(grid):
        for t in range(threads):
            for i in range(b + grid * t, pieces, grid * threads):
                assert i not in got
                got[i] = (b, t, i * piece, min(piece, nbytes - i * piece))
    return got


def evict_lines(addr, nbytes, grid, threads):
    """l2_evict_normal_grid: {line: (block, thread)} of the 128-byte lines
    from addr rounded down to addr + nbytes."""
    lo = addr & ~127
    lines = (addr + nbytes - lo + 127) // 128
    got = {}
    for b in range(grid):
        for t in range(threads):
            for i in range(b + grid * t, lines, grid * threads):
                assert i not in got
                got[i] = (b, t)
    return lo, lines, got


@pytest.mark.parametrize("m,k,grid", [(4096, 4096, H100_SMS),
                                      (300, 528, 9), (1, 16, 3)])
def test_resident_ranges_cover_each_operand_once(m, k, grid):
    """Rung 12's prefetch (all 384 threads of a block) and evict_normal
    (its 256 consumer threads) over an operand's rows (M x lda bytes, lda
    = K padded to 16): every byte in one piece and in one line, piece and
    line i by block i % grid; the kernel passes those ranges."""
    nbytes = m * k
    pieces = prefetch_pieces(nbytes, grid, 384)
    assert sorted(pieces) == list(range(len(pieces)))
    assert sum(p[3] for p in pieces.values()) == nbytes
    assert all(p[0] == i % grid for i, p in pieces.items())
    for addr in (0, 16, 4096 + 48):      # the operand's base, 16-aligned
        lo, lines, got = evict_lines(addr, nbytes, grid, 256)
        assert sorted(got) == list(range(lines))
        assert lo <= addr and lo + 128 * lines >= addr + nbytes
        assert lo + 128 * (lines - 1) < addr + nbytes
        assert all(b == i % grid for i, (b, _) in got.items())
    body = " ".join(_src(BODY).split())
    assert ("ResidentWalk<P::BN> walk{grid, qa, qbt, static_cast<size_t>(M) "
            "* lda, static_cast<size_t>(N) * ldb};") in body
    assert "l2_prefetch_grid(walk.a, walk.a_bytes, keep);" in body
    assert ("l2_evict_normal_grid(walk.a, walk.a_bytes, tid, "
            "wg::CONSUMERS);") in body


def test_sources_name_the_host_constants():
    """Rungs 10 and 12 are one instance (12 adding RESIDENT), its tile and
    ring are manual_dma's PINGPONG_TILE and PINGPONG_STAGES, its shared
    memory (the body's Layout with consumer 1's full barriers) fits a
    block's 227 KB, and rung 10's parity bits fit a word."""
    fat, res = _src("int8_fat.cu"), _src("int8_resident.cu")
    for key in ("BN", "ST", "CH"):
        assert _const("int8_fat.cu", key) == _const("int8_resident.cu", key)
    for key in ("S8", "LOAD_C", "PINGPONG"):
        assert (_const("int8_fat.cu", key, "bool")
                == _const("int8_resident.cu", key, "bool"))
    assert _const("int8_fat.cu", "PINGPONG", "bool")
    assert "RESIDENT" not in fat
    assert _const("int8_resident.cu", "RESIDENT", "bool")
    assert "launch_pingpong<htog::Rung10>" in fat
    assert "launch_pingpong<htog::Rung12>" in res
    assert manual_dma.PINGPONG_TILE == (TM, BN) == (_const(BODY, "BM"), 128)
    assert manual_dma.PINGPONG_STAGES == ST <= 32
    body = _src(BODY)
    assert "SMEM = BARS + 5 * 8 + wg::ATOM;" in body
    assert "BARS = FULL1 + (PP ? 8 * P::ST : 0);" in body
    smem = manual_dma.pingpong_smem_bytes()
    assert smem == (ST * (TM + BN) * LINE + 2 * 2 * 64 * OUT_COLS * 4
                    + 2 * SB_COLS * 4 + 16 * ST + 8 * ST + 5 * 8 + 1024)
    assert smem <= manual_dma.SMEM_BLOCK
    # one more stage would not fit
    assert manual_dma.pingpong_smem_bytes(stages=ST + 1) > \
        manual_dma.SMEM_BLOCK
