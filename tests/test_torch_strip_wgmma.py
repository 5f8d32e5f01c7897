"""Rungs 11 and 17 on K2's int8 wgmma body (``csrc/gemm_wgmma.cuh``:
``int8_strip_nt``, ``int8_hand_pipe_nt``) modelled on the CPU.

Rung 11. The model does what the kernel does, in numpy: clusters of ``CL``
blocks walk 128 x (CL x 256) cluster tiles in groups of row tiles
(``tuned.nt_tile_walk`` on that tile), block rank r taking the 256-column
tile n0 + 256 r; each stage's 128-row A box arrives as ``CL`` slices, rank
r's rows [r 128 / CL, (r + 1) 128 / CL) multicast to every block at byte
offset r x 16 KB / CL, which must land where the whole box's tensor-map
copy would put them under the 128-byte swizzle; the int32 sums are K2's
(``wgmma.m64n256k32``'s accumulator layout, the dequant with sb staged 128
columns a pass); the fresh output goes through the C_LOAD epilogue: C's
boxes of 64 rows x 32 columns (zeros past M and N) into a consumer's two
swizzled buffers, each thread's __fadd_rn of its sums there, the box
stored over out clipped at M and N; a block whose tile lies past N (N's
tiles one past a multiple of CL) stores nothing. The load barriers'
phases are replayed: each wait names the parity of its own load.

Rung 17. Its ring (ST = b_buffers stages; without a_lookahead a `done`
barrier on which both consumer warpgroups arrive after their flush) is
replayed event by event: a producer and eight consumer warps, in orders
drawn from a seed, on mbarriers with the hardware's parity rule (a wait
passes while the barrier's current phase parity differs from the one
named). Every wait must pass only once the phase it names has completed,
no slot may be refilled before all eight warps released its last use, the
replay must not stall, and the sums the warps take from the slots give
an output EQUAL to K2's (b_buffers 4 with lookahead) and the plain
version.

Tolerances: the rung 11 model EQUALS the port's plain version
(``mmult_q_strip_ref``) at (300, 262, 520), (129, 520, 1100), (1, 300, 16)
and at N = 256 (2 CL + 1); the JAX kernel (``pallas_manual_dma.
mmult_q_strip`` in interpret mode) on unit scales and a zero C EQUALS it,
and with real scales and C is within 1e-6 x max |ref| (XLA:CPU contracts
``x * sb + c`` into an FMA; tests/test_torch_int8_wgmma.py). The constants
are read from the kernels' sources. The kernels themselves run only on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.ops import pallas_manual_dma as jdma
from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import (hand_pipeline, int8,
                                               manual_dma, tuned)

torch.set_num_threads(1)

LINE = 128          # bytes of a swizzled line: K bytes a stage
ATOM = 1024         # bytes of 8 swizzled lines
BM, BN = int8.NT_TILE
OUT_COLS = 32       # fp32 columns of a staging box
SB_COLS = 128       # sb's columns staged a pass
SHAPES = [(300, 262, 520), (129, 520, 1100), (1, 300, 16)]
KNOBS = [(nb, la) for nb in hand_pipeline.B_BUFFERS for la in (False, True)]


def _src(name):
    return (_build.CSRC / name).read_text()


def _const(source, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _src(source))[1])


CL = _const("int8_strip_nt.cu", "CL")
# a surplus block: N's 256-column tiles one past a multiple of CL
SURPLUS_N = BN * (2 * CL + 1)

# a consumer's 128 threads and their 128 accumulators (warp w, lane 4 g +
# t; accumulator i = 4 j + 2 h + e at row 16 w + g + 8 h, column
# 8 j + 2 t + e of the consumer's 64 x 256)
W, G, T, I = np.meshgrid(np.arange(4), np.arange(8), np.arange(4),
                         np.arange(128), indexing="ij")
J, H, E = I // 4, (I // 2) % 2, I % 2
ROW = 16 * W + G + 8 * H
COL = 8 * J + 2 * T + E


def swizzled(addr_row, col_chunk):
    """Byte address of 16-byte chunk ``col_chunk`` of the line at byte
    ``addr_row`` (a multiple of 128): the chunk index XORed with the
    line's address bits 7-9, as the tensor-map unit writes and wgmma's
    descriptors read."""
    return addr_row + ((col_chunk ^ ((addr_row >> 7) & 7)) << 4)


def staging_offset(r, col):
    """fp32 column ``col`` of row ``r`` of a staging box (gemm_wgmma.cuh's
    flush_load and flush_tma), its buffer 1,024-byte aligned."""
    return swizzled(r * LINE, col >> 2) + ((col & 3) << 2)


def strip_walk(m, n, clusters, cl=CL):
    """[(cluster, rank, m0, n0)] in each block's order: the cluster tiles of
    ``tuned.nt_tile_walk`` on 128 x (cl x 256), rank r at n0 + 256 r."""
    walk = tuned.nt_tile_walk(m, n, clusters, (BM, cl * BN))
    return [(k, r, m0, n0 + BN * r) for k, tiles in enumerate(walk)
            for m0, n0 in tiles for r in range(cl)]


def a_slices(cl):
    """Rank r's slice of a stage's A box: (its box rows, its byte offset in
    every block's slot)."""
    rows = BM // cl
    return [(range(r * rows, (r + 1) * rows), r * (BM * LINE // cl))
            for r in range(cl)]


def consumer_sums(qa_lines, qbt_lines):
    """int32 sums of one consumer's 64 rows x 256 columns, stage by stage:
    each stage's four 32-byte-deep products (m64n256k32)."""
    acc = np.zeros((64, BN), np.int64)
    for st in range(qa_lines.shape[1] // LINE):
        a = qa_lines[:, st * LINE:(st + 1) * LINE]
        b = qbt_lines[:, st * LINE:(st + 1) * LINE]
        for k in range(LINE // 32):
            acc += a[:, 32 * k:32 * k + 32] @ b[:, 32 * k:32 * k + 32].T
    assert np.abs(acc).max() < 2 ** 31
    return acc.astype(np.int32)


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
        # the wait passes on the phase it names: its own load's
        assert self.loads[b] == self.waits[b] + 1
        assert parity == self.waits[b] & 1
        self.waits[b] += 1


def strip_model(qa, sa, qbt, sb, c, clusters=66, cl=CL):
    """C' as rung 11's kernel computes it, and the tiles each block
    stored: {(m0, n0): (cluster, rank)}."""
    m, _ = qa.shape
    n = qbt.shape[0]
    num_m, num_n = -(-m // BM), -(-n // BN)
    rows_to, cols_to = num_m * BM, -(-num_n // cl) * cl * BN
    qa_z, qbt_z, sa_z, sb_z = _padded(qa, sa, qbt, sb, rows_to, cols_to)
    out = np.full_like(c, np.nan)       # fresh: every element written once
    stored = {}
    bars = {}
    for k, r, m0, n0 in strip_walk(m, n, clusters, cl):
        # the stage's A box as its cl multicast slices put it together
        a_box = np.zeros((BM, qa_z.shape[1]), np.int64)
        for rows, off in a_slices(cl):
            assert off % ATOM == 0
            a_box[off // LINE:off // LINE + len(rows)] = qa_z[m0 + rows.start:
                                                              m0 + rows.stop]
        if n0 >= n:                      # the surplus block: B^T zeros
            assert not qbt_z[n0:n0 + BN].any()
            continue
        stored[m0, n0] = (k, r)
        for cw in range(2):
            bar = bars.setdefault((k, r, cw), LoadBarriers())
            row0 = m0 + 64 * cw
            bar.load(0)                  # C's first two boxes, before the loop
            bar.load(1)
            regs = consumer_sums(a_box[64 * cw:64 * cw + 64],
                                 qbt_z[n0:n0 + BN])[ROW, COL]
            s_col = sb_z[n0:n0 + BN].reshape(-1, SB_COLS)[
                I // (SB_COLS // 2), 8 * (J % (SB_COLS // 8)) + 2 * T + E]
            v = (regs.astype(np.float32) * sa_z[row0 + ROW]) * s_col
            for ch in range(BN // OUT_COLS):
                bar.wait(ch & 1)
                rr, cc = np.meshgrid(np.arange(64), np.arange(OUT_COLS),
                                     indexing="ij")
                gr, gc = row0 + rr, n0 + OUT_COLS * ch + cc
                live = (gr < m) & (gc < n)
                box = np.zeros(64 * OUT_COLS, np.float32)   # C, zero fill
                box[staging_offset(rr, cc)[live] // 4] = c[gr[live],
                                                           gc[live]]
                mine = J // 4 == ch
                at = staging_offset(ROW[mine], COL[mine] - OUT_COLS * ch) // 4
                assert len(set(at.tolist())) == at.size
                box[at] = v[mine] + box[at]
                assert np.isnan(out[gr[live], gc[live]]).all()
                out[gr[live], gc[live]] = box[staging_offset(rr, cc)[live]
                                              // 4]
                if ch + 2 < BN // OUT_COLS:
                    bar.load(ch & 1)
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
    return manual_dma.mmult_q_strip_ref(
        *(torch.from_numpy(x) for x in (qa, sa, qbt, sb, c))).numpy()


@pytest.mark.parametrize("shape", SHAPES + [(200, SURPLUS_N, 200)])
def test_strip_model_equals_plain_version(shape):
    qa, sa, qbt, sb, c = _operands(*shape, seed=sum(shape))
    got, stored = strip_model(qa, sa, qbt, sb, c)
    np.testing.assert_array_equal(got, _plain(qa, sa, qbt, sb, c))
    m, n, _ = shape
    assert set(stored) == {(i * BM, j * BN) for i in range(-(-m // BM))
                           for j in range(-(-n // BN))}


def test_strip_model_holds_the_jax_kernel():
    """(200, 136, 72) through ``pallas_manual_dma.mmult_q_strip`` in
    interpret mode: EQUAL on unit scales and a zero C, within 1e-6 x
    max |ref| with real ones."""
    qa, sa, qbt, sb, c = _operands(200, 136, 72, 11)
    got, _ = strip_model(qa, sa, qbt, sb, c)
    ref = np.asarray(jdma.mmult_q_strip(
        *(jnp.asarray(x) for x in (qa, sa, qbt, sb, c)), interpret=True))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * float(np.abs(ref).max()))
    ones_a, ones_b, zero = np.ones_like(sa), np.ones_like(sb), np.zeros_like(c)
    sums, _ = strip_model(qa, ones_a, qbt, ones_b, zero)
    jsums = np.asarray(jdma.mmult_q_strip(
        *(jnp.asarray(x) for x in (qa, ones_a, qbt, ones_b, zero)),
        interpret=True))
    np.testing.assert_array_equal(sums, jsums)


@pytest.mark.parametrize("m,n,clusters", [(4096, 4096, 66), (2001, 2102, 66),
                                          (200, SURPLUS_N, 3),
                                          (300, 262, 1)])
def test_cluster_walk_covers_every_tile_once(m, n, clusters):
    """Every 128 x 256 tile is computed by exactly one (cluster, rank), the
    rank's tile is n0 + 256 r of its cluster tile, the blocks of a cluster
    walk the same cluster tiles in step, and the surplus blocks (past N)
    appear only where N's tiles are no multiple of CL."""
    walk = strip_walk(m, n, clusters)
    num_m, num_n = -(-m // BM), -(-n // BN)
    live = [(m0, n0) for _, _, m0, n0 in walk if n0 < n]
    assert len(live) == len(set(live)) == num_m * num_n
    for k, r, m0, n0 in walk:
        assert (n0 // BN) % CL == r
    per_rank = {}
    for k, r, m0, n0 in walk:
        per_rank.setdefault((k, r), []).append((m0, n0 - BN * r))
    for (k, r), tiles in per_rank.items():
        assert tiles == per_rank[k, 0]
    surplus = [t for t in walk if t[3] >= n]
    assert len(surplus) == num_m * (-num_n % CL)
    if n == SURPLUS_N:
        assert surplus and {t[1] for t in surplus} == set(range(1, CL))


@pytest.mark.parametrize("cl", [1, 2, 4])
def test_a_slices_cover_each_row_once_on_whole_atoms(cl):
    """Rank r's slice of the A box lands at r x 16 KB / cl: whole 1,024-byte
    swizzle atoms, each row exactly once, each 16-byte chunk where the
    whole box's copy puts it (the swizzle takes address bits 7-9)."""
    seen = []
    for rows, off in a_slices(cl):
        assert off % ATOM == 0 and len(rows) % 8 == 0
        for i, row in enumerate(rows):
            seen.append(row)
            for chunk in range(LINE // 16):
                assert (swizzled(off + i * LINE, chunk)
                        == swizzled(row * LINE, chunk))
    assert sorted(seen) == list(range(BM))
    # a slice of 4 lines (no whole atom) would move the chunks
    assert any(swizzled(LINE * (i + 4), 1) - LINE * 4
               != swizzled(LINE * i, 1) for i in range(8))


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

    def passes(self, phase):
        """A wait for phase ``phase`` (parity phase & 1) passes now; it may
        not pass before that phase has completed."""
        ok = (self.done & 1) != (phase & 1)
        assert not ok or self.done > phase, "a wait passed early"
        return ok


def ring_replay(qa, sa, qbt, sb, c, st, lookahead, blocks, seed):
    """Rung 17's kernel as events (gemm_wgmma.cuh's producer and consumer
    loops at ring depth ``st``), one block at a time, the actors taking
    turns in an order drawn from ``seed`` (each step yields whether it
    got on or waited); returns C'."""
    m, _ = qa.shape
    n = qbt.shape[0]
    num_m, num_n = -(-m // BM), -(-n // BN)
    qa_z, qbt_z, sa_z, sb_z = _padded(qa, sa, qbt, sb, num_m * BM,
                                      num_n * BN)
    stages = qa_z.shape[1] // LINE
    out = c.copy()
    rng = np.random.default_rng(seed)
    for tiles in tuned.nt_tile_walk(m, n, blocks):
        full = [Barrier(1) for _ in range(st)]
        empty = [Barrier(8) for _ in range(st)]
        done = Barrier(2)
        slots = [None] * st
        released = [8] * st          # releases of each slot's last use
        total = len(tiles) * stages

        def producer():
            for q in range(total):
                j, kq = divmod(q, stages)
                s = q % st
                if q >= st:
                    while not empty[s].passes(q // st - 1):
                        yield False
                if not lookahead and kq == 0 and j > 0:
                    while not done.passes(j - 1):
                        yield False
                assert released[s] == 8, "a slot refilled before its releases"
                m0, n0 = tiles[j]
                k0 = kq * LINE
                slots[s] = (q, qa_z[m0:m0 + BM, k0:k0 + LINE],
                            qbt_z[n0:n0 + BN, k0:k0 + LINE])
                released[s] = 0
                full[s].arrive()     # the copies' bytes landed
                yield True

        acc = {}

        def consumer(cw, w):
            def release(s):
                released[s] += 1
                empty[s].arrive()
            q = 0
            rows = slice(64 * cw + 16 * w, 64 * cw + 16 * w + 16)
            for j in range(len(tiles)):
                sums = np.zeros((16, BN), np.int64)
                prev = -1
                for _ in range(stages):
                    s = q % st
                    while not full[s].passes(q // st):
                        yield False
                    tag, a, b = slots[s]
                    assert tag == q
                    sums += a[rows] @ b.T
                    if prev >= 0:     # the stage before's products done
                        release(prev)
                    prev = s
                    q += 1
                    yield True
                release(prev)
                acc[j, cw, w] = sums
                if not lookahead and w == 0:   # the warpgroup's flush issued
                    done.arrive()
                yield True

        actors = [producer()] + [consumer(cw, w) for cw in range(2)
                                 for w in range(4)]
        idle = 0                     # steps since an actor last got on
        while actors:
            i = int(rng.integers(len(actors)))
            try:
                idle = 0 if next(actors[i]) else idle + 1
            except StopIteration:
                actors.pop(i)
                idle = 0
            assert idle <= 100 * len(actors), "the ring stalled"
        for j, (m0, n0) in enumerate(tiles):
            sums = np.concatenate([acc[j, cw, w] for cw in range(2)
                                   for w in range(4)])
            v = (sums.astype(np.float32) * sa_z[m0:m0 + BM, None]) * sb_z[
                None, n0:n0 + BN]
            rows, cols = min(BM, m - m0), min(BN, n - n0)
            out[m0:m0 + rows, n0:n0 + cols] = (
                out[m0:m0 + rows, n0:n0 + cols] + v[:rows, :cols])
    return out


@pytest.mark.parametrize("st,lookahead", KNOBS)
def test_ring_replay_equals_k2(st, lookahead):
    """Each knob's ring on 3 blocks (2 tiles each at (300, 262, 520), whose
    K takes 5 stages): no early wait, no refill before its releases, no
    stall; the output EQUALS K2's ring (4 stages, lookahead) and the plain
    version, in every order tried."""
    qa, sa, qbt, sb, c = _operands(300, 262, 520, 5)
    k2 = ring_replay(qa, sa, qbt, sb, c, 4, True, blocks=3, seed=0)
    plain = int8.mmult_q_bt_ref(*(torch.from_numpy(x) for x in
                                  (qa, sa, qbt, sb, c))).numpy()
    np.testing.assert_array_equal(k2, plain)
    for seed in range(3):
        got = ring_replay(qa, sa, qbt, sb, c, st, lookahead, blocks=3,
                          seed=seed)
        np.testing.assert_array_equal(got, k2)


def test_sources_name_the_host_constants():
    """rung 11's CL is manual_dma.CLUSTER; rung 17's instances are the six
    knobs (b_buffers = ST); the body's shared memory at four stages (the
    deepest ring) fits a block's 227 KB with the C-load barriers; K2 and
    rung 11 take the same tile and ring."""
    assert CL == manual_dma.CLUSTER > 1
    pipe = _src("int8_hand_pipe.cu")
    built = {(int(nb), la == "true") for nb, la in
             re.findall(r"launch_knobs<(\d), (true|false)>;", pipe)}
    assert built == set(KNOBS)
    assert "static constexpr int ST = NB;" in pipe
    assert "static constexpr bool LOOKAHEAD = LA;" in pipe
    body = _src("gemm_wgmma.cuh")
    bars = int(re.search(r"SMEM = BARS \+ (\d+) \* 8 \+ wg::ATOM;", body)[1])
    stage = (BM + BN) * LINE
    out_bytes = 2 * 2 * 64 * OUT_COLS * 4
    for st in hand_pipeline.B_BUFFERS + (_const("int8_strip_nt.cu", "ST"),):
        smem = (st * stage + out_bytes + 2 * SB_COLS * 4 + 16 * st
                + 8 * bars + ATOM)
        assert smem <= 232448, (st, smem)
    assert _const("int8_strip_nt.cu", "BN") == _const("int8_gemm_nt.cu",
                                                      "BN") == BN
    assert "LOAD_C = true;" in _src("int8_strip_nt.cu")
