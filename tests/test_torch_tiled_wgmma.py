"""Rung 13 on rung 12's int8 wgmma ping-pong, fed by 1-D bulk copies of
pretiled stage images (``csrc/gemm_wgmma.cuh``'s TILED instance:
``int8_pretile`` then ``int8_tiled_resident_nt``), modelled on the CPU.

The image. ``pretile_ref`` lays an int8 (rows, K) out as (tiles, nk, 128,
128): image (t, kq) is the 16 KB that a tensor-map copy of the box at
(K byte kq x 128, row t x 128) of 128 rows x 128 bytes lands in shared
memory under the 128-byte swizzle (``kmajor_map_s8``, box_rows 128), zeros
past the rows and K. The model of that box here is the swizzle's address
rule (bits 4-6 of a byte's offset XOR bits 7-9), written independently of
``pretile_ref``'s chunk permutation.

The producer. For tile (m0, n0) and stage kq it copies A's image at byte
((m0 / 128) x nk + kq) x 16,384 and B^T's at ((n0 / 128) x nk + kq) x
16,384, one 1-D bulk copy each, into the stage's A and B planes; the
consumers read the planes through K-major descriptors under the same
swizzle, so un-swizzling a stage as they read it gives back the operands'
128 x 128 boxes. The walk's ranges are the images: rung 12's prefetch (16
KB pieces, piece i by block i % grid) and evict_normal pass (128-byte
lines) cover them once.

The output. The model computes what the kernel computes, in numpy: each
consumer's tiles of the ping-pong walk (tile j of a block to consumer j %
2), the int32 sums of m64n128k32 products read from the un-swizzled
stages, K2's dequant (float(acc) * sa) * sb, rounded each, then one add
of C. It EQUALS the plain version (``mmult_q_tiled_resident_ref``) at
(300, 262, 520), (129, 520, 1100), (1, 300, 16) and on a walk that leaves
every block an odd tile count; the JAX kernel
(``pallas_manual_dma.mmult_q_tiled_resident`` in interpret mode) EQUALS it
on unit scales and a zero C and is within 1e-6 x max |ref| with real
scales and C (XLA:CPU contracts ``x * sb + c`` into an FMA, as in
tests/test_torch_int8_wgmma.py). The C staging and the ring are rung 12's,
modelled in tests/test_torch_pingpong_wgmma.py. The constants are read
from the kernels' sources; the kernels themselves run only on the card
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

BODY = "gemm_wgmma.cuh"
RES = "int8_resident.cu"
H100_SMS = 132


def _src(name):
    return (_build.CSRC / name).read_text()


def _const(source, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _src(source))[1])


TM = _const(BODY, "BM")          # rows a tile and an A plane
BN = _const(RES, "BN")           # columns a tile and a B^T plane
LINE = 128                       # bytes a row of a stage: K bytes a stage
IMAGE = TM * LINE                # bytes an image: one bulk copy
SHAPES = [(300, 262, 520), (129, 520, 1100), (1, 300, 16)]


def swz(offset):
    """The 128-byte swizzle of a byte offset in a 1,024-byte aligned plane:
    bits 4-6 XOR bits 7-9."""
    return offset ^ (((offset >> 7) & 7) << 4)


def tma_box(x, k0, row0, rows=TM):
    """The bytes a tensor-map copy of x's box of ``rows`` rows x LINE bytes
    at (k0, row0) lands in shared memory: element (r, b) at swz(r LINE +
    b), zeros past x's rows and columns."""
    box = np.zeros(rows * LINE, np.int8)
    r, b = np.meshgrid(np.arange(rows), np.arange(LINE), indexing="ij")
    gr, gk = row0 + r, k0 + b
    live = (gr < x.shape[0]) & (gk < x.shape[1])
    box[swz(r * LINE + b)[live]] = x[gr[live], gk[live]]
    return box


def unswizzle(plane, rows=TM):
    """A stage plane as the consumers' K-major descriptors read it: product
    h's 64 rows from plane + 64 h LINE, K step k's 32 bytes from + 32 k, the
    hardware's swizzle on each byte's address; (rows, LINE) values."""
    out = np.zeros((rows, LINE), np.int64)
    for h in range(rows // 64):
        for k in range(LINE // 32):
            r, e = np.meshgrid(np.arange(64), np.arange(32), indexing="ij")
            start = 64 * h * LINE + 32 * k
            out[64 * h + r, 32 * k + e] = plane[swz(start + r * LINE + e)]
    return out


def _image_flat(x):
    return manual_dma.pretile_ref(torch.from_numpy(x)).numpy().reshape(-1)


@pytest.mark.parametrize("rows,k", [(200, 72), (128, 128), (1, 16),
                                    (300, 1100), (0, 32)])
def test_pretile_is_the_tensor_map_box(rows, k):
    """Image (t, kq) is, byte for byte, the box the tensor-map copy lands
    at (kq x 128, t x 128), zero fill included."""
    rng = np.random.default_rng(rows * 7 + k)
    x = rng.integers(-127, 128, (rows, k)).astype(np.int8)
    img = manual_dma.pretile_ref(torch.from_numpy(x)).numpy()
    tiles, nk = -(-rows // TM), -(-k // LINE)
    assert img.shape == (tiles, nk, TM, LINE)
    for t in range(tiles):
        for kq in range(nk):
            np.testing.assert_array_equal(img[t, kq].reshape(-1),
                                          tma_box(x, kq * LINE, t * TM))


def producer_offsets(m0, n0, kq, nk):
    """The byte offsets of tile (m0, n0)'s stage kq in the A and B^T
    images, as the TILED producer computes them."""
    return (((m0 // TM) * nk + kq) * IMAGE, ((n0 // BN) * nk + kq) * IMAGE)


@pytest.mark.parametrize("m,n,k", [(300, 262, 520), (129, 520, 1100),
                                   (1, 300, 16)])
def test_producer_offsets_give_each_stage_its_box(m, n, k):
    """Every (tile, stage) copy of 16,384 bytes from the producer's offset
    is that tile's box of the operand; un-swizzled as the consumers read
    it, the operand's rows and K bytes (zeros past them)."""
    rng = np.random.default_rng(m + n + k)
    qa = rng.integers(-127, 128, (m, k)).astype(np.int8)
    qbt = rng.integers(-127, 128, (n, k)).astype(np.int8)
    ia, ib = _image_flat(qa), _image_flat(qbt)
    nk = -(-k // LINE)
    assert ia.size == -(-m // TM) * nk * IMAGE
    assert ib.size == -(-n // BN) * nk * IMAGE
    pad_a = np.zeros((-(-m // TM) * TM, nk * LINE), np.int64)
    pad_a[:m, :k] = qa
    pad_b = np.zeros((-(-n // BN) * BN, nk * LINE), np.int64)
    pad_b[:n, :k] = qbt
    for m0 in range(0, m, TM):
        for n0 in range(0, n, BN):
            for kq in range(nk):
                oa, ob = producer_offsets(m0, n0, kq, nk)
                a, b = ia[oa:oa + IMAGE], ib[ob:ob + IMAGE]
                np.testing.assert_array_equal(a, tma_box(qa, kq * LINE, m0))
                np.testing.assert_array_equal(b, tma_box(qbt, kq * LINE, n0))
                ks = slice(kq * LINE, (kq + 1) * LINE)
                np.testing.assert_array_equal(unswizzle(a),
                                              pad_a[m0:m0 + TM, ks])
                np.testing.assert_array_equal(unswizzle(b, BN),
                                              pad_b[n0:n0 + BN, ks])


def tiled_model(qa, sa, qbt, sb, c, blocks=4):
    """C' as rung 13 computes it, and the tiles each consumer stored:
    {(m0, n0): (block, cw)}."""
    m, k = qa.shape
    n = qbt.shape[0]
    nk = -(-k // LINE)
    ia, ib = _image_flat(qa), _image_flat(qbt)
    sa_z = np.zeros(-(-m // TM) * TM, np.float32)
    sa_z[:m] = sa[:, 0]
    sb_z = np.zeros(-(-n // BN) * BN, np.float32)
    sb_z[:n] = sb[0]
    out = np.full_like(c, np.nan)
    stored = {}
    for blk, tiles in enumerate(tuned.nt_tile_walk(m, n, blocks, (TM, BN))):
        for j, (m0, n0) in enumerate(tiles):
            stored[m0, n0] = (blk, j % 2)
            acc = np.zeros((TM, BN), np.int64)
            for kq in range(nk):
                oa, ob = producer_offsets(m0, n0, kq, nk)
                a = unswizzle(ia[oa:oa + IMAGE])
                b = unswizzle(ib[ob:ob + IMAGE], BN)
                for h in range(TM // 64):       # the two m64n128 products
                    for step in range(LINE // 32):
                        ks = slice(32 * step, 32 * step + 32)
                        acc[64 * h:64 * h + 64] += (a[64 * h:64 * h + 64, ks]
                                                    @ b[:, ks].T)
            assert np.abs(acc).max() < 2 ** 31
            v = (acc.astype(np.int32).astype(np.float32)
                 * sa_z[m0:m0 + TM, None]) * sb_z[None, n0:n0 + BN]
            rows, cols = min(TM, m - m0), min(BN, n - n0)
            assert np.isnan(out[m0:m0 + rows, n0:n0 + cols]).all()
            out[m0:m0 + rows, n0:n0 + cols] = (
                v[:rows, :cols] + c[m0:m0 + rows, n0:n0 + cols])
    return out, stored


def _operands(m, n, k, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    b = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    c = rng.uniform(-1, 1, (m, n)).astype(np.float32)
    qa, sa, qbt, sb = (x.numpy() for x in int8.prepare_packed(
        torch.from_numpy(a), torch.from_numpy(b)))
    return qa, sa, qbt, sb, c


# the three shapes on 4 blocks, and 15 tiles on 5 blocks: 3 each, so each
# block's consumer 0 takes two and consumer 1 one
MODEL_CASES = [(s, 4) for s in SHAPES] + [((300, 5 * BN, 100), 5)]


@pytest.mark.parametrize("shape,blocks", MODEL_CASES)
def test_tiled_model_equals_plain_version(shape, blocks):
    qa, sa, qbt, sb, c = _operands(*shape, seed=sum(shape) + 1)
    got, stored = tiled_model(qa, sa, qbt, sb, c, blocks)
    ref = manual_dma.mmult_q_tiled_resident_ref(
        *(torch.from_numpy(x) for x in (qa, sa, qbt, sb, c))).numpy()
    np.testing.assert_array_equal(got, ref)
    m, n, _ = shape
    assert set(stored) == {(i * TM, j * BN) for i in range(-(-m // TM))
                           for j in range(-(-n // BN))}
    if blocks == 5:
        walk = tuned.nt_tile_walk(m, n, blocks, (TM, BN))
        assert {len(w) for w in walk} == {3}


def test_tiled_model_holds_the_jax_kernel():
    """(200, 136, 72) through the JAX rung 13 kernel in interpret mode:
    EQUAL on unit scales and a zero C, within 1e-6 x max |ref| with real
    ones."""
    qa, sa, qbt, sb, c = _operands(200, 136, 72, 13)
    got, _ = tiled_model(qa, sa, qbt, sb, c)
    ref = np.asarray(jdma.mmult_q_tiled_resident(
        *(jnp.asarray(x) for x in (qa, sa, qbt, sb, c)), interpret=True))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * float(np.abs(ref).max()))
    ones_a, ones_b, zero = np.ones_like(sa), np.ones_like(sb), np.zeros_like(c)
    sums, _ = tiled_model(qa, ones_a, qbt, ones_b, zero)
    jsums = np.asarray(jdma.mmult_q_tiled_resident(
        *(jnp.asarray(x) for x in (qa, ones_a, qbt, ones_b, zero)),
        interpret=True))
    np.testing.assert_array_equal(sums, jsums)


def ranges_once(nbytes, grid, threads, unit):
    """{unit i: block} for l2_prefetch_grid's 16 KB pieces (unit 16,384)
    or l2_evict_normal_grid's lines (128) of [0, nbytes): unit i taken by
    block i % grid, thread (i // grid) % threads; each once."""
    units = -(-nbytes // unit)
    got = {}
    for b in range(grid):
        for t in range(threads):
            for i in range(b + grid * t, units, grid * threads):
                assert i not in got
                got[i] = b
    return units, got


@pytest.mark.parametrize("m,n,k,grid", [(4096, 4096, 4096, H100_SMS),
                                        (300, 262, 520, 9), (1, 1, 16, 3)])
def test_resident_ranges_cover_the_images_once(m, n, k, grid):
    """The walk's ranges are the images: ceil(M / 128) x nk x 16,384 and
    ceil(N / 128) x nk x 16,384 bytes; the prefetch (384 threads a block)
    and the evict_normal pass (256 consumer threads) take every piece and
    line of each once, block i % grid the i-th; no byte the stages do not
    read."""
    nk = -(-k // LINE)
    for rows in (m, n):
        nbytes = -(-rows // TM) * nk * IMAGE
        assert nbytes == manual_dma.pretile_ref(
            torch.zeros((rows, k), dtype=torch.int8)).numel()
        for threads, unit in ((384, 16384), (256, 128)):
            units, got = ranges_once(nbytes, grid, threads, unit)
            assert sorted(got) == list(range(units))
            assert all(b == i % grid for i, b in got.items())
            assert units * unit == nbytes      # whole pieces and lines
    assert manual_dma.resident_bytes(m, n, k, tiled=True) == (
        (-(-m // TM) + -(-n // BN)) * nk * IMAGE)


def test_sources_name_the_tiled_instance():
    """Rung 13 is rung 12's instance plus TILED; the producer's offsets and
    the walk's ranges are the ones modelled here; the launch builds no
    tensor map of the images, and the repack writes the images'
    (tiles, nk, 128, 128) words, 8 a line."""
    res = _src(RES)
    assert "struct Rung13 : Rung12 {\n  static constexpr bool TILED = true;" \
        in res
    assert "launch_tiled<htog::Rung13>" in res
    assert "launch_fat" not in res
    body = " ".join(_src(BODY).split())
    assert ("(static_cast<size_t>(m0 / BM) * stages + kq) * A_BYTES;"
            in body)
    assert ("(static_cast<size_t>(n0 / BN) * stages + kq) * L::B_BYTES;"
            in body)
    assert "bulk_g2s_l2(st, ia, A_BYTES, full, keep);" in body
    assert "bulk_g2s_l2(st + L::B, ib, L::B_BYTES, full, keep);" in body
    assert ("ResidentWalk<P::BN> walk{{tiles_m, tiles_n}, at, bt, tiles_m "
            "* nk * A_BYTES, tiles_n * nk * Layout<P>::B_BYTES};") in body
    assert "static_assert(!TILED || RES," in body
    assert _const(BODY, "BM") * LINE == IMAGE == 16384
    assert "const size_t words = static_cast<size_t>(tiles) * nk * BM * 8;" \
        in " ".join(res.split())
    assert manual_dma.PINGPONG_TILE == (TM, BN)
    # the fat kernel serves rung 09 alone
    dma = _src("manual_dma.cuh")
    assert "FEED_TILED" not in dma and "kNT" not in dma
    assert "launch_fat<256>" in _src("int8_fat.cu")
