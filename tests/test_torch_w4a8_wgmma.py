"""The W4A8 prefill kernel's data walk (``csrc/w4a8_wgmma.cuh``, kernel
``w4a8_gemm_noc``) modelled on the CPU, against the JAX package's
``pallas_int4.mmult_q_w4a8_noc`` in interpret mode.

The model does what the kernel's threads do, in numpy, vectorised over a
consumer warpgroup's 128 threads: it builds each stage's shared-memory
image of a packed box as the tensor-map copy lays it out (the 128-byte
swizzle), reads each thread's words at the kernel's offsets, decodes the
low and high nibbles with ``w4a8.cuh``'s bit operations, turns each 4 x 4
byte group around with ``__byte_perm``'s selectors, assembles the four
wgmma A fragments, places them by wgmma's A layout, multiplies by the
stage's two QA boxes (K rows past K zero, as the map's fill), sums in
int32 stage by stage, and maps the sums to output columns as the epilogue
stores them: out = (f32(acc) * sa) * sw. The tolerance is none: EQUAL to
the JAX kernel and to the port's plain version, at K = 700, 1,100 and
4,096 (pack blocks straddled, a block's high half past K) and N = 300
(two column tiles, the second ragged).

Beside it, the host-side pieces: the stage count and the persistent walk
over (BT, 256) tiles (``tuned.nt_tile_walk``), with the constants read
from the kernel's source. The kernel, and its choice of token tile, run
only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.ops import pallas_int4 as jint4
from how_to_optimize_gemm_tpu.ops import quant as jquant
from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import int4, tuned

torch.set_num_threads(1)

SOURCE = "w4a8_wgmma.cuh"
H100_SMS = 132
LINE = 128          # bytes of a swizzled line


def _const(name):
    src = (_build.CSRC / SOURCE).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


def stages(k):
    """The kernel's stages(K): pack block b's halves h whose low K rows
    start below K."""
    return sum(1 for st in range(2 * (-(-k // 512)))
               if 512 * (st // 2) + 128 * (st % 2) < k)


# ------------------------------------------------ the threads' operations

def _bytes(w):
    return [(w >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]


def _word(b):
    return (b[0] | (b[1] << np.uint32(8)) | (b[2] << np.uint32(16))
            | (b[3] << np.uint32(24))).astype(np.uint32)


def vsub4(a, b):
    """__vsub4: four byte lanes subtracted modulo 256."""
    return _word([(x - y) & np.uint32(0xFF)
                  for x, y in zip(_bytes(a), _bytes(b))])


def decode_lo4(w):
    return vsub4(w & np.uint32(0x0F0F0F0F), np.uint32(0x08080808))


def decode_hi4(w):
    u = (w >> np.uint32(4)) & np.uint32(0x0F0F0F0F)
    return vsub4(u ^ np.uint32(0x08080808), np.uint32(0x08080808))


def byte_perm(x, y, s):
    """__byte_perm(x, y, s): byte i of the result is byte (s >> 4i) & 7 of
    the eight bytes of y:x."""
    src = _bytes(x) + _bytes(y)
    return _word([src[(s >> (4 * i)) & 7] for i in range(4)])


def transpose4(w):
    """csrc transpose4: rows w[0..3] of four bytes -> columns."""
    lo01 = byte_perm(w[0], w[1], 0x5140)
    lo23 = byte_perm(w[2], w[3], 0x5140)
    hi01 = byte_perm(w[0], w[1], 0x7362)
    hi23 = byte_perm(w[2], w[3], 0x7362)
    return [byte_perm(lo01, lo23, 0x5410), byte_perm(lo01, lo23, 0x7632),
            byte_perm(hi01, hi23, 0x5410), byte_perm(hi01, hi23, 0x7632)]


def swizzled(box):
    """The shared-memory image of a (rows, 128) byte box as a tensor map
    with the 128-byte swizzle writes it: 16-byte chunk c of row r at chunk
    c ^ (r % 8) of the row's line."""
    img = np.zeros(box.size, np.uint8)
    rows = np.arange(box.shape[0])[:, None]
    cols = np.arange(LINE)[None, :]
    img[rows * LINE + (((cols >> 4) ^ (rows & 7)) << 4) + (cols & 15)] = box
    return img


# a consumer warpgroup's 128 threads: warp w, lane 4 g + t
W, G, T = np.meshgrid(np.arange(4), np.arange(8), np.arange(4),
                      indexing="ij")
COL = 4 * (8 * W + G)   # a thread's four columns of its 128


def fragments(img, i):
    """fragments<I>: f[0], f[1] the low nibbles' A fragments of slabs 0
    and 1, f[2], f[3] the high ones; each four registers a thread."""
    lo, hi = [], []
    for grp in range(2):
        words = []
        for j in range(4):
            r = 4 * T + j
            off = r * LINE + ((((COL >> 4) ^ (r & 7)) << 4) | (COL & 15))
            a = (32 * i + 16 * grp) * LINE + off
            words.append(_word([img[a + b].astype(np.uint32)
                                for b in range(4)]))
        lo.append(transpose4([decode_lo4(x) for x in words]))
        hi.append(transpose4([decode_hi4(x) for x in words]))
    f = [None] * 4
    for s in range(2):
        f[s] = [lo[0][2 * s], lo[0][2 * s + 1], lo[1][2 * s],
                lo[1][2 * s + 1]]
        f[2 + s] = [hi[0][2 * s], hi[0][2 * s + 1], hi[1][2 * s],
                    hi[1][2 * s + 1]]
    return f


def a_matrix(frag):
    """A 64 x 32 int8 slab from the warpgroup's fragments by wgmma's A
    layout: register x of thread (w, g, t) holds row 16 w + g + 8 (x % 2),
    K bytes 4 t + 16 (x // 2) .. + 3."""
    a = np.zeros((64, 32), np.int8)
    for x in range(4):
        rows = 16 * W + G + 8 * (x % 2)
        for b, byte in enumerate(_bytes(frag[x])):
            a[rows, 4 * T + 16 * (x // 2) + b] = byte.astype(np.uint8).view(
                np.int8)
    return a


def kernel_model(qa, sa, packed, sw):
    """out as the kernel computes it, stage by stage (int32 sums)."""
    m, k = qa.shape
    n = packed.shape[1]
    tile_n = _const("TILE_N")
    pack_rows = _const("PACK_ROWS")
    n_pad = -(-n // tile_n) * tile_n
    # the maps' zero fill: QA columns past K, packed columns past N and
    # rows past round_up(K, 512) / 2
    rows = -(-k // 512) * 256
    pk = np.zeros((rows + pack_rows, n_pad), np.uint8)
    pk[:rows, :n] = packed[:rows].view(np.uint8)
    q = np.zeros((m, -(-k // 512) * 512 + 512), np.int64)
    q[:, :k] = qa
    acc = np.zeros((m, n_pad), np.int64)
    for tj in range(n_pad // tile_n):
        for cw in range(2):
            c0 = tj * tile_n + 128 * cw
            sums = [np.zeros((64, m), np.int64) for _ in range(2)]
            for st in range(stages(k)):
                k0 = 512 * (st // 2) + 128 * (st % 2)
                prow = 256 * (st // 2) + 128 * (st % 2)
                img = swizzled(pk[prow:prow + pack_rows, c0:c0 + 128])
                for i in range(4):
                    f = fragments(img, i)
                    for s in range(2):
                        for part, kq in ((f[s], k0), (f[2 + s], k0 + 256)):
                            b = q[:, kq + 32 * i:kq + 32 * i + 32]
                            sums[s] += a_matrix(part).astype(np.int64) @ b.T
            # epilogue: slab s row 16 w + g + 8 h is column
            # 4 (8 w + g) + 2 s + h
            for s in range(2):
                for h in range(2):
                    slab_rows = (16 * W + G + 8 * h)[:, :, 0].ravel()
                    cols = (COL[:, :, 0] + 2 * s + h).ravel()
                    acc[:, c0 + cols] = sums[s][slab_rows].T
    assert np.abs(acc).max() < 2 ** 31
    acc32 = acc[:, :n].astype(np.int32)
    return (acc32.astype(np.float32) * sa) * sw


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[1] = 0.0
    x[2] = np.round(rng.uniform(-120, 120, k)) + 0.5
    x[2, 0] = 127.0
    w = rng.standard_normal((k, n)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("k", [700, 1100, 4096])
def test_kernel_model_equals_jax(k):
    m, n = 6, 300
    x, w = _operands(m, k, n, k)
    _, _, jpacked, jsw, _ = jint4.prepare_w4a8(jnp.zeros((1, k)),
                                               jnp.asarray(w))
    jqa, jsa = jquant.quantize_symmetric(jnp.asarray(x), axis=1)
    ref = np.asarray(jint4.mmult_q_w4a8_noc(jqa, jsa, jpacked, jsw,
                                            interpret=True))
    qa, sa, packed, sw, _ = int4.prepare_w4a8(torch.from_numpy(x),
                                              torch.from_numpy(w))
    got = kernel_model(qa.numpy(), sa.numpy(), packed.numpy(), sw.numpy())
    np.testing.assert_array_equal(got, ref)
    plain = int4.mmult_q_w4a8_noc_ref(qa, sa, packed, sw)
    np.testing.assert_array_equal(got, plain.numpy())


def test_decode_and_transpose_bits():
    """Every byte value through both decodes equals the reference's
    nibbles (low: offset binary, high: two's complement), and transpose4
    turns a 4 x 4 group around."""
    b = np.arange(256, dtype=np.uint32)
    words = b | (b[::-1] << np.uint32(8)) | (b << np.uint32(16)) \
        | (np.uint32(0x5A) << np.uint32(24))
    for fn, want in ((decode_lo4, (b & 0xF).astype(np.int64) - 8),
                     (decode_hi4, b.astype(np.uint8).view(np.int8)
                      .astype(np.int64) >> 4)):
        got = _bytes(fn(words))[0].astype(np.uint8).view(np.int8)
        np.testing.assert_array_equal(got, want)
    rows = [_word([np.uint32(16 * r + c) for c in range(4)])
            for r in range(4)]
    cols = transpose4(rows)
    for c in range(4):
        assert [int(x) for x in _bytes(cols[c])] == [16 * r + c
                                                     for r in range(4)]


@pytest.mark.parametrize("k,n", [(1, 1), (40, 1), (129, 2), (256, 2),
                                 (512, 2), (768, 4), (1100, 5), (11008, 44),
                                 (4096, 16)])
def test_stages_pair_both_nibbles(k, n):
    """The stages of a tile cover every K row below K exactly once, low
    and high nibbles of one packed box in one stage; n is the kernel's
    count for K (its stages())."""
    assert stages(k) == n
    seen = []
    for st in range(stages(k)):
        k0 = 512 * (st // 2) + 128 * (st % 2)
        prow = 256 * (st // 2) + 128 * (st % 2)
        for part in (k0, k0 + 256):
            seen += [r for r in range(part, part + 128) if r < k]
        # the packed rows of K rows k0 .. and k0 + 256 .. (w4a8.cuh)
        assert (k0 // 512) * 256 + (k0 % 512) % 256 == prow
        assert ((k0 + 256) // 512) * 256 + ((k0 + 256) % 512) % 256 == prow
    assert sorted(seen) == list(range(k))


def test_kernel_constants_match_the_host():
    """The walk the host describes (tuned.nt_tile_walk's groups of row
    tiles) and the tiles this file models are the kernel's."""
    assert _const("TILE_N") == 256
    assert _const("GROUP_T") == tuned.NT_GROUP_M
    assert _const("PACK_ROWS") == 128
    assert _const("THREADS") == 288   # two consumer warpgroups, a warp


@pytest.mark.parametrize("m,n,bt", [(1024, 11008, 128), (16384, 11008, 128),
                                    (257, 1032, 64), (1, 1, 64)])
def test_w4a8_tile_walk_covers_every_tile_once(m, n, bt):
    tile_n = _const("TILE_N")
    walk = tuned.nt_tile_walk(m, n, H100_SMS, (bt, tile_n))
    tiles = [t for block in walk for t in block]
    expected = {(i * bt, j * tile_n) for i in range(-(-m // bt))
                for j in range(-(-n // tile_n))}
    assert len(tiles) == len(expected) and set(tiles) == expected
    assert max(map(len, walk)) - min(map(len, walk)) <= 1
