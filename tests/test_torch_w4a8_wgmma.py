"""The int8 prefill kernels' data walk (``csrc/w4a8_wgmma.cuh``, kernels
``w4a8_gemm_noc``, ``w4a8_gemm`` (K3, rung 07b) and ``int8_gemm_noc``)
modelled on the CPU, against the JAX package's ``pallas_int4.mmult_q_w4a8_noc``,
``pallas_int4.mmult_q_w4a8`` and ``pallas_int8.mmult_q_noc`` in interpret
mode.

The model does what the kernel's threads do, in numpy, vectorised over a
consumer warpgroup's 128 threads: it builds each stage's shared-memory
image of a weight box as the tensor-map copy lays it out (the 128-byte
swizzle), reads each thread's words at the kernel's offsets, for packed
weights decodes the low and high nibbles with ``w4a8.cuh``'s bit
operations, turns each 4 x 4 byte group around with ``__byte_perm``'s
selectors, assembles the wgmma A fragments, places them by wgmma's A
layout, multiplies by the stage's QA boxes (K rows past K zero, as the
map's fill), sums in int32 stage by stage, and maps the sums to output
columns as the epilogue stores them: out = (f32(acc) * sa) * sw, + C for
K3. Packed weights pair a box's low and high nibbles in a stage; plain
int8 weights (K, N) take one or two boxes of 128 K rows a stage (the
kernel's BOXES, and the other choice). The tolerance is none: EQUAL to
the JAX kernels and to the port's plain versions, at K = 700, 1,100 and
4,096 (pack blocks straddled, a block's high half past K, partial boxes)
and N = 300 (two column tiles, the second ragged).

Beside it, the host-side pieces: the stage counts and the persistent walk
over (BT, 256) tiles (``tuned.nt_tile_walk``), with the constants read
from the kernels' sources. The kernels, and their choice of token tile,
run only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import re
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.ops import pallas_int4 as jint4
from how_to_optimize_gemm_tpu.ops import pallas_int8 as jint8
from how_to_optimize_gemm_tpu.ops import quant as jquant
from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import int4, int8, tuned

torch.set_num_threads(1)

SOURCE = "w4a8_wgmma.cuh"
H100_SMS = 132
LINE = 128          # bytes of a swizzled line


def _const(name, source=SOURCE):
    src = (_build.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


def stages(k):
    """The kernel's stages(K): pack block b's halves h whose low K rows
    start below K."""
    return sum(1 for st in range(2 * (-(-k // 512)))
               if 512 * (st // 2) + 128 * (st % 2) < k)


def s8_stages(k, boxes):
    """PlainS8<boxes>::nst(K): stages of 128 x boxes K rows."""
    return -(-k // (128 * boxes))


def s8_rows(st, boxes):
    """The K rows of stage st's boxes b (QA's columns and W's rows):
    PlainS8's qa_k(st, b) = w_row(st, b)."""
    return [128 * (boxes * st + b) for b in range(boxes)]


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


def fragments(img, i, decode=True):
    """fragments<Src, I> for one weight box: with decode (packed weights)
    f[0], f[1] the low nibbles' A fragments of slabs 0 and 1, f[2], f[3]
    the high ones; without (int8 weights) f[0], f[1] the box's bytes as
    they lie; each four registers a thread."""
    groups = []
    for grp in range(2):
        words = []
        for j in range(4):
            r = 4 * T + j
            off = r * LINE + ((((COL >> 4) ^ (r & 7)) << 4) | (COL & 15))
            a = (32 * i + 16 * grp) * LINE + off
            words.append(_word([img[a + b].astype(np.uint32)
                                for b in range(4)]))
        groups.append(words)
    parts = ([[decode_lo4(x) for x in w] for w in groups],
             [[decode_hi4(x) for x in w] for w in groups]) if decode else (
        groups,)
    f = []
    for part in parts:
        g = [transpose4(w) for w in part]
        # slab_fragments: column 2 s + h is slab s's row g + 8 h
        f += [[g[0][2 * s], g[0][2 * s + 1], g[1][2 * s], g[1][2 * s + 1]]
              for s in range(2)]
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


def kernel_model(qa, sa, w, sw, boxes=None):
    """out as the kernel computes it without C: its int32 sums
    (kernel_sums), then (f32(acc) * sa) * sw."""
    return (kernel_sums(qa, w, boxes).astype(np.float32) * sa) * sw


def kernel_sums(qa, w, boxes=None):
    """The kernel's int32 sums, stage by stage, mapped to output columns
    as the epilogue stores them: w the packed int4 weights (boxes None) or
    a plain (K, N) int8 matrix read in stages of ``boxes`` boxes of 128 K
    rows. The operands as the wrappers pass them (K padded to 16 with
    zeros)."""
    m, k = qa.shape
    n = w.shape[1]
    tile_n = _const("TILE_N")
    pack_rows = _const("PACK_ROWS")
    n_pad = -(-n // tile_n) * tile_n
    # the maps' zero fill: QA columns past K, weight columns past N and
    # rows past the map's extent (round_up(K, 512) / 2 packed rows, or K)
    rows = -(-k // 512) * 256 if boxes is None else k
    pk = np.zeros((-(-k // 512) * 512 + 512, n_pad), np.uint8)
    pk[:rows, :n] = w[:rows].view(np.uint8)
    q = np.zeros((m, -(-k // 512) * 512 + 512), np.int64)
    q[:, :k] = qa
    if boxes is None:
        plan = [([512 * (st // 2) + 128 * (st % 2) + 256 * b
                  for b in range(2)],
                 [256 * (st // 2) + 128 * (st % 2)])
                for st in range(stages(k))]
    else:
        plan = [(s8_rows(st, boxes), s8_rows(st, boxes))
                for st in range(s8_stages(k, boxes))]
    acc = np.zeros((m, n_pad), np.int64)
    for tj in range(n_pad // tile_n):
        for cw in range(2):
            c0 = tj * tile_n + 128 * cw
            sums = [np.zeros((64, m), np.int64) for _ in range(2)]
            for qa_k, w_rows in plan:
                imgs = [swizzled(pk[r:r + pack_rows, c0:c0 + 128])
                        for r in w_rows]
                for i in range(4):
                    f = sum((fragments(img, i, boxes is None)
                             for img in imgs), [])
                    for b, kq in enumerate(qa_k):
                        bq = q[:, kq + 32 * i:kq + 32 * i + 32]
                        for s in range(2):
                            sums[s] += a_matrix(f[2 * b + s]).astype(
                                np.int64) @ bq.T
            # epilogue: slab s row 16 w + g + 8 h is column
            # 4 (8 w + g) + 2 s + h
            for s in range(2):
                for h in range(2):
                    slab_rows = (16 * W + G + 8 * h)[:, :, 0].ravel()
                    cols = (COL[:, :, 0] + 2 * s + h).ravel()
                    acc[:, c0 + cols] = sums[s][slab_rows].T
    assert np.abs(acc).max() < 2 ** 31
    return acc[:, :n].astype(np.int32)


def epilogue_add(acc32, sa, sw, c, contract=False):
    """The "+ C" epilogue: (f32(acc) * sa) * sw + c, each op rounded (the
    kernel's and the plain version's order), or with the last two
    contracted into one fused multiply-add, fma(f32(acc) * sa, sw, c),
    rounded once: what XLA:CPU makes of the JAX kernel's epilogue."""
    p = acc32.astype(np.float32) * sa
    if not contract:
        return p * sw + c
    out = np.empty(p.shape, np.float32)
    for idx in np.ndindex(p.shape):
        out[idx] = f32_round(Fraction(float(p[idx])) * Fraction(
            float(sw[0, idx[1]])) + Fraction(float(c[idx])))
    return out


def f32_round(x):
    """The float32 nearest to the rational x, ties to even."""
    if x == 0:
        return np.float32(0.0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    scale = Fraction(2) ** (max(e, -126) - 23)
    q, r = divmod(x / scale, 1)
    q = int(q)
    if r > Fraction(1, 2) or (r == Fraction(1, 2) and q % 2):
        q += 1
    return np.float32(sign * float(q * scale))


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


@pytest.mark.parametrize("k", [700, 1100, 4096])
def test_kernel_model_with_c_equals_jax(k):
    """K3: the packed walk with the "+ C" epilogue against the JAX rung
    07b kernel, which adds C in place in its own epilogue. The sums are
    the kernel's; XLA:CPU contracts the JAX epilogue's last multiply and
    its add into one fused multiply-add, so the model's sums under that
    rounding give JAX's bits, and under the kernel's (each op rounded)
    the port's plain version's."""
    m, n = 6, 300
    x, w = _operands(m, k, n, k + 1)
    c = np.random.default_rng(k).uniform(-1, 1, (m, n)).astype(np.float32)
    _, _, jpacked, jsw, _ = jint4.prepare_w4a8(jnp.zeros((1, k)),
                                               jnp.asarray(w))
    jqa, jsa = jquant.quantize_symmetric(jnp.asarray(x), axis=1)
    ref = np.asarray(jint4.mmult_q_w4a8(jqa, jsa, jpacked, jsw,
                                        jnp.asarray(c), interpret=True))
    qa, sa, packed, sw, _ = int4.prepare_w4a8(torch.from_numpy(x),
                                              torch.from_numpy(w))
    sums = kernel_sums(qa.numpy(), packed.numpy())
    got = epilogue_add(sums, sa.numpy(), sw.numpy(), c)
    plain = int4.mmult_q_w4a8_ref(qa, sa, packed, sw, torch.from_numpy(c))
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(
        epilogue_add(sums, sa.numpy(), sw.numpy(), c, contract=True), ref)


def test_c_staging_is_the_maps_swizzle():
    """K3's "+ C" epilogue on the tensor-map unit: a consumer warp's
    threads (g, t) write token r = 8 jj + 2 t + e of a pass, columns
    4 g .. 4 g + 3 of the warp's 32, as one float4 at 16-byte chunk
    g ^ (r % 8) of line r; the image is the (OUT_TOKENS, 32) fp32 box as
    the map's 128-byte swizzle reads it, every element written once."""
    tokens = _const("OUT_TOKENS")
    box = np.arange(tokens * 32, dtype=np.float32).reshape(tokens, 32)
    img = np.full(tokens * LINE, 0xFF, np.uint8)
    hits = np.zeros(tokens * LINE, np.int64)
    for g in range(8):
        for t in range(4):
            for jj in range(tokens // 8):
                for e in range(2):
                    r = 8 * jj + 2 * t + e
                    at = r * LINE + ((g ^ (r & 7)) << 4)
                    img[at:at + 16] = box[r, 4 * g:4 * g + 4].view(np.uint8)
                    hits[at:at + 16] += 1
    assert (hits == 1).all()
    np.testing.assert_array_equal(img, swizzled(box.view(np.uint8)))


def _wrapper_operands(qa, qb):
    """QA and QB as int8.mmult_q_noc hands them to the kernel: K padded to
    a multiple of 16 with zeros (QB's rows too) and QB's columns."""
    qa = torch.nn.functional.pad(qa, (0, -qa.shape[1] % int8.ALIGN))
    qb = torch.nn.functional.pad(qb, (0, -qb.shape[1] % int8.ALIGN,
                                      0, -qb.shape[0] % int8.ALIGN))
    return qa.numpy(), qb.numpy()


@pytest.mark.parametrize("boxes", [1, 2])
@pytest.mark.parametrize("k", [700, 1100, 4096])
def test_int8_kernel_model_equals_jax(k, boxes):
    """int8_gemm_noc: the plain int8 walk, one and two boxes of 128 K a
    stage, against the JAX package's mmult_q_noc."""
    m, n = 6, 300
    x, w = _operands(m, k, n, k + 2)
    jqa, jsa, jqb, jsb = jint8.prepare(jnp.asarray(x), jnp.asarray(w))
    ref = np.asarray(jint8.mmult_q_noc(jqa, jsa, jqb, jsb, interpret=True))
    qa, sa, qb, sb = int8.prepare(torch.from_numpy(x), torch.from_numpy(w))
    pqa, pqb = _wrapper_operands(qa, qb)
    got = kernel_model(pqa, sa.numpy(), pqb[:, :n], sb.numpy(), boxes=boxes)
    np.testing.assert_array_equal(got, ref)
    plain = int8.mmult_q_noc_ref(qa, sa, qb, sb)
    np.testing.assert_array_equal(got, plain.numpy())


@pytest.mark.parametrize("i", range(4))
def test_int8_fragments_hold_the_box_k_major(i):
    """The plain path's pieces on a box of known bytes: the swizzled image,
    each thread's word offsets, transpose4 and the slab fragments put box
    row 32 i + kk, column 4 (8 w + g) + 2 s + h at wgmma A's row
    16 w + g + 8 h, K byte kk of slab s (int8, turned K-major)."""
    rng = np.random.default_rng(i)
    box = rng.integers(-128, 128, (128, 128)).astype(np.int8)
    f = fragments(swizzled(box.view(np.uint8)), i, decode=False)
    assert len(f) == 2
    for s in range(2):
        a = a_matrix(f[s])
        for w in range(4):
            for g in range(8):
                for h in range(2):
                    col = 4 * (8 * w + g) + 2 * s + h
                    np.testing.assert_array_equal(
                        a[16 * w + g + 8 * h], box[32 * i:32 * i + 32, col])


@pytest.mark.parametrize("boxes", [1, 2])
@pytest.mark.parametrize("k", [1, 16, 128, 129, 256, 700, 1100, 4096, 11008])
def test_int8_stages_cover_every_k_row_once(k, boxes):
    """PlainS8<boxes>'s stages take K rows 128 boxes st .. of QA and W
    alike, every row below K once, the last stage's boxes partly (or, at
    two boxes, wholly) past K: zeros from the maps' fill."""
    seen = []
    for st in range(s8_stages(k, boxes)):
        for k0 in s8_rows(st, boxes):
            seen += [r for r in range(k0, k0 + 128) if r < k]
        assert s8_rows(st, boxes)[0] < k
    assert seen == list(range(k))


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


def test_int8_kernel_constants_match_the_host():
    """int8_gemm_noc's stage depth is one of the two the model walks, its
    K rows a box are the wrapper's stage (int8.STAGE_K), the wrapper's
    padding makes the maps' 16-byte pitches, and the rings hold the
    stages the header states: packed 3 (BT 128) and 4 (BT 64), with K3's
    staging of C 2 and 3, one int8 box 4 and 5, two int8 boxes 2 and
    2."""
    boxes = _const("BOXES", "int8_gemm_noc.cu")
    assert boxes in (1, 2)
    assert _const("PACK_ROWS") == int8.STAGE_K == 128
    assert int8.ALIGN == 16
    src = (_build.CSRC / SOURCE).read_text()
    assert "int8_wgmma<BT, Src, ADD_C>" in src
    assert "htog::w4::PlainS8<BOXES>, false>" in (
        _build.CSRC / "int8_gemm_noc.cu").read_text()
    assert "htog::w4::Packed, true>" in (
        _build.CSRC / "w4a8_gemm.cu").read_text()
    limit, pk = _const("SMEM_LIMIT"), 128 * LINE
    staging = 8 * 2 * _const("OUT_TOKENS") * LINE
    for qa_boxes, w_boxes, out, want in ((2, 1, 0, (3, 4)),
                                         (2, 1, staging, (2, 3)),
                                         (1, 1, 0, (4, 5)),
                                         (2, 2, 0, (2, 2))):
        for bt, st in zip((128, 64), want):
            stage = qa_boxes * bt * LINE + 2 * w_boxes * pk
            assert (limit - 1024 - 256 - out) // stage == st


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


# ------------------------------------------- K1: C read into a fresh output

def _staging(source, name):
    """(tokens, buffers, loads C) of the Staging<...> that ``name`` names
    in ``source``."""
    src = (_build.CSRC / source).read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    args = re.search(rf"{name}[^;]*Staging<(\w+), (\w+)(, true)?>", src)
    return (consts.get(args[1], None) or int(args[1]),
            consts.get(args[2], None) or int(args[2]), bool(args[3]))


def c_epilogue(y, c, tokens, bufs, bt, load):
    """The "+ C" epilogue as each consumer warp stages it: its 32 columns
    of a (bt, 256) tile, ``tokens`` tokens a pass, in buffer pass %
    ``bufs``. Threads (g, t) hold token r = 8 jj + 2 t + e of a pass,
    columns 4 g .. + 3 of the warp's, at 16-byte chunk g ^ (r % 8) of line
    r. ``load`` (into a fresh output): the tensor map loads C's box into
    the buffer through the 128-byte swizzle (zeros past M and N), the
    threads add their products to what they find at their chunk (fp32,
    rounded), and the map stores the buffer over out (clipped). Else (in
    place) the threads write their products and the map adds the buffer
    into C in L2 (one rounded add). Returns out; every element of the tile
    passes through exactly one buffer slot once."""
    m, n = c.shape
    tile_n = _const("TILE_N")
    mp, np_ = -(-m // bt) * bt, -(-n // tile_n) * tile_n
    yp = np.zeros((mp, np_), np.float32)
    yp[:m, :n] = y
    cp = np.zeros((mp, np_), np.float32)
    cp[:m, :n] = c
    out = cp.copy() if not load else np.zeros((mp, np_), np.float32)
    hits = np.zeros((mp, np_), np.int64)
    r = np.arange(tokens)[:, None]            # a pass's lines
    q = np.arange(8)[None, :]                 # logical 16-byte chunks
    slot = (r * 8 + (q ^ (r & 7)))            # where chunk q of line r lies
    images = [np.full((tokens * 8, 4), np.nan, np.float32)
              for _ in range(bufs)]
    for ti in range(mp // bt):
        for tj in range(np_ // tile_n):
            for warp in range(8):
                n0 = tj * tile_n + 32 * warp
                for p in range(bt // tokens):
                    img = images[p % bufs]
                    t0 = ti * bt + tokens * p
                    box_c = cp[t0:t0 + tokens, n0:n0 + 32].reshape(
                        tokens, 8, 4)
                    if load:
                        img[slot.ravel()] = box_c.reshape(-1, 4)
                    for g in range(8):
                        for t in range(4):
                            for jj in range(tokens // 8):
                                for e in range(2):
                                    rr = 8 * jj + 2 * t + e
                                    at = rr * 8 + (g ^ (rr & 7))
                                    v = yp[t0 + rr, n0 + 4 * g:n0 + 4 * g + 4]
                                    img[at] = img[at] + v if load else v
                                    hits[t0 + rr, n0 + 4 * g:
                                         n0 + 4 * g + 4] += 1
                    box = img[slot.ravel()].reshape(tokens, 32)
                    if load:
                        out[t0:t0 + tokens, n0:n0 + 32] = box
                    else:
                        out[t0:t0 + tokens, n0:n0 + 32] += box
    assert (hits == 1).all()
    return out[:m, :n]


@pytest.mark.parametrize("k", [700, 1100, 4096])
def test_k1_model_with_c_into_a_fresh_output_equals_jax(k):
    """K1 (int8_gemm_nn): the plain int8 walk at its source's BOXES, and
    the out-of-place "+ C" epilogue at its staging (C loaded into each
    warp's buffers, the products added there, the buffers stored into a
    fresh output): EQUAL to the port's plain version, each op rounded, and
    to the JAX rung 06 kernel in interpret mode (XLA:CPU contracts its
    epilogue's last multiply and add into one fused multiply-add, so the
    model's sums under that rounding); C is left as it was."""
    m, n = 6, 300
    x, w = _operands(m, k, n, k + 3)
    c = np.random.default_rng(k + 1).uniform(-1, 1, (m, n)).astype(
        np.float32)
    kept = c.copy()
    jqa, jsa, jqb, jsb = jint8.prepare(jnp.asarray(x), jnp.asarray(w))
    ref = np.asarray(jint8.mmult_q(jqa, jsa, jqb, jsb, jnp.asarray(c),
                                   interpret=True))
    qa, sa, qb, sb = int8.prepare(torch.from_numpy(x), torch.from_numpy(w))
    pqa, pqb = _wrapper_operands(qa, qb)
    boxes = _const("BOXES", "int8_gemm_nn.cu")
    tokens, bufs, load = _staging("int8_gemm_nn.cu", "using K1")
    assert load
    sums = kernel_sums(pqa, pqb[:, :n], boxes)
    y = (sums.astype(np.float32) * sa.numpy()) * sb.numpy()
    for bt in (64, 128):
        got = c_epilogue(y, c, tokens, bufs, bt, load)
        np.testing.assert_array_equal(got, epilogue_add(
            sums, sa.numpy(), sb.numpy(), c))
    plain = int8.mmult_q_ref(qa, sa, qb, sb, torch.from_numpy(c))
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(
        epilogue_add(sums, sa.numpy(), sb.numpy(), c, contract=True), ref)
    np.testing.assert_array_equal(c, kept)


def test_k3_in_place_staging_model_is_the_plain_add():
    """The same staging model in place, at K3's geometry (OUT_TOKENS, two
    buffers, no load): the map's add of each staged box gives y + C."""
    rng = np.random.default_rng(5)
    y = rng.standard_normal((70, 300)).astype(np.float32)
    c = rng.standard_normal((70, 300)).astype(np.float32)
    for bt in (64, 128):
        np.testing.assert_array_equal(
            c_epilogue(y, c, _const("OUT_TOKENS"), 2, bt, False), y + c)


def test_k1_constants_match_the_host():
    """K1's source names PlainS8<BOXES> with a staging that loads C, and
    its layout keeps a ring of at least two stages beside that staging at
    both token tiles (the header's Layout: the stages that fit in a
    block's shared memory after 1,024 bytes of alignment, 256 of
    barriers and the staging); the other choices the variants time fit
    too."""
    src = (_build.CSRC / "int8_gemm_nn.cu").read_text()
    assert "htog::w4::launch<K1, true>" in src
    assert "PlainS8<BOXES, htog::w4::Staging<OUT_T, OUT_B, true>>" in src
    boxes = _const("BOXES", "int8_gemm_nn.cu")
    tokens, bufs, load = _staging("int8_gemm_nn.cu", "using K1")
    limit, pk = _const("SMEM_LIMIT"), 128 * LINE
    for b, t, nb in ((boxes, tokens, bufs), (2, 32, 1), (1, 32, 2),
                     (1, 16, 2)):
        staging = 8 * nb * t * LINE
        for bt in (128, 64):
            assert bt % t == 0
            stage = b * bt * LINE + 2 * b * pk
            assert (limit - 1024 - 256 - staging) // stage >= 2, (b, t, nb)
    # two boxes beside K3's 64 KB staging: one stage, refused
    assert (limit - 1024 - 256 - 8 * 2 * 32 * LINE) // (
        2 * 128 * LINE + 4 * pk) == 1
    # the barriers: the ring's (two a stage) and C's (one a buffer)
    assert 16 * 5 + 8 * 8 * bufs <= 256
