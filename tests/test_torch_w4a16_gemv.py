"""The W4A16 serving pair's walks modelled on the CPU, against the JAX
package's ``pallas_int4.mmult_q_noc`` in interpret mode.

The decode GEMV (``csrc/w4a16_gemv.cu``, kernel ``w4a16_gemv``): a
cluster of blocks shares a slab of 128 output columns and splits its K in
stages of 128 packed rows (``int4.w4a16_gemv_plan`` picks the cluster; a
block takes 8 rows of A, more rows more row groups); each block stores its
K slice of A's rows as bf16 in shared memory, 16 bytes an item, a 16-row
group's low-nibble K rows then its high-nibble ones; each stage's box lands
as the tensor map lays it (128-byte swizzle, zeros past N); each lane loads
its four words at the kernel's offsets (the model asserts 32 distinct
banks a load), pairs a column's bytes of two rows as ``__byte_perm`` does,
makes bf16 pairs with the kernel's bit operations, and ldmatrix's lanes
address A's rows; the mma.sync m16n8k16 products (the weights as A, A's
rows as B) are taken from the fragments as PTX lays them out, each rounded
to fp32 and added to its warp's fp32 sums; the two halves' and the
cluster's partials are added in the owners' slot order, then scaled by sw.

The prefill GEMM (``csrc/w4a16_wgmma.cuh``, kernel ``w4a16_gemm_noc``):
vectorised over a consumer warpgroup's 128 threads, each stage's packed
box image, the threads' words, the same bit decode, the four wgmma A
fragments placed by wgmma's A layout, multiplied by the stage's four
activation boxes (K columns past K zero, as the map's fill), each product
rounded to fp32 and added to the fp32 sums step by step, and the sums
mapped to output columns as the epilogue stores them.

Tolerance: the tensor cores sum in another order than the JAX kernel (and
the JAX GEMV runs the reference's pack algebra), so each model is held
within 1e-5 of max |y| (``tests/test_torch_w4a16.py``'s rule) of the JAX
function and of the port's plain version. The bit decode is EQUAL to
``quant.unpack_int4`` for every byte value, and packed rows past K add
nothing (a pack dirty there gives the same bits). Beside them, the stage
order, the plans, the kernels' constants read from their sources, and the
wrapper's one launch on meta tensors.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.models import linear as jlinear
from how_to_optimize_gemm_tpu.ops import pallas_int4 as jint4
from how_to_optimize_gemm_tpu_torch import _build, convert
from how_to_optimize_gemm_tpu_torch.models import linear
from how_to_optimize_gemm_tpu_torch.ops import bounds, int4, quant, tuned

torch.set_num_threads(1)

GEMV_SOURCE = "w4a16_gemv.cu"
GEMM_SOURCE = "w4a16_wgmma.cuh"
H100_SMS = 132
REL = 1e-5
SLAB = int4.GEMV_SLAB
ROWS = int4.GEMV_STAGE_ROWS
LINE = 128
LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3


def _const(source, name):
    src = (_build.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


def k_base(s, part):
    return 512 * (s // 2) + 128 * (s % 2) + 256 * part


def swz(r, c):
    return r * LINE + ((((c >> 4) ^ r) & 7) << 4) + (c & 15)


# ------------------------------------------------------ the bit decode

def byte_pair(x, y, c):
    """__byte_perm(x, y, c | c << 4 | (4 + c) << 8 | (4 + c) << 12): byte
    c of x in bytes 0 and 1, byte c of y in bytes 2 and 3."""
    bx = (x >> np.uint32(8 * c)) & np.uint32(0xFF)
    by = (y >> np.uint32(8 * c)) & np.uint32(0xFF)
    return (bx | (bx << np.uint32(8)) | (by << np.uint32(16))
            | (by << np.uint32(24))).astype(np.uint32)


def bf16_values(bits):
    """bf16 bit patterns (uint32 holding 16 bits) as float32 values."""
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def to_bf16_bits(v):
    """float32 values exact in bf16 -> their bf16 bits."""
    bits = v.astype(np.float32).view(np.uint32)
    assert not (bits & np.uint32(0xFFFF)).any()
    return bits >> np.uint32(16)


def minus_136(v):
    """__hsub2(v, 136): both halves, exact for these values."""
    lo = bf16_values(v & np.uint32(0xFFFF)) - np.float32(136)
    hi = bf16_values(v >> np.uint32(16)) - np.float32(136)
    return (to_bf16_bits(lo) | (to_bf16_bits(hi) << np.uint32(16))).astype(
        np.uint32)


def bf16x2_lo(p):
    return minus_136((p & np.uint32(0x000F000F)) | np.uint32(0x43004300))


def bf16x2_hi(p):
    return minus_136(((p >> np.uint32(4)) & np.uint32(0x000F000F))
                     ^ np.uint32(0x43084308))


def pair_values(w):
    """A bf16 pair word -> (low half's value, high half's value)."""
    return (bf16_values(w & np.uint32(0xFFFF)),
            bf16_values(w >> np.uint32(16)))


def test_bit_decode_equals_unpack_int4():
    """Every byte value, as the low and high byte of a pair, through both
    decodes: the low nibbles (offset binary) and the high ones (two's
    complement) equal the reference's, as the kernel's bf16 pairs."""
    b = np.arange(256, dtype=np.uint32)
    packed = torch.from_numpy(b.astype(np.uint8).view(np.int8)[:, None])
    want = quant.unpack_int4(packed, int4.PACK_BLOCK)[:, 0].numpy()
    other = b[::-1].copy()
    for c in range(4):
        x = b << np.uint32(8 * c) | np.uint32(0x5A5A5A5A) & ~(
            np.uint32(0xFF) << np.uint32(8 * c))
        y = other << np.uint32(8 * c)
        p = byte_pair(x, y, c)
        lo, lo_y = pair_values(bf16x2_lo(p))
        hi, hi_y = pair_values(bf16x2_hi(p))
        np.testing.assert_array_equal(lo, want[:256])
        np.testing.assert_array_equal(hi, want[256:])
        np.testing.assert_array_equal(lo_y, want[:256][::-1])
        np.testing.assert_array_equal(hi_y, want[256:][::-1])


# ------------------------------------------------------------ the GEMV

def _stage_image(pk, prow0, n0, n):
    """A stage's shared memory as the tensor map writes it: packed rows
    prow0 .. + 127, columns n0 .. + 127, zeros past N and past the pack,
    128-byte swizzle."""
    img = np.zeros(ROWS * SLAB, np.uint8)
    r, c = np.meshgrid(np.arange(ROWS), np.arange(SLAB), indexing="ij")
    rows = prow0 + r
    ok = (rows < pk.shape[0]) & (n0 + c < n)
    vals = np.where(ok, pk[np.minimum(rows, pk.shape[0] - 1),
                           np.minimum(n0 + c, pk.shape[1] - 1)], 0)
    img[swz(r, c)] = vals
    return img


def _a_image(a_bits, k, row0, rows, s0, nst, rowb):
    """A block's rows of A in shared memory (bytes): item e of a row is K
    rows k_base(s0 + u / 2, u % 2) + 8 (e % 16) .. + 7 (u = e / 16, zeros
    past K) at byte ((u / 2) * 8 + (e % 16) / 2) * 64 + (u % 2) * 32 +
    16 (e % 2)."""
    img = np.zeros((rows, rowb), np.uint8)
    for e in range(32 * nst):
        u = e >> 4
        ks = k_base(s0 + (u >> 1), u & 1) + 8 * (e & 15) + np.arange(8)
        vals = np.where(ks < k, a_bits[row0:row0 + rows,
                                       np.minimum(ks, k - 1)], 0)
        off = ((u >> 1) * 8 + ((e & 15) >> 1)) * 64 + (u & 1) * 32 \
            + 16 * (e & 1)
        img[:, off:off + 16] = np.ascontiguousarray(
            vals, dtype=np.uint16).view(np.uint8)
    return img


def _ldmatrix(ximg, rows, step):
    """ldmatrix.x4's four 8 x 8 b16 matrices: lane l addresses A's row
    l % 8 (row 0 past ``rows``) at bytes 16 (l / 8) of the group's 64;
    matrix jm's row i comes from lane 8 jm + i, and lane L receives its row
    L / 4, word L % 4. Returns regs [jm][lane] (uint32)."""
    regs = np.zeros((4, 32), np.uint32)
    for jm in range(4):
        src = 8 * jm + LANE // 4
        r = np.where((src & 7) < rows, src & 7, 0)
        base = step * 64 + 16 * (src >> 3) + 4 * (LANE % 4)
        for byte in range(4):
            regs[jm] |= ximg[r, base + byte].astype(np.uint32) \
                << np.uint32(8 * byte)
    return regs


def _a_fragment(words):
    """A 16 x 16 matrix (mma rows x k) of m16n8k16's A layout from four
    registers a lane: (row g, k 2t..), (g + 8, 2t..), (g, 2t + 8..),
    (g + 8, 2t + 8..)."""
    a = np.zeros((16, 16), np.float32)
    for x, w in enumerate(words):
        rows = G + 8 * (x % 2)
        k = 2 * T + 8 * (x // 2)
        lo, hi = pair_values(w)
        a[rows, k] = lo
        a[rows, k + 1] = hi
    return a


def _b_fragment(b0, b1):
    """A 16 x 8 (k x n) matrix of m16n8k16's B layout: b0 holds (k 2t..,
    column g), b1 (k 2t + 8.., column g)."""
    b = np.zeros((16, 8), np.float32)
    for x, w in enumerate((b0, b1)):
        lo, hi = pair_values(w)
        b[2 * T + 8 * x, G] = lo
        b[2 * T + 8 * x + 1, G] = hi
    return b


def _block(a_bits, k, pk, n, n0, row0, rows, s0, nst, spc):
    """One block's fp32 partials [half][row][column of the slab]."""
    rowb = spc * 8 * 64 + 16
    ximg = _a_image(a_bits, k, row0, rows, s0, nst, rowb)
    acc = np.zeros((2, 8, SLAB), np.float32)   # [half][A row][column]
    for q in range(nst):
        img = _stage_image(pk, (s0 + q) * ROWS, n0, n)
        for grp in range(8):
            half = grp // 4
            regs = _ldmatrix(ximg, rows, 8 * q + grp)
            for wc in range(4):
                col = wc * 32 + 4 * G
                w = []
                for j in range(4):
                    r = 16 * grp + 2 * T + (j & 1) + 8 * (j >> 1)
                    off = swz(r, col)
                    assert len(set((off // 4) % 32)) == 32
                    w.append(sum(img[off + byte].astype(np.uint32)
                                 << np.uint32(8 * byte) for byte in range(4)))
                for pc in range(2):
                    p = [byte_pair(w[0], w[1], 2 * pc),
                         byte_pair(w[0], w[1], 2 * pc + 1),
                         byte_pair(w[2], w[3], 2 * pc),
                         byte_pair(w[2], w[3], 2 * pc + 1)]
                    for dec, b0, b1 in ((bf16x2_lo, regs[0], regs[1]),
                                        (bf16x2_hi, regs[2], regs[3])):
                        d = (_a_fragment([dec(x) for x in p]).astype(
                            np.float64) @ _b_fragment(b0, b1)).astype(
                                np.float32)
                        # D's row g (+ 8): column 4g + 2pc (+ 1); its
                        # column c: A's row c
                        for dr in (0, 1):
                            cols = wc * 32 + 4 * np.arange(8) + 2 * pc + dr
                            acc[half, :, cols] += d[8 * dr:8 * dr + 8, :]
    return acc


def gemv_model(a, packed, sw, k, cluster):
    """The kernel's output for a (m, k) bf16 (as a torch tensor), packed
    (Kp/2, ldp) int8 and sw (1, n) float32 (numpy), on ``cluster`` blocks
    a slab and 8 rows of A a block."""
    m = a.shape[0]
    n = sw.shape[1]
    a_bits = a.view(torch.int16).numpy().view(np.uint16)
    pk = packed.view(np.uint8)
    s_total = int4.gemv_stages(k)
    spc = -(-s_total // cluster)
    out = np.zeros((m, n), np.float32)
    for row0 in range(0, m, 8):
        rows = min(8, m - row0)
        ranges = [(r * s_total // cluster, (r + 1) * s_total // cluster)
                  for r in range(cluster)]
        for n0 in range(0, n, SLAB):
            # slot 2 c + h: block c's half h; the owner adds them in turn
            slots = [part for s0, s1 in ranges
                     for part in _block(a_bits, k, pk, n, n0, row0, rows,
                                        s0, s1 - s0, spc)]
            total = np.zeros((8, SLAB), np.float32)
            for part in slots:
                total = total + part
            cols = min(SLAB, n - n0)
            out[row0:row0 + rows, n0:n0 + cols] = (
                total[:rows, :cols] * sw[:, n0:n0 + cols])
    return out


_WEIGHTS = {}


def _weights(k, n):
    """(JAX packed, JAX sw, port packed, port sw) of one random (k, n) W:
    the port's pack is the JAX bytes."""
    if (k, n) not in _WEIGHTS:
        w = np.random.default_rng(k + n).standard_normal(
            (k, n)).astype(np.float32)
        jlin = jlinear.make_linear(jnp.asarray(w), "int4")
        lin = linear.make_linear(torch.from_numpy(w), "int4")
        for key in lin:
            ref = convert.params_from_jax(np.asarray(jlin[key]), "cpu")
            assert torch.equal(lin[key], ref), key
        _WEIGHTS[k, n] = (jlin["int4_packed"], jlin["int4_sw"],
                          lin["int4_packed"], lin["int4_sw"])
    return _WEIGHTS[k, n]


def _a(m, k, seed):
    """(JAX bf16 A, the port's bf16 A: the same bits)."""
    rng = np.random.default_rng(seed)
    ja = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    return ja, convert.params_from_jax(np.asarray(ja), "cpu")


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=REL * np.abs(ref).max())


@pytest.mark.parametrize("n", [100, 300])
@pytest.mark.parametrize("k", [700, 1024])
@pytest.mark.parametrize("m", [1, 4, 5, 64])
def test_gemv_walk_matches_jax(m, k, n):
    jpacked, jsw, packed, sw = _weights(k, n)
    ja, a = _a(m, k, 100 * m + k + n)
    cluster = int4.w4a16_gemv_plan(m, k, n, H100_SMS)
    ldp = bounds.pad_dim(packed, 1, 16)
    assert ldp.shape[1] > n
    got = gemv_model(a, ldp.numpy(), sw.numpy(), k, cluster)
    ref = np.asarray(jint4.mmult_q_noc(ja, jpacked, jsw, interpret=True))
    _close(got, ref)
    _close(got, int4.mmult_q_noc(a, packed, sw).numpy())


@pytest.mark.parametrize("cluster,m", [(1, 5), (2, 20), (8, 5)])
def test_gemv_walk_at_other_plans(cluster, m):
    """Any cluster (8 blocks over 4 stages leaves half of them none) and
    rows past 8 in more row groups; and packed rows past K add nothing:
    a pack dirty there gives the same bits."""
    k, n = 700, 300
    _, _, packed, sw = _weights(k, n)
    _, a = _a(m, k, 7)
    clean = bounds.pad_dim(packed, 1, 16).numpy()
    got = gemv_model(a, clean, sw.numpy(), k, cluster)
    _close(got, int4.mmult_q_noc(a, packed, sw).numpy())
    # pack block 1 (packed rows 256..511) holds K rows 512..767 in its low
    # nibbles and 768..1023 in its high ones; rows 512..699 are live
    dirty = clean.copy()
    dirty[444:] = 0x77
    dirty[256:444] = (clean[256:444] & 0x0F) | 0x70
    np.testing.assert_array_equal(
        gemv_model(a, dirty, sw.numpy(), k, cluster), got)


def test_stages_cover_every_k_row_once():
    """Stage s holds packed rows 128 s .. + 127: K rows k_base(s, 0) ..
    (low nibbles) and k_base(s, 1) .. (high), so the stages below
    gemv_stages(K) cover each K row below K once; a block's A image holds
    each of its K rows once, at the step its products read."""
    for k in (1, 128, 129, 512, 700, 1024, 4096, 11008):
        seen = []
        for s in range(int4.gemv_stages(k)):
            for part in (0, 1):
                base = k_base(s, part)
                assert 256 * (base // 512) + base % 256 == 128 * s
                seen += [r for r in range(base, base + 128) if r < k]
        assert sorted(seen) == list(range(k)), k
    k = 700
    s_total = int4.gemv_stages(k)
    a_bits = np.arange(k, dtype=np.uint16)[None] + 1
    img = _a_image(a_bits, k, 0, 1, 0, s_total, s_total * 512 + 16)
    vals = img[0, :s_total * 512].view(np.uint16)
    for q in range(s_total):
        for grp in range(8):
            for part in (0, 1):
                step = vals[(8 * q + grp) * 32 + 16 * part:][:16]
                ks = k_base(q, part) + 16 * grp + np.arange(16)
                np.testing.assert_array_equal(
                    step, np.where(ks < k, ks + 1, 0))


def test_ldmatrix_rows_hit_distinct_banks():
    """A row of A is 16 bytes past whole 512-byte stages, so the 8 rows of
    each ldmatrix matrix fall on 8 distinct 16-byte bank groups."""
    for spc in (1, 2, 6, 44):
        rowb = spc * 512 + 16
        for step in range(0, 16):
            for off in (0, 16, 32, 48):
                groups = {((r * rowb + step * 64 + off) // 16) % 8
                          for r in range(8)}
                assert len(groups) == 8


@pytest.mark.parametrize("m,k,n,cluster", [
    (4, 4096, 11008, 4), (4, 4096, 4096, 8), (4, 11008, 4096, 8),
    (1, 4096, 11008, 4), (16, 4096, 11008, 2), (64, 4096, 11008, 2),
    (64, 11008, 4096, 2), (5, 700, 300, 4)])
def test_w4a16_gemv_plan(m, k, n, cluster):
    """The 7B decode shapes at m = 4: 86 slabs x 4 = 344 blocks, three an
    SM (the rows of A take 8 KB a block), and 32 x 8 = 256 at N = 4,096;
    more than one row group at most 2. Every block has a stage and fits
    its shared memory."""
    assert int4.w4a16_gemv_plan(m, k, n, H100_SMS) == cluster
    stages = int4.gemv_stages(k)
    smem = int4.w4a16_gemv_smem(min(m, int4.GEMV_ROWS),
                                -(-stages // cluster))
    assert stages >= cluster and cluster & (cluster - 1) == 0
    assert smem <= int4.GEMV_SMEM
    per_sm = min(int4.GEMV_BLOCKS_PER_SM, int4.GEMV_SM_SMEM // (smem + 1024))
    assert -(-n // int4.GEMV_SLAB) * cluster <= per_sm * H100_SMS


def test_gemv_constants_match_the_host():
    src = (_build.CSRC / GEMV_SOURCE).read_text()
    assert _const(GEMV_SOURCE, "SLAB") == int4.GEMV_SLAB
    assert _const(GEMV_SOURCE, "ROWS") == int4.GEMV_ROWS
    assert _const(GEMV_SOURCE, "PACK_ROWS") == int4.GEMV_STAGE_ROWS
    assert _const(GEMV_SOURCE, "ST") == int4.GEMV_RING
    assert _const(GEMV_SOURCE, "MAX_CLUSTER") == int4.GEMV_MAX_CLUSTER
    assert _const(GEMV_SOURCE, "SMEM_LIMIT") == int4.GEMV_SMEM
    assert _const(GEMV_SOURCE, "ROW_PAD") == int4.W4A16_GEMV_ROW_PAD
    assert _const(GEMV_SOURCE, "GROUP_BYTES") == int4.W4A16_GEMV_GROUP_BYTES
    assert (f"__launch_bounds__(THREADS, {int4.GEMV_BLOCKS_PER_SM})"
            in src)
    # 8 rows of A fit a block at clusters of 8 up to the largest Kp
    spc = -(-int4.gemv_stages(int4.W4A16_GEMV_MAX_KP) // 8)
    assert int4.w4a16_gemv_smem(8, spc) <= int4.GEMV_SMEM
    assert int4.w4a16_gemv_plan(64, int4.W4A16_GEMV_MAX_KP, 4096,
                                H100_SMS) == 8


def _meta_call(monkeypatch, m, k, n, a=None):
    calls = []
    monkeypatch.setattr(int4, "require_cuda", lambda name, x: None)
    monkeypatch.setattr(int4, "_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(_build, "launch", lambda name, dev, *args:
                        calls.append((name, *args)))
    meta = dict(device="meta")
    kp = -(-k // 512) * 512
    packed = torch.zeros((kp // 2, n), dtype=torch.int8, **meta)
    sw = torch.zeros((1, n), **meta)
    if a is None:
        a = torch.zeros((m, k), dtype=torch.bfloat16, **meta)
    out = int4.mmult_q_noc(a, packed, sw)
    assert out.shape == (m, n) and out.dtype == torch.float32
    (call,) = calls
    return call, out, packed, sw


def test_wrapper_launches_the_gemv_once_on_a_as_it_is(monkeypatch):
    """At m <= 64 the wrapper allocates out alone and launches the GEMV once
    with its plan; A keeps its K and its row pitch (meta tensors, the
    launch recorded)."""
    k, n = 11008, 4096
    wide = torch.zeros((4, k + 64), dtype=torch.bfloat16, device="meta")
    (name, aa, pa, swa, outa, *ints), out, packed, sw = _meta_call(
        monkeypatch, 4, k, n, wide[:, :k])
    assert name == "w4a16_gemv" and outa is out
    assert aa.shape == (4, k) and pa is packed and swa is sw
    assert ints == [4, n, k, k + 64, 11264, n, 8]


@pytest.mark.parametrize("m,k,route", [(64, 4096, "w4a16_gemv"),
                                       (65, 4096, "w4a16_gemm_noc"),
                                       (4, 65536, "w4a16_gemv"),
                                       (4, 65537, "w4a16_gemm_noc")])
def test_wrapper_routes(monkeypatch, m, k, route):
    """The GEMV at m <= 64 up to Kp = W4A16_GEMV_MAX_KP, the GEMM past
    either."""
    (name, *_), _, _, _ = _meta_call(monkeypatch, m, k, 256)
    assert name == route


# ------------------------------------------------------------ the GEMM

# a consumer warpgroup's 128 threads: warp w, lane 4 g + t
W, GW, TW = np.meshgrid(np.arange(4), np.arange(8), np.arange(4),
                        indexing="ij")
COL = 4 * (8 * W + GW)   # a thread's four columns of its 128


def swizzled(box):
    """The shared-memory image of a (rows, 128) byte box as a tensor map
    with the 128-byte swizzle writes it."""
    img = np.zeros(box.size, np.uint8)
    rows = np.arange(box.shape[0])[:, None]
    cols = np.arange(LINE)[None, :]
    img[rows * LINE + (((cols >> 4) ^ (rows & 7)) << 4) + (cols & 15)] = box
    return img


def gemm_fragments(img, i):
    """fragments<I>: f[0], f[1] the low nibbles' A fragments of slabs 0 and
    1, f[2], f[3] the high ones'; four registers a thread."""
    words = []
    for j in range(4):
        r = 2 * TW + (j & 1) + 8 * (j >> 1)
        off = r * LINE + ((((COL >> 4) ^ (r & 7)) << 4) | (COL & 15))
        a = 16 * i * LINE + off
        words.append(sum(img[a + b].astype(np.uint32) << np.uint32(8 * b)
                         for b in range(4)))
    f = [[None] * 4 for _ in range(4)]
    for s in range(2):
        for h in range(2):
            p0 = byte_pair(words[0], words[1], 2 * s + h)
            p1 = byte_pair(words[2], words[3], 2 * s + h)
            f[s][h], f[s][2 + h] = bf16x2_lo(p0), bf16x2_lo(p1)
            f[2 + s][h], f[2 + s][2 + h] = bf16x2_hi(p0), bf16x2_hi(p1)
    return f


def a_slab(frag):
    """A 64 x 16 slab from the warpgroup's fragments by wgmma's A layout:
    register x of thread (w, g, t) holds row 16 w + g + 8 (x % 2), K
    values 2 t + 8 (x // 2) and the next."""
    a = np.zeros((64, 16), np.float32)
    for x in range(4):
        rows = 16 * W + GW + 8 * (x % 2)
        k = 2 * TW + 8 * (x // 2)
        lo, hi = pair_values(frag[x])
        a[rows, k] = lo
        a[rows, k + 1] = hi
    return a


def gemm_model(a, packed, sw, bt=128):
    """out as the kernel computes it on (bt, 256) tiles: per stage, per
    16-deep step, each wgmma's product rounded to fp32 and added to the
    fp32 sums (a numpy model of the tensor cores' sum; bt does not change
    the order of any output's sums)."""
    m, k = a.shape
    n = packed.shape[1]
    tile_n = _const("w4a8_wgmma.cuh", "TILE_N")
    n_pad = -(-n // tile_n) * tile_n
    rows = -(-k // 512) * 256
    pk = np.zeros((rows + ROWS, n_pad), np.uint8)
    pk[:rows, :n] = packed[:rows].view(np.uint8)
    av = np.zeros((-(-m // bt) * bt, -(-k // 512) * 512 + 512), np.float32)
    av[:m, :k] = a.float().numpy()   # the activation map's zero fill
    out = np.zeros((av.shape[0], n_pad), np.float32)
    for ti in range(av.shape[0] // bt):
        tok = slice(ti * bt, (ti + 1) * bt)
        for tj in range(n_pad // tile_n):
            for cw in range(2):
                c0 = tj * tile_n + 128 * cw
                sums = [np.zeros((64, bt), np.float32) for _ in range(2)]
                for st in range(int4.gemv_stages(k)):
                    k0 = 512 * (st // 2) + 128 * (st % 2)
                    prow = 256 * (st // 2) + 128 * (st % 2)
                    img = swizzled(pk[prow:prow + ROWS, c0:c0 + 128])
                    for i in range(8):
                        f = gemm_fragments(img, i)
                        for s in range(2):
                            for frag, kq in ((f[s], k0), (f[2 + s],
                                                          k0 + 256)):
                                b = av[tok, kq + 16 * i:kq + 16 * i + 16]
                                sums[s] += (a_slab(frag).astype(np.float64)
                                            @ b.T.astype(np.float64)) \
                                    .astype(np.float32)
                # epilogue: slab s row 16 w + g + 8 h is column
                # 4 (8 w + g) + 2 s + h
                for s in range(2):
                    for h in range(2):
                        slab_rows = (16 * W + GW + 8 * h)[:, :, 0].ravel()
                        cols = (COL[:, :, 0] + 2 * s + h).ravel()
                        out[tok, c0 + cols] = sums[s][slab_rows].T
    return out[:m, :n] * sw


@pytest.mark.parametrize("m", [65, 130, 300])
def test_gemm_walk_matches_jax(m):
    k, n = 700, 300
    jpacked, jsw, packed, sw = _weights(k, n)
    ja, a = _a(m, k, m)
    got = gemm_model(a, packed.numpy(), sw.numpy())
    ref = np.asarray(jint4.mmult_q_noc(ja, jpacked, jsw, interpret=True))
    _close(got, ref)
    _close(got, int4.mmult_q_noc(a, packed, sw).numpy())


def test_gemm_walk_is_the_same_at_both_token_tiles():
    k, n, m = 700, 300, 65
    _, _, packed, sw = _weights(k, n)
    _, a = _a(m, k, 3)
    np.testing.assert_array_equal(
        gemm_model(a, packed.numpy(), sw.numpy(), bt=64),
        gemm_model(a, packed.numpy(), sw.numpy(), bt=128))


@pytest.mark.parametrize("k,n", [(1, 1), (40, 1), (129, 2), (256, 2),
                                 (512, 2), (700, 4), (1100, 5), (4096, 16),
                                 (11008, 44)])
def test_gemm_stages_pair_both_nibbles(k, n):
    """A tile's stages cover every K row below K once, the low and high
    nibbles of one packed box in one stage, and its four activation boxes
    (K columns k0, k0 + 64, k0 + 256, k0 + 320, 64 wide) hold exactly the
    stage's K rows; n is the kernel's count for K."""
    assert int4.gemv_stages(k) == n
    seen = []
    for st in range(n):
        k0 = 512 * (st // 2) + 128 * (st % 2)
        prow = 256 * (st // 2) + 128 * (st % 2)
        rows = [k0 + r for r in range(128)] + [k0 + 256 + r
                                               for r in range(128)]
        boxes = [k0 + 256 * (b >> 1) + 64 * (b & 1) + c
                 for b in range(4) for c in range(64)]
        assert boxes == rows
        seen += [r for r in rows if r < k]
        for kk in (k0, k0 + 256):
            assert (kk // 512) * 256 + (kk % 512) % 256 == prow
    assert sorted(seen) == list(range(k))


def test_gemm_constants_match_the_host():
    """The walk the host describes (tuned.nt_tile_walk's groups of token
    tiles on (BT, 256) tiles) and the tiles this file models are the
    kernel's: w4a8_wgmma.cuh's block, tile and stage, bf16 boxes of 64 K
    values, two stages at BT 128 and three at 64."""
    src = (_build.CSRC / GEMM_SOURCE).read_text()
    w4 = "w4a8_wgmma.cuh"
    assert _const(w4, "TILE_N") == 256
    assert _const(w4, "GROUP_T") == tuned.NT_GROUP_M
    assert _const(w4, "PACK_ROWS") == ROWS
    assert _const(w4, "THREADS") == 288
    assert "static constexpr int STAGE = 4 * A_BYTES + 2 * PK_BYTES;" in src
    assert "abox[2] = {64, BT};" in src
    assert "CU_TENSOR_MAP_DATA_TYPE_BFLOAT16" in src
    limit = _const(w4, "SMEM_LIMIT")
    for bt, st in ((128, 2), (64, 3)):
        stage = 4 * bt * LINE + 2 * ROWS * LINE
        assert (limit - 1024 - 256) // stage == st


@pytest.mark.parametrize("m,n,bt", [(1024, 11008, 128), (1024, 4096, 128),
                                    (130, 300, 64), (1, 1, 64)])
def test_gemm_tile_walk_covers_every_tile_once(m, n, bt):
    walk = tuned.nt_tile_walk(m, n, H100_SMS, (bt, 256))
    tiles = [t for block in walk for t in block]
    expected = {(i * bt, j * 256) for i in range(-(-m // bt))
                for j in range(-(-n // 256))}
    assert len(tiles) == len(expected) and set(tiles) == expected


# ------------------------------------------------ rung 07: C added in place

def _c_staging():
    """(tokens, buffers) of w4a16_wgmma.cuh's C_STAGING."""
    src = (_build.CSRC / GEMM_SOURCE).read_text()
    args = re.search(r"using C_STAGING = w4::Staging<(\d+), (\d+)>;", src)
    return int(args[1]), int(args[2])


def staged_add_c(y, c, tokens, bufs, bt):
    """Rung 07's "+ C" epilogue as each consumer warp stages it: its 32
    columns of a (bt, 256) tile, ``tokens`` tokens a pass, in buffer pass %
    ``bufs``; thread (g, t) writes token r = 8 jj + 2 t + e, columns
    4 g .. + 3 of the warp's, as one float4 at 16-byte chunk g ^ (r % 8) of
    line r, and the tensor map reads the buffer through the 128-byte
    swizzle and adds it into C (one rounded fp32 add, clipped at M and N).
    Each element of the tile is staged once."""
    m, n = c.shape
    mp, np_ = -(-m // bt) * bt, -(-n // 256) * 256
    yp = np.zeros((mp, np_), np.float32)
    yp[:m, :n] = y
    out = np.zeros((mp, np_), np.float32)
    out[:m, :n] = c
    hits = np.zeros((mp, np_), np.int64)
    r = np.arange(tokens)[:, None]
    slot = (r * 8 + (np.arange(8)[None, :] ^ (r & 7))).ravel()
    images = [np.zeros((tokens * 8, 4), np.float32) for _ in range(bufs)]
    for ti in range(mp // bt):
        for tj in range(np_ // 256):
            for warp in range(8):
                n0 = tj * 256 + 32 * warp
                for p in range(bt // tokens):
                    img = images[p % bufs]
                    t0 = ti * bt + tokens * p
                    for g in range(8):
                        for t in range(4):
                            for jj in range(tokens // 8):
                                for e in range(2):
                                    rr = 8 * jj + 2 * t + e
                                    cols = slice(n0 + 4 * g, n0 + 4 * g + 4)
                                    img[rr * 8 + (g ^ (rr & 7))] = \
                                        yp[t0 + rr, cols]
                                    hits[t0 + rr, cols] += 1
                    out[t0:t0 + tokens, n0:n0 + 32] += img[slot].reshape(
                        tokens, 32)
    assert (hits == 1).all()
    return out[:m, :n]


@pytest.mark.parametrize("m", [65, 130, 300])
def test_gemm_walk_with_c_matches_jax(m):
    """Rung 07 (w4a16_gemm): the GEMM's walk, then C added in place
    through the staging at the source's geometry (C_STAGING), at both
    token tiles; within REL of max |y| of the JAX rung 07 kernel in
    interpret mode (C aliased into its output) and of the port's plain
    version, and EQUAL to the walk's products plus C (the staging moves
    the values, the map's add rounds once)."""
    k, n = 700, 300
    jpacked, jsw, packed, sw = _weights(k, n)
    ja, a = _a(m, k, m + 1)
    c = np.random.default_rng(m).uniform(-1, 1, (m, n)).astype(np.float32)
    tokens, bufs = _c_staging()
    y = gemm_model(a, packed.numpy(), sw.numpy())
    for bt in (64, 128):
        got = staged_add_c(y, c, tokens, bufs, bt)
        np.testing.assert_array_equal(got, y + c)
    ref = np.asarray(jint4.mmult_q(ja, jpacked, jsw, jnp.asarray(c),
                                   interpret=True))
    _close(got, ref)
    plain = int4.mmult_q(a, packed, sw, torch.from_numpy(c.copy()))
    _close(got, plain.numpy())


def test_gemm_with_c_constants_match_the_host():
    """Rung 07's kernel is the GEMM's body with ADD_C, its staging (one
    32-token buffer or two 16-token buffers a warp: 32 KB) keeps a ring of
    two stages at BT 128 and three at 64 beside it, where K3's 64 KB would
    leave one stage at BT 128; C's barriers fit beside the ring's."""
    src = (_build.CSRC / GEMM_SOURCE).read_text()
    assert "htog::w16::launch<true>" in (
        _build.CSRC / "w4a16_gemm.cu").read_text()
    assert "htog::w16::launch<false>" in (
        _build.CSRC / "w4a16_gemm_noc.cu").read_text()
    assert ("static constexpr int OUT = ADD_C ? C_STAGING::BYTES : 0;"
            in src)
    tokens, bufs = _c_staging()
    limit = _const("w4a8_wgmma.cuh", "SMEM_LIMIT")
    for staging in (8 * bufs * tokens * LINE, 8 * 2 * 16 * LINE):
        assert staging == 32 * 1024
        for bt, st in ((128, 2), (64, 3)):
            assert bt % tokens == 0
            stage = 4 * bt * LINE + 2 * ROWS * LINE
            assert (limit - 1024 - 256 - staging) // stage == st
            assert 16 * st + 8 * 8 * bufs <= 256
    assert (limit - 1024 - 256 - 8 * 2 * 32 * LINE) // (
        4 * 128 * LINE + 2 * ROWS * LINE) == 1
