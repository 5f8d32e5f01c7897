// Kernel 3 w4a8_gemv_fq: y = f32(quantize(x) @ decode(P) as int32) *
// sa[i] * sw[j] for a few float rows x (m <= 64): the W4A8 serving linear
// at decode widths, with the activation quantization fused in, in one
// launch.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_int4.py,
// _kernel_w4a8_noc_gemv_fq (via mmult_w4a8_fused_noc;
// models/linear.apply_linear at m <= 64). x (M, K) float32, rows ldx
// apart, read at its own K (the columns K .. Kp - 1 count as zeros, as the
// reference's pad makes them; zeros change no row maximum), P (Kp/2, ldp)
// int8 packed nibbles (the layout of w4a8.cuh), sw (1, N) float32, out
// (M, N) float32.
//
// Bound on an H100 SXM, at a Llama-2-7B decode shape (M = 4, K = 4096,
// N = 11008): 22.5 MB of packed weights against 3.6e8 int operations;
// 6.7 us at 3.35 TB/s, so the weight stream bounds it, as for every GEMV.
//
// Design: one launch, a grid of thread-block clusters. A cluster owns a
// slab of SLAB output columns and a group of at most 8 rows of x (more
// rows take more groups, each streaming the slab again, mostly from L2:
// on an H100 that beat 16 to 64 rows a block by 1.1-2.2x at m = 16 and 64);
// its CL blocks split the slab's K: block r takes the stages
// [r * S / CL, (r + 1) * S / CL) of the S = stages(K) stages of PACK_ROWS
// packed rows (the host picks CL: ops/int4.gemv_plan).
// - Stream: warp 8's lane 0 copies each stage's (PACK_ROWS x SLAB) box of
//   the pack by tensor map into a ring of ST 16 KB stages (128-byte
//   swizzle), one mbarrier pair a stage.
// - Quantize (the TPU kernel quantizes in the kernel too): the eight
//   consumer warps take the absmax of the block's slice of each row, a
//   lane loading 16 values at once; each block stores its maxima in every
//   block of the cluster (distributed shared memory), one cluster barrier;
//   max is exact in any order, so every block holds the row's absmax and
//   scale = max(amax, 1e-8) / 127 (__fdiv_rn). Each block then writes its slice as q = clip(rint(x /
//   scale), -127, 127) (__fdiv_rn, __float2int_rn) into shared memory, in
//   the order its products read it. Where a warp has one item of x to
//   load (m <= 4 at 4 stages a block), its loads go out before the first
//   stage's copy and the ring's other copies only once the cluster has its
//   maxima: x's loads then do not queue behind the weight stream (on an
//   H100 the last maxima came 4-8 us late behind it, and each cluster
//   waited for its last), and its values stay in registers between the
//   passes.
// - Products: mma.sync.m16n8k32.s8 on the tensor cores with the weights
//   as A (16 output columns) and x as B (8 rows, by ldmatrix): at m <= 8
//   half the products of x as A's 16 rows. A stage's packed row p holds K
//   rows k (low nibble) and k + 256 (high nibble), so one load feeds two
//   products. Consumer warp w owns 32 columns (w % 4) and half the
//   stage's four 32-row groups (w / 4); in a group, lane (g, t) loads one
//   word (4 columns) from each of the rows {2t, 2t + 1, 2t + 8, 2t + 9}
//   and the same + 16, a pattern that hits 32 distinct banks under the
//   swizzle; __byte_perm turns each 4 x 4 byte group around so that a word
//   holds four K values of one column (the A fragment's rows g and g + 8
//   are two of the lane's four columns), and two bit operations make it 16
//   times the signed nibbles: low ((w << 4) & 0xF0..) ^ 0x80.. (offset
//   binary), high w & 0xF0... The int32 sums are 16 times the true ones,
//   exact (|sum| < 2^31 for K < 132,104; the wrapper allows Kp <=
//   131,072); x is stored in the same permuted K order, so each mma's k
//   index pairs the same K row on both sides.
// - Combine: block r owns the r-th share of the slab's outputs. The two
//   halves' int32 partials are added in the block, each sum stored in its
//   owner's shared memory (a slot a block), one cluster barrier, then each
//   block adds its share's slots in rank order (exact in any order),
//   shifts out the factor 16 and writes (float(acc) * sa) * sw with
//   __fmul_rn: the plain version's order, so out equals it bit for bit.
//   No global workspace, counter or atomic: a graph replays it as is.
//   (Reading the peers' partials through distributed shared memory took
//   a second barrier; remote adds, red.shared::cluster, ran no faster.)
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace htog {
namespace fq {

constexpr int SLAB = 128;            // output columns a cluster
constexpr int PACK_ROWS = 128;       // packed rows a stage
constexpr int STAGE = SLAB * PACK_ROWS;   // 16 KB
constexpr int ST = 4;                // stages of the ring
constexpr int CONSUMER_WARPS = 2 * SLAB / 32;   // two halves of a stage
constexpr int THREADS = 32 * CONSUMER_WARPS + 32;   // and a producer warp
constexpr int MAX_CLUSTER = 8;
constexpr int ROW_PAD = 16;          // bytes after a row of quantized x
constexpr int SMEM_LIMIT = 232448;
constexpr int ROWS = 8;              // rows of x a block (an mma's n)

// Stages of K rows: pack block b's halves h with K rows from
// 512 b + 128 h below K (w4a8_wgmma.cuh's count).
__host__ __device__ __forceinline__ int stages(int K) {
  int rest = K % 512;
  return 2 * (K / 512) + (rest > 128 ? 2 : rest > 0 ? 1 : 0);
}

// The first K row of stage s's low (part 0) or high (part 1) nibbles.
__device__ __forceinline__ int k_base(int s, int part) {
  return 512 * (s >> 1) + 128 * (s & 1) + 256 * part;
}

// Byte offset of row r, column c of a stage (128-byte lines, the 16-byte
// chunk index XORed with r mod 8; the stage is 1024-byte aligned).
__device__ __forceinline__ int swz(int r, int c) {
  return r * SLAB + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

// The mma k index (0..31) that carries row rho (0..31) of a 32-row group:
// lane t's B words hold rows {2t, 2t + 1, 2t + 8, 2t + 9} (+ 16 for its
// second register) in that order.
__device__ __forceinline__ int k_slot(int rho) {
  int r = rho & 15;
  return (rho & 16) + 4 * ((r & 7) >> 1) + 2 * (r >> 3) + (r & 1);
}

// rows r[0..3] (bytes = four columns) -> col[c] = the four rows' bytes of
// column c (the K1 transpose, int8_mma.cuh)
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4],
                                             uint32_t (&col)[4]) {
  uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
  uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
  uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
  uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
  col[0] = __byte_perm(lo01, lo23, 0x5410);
  col[1] = __byte_perm(lo01, lo23, 0x7632);
  col[2] = __byte_perm(hi01, hi23, 0x5410);
  col[3] = __byte_perm(hi01, hi23, 0x7632);
}

// 16 x the signed low nibbles (offset binary: (u ^ 8) is u - 8 in two's
// complement) and 16 x the signed high nibbles, four bytes at once.
__device__ __forceinline__ uint32_t lo16(uint32_t w) {
  return ((w << 4) & 0xF0F0F0F0u) ^ 0x80808080u;
}
__device__ __forceinline__ uint32_t hi16(uint32_t w) {
  return w & 0xF0F0F0F0u;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                 uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  return remote;
}

// *p = v in block `rank`'s shared memory (a cluster barrier's release
// orders it)
__device__ __forceinline__ void st_cluster_s32(void* p, uint32_t rank,
                                               int v) {
  asm volatile("st.shared::cluster.s32 [%0], %1;\n" ::"r"(
                   cluster_addr(p, rank)),
               "r"(v)
               : "memory");
}

struct Params {
  const float* x;
  const float* sw;
  float* out;
  int M, N, K, ldx;
  int S;     // stages(K)
  int spc;   // most stages of a block: ceil(S / CL)
};

// Bytes of a row of quantized x: the most stages of a block, 256 K rows
// each, and the pad that puts ldmatrix's 8 rows on 8 distinct bank
// groups.
__host__ __device__ __forceinline__ int row_bytes(int spc) {
  return spc * 2 * PACK_ROWS + ROW_PAD;
}

// The outputs a block sums for its cluster: a 1 / CL share of the slab's.
__host__ __device__ __forceinline__ int share(int rows, int CL) {
  return (rows * SLAB + CL - 1) / CL;
}

// Dynamic shared memory: the 1024-byte alignment, the ring, `rows` rows of
// quantized x, then the cluster's CL partials of the block's share.
inline int smem_bytes(int rows, int spc, int CL) {
  return wg::ATOM + ST * STAGE + rows * row_bytes(spc) +
         4 * CL * share(rows, CL);
}

// Three blocks an SM (72 registers a thread): at two, the 344 blocks of a
// 4,096 -> 11,008 call took two waves on an H100.
__global__ void __launch_bounds__(THREADS, 3)
    gemv_fq(const __grid_constant__ CUtensorMap tp, Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = wg::align_1024(smem_raw);
  int8_t* qa = reinterpret_cast<int8_t*>(ring + ST * STAGE);
  __shared__ uint64_t full[ST], empty[ST];
  // the block's row maxima, then every block's ([CL][ROWS]), and scales
  __shared__ float amax_s[ROWS], amax_all[MAX_CLUSTER][ROWS], scale_s[ROWS];
  __shared__ __align__(16) int8_t zeros[64];

  const int CL = static_cast<int>(gridDim.x);
  const uint32_t rank = cluster_rank();
  const int n0 = blockIdx.y * SLAB;
  const int row0 = blockIdx.z * ROWS;
  const int rows = min(ROWS, p.M - row0);
  const int s0 = static_cast<int>(rank) * p.S / CL;
  const int nst = (static_cast<int>(rank) + 1) * p.S / CL - s0;
  const int rowb = row_bytes(p.spc);
  const int own = share(rows, CL);
  // [CL][own]: block c's partials of this block's share
  int* parts = reinterpret_cast<int*>(qa + rows * rowb);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  if (threadIdx.x < 16) reinterpret_cast<uint32_t*>(zeros)[threadIdx.x] = 0;
  if (threadIdx.x < ROWS) amax_s[threadIdx.x] = 0.0f;
  __syncthreads();

  auto load = [&](int q) {
    uint64_t* bar = &full[q % ST];
    mbar_arrive_expect_tx(bar, STAGE);
    wg::tma_2d(ring + (q % ST) * STAGE, &tp, n0, (s0 + q) * PACK_ROWS, bar);
  };
  const bool producer = warp == CONSUMER_WARPS;

  // The block's slice of row r: runs u of 128 K rows (stage s0 + u / 2's
  // low nibbles' rows for u even, its high ones' for u odd), lane l taking
  // K rows 32 j + l of each run (j = 0..3: group j of the stage, mma k
  // index k_slot(l)). An item is a row's chunk of CHUNK of a lane's values
  // (four runs), loaded together so that their latencies overlap; the
  // warps take the items in turn.
  constexpr int CHUNK = 16;
  float v[CHUNK];
  const int chunks = (2 * nst + CHUNK / 4 - 1) / (CHUNK / 4);
  const int items = rows * chunks;
  auto load_item = [&](int it) {
    const int c = it % chunks;
    const float* xr = p.x + static_cast<size_t>(row0 + it / chunks) * p.ldx;
#pragma unroll
    for (int e = 0; e < CHUNK; ++e) {
      int u = c * (CHUNK / 4) + e / 4;
      int k = k_base(s0 + (u >> 1), u & 1) + 32 * (e & 3) + lane;
      v[e] = u < 2 * nst && k < p.K ? __ldg(xr + k) : 0.0f;
    }
  };
  // one item a warp at most: loaded before the stream, held for pass (2)
  const bool held = items <= CONSUMER_WARPS;
  if (!producer && warp < items) load_item(warp);
  __syncthreads();
  if (producer && lane == 0) {
    for (int q = 0; q < min(held ? 1 : ST, nst); ++q) load(q);
  }
  // (1) the absmax of the block's slice of each row
  if (!producer) {
    for (int it = warp; it < items; it += CONSUMER_WARPS) {
      if (it != warp) load_item(it);
      float m = 0.0f;
#pragma unroll
      for (int e = 0; e < CHUNK; ++e) m = fmaxf(m, fabsf(v[e]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      }
      // non-negative floats order as their bits
      if (lane == 0) {
        atomicMax(reinterpret_cast<int*>(&amax_s[it / chunks]),
                  __float_as_int(m));
      }
    }
  }
  // each block's maxima stored in every block (the barrier's release
  // orders the stores), so that none is read remotely after it
  __syncthreads();
  if (threadIdx.x < CL * rows) {
    int c = threadIdx.x / rows;
    int r = threadIdx.x % rows;
    st_cluster_s32(&amax_all[rank][r], c, __float_as_int(amax_s[r]));
  }
  cluster_sync();   // every block's maxima are in place
  auto row_scale = [&](int r) {
    float amax = 0.0f;
    for (int c = 0; c < CL; ++c) amax = fmaxf(amax, amax_all[c][r]);
    return __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  };
  if (producer) {
    if (lane == 0 && held) {
      for (int q = 1; q < min(ST, nst); ++q) load(q);
    }
    for (int r = 0; r < rows; ++r) {
      float scale = row_scale(r);
      if (lane == 0) scale_s[r] = scale;
    }
  }
  // (2) the slice quantized, in the products' K order: run u's K row
  // 32 j + l is step (4 * (u / 2) + j) * 2 + u % 2, byte k_slot(l)
  if (!held) __syncthreads();   // scale_s
  if (!producer) {
    const int slot = k_slot(lane);
    for (int it = warp; it < items; it += CONSUMER_WARPS) {
      const int r = it / chunks;
      const int c = it % chunks;
      if (!held) load_item(it);
      // one item a warp: its own scale, without waiting for the block
      float scale = held ? row_scale(r) : scale_s[r];
      int8_t* qr = qa + r * rowb + slot;
#pragma unroll
      for (int e = 0; e < CHUNK; ++e) {
        int u = c * (CHUNK / 4) + e / 4;
        if (u < 2 * nst) {
          int q = __float2int_rn(__fdiv_rn(v[e], scale));  // half to even
          q = min(max(q, -127), 127);
          int step = (4 * (u >> 1) + (e & 3)) * 2 + (u & 1);
          qr[step * 32] = static_cast<int8_t>(q);
        }
      }
    }
  }
  __syncthreads();

  int acc[2][4] = {};
  const int wc = warp & 3;     // this warp's 32 columns of the slab
  const int half = warp >> 2;  // and its groups of a stage: 2 half, + 1
  if (producer) {
    if (lane == 0) {
      for (int q = ST; q < nst; ++q) {
        wg::wait(&empty[q % ST], ((q / ST) - 1) & 1);
        load(q);
      }
    }
  } else {
    const int g = lane >> 2;
    const int t = lane & 3;
    const int col = wc * 32 + 4 * g;   // this lane's four columns
    // ldmatrix.x4: lane l addresses x row l % 8, bytes 16 (l / 8) of the
    // low nibbles' step and the high ones' after it (b0, b1 of each); rows
    // past `rows` read the zero row at every step
    const bool live = (lane & 7) < rows;
    const int8_t* brow = (live ? qa + (lane & 7) * rowb : zeros) +
                         16 * (lane >> 3);
    const int bstep = live ? 32 : 0;
    for (int q = 0; q < nst; ++q) {
      wg::wait(&full[q % ST], (q / ST) & 1);
      const uint8_t* stage = ring + (q % ST) * STAGE;
#pragma unroll
      for (int gh = 0; gh < 2; ++gh) {
        const int grp = 2 * half + gh;
        uint32_t w[2][4], b[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            int r = 32 * grp + 16 * h + 2 * t + (j & 1) + 8 * (j >> 1);
            w[h][j] = *reinterpret_cast<const uint32_t*>(stage + swz(r, col));
          }
        transpose4x4(w[0], b[0]);
        transpose4x4(w[1], b[1]);
        int step = (4 * q + grp) * 2;   // low nibbles; + 1 the high ones
        uint32_t bx[4];   // b0, b1 of the low step, then of the high
        ldmatrix_x4(bx, brow + step * bstep);
        uint32_t blo[2] = {bx[0], bx[1]};
        uint32_t bhi[2] = {bx[2], bx[3]};
        // A of column pair pc: rows g, g + 8 are columns 4g + 2pc, + 1
#pragma unroll
        for (int pc = 0; pc < 2; ++pc) {
          uint32_t alo[4] = {lo16(b[0][2 * pc]), lo16(b[0][2 * pc + 1]),
                             lo16(b[1][2 * pc]), lo16(b[1][2 * pc + 1])};
          uint32_t ahi[4] = {hi16(b[0][2 * pc]), hi16(b[0][2 * pc + 1]),
                             hi16(b[1][2 * pc]), hi16(b[1][2 * pc + 1])};
          mma_s8(acc[pc], alo, blo);
          mma_s8(acc[pc], ahi, bhi);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[q % ST]);
    }
  }
  // (3) the partials (16 x the int32 sums): the second half's warps leave
  // theirs in the ring (every stage is used), the first half's add them to
  // their own and store the sums in their owners' parts; D's row g (+ 8)
  // of pair pc is column 4g + 2pc (+ 1), its column 2t (+ 1) x row 2t (+ 1)
  __syncthreads();
  int* other = reinterpret_cast<int*>(ring) + (wc * 32 + lane) * 8;
  if (!producer && half == 1) {
#pragma unroll
    for (int pc = 0; pc < 2; ++pc)
#pragma unroll
      for (int e = 0; e < 4; ++e) other[pc * 4 + e] = acc[pc][e];
  }
  __syncthreads();
  if (!producer && half == 0) {
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int pc = 0; pc < 2; ++pc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r = 2 * t + (e & 1);
        int el = r * SLAB + wc * 32 + 4 * g + 2 * pc + (e >> 1);
        if (r < rows) {
          int owner = el / own;
          st_cluster_s32(&parts[rank * own + el - owner * own], owner,
                         acc[pc][e] + other[pc * 4 + e]);
        }
      }
  }
  cluster_sync();   // every block's partials are in their owners' parts
  const int e0 = static_cast<int>(rank) * own;
  for (int i = threadIdx.x; i < own && e0 + i < rows * SLAB; i += THREADS) {
    int sum = 0;
    for (int c = 0; c < CL; ++c) sum += parts[c * own + i];
    int r = (e0 + i) / SLAB;
    int n = n0 + (e0 + i) % SLAB;
    if (n < p.N) {
      p.out[static_cast<size_t>(row0 + r) * p.N + n] =
          __fmul_rn(__fmul_rn(__int2float_rn(sum >> 4), scale_s[r]),
                    __ldg(p.sw + n));
    }
  }
}

}  // namespace fq
}  // namespace htog

// x (M, K) float32 rows ldx apart; packed (Kp/2, ldp) int8, Kp a multiple
// of 512 with K <= Kp <= 131,072, ldp a multiple of 16 >= N, base 16-byte
// aligned; sw (1, N) and out (M, N) float32 contiguous; M <= 64. cluster
// (1, 2, 4 or 8) blocks split each slab's K (ops/int4.gemv_plan). One
// launch; returns its error.
extern "C" int w4a8_gemv_fq(const void* x, const void* packed,
                            const void* sw, void* out, int M, int N, int K,
                            int ldx, int Kp, int ldp, int cluster,
                            void* stream) {
  using namespace htog::fq;
  if (M < 1 || M > 64 || N < 1 || K < 1 || K > Kp || Kp % 512 ||
      Kp > 131072 || ldp % 16 || ldp < N || cluster < 1 ||
      cluster > MAX_CLUSTER || (cluster & (cluster - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // boxes of PACK_ROWS rows x SLAB bytes, zeros past N and past Kp / 2
  CUtensorMap map;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                        static_cast<cuuint64_t>(Kp / 2)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldp)};
  cuuint32_t box[2] = {SLAB, PACK_ROWS};
  if (!htog::wg::make_map(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, packed,
                          dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const float*>(x);
  p.sw = static_cast<const float*>(sw);
  p.out = static_cast<float*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.ldx = ldx;
  p.S = stages(K);
  p.spc = (p.S + cluster - 1) / cluster;
  int rows = M < ROWS ? M : ROWS;
  int bytes = smem_bytes(rows, p.spc, cluster);
  if (bytes > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  static int configured = 0;   // the dynamic shared memory allowed so far
  if (bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        gemv_fq, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (N + SLAB - 1) / SLAB, (M + ROWS - 1) / ROWS);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, gemv_fq, map, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
