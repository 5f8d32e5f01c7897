// w4a16_gemv: out = (A @ decode(P)) * sw[j] for a few bf16 rows A
// (m <= 64), fp32 sums: the W4A16 serving linear at decode widths, in one
// launch.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_int4.py, _kernel_noc_gemv
// (via mmult_q_noc at m <= 64; models/linear.apply_linear for int4
// weights in decode). The TPU kernel splits the nibbles on its matrix unit
// by pack algebra, (A_hi P - A_hi u) / 16 + A_lo u - 8 rowsum(A_lo) with
// u = P & 15; that is a trick for the TPU's matrix unit, and what it
// computes, A @ decode(P), is what is ported. A (M, lda) bf16 read at its
// own K (the columns K .. Kp - 1 count as zeros), P (Kp/2, ldp) int8
// packed nibbles (w4a8.cuh), sw (1, N) float32, out (M, N) float32.
//
// Bound on an H100 SXM, at a Llama-2-7B decode shape (M = 4, K = 4096,
// N = 11008): 22.5 MB of packed weights against 3.6e8 operations; 6.7 us
// at 3.35 TB/s, so the weight stream bounds it, as for every GEMV.
//
// Design: w4a8_gemv_fq.cu's walk with bf16 products. One launch, a grid of
// thread-block clusters. A cluster owns a slab of SLAB output columns and
// a group of at most 8 rows of A (more rows take more groups, each
// streaming the slab again, mostly from L2); its CL blocks split the
// slab's K: block r takes the stages [r * S / CL, (r + 1) * S / CL) of the
// S = stages(K) stages of PACK_ROWS packed rows (the host picks CL:
// ops/int4.w4a16_gemv_plan).
// - Stream: warp 8's lane 0 copies each stage's (PACK_ROWS x SLAB) box of
//   the pack by tensor map into a ring of ST 16 KB stages (128-byte
//   swizzle), one mbarrier pair a stage.
// - A: the eight consumer warps load the block's K slice of its rows,
//   16 bytes (8 K values) a load, and store it as bf16 into shared memory
//   in the products' K order: a 16-row group's low-nibble K rows, then its
//   high-nibble ones (64 bytes a row a group), the groups in stage order.
//   Their first loads go out before the first stage's copy, so A's loads
//   do not queue behind the weight stream (w4a8_gemv_fq.cu found them 4-8
//   us late behind it on an H100).
// - Products: mma.sync.m16n8k16 bf16 -> fp32 on the tensor cores with the
//   weights as A (16 output columns) and A's rows as B (8 rows, by
//   ldmatrix). A stage's packed row p holds K rows k (low nibble) and
//   k + 256 (high nibble), so one load feeds two products. Consumer warp w
//   owns 32 columns (w % 4) and half the stage's eight 16-row groups
//   (w / 4); in a group, lane (g, t) loads one word (4 columns) from each
//   of the rows 2t, 2t + 1, 2t + 8, 2t + 9 (32 distinct banks under the
//   swizzle), which are the mma's k indices 2t, 2t + 1, 2t + 8, 2t + 9 as
//   they stand; __byte_perm pairs a column's bytes of two rows and bit
//   operations make the bf16 pairs (w4a16_wgmma.cuh: (b & 0xF) | 0x4300 is
//   128 + u, minus 136 is u - 8; the high nibble ^ 8 first). The A
//   fragment's rows g and g + 8 are two of the lane's four columns.
// - Combine: every block's fp32 partials go, after a cluster barrier that
//   frees every ring, into their owner's ring (block r owns the r-th share
//   of the slab's outputs; a slot a block and half; a lane's four columns
//   of a row one 16-byte store: on an H100 that took 0.0139 -> 0.0127 ms
//   at m = 4, 4,096 -> 11,008 against a store a sum, and adding the
//   halves in the block first ran no faster), one more cluster barrier,
//   then each owner adds its share's 2 CL slots in a fixed order and
//   writes __fmul_rn(sum, sw[j]). No global workspace, counter or
//   atomic, so two calls and a graph replay give the same bits. The sums
//   run in another order than the plain version's (and the tensor cores
//   do not round each add as IEEE does), so the two agree to a stated
//   tolerance.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "w4a16_wgmma.cuh"

namespace htog {
namespace gv {

constexpr int SLAB = 128;            // output columns a cluster
constexpr int PACK_ROWS = 128;       // packed rows a stage
constexpr int STAGE = SLAB * PACK_ROWS;   // 16 KB
constexpr int ST = 4;                // stages of the ring
constexpr int CONSUMER_WARPS = 2 * SLAB / 32;   // two halves of a stage
constexpr int THREADS = 32 * CONSUMER_WARPS + 32;   // and a producer warp
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;
constexpr int MAX_CLUSTER = 8;
constexpr int ROWS = 8;              // rows of A a block (an mma's n)
constexpr int GROUP_BYTES = 64;      // a row's low and high K of a group
constexpr int ROW_PAD = 16;          // bytes after a row of A
constexpr int X_ITEMS = 8;           // A's 16-byte loads a thread at once
constexpr int SMEM_LIMIT = 232448;

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

// Bytes of a row of A in shared memory: the most stages of a block, eight
// groups each, and the pad that puts ldmatrix's 8 rows on 8 distinct bank
// groups.
__host__ __device__ __forceinline__ int row_bytes(int spc) {
  return spc * 8 * GROUP_BYTES + ROW_PAD;
}

// The outputs a block sums for its cluster: a 1 / CL share of the slab's.
__host__ __device__ __forceinline__ int share(int rows, int CL) {
  return (rows * SLAB + CL - 1) / CL;
}

// Dynamic shared memory: the 1024-byte alignment, the ring (which the
// combine reuses for the partials), then `rows` rows of A.
inline int smem_bytes(int rows, int spc) {
  return wg::ATOM + ST * STAGE + rows * row_bytes(spc);
}
// 2 CL shares of at most rows * SLAB / CL + 1 floats
static_assert(4 * 2 * (ROWS * SLAB + MAX_CLUSTER) <= ST * STAGE,
              "the partials fit the ring");

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// p[0..3] = v0..v3 in block `rank`'s shared memory, one 16-byte store (p
// 16-byte aligned; a cluster barrier's release orders it)
__device__ __forceinline__ void st_cluster_v4(float* p, uint32_t rank,
                                              float v0, float v1, float v2,
                                              float v3) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   remote),
               "f"(v0), "f"(v1), "f"(v2), "f"(v3)
               : "memory");
}

struct Params {
  const __nv_bfloat16* a;
  const float* sw;
  float* out;
  int M, N, K, lda;
  int S;     // stages(K)
  int spc;   // most stages of a block: ceil(S / CL)
};

// Three blocks an SM where their shared memory allows (at 4 rows of A and
// up to 4 stages a block).
__global__ void __launch_bounds__(THREADS, 3)
    gemv_w4a16(const __grid_constant__ CUtensorMap tp, Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = wg::align_1024(smem_raw);
  uint8_t* xs = ring + ST * STAGE;
  __shared__ uint64_t full[ST], empty[ST];

  const int CL = static_cast<int>(gridDim.x);
  const uint32_t rank = cluster_rank();
  const int n0 = blockIdx.y * SLAB;
  const int row0 = blockIdx.z * ROWS;
  const int rows = min(ROWS, p.M - row0);
  const int s0 = static_cast<int>(rank) * p.S / CL;
  const int nst = (static_cast<int>(rank) + 1) * p.S / CL - s0;
  const int rowb = row_bytes(p.spc);
  const int own = share(rows, CL);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool producer = warp == CONSUMER_WARPS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }

  // The block's slice of row r in items of 8 K values: item e is K rows
  // k_base(s0 + u / 2, u % 2) + 8 (e % 16) .. + 7 for run u = e / 16 (the
  // low nibbles' 128 K rows of local stage u / 2 for u even, the high
  // ones' for u odd), stored at byte ((u / 2) * 8 + j) * 64 + (u % 2) * 32
  // + 16 h of the row, j = (e % 16) / 2, h = e % 2. A thread takes the
  // items it, it + CONSUMERS, ... of the rows' items in turn.
  const int per_row = 32 * nst;
  const int items = rows * per_row;
  const bool vec = (p.lda & 7) == 0 &&
                   (reinterpret_cast<uintptr_t>(p.a) & 15) == 0;
  uint4 v[X_ITEMS];
  auto load_x = [&](int first) {
#pragma unroll
    for (int i = 0; i < X_ITEMS; ++i) {
      const int it = first + CONSUMERS * i;
      v[i] = make_uint4(0, 0, 0, 0);
      if (it < items) {
        const int e = it % per_row;
        const int u = e >> 4;
        const int k = k_base(s0 + (u >> 1), u & 1) + 8 * (e & 15);
        const __nv_bfloat16* src =
            p.a + static_cast<size_t>(row0 + it / per_row) * p.lda + k;
        if (vec && k + 8 <= p.K) {
          v[i] = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          uint32_t h[8];
#pragma unroll
          for (int c = 0; c < 8; ++c)
            h[c] = k + c < p.K ? __bfloat16_as_ushort(src[c]) : 0u;
          v[i] = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                            h[4] | (h[5] << 16), h[6] | (h[7] << 16));
        }
      }
    }
  };
  auto store_x = [&](int first) {
#pragma unroll
    for (int i = 0; i < X_ITEMS; ++i) {
      const int it = first + CONSUMERS * i;
      if (it < items) {
        const int e = it % per_row;
        const int u = e >> 4;
        const int off = (((u >> 1) * 8 + ((e & 15) >> 1)) * GROUP_BYTES) +
                        (u & 1) * 32 + 16 * (e & 1);
        *reinterpret_cast<uint4*>(xs + (it / per_row) * rowb + off) = v[i];
      }
    }
  };
  if (!producer) load_x(threadIdx.x);
  __syncthreads();   // A's first loads are out before the weight stream

  float acc[2][4] = {};
  const int wc = warp & 3;     // this warp's 32 columns of the slab
  const int half = warp >> 2;  // and its groups of a stage: 4 half .. + 3
  if (producer) {
    if (lane == 0) {
      for (int q = 0; q < nst; ++q) {
        if (q >= ST) wg::wait(&empty[q % ST], ((q / ST) - 1) & 1);
        mbar_arrive_expect_tx(&full[q % ST], STAGE);
        wg::tma_2d(ring + (q % ST) * STAGE, &tp, n0, (s0 + q) * PACK_ROWS,
                   &full[q % ST]);
      }
    }
    __syncwarp();
  } else {
    store_x(threadIdx.x);
    for (int first = threadIdx.x + CONSUMERS * X_ITEMS; first < items;
         first += CONSUMERS * X_ITEMS) {
      load_x(first);
      store_x(first);
    }
    wg::bar_sync(1, CONSUMERS);   // A's slice is in place

    const int g = lane >> 2;
    const int t = lane & 3;
    const int col = wc * 32 + 4 * g;   // this lane's four columns
    int off[4];                        // its words in a 16-row group
#pragma unroll
    for (int j = 0; j < 4; ++j)
      off[j] = swz(2 * t + (j & 1) + 8 * (j >> 1), col);
    // ldmatrix.x4: lane l addresses A row l % 8 (row 0 where that is past
    // `rows`: its products land in sums that are not stored), bytes
    // 16 (l / 8) of a group's 64: the low K rows' b0, b1, the high ones'
    const uint8_t* brow =
        xs + ((lane & 7) < rows ? (lane & 7) : 0) * rowb + 16 * (lane >> 3);
    for (int q = 0; q < nst; ++q) {
      wg::wait(&full[q % ST], (q / ST) & 1);
      const uint8_t* stage = ring + (q % ST) * STAGE;
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
        const int grp = 4 * half + gi;
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = *reinterpret_cast<const uint32_t*>(stage + 16 * grp * SLAB +
                                                    off[j]);
        uint32_t b[4];
        ldmatrix_x4(b, brow + (8 * q + grp) * GROUP_BYTES);
        // A of column pair pc: rows g, g + 8 are columns 4g + 2pc, + 1
#pragma unroll
        for (int pc = 0; pc < 2; ++pc) {
          uint32_t p0 = byte_pair(w[0], w[1], 2 * pc);
          uint32_t p1 = byte_pair(w[0], w[1], 2 * pc + 1);
          uint32_t p2 = byte_pair(w[2], w[3], 2 * pc);
          uint32_t p3 = byte_pair(w[2], w[3], 2 * pc + 1);
          uint32_t alo[4] = {bf16x2_lo(p0), bf16x2_lo(p1), bf16x2_lo(p2),
                             bf16x2_lo(p3)};
          uint32_t ahi[4] = {bf16x2_hi(p0), bf16x2_hi(p1), bf16x2_hi(p2),
                             bf16x2_hi(p3)};
          mma_bf16(acc[pc], alo, b[0], b[1]);
          mma_bf16(acc[pc], ahi, b[2], b[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[q % ST]);
    }
  }
  cluster_sync();   // every block is done with its ring and its A

  // [2 CL][own] in each ring: block c's half h partials of this block's
  // share in slot 2 c + h. D's row g (+ 8) of pair pc is column
  // 4g + 2pc (+ 1), its column 2t (+ 1) A's row 2t (+ 1): a lane's sums
  // of A's row 2t + h are the four columns 4g .. 4g + 3, one 16-byte store
  // (own is a multiple of 16 at clusters of 1, 2, 4 or 8, so the four lie
  // in one share).
  float* parts = reinterpret_cast<float*>(ring);
  if (!producer) {
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int r = 2 * t + h;
      int el = r * SLAB + wc * 32 + 4 * g;
      if (r < rows) {
        int owner = el / own;
        st_cluster_v4(&parts[(2 * rank + half) * own + el - owner * own],
                      owner, acc[0][h], acc[0][2 + h], acc[1][h],
                      acc[1][2 + h]);
      }
    }
  }
  cluster_sync();   // every block's partials are in their owners' rings
  const int e0 = static_cast<int>(rank) * own;
  for (int i = threadIdx.x; i < own && e0 + i < rows * SLAB; i += THREADS) {
    float sum = 0.0f;
    for (int c = 0; c < 2 * CL; ++c) sum = __fadd_rn(sum, parts[c * own + i]);
    int r = (e0 + i) / SLAB;
    int n = n0 + (e0 + i) % SLAB;
    if (n < p.N) {
      p.out[static_cast<size_t>(row0 + r) * p.N + n] =
          __fmul_rn(sum, __ldg(p.sw + n));
    }
  }
}

}  // namespace gv
}  // namespace htog

// a (M, lda) bf16 with K <= lda; packed (Kp/2, ldp) int8, Kp a multiple
// of 512 with K <= Kp, ldp a multiple of 16 >= N, base 16-byte aligned; sw
// (1, N) and out (M, N) float32 contiguous; M <= 64. cluster (1, 2, 4 or
// 8) blocks split each slab's K (ops/int4.w4a16_gemv_plan). One launch;
// returns its error.
extern "C" int w4a16_gemv(const void* a, const void* packed, const void* sw,
                          void* out, int M, int N, int K, int lda, int Kp,
                          int ldp, int cluster, void* stream) {
  using namespace htog::gv;
  if (M < 1 || M > 64 || N < 1 || K < 1 || K > Kp || K > lda || Kp % 512 ||
      ldp % 16 || ldp < N || cluster < 1 || cluster > MAX_CLUSTER ||
      (cluster & (cluster - 1))) {
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
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.sw = static_cast<const float*>(sw);
  p.out = static_cast<float*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.lda = lda;
  p.S = stages(K);
  p.spc = (p.S + cluster - 1) / cluster;
  int rows = M < ROWS ? M : ROWS;
  int bytes = smem_bytes(rows, p.spc);
  if (bytes > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  static int configured = 0;   // the dynamic shared memory allowed so far
  if (bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        gemv_w4a16, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
  cudaError_t err = cudaLaunchKernelEx(&cfg, gemv_w4a16, map, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
