// Kernel 3 w4a8_gemv_fq: y = f32(quantize(x) @ decode(P) as int32) *
// sa[i] * sw[j] for a few float rows x (m <= 64): the W4A8 serving linear
// at decode widths, with the activation quantization fused in.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_int4.py,
// _kernel_w4a8_noc_gemv_fq (via mmult_w4a8_fused_noc;
// models/linear.apply_linear at m <= 64). x (M, Kp) float32, zero-padded
// by the wrapper to Kp = round_up(K, 512) (zero columns change no row
// maximum), P (Kp/2, ldp) int8 packed nibbles (w4a8.cuh), sw (1, N)
// float32, out (M, N) float32; qa (M, Kp) int8 and sa (M) float32 are
// scratch the wrapper allocates.
//
// Bound on an H100 SXM, at a Llama-2-7B decode shape (M = 4, K = 4096,
// N = 11008): 22.5 MB of packed weights against 3.6e8 int operations;
// 6.7 us at 3.35 TB/s, so the weight stream bounds it, as for every GEMV.
//
// Design, two kernels behind one entry point on one stream:
// 1. quantize: one block per row. The row's absmax (a max, exact in any
//    order), then scale = max(amax, 1e-8) / 127 and
//    q = clip(rint(x / scale), -127, 127), with IEEE division
//    (__fdiv_rn, no reciprocal) and round half to even: the same bytes
//    as ops/quant.quantize_symmetric. The TPU kernel quantizes once under
//    (kk == 0) & (j == 0) and relies on its grid running in order; CUDA
//    blocks run in no order, so the quantization is a pass of its own.
// 2. GEMV on the CUDA cores with __dp4a: each block owns 32 output
//    columns and 4 rows of x; its 256 threads are 8 column words x 32
//    K slices. A thread loads four packed rows of one word (4 K rows x 4
//    columns, twice: the low and the high nibbles), decodes them with two
//    SIMD byte ops, transposes the 4x4 bytes with __byte_perm so that each
//    column's four K values share a word, and takes one __dp4a per row of
//    x and column. The K slices are summed in shared memory (int32,
//    exact), then the epilogue (float(acc) * sa) * sw, written with
//    __fmul_rn, makes the result equal the plain version bit for bit.
//    The integer sum equals the reference's pack-algebra form
//    ((d1 - d3) >> 4) + d2 - 8 * rowsum, which is the same exact sum.
// Simple first version: no shared-memory staging of P, no split of K
// across blocks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "w4a8.cuh"

namespace {

constexpr int QUANT_THREADS = 256;
constexpr int THREADS = 256;
constexpr int WORDS = 8;               // column words per block
constexpr int COLS = WORDS * 4;        // 32 output columns per block
constexpr int KSLICES = THREADS / WORDS;
constexpr int MT = 4;                  // rows of x per block

__global__ void __launch_bounds__(QUANT_THREADS)
    quantize_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ qa,
                         float* __restrict__ sa, int Kp) {
  __shared__ float warp_max[QUANT_THREADS / 32];
  const float* row = x + (size_t)blockIdx.x * Kp;
  float amax = 0.0f;
  for (int k = threadIdx.x * 4; k < Kp; k += QUANT_THREADS * 4) {
    float4 v = *reinterpret_cast<const float4*>(row + k);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                             fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
  for (int w = 1; w < QUANT_THREADS / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  if (threadIdx.x == 0) sa[blockIdx.x] = scale;
  int8_t* qrow = qa + (size_t)blockIdx.x * Kp;
  for (int k = threadIdx.x * 4; k < Kp; k += QUANT_THREADS * 4) {
    float4 v = *reinterpret_cast<const float4*>(row + k);
    float e[4] = {v.x, v.y, v.z, v.w};
    uint32_t packed = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int q = __float2int_rn(__fdiv_rn(e[i], scale));  // half to even
      q = min(max(q, -127), 127);
      packed |= (uint32_t)(q & 0xFF) << (8 * i);
    }
    *reinterpret_cast<uint32_t*>(qrow + k) = packed;
  }
}

// rows r[0..3] (four consecutive K rows, bytes = four columns) ->
// col[c] = the four K values of column c (the K1 transpose, int8_mma.cuh)
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

__global__ void __launch_bounds__(THREADS)
    gemv_kernel(const int8_t* __restrict__ qa, const float* __restrict__ sa,
                const int8_t* __restrict__ packed,
                const float* __restrict__ sw, float* __restrict__ out, int M,
                int N, int Kp, int ldp) {
  __shared__ int red[KSLICES][MT][COLS];
  int cw = threadIdx.x % WORDS;
  int ks = threadIdx.x / WORDS;
  int n0 = blockIdx.x * COLS;
  int m0 = blockIdx.y * MT;
  int n = n0 + cw * 4;
  bool ncol = n < N;   // the word's four columns lie inside the pitch
  int acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0;

  int nquads = Kp / 8;   // groups of four packed rows
  if (ncol) {
#pragma unroll 2
    for (int q = ks; q < nquads; q += KSLICES) {
      int prow = q * 4;                         // packed row, 4 | prow
      int k_lo = (prow >> 8) * 512 + (prow & 255);
      int k_hi = k_lo + 256;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = *reinterpret_cast<const uint32_t*>(
            packed + (size_t)(prow + i) * ldp + n);
      }
      uint32_t lo[4], hi[4], lo_t[4], hi_t[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = htog::decode_lo4(w[i]);
        hi[i] = htog::decode_hi4(w[i]);
      }
      transpose4x4(lo, lo_t);
      transpose4x4(hi, hi_t);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m0 + m >= M) break;
        const int8_t* arow = qa + (size_t)(m0 + m) * Kp;
        int a_lo = *reinterpret_cast<const int*>(arow + k_lo);
        int a_hi = *reinterpret_cast<const int*>(arow + k_hi);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[m][c] = __dp4a(a_lo, static_cast<int>(lo_t[c]), acc[m][c]);
          acc[m][c] = __dp4a(a_hi, static_cast<int>(hi_t[c]), acc[m][c]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[ks][m][cw * 4 + c] = acc[m][c];
  __syncthreads();
  for (int e = threadIdx.x; e < MT * COLS; e += THREADS) {
    int m = e / COLS;
    int col = e % COLS;
    int row = m0 + m;
    int j = n0 + col;
    if (row >= M || j >= N) continue;
    int sum = 0;
    for (int s = 0; s < KSLICES; ++s) sum += red[s][m][col];
    out[(size_t)row * N + j] =
        __fmul_rn(__fmul_rn(__int2float_rn(sum), sa[row]), sw[j]);
  }
}

}  // namespace

// x (M, Kp) float32 and qa (M, Kp) int8 contiguous, Kp a multiple of 512,
// all bases 16-byte aligned; ldp a multiple of 16 and >= N. Two launches
// on one stream; returns the first error.
extern "C" int w4a8_gemv_fq(const void* x, const void* packed,
                            const void* sw, void* qa, void* sa, void* out,
                            int M, int N, int Kp, int ldp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  quantize_rows_kernel<<<M, QUANT_THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(qa),
      static_cast<float*>(sa), Kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + COLS - 1) / COLS, (M + MT - 1) / MT);
  gemv_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const int8_t*>(qa), static_cast<const float*>(sa),
      static_cast<const int8_t*>(packed), static_cast<const float*>(sw),
      static_cast<float*>(out), M, N, Kp, ldp);
  return static_cast<int>(cudaGetLastError());
}
