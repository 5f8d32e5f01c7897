// w4a16_gemv: out = (A @ decode(P)) * sw[j] for a few bf16 rows A
// (m <= 64), fp32 sums: the W4A16 serving linear at decode widths.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_int4.py, _kernel_noc_gemv
// (via mmult_q_noc at m <= 64; models/linear.apply_linear for int4
// weights in decode). The TPU kernel splits the nibbles on its matrix unit
// by pack algebra, (A_hi P - A_hi u) / 16 + A_lo u - 8 rowsum(A_lo) with
// u = P & 15; that is a trick for the TPU's matrix unit, and what it
// computes, A @ decode(P), is what is ported. A (M, lda) bf16 with K <= Kp
// valid columns (columns >= K count as zero), P (Kp/2, ldp) int8 packed
// nibbles (w4a8.cuh), sw (1, N) float32, out (M, N) float32.
//
// Bound on an H100 SXM, at a Llama-2-7B decode shape (M = 4, K = 4096,
// N = 11008): 22.5 MB of packed weights against 3.6e8 operations; 6.7 us
// at 3.35 TB/s, so the weight stream bounds it, as for every GEMV.
//
// Design: each packed byte is read once. A block owns 32 output columns
// and 4 rows of A; its 256 threads are 8 column words x 32 K slices. The
// block walks K in chunks of 1024 rows (two pack blocks): the chunk of its
// 4 A rows is staged in shared memory as fp32 (zero past K and past M),
// then each thread takes groups of four packed rows of its column word
// (4 K rows in the low nibbles, the 4 rows 256 further in the high ones),
// turns each nibble into an exact float with integer ops and one float
// subtraction (0x4B000000 | u is 2^23 + u), and multiply-adds it with the
// staged A values in fp32 on the CUDA cores. The K slices are summed in
// shared memory at the end, then out = sum * sw (__fmul_rn). The sums run
// in another order than the plain version's, which agrees to a stated
// tolerance. Simple first version: no split of K across blocks, so N =
// 4096 gives 128 blocks for 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WORDS = 8;               // column words per block
constexpr int COLS = WORDS * 4;        // 32 output columns per block
constexpr int KSLICES = THREADS / WORDS;
constexpr int MT = 4;                  // rows of A per block
constexpr int KC = 1024;               // K rows staged per pass
constexpr float MAGIC = 8388608.0f;    // 2^23

// nibble u in [0, 15] (offset binary) -> float(u - 8), exact
__device__ __forceinline__ float nib(uint32_t u) {
  return __int_as_float(0x4B000000 | u) - (MAGIC + 8.0f);
}

__global__ void __launch_bounds__(THREADS)
    w4a16_gemv_kernel(const __nv_bfloat16* __restrict__ a,
                      const int8_t* __restrict__ packed,
                      const float* __restrict__ sw, float* __restrict__ out,
                      int M, int N, int K, int Kp, int lda, int ldp) {
  __shared__ __align__(16) float xs[MT][KC];
  __shared__ float red[KSLICES][MT][COLS];
  int cw = threadIdx.x % WORDS;
  int ks = threadIdx.x / WORDS;
  int n0 = blockIdx.x * COLS;
  int m0 = blockIdx.y * MT;
  int n = n0 + cw * 4;
  bool ncol = n < N;   // the word's four columns lie inside the pitch
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.0f;

  for (int kc0 = 0; kc0 < Kp; kc0 += KC) {
    for (int e = threadIdx.x; e < MT * KC; e += THREADS) {
      int m = e / KC;
      int gk = kc0 + e % KC;
      float v = 0.0f;
      if (m0 + m < M && gk < K) {
        v = __bfloat162float(a[(size_t)(m0 + m) * lda + gk]);
      }
      xs[m][e % KC] = v;
    }
    __syncthreads();
    int nquads = min(KC, Kp - kc0) / 8;   // groups of four packed rows
    if (ncol) {
#pragma unroll 2
      for (int q = ks; q < nquads; q += KSLICES) {
        int lprow = q * 4;                       // packed row in the chunk
        int prow = kc0 / 2 + lprow;
        int k_lo = (lprow >> 8) * 512 + (lprow & 255);   // in the chunk
        int k_hi = k_lo + 256;
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          w[i] = *reinterpret_cast<const uint32_t*>(
              packed + (size_t)(prow + i) * ldp + n);
        }
        float wl[4][4], wh[4][4];   // [K row i][column c]
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            uint32_t byte = w[i] >> (8 * c);
            wl[i][c] = nib(byte & 0xFu);
            wh[i][c] = nib(((byte >> 4) & 0xFu) ^ 0x8u);
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float4 xl = *reinterpret_cast<const float4*>(&xs[m][k_lo]);
          float4 xh = *reinterpret_cast<const float4*>(&xs[m][k_hi]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float s = acc[m][c];
            s = fmaf(xl.x, wl[0][c], s);
            s = fmaf(xl.y, wl[1][c], s);
            s = fmaf(xl.z, wl[2][c], s);
            s = fmaf(xl.w, wl[3][c], s);
            s = fmaf(xh.x, wh[0][c], s);
            s = fmaf(xh.y, wh[1][c], s);
            s = fmaf(xh.z, wh[2][c], s);
            s = fmaf(xh.w, wh[3][c], s);
            acc[m][c] = s;
          }
        }
      }
    }
    __syncthreads();
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
    float sum = 0.0f;
    for (int s = 0; s < KSLICES; ++s) sum += red[s][m][col];
    out[(size_t)row * N + j] = __fmul_rn(sum, sw[j]);
  }
}

}  // namespace

// A (M, lda) bf16 with K <= lda valid columns, K <= Kp, Kp a multiple of
// 512; P (Kp/2, ldp) int8 with ldp a multiple of 16, >= N, its base 16-byte
// aligned; out (M, N) float32. Returns cudaGetLastError() after the launch.
extern "C" int w4a16_gemv(const void* a, const void* packed, const void* sw,
                          void* out, int M, int N, int K, int Kp, int lda,
                          int ldp, void* stream) {
  dim3 grid((N + COLS - 1) / COLS, (M + MT - 1) / MT);
  w4a16_gemv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const int8_t*>(packed), static_cast<const float*>(sw),
      static_cast<float*>(out), M, N, K, Kp, lda, ldp);
  return static_cast<int>(cudaGetLastError());
}
