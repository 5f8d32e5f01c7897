// The W4A16 GEMM of w4a16_gemm.cu (rung 07, "+ C" in place; the serving
// linear w4a16_gemm_noc.cu runs w4a16_wgmma.cuh): bf16 A, int4 weights
// decoded to bf16, fp32 accumulation,
//     out[i,j] = acc[i,j] * sw[j] + c[i,j],
// the reference's order (pallas_int4._kernel's flush: acc * s + c),
// written with rounding intrinsics so nvcc cannot contract it into an FMA.
//
// A (M, lda) bf16 row-major, P (Kp/2, N) int8 packed nibbles (w4a8.cuh),
// sw (1, N) float32, c and out (M, ldc) float32 (one buffer for the
// in-place rung: each element is read and written by the same thread). A
// has K <= Kp columns; weight rows >= K are not read.
//
// Design: the int8 kernels' tiling and staging (int8_mma.cuh): 128x128
// output tiles, 256 threads in 8 warps of 64x32, two stages, A through
// cp.async. A 64-byte K step holds 32 bf16 values, and mma.m16n8k16.bf16
// reads its fragments at the same byte offsets as the int8 m16n8k32, so
// the fragment walk is shared (mma_stage). Each thread loads one group
// of 4 K rows x 4 columns of packed bytes, decodes the nibbles (values in
// [-8, 7], exact in bf16) and stores each column's four K values as two
// bf16 pairs, K-major. The products are exact in fp32; the tensor cores
// sum them in another order than the plain version (and do not round each
// add as IEEE does), so the two agree to a stated tolerance. Simple first
// version: mma.sync rather than wgmma/TMA, no warp specialisation.
#pragma once

#include "bf16_gemm.cuh"
#include "w4a8.cuh"

namespace htog {

// This thread's group of the 32(k) x 128(n) weight tile: 4 K rows from k,
// 4 columns from n. A warp covers 8 k-groups x 4 n-groups.
__device__ __forceinline__ void w4_group(int& k, int& n) {
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  n = (warp * 4 + (lane & 3)) * 4;
  k = (lane >> 2) * 4;
}

// Four packed words (K rows k..k+3, columns n..n+3) decoded to int8;
// rows >= K and columns past the pitch are zero.
__device__ __forceinline__ void load_w4(uint32_t (&r)[4], const PackedW4& w,
                                        int k0, int n0) {
  int k, n;
  w4_group(k, n);
  bool nvalid = n0 + n < w.ld;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int gk = k0 + k + j;
    uint32_t v = 0;
    if (nvalid && gk < w.K) {
      v = w.decode(*reinterpret_cast<const uint32_t*>(w.row(gk) + n0 + n),
                   gk);
    }
    r[j] = v;
  }
}

__device__ __forceinline__ uint32_t bf16_bits(uint32_t word, int c) {
  int v = static_cast<int8_t>(word >> (8 * c));
  return __bfloat16_as_ushort(__float2bfloat16_rn(static_cast<float>(v)));
}

// Column n+c of the group becomes the bf16 values K k..k+3 of smem row n+c.
__device__ __forceinline__ void store_w4(int8_t (*dst)[LDS],
                                         const uint32_t (&r)[4]) {
  int k, n;
  w4_group(k, n);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint2 pair;
    pair.x = bf16_bits(r[0], c) | (bf16_bits(r[1], c) << 16);
    pair.y = bf16_bits(r[2], c) | (bf16_bits(r[3], c) << 16);
    *reinterpret_cast<uint2*>(&dst[n + c][k * 2]) = pair;
  }
}

__global__ void __launch_bounds__(THREADS)
    w4a16_gemm_kernel(const int8_t* a, PackedW4 w, const float* sw,
                      const float* c, float* out, int M, int N, int K,
                      int lda, int ldc) {
  __shared__ __align__(16) Smem sm;
  int m0 = blockIdx.y * BM;
  int n0 = blockIdx.x * BN;
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  int wm = warp >> 2;
  int wn = warp & 3;
  float acc[4][4][4];
  zero_acc(acc);
  // A as bytes: K * 2 bytes of each row, pitch lda * 2
  int kbytes = K * 2;
  int ldab = lda * 2;
  uint32_t breg[4];
  int nk = (K + BKE - 1) / BKE;
  load_kmajor_async(sm.a[0], a, m0, M, 0, kbytes, ldab);
  cp_async_commit();
  load_w4(breg, w, 0, n0);
  store_w4(sm.b[0], breg);
  cp_async_wait_all();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    int s = kt & 1;
    bool more = kt + 1 < nk;
    if (more) {
      load_kmajor_async(sm.a[s ^ 1], a, m0, M, (kt + 1) * BK, kbytes, ldab);
      cp_async_commit();
      load_w4(breg, w, (kt + 1) * BKE, n0);
    }
    mma_stage<MmaBf16>(acc, sm.a[s], sm.b[s], wm, wn, lane);
    if (more) store_w4(sm.b[s ^ 1], breg);
    cp_async_wait_all();
    __syncthreads();
  }
  for_each_acc(acc, M, N, m0, n0, wm, wn, lane,
               [&](float& v, int row, int col) {
                 size_t idx = (size_t)row * ldc + col;
                 float y = __fmul_rn(v, sw[col]);
                 out[idx] = __fadd_rn(y, c[idx]);
               });
}

// A (M, lda) bf16 with K a multiple of 8 and K <= lda (16-byte rows, the
// wrapper pads), K <= Kp; ldb (the packed pitch) a multiple of 16, >= N;
// bases 16-byte aligned. Returns cudaGetLastError() after the launch.
inline int launch_w4a16_gemm(const void* a, const void* packed,
                             const void* sw, const void* c, void* out, int M,
                             int N, int K, int lda, int ldb, int ldc,
                             void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  PackedW4 w{static_cast<const int8_t*>(packed), K, ldb};
  w4a16_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), w, static_cast<const float*>(sw),
      static_cast<const float*>(c), static_cast<float*>(out), M, N, K, lda,
      ldc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace htog
