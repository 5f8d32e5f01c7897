// The compute probes of ops/probes.py: the tensor cores' chained and
// independent rates (mma_chain, mma_throughput), the SFU's exp rate
// (exp_chain) and the CUDA cores' FFMA rate (ffma_chain).
//
// Replaces: how_to_optimize_gemm_tpu/ops/probes.py, _mxu_kernel (via
// _mxu_probe / mxu_peak_gflops), _mxu_throughput_kernel (via
// mxu_throughput_gflops and mxu_depth_gflops), _vpu_exp_kernel (via
// vpu_exp_gelems) and _vpu_kernel (via vpu_peak_gflops). On the TPU one
// kernel holds one tile in VMEM; here every block holds its own tile in
// shared memory or registers, and a probe launches enough blocks to fill
// the card, so a reading covers all 132 SMs.
//
// Bounds on an H100 SXM (data sheet, dense): 989 TFLOP/s bf16 and 1,979
// TOP/s int8 on the tensor cores, reached only through wgmma; these probes
// issue mma.sync, the instruction every kernel of the port uses, so they
// read mma.sync's ceiling. fp32 at full accuracy is the 3xTF32 split, a
// third of the 495 TFLOP/s TF32 peak. FFMA: 128 lanes an SM a clock, 67
// TFLOP/s. exp: ex2.approx on the SFU, 16 results an SM a clock (CUDA C
// Programming Guide, arithmetic instruction throughput, compute
// capability 9.0). Nothing is read from device memory inside the timed
// loops.
//
// mma_chain: acc <- x @ cast(acc), n_iters times, on one (S, S) tile a
// block (S = 64 or 128; int8 x int8 -> int32 on m16n8k32, bf16 -> fp32 on
// m16n8k16, fp32 as 3xTF32 on m16n8k8: a = hi + lo with hi = tf32(a), lo =
// tf32(a - hi), and a*b = hi*hi + hi*lo + lo*hi). Warp w owns rows 16w ..
// 16w + 15. Each iteration reads x and cast(acc) from shared memory, writes
// the new cast(acc) transposed into the other buffer (the next product's B
// operand, K-contiguous) and syncs: a serially dependent chain, the
// latency-bound rate. cast is the reference's astype: int8 keeps the low
// byte (wraps), bf16 rounds to nearest even, fp32 is the identity.
//
// mma_throughput: acc += vary(x, t) @ y, t = 0 .. n_iters - 1, on one
// (64, K) @ (K, 64) tile a block; int8 varies x by x ^ int8(t), bf16 by
// the sign flip x * (1 - 2 (t % 2)) (exact: the sign bits). The four warps
// split K, each holding a whole 64 x 64 accumulator (4 x 8 fragments) and
// reading its fragments with ldmatrix: 32 independent MMAs for every 8
// ldmatrix.x4, so shared memory does not bound the rate. The four partial
// sums are added at the end in warp order.
//
// exp_chain: acc += __expf(y * (1 + 1e-7 t)) per element, every product
// and sum rounded on its own (no contraction), t counted in fp32.
// ffma_chain: 8 dependent fmaf(acc, 1.000001, y) an iteration (func1.S),
// or 4 independent chains from y, 2y, 3y, 4y summed at the end (func2.S).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind { KIND_INT8 = 0, KIND_BF16 = 1, KIND_FP32 = 2 };

template <int KIND>
struct Elem;
template <>
struct Elem<KIND_INT8> {
  using T = int8_t;
  using Acc = int;
  static constexpr int KSTEP = 32;  // k of one MMA
};
template <>
struct Elem<KIND_BF16> {
  using T = __nv_bfloat16;
  using Acc = float;
  static constexpr int KSTEP = 16;
};
template <>
struct Elem<KIND_FP32> {
  using T = float;
  using Acc = float;
  static constexpr int KSTEP = 8;
};

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// ------------------------------------------------------------ mma_chain

// One (S, S) tile a block, S / 16 warps. Shared memory: x row-major, then
// two buffers of B^T (row n holds column n of B, K-contiguous); every row
// padded by 16 bytes, so the 8 rows x 4 words of a fragment load hit 32
// distinct banks.
template <int KIND, int S>
__global__ void __launch_bounds__(S * 2)
    mma_chain_kernel(const void* __restrict__ xg, const void* __restrict__ yg,
                     void* __restrict__ outg, int n_iters) {
  using E = Elem<KIND>;
  using T = typename E::T;
  using Acc = typename E::Acc;
  constexpr int LD = S + 16 / (int)sizeof(T);  // row pitch, elements
  constexpr int NT = S / 8;                    // n tiles a warp
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* bs[2] = {xs + S * LD, xs + 2 * S * LD};
  const size_t tile = (size_t)blockIdx.x * S * S;
  const T* x = static_cast<const T*>(xg) + tile;
  const T* y = static_cast<const T*>(yg) + tile;
  Acc* out = static_cast<Acc*>(outg) + tile;
  for (int i = threadIdx.x; i < S * S; i += blockDim.x) {
    int r = i / S, c = i % S;
    xs[r * LD + c] = x[i];
    bs[0][c * LD + r] = y[i];  // B^T: B[k = r][n = c]
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  if (n_iters == 0) {  // acc = astype(y)
    for (int i = threadIdx.x; i < S * S; i += blockDim.x)
      out[i] = static_cast<Acc>(static_cast<float>(y[i]));
    return;
  }
  Acc acc[NT][4];
  int cur = 0;
  for (int it = 0; it < n_iters; ++it) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = Acc(0);
    const T* b = bs[cur];
#pragma unroll 2
    for (int k0 = 0; k0 < S; k0 += E::KSTEP) {
      if constexpr (KIND == KIND_FP32) {
        const float* xf = reinterpret_cast<const float*>(xs);
        const float* bf = reinterpret_cast<const float*>(b);
        uint32_t ah[4], al[4];
        split_tf32(xf[(r0 + g) * LD + k0 + t], ah[0], al[0]);
        split_tf32(xf[(r0 + g + 8) * LD + k0 + t], ah[1], al[1]);
        split_tf32(xf[(r0 + g) * LD + k0 + t + 4], ah[2], al[2]);
        split_tf32(xf[(r0 + g + 8) * LD + k0 + t + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(bf[(8 * j + g) * LD + k0 + t], bh0, bl0);
          split_tf32(bf[(8 * j + g) * LD + k0 + t + 4], bh1, bl1);
          mma_tf32(acc[j], al, bh0, bh1);
          mma_tf32(acc[j], ah, bl0, bl1);
          mma_tf32(acc[j], ah, bh0, bh1);
        }
      } else {
        // bf16: a 32-bit word holds 2 k; int8: 4 k
        constexpr int PER = 4 / (int)sizeof(T);
        const int kw = k0 + PER * t;
        uint32_t a[4] = {lds32(xs + (r0 + g) * LD + kw),
                         lds32(xs + (r0 + g + 8) * LD + kw),
                         lds32(xs + (r0 + g) * LD + kw + 4 * PER),
                         lds32(xs + (r0 + g + 8) * LD + kw + 4 * PER)};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const T* bn = b + (8 * j + g) * LD + kw;
          mma(acc[j], a, lds32(bn), lds32(bn + 4 * PER));
        }
      }
    }
    // the next B = cast(acc), written transposed into the other buffer
    T* nb = bs[cur ^ 1];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int m = r0 + g + 8 * (e >> 1), n = 8 * j + 2 * t + (e & 1);
        T v;
        if constexpr (KIND == KIND_INT8)
          v = static_cast<int8_t>(static_cast<uint8_t>(acc[j][e] & 0xff));
        else if constexpr (KIND == KIND_BF16)
          v = __float2bfloat16_rn(acc[j][e]);
        else
          v = acc[j][e];
        nb[n * LD + m] = v;
      }
    cur ^= 1;
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int m = r0 + g + 8 * (e >> 1), n = 8 * j + 2 * t + (e & 1);
      out[m * S + n] = acc[j][e];
    }
}

template <int KIND, int S>
int launch_chain(const void* x, const void* y, void* out, int blocks,
                 int n_iters, cudaStream_t stream) {
  using T = typename Elem<KIND>::T;
  constexpr int LD = S + 16 / (int)sizeof(T);
  const int smem = 3 * S * LD * (int)sizeof(T);
  auto kern = mma_chain_kernel<KIND, S>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  kern<<<blocks, S * 2, smem, stream>>>(x, y, out, n_iters);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- mma_throughput

// int32 sums wrap, as the MMA's s32 accumulation does
__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

constexpr int TM = 64;  // the tile's rows and columns
constexpr int TWARPS = 4;

// x (blocks, 64, K) and y^T (blocks, 64, K), both K-contiguous, staged
// with rows padded by 16 bytes (ldmatrix: 8 rows of 16 bytes on 32
// distinct banks); a (64, 64) fp32 / int32 reduction buffer after them.
template <int KIND>
__global__ void __launch_bounds__(TWARPS * 32)
    mma_throughput_kernel(const void* __restrict__ xg,
                          const void* __restrict__ ytg,
                          void* __restrict__ outg, int K, int n_iters) {
  using E = Elem<KIND>;
  using T = typename E::T;
  using Acc = typename E::Acc;
  const int ldb = K * (int)sizeof(T) + 16;  // row pitch, bytes
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* xs = smem;
  unsigned char* ys = smem + TM * ldb;
  Acc* red = reinterpret_cast<Acc*>(smem + 2 * TM * ldb);
  const size_t rowb = (size_t)K * sizeof(T);
  const unsigned char* x =
      static_cast<const unsigned char*>(xg) + blockIdx.x * TM * rowb;
  const unsigned char* yt =
      static_cast<const unsigned char*>(ytg) + blockIdx.x * TM * rowb;
  const int words = (int)(rowb / 16);
  for (int i = threadIdx.x; i < TM * words; i += blockDim.x) {
    int r = i / words, c = (i % words) * 16;
    *reinterpret_cast<uint4*>(xs + r * ldb + c) =
        *reinterpret_cast<const uint4*>(x + r * rowb + c);
    *reinterpret_cast<uint4*>(ys + r * ldb + c) =
        *reinterpret_cast<const uint4*>(yt + r * rowb + c);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Acc acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = Acc(0);
  // this warp's quarter of K, in 32-byte MMA steps
  const int kb0 = warp * (int)rowb / TWARPS, kb1 = kb0 + (int)rowb / TWARPS;
  // ldmatrix addresses: A rows lane % 16, bytes + 16 for lanes 16..31;
  // B^T rows (lane % 8) + 8 (lane / 16), bytes + 16 for lanes 8..15, 24..31
  const unsigned char* pa = xs + (lane & 15) * ldb + (lane >> 4) * 16;
  const unsigned char* pb =
      ys + ((lane & 7) + 8 * (lane >> 4)) * ldb + ((lane >> 3) & 1) * 16;
  for (int it = 0; it < n_iters; ++it) {
    uint32_t vary;
    if constexpr (KIND == KIND_INT8)
      vary = static_cast<uint32_t>(static_cast<uint8_t>(it)) * 0x01010101u;
    else
      vary = (it & 1) ? 0x80008000u : 0u;
    for (int kb = kb0; kb < kb1; kb += 32) {
      uint32_t a[4][4], b[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ldmatrix_x4(a[i], pa + i * 16 * ldb + kb);
#pragma unroll
        for (int e = 0; e < 4; ++e) a[i][e] ^= vary;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) ldmatrix_x4(b[j], pb + j * 16 * ldb + kb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma(acc[i][2 * j], a[i], b[j][0], b[j][1]);
          mma(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
        }
    }
  }
  // partial sums added in warp order: warp 0 writes, 1..3 add
  const int g = lane >> 2, t = lane & 3;
  for (int w = 0; w < TWARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int m = 16 * i + g + 8 * (e >> 1), n = 8 * j + 2 * t + (e & 1);
            Acc* p = red + m * TM + n;
            *p = w == 0 ? acc[i][j][e] : add(*p, acc[i][j][e]);
          }
    }
    __syncthreads();
  }
  Acc* out = static_cast<Acc*>(outg) + (size_t)blockIdx.x * TM * TM;
  for (int i = threadIdx.x; i < TM * TM; i += blockDim.x) out[i] = red[i];
}

// ------------------------------------------------------------ exp, FFMA

__global__ void exp_chain_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int n,
                                 int n_iters) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float y = x[i];
    float acc = 0.0f, tf = 0.0f;
    for (int t = 0; t < n_iters; ++t) {
      float s = __fadd_rn(1.0f, __fmul_rn(1e-7f, tf));
      acc = __fadd_rn(acc, __expf(__fmul_rn(y, s)));
      tf = __fadd_rn(tf, 1.0f);
    }
    out[i] = acc;
  }
}

template <bool DEPENDENT>
__global__ void ffma_chain_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, int n,
                                  int n_iters) {
  constexpr float M = 1.000001f;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float y = x[i];
    if (DEPENDENT) {
      float acc = y;
      for (int t = 0; t < n_iters; ++t) {
#pragma unroll
        for (int u = 0; u < 8; ++u) acc = fmaf(acc, M, y);
      }
      out[i] = acc;
    } else {
      float a0 = y, a1 = __fmul_rn(y, 2.0f), a2 = __fmul_rn(y, 3.0f),
            a3 = __fmul_rn(y, 4.0f);
      for (int t = 0; t < n_iters; ++t) {
        a0 = fmaf(a0, M, y);
        a1 = fmaf(a1, M, y);
        a2 = fmaf(a2, M, y);
        a3 = fmaf(a3, M, y);
      }
      out[i] = __fadd_rn(__fadd_rn(__fadd_rn(a0, a1), a2), a3);
    }
  }
}

int elementwise_grid(int n) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int want = (n + 255) / 256;
  int full = 8 * sms;  // 2,048 threads an SM
  return want < full ? want : full;
}

}  // namespace

// x, y (blocks, S, S) of the kind's type, out (blocks, S, S) int32 (int8)
// or fp32; kind 0 int8, 1 bf16, 2 fp32; S 64 or 128.
extern "C" int mma_chain(const void* x, const void* y, void* out, int blocks,
                         int S, int n_iters, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 128) {
    if (kind == KIND_INT8) return launch_chain<KIND_INT8, 128>(x, y, out, blocks, n_iters, s);
    if (kind == KIND_BF16) return launch_chain<KIND_BF16, 128>(x, y, out, blocks, n_iters, s);
    if (kind == KIND_FP32) return launch_chain<KIND_FP32, 128>(x, y, out, blocks, n_iters, s);
  } else if (S == 64) {
    if (kind == KIND_INT8) return launch_chain<KIND_INT8, 64>(x, y, out, blocks, n_iters, s);
    if (kind == KIND_BF16) return launch_chain<KIND_BF16, 64>(x, y, out, blocks, n_iters, s);
    if (kind == KIND_FP32) return launch_chain<KIND_FP32, 64>(x, y, out, blocks, n_iters, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// x (blocks, 64, K) and yt (blocks, 64, K) = y^T, K-contiguous; out
// (blocks, 64, 64) int32 (kind 0, int8, K a multiple of 128) or fp32
// (kind 1, bf16, K a multiple of 64).
extern "C" int mma_throughput(const void* x, const void* yt, void* out,
                              int blocks, int K, int n_iters, int kind,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int esz = kind == KIND_INT8 ? 1 : 2;
  int smem = 2 * TM * (K * esz + 16) + TM * TM * 4;
  if (kind == KIND_INT8) {
    auto kern = mma_throughput_kernel<KIND_INT8>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    kern<<<blocks, TWARPS * 32, smem, s>>>(x, yt, out, K, n_iters);
  } else if (kind == KIND_BF16) {
    auto kern = mma_throughput_kernel<KIND_BF16>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    kern<<<blocks, TWARPS * 32, smem, s>>>(x, yt, out, K, n_iters);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, out (n) fp32
extern "C" int exp_chain(const void* x, void* out, int n, int n_iters,
                         void* stream) {
  exp_chain_kernel<<<elementwise_grid(n), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, n_iters);
  return static_cast<int>(cudaGetLastError());
}

// x, out (n) fp32; dependent 1: func1.S, 0: func2.S
extern "C" int ffma_chain(const void* x, void* out, int n, int n_iters,
                          int dependent, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = elementwise_grid(n);
  if (dependent)
    ffma_chain_kernel<true><<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, n_iters);
  else
    ffma_chain_kernel<false><<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, n_iters);
  return static_cast<int>(cudaGetLastError());
}
