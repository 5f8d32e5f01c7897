// grouped_gemm_t, grouped_gemm_t4: the grouped GEMM's transposed product,
// the dx of the MoE expert FFN's backward:
//     dx[i*bt:(i+1)*bt] = dy[i*bt:(i+1)*bt] @ W[be[i]]^T
// for every bt-row block i of the expert-sorted rows dy (Tp, f) fp32, W an
// (E, dout, f) expert stack and be the block -> expert map; dx (Tp, dout)
// fp32. The contraction runs over the stack's last dim in place: no
// transposed copy of the stack.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_grouped_gemm.py,
// _kernel_t :152 (dense and int8 stacks, _gmm_call_t :163, pl.pallas_call
// :187) with grouped_gemm_t, and _kernel_t4 :198 (packed int4 stacks,
// _gmm_call_t4 :218, pl.pallas_call :244) with grouped_gemm_t4. The TPU
// grid reads be by scalar prefetch; here each block reads be[row0 / bt].
//
// Stack kinds of grouped_gemm_t (the `kind` argument): 0 bf16, 1 int8,
// 3 fp32 (E, dout, f). grouped_gemm_t4 takes the packed int4 stack
// (E, dout/2, f) of ops/quant.pack_int4 with block_k = dout, as the
// forward decodes it with block_k = d: output column n < dout/2 reads the
// low nibble of packed row n, (b & 0xF) - 8, and n >= dout/2 the high
// nibble of packed row n - dout/2, the arithmetic b >> 4 of the signed byte
// (the reference's int32 p >> 4 at :211) -- not the int4 linears' 512-row
// pack blocks (w4a8.cuh).
//
// Bound on an H100 SXM at Mixtral-8x7B's prefill (8,192 routed rows, Tp =
// 9,216), w_gate's dx, dy (Tp, 14,336) -> dx (Tp, 4,096): 2 x 8,192 x
// 14,336 x 4,096 = 0.962 TFLOP, the forward's, 0.973 ms at the 989 TFLOP/s
// bf16 peak, against ~1.2 GB of traffic (dy 528 MB, stack 470 MB in int8,
// dx 151 MB), 0.36 ms at 3.35 TB/s: the tensor cores bound it.
//
// Design. The stack's rows are the output columns and its last dim is the
// contraction, contiguous: the NT layout of bf16_gemm_nt.cu and
// int8_gemm_nt.cu. So a stage of 32 K values x 128 columns is read as it
// lies, 16 K values of one column a thread (32 bytes of bf16 or 16 bytes of
// int8 or packed bytes, two or one 16-byte loads), converted or decoded to
// bf16 in registers and stored K-major with no transpose; the rest is the
// forward's tile walk (grouped_gemm.cuh): dy split into bf16 hi + lo, two
// mma.sync.m16n8k16 a product, 128 x 128 tiles in groups of 8 row tiles, a
// 128-row tile inside one layout block (bt a multiple of 128), so one
// expert. dy is fp32 and not exact in bf16; every bf16, int8 and int4 stack
// value is, so the product is the fp32 one to about 2^-17 relative, summed
// in the tensor cores' order. Kind 3 (fp32 stacks, not exact in bf16) runs
// fp32_gemm.cuh's FFMA main loop with B given transposed (its kBT form) on
// the expert's stack: full fp32. On an H100 at the shape above it reads up
// to 3.5e-5 of max |plain| (cuBLAS fp32) at K = 14,336 and takes 8.9 ms on
// a bf16 stack, 8.7 on int8, 9.1 on packed int4: 9x the bound, as the
// forward. Simple first version: mma.sync, not wgmma or TMA.
#include <cuda_bf16.h>
#include <stdint.h>

#include "fp32_gemm.cuh"
#include "grouped_gemm.cuh"
#include "w4a8.cuh"

namespace htog {
namespace gg {

// The 16 K values (k0 + 16 h .. + 15) of output column n0 + c a thread
// stages, c = thread / 2, h = thread % 2.
__device__ __forceinline__ int nt_col() { return threadIdx.x >> 1; }
__device__ __forceinline__ int nt_k() { return (threadIdx.x & 1) * 16; }

// Two bf16 of bytes 2j, 2j + 1 of an int8 word, packed (byte 2j low).
__device__ __forceinline__ uint32_t bf16x2_of_bytes(uint32_t w, int j) {
  __nv_bfloat162 h = __floats2bfloat162_rn(
      static_cast<float>(static_cast<int8_t>(w >> (16 * j))),
      static_cast<float>(static_cast<int8_t>(w >> (16 * j + 8))));
  return *reinterpret_cast<uint32_t*>(&h);
}

// Policies of grouped_gemm.cuh's walk for an (N, K) stack whose rows are
// `ld` elements apart, ld a multiple of 16 whose columns from K on are
// zeros (the wrapper pads them). A row n >= N and a 16-value chunk starting
// at K or later read as zeros.
struct Bf16NT {
  struct Regs {
    uint4 r[2];
  };
  const uint16_t* base;
  int N, K, ld;
  __device__ void load(Regs& regs, int k0, int n0) const {
    int n = n0 + nt_col();
    int k = k0 + nt_k();
    regs.r[0] = regs.r[1] = make_uint4(0u, 0u, 0u, 0u);
    if (n < N && k < K) {
      const uint4* p = reinterpret_cast<const uint4*>(base + (size_t)n * ld
                                                      + k);
      regs.r[0] = p[0];
      regs.r[1] = p[1];
    }
  }
  static __device__ void store(int8_t (*dst)[LDS], const Regs& regs) {
    uint4* p = reinterpret_cast<uint4*>(&dst[nt_col()][nt_k() * 2]);
    p[0] = regs.r[0];
    p[1] = regs.r[1];
  }
};

// 16 int8 values a thread, already decoded (int8 stacks as they are,
// packed int4 nibbles by Int4NT), converted to bf16 at the store.
struct Int8Regs {
  uint4 r;
};

__device__ __forceinline__ void store_int8_regs(int8_t (*dst)[LDS],
                                                const Int8Regs& regs) {
  uint32_t w[4] = {regs.r.x, regs.r.y, regs.r.z, regs.r.w};
  uint4* p = reinterpret_cast<uint4*>(&dst[nt_col()][nt_k() * 2]);
  p[0] = make_uint4(bf16x2_of_bytes(w[0], 0), bf16x2_of_bytes(w[0], 1),
                    bf16x2_of_bytes(w[1], 0), bf16x2_of_bytes(w[1], 1));
  p[1] = make_uint4(bf16x2_of_bytes(w[2], 0), bf16x2_of_bytes(w[2], 1),
                    bf16x2_of_bytes(w[3], 0), bf16x2_of_bytes(w[3], 1));
}

struct Int8NT {
  using Regs = Int8Regs;
  const int8_t* base;
  int N, K, ld;
  __device__ void load(Regs& regs, int k0, int n0) const {
    int n = n0 + nt_col();
    int k = k0 + nt_k();
    regs.r = make_uint4(0u, 0u, 0u, 0u);
    if (n < N && k < K) {
      regs.r = *reinterpret_cast<const uint4*>(base + (size_t)n * ld + k);
    }
  }
  static __device__ void store(int8_t (*dst)[LDS], const Regs& regs) {
    store_int8_regs(dst, regs);
  }
};

// Packed int4, block_k = N: output column n reads packed row n % (N / 2),
// its low nibble for n < N / 2, else its high nibble. Padding columns of a
// packed row are zero bytes, which decode to -8 (low) or 0 (high): they
// meet dy's zero padding, or are never read (chunks from K on).
struct Int4NT {
  using Regs = Int8Regs;
  const int8_t* base;
  int N, K, ld;
  __device__ void load(Regs& regs, int k0, int n0) const {
    int n = n0 + nt_col();
    int k = k0 + nt_k();
    regs.r = make_uint4(0u, 0u, 0u, 0u);
    if (n < N && k < K) {
      int half = N >> 1;
      bool lo = n < half;
      uint4 w = *reinterpret_cast<const uint4*>(
          base + (size_t)(lo ? n : n - half) * ld + k);
      regs.r = lo ? make_uint4(decode_lo4(w.x), decode_lo4(w.y),
                               decode_lo4(w.z), decode_lo4(w.w))
                  : make_uint4(decode_hi4(w.x), decode_hi4(w.y),
                               decode_hi4(w.z), decode_hi4(w.w));
    }
  }
  static __device__ void store(int8_t (*dst)[LDS], const Regs& regs) {
    store_int8_regs(dst, regs);
  }
};

// Kinds 0-2: bf16 tensor cores on split dy, two blocks an SM (at most 128
// registers a thread, as the forward). `w` is the whole stack of
// E x rows x ld elements of Stack's type; rows = N (N / 2 for int4).
template <class Stack, class T, int kRowsDiv>
__global__ void __launch_bounds__(THREADS, 2)
    grouped_gemm_t_mma(const float* dy, const T* w, const int* be,
                       float* out, int Tp, int N, int K, int ldx, int ldw,
                       int bt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  int m0, n0;
  tile_of_block(Tp, N, m0, n0);
  int e = be[m0 / bt];
  Stack stack{w + (size_t)e * (N / kRowsDiv) * ldw, N, K, ldw};
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  float acc[4][4][4];
  zero_acc(acc);
  split_mma_tile(acc, sm, dy, m0, K, ldx, stack, n0);
  for_each_acc(acc, Tp, N, m0, n0, warp >> 2, warp & 3, lane,
               [&](float& v, int row, int col) {
                 out[(size_t)row * N + col] = v;
               });
}

// Kind 3: fp32 stacks, B = the expert's (N, K) stack given transposed.
__global__ void __launch_bounds__(THREADS)
    grouped_gemm_t_ffma(const float* dy, const float* w, const int* be,
                        float* out, int Tp, int N, int K, int ldx, int ldw,
                        int bt) {
  int m0, n0;
  tile_of_block(Tp, N, m0, n0);
  int e = be[m0 / bt];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  fp32_gemm_mainloop<true>(acc, dy, w + (size_t)e * N * ldw, Tp, N, K, ldx,
                           ldw, m0, n0);
  int tx = threadIdx.x & 15;
  int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int row = m0 + ftile(ty, i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int col = n0 + ftile(tx, j);
      if (col < N) out[(size_t)row * N + col] = acc[i][j];
    }
  }
}

template <class Stack, class T, int kRowsDiv>
int launch_t_mma(const void* dy, const void* w, const void* be, void* out,
                 int Tp, int N, int K, int ldx, int ldw, int bt,
                 cudaStream_t stream) {
  static bool configured = false;
  int bytes = static_cast<int>(sizeof(Smem));
  if (!configured) {
    cudaFuncSetAttribute(grouped_gemm_t_mma<Stack, T, kRowsDiv>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    configured = true;
  }
  int blocks = (Tp / BM) * ((N + BN - 1) / BN);
  grouped_gemm_t_mma<Stack, T, kRowsDiv><<<blocks, THREADS, bytes, stream>>>(
      static_cast<const float*>(dy), static_cast<const T*>(w),
      static_cast<const int*>(be), static_cast<float*>(out), Tp, N, K, ldx,
      ldw, bt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gg
}  // namespace htog

// dy (Tp, ldx) fp32 with ldx a multiple of 4 and zero columns from K to ldx,
// Tp a multiple of bt and bt of 128; w the stack (E, N, ldw), ldw >= K a
// multiple of 16 (kinds 0, 1; of 4 for kind 3) with zero columns from K;
// block_expert (Tp / bt,) int32; out (Tp, N) fp32. Bases 16-byte aligned.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unknown kind).
extern "C" int grouped_gemm_t(const void* dy, const void* w,
                              const void* block_expert, void* out, int Tp,
                              int N, int K, int ldx, int ldw, int bt,
                              int kind, void* stream) {
  using namespace htog;
  auto st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return gg::launch_t_mma<gg::Bf16NT, uint16_t, 1>(
          dy, w, block_expert, out, Tp, N, K, ldx, ldw, bt, st);
    case 1:
      return gg::launch_t_mma<gg::Int8NT, int8_t, 1>(
          dy, w, block_expert, out, Tp, N, K, ldx, ldw, bt, st);
    case 3:
      gg::grouped_gemm_t_ffma<<<(Tp / BM) * ((N + BN - 1) / BN), THREADS, 0,
                                st>>>(
          static_cast<const float*>(dy), static_cast<const float*>(w),
          static_cast<const int*>(block_expert), static_cast<float*>(out),
          Tp, N, K, ldx, ldw, bt);
      return static_cast<int>(cudaGetLastError());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same on a packed int4 stack (E, N / 2, ldw) int8 bytes, N even, ldw
// >= K a multiple of 16 with zero bytes from K.
extern "C" int grouped_gemm_t4(const void* dy, const void* w,
                               const void* block_expert, void* out, int Tp,
                               int N, int K, int ldx, int ldw, int bt,
                               void* stream) {
  using namespace htog;
  return gg::launch_t_mma<gg::Int4NT, int8_t, 2>(
      dy, w, block_expert, out, Tp, N, K, ldx, ldw, bt,
      static_cast<cudaStream_t>(stream));
}
