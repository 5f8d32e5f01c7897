// Hopper's warpgroup MMA (wgmma) fed by tensor-map copies (TMA) into an
// mbarrier ring: the building blocks of the grouped GEMM's forward and dx
// (grouped_gemm.cuh's kernel: grouped_gemm.cu, grouped_gemm_t.cu, kinds
// 0-2) and its dW (grouped_dw.cu), of the flash forwards
// (flash_wgmma.cuh: wgmma.m64nNk16 at N 64 and 128, A from registers for
// P V, 4-D tensor maps over strided views, named barriers between the
// consumers; its own block layout, described there), of flash dK/dV
// (flash_attention_bwd_dkv.cu, N 32 to 128) and of rungs 15, 16, 05, 04,
// K2 (rung 14) and 18 (gemm_wgmma.cuh, N 256 and 128; K2 and 18 on int8,
// m64n256k32.s8; rung 11 on that body in clusters of blocks sharing A by
// multicast, Ring's and release's cluster forms below), each with its own
// block layout.
//
// ptxas serializes the wgmmas of a loop shaped like consume() below (its
// note C7518, "wgmma.mma_async instructions are serialized due to program
// dependence on compiler-inserted WG.DP in divergent path": the
// accumulators fenced before each stage's products while the group before
// still writes them, the last stage's wait on a branch of its own); it
// says so for the grouped kernels' builds, and gemm_wgmma.cuh's kernel in
// that shape runs slower (harness/flash_variants.py --group gemm, variant
// consume_shape; PERF.md).
//
// Block shape (the grouped GEMM's three): 384 threads, three warpgroups.
// Warp 0 is the producer (its lane 0 issues every tensor-map copy of the
// ring); warps 1-3 convert integer stack tiles to bf16 where the stack
// needs it and leave at once otherwise (a warpgroup's wgmma wants its four
// warps aligned to a warpgroup, so the consumers start at thread 128
// either way, and a warp that has left costs nothing: one block an SM);
// warpgroups 1 and 2 are the consumers, each issuing wgmma.m64n128k16 on 64
// rows of the block's 128 x 128 output tile. No register rebalancing
// (setmaxnreg): one block an SM caps a thread at 168 registers, which the
// consumers' 128 accumulator registers fit (and ptxas gives no more after
// setmaxnreg at 384 threads a block; flash_wgmma.cuh).
//
// A ring slot (a stage of KT = 64 K values) has two barriers (the
// forward and dx add a third for their converters, grouped_gemm.cuh):
//   full[s]   one producer arrival with the stage's byte count; the
//             copies' complete_tx pays it off;
//   empty[s]  one arrival a consumer warp once its wgmmas on the slot have
//             completed; the producer waits on it before refilling.
// The q-th use of slot s = q % ST is phase q / ST: every wait names parity
// (q / ST) & 1.
//
// Shared-memory tiles use the 128-byte swizzle (a 16-byte chunk's index
// within a 128-byte line XORed with the line's index mod 8), which the
// tensor-map copies write and the wgmma descriptors name; every tile base
// is 1024-byte aligned. Two layouts:
//   K-major (A, x or dy split into bf16; dx's B, the stack's rows as
//     they lie): one 128-byte line per row (or column), 64 K values;
//     8-line groups 1024 bytes apart (SBO). The k-th 16-deep step starts
//     32 k bytes into the line.
//   MN-major (the forward's stacks and dy as they lie, x transposed for
//     dW): one 128-byte line per K row holding 64 M (or N) values; blocks
//     of 64 M/N values KT x 128 = 8,192 bytes apart (LBO), 8-row K groups
//     1024 bytes apart (SBO). The k-th 16-deep step starts 2,048 k bytes
//     in.
// wgmma takes the MN-major form for 16-bit types only (imm-trans-a/b = 1).
//
// Accumulation: the tensor cores' fp32 sum loses low bits over a long K
// (measured on an H100 with mma.sync: 3.4e-5 of max |y| at K = 14,336).
// So a consumer sums CH stages in its wgmma accumulator, then adds that
// partial into a second fp32 register array with ordinary adds and
// restarts the wgmma sum (scale-d = 0): the fixed order of a fixed tiling,
// the same bits on every run.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "manual_dma.cuh"

namespace htog {
namespace wg {

constexpr int BLOCK = 384;         // producer, converters, 2 consumers
constexpr int CONSUMERS = 256;     // threads of warpgroups 1 and 2
constexpr int TILE = 128;          // output tile edge (rows and columns)
constexpr int KT = 64;             // K values a stage
constexpr int LINE = 128;          // bytes of a swizzled line
constexpr int ATOM = 1024;         // bytes of 8 swizzled lines
constexpr int HALF_TILE = KT * LINE;           // 64 lines: 8,192 bytes
constexpr int TILE_BYTES = 2 * HALF_TILE;      // a 128 x 64 bf16 tile
constexpr int ACC = 64;            // fp32 accumulators a thread (64 x 128)

// ------------------------------------------------------------- host side

// cuTensorMapEncodeTiled, found through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of `rank` dims (innermost first) over `base`; strides in
// bytes of dims 1 .. rank-1 (multiples of 16). Elements outside the dims
// read as zeros. Returns false if the driver refuses it.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                     const void* base, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box,
                     CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(base), dims, strides, box,
            ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (2 rows, cols) bf16 pair of planes laid out (2, rows, ld) -- hi then
// lo, split_bf16.cu's output -- as one 2-D map of 2 * rows rows, boxes of
// box_rows rows x 64 values, 128-byte swizzle.
inline bool make_split_map(CUtensorMap* map, const void* base, int rows,
                           int cols, int ld, int box_rows) {
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                        2 * static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims,
                  strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// ----------------------------------------------------------- device side

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  uint32_t a = smem_u32(p);
  return p + ((ATOM - (a & (ATOM - 1))) & (ATOM - 1));
}

// Tensor-map copies global -> shared, paid off on `bar`; coordinates
// innermost first, in elements.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// tma_2d and tma_out_2d's store under an L2 cache policy (createpolicy's
// handle: manual_dma.cuh's l2_evict_last, l2_evict_first) on every line
// the copy touches.
__device__ __forceinline__ void tma_2d_hint(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d_hint(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3}], [%1], %4;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}

// The shared-memory box at src (one box of the map, fp32) added into (kAdd)
// or stored over the global tensor at (c0, c1), by the tensor-map unit,
// tracked by this thread's bulk groups (global -> shared's counterpart of
// tma_2d).
template <bool kAdd>
__device__ __forceinline__ void tma_out_2d(const CUtensorMap* map,
                                           const void* src, int c0, int c1) {
  if constexpr (kAdd) {
    asm volatile(
        "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group"
        " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(src)), "r"(c0), "r"(c1)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
        " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(src)), "r"(c0), "r"(c1)
        : "memory");
  }
}

// tma_2d's box landing at dst's offset in every block of the cluster named
// by `mask` (bit r: block rank r), each block's barrier at bar's offset
// paid off with the bytes that land in that block.
__device__ __forceinline__ void tma_2d_multicast(void* dst,
                                                 const CUtensorMap* map,
                                                 int c0, int c1,
                                                 uint64_t* bar,
                                                 uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask),
      "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, int c3,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (PTX ISA, "Matrix Descriptor").
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

// A K-major tile at `addr` (64 rows of A, or 128 columns of B), its k-th
// 16-deep step.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, int k) {
  return sw128_desc(addr + 32 * k, 0, ATOM);
}

// An MN-major tile at `addr` (64-value blocks `lbo` bytes apart), its k-th
// 16-deep step.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, int k,
                                                 uint32_t lbo = HALF_TILE) {
  return sw128_desc(addr + 2 * ATOM * k, lbo, ATOM);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma.m64nNk16 for N in {32, 64, 128, 256}, bf16 operands, fp32 sums, d
// holding N / 2 accumulators a thread (the layout of for_each_pair below;
// N 32 and 256 have ss and ss0 only).
//   ss<kTA, kTB>(d, da, db, accumulate): A and B from shared memory by
//     descriptor; kTA / kTB: A / B MN-major. ss0: the same as a fresh
//     sum, d an output only (its registers free until the product).
//   rs<kTB>(d, ra, db, accumulate): A from registers, four bf16 pairs a
//     thread in mma.sync's m16n8k16 A layout within each warp's 16 rows
//     (pairs (row g, k 2c..), (g + 8, 2c..), (g, 8 + 2c..), (g + 8,
//     8 + 2c..), g = lane / 4, c = lane % 4): the accumulator of an
//     m64 product, its 16 columns 16 kk .. rounded to bf16 pairs, is this
//     fragment as it stands, so P feeds P . V without shared memory.
// accumulate = 0 ignores d's old value. The operand registers are read
// asynchronously: keep them (fence_regs) until the wgmma_wait that covers
// the product.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // d = A . B from shared memory, d's old value not read (a fresh sum)
  template <int kTA, int kTB>
  static __device__ __forceinline__ void ss0(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
          "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
          "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
          "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
          "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31])
        : "l"(da), "l"(db), "r"(0), "n"(kTA), "n"(kTB));
  }
  template <int kTA, int kTB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate), "n"(kTA), "n"(kTB));
  }
  template <int kTB>
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&ra)[4],
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, "
        "%38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(ra[0]), "r"(ra[1]), "r"(ra[2]), "r"(ra[3]), "l"(db),
          "r"(accumulate), "n"(kTB));
  }
};

template <>
struct Wgmma<128> {
  // d = A . B from shared memory, d's old value not read (a fresh sum)
  template <int kTA, int kTB>
  static __device__ __forceinline__ void ss0(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
          "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
          "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
          "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
          "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
          "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
          "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]),
          "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
          "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]),
          "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
          "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
        : "l"(da), "l"(db), "r"(0), "n"(kTA), "n"(kTB));
  }
  template <int kTA, int kTB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate), "n"(kTA), "n"(kTB));
  }
  template <int kTB>
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&ra)[4],
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, "
        "%70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(ra[0]), "r"(ra[1]), "r"(ra[2]), "r"(ra[3]), "l"(db),
          "r"(accumulate), "n"(kTB));
  }
};

template <>
struct Wgmma<32> {
  // d = A . B from shared memory, d's old value not read (a fresh sum)
  template <int kTA, int kTB>
  static __device__ __forceinline__ void ss0(float (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
          "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
          "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
          "=f"(d[15])
        : "l"(da), "l"(db), "r"(0), "n"(kTA), "n"(kTB));
  }
  template <int kTA, int kTB>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate), "n"(kTA), "n"(kTB));
  }
};

template <>
struct Wgmma<256> {
  // d = A . B from shared memory, d's old value not read (a fresh sum)
  template <int kTA, int kTB>
  static __device__ __forceinline__ void ss0(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
          "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
          "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
          "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
          "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
          "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
          "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]),
          "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
          "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]),
          "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
          "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63]), "=f"(d[64]),
          "=f"(d[65]), "=f"(d[66]), "=f"(d[67]), "=f"(d[68]), "=f"(d[69]),
          "=f"(d[70]), "=f"(d[71]), "=f"(d[72]), "=f"(d[73]), "=f"(d[74]),
          "=f"(d[75]), "=f"(d[76]), "=f"(d[77]), "=f"(d[78]), "=f"(d[79]),
          "=f"(d[80]), "=f"(d[81]), "=f"(d[82]), "=f"(d[83]), "=f"(d[84]),
          "=f"(d[85]), "=f"(d[86]), "=f"(d[87]), "=f"(d[88]), "=f"(d[89]),
          "=f"(d[90]), "=f"(d[91]), "=f"(d[92]), "=f"(d[93]), "=f"(d[94]),
          "=f"(d[95]), "=f"(d[96]), "=f"(d[97]), "=f"(d[98]), "=f"(d[99]),
          "=f"(d[100]), "=f"(d[101]), "=f"(d[102]), "=f"(d[103]),
          "=f"(d[104]), "=f"(d[105]), "=f"(d[106]), "=f"(d[107]),
          "=f"(d[108]), "=f"(d[109]), "=f"(d[110]), "=f"(d[111]),
          "=f"(d[112]), "=f"(d[113]), "=f"(d[114]), "=f"(d[115]),
          "=f"(d[116]), "=f"(d[117]), "=f"(d[118]), "=f"(d[119]),
          "=f"(d[120]), "=f"(d[121]), "=f"(d[122]), "=f"(d[123]),
          "=f"(d[124]), "=f"(d[125]), "=f"(d[126]), "=f"(d[127])
        : "l"(da), "l"(db), "r"(0), "n"(kTA), "n"(kTB));
  }
  template <int kTA, int kTB>
  static __device__ __forceinline__ void ss(float (&d)[128], uint64_t da,
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(accumulate), "n"(kTA), "n"(kTB));
  }
};

// wgmma.m64nNk32.s32.s8.s8 for N 256 and 128 with A and B from shared
// memory by descriptor, both K-major (8-bit types have no transposed form),
// d holding N / 2 int32 sums a thread in the fp32 accumulator layout above
// (for_each_pair). A 32-byte K step of a 128-byte swizzled line, as
// m64nNk16's bf16 step: kmajor_desc(addr, k) names both. accumulate = 0
// ignores d's old value. (w4a8_wgmma.cuh's w4::WgmmaS8 takes A from
// registers.)
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<256> {
  static __device__ __forceinline__ void ss(int (&d)[128], uint64_t da,
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
          "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
          "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
          "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
          "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
          "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
          "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
          "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
          "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void ss(int (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

// Keeps the compiler from moving reads and writes of r (accumulators, or
// A fragments) across a wgmma issue or wait (the registers change or are
// read behind its back).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Named barriers (0 is __syncthreads'): `n` threads take part, each warp
// either waits (sync) or only counts itself in (arrive).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

}  // namespace wg

// Arrive on the barrier at the same offset in block `cta` of the cluster,
// at the default release.cta (CUTLASS's ClusterBarrier::arrive): what the
// arrival publishes is that reads of this block's shared memory, wgmma's,
// have completed (wgmma's wait came first), not data. A release at
// cluster scope made rung 11 1.55x slower (NVIDIA H100 80GB HBM3,
// 700.00 W; harness/flash_variants.py --group strip, release_cluster).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(cta));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

// Every thread of the cluster's blocks meets here (each warp converged).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

namespace wg {

// The ring's barriers, after the stages in shared memory. A slot is empty
// once the `warps` consumer warps that read it have released it (both
// consumer warpgroups', or one's where each takes whole tiles). CL > 1: a
// ring of each block of a cluster of CL blocks whose stages peers'
// multicasts fill too, so a slot is empty once the consumer warps of all
// CL blocks have released it.
template <int ST, int CL = 1>
struct Ring {
  uint64_t full[ST];
  uint64_t empty[ST];

  // by one thread, before the block's __syncthreads (CL > 1: before the
  // cluster's barrier)
  __device__ void init(int warps = CONSUMERS / 32) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CL * warps);
    }
    mbar_fence_init();
  }
};

// mbar_wait that traps (a launch failure the wrapper reports) instead of
// spinning forever on a phase that never completes.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0; !mbar_try_wait(addr, parity); ++n)
    if (n == (1u << 28)) __trap();
}

// The producer's wait before it fills use q of a slot: the slots start
// empty.
template <int ST, int CL>
__device__ __forceinline__ void wait_empty(Ring<ST, CL>& ring, int q) {
  if (q >= ST) wait(&ring.empty[q % ST], ((q / ST) - 1) & 1);
}

// One consumer warp's release of a slot once its wgmmas have completed;
// CL > 1: on the slot's empty barrier in every block of the cluster, lane
// k on block k's (one lane arriving on each block in turn took half again
// as long in the mma.sync rung 11 this replaced, NVIDIA H100 80GB HBM3,
// 700.00 W).
template <int ST, int CL>
__device__ __forceinline__ void release(Ring<ST, CL>& ring, int s) {
  __syncwarp();
  int lane = threadIdx.x & 31;
  if constexpr (CL == 1) {
    if (lane == 0) mbar_arrive(&ring.empty[s]);
  } else {
    if (lane < CL) mbar_arrive_cluster(&ring.empty[s], lane);
  }
}

// A consumer warpgroup's walk over nk stages: issue(s, q, first) issues
// the wgmmas of use q of slot s into acc (first: restart the sum), after
// wait(s, q) has seen its operands land. After every CH stages and after
// the last, once those wgmmas have completed, fold() takes acc (to add it
// into fp32 registers of its own). One wgmma group stays in flight while
// the next stage's operands are awaited.
template <int ST, int CH, class Wait, class Issue, class Fold>
__device__ __forceinline__ void consume(Ring<ST>& ring, int nk,
                                        float (&acc)[ACC], Wait wait,
                                        Issue issue, Fold fold) {
  int pending = -1;
  for (int q = 0; q < nk; ++q) {
    int s = q % ST;
    wait(s, q);
    fence_regs(acc);
    wgmma_fence();
    issue(s, q, q % CH == 0);
    wgmma_commit();
    if ((q + 1) % CH == 0 || q + 1 == nk) {
      wgmma_wait<0>();
      fence_regs(acc);
      if (pending >= 0) release(ring, pending);
      release(ring, s);
      pending = -1;
      fold();
    } else {
      wgmma_wait<1>();
      if (pending >= 0) release(ring, pending);
      pending = s;
    }
  }
}

// tot += acc, fp32 adds in a fixed order.
__device__ __forceinline__ void add_into(float (&tot)[ACC],
                                         const float (&acc)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) tot[i] = __fadd_rn(tot[i], acc[i]);
}

__device__ __forceinline__ void zero(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) d[i] = 0.0f;
}

// Calls f(v0, v1, row, col) for each pair of a consumer's accumulators:
// rows row0 + its 64, columns col .. col + 1 from col0 (wgmma's fp32
// accumulator layout: each 8-column block j holds, for the warp's 16 rows,
// d[4j], d[4j+1] on row g and d[4j+2], d[4j+3] on row g + 8).
template <class F>
__device__ __forceinline__ void for_each_pair(const float (&d)[ACC],
                                              int row0, int col0, F f) {
  int warp = (threadIdx.x >> 5) & 3;
  int lane = threadIdx.x & 31;
  int row = row0 + warp * 16 + (lane >> 2);
  int col = col0 + (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < ACC / 4; ++j) {
    f(d[4 * j], d[4 * j + 1], row, col + 8 * j);
    f(d[4 * j + 2], d[4 * j + 3], row + 8, col + 8 * j);
  }
}

// Stores v0, v1 at columns col, col + 1 of row `row` of an n-column
// matrix where they lie below n: one 8-byte store when both do and the
// address allows.
__device__ __forceinline__ void store_pair(float* out, size_t row, int col,
                                           int n, float v0, float v1) {
  float* p = out + row * n + col;
  if (col + 1 < n && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (col < n) p[0] = v0;
    if (col + 1 < n) p[1] = v1;
  }
}

}  // namespace wg
}  // namespace htog
