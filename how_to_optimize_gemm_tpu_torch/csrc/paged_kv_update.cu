// paged_kv_update: in-place row writes into a paged KV pool.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_kv_update.py, _kernel_paged
// (via paged_kv_update; models/llama._update_paged_cache for writes of at
// most 8 rows). pool (NP, PS, *rest) and new (B, S, *rest) of one dtype,
// each token's row of row_bytes bytes contiguous; pages and offs (B, S)
// int32, the physical page and offset of each new row; mask (B) int32 or
// null (every slot writes). Row i of slot b lands at pool[page, off] when
// mask[b] != 0 and page != 0: page 0 is the trash page (masked slots,
// unallocated chunks), skipped rather than written, as the TPU kernel
// skips it. Rows outside [1, NP) x [0, PS) are skipped too (no engine call
// makes one).
//
// Bound on an H100 SXM: the bytes of the new rows, read once and written
// once (64 KB for four slots of one Llama-2-7B token row, 0.02 us at
// 3.35 TB/s) and the page table; a launch and one load's latency (599 ns
// on an H100) cost more than that.
//
// Design: one launch a call, taking pages and offs as the engine computes
// them (no stacked table). A block of 128 threads takes 128 units of one
// new row, a unit a thread: a 16-byte word when the row is a multiple of
// 16 bytes and both bases are 16-byte aligned (every bf16 and int8 row
// with d_head a multiple of 16, and KV8 scale rows of a multiple of 4
// heads), else a byte (the byte path, for other rows); the grid is (B x S,
// the row's units / 128). The source's address depends only on (b, i), so
// each thread issues its unit's load together with those of mask[b],
// pages[b, i] and offs[b, i] (one address a warp), and only then decides
// and stores: one round trip to memory, not the three of a chain mask ->
// table -> row. The pool is never read or copied as a whole.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

// Loads issued where they stand: volatile, so the compiler neither sinks
// the row's load past the decision nor chains it after the table's.
__device__ __forceinline__ uint4 load(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ char load(const char* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u8 %0, [%1];\n" : "=r"(v) : "l"(p));
  return static_cast<char>(v);
}

__device__ __forceinline__ int load(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

template <class T>
__global__ void __launch_bounds__(THREADS)
    paged_kv_update_kernel(T* __restrict__ pool, const T* __restrict__ src,
                           const int* __restrict__ pages,
                           const int* __restrict__ offs,
                           const int* __restrict__ mask, int S, int NP,
                           int PS, int row_units) {
  const int bi = blockIdx.x;   // b * S + i
  const int e = blockIdx.y * THREADS + threadIdx.x;
  T v{};
  if (e < row_units) v = load(src + static_cast<size_t>(bi) * row_units + e);
  const int live = mask == nullptr ? 1 : load(mask + bi / S);
  const int page = load(pages + bi);
  const int off = load(offs + bi);
  if (e >= row_units || live == 0 || page <= 0 || page >= NP || off < 0 ||
      off >= PS)
    return;
  pool[(static_cast<size_t>(page) * PS + off) * row_units + e] = v;
}

}  // namespace

// pool and new contiguous; pages and offs (B, S) int32 on the device;
// mask (B) int32 on the device or null. Returns a cudaError_t.
extern "C" int paged_kv_update(void* pool, const void* new_rows,
                               const void* pages, const void* offs,
                               const void* mask, int B, int S, int NP,
                               int PS, int row_bytes, void* stream) {
  const bool vec16 = (row_bytes % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(pool) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(new_rows) % 16 == 0);
  const int units = vec16 ? row_bytes / 16 : row_bytes;
  const dim3 grid(B * S, (units + THREADS - 1) / THREADS);
  if (grid.x == 0 || grid.y == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pages);
  const int* o = static_cast<const int*>(offs);
  const int* m = static_cast<const int*>(mask);
  if (vec16)
    paged_kv_update_kernel<uint4><<<grid, THREADS, 0, s>>>(
        static_cast<uint4*>(pool), static_cast<const uint4*>(new_rows), p, o,
        m, S, NP, PS, units);
  else
    paged_kv_update_kernel<char><<<grid, THREADS, 0, s>>>(
        static_cast<char*>(pool), static_cast<const char*>(new_rows), p, o, m,
        S, NP, PS, units);
  return static_cast<int>(cudaGetLastError());
}
