// paged_kv_update: in-place row writes into a paged KV pool.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_kv_update.py, _kernel_paged
// (via paged_kv_update; models/llama._update_paged_cache for writes of at
// most 8 rows). pool (NP, PS, *rest) and new (B, S, *rest) of one dtype,
// each token's row of row_bytes bytes contiguous; tab (B, S, 2) int32, the
// physical (page, offset) of each new row; mask (B) int32 or null (every
// slot writes). Row i of slot b lands at pool[page, off] when mask[b] != 0
// and page != 0: page 0 is the trash page (masked slots, unallocated
// chunks), skipped rather than written, as the TPU kernel skips it. Rows
// outside [1, NP) x [0, PS) are skipped too (no engine call makes one).
//
// Bound on an H100 SXM: the bytes of the new rows, read once and written
// once (64 KB for four slots of one Llama-2-7B token row, 0.02 us at
// 3.35 TB/s) and the (page, offset) table; a launch costs more than that.
//
// Design: one block per (new row, slot). The block reads its (page, offset)
// pair itself (the TPU kernel prefetches the table as scalars) and copies
// the row with 16-byte loads and stores when the row is a multiple of 16
// bytes and both bases are 16-byte aligned (every bf16 and int8 row with
// d_head a multiple of 16, and KV8 scale rows of a multiple of 4 heads),
// byte by byte otherwise. The pool is never read or copied as a whole.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    paged_kv_update_kernel(char* __restrict__ pool,
                           const char* __restrict__ src,
                           const int* __restrict__ tab,
                           const int* __restrict__ mask, int S, int NP,
                           int PS, int row_bytes, bool vec16) {
  int i = blockIdx.x;
  int b = blockIdx.y;
  if (mask != nullptr && mask[b] == 0) return;
  int page = tab[((size_t)b * S + i) * 2];
  int off = tab[((size_t)b * S + i) * 2 + 1];
  if (page <= 0 || page >= NP || off < 0 || off >= PS) return;
  char* dst = pool + ((size_t)page * PS + off) * row_bytes;
  const char* from = src + ((size_t)b * S + i) * row_bytes;
  if (vec16) {
    int n = row_bytes >> 4;
    for (int e = threadIdx.x; e < n; e += THREADS) {
      reinterpret_cast<uint4*>(dst)[e] =
          reinterpret_cast<const uint4*>(from)[e];
    }
  } else {
    for (int e = threadIdx.x; e < row_bytes; e += THREADS) dst[e] = from[e];
  }
}

}  // namespace

// pool and new contiguous; tab (B, S, 2) int32 on the device; mask (B)
// int32 on the device or null.
extern "C" int paged_kv_update(void* pool, const void* new_rows,
                               const void* tab, const void* mask, int B,
                               int S, int NP, int PS, int row_bytes,
                               void* stream) {
  dim3 grid(S, B);
  bool vec16 = (row_bytes % 16 == 0) &&
               (reinterpret_cast<uintptr_t>(pool) % 16 == 0) &&
               (reinterpret_cast<uintptr_t>(new_rows) % 16 == 0);
  paged_kv_update_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(pool), static_cast<const char*>(new_rows),
      static_cast<const int*>(tab), static_cast<const int*>(mask), S, NP, PS,
      row_bytes, vec16);
  return static_cast<int>(cudaGetLastError());
}
