// Kernel 4 kv_update: in-place row writes into a contiguous KV cache.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_kv_update.py,
// _kernel_contig (via kv_update; models/llama._update_cache for writes of
// at most 8 rows). cache (B, T, *rest) and new (B, S, *rest) of one dtype,
// each token's row of row_bytes bytes contiguous; pos (B) and mask (B)
// int32 (mask may be null: every slot writes). Row i of slot b lands at
// cache[b, pos[b] + i] when mask[b] != 0 and 0 <= pos[b] + i < T; a row out of range is dropped on its own, the
// others of the slot are written (the reference's per-row drop), and a
// masked slot keeps its rows.
//
// Bound on an H100 SXM: the bytes of the new rows, read once and written
// once (64 KB for four slots of one Llama-2-7B token row, 0.02 us at
// 3.35 TB/s); a launch costs more than that.
//
// Design: one block per (new row, slot), 16-byte copies when the row is a
// multiple of 16 bytes and both bases are 16-byte aligned (every bf16
// cache row with d_head a multiple of 8), byte copies otherwise. The cache is never read or copied as a whole.
// The TPU's 128-lane layout rule (kernel_supported) is a Mosaic rule and
// has no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    kv_update_kernel(char* __restrict__ cache, const char* __restrict__ src,
                     const int* __restrict__ pos, const int* __restrict__ mask,
                     int T, int S, int row_bytes, bool vec16) {
  int i = blockIdx.x;
  int b = blockIdx.y;
  if (mask != nullptr && mask[b] == 0) return;
  int p = pos[b] + i;
  if (p < 0 || p >= T) return;
  char* dst = cache + ((size_t)b * T + p) * row_bytes;
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

// cache and new contiguous; pos (B) int32 on the device, mask (B) int32
// on the device or null.
extern "C" int kv_update(void* cache, const void* new_rows, const void* pos,
                         const void* mask, int B, int T, int S,
                         int row_bytes, void* stream) {
  dim3 grid(S, B);
  bool vec16 = (row_bytes % 16 == 0) &&
               (reinterpret_cast<uintptr_t>(cache) % 16 == 0) &&
               (reinterpret_cast<uintptr_t>(new_rows) % 16 == 0);
  kv_update_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(cache), static_cast<const char*>(new_rows),
      static_cast<const int*>(pos), static_cast<const int*>(mask), T, S,
      row_bytes, vec16);
  return static_cast<int>(cudaGetLastError());
}
