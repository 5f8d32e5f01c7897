// The memory probes of ops/probes.py: device-memory copy bandwidth
// (copy_grid, pipelined_copy), read bandwidth by tile geometry
// (tile_read), shared-memory bandwidth (smem_copy) and the latency of one
// global -> shared load (load_latency).
//
// Replaces: how_to_optimize_gemm_tpu/ops/probes.py, _copy_kernel (via
// _hbm_copy_once / hbm_bandwidth_gbps), _chunk_kernel (via
// dma_chunk_bandwidth_gbps), _vmem_copy_kernel (via vmem_bandwidth_gbps),
// _dma_latency_kernel (via dma_latency_ns) and _manual_copy_kernel (via
// hbm_copy_manual_gbps). The TPU's DMA engine becomes cp.async
// (global -> shared, 16 bytes a thread, committed in groups), its VMEM
// the SM's shared memory.
//
// Bounds on an H100 SXM: 3.35 TB/s of HBM3 (data sheet) for the copies and
// reads, each byte of the 50 MB L2 counted as device memory only when the
// walk is larger than the L2; 32 banks of 4 bytes a clock an SM of shared
// memory (CUDA C Programming Guide, shared memory, compute capability 9.0)
// for smem_copy; load_latency measures a latency and has no bound.
//
// copy_grid: one copy, 16-byte vector loads and stores, grid-stride, four
// words in flight a thread. tile_read: the (rows, cols) int8 chunks of a
// (parent, parent) array walked reps times; the walk is cut into tiles of
// at most 16 KB (whole rows of a chunk), and block b takes tiles b, b + G,
// ... through a two-stage cp.async ring, so every byte lands in shared
// memory; the checksum is the reference's: over every chunk read, the sum
// of its [:8, :128] sliver, in wrapping int32 (added with atomics, which
// commute). smem_copy: buf = x ^ t, o = buf, n_iters times, on a 16 KB slab
// a block, through volatile 16-byte shared loads and stores (nothing can
// be elided or merged); a word of buf is read back by another thread than
// the one that wrote it, after a barrier. load_latency: one warp; each iteration one
// cp.async of a (rows, cols) tile from source t % nsrc, waited on, then
// summed (dp4a) into the result: issue, transfer and completion are
// serial; without the load the same loop is the baseline. pipelined_copy:
// an nslots-stage cp.async ring from src to shared memory, written out to
// dst from each slot as it lands while the later slots are in flight.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint4 lds128(const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts128(void* p, uint4 v) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("st.shared.v4.u32 [%0], {%1,%2,%3,%4};\n" ::"r"(a), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// blocks resident at once on the whole card for this kernel
template <typename K>
int full_grid(K kernel, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// ------------------------------------------------------------ copy_grid

__global__ void __launch_bounds__(256)
    copy_grid_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                     int n) {
  const int stride = gridDim.x * blockDim.x;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + 3 * stride < n; i += 4 * stride) {
    uint4 a = src[i], b = src[i + stride], c = src[i + 2 * stride],
          d = src[i + 3 * stride];
    dst[i] = a;
    dst[i + stride] = b;
    dst[i + 2 * stride] = c;
    dst[i + 3 * stride] = d;
  }
  for (; i < n; i += stride) dst[i] = src[i];
}

// ------------------------------------------------------------ tile_read

constexpr int STAGE = 16384;

__global__ void __launch_bounds__(256)
    tile_read_kernel(const int8_t* __restrict__ x, unsigned* __restrict__ out,
                     int parent, int rows, int cols, int nj, int nchunks,
                     int tpc, int tr, int total) {
  __shared__ __align__(16) int8_t buf[2][STAGE];
  const int wpr = cols / 16;
  const int sr = rows < 8 ? rows : 8, sc = cols < 128 ? cols : 128;
  auto issue = [&](int item, int slot) {
    int k = item % tpc, c = (item / tpc) % nchunks;
    int r0 = k * tr, nr = min(tr, rows - r0);
    const int8_t* base = x + (size_t)((c / nj) * rows + r0) * parent +
                         (size_t)(c % nj) * cols;
    for (int w = threadIdx.x; w < nr * wpr; w += blockDim.x) {
      int r = w / wpr, cw = (w % wpr) * 16;
      cp_async16(&buf[slot][r * cols + cw], base + (size_t)r * parent + cw);
    }
  };
  unsigned local = 0;
  int slot = 0;
  if (blockIdx.x < total) issue(blockIdx.x, 0);
  cp_async_commit();
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    if (item + gridDim.x < total) issue(item + gridDim.x, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    int r0 = (item % tpc) * tr;
    if (r0 < sr) {  // the sliver's rows in this tile
      int nr = min(min(tr, rows - r0), sr - r0);
      for (int e = threadIdx.x; e < nr * sc; e += blockDim.x)
        local += static_cast<unsigned>(buf[slot][(e / sc) * cols + e % sc]);
    }
    __syncthreads();
    slot ^= 1;
  }
  for (int o = 16; o > 0; o >>= 1) local += __shfl_xor_sync(0xffffffffu, local, o);
  if ((threadIdx.x & 31) == 0 && local) atomicAdd(out, local);
}

// ------------------------------------------------------------ smem_copy

constexpr int SLAB = 16384;
constexpr int SLAB_WORDS = SLAB / 16;

__global__ void __launch_bounds__(256)
    smem_copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                     int n_iters) {
  __shared__ __align__(16) uint4 xs[SLAB_WORDS], bufs[SLAB_WORDS],
      os[SLAB_WORDS];
  const size_t base = (size_t)blockIdx.x * SLAB_WORDS;
  for (int w = threadIdx.x; w < SLAB_WORDS; w += blockDim.x)
    xs[w] = x[base + w];
  __syncthreads();
  // buf's words are read back by the thread half a block away from the
  // one that wrote them: no load is served from its own thread's store
  const int other = (threadIdx.x + blockDim.x / 2) % blockDim.x;
  for (int t = 0; t < n_iters; ++t) {
    const uint32_t pat = static_cast<uint32_t>(static_cast<uint8_t>(t)) *
                         0x01010101u;
    for (int w = threadIdx.x; w < SLAB_WORDS; w += blockDim.x) {
      uint4 v = lds128(&xs[w]);
      v.x ^= pat;
      v.y ^= pat;
      v.z ^= pat;
      v.w ^= pat;
      sts128(&bufs[w], v);
    }
    __syncthreads();
    for (int w = other; w < SLAB_WORDS; w += blockDim.x)
      sts128(&os[w], lds128(&bufs[w]));
    __syncthreads();
  }
  for (int w = threadIdx.x; w < SLAB_WORDS; w += blockDim.x)
    out[base + w] = os[w];
}

// --------------------------------------------------------- load_latency

constexpr int MAX_TILE = 16384;

__global__ void load_latency_kernel(const int8_t* __restrict__ x,
                                    int* __restrict__ out, int tile_bytes,
                                    int nsrc, int n_iters, int do_load) {
  __shared__ __align__(16) int8_t buf[MAX_TILE];
  const int lane = threadIdx.x, nw = tile_bytes / 16;
  for (int i = lane; i < tile_bytes; i += 32) buf[i] = 0;
  __syncwarp();
  unsigned acc = 0;
  for (int t = 0; t < n_iters; ++t) {
    if (do_load) {
      const int8_t* src = x + (size_t)(t % nsrc) * tile_bytes;
      for (int w = lane; w < nw; w += 32) cp_async16(buf + 16 * w, src + 16 * w);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncwarp();
    int s = 0;
    for (int w = lane; w < nw; w += 32) {
      uint4 v = lds128(buf + 16 * w);
      s = __dp4a(static_cast<int>(v.x), 0x01010101, s);
      s = __dp4a(static_cast<int>(v.y), 0x01010101, s);
      s = __dp4a(static_cast<int>(v.z), 0x01010101, s);
      s = __dp4a(static_cast<int>(v.w), 0x01010101, s);
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    acc += static_cast<unsigned>(s);
    __syncwarp();
  }
  if (lane == 0) *out = static_cast<int>(acc);
}

// ------------------------------------------------------- pipelined_copy

template <int NSLOTS>
__global__ void __launch_bounds__(256)
    pipelined_copy_kernel(const int8_t* __restrict__ src,
                          int8_t* __restrict__ dst, int* __restrict__ nout,
                          int cb, int nchunks, int total) {
  extern __shared__ __align__(16) int8_t ring[];
  const int G = gridDim.x, nw = cb / 16;
  auto issue = [&](int j) {  // this block's j-th chunk into slot j % NSLOTS
    int item = blockIdx.x + j * G;
    if (item < total) {
      const int8_t* s = src + (size_t)(item % nchunks) * cb;
      int8_t* slot = ring + (j % NSLOTS) * cb;
      for (int w = threadIdx.x; w < nw; w += blockDim.x)
        cp_async16(slot + 16 * w, s + 16 * w);
    }
    cp_async_commit();  // one group a chunk, empty past the end
  };
  for (int j = 0; j < NSLOTS; ++j) issue(j);
  for (int j = 0, item = blockIdx.x; item < total; ++j, item += G) {
    cp_async_wait<NSLOTS - 1>();  // chunk j has landed
    __syncthreads();
    const int8_t* slot = ring + (j % NSLOTS) * cb;
    int8_t* d = dst + (size_t)(item % nchunks) * cb;
    for (int w = threadIdx.x; w < nw; w += blockDim.x)
      *reinterpret_cast<uint4*>(d + 16 * w) = lds128(slot + 16 * w);
    __syncthreads();  // the slot is free
    issue(j + NSLOTS);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *nout = nchunks;
}

template <int NSLOTS>
int launch_pipelined(const void* src, void* dst, void* nout, int cb,
                     int nchunks, int total, cudaStream_t stream) {
  auto kern = pipelined_copy_kernel<NSLOTS>;
  int smem = NSLOTS * cb;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  int grid = full_grid(kern, 256, smem);
  if (grid > total) grid = total;
  if (grid < 1) grid = 1;
  kern<<<grid, 256, smem, stream>>>(static_cast<const int8_t*>(src),
                                    static_cast<int8_t*>(dst),
                                    static_cast<int*>(nout), cb, nchunks,
                                    total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src, dst: n16 words of 16 bytes, 16-byte aligned
extern "C" int copy_grid(const void* src, void* dst, int n16, void* stream) {
  int grid = full_grid(copy_grid_kernel, 256, 0);
  copy_grid_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), n16);
  return static_cast<int>(cudaGetLastError());
}

// x (parent, parent) int8, parent and cols multiples of 16, cols <= 16384;
// out: one int32, zeroed by the caller. Chunks (rows, cols): parent / rows
// x parent / cols of them, walked reps times.
extern "C" int tile_read(const void* x, void* out, int parent, int rows,
                         int cols, int reps, void* stream) {
  int nj = parent / cols, nchunks = (parent / rows) * nj;
  int tr = STAGE / cols < rows ? STAGE / cols : rows;
  int tpc = (rows + tr - 1) / tr;
  int total = reps * nchunks * tpc;
  int grid = full_grid(tile_read_kernel, 256, 0);
  if (grid > total) grid = total;
  if (grid < 1) grid = 1;
  tile_read_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<unsigned*>(out), parent,
      rows, cols, nj, nchunks, tpc, tr, total);
  return static_cast<int>(cudaGetLastError());
}

// x, out: blocks slabs of 16 KB
extern "C" int smem_copy(const void* x, void* out, int blocks, int n_iters,
                         void* stream) {
  smem_copy_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), n_iters);
  return static_cast<int>(cudaGetLastError());
}

// x: nsrc tiles of tile_bytes (a multiple of 16, at most 16 KB); out: one
// int32
extern "C" int load_latency(const void* x, void* out, int tile_bytes,
                            int nsrc, int n_iters, int do_load,
                            void* stream) {
  load_latency_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int*>(out), tile_bytes,
      nsrc, n_iters, do_load);
  return static_cast<int>(cudaGetLastError());
}

// src, dst: nchunks chunks of cb bytes (a multiple of 16); copied reps
// times through an nslots-stage ring (2 .. 8 slots of cb bytes, at most
// 227 KB in all); nout: one int32, set to nchunks.
extern "C" int pipelined_copy(const void* src, void* dst, void* nout, int cb,
                              int nchunks, int nslots, int reps,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int total = reps * nchunks;
  switch (nslots) {
    case 2: return launch_pipelined<2>(src, dst, nout, cb, nchunks, total, s);
    case 3: return launch_pipelined<3>(src, dst, nout, cb, nchunks, total, s);
    case 4: return launch_pipelined<4>(src, dst, nout, cb, nchunks, total, s);
    case 6: return launch_pipelined<6>(src, dst, nout, cb, nchunks, total, s);
    case 8: return launch_pipelined<8>(src, dst, nout, cb, nchunks, total, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
