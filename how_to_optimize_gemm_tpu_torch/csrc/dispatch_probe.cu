// add_one: o = x + 1 on a bf16 tensor, the dispatch probe's "custom" op.
//
// Replaces: how_to_optimize_gemm_tpu/ops/dispatch_probe.py, _copy_kernel
// (via _custom_op, chained N times by _make_chain as the "custom" kind).
// Each element is rounded once, bf16(float(x) + 1), as XLA and PyTorch
// round a bf16 add.
//
// Bound on an H100 SXM: the probe's (8, 256) tile is 4 KB read and 4 KB
// written, 2.4 ns at 3.35 TB/s; a launch costs microseconds, so a chain of
// these kernels times the cost of issuing a kernel (eagerly, or from a
// CUDA graph), which is what the probe is for.
//
// Design: one thread an element, grid-stride; the probe's tile is one
// wave of 8 blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
    add_one_kernel(const __nv_bfloat16* __restrict__ x,
                   __nv_bfloat16* __restrict__ out, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    out[i] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(x[i]), 1.0f));
}

}  // namespace

// x, out: n bf16
extern "C" int add_one(const void* x, void* out, int n, void* stream) {
  int grid = (n + 255) / 256;
  if (grid > 1024) grid = 1024;
  if (grid < 1) grid = 1;
  add_one_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
      n);
  return static_cast<int>(cudaGetLastError());
}
