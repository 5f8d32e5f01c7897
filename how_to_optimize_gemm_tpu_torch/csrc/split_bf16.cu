// split_bf16: an fp32 matrix split into two bf16 planes for the bf16
// tensor cores,
//     hi = bf16(x),  lo = bf16(x - hi)      (round to nearest even)
// so that |x - hi - lo| <= 2^-17 |x| and a product hi.b + lo.b with an
// operand b exact in bf16 is the fp32 product to about 2^-17 relative.
// The operand of the wgmma kernels on fp32 operands: x for the grouped
// GEMM's forward (grouped_gemm.cu), x and dy for its dW (grouped_dw.cu),
// and A and BT for rung 16 (fp32_gemm_nt.cu).
//
// Replaces: no Pallas kernel of its own. The TPU kernels of
// how_to_optimize_gemm_tpu/ops/pallas_grouped_gemm.py take fp32 x into the
// MXU at the reference's precision inside _kernel :71 (and dW's operands
// inside _dw_kernel :255); here that split is a pre-pass, so the wgmma
// kernels read both planes from shared memory as the tensor-map copies
// land them.
//
// Bound: bytes. x (rows, cols) fp32 is read once and the two planes
// (2, rows, ldo) bf16 written once: 8 bytes an element in all, 0.09 ms for
// (9,216, 4,096) at 3.35 TB/s on an H100 SXM.
//
// Design: one thread per 8 columns of a row: two 16-byte loads where the
// row's 8 values lie inside x and its pitch allows (scalar loads at the
// edge), flash_common.cuh's split_pack, one 16-byte store to each plane.
// Columns cols .. ldo of both planes are zeros, so the planes' rows are a
// multiple of 16 bytes, as the tensor maps need.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace htog {

__global__ void split_bf16_kernel(const float* x, uint16_t* out, int rows,
                                  int cols, int ldx, int ldo) {
  const size_t per_row = ldo / 8;
  const size_t total = per_row * rows;
  const size_t plane = static_cast<size_t>(rows) * ldo;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    size_t r = i / per_row;
    int c0 = static_cast<int>(i % per_row) * 8;
    const float* p = x + r * ldx + c0;
    float v[8];
    if (c0 + 8 <= cols && (ldx & 3) == 0) {
      float4 a = *reinterpret_cast<const float4*>(p);
      float4 b = *reinterpret_cast<const float4*>(p + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = c0 + j < cols ? p[j] : 0.0f;
    }
    uint4 hi, lo;
    fa::split_pack(v[0], v[1], hi.x, lo.x);
    fa::split_pack(v[2], v[3], hi.y, lo.y);
    fa::split_pack(v[4], v[5], hi.z, lo.z);
    fa::split_pack(v[6], v[7], hi.w, lo.w);
    uint16_t* o = out + r * ldo + c0;
    *reinterpret_cast<uint4*>(o) = hi;
    *reinterpret_cast<uint4*>(o + plane) = lo;
  }
}

}  // namespace htog

// x (rows, ldx) fp32, ldx >= cols; out (2, rows, ldo) bf16, ldo >= cols a
// multiple of 8. Bases 16-byte aligned. Returns cudaGetLastError() after
// the launch.
extern "C" int split_bf16(const void* x, void* out, int rows, int cols,
                          int ldx, int ldo, void* stream) {
  using namespace htog;
  size_t total = static_cast<size_t>(rows) * (ldo / 8);
  size_t blocks = (total + 255) / 256;
  int grid = static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
  split_bf16_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint16_t*>(out), rows, cols,
      ldx, ldo);
  return static_cast<int>(cudaGetLastError());
}
