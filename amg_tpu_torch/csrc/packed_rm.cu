// K9: the fused (symmetric) four-color GS sweep of K1 on the row-grouped
// (M, 4M) f32 layout: row J holds the four quarters' row J side by side,
// quarter q at columns [q*M, (q+1)*M).
//
// Replaces the TPU kernel amg_tpu/ops/pallas/packed_rm.py
// fused_gs4_sweep_rm (bodies _sweep_kernel_rm_db, _sweep_kernel_rm_sb).
// On the TPU the layout turned the ghosted tile DMA from four strided
// chunks into one contiguous chunk; no solver there uses it (a measured
// negative result: +6 % on the sweep, less than the layout conversions
// cost). It is ported so that the card can answer the same question.
//
// Bound on the card: device-memory traffic, as K1. The block and its color
// steps are K1's first block (packed_common.cuh sweep_block, with the
// kRowGrouped address map): a block reads the 4 x 48 rows of u and b of its
// ghosted tile and writes 4 x 32 rows, 22 bytes per packed cell (12 is the
// floor). Each tile row of a quarter is 48 contiguous floats in both
// layouts, so the loads coalesce alike; the layouts differ only in the
// stride between the rows of a quarter (4M floats here, M in K1). K1 runs
// the windowed block; both are bitwise equal to the plain sweep, so K9
// through the layout conversions equals K1.
//
// Out of place, like K1: every block's ghost cells read the input.

#include "packed_common.cuh"

namespace {

constexpr int T = 32;
constexpr int G = 8;
constexpr int W = T + 2 * G;
constexpr size_t kSmem = 2 * 4 * W * W * sizeof(float);

__global__ void __launch_bounds__(amg::kThreads)
packed_sweep_rm_kernel(const float* __restrict__ u,
                       const float* __restrict__ b, float* __restrict__ out,
                       int M, amg::Stencil st, int symmetric) {
  amg::sweep_block<T, G, amg::kRowGrouped>(u, b, out, M, st, symmetric);
}

}  // namespace

extern "C" int amg_packed_sweep_rm(const float* u, const float* b, float* out,
                                   int M, const float* w9, float inv_diag,
                                   float omega, int symmetric,
                                   cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_set{0};
  const cudaError_t err = amg::set_smem_once(packed_sweep_rm_kernel, kSmem, attr_set);
  if (err != cudaSuccess) return (int)err;
  const int nt = (M + T - 1) / T;
  packed_sweep_rm_kernel<<<dim3(nt, nt), amg::kThreads, kSmem, stream>>>(
      u, b, out, M, amg::make_stencil(w9, inv_diag, omega), symmetric);
  return (int)cudaGetLastError();
}
