// K1: one fused (symmetric) four-color Gauss-Seidel sweep on the packed
// (4, M, M) f32 layout.
//
// Replaces the TPU kernels amg_tpu/ops/pallas/packed_rbgs.py
// fused_gs4_sweep_packed (row tiles; bodies _packed_sweep_kernel, _db, _db3)
// and fused_gs4_sweep_packed_2d (2-D tiles for M >= 4096). One kernel covers
// both: it tiles in 2-D at every M.
//
// Bound on the card: device-memory traffic. Unfused, the 8 color steps move
// about 24 field passes; here a block reads u and b once with a ghost ring
// and writes u once: (4 + 4) * ((T+2G)/T)^2 + 4 = 22 bytes per packed cell
// at T = 32, G = 8 (12 bytes is the floor without ghosts). The 8 steps run
// out of shared memory: 2 * 4 * 48^2 * 4 B = 73.7 KB per block, so three
// blocks fit on one SM.
//
// Out of place: every block's ghost cells read the pre-sweep input, so the
// output is a separate buffer (never u itself).

#include "packed_common.cuh"

namespace {

constexpr int T = 32;
constexpr int G = 8;
constexpr int W = T + 2 * G;
constexpr size_t kSmem = 2 * 4 * W * W * sizeof(float);

__global__ void __launch_bounds__(amg::kThreads)
packed_sweep_kernel(const float* __restrict__ u, const float* __restrict__ b,
                    float* __restrict__ out, int M, amg::Stencil st,
                    int symmetric) {
  amg::sweep_block<T, G, amg::kQuarterMajor>(u, b, out, M, st, symmetric);
}

}  // namespace

extern "C" int amg_packed_sweep(const float* u, const float* b, float* out,
                                int M, const float* w9, float inv_diag,
                                float omega, int symmetric,
                                cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_set{0};
  const cudaError_t err = amg::set_smem_once(packed_sweep_kernel, kSmem, attr_set);
  if (err != cudaSuccess) return (int)err;
  const int nt = (M + T - 1) / T;
  packed_sweep_kernel<<<dim3(nt, nt), amg::kThreads, kSmem, stream>>>(
      u, b, out, M, amg::make_stencil(w9, inv_diag, omega), symmetric);
  return (int)cudaGetLastError();
}
