// K1 and K9: one fused (symmetric) four-color Gauss-Seidel sweep on a
// color-packed f32 field, in the packed (4, M, M) layout (K1) or the
// row-grouped (M, 4M) layout (K9), whose row J holds the four quarters'
// row J side by side, quarter q at columns [q*M, (q+1)*M).
//
// K1 replaces the TPU kernels amg_tpu/ops/pallas/packed_rbgs.py
// fused_gs4_sweep_packed (row tiles; bodies _packed_sweep_kernel, _db,
// _db3) and fused_gs4_sweep_packed_2d (2-D tiles for M >= 4096); one
// kernel covers both: it tiles in 2-D at every M. K9 replaces
// amg_tpu/ops/pallas/packed_rm.py fused_gs4_sweep_rm (bodies
// _sweep_kernel_rm_db, _sweep_kernel_rm_sb). On the TPU that layout turned
// the ghosted tile DMA from four strided chunks into one contiguous chunk;
// no solver there uses it (a measured negative result: +6 % on the sweep,
// less than the layout conversions cost). It is ported so that the card
// can answer the same question.
//
// Bound on the card: device-memory traffic. Unfused, the 8 color steps
// move about 24 field passes; the floor is u and b read once and u written
// once, 12 bytes per packed cell. The kernel is K3 (packed_cycle.cu)
// without the correction: a windowed block (packed_common.cuh Tiling) with
// a 32 x 64 tile in a 36 x 72 window, the exact ring of 2 rows and 4
// columns, 576 threads and 82,944 B of shared memory, so two blocks share
// an SM and one block's loads overlap the other's color steps. u and b go
// in by cp.async (16-byte copies where M % 4 == 0 and the pointers are
// aligned), the color steps take the weights' zero pattern as a template
// parameter and test cells for being real only in blocks at the domain's
// edge, and the tile goes out by 16-byte stores: (4 + 4) * (36 * 72) /
// (32 * 64) + 4 = 14.1 bytes per packed cell. The two layouts differ only
// in the stride between a quarter's rows (M floats in K1, 4M in K9): a
// window row of a quarter is 72 contiguous floats in both, so the copies
// coalesce alike, and the layout is a template parameter of the loads and
// stores alone. Both are bitwise equal to the plain sweep, so K9 through
// the layout conversions equals K1.
//
// Out of place: every block's ghost cells read the pre-sweep input, so the
// output is a separate buffer (never u itself).

#include "packed_common.cuh"

namespace {

using Sweep = amg::Tiling<32, 64, 2, 4, 8>;

template <int kPat, int Lay>
__global__ void __launch_bounds__(Sweep::NT, Sweep::kBlocks)
packed_sweep_kernel(const float* __restrict__ u, const float* __restrict__ b,
                    float* __restrict__ out, int M, amg::Stencil st,
                    int symmetric, int vec) {
  extern __shared__ float sweep_smem[];
  float* U = sweep_smem;
  float* B = sweep_smem + 4 * Sweep::H * Sweep::W;
  const int Jt = blockIdx.y * Sweep::TJ;
  const int It = blockIdx.x * Sweep::TI;
  const int J0 = Jt - Sweep::GJ;
  const int I0 = It - Sweep::GI;
  amg::load_window<Sweep, Lay>(U, u, M, J0, I0, vec);
  amg::load_window<Sweep, Lay>(B, b, M, J0, I0, vec);
  amg::cp_async_commit();
  amg::cp_async_wait<0>();
  __syncthreads();
  if (amg::window_inside<Sweep>(M, J0, I0))
    amg::window_sweep<Sweep, false, kPat>(U, B, st, M, J0, I0, symmetric);
  else
    amg::window_sweep<Sweep, true, kPat>(U, B, st, M, J0, I0, symmetric);
  amg::store_tile<Sweep, Lay>(U, out, M, Jt, It, vec);
}

template <int kPat, int Lay>
int launch_sweep(const float* u, const float* b, float* out, int M,
                 const float* w9, float inv_diag, float omega, int symmetric,
                 int vec, cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_set{0};
  const cudaError_t err = amg::set_smem_once(packed_sweep_kernel<kPat, Lay>,
                                             Sweep::kSmem, attr_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + Sweep::TI - 1) / Sweep::TI,
                  (M + Sweep::TJ - 1) / Sweep::TJ);
  packed_sweep_kernel<kPat, Lay>
      <<<grid, dim3(Sweep::NX, Sweep::NY), Sweep::kSmem, stream>>>(
          u, b, out, M, amg::make_stencil(w9, inv_diag, omega), symmetric,
          vec);
  return (int)cudaGetLastError();
}

template <int Lay>
int sweep(const float* u, const float* b, float* out, int M, const float* w9,
          float inv_diag, float omega, int symmetric, cudaStream_t stream) {
  const int vec = M % 4 == 0 && amg::aligned16(u) && amg::aligned16(b)
                  && amg::aligned16(out);
  return amg::by_weight_pattern(w9, [&](auto pat) {
    return launch_sweep<decltype(pat)::value, Lay>(
        u, b, out, M, w9, inv_diag, omega, symmetric, vec, stream);
  });
}

}  // namespace

extern "C" int amg_packed_sweep(const float* u, const float* b, float* out,
                                int M, const float* w9, float inv_diag,
                                float omega, int symmetric,
                                cudaStream_t stream) {
  return sweep<amg::kQuarterMajor>(u, b, out, M, w9, inv_diag, omega,
                                   symmetric, stream);
}

extern "C" int amg_packed_sweep_rm(const float* u, const float* b, float* out,
                                   int M, const float* w9, float inv_diag,
                                   float omega, int symmetric,
                                   cudaStream_t stream) {
  return sweep<amg::kRowGrouped>(u, b, out, M, w9, inv_diag, omega,
                                 symmetric, stream);
}
