// K4: the double-float32 residual r = b - A u on the packed (4, M, M)
// layout with power-of-two weights, writing r.hi and one partial of
// sum(hi^2 + 2 hi lo) per block.
//
// Replaces the TPU kernel amg_tpu/ops/pallas/packed_df.py
// fused_df_residual_rss (bodies _df_kernel, _df_kernel_db, _df_compute).
// The arithmetic is sparse/packed.py _df_residual_pow2_packed: with
// weights +/-2^j, w * x is exact in f32, so the df32 sum is a TwoSum
// cascade (centre term first, then the _neighbors order); the lo parts
// accumulate in plain f32. r.lo feeds only the rss, so it is never stored.
//
// Bound on the card: device-memory traffic, 4 fields read (b.hi, b.lo,
// u.hi, u.lo) and 1 written: 20 bytes per packed cell. The +/-1 neighbour
// reads of u come from L1/L2, so no shared-memory tile is needed: one
// thread per packed position (J, I) computes all four quarters.
//
// The TwoSum cascade is exact only if no operation is re-associated or
// contracted: every add and multiply below is an explicit round-to-nearest
// intrinsic (__fadd_rn, __fsub_rn, __fmul_rn), which the compiler never
// fuses into an FMA, and the library is built without fast math.
//
// The per-block partials are reduced in a fixed tree order (no atomics), so
// a run is reproducible; the wrapper sums them in f64.

#include "packed_common.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ float read0(const float* __restrict__ f, int q,
                                       int J, int I, int M) {
  return (J >= 0 && J < M && I >= 0 && I < M) ? f[amg::gidx(q, J, I, M)]
                                              : 0.f;
}

// One TwoSum-cascade term: s, c += (-w) * (xh + xl), skipped for w == 0.
__device__ __forceinline__ void cascade_term(float w, const float* uh,
                                             const float* ul, int src,
                                             int J, int I, int M, float& s,
                                             float& c) {
  if (w == 0.f) return;
  const float wf = -w;
  const float t = __fmul_rn(wf, read0(uh, src, J, I, M));   // exact
  float e;
  two_sum(s, t, s, e);
  c = __fadd_rn(__fadd_rn(c, e), __fmul_rn(wf, read0(ul, src, J, I, M)));
}

template <int PJ, int PI>
__device__ __forceinline__ float residual_color(
    const float* __restrict__ bh, const float* __restrict__ bl,
    const float* __restrict__ uh, const float* __restrict__ ul,
    float* __restrict__ rh, const amg::Stencil& st, int M, int J, int I) {
  constexpr int a = 2 * PJ + PI;
  float s = bh[amg::gidx(a, J, I, M)];
  float c = bl[amg::gidx(a, J, I, M)];
  cascade_term(st.w[4], uh, ul, a, J, I, M, s, c);
#pragma unroll
  for (int dj = -1; dj <= 1; ++dj) {
#pragma unroll
    for (int di = -1; di <= 1; ++di) {
      if (dj == 0 && di == 0) continue;
      const int bj = (PJ + dj + 2) & 1;
      const int bi = (PI + di + 2) & 1;
      cascade_term(st.w[(dj + 1) * 3 + (di + 1)], uh, ul, 2 * bj + bi,
                   J + (PJ + dj - bj) / 2, I + (PI + di - bi) / 2, M, s, c);
    }
  }
  float hi, lo;
  two_sum(s, c, hi, lo);
  if (!amg::real_cell(a, J, I, M)) {
    hi = 0.f;
    lo = 0.f;
  }
  rh[amg::gidx(a, J, I, M)] = hi;
  // df_rss_fast's square: hi*hi + 2*(hi*lo)
  return __fadd_rn(__fmul_rn(hi, hi), __fmul_rn(2.f, __fmul_rn(hi, lo)));
}

__global__ void __launch_bounds__(BX * BY)
df_residual_kernel(const float* __restrict__ bh, const float* __restrict__ bl,
                   const float* __restrict__ uh, const float* __restrict__ ul,
                   float* __restrict__ rh, float* __restrict__ partials,
                   int M, amg::Stencil st) {
  __shared__ float red[BX * BY];
  const int I = blockIdx.x * BX + threadIdx.x;
  const int J = blockIdx.y * BY + threadIdx.y;
  float psum = 0.f;
  if (J < M && I < M) {
    psum = residual_color<0, 0>(bh, bl, uh, ul, rh, st, M, J, I);
    psum = __fadd_rn(psum, residual_color<0, 1>(bh, bl, uh, ul, rh, st, M, J, I));
    psum = __fadd_rn(psum, residual_color<1, 0>(bh, bl, uh, ul, rh, st, M, J, I));
    psum = __fadd_rn(psum, residual_color<1, 1>(bh, bl, uh, ul, rh, st, M, J, I));
  }
  const int tid = threadIdx.y * BX + threadIdx.x;
  red[tid] = psum;
  __syncthreads();
  for (int half = BX * BY / 2; half > 0; half >>= 1) {
    if (tid < half) red[tid] = __fadd_rn(red[tid], red[tid + half]);
    __syncthreads();
  }
  if (tid == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = red[0];
}

}  // namespace

extern "C" int amg_df_partials_count(int M) {
  return ((M + BX - 1) / BX) * ((M + BY - 1) / BY);
}

extern "C" int amg_df_residual(const float* bh, const float* bl,
                               const float* uh, const float* ul, float* rh,
                               float* partials, int M, const float* w9,
                               cudaStream_t stream) {
  const dim3 grid((M + BX - 1) / BX, (M + BY - 1) / BY);
  df_residual_kernel<<<grid, dim3(BX, BY), 0, stream>>>(
      bh, bl, uh, ul, rh, partials, M, amg::make_stencil(w9, 0.f, 0.f));
  return (int)cudaGetLastError();
}
