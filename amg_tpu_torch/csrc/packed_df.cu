// K4: the double-float32 residual r = b - A u on the packed (4, M, M)
// layout with power-of-two weights, writing r.hi and the rss
// sum(hi^2 + 2 hi lo) as one f64 value.
//
// Replaces the TPU kernel amg_tpu/ops/pallas/packed_df.py
// fused_df_residual_rss (bodies _df_kernel, _df_kernel_db, _df_compute).
// The arithmetic is sparse/packed.py _df_residual_pow2_packed: with
// weights +/-2^j, w * x is exact in f32, so the df32 sum is a TwoSum
// cascade (centre term first, then the _neighbors order: dj outer, di
// inner); the lo parts accumulate in plain f32. r.lo feeds only the rss,
// so it is never stored.
//
// The TwoSum cascade is exact only if no operation is re-associated or
// contracted: every add and multiply below is an explicit round-to-nearest
// intrinsic (__fadd_rn, __fsub_rn, __fmul_rn), which the compiler never
// fuses into an FMA, and the library is built with -fmad=false and without
// fast math. r.hi is then the plain version's, bit for bit.
//
// Bound on the card: device-memory traffic, 4 fields read (b.hi, b.lo,
// u.hi, u.lo) and 1 written: 20 bytes per packed cell, 0.100 ms at M =
// 2048 and 0.400 ms at M = 4096 (3.35 TB/s).
//
// Design. A block owns a 32 x 64 tile of packed positions (all four
// quarters). A quarter's neighbours lie at most one packed row and column
// away, so u.hi's and u.lo's windows are the tile with a ring of 1 row
// above and below and 4 columns left and right (one is read; four keep
// 16-byte rows): 34 x 72 cells of each quarter, 78,336 B of shared
// memory, two blocks an SM. They arrive through cp.async, all in flight at
// once, zero-filled outside [0, M)^2: 16-byte copies when M % 4 == 0 and
// the fields are 16-byte aligned (every M of the solver's plans), 4-byte
// copies otherwise. While they fly, each thread reads the b.hi and b.lo of
// its cells, coalesced, into registers. A thread owns one tile column and
// every NY-th row (4 rows), so each thread runs 16 independent cascades
// and a warp's shared-memory reads are 32 neighbouring words. Only blocks
// whose tile reaches the last row or column of [0, M - 1) test cells for
// being real (pad cells give exactly 0). r.hi is stored coalesced. Design
// bytes with the 34 x 72 window: u 2 x 4 x 1.20 (L2 catches most of the
// ring), b 8, r 4: about 21.6 B a cell, 0.108 / 0.433 ms.
//
// The rss. Each thread sums its cells' f32 squares (df_rss_fast's hi*hi +
// 2*(hi*lo)) in f64; the block reduces them through warp shuffles and its
// warps in a fixed order and writes one f64 partial. A ticket counter
// picks the last block to finish, which sums the partials in index order
// (a fixed strided split and the same fixed reduction) into the rss and
// resets the counter to 0 for the next launch. No atomic touches a sum, so
// the same inputs give the same rss bits; the order differs from the plain
// version's row sums (held within 1e-5 relative).

#include "packed_common.cuh"

namespace {

// The tile (rows, columns of packed positions), the row phases and the
// blocks an SM.
constexpr int kTJ = 32;
constexpr int kTI = 64;
constexpr int kNY = 8;
constexpr int kBlocks = 2;

struct Df {
  static constexpr int TJ = kTJ;
  static constexpr int TI = kTI;
  static constexpr int NY = kNY;
  static constexpr int NX = TI;          // a thread per tile column
  static constexpr int NT = NX * NY;
  static constexpr int R = TJ / NY;      // rows a thread works
  static constexpr int GI = 4;           // ring columns each side
  static constexpr int H = TJ + 2;       // window rows
  static constexpr int W = TI + 2 * GI;  // window columns
  static constexpr int Q = H * W;        // one quarter's window
  static constexpr size_t kSmem = 2 * 4 * Q * sizeof(float);
  static_assert(TJ % NY == 0 && TI % 32 == 0 && NT % 32 == 0, "tiling");
  static_assert(kBlocks * (kSmem + 1024) <= 233472, "shared memory");
};

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// S[4][H][W] <- one field's four quarter windows from packed row J0 and
// column I0, 0 outside [0, M)^2, as cp.async copies in flight.
__device__ __forceinline__ void load_window(float* S,
                                            const float* __restrict__ g,
                                            int M, int J0, int I0, bool vec) {
  const int tid = threadIdx.x + Df::NX * threadIdx.y;
  if (vec) {
    constexpr int CH = Df::W / 4;
    constexpr int N = 4 * Df::H * CH;
#pragma unroll
    for (int k = 0; k < (N + Df::NT - 1) / Df::NT; ++k) {
      const int L = tid + Df::NT * k;
      if (L >= N) break;
      const int qr = L / CH;             // quarter * H + row
      const int ch = L - qr * CH;
      const int q = qr / Df::H;
      const int J = J0 + qr - q * Df::H;
      const int I = I0 + 4 * ch;
      const bool in = J >= 0 && J < M && I >= 0 && I < M;
      amg::cp_async(S + qr * Df::W + 4 * ch,
                    in ? g + amg::gidx(q, J, I, M) : g, 16, in);
    }
  } else {
    constexpr int N = 4 * Df::Q;
    for (int L = tid; L < N; L += Df::NT) {
      const int qr = L / Df::W;
      const int c = L - qr * Df::W;
      const int q = qr / Df::H;
      const int J = J0 + qr - q * Df::H;
      const int I = I0 + c;
      const bool in = J >= 0 && J < M && I >= 0 && I < M;
      amg::cp_async(S + L, in ? g + amg::gidx(q, J, I, M) : g, 4, in);
    }
  }
}

// One TwoSum-cascade term: s, c += (-w) * (xh + xl).
__device__ __forceinline__ void cascade_term(float w, float xh, float xl,
                                             float& s, float& c) {
  const float wf = -w;
  const float t = __fmul_rn(wf, xh);     // exact (pow2 w)
  float e;
  two_sum(s, t, s, e);
  c = __fadd_rn(__fadd_rn(c, e), __fmul_rn(wf, xl));
}

// r.hi of quarter (PJ, PI) at window cell (r, c) from b (bh, bl); returns
// hi and sets the rss term. real: the cell is not a pad cell.
template <int PJ, int PI, int kPat>
__device__ __forceinline__ float residual_cell(const float* UH,
                                               const float* UL, float bh,
                                               float bl,
                                               const amg::Stencil& st, int r,
                                               int c, bool real, float& sq) {
  constexpr int a = 2 * PJ + PI;
  float s = bh;
  float cc = bl;
  if (st.w[4] != 0.f) {                  // the plain version skips a 0
    const int L = a * Df::Q + r * Df::W + c;
    cascade_term(st.w[4], UH[L], UL[L], s, cc);
  }
#pragma unroll
  for (int dj = -1; dj <= 1; ++dj) {
#pragma unroll
    for (int di = -1; di <= 1; ++di) {
      if (dj == 0 && di == 0) continue;
      if (kPat == amg::kFivePoint && dj != 0 && di != 0) continue;
      const float w = st.w[(dj + 1) * 3 + (di + 1)];
      if (kPat == amg::kAnyWeights && w == 0.f) continue;
      const int bj = (PJ + dj + 2) & 1;
      const int bi = (PI + di + 2) & 1;
      const int L = (2 * bj + bi) * Df::Q + (r + (PJ + dj - bj) / 2) * Df::W
                    + c + (PI + di - bi) / 2;
      cascade_term(w, UH[L], UL[L], s, cc);
    }
  }
  float hi, lo;
  two_sum(s, cc, hi, lo);
  if (!real) {
    hi = 0.f;
    lo = 0.f;
  }
  // df_rss_fast's square: hi*hi + 2*(hi*lo)
  sq = __fadd_rn(__fmul_rn(hi, hi), __fmul_rn(2.f, __fmul_rn(hi, lo)));
  return hi;
}

// The block's sum of v, in a fixed order: warp xor-shuffles, then the
// warps in index order (thread 0 holds the result).
__device__ __forceinline__ double block_sum(double v, double* wsum) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int tid = threadIdx.x + Df::NX * threadIdx.y;
  if ((tid & 31) == 0) wsum[tid >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (tid == 0) {
#pragma unroll
    for (int w = 0; w < Df::NT / 32; ++w) s += wsum[w];
  }
  return s;
}

template <bool kEdge, int kPat>
__device__ __forceinline__ double tile_residual(
    const float* UH, const float* UL, const float* __restrict__ bhp,
    const float* __restrict__ blp, float* __restrict__ rh,
    const amg::Stencil& st, int M, int Jt, int It) {
  const int x = threadIdx.x;
  const int I = It + x;
  // b of the thread's cells, read while the windows' copies fly
  float bh[Df::R][4], bl[Df::R][4];
#pragma unroll
  for (int k = 0; k < Df::R; ++k) {
    const int J = Jt + (int)threadIdx.y + Df::NY * k;
    const bool in = !kEdge || (J < M && I < M);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const size_t g = in ? amg::gidx(a, J, I, M) : 0;
      bh[k][a] = in ? __ldg(bhp + g) : 0.f;
      bl[k][a] = in ? __ldg(blp + g) : 0.f;
    }
  }
  amg::cp_async_wait<0>();
  __syncthreads();
  double psum = 0.0;
  const int c = Df::GI + x;
#pragma unroll
  for (int k = 0; k < Df::R; ++k) {
    const int y = (int)threadIdx.y + Df::NY * k;
    const int J = Jt + y;
    if (kEdge && (J >= M || I >= M)) continue;
    const int r = 1 + y;
    float sq[4], hi[4];
    hi[0] = residual_cell<0, 0, kPat>(UH, UL, bh[k][0], bl[k][0], st, r, c,
                                      !kEdge || amg::real_cell(0, J, I, M),
                                      sq[0]);
    hi[1] = residual_cell<0, 1, kPat>(UH, UL, bh[k][1], bl[k][1], st, r, c,
                                      !kEdge || amg::real_cell(1, J, I, M),
                                      sq[1]);
    hi[2] = residual_cell<1, 0, kPat>(UH, UL, bh[k][2], bl[k][2], st, r, c,
                                      !kEdge || amg::real_cell(2, J, I, M),
                                      sq[2]);
    hi[3] = residual_cell<1, 1, kPat>(UH, UL, bh[k][3], bl[k][3], st, r, c,
                                      !kEdge || amg::real_cell(3, J, I, M),
                                      sq[3]);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      rh[amg::gidx(a, J, I, M)] = hi[a];
      psum += (double)sq[a];
    }
  }
  return psum;
}

template <int kPat>
__global__ void __launch_bounds__(Df::NT, kBlocks)
df_residual_kernel(const float* __restrict__ bh, const float* __restrict__ bl,
                   const float* __restrict__ uh, const float* __restrict__ ul,
                   float* __restrict__ rh, double* __restrict__ partials,
                   unsigned* __restrict__ counter, double* __restrict__ rss,
                   int M, amg::Stencil st, int vec) {
  extern __shared__ __align__(16) float df_smem[];
  __shared__ double wsum[Df::NT / 32];
  __shared__ bool last;
  float* UH = df_smem;
  float* UL = df_smem + 4 * Df::Q;
  const int Jt = blockIdx.y * Df::TJ;
  const int It = blockIdx.x * Df::TI;
  load_window(UH, uh, M, Jt - 1, It - Df::GI, vec);
  load_window(UL, ul, M, Jt - 1, It - Df::GI, vec);
  amg::cp_async_commit();
  const bool edge = Jt + Df::TJ > M - 1 || It + Df::TI > M - 1;
  const double psum =
      edge ? tile_residual<true, kPat>(UH, UL, bh, bl, rh, st, M, Jt, It)
           : tile_residual<false, kPat>(UH, UL, bh, bl, rh, st, M, Jt, It);
  const double s = block_sum(psum, wsum);
  const int tid = threadIdx.x + Df::NX * threadIdx.y;
  const unsigned nblocks = gridDim.x * gridDim.y;
  if (tid == 0) {
    partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(counter, 1u) == nblocks - 1;
  }
  __syncthreads();
  if (!last) return;                     // uniform over the block
  // the last block: the partials in index order, a fixed split (the
  // barrier above keeps thread 0's reads of wsum before its reuse)
  __threadfence();
  double v = 0.0;
  for (unsigned i = tid; i < nblocks; i += Df::NT) v += __ldcg(partials + i);
  const double total = block_sum(v, wsum);
  if (tid == 0) {
    *rss = total;
    *counter = 0u;
  }
}

template <int kPat>
int launch(const float* bh, const float* bl, const float* uh,
           const float* ul, float* rh, double* partials, unsigned* counter,
           double* rss, int M, const float* w9, int vec,
           cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_set{0};
  const cudaError_t err = amg::set_smem_once(df_residual_kernel<kPat>,
                                             Df::kSmem, attr_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + Df::TI - 1) / Df::TI, (M + Df::TJ - 1) / Df::TJ);
  df_residual_kernel<kPat><<<grid, dim3(Df::NX, Df::NY), Df::kSmem,
                             stream>>>(
      bh, bl, uh, ul, rh, partials, counter, rss, M,
      amg::make_stencil(w9, 0.f, 0.f), vec);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of f64 partials (blocks) of amg_df_residual_rss at M.
extern "C" int amg_df_block_count(int M) {
  return ((M + Df::TI - 1) / Df::TI) * ((M + Df::TJ - 1) / Df::TJ);
}

// r.hi to rh and the rss to *rss (f64). partials: amg_df_block_count(M)
// f64 scratch; counter: one unsigned, 0 before the launch and left 0
// after it (launches that share it must be ordered on one stream).
extern "C" int amg_df_residual_rss(const float* bh, const float* bl,
                                   const float* uh, const float* ul,
                                   float* rh, double* partials,
                                   unsigned* counter, double* rss, int M,
                                   const float* w9, cudaStream_t stream) {
  const int vec = M % 4 == 0 && amg::aligned16(uh) && amg::aligned16(ul);
  return amg::by_weight_pattern(w9, [&](auto pat) {
    return launch<decltype(pat)::value>(bh, bl, uh, ul, rh, partials,
                                        counter, rss, M, w9, vec, stream);
  });
}
