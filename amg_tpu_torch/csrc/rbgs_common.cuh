// Shared device code of the fused four-color sweeps on the unpacked (n, n)
// layout: K5 (rbgs_sweep.cu, a constant 3x3 stencil) and K6 (rbgs_var.cu,
// nine coefficient planes). Both run one block per tile with the same
// window and the same per-step update regions; their thread maps and
// shared-memory layouts are their own.
//
// The ring. A color step changes the cells of one row and column parity,
// so along a chain of steps a wrong value moves one row only where the row
// parity changes and one column where the column parity changes. Tracing
// back from the tile (tests/test_torch_tiling_rbgs.py emulates it), the
// symmetric sweep reads u 3 rows above the tile, 2 below, 7 columns left
// and 6 right; the forward sweep 1, 2, 3 and 4. The window starts on an
// even row and column so that the parities are compile-time facts: it
// takes 4 / 2 / 8 / 6 (symmetric) and 2 / 2 / 4 / 4 (forward). The ring
// and the regions depend on the color order and the stencil's reach, not
// on the weights: they hold for any 3x3 stencil, constant or not.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace rbgs {

// Load phases: 0 = row parity 0, steps 0 (even columns) and 1 (odd);
// 1 = row parity 1, steps 2 and 5 (even), 3 and 4 (odd); 2 (symmetric
// only) = row parity 0, steps 6 (odd) and 7 (even). A phase covers the
// cells of its row parity within margins around the tile: field 0 rows
// above, 1 rows below, 2 / 3 columns left / right of even columns, 4 / 5
// of odd columns; the least that keeps the tile exact (the trapezoid of
// temporal blocking: each step updates only the cells of its color that
// can still reach the tile). The table is copied as MARGINS in
// tests/test_torch_tiling_rbgs.py, which shows it exact for K5's and K6's
// arithmetic and each entry one smaller inexact: change both together.
__host__ __device__ constexpr int margin(bool sym, int phase, int field) {
  const int m[5][6] = {{2, 1, 6, 5, 5, 4},     // symmetric, phase 0
                       {1, 0, 4, 3, 3, 2},     // symmetric, phase 1
                       {0, -1, 0, -1, 1, 0},   // symmetric, phase 2
                       {0, 1, 2, 3, 1, 2},     // forward, phase 0
                       {-1, 0, 0, 1, -1, 0}};  // forward, phase 1
  return m[sym ? phase : 3 + phase][field];
}

// A TJ x TI tile in its window, NY row phases; K6's map takes a thread per
// window column (NX x NY threads).
template <int TJ_, int TI_, int NY_, bool kSym_>
struct Tiling {
  static constexpr bool kSym = kSym_;
  static constexpr int TJ = TJ_;
  static constexpr int TI = TI_;
  static constexpr int NY = NY_;
  static constexpr int TOP = kSym ? 4 : 2;
  static constexpr int BOT = 2;
  static constexpr int LEFT = kSym ? 8 : 4;
  static constexpr int RIGHT = kSym ? 6 : 4;
  static constexpr int H = TJ + TOP + BOT;   // window rows
  static constexpr int W = TI + LEFT + RIGHT;
  static constexpr int NX = W;               // a thread per window column
  static constexpr int NT = NX * NY;
  static_assert(TJ % 2 == 0 && TI % 2 == 0, "even tiles keep the parity");
  static_assert(2 * H * W * sizeof(float) <= 48 * 1024, "static smem");
};

// Rows of load phase PH: the first tile row (of the phase's row parity),
// the number of rows, and the rows a thread holds (every NY-th).
template <class V, int PH>
struct Phase {
  static constexpr int P = PH == 1 ? 1 : 0;    // row parity
  static constexpr int top = margin(V::kSym, PH, 0);
  static constexpr int R0 = -top + ((-top - P) & 1);
  static constexpr int NR = (V::TJ - 1 + margin(V::kSym, PH, 1) - R0) / 2
                            + 1;
  static constexpr int K = (NR + V::NY - 1) / V::NY;
};

}  // namespace rbgs
