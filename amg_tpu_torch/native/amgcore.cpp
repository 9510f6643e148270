// amgcore — native setup engine for the TPU AMG framework.
//
// The reference implements its whole pipeline in C++ on Eigen
// (include/amg/*.hpp). In the TPU-native redesign the *device* compute path
// is JAX/XLA/Pallas; this library is the native host-side runtime for the
// setup phase, where sparse symbolic work is pointer-chasing that Python is
// bad at:
//   * CSR SpGEMM (two-pass symbolic+numeric) for Galerkin RAP products
//     (reference: Eigen sparse products at multigrid.hpp:219-223),
//   * CSR transpose (R = P^T, interpolator.hpp:131-134),
//   * greedy first-fit graph coloring for multicolor smoother scheduling,
//   * ELL packing (CSR -> padded row panels) for device upload,
//   * a sequential symmetric Gauss-Seidel CPU benchmark reproducing the
//     reference smoother's sweep structure (smoother.hpp:129-174), used by
//     bench.py as the single-threaded-CPU baseline proxy.
//
// Build: g++ -O3 -march=native -shared -fPIC amgcore.cpp -o libamgcore.so
// Exposed via ctypes (bindings.py); all functions use the two-call
// (symbolic then numeric) pattern so Python owns every allocation.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CSR SpGEMM: C = A (n x k) * B (k x m).  Pass 1: row nnz counts.

void amg_spgemm_symbolic(int64_t n, int64_t m,
                         const int64_t* a_indptr, const int64_t* a_indices,
                         const int64_t* b_indptr, const int64_t* b_indices,
                         int64_t* c_row_nnz) {
  std::vector<int64_t> marker(m, -1);
  for (int64_t i = 0; i < n; ++i) {
    int64_t count = 0;
    for (int64_t jj = a_indptr[i]; jj < a_indptr[i + 1]; ++jj) {
      int64_t j = a_indices[jj];
      for (int64_t kk = b_indptr[j]; kk < b_indptr[j + 1]; ++kk) {
        int64_t k = b_indices[kk];
        if (marker[k] != i) {
          marker[k] = i;
          ++count;
        }
      }
    }
    c_row_nnz[i] = count;
  }
}

// Pass 2: fill indices/data. c_indptr must be the exclusive prefix sum of
// c_row_nnz. Columns within each output row are sorted.

void amg_spgemm_numeric(int64_t n, int64_t m,
                        const int64_t* a_indptr, const int64_t* a_indices,
                        const double* a_data,
                        const int64_t* b_indptr, const int64_t* b_indices,
                        const double* b_data,
                        const int64_t* c_indptr, int64_t* c_indices,
                        double* c_data) {
  std::vector<int64_t> next(m, -1);
  std::vector<double> sums(m, 0.0);
  for (int64_t i = 0; i < n; ++i) {
    int64_t head = -2;
    int64_t length = 0;
    for (int64_t jj = a_indptr[i]; jj < a_indptr[i + 1]; ++jj) {
      int64_t j = a_indices[jj];
      double v = a_data[jj];
      for (int64_t kk = b_indptr[j]; kk < b_indptr[j + 1]; ++kk) {
        int64_t k = b_indices[kk];
        sums[k] += v * b_data[kk];
        if (next[k] == -1) {
          next[k] = head;
          head = k;
          ++length;
        }
      }
    }
    int64_t offset = c_indptr[i];
    for (int64_t cnt = 0; cnt < length; ++cnt) {
      c_indices[offset + cnt] = head;
      int64_t temp = head;
      head = next[head];
      next[temp] = -1;
      // data written after sort below
    }
    // sort this row's column indices (insertion sort: rows are short)
    int64_t lo = c_indptr[i], hi = c_indptr[i + 1];
    for (int64_t x = lo + 1; x < hi; ++x) {
      int64_t key = c_indices[x];
      int64_t y = x - 1;
      while (y >= lo && c_indices[y] > key) {
        c_indices[y + 1] = c_indices[y];
        --y;
      }
      c_indices[y + 1] = key;
    }
    for (int64_t x = lo; x < hi; ++x) {
      int64_t k = c_indices[x];
      c_data[x] = sums[k];
      sums[k] = 0.0;
    }
  }
}

// ---------------------------------------------------------------------------
// CSR transpose: B = A^T, A is n x m.

void amg_csr_transpose(int64_t n, int64_t m,
                       const int64_t* a_indptr, const int64_t* a_indices,
                       const double* a_data,
                       int64_t* b_indptr, int64_t* b_indices,
                       double* b_data) {
  int64_t nnz = a_indptr[n];
  std::vector<int64_t> count(m + 1, 0);
  for (int64_t x = 0; x < nnz; ++x) count[a_indices[x] + 1]++;
  for (int64_t j = 0; j < m; ++j) count[j + 1] += count[j];
  std::memcpy(b_indptr, count.data(), (m + 1) * sizeof(int64_t));
  std::vector<int64_t> pos(count.begin(), count.end() - 1);
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t x = a_indptr[i]; x < a_indptr[i + 1]; ++x) {
      int64_t j = a_indices[x];
      int64_t p = pos[j]++;
      b_indices[p] = i;
      b_data[p] = a_data[x];
    }
  }
}

// ---------------------------------------------------------------------------
// Greedy first-fit coloring over an ELL pattern (cols: n x K row-major;
// entries with data == 0 are padding). Returns max color + 1.

int64_t amg_greedy_color(int64_t n, int64_t K, const int64_t* cols,
                         const double* data, int64_t* colors) {
  for (int64_t i = 0; i < n; ++i) colors[i] = -1;
  std::vector<int64_t> used;  // color -> last row that used it
  int64_t n_colors = 0;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t k = 0; k < K; ++k) {
      int64_t j = cols[i * K + k];
      if (data[i * K + k] == 0.0 || j == i) continue;
      int64_t cj = colors[j];
      if (cj >= 0) {
        if ((int64_t)used.size() <= cj) used.resize(cj + 1, -1);
        used[cj] = i;
      }
    }
    int64_t c = 0;
    while (c < (int64_t)used.size() && used[c] == i) ++c;
    colors[i] = c;
    if (c + 1 > n_colors) n_colors = c + 1;
  }
  return n_colors;
}

// ---------------------------------------------------------------------------
// ELL pack: CSR -> padded (n x K) panels. Returns required K if k_max too
// small; otherwise fills and returns K used.

int64_t amg_ell_pack(int64_t n, int64_t m, const int64_t* indptr,
                     const int64_t* indices, const double* data,
                     int64_t k_max, int64_t* ell_cols, double* ell_data) {
  int64_t K = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t deg = indptr[i + 1] - indptr[i];
    if (deg > K) K = deg;
  }
  if (K > k_max) return -K;
  for (int64_t i = 0; i < n; ++i) {
    int64_t pad_col = i < m ? i : m - 1;
    int64_t deg = indptr[i + 1] - indptr[i];
    for (int64_t k = 0; k < k_max; ++k) {
      if (k < deg) {
        ell_cols[i * k_max + k] = indices[indptr[i] + k];
        ell_data[i * k_max + k] = data[indptr[i] + k];
      } else {
        ell_cols[i * k_max + k] = pad_col;
        ell_data[i * k_max + k] = 0.0;
      }
    }
  }
  return k_max;
}

// ---------------------------------------------------------------------------
// Sequential symmetric Gauss-Seidel sweeps on CSR — the reference smoother's
// exact recurrence (smoother.hpp:129-174), used as the single-threaded CPU
// baseline in bench.py. Returns elapsed seconds for `iters` symmetric sweeps.

double amg_seq_sgs_bench(int64_t n, const int64_t* indptr,
                         const int64_t* indices, const double* data,
                         double* u, const double* b, int64_t iters) {
  auto t0 = std::chrono::steady_clock::now();
  for (int64_t it = 0; it < iters; ++it) {
    for (int64_t i = 0; i < n; ++i) {
      double rsum = 0.0, diag = 0.0;
      for (int64_t x = indptr[i]; x < indptr[i + 1]; ++x) {
        int64_t j = indices[x];
        double v = data[x];
        if (j == i) diag = v; else rsum += v * u[j];
      }
      if (diag != 0.0) u[i] = (b[i] - rsum) / diag;
    }
    for (int64_t i = n - 1; i >= 0; --i) {
      double rsum = 0.0, diag = 0.0;
      for (int64_t x = indptr[i]; x < indptr[i + 1]; ++x) {
        int64_t j = indices[x];
        double v = data[x];
        if (j == i) diag = v; else rsum += v * u[j];
      }
      if (diag != 0.0) u[i] = (b[i] - rsum) / diag;
    }
  }
  auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double>(t1 - t0).count();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Reference-class CPU AMG: full V-cycle solve on a caller-supplied CSR
// hierarchy (levels' A plus P/R transfer operators), symmetric sequential
// Gauss-Seidel smoothing, dense LU coarsest solve, rss checks every
// `check_every` cycles — the exact solver structure of the reference
// (multigrid.hpp:263-337) as a single-threaded CPU baseline for bench.py.

namespace {

struct Csr {
  int64_t n, m;
  const int64_t* indptr;
  const int64_t* indices;
  const double* data;
};

void spmv(const Csr& A, const double* x, double* y) {
  for (int64_t i = 0; i < A.n; ++i) {
    double s = 0.0;
    for (int64_t p = A.indptr[i]; p < A.indptr[i + 1]; ++p)
      s += A.data[p] * x[A.indices[p]];
    y[i] = s;
  }
}

void sgs_sweep(const Csr& A, double* u, const double* b) {
  for (int64_t i = 0; i < A.n; ++i) {
    double rsum = 0.0, diag = 0.0;
    for (int64_t p = A.indptr[i]; p < A.indptr[i + 1]; ++p) {
      int64_t j = A.indices[p];
      if (j == i) diag = A.data[p]; else rsum += A.data[p] * u[j];
    }
    if (diag != 0.0) u[i] = (b[i] - rsum) / diag;
  }
  for (int64_t i = A.n - 1; i >= 0; --i) {
    double rsum = 0.0, diag = 0.0;
    for (int64_t p = A.indptr[i]; p < A.indptr[i + 1]; ++p) {
      int64_t j = A.indices[p];
      if (j == i) diag = A.data[p]; else rsum += A.data[p] * u[j];
    }
    if (diag != 0.0) u[i] = (b[i] - rsum) / diag;
  }
}

}  // namespace

extern "C" {

// levels' CSR arrays are passed as flat arrays-of-pointers. lu is the dense
// coarsest matrix (nc x nc, row-major), factorized in place here with
// partial pivoting. Returns elapsed seconds; *iters_out = cycles used,
// *rss_out = final rss.

double amg_cpu_vcycle_solve(
    int64_t n_levels,
    const int64_t* const* a_indptr, const int64_t* const* a_indices,
    const double* const* a_data, const int64_t* level_n,
    const int64_t* const* p_indptr, const int64_t* const* p_indices,
    const double* const* p_data,
    const int64_t* const* r_indptr, const int64_t* const* r_indices,
    const double* const* r_data,
    double* lu, const double* b0, double* u0,
    double tol, int64_t check_every, int64_t max_iters,
    int64_t* iters_out, double* rss_out) {
  int64_t L = n_levels;
  std::vector<Csr> A(L);
  std::vector<Csr> P(L - 1), R(L - 1);
  for (int64_t l = 0; l < L; ++l)
    A[l] = {level_n[l], level_n[l], a_indptr[l], a_indices[l], a_data[l]};
  for (int64_t l = 0; l < L - 1; ++l) {
    P[l] = {level_n[l], level_n[l + 1], p_indptr[l], p_indices[l], p_data[l]};
    R[l] = {level_n[l + 1], level_n[l], r_indptr[l], r_indices[l], r_data[l]};
  }
  int64_t nc = level_n[L - 1];
  // dense LU with partial pivoting (coarsest solve, cf. SimplicialLDLT at
  // multigrid.hpp:240-243)
  std::vector<int64_t> piv(nc);
  for (int64_t k = 0; k < nc; ++k) {
    int64_t p = k;
    for (int64_t i = k + 1; i < nc; ++i)
      if (std::abs(lu[i * nc + k]) > std::abs(lu[p * nc + k])) p = i;
    piv[k] = p;
    if (p != k)
      for (int64_t j = 0; j < nc; ++j)
        std::swap(lu[k * nc + j], lu[p * nc + j]);
    double d = lu[k * nc + k];
    for (int64_t i = k + 1; i < nc; ++i) {
      double f = lu[i * nc + k] / d;
      lu[i * nc + k] = f;
      for (int64_t j = k + 1; j < nc; ++j) lu[i * nc + j] -= f * lu[k * nc + j];
    }
  }

  std::vector<std::vector<double>> u(L), rhs(L), r(L);
  for (int64_t l = 0; l < L; ++l) {
    u[l].assign(level_n[l], 0.0);
    rhs[l].assign(level_n[l], 0.0);
    r[l].assign(level_n[l], 0.0);
  }
  std::copy(b0, b0 + level_n[0], rhs[0].begin());
  std::copy(u0, u0 + level_n[0], u[0].begin());

  auto t0 = std::chrono::steady_clock::now();
  int64_t it = 0;
  double err = 1e100;
  while (it < max_iters && err > tol) {
    // down-leg
    for (int64_t l = 0; l < L - 1; ++l) {
      sgs_sweep(A[l], u[l].data(), rhs[l].data());
      spmv(A[l], u[l].data(), r[l].data());
      for (int64_t i = 0; i < level_n[l]; ++i) r[l][i] = rhs[l][i] - r[l][i];
      spmv(R[l], r[l].data(), rhs[l + 1].data());
      std::fill(u[l + 1].begin(), u[l + 1].end(), 0.0);
    }
    // coarsest: LU solve
    {
      std::vector<double>& x = u[L - 1];
      x = rhs[L - 1];
      for (int64_t k = 0; k < nc; ++k)
        if (piv[k] != k) std::swap(x[k], x[piv[k]]);
      for (int64_t i = 0; i < nc; ++i)
        for (int64_t j = 0; j < i; ++j) x[i] -= lu[i * nc + j] * x[j];
      for (int64_t i = nc - 1; i >= 0; --i) {
        for (int64_t j = i + 1; j < nc; ++j) x[i] -= lu[i * nc + j] * x[j];
        x[i] /= lu[i * nc + i];
      }
    }
    // up-leg
    for (int64_t l = L - 2; l >= 0; --l) {
      std::vector<double> corr(level_n[l]);
      spmv(P[l], u[l + 1].data(), corr.data());
      for (int64_t i = 0; i < level_n[l]; ++i) u[l][i] += corr[i];
      sgs_sweep(A[l], u[l].data(), rhs[l].data());
    }
    ++it;
    if (check_every > 0 && it % check_every == 0) {
      spmv(A[0], u[0].data(), r[0].data());
      err = 0.0;
      for (int64_t i = 0; i < level_n[0]; ++i) {
        double d = rhs[0][i] - r[0][i];
        err += d * d;
      }
    }
  }
  auto t1 = std::chrono::steady_clock::now();
  std::copy(u[0].begin(), u[0].end(), u0);
  *iters_out = it;
  *rss_out = err;
  return std::chrono::duration<double>(t1 - t0).count();
}

}  // extern "C"
