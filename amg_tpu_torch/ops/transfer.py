"""Grid-transfer operators: prolongation P and restriction R.

PyTorch port of ``amg_tpu/ops/transfer.py:31-141`` (the reference's
interpolator layer, include/amg/interpolator.hpp). Operators are assembled
on the host in scipy and kept as ELL matrices; ``prolongation`` and
``restriction`` are ELL mat-vecs (interpolator.hpp:52-68).

* ``LinearInterpolator``: reference parity, 1-D linear interpolation of the
  *flattened* dof vector (interpolator.hpp:98-142). Column j of P holds
  [0.5, 1, 0.5] at rows 2j, 2j+1, 2j+2, out-of-range rows dropped; R = P^T;
  n_H = (n_h + 1)/2 - 1 (multigrid.hpp:127-130).
* ``BilinearInterpolator2D``: per-dimension linear interpolation on the
  2-D grid, P = kron(P1, P1), with R = P^T (or P^T / 4 with
  ``full_weighting``). Every Galerkin level of the 5-point Laplacian stays
  a 9-point stencil.

``linear_interp_1d`` is the 1-D P1 whose Kronecker square is also the
structured hierarchy's prolongation (structured.py, the distributed
setup).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from amg_tpu_torch.sparse.ell import ELL


class InterpolatorBase:
    """Per-level P/R maps, as InterpolatorBase (interpolator.hpp:15-87):
    ``make_operators(n_h, n_H, level)`` fills them; ``prolongation`` and
    ``restriction`` apply them."""

    def __init__(self, n_levels: int | None = None):
        # operators exist for levels 0..n_levels-2 (interpolator.hpp:22-26)
        self.level_to_P: dict[int, ELL] = {}
        self.level_to_R: dict[int, ELL] = {}
        self.n_levels = n_levels

    def coarse_size(self, n_h: int) -> int:
        """n_H from n_h: the flattened Briggs formula
        (multigrid.hpp:127-130)."""
        return (n_h + 1) // 2 - 1

    def make_operators_scipy(self, n_h: int, n_H: int):
        raise NotImplementedError

    def make_operators(self, n_h: int, n_H: int, level: int, dtype=None,
                       device=None):
        P, R = self.make_operators_scipy(n_h, n_H)
        self.level_to_P[level] = ELL.from_scipy(P, dtype=dtype, device=device)
        self.level_to_R[level] = ELL.from_scipy(R, dtype=dtype, device=device)

    def get_P(self, level: int) -> ELL:
        return self.level_to_P[level]

    def get_R(self, level: int) -> ELL:
        return self.level_to_R[level]

    def set_level_to_P(self, level: int, P: ELL):
        self.level_to_P[level] = P

    def set_level_to_R(self, level: int, R: ELL):
        self.level_to_R[level] = R

    def prolongation(self, v, level: int):
        """P_level @ v (interpolator.hpp:52-57)."""
        return self.level_to_P[level].matvec(v)

    def restriction(self, v, level: int):
        """R_level @ v (interpolator.hpp:63-68)."""
        return self.level_to_R[level].matvec(v)


class LinearInterpolator(InterpolatorBase):
    """Reference-parity 1-D linear interpolation of the flattened dof
    vector (interpolator.hpp:98-142): 3 entries per column at rows
    2j..2j+2, those past n_h dropped; R = P^T."""

    N_ELEMENTS_PER_COLUMN = 3

    def make_operators_scipy(self, n_h: int, n_H: int):
        j = np.repeat(np.arange(n_H), 3)
        rows = (self.N_ELEMENTS_PER_COLUMN - 1) * j + np.tile([0, 1, 2], n_H)
        vals = np.tile([0.5, 1.0, 0.5], n_H)
        keep = rows < n_h
        P = sp.coo_matrix((vals[keep], (rows[keep], j[keep])),
                          shape=(n_h, n_H)).tocsr()
        R = P.T.tocsr()
        return P, R


def linear_interp_1d(n_f: int, n_c: int) -> sp.csr_matrix:
    """1-D linear interpolation for n_f = 2*n_c + 1 interior points: column
    j has [0.5, 1, 0.5] at rows 2j, 2j+1, 2j+2."""
    if n_f != 2 * n_c + 1:
        raise ValueError(f"linear_interp_1d needs n_f = 2 n_c + 1, got "
                         f"({n_f}, {n_c})")
    rows = np.concatenate([2 * np.arange(n_c), 2 * np.arange(n_c) + 1,
                           2 * np.arange(n_c) + 2])
    cols = np.concatenate([np.arange(n_c)] * 3)
    vals = np.concatenate([np.full(n_c, 0.5), np.full(n_c, 1.0),
                           np.full(n_c, 0.5)])
    return sp.coo_matrix((vals, (rows, cols)), shape=(n_f, n_c)).tocsr()


class BilinearInterpolator2D(InterpolatorBase):
    """Tensor-product linear interpolation on the 2-D grid.

    The side coarsens n -> (n - 1) / 2 (odd sides, n = 2^k - 1);
    P = kron(P1, P1) follows the reference's lexicographic dof = j*n + i
    order (grid.hpp:88-98). ``full_weighting`` scales R by 1/4.
    """

    def __init__(self, fine_side: int, n_levels: int | None = None,
                 full_weighting: bool = False):
        super().__init__(n_levels)
        self.full_weighting = full_weighting
        self.sides: dict[int, int] = {0: fine_side}

    def coarse_size(self, n_h: int) -> int:
        side = int(round(np.sqrt(n_h)))
        if side * side != n_h:
            raise ValueError(f"not a square grid: {n_h} dofs")
        if side % 2 == 0 or side < 3:
            raise ValueError(
                f"BilinearInterpolator2D needs odd grid side >= 3, got {side}")
        return ((side - 1) // 2) ** 2

    def make_operators_scipy(self, n_h: int, n_H: int):
        side_f = int(round(np.sqrt(n_h)))
        side_c = (side_f - 1) // 2
        P1 = linear_interp_1d(side_f, side_c)
        P = sp.kron(P1, P1).tocsr()
        R = P.T.tocsr()
        if self.full_weighting:
            R = (R * 0.25).tocsr()
        return P, R
