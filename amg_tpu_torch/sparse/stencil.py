"""9-point stencil operators on 2-D grids, and the masked four-color
Gauss-Seidel sweep.

PyTorch port of ``amg_tpu/sparse/stencil.py:31-243, 307-327``. An operator
is either constant (``w33``: static 3x3 weights, zero-padding boundary
semantics, no planes stored; every level of the Poisson hierarchy) or
variable (``c``: (3,3,n,n) coefficient planes; the levels of a
variable-coefficient hierarchy). Fields are indexed ``u2[j, i]`` with
``u2.reshape(-1)`` the reference's dof vector; ``c[dj+1, di+1][j, i]`` (or
``w33[dj+1][di+1]``) multiplies ``u2[j+dj, i+di]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

# Color visit order: the 2x2-block parity classes.
FOUR_COLORS = ((0, 0), (0, 1), (1, 0), (1, 1))


@dataclasses.dataclass(frozen=True)
class Stencil2D:
    """9-point operator on a side x side grid: constant when ``w33`` is
    set (``c`` may then be None), else given by the planes ``c``.

    When both are set, ``w33`` asserts that ``c`` is exactly that constant
    stencil (``detect_const_stencil``) and the operators use ``w33``."""

    side: int
    w33: tuple | None = None
    c: torch.Tensor | None = None

    def __post_init__(self):
        if self.w33 is None and self.c is None:
            raise ValueError("Stencil2D needs w33 or planes c")
        if self.c is not None and tuple(self.c.shape) != (3, 3, self.side,
                                                          self.side):
            raise ValueError(f"planes of shape {tuple(self.c.shape)} for "
                             f"side {self.side}")

    @staticmethod
    def const(w33, side: int) -> "Stencil2D":
        if w33 is None:
            raise ValueError("Stencil2D.const requires a w33 tuple")
        return Stencil2D(side=side, w33=w33)

    @staticmethod
    def from_planes(c: torch.Tensor, side: int) -> "Stencil2D":
        """Wrap (3,3,n,n) planes, detecting a constant stencil."""
        return Stencil2D(side=side, c=c, w33=detect_const_stencil(
            c.detach().cpu().numpy(), side))

    @staticmethod
    def from_scipy(A, side: int, dtype=None, device=None) -> "Stencil2D":
        """Planes of a sparse matrix with lexicographic dofs; raises if A
        couples beyond the 3x3 neighbourhood."""
        A = A.tocsr().copy()
        A.sum_duplicates()
        A.eliminate_zeros()
        A = A.tocoo()
        n = side
        c = np.zeros((3, 3, n, n), dtype=A.data.dtype)
        r_j, r_i = A.row // n, A.row % n
        dj, di = A.col // n - r_j, A.col % n - r_i
        if np.any(np.abs(dj) > 1) or np.any(np.abs(di) > 1):
            raise ValueError("matrix is not a 9-point stencil on this grid")
        c[dj + 1, di + 1, r_j, r_i] = A.data
        t = torch.as_tensor(c, device=device)
        if dtype is not None:
            t = t.to(dtype)
        return Stencil2D(side=side, c=t, w33=detect_const_stencil(
            t.cpu().numpy(), side))

    def matvec2(self, u2: torch.Tensor) -> torch.Tensor:
        """A @ u on the 2-D field: sum of 9 shifted products; the zero
        padding supplies the boundary truncation."""
        n = self.side
        up = F.pad(u2, (1, 1, 1, 1))
        out = torch.zeros_like(u2)
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                sl = up[1 + dj:1 + dj + n, 1 + di:1 + di + n]
                if self.w33 is None:
                    out = out + self.c[dj + 1, di + 1] * sl
                    continue
                w = self.w33[dj + 1][di + 1]
                if w == 0.0:
                    continue
                out = out + w * sl
        return out

    def inv_diag(self):
        """1/diag: a Python float (constant) or a plane."""
        if self.w33 is not None:
            return 1.0 / self.w33[1][1]
        return 1.0 / self.c[1, 1]

    def diag(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """The diagonal plane (a constant operator's is uniform: the zero
        padding truncates only off-diagonal couplings)."""
        if self.c is not None:
            return self.c[1, 1]
        return torch.full((self.side, self.side), self.w33[1][1],
                          dtype=dtype, device=device)


def const_planes(w33, side: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """(3,3,n,n) coefficient planes of a constant stencil with zero-padding
    boundary semantics (used for the coarsest-level densify)."""
    n = side
    j = torch.arange(n, device=device).reshape(n, 1)
    i = torch.arange(n, device=device).reshape(1, n)
    zero = torch.zeros((), dtype=dtype, device=device)
    planes = []
    for dj in (-1, 0, 1):
        row = []
        for di in (-1, 0, 1):
            inb = ((j + dj >= 0) & (j + dj < n)
                   & (i + di >= 0) & (i + di < n))
            w = torch.tensor(w33[dj + 1][di + 1], dtype=dtype, device=device)
            row.append(torch.where(inb, w, zero))
        planes.append(torch.stack(row))
    return torch.stack(planes)


def detect_const_stencil(c_np: np.ndarray, side: int) -> tuple | None:
    """The 3x3 weight tuple if the planes are EXACTLY (bitwise) a constant
    stencil with zero-padding boundary semantics, else None."""
    n = side
    c_np = np.asarray(c_np)
    w = c_np[:, :, n // 2, n // 2]
    jj, ii = np.indices((n, n))
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            plane = c_np[dj + 1, di + 1]
            valid = ((jj + dj >= 0) & (jj + dj < n)
                     & (ii + di >= 0) & (ii + di < n))
            expect = np.where(valid, w[dj + 1, di + 1], plane.dtype.type(0))
            if not np.array_equal(plane, expect):
                return None
    return tuple(tuple(float(x) for x in row) for row in w)


def color_masks_iota(n: int, dtype=torch.float32, device=None
                     ) -> torch.Tensor:
    """(4, n, n) parity-class masks in FOUR_COLORS order."""
    j = torch.arange(n, device=device).reshape(n, 1)
    i = torch.arange(n, device=device).reshape(1, n)
    return torch.stack([((j % 2) == pj) & ((i % 2) == pi)
                        for pj, pi in FOUR_COLORS]).to(dtype)


def gs4_sweep_masked(S: Stencil2D, u2, b2, masks, omega: float = 1.0,
                     symmetric: bool = True):
    """Four-color GS sweep via full-grid masked updates: per color, the GS
    correction is computed everywhere and kept on that color's mask
    (colors forward, then reversed when symmetric)."""
    order = list(range(4))
    if symmetric:
        order = order + order[::-1]
    inv_diag = S.inv_diag()
    for ci in order:
        r = b2 - S.matvec2(u2)
        gs_delta = r * inv_diag
        u2 = u2 + (omega * masks[ci]) * gs_delta
    return u2
