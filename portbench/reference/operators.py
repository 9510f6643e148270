"""f64 operator applies and the reference's stopping rule.

The grid is the reference's (jfdev001/algebraic-multigrid, grid.hpp): n x n
interior nodes of [-1, 1]^2, h = 2 / (n + 1), homogeneous Dirichlet
boundaries, field ``u[j, i]`` at (x_j, y_i) with x_j = -1 + (j + 1) h. The
rss rule is the reference's absolute one: sum((b - A u)^2) <= tolerance.
"""

from __future__ import annotations

import torch


def grid_h(n: int) -> float:
    return 2.0 / (n + 1)


def poisson5_apply(u: torch.Tensor) -> torch.Tensor:
    """A u for the 5-point finite-difference Laplacian of grid.hpp:88-98,
    A = kron(I, D) + kron(D, I), D = tridiag(1, -2, 1) / h^2, on an f64
    (n, n) field; nodes outside the grid are 0."""
    if u.dtype != torch.float64:
        raise TypeError(f"the reference applies in float64, got {u.dtype}")
    n = u.shape[-1]
    inv_h2 = 1.0 / (grid_h(n) ** 2)
    au = -4.0 * u
    au[1:] += u[:-1]
    au[:-1] += u[1:]
    au[:, 1:] += u[:, :-1]
    au[:, :-1] += u[:, 1:]
    return au * inv_h2


def rss(b: torch.Tensor, au: torch.Tensor) -> float:
    """sum((b - A u)^2) in f64 (the reference's residual sum of squares)."""
    r = b - au
    return float(torch.dot(r.reshape(-1), r.reshape(-1)))
