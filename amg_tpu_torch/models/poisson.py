"""2-D Poisson model problem: grid spacing, forcing vector and the host
scipy Laplacian.

PyTorch port of ``amg_tpu/models/poisson.py`` (all but the ELL
``laplacian``). The forcing is evaluated in numpy exactly as the reference
does, so ``rhs`` is bitwise equal to ``amg_tpu.models.poisson.rhs`` (same
grid, same column-major dof order: ``b[j*n + i] = f(x[j+1], x[i+1])``).
The scipy matrices are the distributed solver's setup input
(parallel/structured_dist.py), built on the host as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from amg_tpu_torch.utils.device import resolve_device

# Two boundary points flank each direction (reference: grid.hpp:22).
N_BOUNDARY_POINTS = 2


def grid_spacing_h(n: int) -> float:
    """Grid spacing for n interior points on [-1, 1] (grid.hpp:31)."""
    return 2.0 / (n + 1)


def points_n_from_grid_spacing_h(h: float = 1.0 / 50) -> int:
    """Inverse of grid_spacing_h (grid.hpp:38-40)."""
    return int(2 / h - 1)


def second_order_central_difference(n: int) -> sp.csr_matrix:
    """1-D tridiagonal second-order central difference: -2 on the
    diagonal, +1 off it, all over h^2 (grid.hpp:50-75); host scipy CSR."""
    h = grid_spacing_h(n)
    main = np.full(n, -2.0)
    off = np.ones(n - 1)
    D = sp.diags([off, main, off], [-1, 0, 1], format="csr")
    return (D / (h * h)).tocsr()


def laplacian_scipy(n: int) -> sp.csr_matrix:
    """5-point Laplacian ``kron(I, D) + kron(D, I)``, shape (n^2, n^2),
    lexicographic dofs ``j*n + i`` (grid.hpp:88-98): -4/h^2 on the
    diagonal, +1/h^2 to the neighbours. Built from its five diagonals (the
    +-1 diagonals vanish where i wraps), as the JAX package does."""
    h = grid_spacing_h(n)
    N = n * n
    inv_h2 = 1.0 / (h * h)
    main = np.full(N, -4.0 * inv_h2)
    off1 = np.full(N - 1, inv_h2)
    off1[n - 1::n] = 0.0
    offn = np.full(N - n, inv_h2)
    return sp.diags([offn, off1, main, off1, offn],
                    [-n, -1, 0, 1, n], format="csr")


def default_forcing(x, y):
    """Default forcing ``f(x,y) = 5 exp(-10 (x^2 + y^2))`` (grid.hpp:110-112)."""
    return 5.0 * np.exp(-10.0 * (x * x + y * y))


def rhs(n: int, f=default_forcing, dtype=torch.float64,
        device=None) -> torch.Tensor:
    """Forcing vector b (flat, length n^2): f at the n x n interior points,
    outer loop j over x, inner loop i over y (grid.hpp:108-140).
    ``device`` None means ``"cuda"`` (utils/device.py)."""
    device = resolve_device(device)
    domain = np.linspace(-1.0, 1.0, n + N_BOUNDARY_POINTS)
    interior = domain[1:-1]
    X, Y = np.meshgrid(interior, interior, indexing="ij")  # X varies with j
    b = f(X, Y).reshape(-1)
    return torch.as_tensor(b).to(dtype=dtype, device=device)
