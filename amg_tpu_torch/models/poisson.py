"""2-D Poisson model problem: grid spacing and forcing vector.

PyTorch port of ``amg_tpu/models/poisson.py`` (the parts the constant-
coefficient solve needs). The forcing is evaluated in numpy exactly as the
reference does, so ``rhs`` is bitwise equal to ``amg_tpu.models.poisson.rhs``
(same grid, same column-major dof order: ``b[j*n + i] = f(x[j+1], x[i+1])``).
"""

from __future__ import annotations

import numpy as np
import torch

from amg_tpu_torch.utils.device import resolve_device

# Two boundary points flank each direction (reference: grid.hpp:22).
N_BOUNDARY_POINTS = 2


def grid_spacing_h(n: int) -> float:
    """Grid spacing for n interior points on [-1, 1] (grid.hpp:31)."""
    return 2.0 / (n + 1)


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
