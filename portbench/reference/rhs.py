"""Frozen copy of the right-hand-side family: sums of Gaussian sources
a exp(-c ((x - x0)^2 + (y - y0)^2)) at the interior nodes, in f64. The
reference's own forcing 5 exp(-10 (x^2 + y^2)) (grid.hpp:110-112) is the
member with one source a = 5, c = 10 at the origin."""

from __future__ import annotations

import torch


def gaussian_sources(side: int, sources, device) -> torch.Tensor:
    """The (side, side) f64 field ``b[j, i] = sum_s f_s(x_j, y_i)`` for
    ``sources`` a sequence of (a, c, x0, y0), evaluated on ``device``."""
    num = side + 2
    # numpy's linspace arithmetic (k * step - 1, the end point set)
    grid = torch.arange(num, dtype=torch.float64, device=device) * (
        2.0 / (num - 1)) - 1.0
    grid[-1] = 1.0
    x = grid[1:-1]
    b = torch.zeros((side, side), dtype=torch.float64, device=device)
    for a, c, x0, y0 in sources:
        dx2 = (x - x0) ** 2
        dy2 = (x - y0) ** 2
        b += a * torch.exp(-c * (dx2.reshape(side, 1) + dy2.reshape(1, side)))
    return b
