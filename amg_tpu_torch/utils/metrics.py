"""Convergence metric: the residual sum of squares (common.hpp:17-27).

PyTorch port of ``amg_tpu/utils/metrics.py``. The reference stops on the
absolute rss, not a norm, so the port keeps the same quantity.
"""

from __future__ import annotations

import torch


def rss_from_residual(r: torch.Tensor) -> torch.Tensor:
    """Residual sum of squares given an explicit residual ``r = b - A u``."""
    return torch.sum(r * r)


def rss(A, u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Residual sum of squares ``sum((b - A u)**2)`` for any operator with
    a flat ``matvec`` (AMG::rss, common.hpp:17-27)."""
    return rss_from_residual(b - A.matvec(u))
