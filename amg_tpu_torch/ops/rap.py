"""Closed-form Galerkin coarsening of the constant Poisson stencil, and the
dense operators the hierarchy build needs.

PyTorch port of ``amg_tpu/ops/rap.py:92-172``. ``poisson_const_w33`` is pure
Python f64 arithmetic in the same order as the reference module, so the
weight tuples are identical.
"""

from __future__ import annotations

import torch


def coarsen_tridiag(off: float, diag: float) -> tuple[float, float]:
    """1-D Galerkin RAP of a constant symmetric tridiagonal (off, diag)
    under the [1/2, 1, 1/2] transfer: diag' = 1.5*diag + 2*off,
    off' = off + diag/4."""
    return off + diag / 4.0, 1.5 * diag + 2.0 * off


def poisson_const_w33(side: int, n_levels: int) -> list[tuple]:
    """Per-level constant 3x3 stencil weights of the Poisson hierarchy,
    in f64: A_l = M_l (x) K_l + K_l (x) M_l with M, K constant symmetric
    tridiagonals, so w33_l[dj][di] = M_l[dj]*K_l[di] + K_l[dj]*M_l[di]."""
    h = 2.0 / (side + 1)
    K = (1.0 / (h * h), -2.0 / (h * h))  # (off, diag) of D
    M = (0.0, 1.0)                       # (off, diag) of I
    out = []
    for _ in range(n_levels):
        m = {-1: M[0], 0: M[1], 1: M[0]}
        k = {-1: K[0], 0: K[1], 1: K[0]}
        out.append(tuple(
            tuple(m[dj] * k[di] + k[dj] * m[di] for di in (-1, 0, 1))
            for dj in (-1, 0, 1)))
        M = coarsen_tridiag(*M)
        K = coarsen_tridiag(*K)
    return out


def planes_to_dense(c: torch.Tensor) -> torch.Tensor:
    """Densify (3,3,n,n) coefficient planes into the (n^2, n^2) matrix
    (the coarsest-level factorization input)."""
    n = c.shape[-1]
    N = n * n
    out = torch.zeros((N, N), dtype=c.dtype, device=c.device)
    j = torch.arange(n, device=c.device).reshape(n, 1).expand(n, n)
    i = torch.arange(n, device=c.device).reshape(1, n).expand(n, n)
    rows = (j * n + i).reshape(-1)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            jj = j + dj
            ii = i + di
            ok = (jj >= 0) & (jj < n) & (ii >= 0) & (ii < n)
            cols = (jj.clamp(0, n - 1) * n + ii.clamp(0, n - 1)).reshape(-1)
            vals = torch.where(ok, c[dj + 1, di + 1],
                               torch.zeros((), dtype=c.dtype,
                                           device=c.device)).reshape(-1)
            out.index_put_((rows, cols), vals, accumulate=True)
    return out


def interp1d_dense(n_f: int, n_c: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """Dense 1-D transfer matrix P1 (n_f x n_c):
    P1[f, c] = w(f - 2c - 1) with w = [1/2, 1, 1/2]."""
    f = torch.arange(n_f, device=device).reshape(n_f, 1)
    cc = torch.arange(n_c, device=device).reshape(1, n_c)
    d = (f - 2 * cc - 1).abs()
    one = torch.ones((), dtype=dtype, device=device)
    return torch.where(d == 0, one,
                       torch.where(d == 1, 0.5 * one, 0.0 * one))
