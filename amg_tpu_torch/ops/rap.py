"""Closed-form Galerkin coarsening of 9-point stencils, and the dense
operators the hierarchy build needs.

PyTorch port of ``amg_tpu/ops/rap.py:28-75, 92-172``. ``poisson_const_w33``
is pure Python f64 arithmetic in the same order as the reference module,
so the weight tuples are identical; ``rap_stencil_planes`` sums its terms
in the reference's order, so the coarse planes are bitwise equal.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_W = (0.5, 1.0, 0.5)  # w(-1), w(0), w(1): the transfer stencil


def rap_stencil_planes(c: torch.Tensor) -> torch.Tensor:
    """Galerkin-coarsen (3,3,n,n) coefficient planes (n odd >= 3) under the
    tensor-product bilinear transfer: returns (3,3,nc,nc), nc = (n-1)/2,

      A_H[dJ,dI][a,b] = sum w(d1) w(d2) w(d1') w(d2')
                        * c[2dJ+d1'-d1, 2dI+d2'-d2][2a+1+d1, 2b+1+d2]

    over the offsets with |2dJ+d1'-d1| <= 1 and |2dI+d2'-d2| <= 1, with
    couplings to coarse dofs outside the grid set to 0."""
    n = c.shape[-1]
    nc = (n - 1) // 2
    cp = F.pad(c, (1, 1, 1, 1))

    def sample(dj, di, d1, d2):
        # fine rows 2a+1+d1, a in [0, nc): padded index 2a+2+d1
        return cp[dj + 1, di + 1, 2 + d1:2 + d1 + 2 * nc - 1:2,
                  2 + d2:2 + d2 + 2 * nc - 1:2]

    a_idx = torch.arange(nc, device=c.device).reshape(nc, 1)
    b_idx = torch.arange(nc, device=c.device).reshape(1, nc)
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    out = torch.zeros((3, 3, nc, nc), dtype=c.dtype, device=c.device)
    for dJ in (-1, 0, 1):
        for dI in (-1, 0, 1):
            acc = torch.zeros((nc, nc), dtype=c.dtype, device=c.device)
            for d1 in (-1, 0, 1):
                for d1p in (-1, 0, 1):
                    dj = 2 * dJ + d1p - d1
                    if abs(dj) > 1:
                        continue
                    for d2 in (-1, 0, 1):
                        for d2p in (-1, 0, 1):
                            di = 2 * dI + d2p - d2
                            if abs(di) > 1:
                                continue
                            w = (_W[d1 + 1] * _W[d2 + 1] * _W[d1p + 1]
                                 * _W[d2p + 1])
                            acc = acc + w * sample(dj, di, d1, d2)
            valid = ((a_idx + dJ >= 0) & (a_idx + dJ < nc)
                     & (b_idx + dI >= 0) & (b_idx + dI < nc))
            out[dJ + 1, dI + 1] = torch.where(valid, acc, zero)
    return out


def poisson_planes(side: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """The fine 5-point Laplacian as (3,3,n,n) planes (-4/h^2 diagonal,
    +1/h^2 neighbours, boundary couplings 0), built on ``device``."""
    n = side
    h = 2.0 / (n + 1)
    one = torch.full((n, n), 1.0 / (h * h), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    j = torch.arange(n, device=device).reshape(n, 1)
    i = torch.arange(n, device=device).reshape(1, n)
    c = torch.zeros((3, 3, n, n), dtype=dtype, device=device)
    c[1, 1] = -4.0 * one
    c[0, 1] = torch.where(j > 0, one, zero)         # u[j-1, i]
    c[2, 1] = torch.where(j < n - 1, one, zero)     # u[j+1, i]
    c[1, 0] = torch.where(i > 0, one, zero)         # u[j, i-1]
    c[1, 2] = torch.where(i < n - 1, one, zero)     # u[j, i+1]
    return c


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
