"""Variable-coefficient 2-D diffusion problems: -div(a grad u) = f.

PyTorch port of ``amg_tpu/models/varcoef.py:28-128``: the jump-coefficient
(optionally anisotropic) operator as (3,3,n,n) stencil planes, built on the
device, and its scipy assembly for the tests.

Discretization: 5-point finite volumes on the grid of models/poisson.py
(h = 2/(n+1), u2[j, i] at (x_j, y_i) = (-1 + (j+1)h, -1 + (i+1)h)), face
diffusivities by the harmonic mean of the nodal coefficient, negative
diagonal; with a == 1 the planes equal ops/rap.poisson_planes. Dirichlet
boundaries: out-of-range couplings are dropped from the off-diagonal
planes, their face terms stay in the diagonal.

Rounding follows the JAX version: node coordinates are f32 products of an
f32 h, and every Python scalar meets a tensor as a 0-dim tensor of the
tensor's dtype (JAX's weak-type rule), so the planes are bitwise equal.

Beside it, for a coefficient constant on each grid cell (interfaces
through the nodes), the vertex-centred finite-volume (box) scheme
(``box_planes``) and Kellogg's intersecting-interfaces coefficient
(``kellogg_cells``, ``kellogg_planes``), which have no JAX counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from amg_tpu_torch.utils.device import resolve_device


def jump_coefficient(side: int, a_in: float = 100.0, r: float = 0.5,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """Nodal coefficient on the FULL (n+2, n+2) node set: a = a_in inside
    the centered square |x| < r, |y| < r, else 1."""
    n = side
    device = resolve_device(device)
    h = np.float32(2.0 / (n + 1))
    k = torch.arange(n + 2, device=device).to(torch.float32)
    x = (-1.0 + k * float(h)).to(dtype)
    rr = torch.tensor(r, dtype=dtype, device=device)
    inside_1d = x.abs() < rr
    inside = inside_1d.reshape(n + 2, 1) & inside_1d.reshape(1, n + 2)
    return torch.where(inside, torch.tensor(a_in, dtype=dtype, device=device),
                       torch.tensor(1.0, dtype=dtype, device=device))


def planes_from_nodal(a_full: torch.Tensor, side: int,
                      eps_y: float = 1.0) -> torch.Tensor:
    """(3,3,n,n) stencil planes from a full nodal coefficient field
    ``a_full`` ((n+2, n+2), boundary nodes included). The faces in i (the
    E/W couplings) are scaled by ``eps_y`` (anisotropy)."""
    n = side
    dt, dev = a_full.dtype, a_full.device
    h = 2.0 / (n + 1)

    def s(v):
        return torch.tensor(v, dtype=dt, device=dev)

    inv_h2 = s(1.0 / (h * h))
    two, eps = s(2.0), s(eps_y)

    def hmean(p, q):
        return two * p * q / (p + q)

    a_c = a_full[1:-1, 1:-1]
    aN = hmean(a_c, a_full[2:, 1:-1])             # face to (j+1, i)
    aS = hmean(a_c, a_full[:-2, 1:-1])            # face to (j-1, i)
    aE = hmean(a_c, a_full[1:-1, 2:]) * eps       # face to (j, i+1)
    aW = hmean(a_c, a_full[1:-1, :-2]) * eps      # face to (j, i-1)

    j = torch.arange(n, device=dev).reshape(n, 1)
    i = torch.arange(n, device=dev).reshape(1, n)
    zero = s(0.0)
    c = torch.zeros((3, 3, n, n), dtype=dt, device=dev)
    c[1, 1] = -(aN + aS + aE + aW) * inv_h2
    c[2, 1] = torch.where(j < n - 1, aN * inv_h2, zero)
    c[0, 1] = torch.where(j > 0, aS * inv_h2, zero)
    c[1, 2] = torch.where(i < n - 1, aE * inv_h2, zero)
    c[1, 0] = torch.where(i > 0, aW * inv_h2, zero)
    return c


def jump_planes(side: int, a_in: float = 100.0, r: float = 0.5,
                eps_y: float = 1.0, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """The jump-coefficient diffusion operator as (3,3,n,n) planes, built
    on ``device`` (None means ``"cuda"``)."""
    a = jump_coefficient(side, a_in, r, dtype, device)
    return planes_from_nodal(a, side, eps_y)


def jump_scipy(side: int, a_in: float = 100.0, r: float = 0.5,
               eps_y: float = 1.0):
    """Host (scipy CSR, f64) assembly of the same operator, an independent
    numpy path for the tests."""
    import scipy.sparse as sp

    n = side
    h = 2.0 / (n + 1)
    inv_h2 = 1.0 / (h * h)
    xs = -1.0 + np.arange(n + 2, dtype=np.float64) * np.float64(
        np.float32(h))
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    a_full = np.where((np.abs(X) < r) & (np.abs(Y) < r), a_in, 1.0)

    def hmean(p, q):
        return 2.0 * p * q / (p + q)

    a_c = a_full[1:-1, 1:-1]
    aN = hmean(a_c, a_full[2:, 1:-1])
    aS = hmean(a_c, a_full[:-2, 1:-1])
    aE = hmean(a_c, a_full[1:-1, 2:]) * eps_y
    aW = hmean(a_c, a_full[1:-1, :-2]) * eps_y

    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    row = j * n + i
    parts = [(row, row, -(aN + aS + aE + aW) * inv_h2)]
    for ok, step, a in ((j < n - 1, n, aN), (j > 0, -n, aS),
                        (i < n - 1, 1, aE), (i > 0, -1, aW)):
        parts.append((row[ok], row[ok] + step, a[ok] * inv_h2))
    rows, cols, vals = (np.concatenate([p[k].ravel() for p in parts])
                        for k in range(3))
    return sp.csr_matrix((vals, (rows, cols)), shape=(n * n, n * n))


# Kellogg's intersecting-interfaces problem (R. B. Kellogg, Applicable Anal.
# 4 (1974) 101-129; problem "Intersecting Interfaces" of W. F. Mitchell,
# Appl. Math. Comput. 220 (2013) 350-364): -div(p grad u) = f on (-1, 1)^2
# with p = R in the first and third quadrants and 1 in the second and
# fourth; R of the alpha = 0.1 parameter set.
KELLOGG_R = 161.4476387975881


def kellogg_cells(side: int, dtype=torch.float64,
                  device=None) -> torch.Tensor:
    """Kellogg's coefficient on the (n+1, n+1) grid cells of the side-n
    grid, boundary cells included: cell (J, I) spans the full nodes J..J+1
    by I..I+1 (node k of the n+2 at -1 + k h), and takes KELLOGG_R where
    its centre (-1 + (J + 1/2) h, -1 + (I + 1/2) h) has x y > 0, else 1.
    The sign of a centre coordinate is read off the integer 2 J + 1 - (n +
    1), so the test is exact."""
    device = resolve_device(device)
    k = torch.arange(side + 1, device=device)
    s = torch.sign(2 * k + 1 - (side + 1))
    quad13 = (s.reshape(-1, 1) * s.reshape(1, -1)) > 0
    return torch.where(quad13, torch.tensor(KELLOGG_R, dtype=dtype,
                                            device=device),
                       torch.tensor(1.0, dtype=dtype, device=device))


def box_planes(p_cells: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """(3,3,n,n) planes of the vertex-centred finite-volume (box) scheme
    for -div(p grad u) with ``p_cells`` constant on each of the (n+1,
    n+1) grid cells (boundary cells included; ``kellogg_cells``' layout),
    on the grid of models/poisson.py and with its sign (negative
    diagonal). Each edge couples its two nodes by the arithmetic mean of
    the two cells that share it, over h^2; the diagonal is minus the sum
    of the node's four edges, Dirichlet edges included, whose couplings
    are dropped from the off-diagonal planes. Built in f64, returned in
    ``dtype``; with p == 1 the planes equal ops/rap.poisson_planes."""
    n = int(p_cells.shape[-1]) - 1
    if tuple(p_cells.shape) != (n + 1, n + 1):
        raise ValueError(f"p_cells must be square, got "
                         f"{tuple(p_cells.shape)}")
    p = p_cells.to(torch.float64)
    inv_h2 = 1.0 / (2.0 / (n + 1)) ** 2
    eN = 0.5 * (p[1:, :-1] + p[1:, 1:])       # edge to (j+1, i)
    eS = 0.5 * (p[:-1, :-1] + p[:-1, 1:])     # edge to (j-1, i)
    eE = 0.5 * (p[:-1, 1:] + p[1:, 1:])       # edge to (j, i+1)
    eW = 0.5 * (p[:-1, :-1] + p[1:, :-1])     # edge to (j, i-1)
    j = torch.arange(n, device=p.device).reshape(n, 1)
    i = torch.arange(n, device=p.device).reshape(1, n)
    c = torch.zeros((3, 3, n, n), dtype=torch.float64, device=p.device)
    c[1, 1] = -(eN + eS + eE + eW) * inv_h2
    c[2, 1] = torch.where(j < n - 1, eN * inv_h2, 0.0)
    c[0, 1] = torch.where(j > 0, eS * inv_h2, 0.0)
    c[1, 2] = torch.where(i < n - 1, eE * inv_h2, 0.0)
    c[1, 0] = torch.where(i > 0, eW * inv_h2, 0.0)
    return c.to(dtype)


def kellogg_planes(side: int, dtype=torch.float64,
                   device=None) -> torch.Tensor:
    """Kellogg's operator (``kellogg_cells``) in the box scheme as
    (3,3,n,n) planes, built in f64 on ``device`` (None means ``"cuda"``):
    ``StructuredSolver(side, A_planes=kellogg_planes(side),
    precision="f64")`` keeps these f64 planes as its residual's operator
    and rounds its f32 hierarchy from them."""
    return box_planes(kellogg_cells(side, device=device), dtype)
