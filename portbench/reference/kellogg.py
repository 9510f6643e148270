"""Frozen copy of Kellogg's intersecting-interfaces operator, and two f64
applies: of (3, 3, n, n) planes, and in flux form straight from the cell
coefficients.

The problem (R. B. Kellogg, Applicable Anal. 4 (1974) 101-129; problem
"Intersecting Interfaces" of W. F. Mitchell, Appl. Math. Comput. 220
(2013) 350-364): -div(p grad u) = f on (-1, 1)^2, p = R in the first and
third quadrants (x y > 0) and 1 in the second and fourth, R of the
alpha = 0.1 set. Discretised on the grid of ``operators.py`` by the
vertex-centred finite-volume (box) scheme: p is constant on each of the
(n+1)^2 grid cells, each edge between two nodes carries the mean of the
two cells that share it, and A u at a node is the sum over its four
edges of (edge mean) (u_neighbour - u) / h^2, a neighbour outside the
grid 0 (homogeneous Dirichlet): the sign of ``operators.poisson5_apply``,
which it equals where p == 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.operators import grid_h

R = 161.4476387975881


def cells(n: int, device=None) -> torch.Tensor:
    """p on the (n+1, n+1) cells, f64: cell (J, I) spans nodes J-1..J by
    I-1..I (node -1 and node n on the boundary), its centre at
    (-1 + (J + 1/2) h, -1 + (I + 1/2) h); R where the centre's x y > 0,
    read off the signs of the integers 2 J + 1 - (n + 1)."""
    k = torch.arange(n + 1, device=device)
    s = torch.sign(2 * k + 1 - (n + 1)).to(torch.float64)
    prod = s.reshape(-1, 1) * s.reshape(1, -1)
    p = torch.ones((n + 1, n + 1), dtype=torch.float64, device=device)
    p[prod > 0] = R
    return p


def edges(p: torch.Tensor) -> tuple:
    """The edge means: ``ej[J, i]`` between nodes (J-1, i) and (J, i), of
    cells (J, i) and (J, i+1); ``ei[j, I]`` between (j, I-1) and (j, I),
    of cells (j, I) and (j+1, I). Rows 0 and n of ``ej`` and columns 0 and
    n of ``ei`` reach the boundary."""
    return 0.5 * (p[:, :-1] + p[:, 1:]), 0.5 * (p[:-1, :] + p[1:, :])


def planes(p: torch.Tensor) -> torch.Tensor:
    """The box scheme's (3, 3, n, n) f64 planes of the cell coefficient
    ``p``: ``c[1 + dj, 1 + di][j, i]`` couples node (j, i) to (j + dj, i +
    di); the diagonal is minus the sum of the node's four edges, those to
    the boundary included; couplings to the boundary are 0."""
    n = p.shape[0] - 1
    inv_h2 = 1.0 / grid_h(n) ** 2
    ej, ei = edges(p.to(torch.float64))
    c = torch.zeros((3, 3, n, n), dtype=torch.float64, device=p.device)
    c[0, 1] = ej[:-1] * inv_h2
    c[2, 1] = ej[1:] * inv_h2
    c[1, 0] = ei[:, :-1] * inv_h2
    c[1, 2] = ei[:, 1:] * inv_h2
    c[1, 1] = -(c[0, 1] + c[2, 1] + c[1, 0] + c[1, 2])
    c[0, 1, 0] = 0.0
    c[2, 1, -1] = 0.0
    c[1, 0, :, 0] = 0.0
    c[1, 2, :, -1] = 0.0
    return c


def planes_apply(c: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A u of (3, 3, n, n) planes on an f64 (n, n) field: the sum of the
    nine shifted products, nodes outside the grid 0."""
    if u.dtype != torch.float64 or c.dtype != torch.float64:
        raise TypeError(f"the reference applies in float64, got {u.dtype} "
                        f"and planes in {c.dtype}")
    n = u.shape[-1]
    up = F.pad(u, (1, 1, 1, 1))
    au = torch.zeros_like(u)
    for a in range(3):
        for b in range(3):
            au += c[a, b] * up[a:a + n, b:b + n]
    return au


def flux_apply(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A u in flux form, from the cell coefficient ``p`` alone (no
    planes): per node, the sum over its four edges of (edge mean) (u_nb -
    u) / h^2, u_nb 0 outside the grid."""
    if u.dtype != torch.float64:
        raise TypeError(f"the reference applies in float64, got {u.dtype}")
    n = u.shape[-1]
    ej, ei = edges(p.to(torch.float64))
    up = F.pad(u, (1, 1, 1, 1))
    flux = (ej[:-1] * (up[:-2, 1:-1] - u) + ej[1:] * (up[2:, 1:-1] - u)
            + ei[:, :-1] * (up[1:-1, :-2] - u)
            + ei[:, 1:] * (up[1:-1, 2:] - u))
    return flux / grid_h(n) ** 2
