"""Constant 9-point stencil operators on 2-D grids, and the masked
four-color Gauss-Seidel sweep of the coarse levels.

PyTorch port of ``amg_tpu/sparse/stencil.py:31-213, 307-327``, restricted
to the constant-weight operator (``Stencil2D.const``): every level of the
Poisson hierarchy is spatially constant with zero-padding boundary
semantics, so an operator is its static 3x3 weight tuple ``w33`` and no
coefficient plane is ever stored. Fields are indexed ``u2[j, i]`` with
``u2.reshape(-1)`` the reference's dof vector; ``w33[dj+1][di+1]``
multiplies ``u2[j+dj, i+di]``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

# Color visit order: the 2x2-block parity classes.
FOUR_COLORS = ((0, 0), (0, 1), (1, 0), (1, 1))


@dataclasses.dataclass(frozen=True)
class Stencil2D:
    """Constant-stencil 9-point operator on a side x side grid."""

    side: int
    w33: tuple

    @staticmethod
    def const(w33, side: int) -> "Stencil2D":
        if w33 is None:
            raise ValueError("Stencil2D.const requires a w33 tuple")
        return Stencil2D(side=side, w33=w33)

    def matvec2(self, u2: torch.Tensor) -> torch.Tensor:
        """A @ u on the 2-D field: sum of 9 shifted products; the zero
        padding supplies the boundary truncation."""
        n = self.side
        up = F.pad(u2, (1, 1, 1, 1))
        out = torch.zeros_like(u2)
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                w = self.w33[dj + 1][di + 1]
                if w == 0.0:
                    continue
                out = out + w * up[1 + dj:1 + dj + n, 1 + di:1 + di + n]
        return out

    def inv_diag(self) -> float:
        return 1.0 / self.w33[1][1]


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
