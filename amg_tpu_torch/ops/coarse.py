"""Coarsest-level direct solver.

PyTorch port of ``amg_tpu/ops/coarse.py:25-35``. The reference factors the
coarsest Galerkin matrix once (Eigen SimplicialLDLT, multigrid.hpp:240-243)
and back-solves every V-cycle; the coarsest level is small (8 dofs in the
reference benchmark), so it is densified and LU-factored, with partial
pivoting for the Laplacian's negative-definite sign.

``torch.linalg.lu_factor`` returns LAPACK's 1-based int32 pivots, JAX's
``lu_factor`` 0-based ones: ``pivots_from_jax`` and ``pivots_to_jax``
convert between the two (interop, checkpoints).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from amg_tpu_torch.sparse.ell import ELL


def pivots_from_jax(piv, device=None) -> torch.Tensor:
    """JAX's 0-based LU pivots as torch's 1-based int32 ones."""
    return torch.tensor(np.asarray(piv).astype(np.int32) + 1, device=device)


def pivots_to_jax(piv: torch.Tensor) -> np.ndarray:
    """torch's 1-based LU pivots as JAX's 0-based int32 ones."""
    return (piv.cpu().numpy() - 1).astype(np.int32)


def cusolver_linalg() -> None:
    """Make torch.linalg take cuSOLVER for the process (where it takes its
    default): the coarsest solve's ``lu_solve`` then runs cuSOLVER's
    ``getrs`` in every thread and process. The default heuristic took
    cuBLAS's batched ``getrs`` in some threads (after an eager solve on
    another stream), whose bits can differ from cuSOLVER's and whose CUDA
    graph capture holds stream-ordered allocation nodes, which the loop
    graphs' child graphs cannot hold (H100, driver 13.0, torch 2.11)."""
    cuda = torch.backends.cuda
    if cuda.preferred_linalg_library() == torch._C._LinalgBackend.Default:
        cuda.preferred_linalg_library("cusolver")


@dataclasses.dataclass(frozen=True)
class CoarseSolver:
    lu: torch.Tensor
    piv: torch.Tensor  # 1-based (LAPACK)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """On the card torch.linalg takes cuSOLVER from the first solve on
        (``cusolver_linalg``)."""
        if b.is_cuda:
            cusolver_linalg()
        return torch.linalg.lu_solve(self.lu, self.piv, b[:, None])[:, 0]

    def to(self, device) -> "CoarseSolver":
        return CoarseSolver(lu=self.lu.to(device), piv=self.piv.to(device))


def setup_coarse_solver(A: ELL) -> CoarseSolver:
    """Dense LU of the coarsest level, on A's device."""
    lu, piv = torch.linalg.lu_factor(A.to_dense())
    return CoarseSolver(lu=lu, piv=piv)
