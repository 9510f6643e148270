"""Krylov acceleration: conjugate gradient preconditioned by one V-cycle.

PyTorch port of ``amg_tpu/krylov.py``. The Poisson operator is symmetric
negative definite, so CG runs on the negated system -A u = -b and M^-1 is
minus one V-cycle from zero (the V-cycle is linear in its rhs, so M stays
SPD). The stopping rule is the reference's: rss of the recurrence residual
against an absolute tolerance, checked every iteration.

Two loops, as in the JAX package: ``solve_pcg_stencil``, the host loop
with a history, and ``solve_pcg_device``, which keeps the state on the
device and returns device stats. Both read the rss once per iteration (one
host sync), as the solver's refine loops read it once per refine; a CUDA
graph of the iteration is later work.
"""

from __future__ import annotations

import torch

from amg_tpu_torch.structured import (PACKED_MIN_SIDE, SolveResult,
                                      StencilHierarchy, level_plan,
                                      vcycle_packed, vcycle_stencil)
from amg_tpu_torch.utils.debugging import check_rss
from amg_tpu_torch.utils.metrics import rss_from_residual


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.dot(x.reshape(-1), y.reshape(-1))


def _preconditioner(hier: StencilHierarchy, fused: bool = False,
                    min_side: int | None = None, cycle=None):
    """z = -cycle(hier, 0, r). By default a packed hierarchy takes the
    color-packed V-cycle (with the fused kernels when ``fused``) and any
    other the unpacked V-cycle (vcycle_stencil)."""
    if cycle is None:
        if hier.smoother == "packed":
            ms = PACKED_MIN_SIDE if min_side is None else min_side
            plan = level_plan(hier.sides, 1, 1, ms, fused, var=hier.is_var)

            def cycle(h, z, r):
                return vcycle_packed(h, z, r, min_side=ms, fused=fused,
                                     plan=plan)
        else:
            cycle = vcycle_stencil
    return lambda r: -cycle(hier, torch.zeros_like(r), r)


def _step(A_neg, precond, u, r, z, p, rz, dot=_dot):
    """One PCG iteration; ``rz`` is (r, z) carried from the last one.
    ``dot`` is the inner product (the distributed solvers' sums over the
    slabs and processes)."""
    Ap = A_neg(p)
    alpha = rz / dot(p, Ap)
    u = u + alpha * p
    r = r - alpha * Ap
    z = precond(r)
    rz_new = dot(r, z)
    p = z + (rz_new / rz) * p
    return u, r, z, p, rz_new


def _tolerance(tolerance: float, dtype) -> float:
    """The tolerance rounded to the field's dtype: the JAX loops compare
    the rss with it in that dtype."""
    return float(torch.tensor(tolerance, dtype=dtype))


def solve_pcg_stencil(hier: StencilHierarchy, b2: torch.Tensor,
                      tolerance: float = 1e-9, n_iters: int = 100, u0=None,
                      cycle=None) -> SolveResult:
    """Preconditioned CG on the structured hierarchy (M^-1 = one V-cycle
    from zero, ``cycle`` or the hierarchy's default); returns the solution
    of the original system with the rss history."""
    A = hier.levels[0]

    def A_neg(x):
        return -A.matvec2(x)

    precond = _preconditioner(hier, cycle=cycle)
    if u0 is None:
        u0 = torch.zeros_like(b2)
    r = -b2 - A_neg(u0)
    z = precond(r)
    u, p, rz = u0, z, _dot(r, z)
    tol = _tolerance(tolerance, b2.dtype)
    it = 0
    error = check_rss(float(rss_from_residual(r)))
    history = [(0, error)]
    while it < n_iters and error > tol:
        u, r, z, p, rz = _step(A_neg, precond, u, r, z, p, rz)
        it += 1
        error = check_rss(float(rss_from_residual(r)))
        history.append((it, error))
    return SolveResult(u=u, iterations=it, error=error,
                       converged=error <= tol, history=history)


def solve_pcg_device(hier: StencilHierarchy, b2: torch.Tensor,
                     tolerance: float = 1e-7, n_iters: int = 100,
                     fused: bool = False, min_side: int | None = None):
    """PCG from u = 0 with the state kept on the device. Returns
    ``(u, stats)``, ``stats`` the device tensor ``[rss, iterations]`` in
    b2's dtype. ``fused`` runs the packed levels' fused kernels (legs,
    split) on a packed hierarchy. f32 reaches about 1e-5 at 2047^2-4095^2;
    the defect-correction solve (StructuredSolver) is the way below it."""
    A = hier.levels[0]

    def A_neg(x):
        return -A.matvec2(x)

    precond = _preconditioner(hier, fused, min_side)
    tol = _tolerance(tolerance, b2.dtype)
    r = -b2
    z = precond(r)
    u, p, rz = torch.zeros_like(b2), z, _dot(r, z)
    err = rss_from_residual(r)
    it = 0
    while check_rss(float(err)) > tol and it < n_iters:  # one host sync
        u, r, z, p, rz = _step(A_neg, precond, u, r, z, p, rz)
        err = rss_from_residual(r)
        it += 1
    return u, torch.stack([err, torch.tensor(float(it), dtype=b2.dtype,
                                             device=b2.device)])
