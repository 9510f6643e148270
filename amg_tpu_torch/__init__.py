"""amg_tpu_torch: the PyTorch + CUDA port of amg_tpu for NVIDIA Hopper GPUs.

The JAX package ``amg_tpu`` is the reference this package is checked
against; this package imports neither JAX nor ``amg_tpu``. It holds the
single-device structured solve of ``amg_tpu.StructuredSolver``, for the
constant-coefficient Poisson problem and for variable coefficients:

    from amg_tpu_torch import StructuredSolver, poisson, varcoef
    s = StructuredSolver(1023)                      # device="cuda"
    b2 = poisson.rhs(1023).reshape(1023, 1023)
    u4, stats = s.solve_ir_device_prepared(s.prepare_b(b2), tolerance=1e-7)
    u = s.finalize_u(u4)

    v = StructuredSolver(2047, A_planes=varcoef.jump_planes(2047))
    u, stats = v.solve_ir_device(poisson.rhs(2047).reshape(2047, 2047))

with the other smoothers (``smoother="masked"``, ``"strided"``,
``"chebyshev"``, ``"fused"``), a scipy fine matrix (``A_fine=``, its
hierarchy built on the host by ``build_stencil_hierarchy``), a zero start
(``fmg=False``) and the host-stepped ``solve_ir``; the one-shot loops
``solve_stencil`` and ``solve_ir`` of the JAX package;

the AMG-preconditioned conjugate gradient of ``amg_tpu.krylov``:

    h = build_stencil_hierarchy_device(4095, smoother="packed")
    b32 = poisson.rhs(4095, dtype=torch.float32).reshape(4095, 4095)
    u, stats = solve_pcg_device(h, b32, tolerance=1e-5, fused=True)

and the row-partitioned distributed solve of
``amg_tpu.parallel.structured_dist`` over a mesh of D row slabs on one
device (``halo="rdma"``: the exchange is a CUDA kernel):

    d = DistStructuredSolver(4095, n_devices=4, halo="rdma")
    res = d.solve_ir_fused(poisson.rhs(4095).reshape(4095, 4095), 1e-7)

and the reference-parity ELL pipeline of ``amg_tpu.multigrid`` (the
reference's Multigrid object, its smoothers and interpolators, a host or
device Galerkin chain), in plain PyTorch as in JAX:

    A, b = poisson.poisson2d(35)                    # device="cuda"
    amg = Multigrid(None, SparseGaussSeidel(), A, b, 8, 1e-9, 5, 100)
    res = amg.solve()                               # 35 V-cycles

The ELL names are those of ``amg_tpu/__init__.py``; its ``enable_x64``
has no counterpart (torch takes the dtype of each tensor).

Entry points run on the card unless given ``device="cpu"``. The
hand-written CUDA kernels (``ops/kernels``, sources in ``csrc``) build
with ``nvcc`` at their first launch, never at import.
"""

from amg_tpu_torch.krylov import solve_pcg_device, solve_pcg_stencil
from amg_tpu_torch.models import poisson, varcoef
from amg_tpu_torch.multigrid import (Hierarchy, Level, Multigrid, SolveResult,
                                     build_hierarchy, galerkin_rap,
                                     n_H_dofs_from_n_h_dofs, solve, vcycle)
from amg_tpu_torch.ops.doublefloat import DF32
from amg_tpu_torch.ops.smoothers import (Jacobi, MulticolorGaussSeidel,
                                         SmootherResult, SparseGaussSeidel,
                                         SuccessiveOverRelaxation)
from amg_tpu_torch.ops.transfer import (BilinearInterpolator2D,
                                        InterpolatorBase, LinearInterpolator)
from amg_tpu_torch.parallel.structured_dist import DistStructuredSolver
from amg_tpu_torch.sparse.ell import ELL
from amg_tpu_torch.sparse.stencil import Stencil2D
from amg_tpu_torch.structured import (StencilHierarchy,
                                      StructuredSolver,
                                      build_fine_stencil_f64,
                                      build_stencil_hierarchy,
                                      build_stencil_hierarchy_device,
                                      build_stencil_hierarchy_planes,
                                      solve_ir, solve_stencil, vcycle_packed,
                                      vcycle_stencil)
from amg_tpu_torch.utils.metrics import rss, rss_from_residual

__all__ = ["BilinearInterpolator2D", "DF32", "DistStructuredSolver", "ELL",
           "Hierarchy", "InterpolatorBase", "Jacobi", "Level",
           "LinearInterpolator", "MulticolorGaussSeidel", "Multigrid",
           "SmootherResult", "SolveResult", "SparseGaussSeidel", "Stencil2D",
           "StencilHierarchy", "StructuredSolver",
           "SuccessiveOverRelaxation", "build_fine_stencil_f64",
           "build_hierarchy", "build_stencil_hierarchy",
           "build_stencil_hierarchy_device", "build_stencil_hierarchy_planes",
           "galerkin_rap", "n_H_dofs_from_n_h_dofs", "poisson", "rss",
           "rss_from_residual", "solve", "solve_ir", "solve_pcg_device",
           "solve_pcg_stencil", "solve_stencil", "varcoef", "vcycle",
           "vcycle_packed", "vcycle_stencil"]
