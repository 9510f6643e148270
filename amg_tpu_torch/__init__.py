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

and the row-partitioned distributed solve of
``amg_tpu.parallel.structured_dist`` over a mesh of D row slabs on one
device (``halo="rdma"``: the exchange is a CUDA kernel):

    d = DistStructuredSolver(4095, n_devices=4, halo="rdma")
    res = d.solve_ir_fused(poisson.rhs(4095).reshape(4095, 4095), 1e-7)

Entry points run on the card unless given ``device="cpu"``. The
hand-written CUDA kernels (``ops/kernels``, sources in ``csrc``) build
with ``nvcc`` at their first launch, never at import.
"""

from amg_tpu_torch.models import poisson, varcoef
from amg_tpu_torch.ops.doublefloat import DF32
from amg_tpu_torch.parallel.structured_dist import DistStructuredSolver
from amg_tpu_torch.structured import (SolveResult, StencilHierarchy,
                                      StructuredSolver,
                                      build_stencil_hierarchy_device,
                                      build_stencil_hierarchy_planes,
                                      vcycle_packed)
from amg_tpu_torch.utils.metrics import rss_from_residual

__all__ = ["DF32", "DistStructuredSolver", "SolveResult",
           "StencilHierarchy", "StructuredSolver",
           "build_stencil_hierarchy_device", "build_stencil_hierarchy_planes",
           "poisson", "rss_from_residual", "varcoef", "vcycle_packed"]
