"""Krylov acceleration: conjugate gradient preconditioned by one V-cycle.

PyTorch port of ``amg_tpu/krylov.py``. The Poisson operator is symmetric
negative definite, so CG runs on the negated system -A u = -b and M^-1 is
minus one V-cycle from zero (the V-cycle is linear in its rhs, so M stays
SPD). The stopping rule is the reference's: rss of the recurrence residual
against an absolute tolerance, checked every iteration.

Two loops, as in the JAX package: ``solve_pcg_stencil``, the host loop
with a history, which reads the rss once per iteration, and
``solve_pcg_device``, JAX's one ``lax.while_loop`` program: on the card
one CUDA graph whose convergence control runs on the device
(``ops/kernels/graph_loop.py``), with no host read; on the CPU the same
loop pieces under a host driver.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from amg_tpu_torch.ops.kernels import graph_loop
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
            plan = level_plan(hier, 1, 1, ms, fused)

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


def _pcg_loop(hier: StencilHierarchy, shape: tuple, dtype, device,
              fused: bool, min_side: int | None) -> SimpleNamespace:
    """JAX's _pcg_device in cond/body form on fixed buffers: the state
    (u, r, z, p, rz, it, err) from u = 0, the loop while err > tol and it <
    n, stats [err, it] in the field's dtype. The condition reads err and
    tol as f64 (exact for an f32 field)."""
    A = hier.levels[0]

    def A_neg(x):
        return -A.matvec2(x)

    precond = _preconditioner(hier, fused, min_side)

    def zeros(shape_, dtype_=dtype):
        return torch.zeros(shape_, dtype=dtype_, device=device)
    L = SimpleNamespace(b=zeros(shape), u=zeros(shape), r=zeros(shape),
                        z=zeros(shape), p=zeros(shape), rz=zeros(()),
                        err=zeros(()), tol=zeros(()),
                        err64=zeros((), torch.float64),
                        tol64=zeros((), torch.float64),
                        it=zeros((), torch.int32), n=zeros((), torch.int32),
                        stats=zeros(2))

    def set_err(r):
        L.err.copy_(rss_from_residual(r))
        L.err64.copy_(L.err)

    def start():
        r = -L.b
        z = precond(r)
        L.u.zero_()
        L.r.copy_(r)
        L.z.copy_(z)
        L.p.copy_(z)
        L.rz.copy_(_dot(r, z))
        set_err(r)
        L.tol64.copy_(L.tol)
        L.it.zero_()

    def body():
        for buf, x in zip((L.u, L.r, L.z, L.p, L.rz),
                          _step(A_neg, precond, L.u, L.r, L.z, L.p, L.rz)):
            buf.copy_(x)
        set_err(L.r)

    def finish():
        L.stats.copy_(torch.stack([L.err, L.it.to(dtype)]))

    L.loop = graph_loop.DeviceLoop(body, err=L.err64, tol=L.tol64, it=L.it,
                                   n=L.n)
    L.program = (start, finish)
    L.graph = None
    return L


def _pcg_state(hier: StencilHierarchy, b2: torch.Tensor, fused: bool,
               min_side: int | None, n_iters: int) -> SimpleNamespace:
    """solve_pcg_device's loop for b2, cached on the hierarchy under what
    JAX makes static (shape, dtype, fused, min_side, n_iters; the
    tolerance is a device scalar written before each run); ``graph`` is
    its loop graph once captured (``_pcg_graph``)."""
    loops = hier.__dict__.setdefault("_pcg_loops", {})
    key = (tuple(b2.shape), b2.dtype, b2.device, fused, min_side, n_iters)
    L = loops.get(key)
    if L is None:
        L = loops[key] = _pcg_loop(hier, tuple(b2.shape), b2.dtype,
                                   b2.device, fused, min_side)
    return L


def _pcg_graph(L: SimpleNamespace) -> graph_loop.LoopGraph:
    """The loop's graph on the card, captured at its first use."""
    if L.graph is None:
        L.graph = L.loop.graph(*L.program)
    return L.graph


def _solve_pcg_device(hier: StencilHierarchy, b2: torch.Tensor,
                      tolerance: float, n_iters: int, fused: bool,
                      min_side: int | None, host: bool = False):
    """One run of solve_pcg_device's loop: on the card one launch of its
    graph, on the CPU (or with ``host=True``, the oracle) the host driver
    of the same pieces. Returns clones of (u, stats)."""
    L = _pcg_state(hier, b2, fused, min_side, n_iters)
    L.b.copy_(b2)
    L.tol.fill_(tolerance)
    L.n.fill_(n_iters)
    if host or b2.device.type != "cuda":
        L.loop.run_host(*L.program)
    else:
        _pcg_graph(L).launch()
    return L.u.clone(), L.stats.clone()


def solve_pcg_device(hier: StencilHierarchy, b2: torch.Tensor,
                     tolerance: float = 1e-7, n_iters: int = 100,
                     fused: bool = False, min_side: int | None = None):
    """PCG from u = 0 with the state kept on the device (JAX's one
    ``lax.while_loop`` program). Returns ``(u, stats)``, ``stats`` the
    device tensor ``[rss, iterations]`` in b2's dtype; on the card one
    graph launch and no host synchronization (the graph is captured at
    the first call of each shape, dtype and options). ``fused`` runs the
    packed levels' fused kernels (legs, split) on a packed hierarchy. f32
    reaches about 1e-5 at 2047^2-4095^2; the defect-correction solve
    (StructuredSolver) is the way below it."""
    return _solve_pcg_device(hier, b2, tolerance, n_iters, fused, min_side)
