"""Multigrid hierarchy, V-cycle and outer solve loop of the ELL path.

PyTorch port of ``amg_tpu/multigrid.py:48-408`` (the reference's
include/amg/multigrid.hpp):

* ``Hierarchy``: the ``Level``s (each level's ELL operator, its transfers
  to the next coarser level and the smoother's per-level state) and a
  dense LU of the coarsest operator (the reference's SimplicialLDLT,
  multigrid.hpp:240-243). ``build_hierarchy`` runs the Galerkin chain in
  host scipy, ``build_hierarchy_device`` on the device (ops/ell_rap.py);
* ``vcycle``: one V-cycle in the reference's leg order
  (multigrid.hpp:263-305), a function of (u, b);
* ``solve``: the host loop with the reference's stopping rule
  (multigrid.hpp:311-337), ``while iter < n_iters && error > tol``, the
  rss checked every ``compute_error_every_n_iters`` V-cycles; as JAX runs
  one jitted chunk of V-cycles between two checks, on the card each chunk
  is one CUDA graph launch and each check one rss graph and one read
  (``graph_loop.ChunkLoop``, kept with the hierarchy), and on the CPU the
  same pieces run eagerly;
* ``Multigrid``: the reference's object (class AMG::Multigrid), with its
  validations, the stateful ``vcycle()`` and the getters.

Not replicated, as in JAX: the reference smooths the coarsest level and
computes its residual before the direct solve overwrites that solution
(multigrid.hpp:265-288), dead work; and its ``display_error_off`` sets the
flag to true (multigrid.hpp:361-364).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any

import scipy.sparse as sp
import torch
from torch import nn

from amg_tpu_torch.ops.coarse import CoarseSolver, setup_coarse_solver
from amg_tpu_torch.ops.ell_rap import apply_rap_chain, build_rap_plans
from amg_tpu_torch.ops.kernels.graph_loop import ChunkLoop
from amg_tpu_torch.ops.smoothers import (MulticolorGaussSeidel,
                                         MulticolorGSState, SmootherBase,
                                         SparseGaussSeidel)
from amg_tpu_torch.ops.transfer import InterpolatorBase, LinearInterpolator
from amg_tpu_torch.sparse.ell import ELL
from amg_tpu_torch.utils import tracing
from amg_tpu_torch.utils.device import resolve_device
from amg_tpu_torch.utils.metrics import rss


def n_H_dofs_from_n_h_dofs(h_dofs: int) -> int:
    """Coarse dof count (Briggs): n_H = (n_h + 1)/2 - 1
    (multigrid.hpp:127-130)."""
    return (h_dofs + 1) // 2 - 1


@dataclasses.dataclass(frozen=True)
class Level:
    """One level; P and R map to the next coarser level (None on the
    coarsest), as the per-level maps of multigrid.hpp:83-107."""

    A: ELL
    P: Any  # ELL | None
    R: Any  # ELL | None
    smoother_state: Any


def _map_tensors(obj, fn):
    """``obj`` with ``fn`` applied to every tensor in it (ELLs, the
    smoother states and the coarse solver are frozen dataclasses)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_tensors(x, fn) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj) if f.init})
    return obj


class Hierarchy(nn.Module):
    """The levels and the coarsest LU. ``.to(device)`` moves every tensor
    of the levels. ``setup_seconds`` splits the build's host time
    (``rap``, ``upload``, ``smoother`` — coloring and panels —, ``lu``)
    where a build recorded it. ``solve``'s chunk loops (and their graphs)
    live here too, dropped with the hierarchy or when it moves."""

    def __init__(self, levels, coarse: CoarseSolver,
                 setup_seconds: dict | None = None):
        super().__init__()
        self.levels = tuple(levels)
        self.coarse = coarse
        self.setup_seconds = setup_seconds or {}
        self.chunk_loops = {}

    def _apply(self, fn, recurse=True):
        self.levels = _map_tensors(self.levels, fn)
        self.coarse = _map_tensors(self.coarse, fn)
        self.chunk_loops = {}
        return self

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def n_dofs(self, level: int) -> int:
        return self.levels[level].A.n_rows


@dataclasses.dataclass
class SolveResult:
    """Outcome of a solve (the reference's convergence prints,
    multigrid.hpp:323-334)."""

    u: torch.Tensor
    iterations: int
    error: float
    converged: bool
    history: list  # (iteration, rss) at each check


def galerkin_rap(R: sp.spmatrix, A: sp.spmatrix, P: sp.spmatrix):
    """A_H = R (A P): two host SpGEMMs in the reference's association
    order (multigrid.hpp:219-223)."""
    return (R @ (A @ P)).tocsr()


class _Clock:
    """A hierarchy build's phases as set-up spans of the tracing module
    (``setup.rap``, ``setup.upload``, ``setup.smoother``, ``setup.lu``),
    each ending in a device sync so the work it queued is inside it;
    ``seconds`` sums them by phase (``Hierarchy.setup_seconds``)."""

    def __init__(self, device):
        self.device = device
        self.seconds = {"rap": 0.0, "upload": 0.0, "smoother": 0.0,
                        "lu": 0.0}

    def __call__(self, key, fn, *args):
        with tracing.setup_span(f"setup.{key}", self.device) as span:
            out = fn(*args)
        self.seconds[key] += span.seconds
        return out


def build_hierarchy(A, n_levels: int,
                    interpolator: InterpolatorBase | None = None,
                    smoother: SmootherBase | None = None, dtype=None,
                    device=None) -> Hierarchy:
    """The level hierarchy (the reference ctor, multigrid.hpp:151-244), its
    Galerkin chain in host scipy.

    Args:
      A: finest operator, ELL or scipy sparse.
      n_levels: total levels (level 0 the finest).
      interpolator: transfer factory (default LinearInterpolator, the
        reference's); its per-level P/R maps are filled too.
      smoother: whose per-level state to build (default
        SparseGaussSeidel()).
      dtype: device dtype (default A's).
      device: None means ``"cuda"``.
    """
    device = resolve_device(device)
    if interpolator is None:
        interpolator = LinearInterpolator(n_levels)
    if smoother is None:
        smoother = SparseGaussSeidel()
    clock = _Clock(device)
    A_sp = A.to_scipy() if isinstance(A, ELL) else A.tocsr()
    if dtype is None and isinstance(A, ELL):
        dtype = A.dtype

    mats, Ps, Rs = [A_sp], [], []
    for level in range(1, n_levels):
        n_h = mats[-1].shape[0]
        n_H = interpolator.coarse_size(n_h)
        if n_H < 1:
            raise ValueError(
                f"hierarchy too deep: level {level} would have {n_H} dofs "
                f"(finest {A_sp.shape[0]}, requested {n_levels} levels)")
        P, R = clock("rap", interpolator.make_operators_scipy, n_h, n_H)
        Ps.append(P)
        Rs.append(R)
        mats.append(clock("rap", galerkin_rap, R, mats[-1], P))

    def upload(M):
        return ELL.from_scipy(M, dtype=dtype, device=device)

    levels = []
    for l, M in enumerate(mats):
        A_ell = clock("upload", upload, M)
        P_ell = R_ell = None
        if l < n_levels - 1:
            P_ell = clock("upload", upload, Ps[l])
            R_ell = clock("upload", upload, Rs[l])
            interpolator.set_level_to_P(l, P_ell)
            interpolator.set_level_to_R(l, R_ell)
        levels.append(Level(A=A_ell, P=P_ell, R=R_ell,
                            smoother_state=clock("smoother", smoother.setup,
                                                 A_ell)))
    coarse = clock("lu", setup_coarse_solver, levels[-1].A)
    return Hierarchy(levels, coarse, clock.seconds)


def build_hierarchy_device(A, n_levels: int,
                           smoother: SmootherBase | None = None, dtype=None,
                           device=None):
    """A hierarchy whose Galerkin products run on the device
    (ops/ell_rap.py, the closed form under the reference transfer
    structure, interpolator.hpp:98-142). Returns (hierarchy, plans): keep
    ``plans`` to refresh the hierarchy for new operator values with
    ``rebuild_hierarchy_values`` (BASELINE config 4)."""
    device = resolve_device(device)
    if smoother is None:
        smoother = MulticolorGaussSeidel()
    clock = _Clock(device)
    interpolator = LinearInterpolator()
    if isinstance(A, ELL):
        A_ell = A.to(device=device, dtype=dtype)
    else:
        A_ell = clock("upload", ELL.from_scipy, A, dtype, True, device)
    plans, mats = clock("rap", build_rap_plans, A_ell, n_levels)
    levels = []
    for l, M in enumerate(mats):
        P_ell = R_ell = None
        if l < n_levels - 1:
            P, R = interpolator.make_operators_scipy(M.n_rows,
                                                     mats[l + 1].n_rows)
            P_ell = clock("upload", ELL.from_scipy, P, M.dtype, True, device)
            R_ell = clock("upload", ELL.from_scipy, R, M.dtype, True, device)
        levels.append(Level(A=M, P=P_ell, R=R_ell,
                            smoother_state=clock("smoother", smoother.setup,
                                                 M)))
    coarse = clock("lu", setup_coarse_solver, levels[-1].A)
    return Hierarchy(levels, coarse, clock.seconds), tuple(plans)


def rebuild_hierarchy_values(hier: Hierarchy, plans: tuple,
                             A_data: torch.Tensor) -> Hierarchy:
    """New fine ELL values of the same pattern -> new level operators,
    smoother panels and coarse LU, all on the device: the general path's
    form of the structured closed-form rebuild."""
    datas = apply_rap_chain(plans, A_data)
    new_levels = []
    for l, lev in enumerate(hier.levels):
        st = lev.smoother_state
        if not isinstance(st, MulticolorGSState):
            raise NotImplementedError(
                "rebuild_hierarchy_values supports MulticolorGaussSeidel "
                "hierarchies (the production smoother); rebuild others "
                "with build_hierarchy_device")
        new_levels.append(dataclasses.replace(
            lev, A=ELL(data=datas[l], cols=lev.A.cols, shape=lev.A.shape),
            smoother_state=MulticolorGaussSeidel.refresh_state(st,
                                                               datas[l])))
    return Hierarchy(new_levels, setup_coarse_solver(new_levels[-1].A))


def _smooth_level(smoother: SmootherBase, state, u, b):
    """In-cycle smoothing: n_iters iterations, no error cadence (the
    reference's smooth() with check-every 0, smoother.hpp:189-198)."""
    for _ in range(smoother.n_iters):
        u = smoother.apply(state, u, b)
    return u


def vcycle(hier: Hierarchy, smoother: SmootherBase, u: torch.Tensor,
           b: torch.Tensor, collect: bool = False):
    """One V-cycle (multigrid.hpp:263-305): down leg (pre-smooth,
    residual, restrict), direct solve on the coarsest level, up leg
    (prolong-correct, post-smooth). Each coarse solution starts at zero
    (multigrid.hpp:278). ``collect=True`` also returns the per-level
    (u, b, r) lists."""
    L = hier.n_levels
    us, bs, rs = [None] * L, [None] * L, [None] * L
    us[0], bs[0] = u, b
    for l in range(L - 1):
        lev = hier.levels[l]
        us[l] = _smooth_level(smoother, lev.smoother_state, us[l], bs[l])
        rs[l] = bs[l] - lev.A.matvec(us[l])
        bs[l + 1] = lev.R.matvec(rs[l])
        us[l + 1] = torch.zeros_like(bs[l + 1])
    us[L - 1] = hier.coarse.solve(bs[L - 1])
    rs[L - 1] = bs[L - 1] - hier.levels[L - 1].A.matvec(us[L - 1])
    for l in range(L - 2, -1, -1):
        lev = hier.levels[l]
        us[l] = us[l] + lev.P.matvec(us[l + 1])
        us[l] = _smooth_level(smoother, lev.smoother_state, us[l], bs[l])
    if collect:
        return us[0], (us, bs, rs)
    return us[0]


def _chunk_loop(hier: Hierarchy, smoother: SmootherBase, u: torch.Tensor,
                b: torch.Tensor) -> ChunkLoop:
    """The hierarchy's chunk loop for the smoother's options and the
    buffers' kind (built at the first solve, kept with the hierarchy)."""
    key = (type(smoother), repr(sorted(vars(smoother).items())),
           *((t.dtype, tuple(t.shape), t.device) for t in (u, b)))
    loop = hier.chunk_loops.get(key)
    if loop is None:
        ref = weakref.ref(hier)     # the hierarchy holds the loop
        loop = hier.chunk_loops[key] = ChunkLoop(
            lambda uu, bb: vcycle(ref(), smoother, uu, bb),
            lambda uu, bb: rss(ref().levels[0].A, uu, bb), u, b)
    return loop


def solve(hier: Hierarchy, smoother: SmootherBase, b: torch.Tensor,
          u0: torch.Tensor | None = None, tolerance: float = 1e-9,
          compute_error_every_n_iters: int = 10, n_iters: int = 100,
          display_error: bool = False) -> SolveResult:
    """The outer V-cycle loop (multigrid.hpp:311-337): error sentinel 100,
    the finest rss checked every ``compute_error_every_n_iters`` cycles
    (0 = never), loop while ``iter < n_iters && error > tolerance``. The
    V-cycles between two checks are one chunk (JAX's jitted
    ``cycle_chunk``): on the card one CUDA graph launch, and each check
    one rss graph launch and one read; ``u0`` and ``b`` are copied into
    the loop's buffers."""
    return _solve(hier, smoother, b, u0, tolerance,
                  compute_error_every_n_iters, n_iters, display_error)


def _solve(hier: Hierarchy, smoother: SmootherBase, b: torch.Tensor,
           u0: torch.Tensor | None, tolerance: float, every: int,
           n_iters: int, display_error: bool = False,
           host: bool = False) -> SolveResult:
    """``solve`` under the graph driver on the card, or under the host
    driver of the same pieces (the CPU's; ``host=True``: the card's
    oracle)."""
    A0 = hier.levels[0].A
    u = torch.zeros(A0.n_rows, dtype=A0.dtype, device=A0.device) \
        if u0 is None else u0
    loop = _chunk_loop(hier, smoother, u, b)

    def report(it, error):
        print(f"Iter: {it} | Error: {error}")
    u, it, error, history = loop.solve(
        u, b, tolerance, every, n_iters, host or A0.device.type != "cuda",
        report if display_error else None)
    return SolveResult(u=u, iterations=it, error=error,
                       converged=error <= tolerance, history=history)


class Multigrid:
    """The reference's solver object (class AMG::Multigrid,
    multigrid.hpp:23-365) over the functions above: construction validates
    and builds the hierarchy, ``solve`` runs V-cycles to tolerance. The
    interpolator and smoother are injected (multigrid.hpp:151-156).

    ``config`` (a config.SolverConfig) overrides ``tolerance``,
    ``compute_error_every_n_iters`` and ``n_iters``, and gives
    ``n_levels`` only when ``n_levels`` is falsy: JAX's rule
    (amg_tpu/multigrid.py:320-325). ``device`` None means ``"cuda"``.
    """

    def __init__(self, interpolator: InterpolatorBase | None,
                 smoother: SmootherBase | None, A, b, n_levels: int,
                 tolerance: float = 1e-9,
                 compute_error_every_n_iters: int = 10, n_iters: int = 100,
                 dtype=None, config=None, device=None):
        if config is not None:
            n_levels = n_levels or config.n_levels
            tolerance = config.tolerance
            compute_error_every_n_iters = config.compute_error_every_n_iters
            n_iters = config.n_iters
        # validations (multigrid.hpp:164-178)
        if compute_error_every_n_iters > n_iters:
            raise ValueError(
                "`compute_error_every_n_iters` must be leq to `n_iters`, "
                f"got {compute_error_every_n_iters} and {n_iters}")
        n_rows_A = A.n_rows if isinstance(A, ELL) else A.shape[0]
        if n_rows_A != b.shape[0]:
            raise ValueError(
                "`A` and `b` must have the same number of degrees of "
                f"freedom, got {n_rows_A} and {b.shape[0]}")
        self.device = resolve_device(device)
        self.smoother = (smoother if smoother is not None
                         else SparseGaussSeidel())
        self.interpolator = (interpolator if interpolator is not None
                             else LinearInterpolator(n_levels))
        self.tolerance = tolerance
        self.compute_error_every_n_iters = compute_error_every_n_iters
        self.n_iters = n_iters
        self.n_levels = n_levels
        self.hierarchy = build_hierarchy(A, n_levels, self.interpolator,
                                         self.smoother, dtype=dtype,
                                         device=self.device)
        dt = self.hierarchy.levels[0].A.dtype
        self.b = torch.as_tensor(b).to(dtype=dt, device=self.device)
        self._display_error = False
        # per-level state: u zero, the coarse rhs and residual zero, the
        # finest = b (multigrid.hpp:190-236)
        zeros = [torch.zeros(lev.A.n_rows, dtype=dt, device=self.device)
                 for lev in self.hierarchy.levels]
        self._us = list(zeros)
        self._bs = [self.b] + zeros[1:]
        self._rs = list(self._bs)

    def vcycle(self) -> torch.Tensor:
        """One stateful V-cycle: updates the per-level state as the
        reference's in-place version does (multigrid.hpp:263-305)."""
        u0, (us, bs, rs) = vcycle(self.hierarchy, self.smoother,
                                  self._us[0], self.b, collect=True)
        self._us, self._bs, self._rs = list(us), list(bs), list(rs)
        return u0

    def solve(self, verbose: bool = True) -> SolveResult:
        """Solve to tolerance (multigrid.hpp:311-337); ``result.u`` is the
        finest solution."""
        res = solve(self.hierarchy, self.smoother, self.b, self._us[0],
                    self.tolerance, self.compute_error_every_n_iters,
                    self.n_iters, self._display_error)
        self._us[0] = res.u
        if verbose:
            word = "converged" if res.converged else "did not converge"
            print(f"AMG {word} after {res.iterations} iterations.")
        return res

    def get_coefficient_matrix(self, level: int) -> ELL:
        return self.hierarchy.levels[level].A

    def get_soln(self, level: int) -> torch.Tensor:
        return self._us[level]

    def get_rhs(self, level: int) -> torch.Tensor:
        return self._bs[level]

    def get_residual(self, level: int) -> torch.Tensor:
        return self._rs[level]

    def get_n_dofs(self, level: int) -> int:
        return self.hierarchy.n_dofs(level)

    def get_tolerance(self) -> float:
        return self.tolerance

    def display_error_on(self):
        self._display_error = True

    def display_error_off(self):
        self._display_error = False
