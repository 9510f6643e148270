"""Structured-grid multigrid solver for 2-D 9-point problems: the PyTorch
port of ``amg_tpu/structured.py``.

Three ways to build a hierarchy, as in the JAX package:

* ``build_stencil_hierarchy_device``: the constant-coefficient Poisson
  problem with closed-form constant stencils (static 3x3 weights per
  level, no coefficient planes); ``StructuredSolver(side)``;
* ``build_stencil_hierarchy_planes``: a variable-coefficient operator
  given as (3,3,n,n) fine planes (models/varcoef.py), coarsened by the
  Galerkin plane contraction on the device (ops/rap.py);
  ``StructuredSolver(side, A_planes=planes)``;
* ``build_stencil_hierarchy``: any 9-point fine matrix in scipy form,
  coarsened by the scipy Galerkin chain on the host, with planes, color
  masks and the detected constant stencils on every level;
  ``StructuredSolver(side, A_fine=A)`` and the strided smoother.

All get a dense LU on the coarsest level. ``StructuredSolver`` runs a
full-multigrid start (or, ``fmg=False``, a zero start) and a
defect-correction loop of 3 f32 V-cycles per refine, with the residual in
double-float32 (``precision="df32"``, the default) or native f64
(``precision="f64"``); ``solve_ir`` steps the same refine from the host
with an f64 residual. The free functions ``solve_stencil`` and
``solve_ir`` are the JAX package's one-shot loops.

Smoothers (``smoother=``):

* ``"auto"``: color-packed levels (sparse/packed.py) from side 200 up. On
  constant levels of side >= 1023 the V-cycle legs are the fused CUDA
  kernels K2/K3 (K1 the standalone sweep when the sweep counts are not 1),
  from side 8191 the split level (K1, the fused residual + restriction K8,
  K3), and the fine-level df32 residual + rss is K4. Variable-coefficient
  levels run the plain packed-var ops, with no kernel, as in JAX.
* ``"packed"``: the same levels with the plain packed ops only.
* ``"fused"``: the unpacked V-cycle with masked four-color sweeps, and on
  levels of side >= FUSED_MIN_SIDE the fused sweep kernel K5 (constant) or
  K6 (variable).
* ``"masked"``, ``"strided"``, ``"chebyshev"``: the unpacked V-cycle with
  full-grid masked four-color sweeps, four-color sweeps on strided
  sub-lattices, or the degree-4 Chebyshev smoother on each level's
  lambda_max bound. All three are plain PyTorch, as in JAX.

Which machinery runs on which level is decided once, from the sides and
the options, in :func:`level_plan` (``StructuredSolver.plan``). On CPU
tensors every kernel wrapper runs its plain version, so the same plan
drives the CPU tests.
"""

from __future__ import annotations

import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn

from amg_tpu_torch.ops.doublefloat import (DF32, df_add_f32, df_residual,
                                           df_residual_const, df_rss,
                                           df_rss_fast, is_pow2_weights)
from amg_tpu_torch.models import poisson
from amg_tpu_torch.multigrid import SolveResult
from amg_tpu_torch.native import bindings
from amg_tpu_torch.ops.kernels import (fused_df_residual_rss,
                                       fused_down_leg_packed, fused_gs4_sweep,
                                       fused_gs4_sweep_packed,
                                       fused_residual_restrict_packed,
                                       fused_up_leg_packed)
from amg_tpu_torch.ops.rap import (interp1d_dense, planes_to_dense,
                                   poisson_const_w33, rap_stencil_planes)
from amg_tpu_torch.ops.transfer import linear_interp_1d
from amg_tpu_torch.sparse.packed import (df_residual_const_packed,
                                         gs4_sweep_packed,
                                         gs4_sweep_packed_var, pack,
                                         pack_planes, prolong_add_packed,
                                         residual_packed, residual_packed_var,
                                         restrict_packed, unpack)
from amg_tpu_torch.sparse.stencil import (Stencil2D, chebyshev_smooth,
                                          color_masks, color_masks_iota,
                                          const_lam_max, const_planes,
                                          estimate_lam_max, gs4_sweep,
                                          gs4_sweep_masked)
from amg_tpu_torch.utils.debugging import check_rss
from amg_tpu_torch.utils.device import resolve_device
from amg_tpu_torch.utils.metrics import rss_from_residual

# Level thresholds, all measured on a TPU v5e for the JAX package
# (amg_tpu/structured.py) and kept as they are; re-deriving them on the GPU
# is later work. Packed levels from PACKED_MIN_SIDE up, the fused packed
# kernels from FUSED_PACKED_MIN_SIDE up, and with smoother="fused" the
# fused masked sweep (K5/K6) from FUSED_MIN_SIDE up. From SPLIT_MIN_SIDE
# up a fused level is split (sweep K1, residual + restriction K8, up leg
# K3): the side from which the JAX package's full down leg does not fit the
# TPU's VMEM (ops/pallas/packed_cycle.py eligible / eligible_split); K2
# itself takes every size on the GPU.
PACKED_MIN_SIDE = 200
FUSED_PACKED_MIN_SIDE = 1023
FUSED_MIN_SIDE = 3000
SPLIT_MIN_SIDE = 8191


class StencilHierarchy(nn.Module):
    """Level hierarchy: each level has constant weights (``w33s``, static
    tuples), planes (``planes``: one (3,3,n,n) tensor per level), or both
    (a host-built level whose planes were detected constant; its
    operators then use the weights). Without planes every level needs
    weights.

    Buffers: the coarsest level's LU factors (``coarse_lu``, LAPACK
    1-based ``coarse_piv``), the dense 1-D transfer matrices ``P1_l``
    (side_l x side_{l+1}; restriction and prolongation are P1^T X P1 and
    P1 X P1^T because P2d = kron(P1, P1)), the planes ``c_l``, the (4,n,n)
    color masks ``mask_l`` of a host-built hierarchy (a level without
    them builds its masks in each sweep) and, when ``smoother ==
    "packed"``, the color-packed planes ``cp_l`` of the levels without
    weights of side >= ``packed_min_side`` except the coarsest, packed
    once here rather than in every V-cycle. ``lam_maxes``: per-level
    lambda_max(D^-1 A) bounds for the Chebyshev smoother, or None.
    """

    def __init__(self, sides, w33s, coarse_lu, coarse_piv, P1s, planes=None,
                 smoother: str = "masked",
                 packed_min_side: int = PACKED_MIN_SIDE, masks=None,
                 lam_maxes=None):
        super().__init__()
        L = len(sides)
        if len(P1s) != L - 1 or len(w33s) != L:
            raise ValueError("need one w33 per level and one P1 per pair")
        if planes is None and any(w is None for w in w33s):
            raise ValueError("a level without weights needs its planes")
        for name, per_level in (("planes", planes), ("masks", masks),
                                ("lam_maxes", lam_maxes)):
            if per_level is not None and len(per_level) != L:
                raise ValueError(f"need {name} on every level")
        self.sides = tuple(int(s) for s in sides)
        self.w33s = tuple(w33s)
        self.smoother = smoother
        self.lam_maxes = (None if lam_maxes is None
                          else tuple(float(x) for x in lam_maxes))
        self.register_buffer("coarse_lu", coarse_lu)
        self.register_buffer("coarse_piv", coarse_piv)
        for l, P in enumerate(P1s):
            self.register_buffer(f"P1_{l}", P)
        for l, m in enumerate(masks or ()):
            self.register_buffer(f"mask_{l}", m)
        for l, c in enumerate(planes or ()):
            self.register_buffer(f"c_{l}", c)
            if (smoother == "packed" and self.w33s[l] is None and l < L - 1
                    and self.sides[l] >= packed_min_side):
                self.register_buffer(f"cp_{l}",
                                     pack_planes(c, (self.sides[l] - 1) // 2))

    @property
    def n_levels(self) -> int:
        return len(self.sides)

    @property
    def is_var(self) -> bool:
        return self.w33s[0] is None

    @property
    def P1s(self) -> tuple:
        return tuple(getattr(self, f"P1_{l}")
                     for l in range(self.n_levels - 1))

    @property
    def masks(self) -> tuple:
        """Per-level stored color masks (None where none are stored)."""
        return tuple(getattr(self, f"mask_{l}", None)
                     for l in range(self.n_levels))

    @property
    def levels(self) -> tuple:
        """Per-level Stencil2D operators (views of the current buffers)."""
        return tuple(Stencil2D(side=s, w33=w, c=getattr(self, f"c_{l}", None),
                               const_dtype=self.coarse_lu.dtype)
                     for l, (s, w) in enumerate(zip(self.sides, self.w33s)))

    def packed_planes(self, l: int) -> torch.Tensor:
        """Level l's color-packed planes: the setup-time buffer, or packed
        now for a level outside the setup's packed range."""
        cp = getattr(self, f"cp_{l}", None)
        if cp is None:
            cp = pack_planes(getattr(self, f"c_{l}"), (self.sides[l] - 1) // 2)
        return cp

    def coarse_solve(self, b2: torch.Tensor) -> torch.Tensor:
        """Direct solve on the coarsest level (nc x nc field)."""
        nc = self.sides[-1]
        sol = torch.linalg.lu_solve(self.coarse_lu, self.coarse_piv,
                                    b2.reshape(-1, 1))
        return sol.reshape(nc, nc)


def max_levels_for_side(side: int) -> int:
    """Number of times side -> (side-1)/2 stays a valid odd grid >= 3."""
    n, L = side, 1
    while n >= 7 and (n - 1) % 2 == 0 and ((n - 1) // 2) % 2 == 1:
        n = (n - 1) // 2
        L += 1
    return L


def _level_sides(side: int, n_levels: int | None) -> list:
    if n_levels is None:
        n_levels = max_levels_for_side(side)
    sides = [side]
    for _ in range(n_levels - 1):
        n = sides[-1]
        if (n - 1) % 2 or n < 3:
            raise ValueError(f"cannot coarsen side {n}; use side = 2^k - 1")
        sides.append((n - 1) // 2)
    return sides


def _factor_coarse(c: torch.Tensor, device):
    """Densify the coarsest planes and LU-factor them on the host (9 x 9
    at coarsest side 3); the factors move to ``device``."""
    lu, piv = torch.linalg.lu_factor(planes_to_dense(c.cpu()))
    return lu.to(device), piv.to(device)


def galerkin_chain(A_fine, sides, *, native: bool) -> list:
    """The Galerkin RAP chain A_{l+1} = P^T A_l P under the tensor-product
    bilinear transfer P = kron(P1, P1), on the host (multigrid.hpp:211-243):
    one CSR matrix per level. ``native``: the native engine's transpose
    and two SpGEMMs (``native/bindings.py``) where it is available, as
    JAX's ``build_stencil_hierarchy`` takes them; else, and without it,
    scipy's products, as JAX's distributed setup takes them. The two sum
    the same terms in another order."""
    native = native and bindings.available()
    mats = [A_fine.tocsr()]
    for l in range(len(sides) - 1):
        P1 = linear_interp_1d(sides[l], sides[l + 1])
        P2 = sp.kron(P1, P1).tocsr()
        if native:
            R = bindings.csr_transpose(P2)
            mats.append(bindings.galerkin_rap(R, mats[-1], P2))
        else:
            mats.append((P2.T @ (mats[-1] @ P2)).tocsr())
    return mats


def build_stencil_hierarchy(side: int, n_levels: int | None = None,
                            dtype=torch.float32, A_fine=None,
                            smoother: str = "masked", device=None
                            ) -> StencilHierarchy:
    """The hierarchy of a 9-point fine matrix (None: the Poisson matrix of
    ``side``) built on the host: the Galerkin chain (native where the
    engine is available, as JAX's; ``galerkin_chain``), every level's
    planes in ``dtype`` with its constant stencil detected
    (``Stencil2D.from_scipy``), the coarsest level's dense LU, the
    transfers and every level's (4,n,n) color masks; with
    ``smoother="chebyshev"`` each level's lambda_max bound (the analytic
    one on constant levels, else the power-iteration estimate). ``device``
    None means ``"cuda"``."""
    device = resolve_device(device)
    sides = _level_sides(side, n_levels)
    if A_fine is None:
        A_fine = poisson.laplacian_scipy(side)
    mats = galerkin_chain(A_fine, sides, native=True)
    levels = [Stencil2D.from_scipy(M, s, dtype=dtype, device=device)
              for M, s in zip(mats, sides)]
    lu, piv = torch.linalg.lu_factor(torch.as_tensor(mats[-1].toarray(),
                                                     dtype=dtype))
    P1s = [interp1d_dense(sides[l], sides[l + 1], dtype, device)
           for l in range(len(sides) - 1)]
    lam_maxes = None
    if smoother == "chebyshev":
        lam_maxes = [const_lam_max(S.w33) if S.w33 is not None
                     else float(estimate_lam_max(S)) for S in levels]
    return StencilHierarchy(
        sides, [S.w33 for S in levels], lu.to(device), piv.to(device), P1s,
        planes=[S.c for S in levels], smoother=smoother,
        masks=[color_masks(s, dtype, device) for s in sides],
        lam_maxes=lam_maxes)


def build_stencil_hierarchy_device(side: int, n_levels: int | None = None,
                                   dtype=torch.float32, device=None,
                                   smoother: str = "masked"
                                   ) -> StencilHierarchy:
    """The Poisson hierarchy with closed-form constant stencils
    (ops/rap.poisson_const_w33) on every level: no coefficient planes or
    masks are stored; with ``smoother="chebyshev"`` the analytic
    lambda_max bounds. ``device`` None means ``"cuda"``."""
    device = resolve_device(device)
    sides = _level_sides(side, n_levels)
    w33s = poisson_const_w33(side, len(sides))
    lu, piv = _factor_coarse(const_planes(w33s[-1], sides[-1], dtype), device)
    P1s = [interp1d_dense(sides[l], sides[l + 1], dtype, device)
           for l in range(len(sides) - 1)]
    lam_maxes = ([const_lam_max(w) for w in w33s]
                 if smoother == "chebyshev" else None)
    return StencilHierarchy(sides, w33s, lu, piv, P1s, smoother=smoother,
                            lam_maxes=lam_maxes)


def build_stencil_hierarchy_planes(c_fine: torch.Tensor,
                                   n_levels: int | None = None,
                                   dtype=torch.float32, device=None,
                                   smoother: str = "masked",
                                   packed_min_side: int = PACKED_MIN_SIDE
                                   ) -> StencilHierarchy:
    """A variable-coefficient hierarchy from fine (3,3,n,n) planes: the
    Galerkin chain as the closed-form plane contraction
    (ops/rap.rap_stencil_planes), run on ``device`` (None means
    ``"cuda"``) in ``dtype``. The levels keep their planes: no constant
    stencil is detected, as in the JAX package. With
    ``smoother="chebyshev"`` each level's lambda_max is the power-iteration
    estimate (``estimate_lam_max``, seed 0)."""
    device = resolve_device(device)
    side = int(c_fine.shape[-1])
    sides = _level_sides(side, n_levels)
    planes = [c_fine.to(device=device, dtype=dtype).contiguous()]
    for _ in range(len(sides) - 1):
        planes.append(rap_stencil_planes(planes[-1]))
    lu, piv = _factor_coarse(planes[-1], device)
    P1s = [interp1d_dense(sides[l], sides[l + 1], dtype, device)
           for l in range(len(sides) - 1)]
    lam_maxes = None
    if smoother == "chebyshev":
        lam_maxes = [float(estimate_lam_max(Stencil2D(side=s, c=c)))
                     for s, c in zip(sides, planes)]
    return StencilHierarchy(sides, [None] * len(sides), lu, piv, P1s,
                            planes=planes, smoother=smoother,
                            packed_min_side=packed_min_side,
                            lam_maxes=lam_maxes)


def restrict_mm(r2, P1):
    """R @ r via the tensor-product factorization: P1^T @ r2 @ P1."""
    return P1.T @ r2 @ P1


def prolong_mm(uc2, P1):
    """P @ u_c via P1 @ uc2 @ P1^T."""
    return P1 @ uc2 @ P1.T


def _fused_level(smoother: str, side: int) -> bool:
    """Whether a level sweeps with K5/K6 (smoother="fused", large side)."""
    return smoother == "fused" and side >= FUSED_MIN_SIDE


def _smooth(hier: StencilHierarchy, l: int, u2, b2, sweeps: int,
            omega: float, symmetric: bool):
    """Smoothing on a non-packed level, in the JAX package's order: the
    strided sweep; the degree-4 Chebyshev smoother (where the level has a
    lambda_max bound: stored, or analytic on a constant level); the fused
    sweep kernel on the fused levels; masked four-color sweeps with the
    stored masks, or masks built here."""
    S = hier.levels[l]
    if hier.smoother == "strided":
        for _ in range(sweeps):
            u2 = gs4_sweep(S, u2, b2, omega, symmetric)
        return u2
    if hier.smoother == "chebyshev" and (hier.lam_maxes is not None
                                         or S.w33 is not None):
        lam = (hier.lam_maxes[l] if hier.lam_maxes is not None
               else const_lam_max(S.w33))
        for _ in range(sweeps):
            u2 = chebyshev_smooth(S, u2, b2, lam, degree=4)
        return u2
    if _fused_level(hier.smoother, S.side):
        for _ in range(sweeps):
            u2 = fused_gs4_sweep(S, u2, b2, omega, symmetric)
        return u2
    masks = hier.masks[l]
    if masks is None:
        masks = color_masks_iota(S.side, b2.dtype, b2.device)
    for _ in range(sweeps):
        u2 = gs4_sweep_masked(S, u2, b2, masks, omega, symmetric)
    return u2


def cycle_stencil(hier: StencilHierarchy, u2, b2, gamma: int = 1,
                  pre_sweeps: int = 1, post_sweeps: int = 1,
                  omega: float = 1.0, symmetric: bool = True,
                  _level: int = 0):
    """Generalized multigrid cycle on unpacked fields from level ``_level``
    down (leg order of multigrid.hpp:263-305): the coarse problem is
    visited ``gamma`` times per level, so gamma = 1 is the V-cycle
    (:func:`vcycle_stencil`) and gamma = 2 the W-cycle."""
    l = _level
    if l == hier.n_levels - 1:
        return hier.coarse_solve(b2)
    S = hier.levels[l]
    u2 = _smooth(hier, l, u2, b2, pre_sweeps, omega, symmetric)
    r = b2 - S.matvec2(u2)
    bc = restrict_mm(r, hier.P1s[l])
    uc = torch.zeros_like(bc)
    for _ in range(gamma):
        uc = cycle_stencil(hier, uc, bc, gamma, pre_sweeps, post_sweeps,
                           omega, symmetric, _level=l + 1)
    u2 = u2 + prolong_mm(uc, hier.P1s[l])
    return _smooth(hier, l, u2, b2, post_sweeps, omega, symmetric)


def vcycle_stencil(hier: StencilHierarchy, u2, b2, pre_sweeps: int = 1,
                   post_sweeps: int = 1, omega: float = 1.0,
                   symmetric: bool = True, *, _level: int = 0):
    """One V-cycle on unpacked fields from level ``_level`` down: the
    smoother="fused" solve cycle and the masked levels of a packed one
    (:func:`cycle_stencil` with gamma = 1)."""
    return cycle_stencil(hier, u2, b2, 1, pre_sweeps, post_sweeps, omega,
                         symmetric, _level=_level)


def level_plan(sides, pre_sweeps: int, post_sweeps: int, min_side: int,
               fused: bool, var: bool = False,
               smoother: str = "packed") -> tuple:
    """Per-level choice of machinery, decided once from the sides:

    * ``direct``: the coarsest level's LU solve;
    * ``masked``: the masked four-color cycle (side < min_side, any
      non-fused level of a smoother="fused" solve, every level of a
      smoother="masked" one);
    * ``strided`` / ``chebyshev``: the unpacked cycle with that smoother
      (smoother="strided" / "chebyshev", every level);
    * ``packed``: plain PyTorch packed ops, constant stencil;
    * ``packed_var``: plain PyTorch packed ops on packed planes;
    * ``legs``: the fused down/up legs (K2/K3), constant levels of side
      >= FUSED_PACKED_MIN_SIDE with one pre- and one post-sweep;
    * ``split``: the same levels of side >= SPLIT_MIN_SIDE: the fused
      sweep (K1), the fused residual + restriction (K8), then the up leg
      (K3), as the JAX package runs its levels of M >= 4096;
    * ``sweep``: the fused packed sweep (K1) with plain residual and
      transfers, the same levels with other sweep counts;
    * ``fused_const`` / ``fused_var``: smoother="fused" levels of side >=
      FUSED_MIN_SIDE, swept by K5 / K6.

    The GPU kernels take every size; the TPU's VMEM eligibility gates
    survive only as the thresholds, so the plan picks on each level what
    the JAX package picks on a 2^k - 1 hierarchy.
    """
    kinds = []
    for l, s in enumerate(sides):
        if l == len(sides) - 1:
            kinds.append("direct")
        elif smoother == "fused":
            kinds.append(("fused_var" if var else "fused_const")
                         if _fused_level(smoother, s) else "masked")
        elif smoother != "packed":
            kinds.append(smoother)
        elif s < min_side:
            kinds.append("masked")
        elif var:
            kinds.append("packed_var")
        elif fused and s >= FUSED_PACKED_MIN_SIDE:
            if pre_sweeps == post_sweeps == 1:
                kinds.append("split" if s >= SPLIT_MIN_SIDE else "legs")
            else:
                kinds.append("sweep")
        else:
            kinds.append("packed")
    return tuple(kinds)


def vcycle_packed(hier: StencilHierarchy, u2, b2, pre_sweeps: int = 1,
                  post_sweeps: int = 1, omega: float = 1.0,
                  symmetric: bool = True, _level: int = 0,
                  _packed_in: bool = False, min_side: int | None = None,
                  fused: bool = False, plan: tuple | None = None):
    """V-cycle with color-packed smoothing, residual and transfers on the
    levels of side >= min_side and the masked machinery below; the same
    leg order and iterates as the unpacked cycle up to rounding.
    Variable-coefficient levels sweep with their packed planes.

    ``plan`` (from :func:`level_plan`) picks each level's machinery; when
    None it is derived from the arguments. With ``_packed_in`` the fields
    arrive and return packed ((4, M, M)), so a solve loop pays pack and
    unpack once per solve."""
    if min_side is None:
        min_side = PACKED_MIN_SIDE
    if plan is None:
        plan = level_plan(hier.sides, pre_sweeps, post_sweeps, min_side,
                          fused, var=hier.is_var)
    l = _level
    if l == hier.n_levels - 1:
        nc = hier.sides[-1]
        ml = (nc - 1) // 2
        bd = unpack(b2, ml) if _packed_in else b2
        sol = hier.coarse_solve(bd)
        return pack(sol, ml) if _packed_in else sol
    kind = plan[l]
    if not _packed_in and kind == "masked":
        return vcycle_stencil(hier, u2, b2, pre_sweeps, post_sweeps, omega,
                              symmetric, _level=l)
    S = hier.levels[l]
    m = (S.side - 1) // 2
    if S.w33 is None:
        cp = hier.packed_planes(l)

        def sweep(u4_, b4_):
            return gs4_sweep_packed_var(cp, u4_, b4_, m, omega, symmetric)

        def resid(u4_, b4_):
            return residual_packed_var(cp, u4_, b4_, m)
    else:
        sweep_fn = fused_gs4_sweep_packed if kind == "sweep" \
            else gs4_sweep_packed

        def sweep(u4_, b4_):
            return sweep_fn(u4_, b4_, S.w33, m, omega, symmetric)

        def resid(u4_, b4_):
            return residual_packed(u4_, b4_, S.w33, m)
    if _packed_in:
        u4, b4 = u2, b2
    else:
        u4, b4 = pack(u2, m), pack(b2, m)
    if kind == "legs":
        u4, bc_pad = fused_down_leg_packed(u4, b4, S.w33, m, omega,
                                           symmetric)
        bc = bc_pad[:m, :m]
    elif kind == "split":
        u4 = fused_gs4_sweep_packed(u4, b4, S.w33, m, omega, symmetric)
        bc = fused_residual_restrict_packed(u4, b4, S.w33, m)[:m, :m]
    else:
        for _ in range(pre_sweeps):
            u4 = sweep(u4, b4)
        bc = restrict_packed(resid(u4, b4), m)
    uc = vcycle_packed(hier, torch.zeros_like(bc), bc, pre_sweeps,
                       post_sweeps, omega, symmetric, _level=l + 1,
                       min_side=min_side, fused=fused, plan=plan)
    if kind in ("legs", "split"):
        u4 = fused_up_leg_packed(u4, b4, F.pad(uc, (0, 1, 0, 1)), S.w33, m,
                                 omega, symmetric)
    else:
        u4 = prolong_add_packed(u4, uc, m)
        for _ in range(post_sweeps):
            u4 = sweep(u4, b4)
    return u4 if _packed_in else unpack(u4, m)


def fmg_stencil(hier: StencilHierarchy, b2, cycles_per_level: int = 1,
                pre_sweeps: int = 1, post_sweeps: int = 1,
                omega: float = 1.0, symmetric: bool = True,
                gamma: int = 1, start_level: int = 0,
                min_side: int | None = None, fused: bool = False, *,
                plan: tuple | None = None):
    """Full multigrid (nested iteration): restrict the rhs down from level
    ``start_level``, solve the coarsest level directly, then prolong the
    solution up, running ``cycles_per_level`` cycles on each level: with
    gamma = 1 a packed V-cycle on the constant levels of side >= min_side
    of a smoother="packed" hierarchy, the unpacked cycle of ``gamma``
    everywhere else (as in the JAX package, so a variable or fused
    hierarchy never takes a packed cycle here).

    The b-chain uses restrict_mm / prolong_mm: the JAX package measured the
    4095^2 refine count to depend on this chain's precision, which is why
    TF32 stays off (StructuredSolver)."""
    if min_side is None:
        min_side = PACKED_MIN_SIDE
    use_packed = hier.smoother == "packed" and gamma == 1
    L = hier.n_levels
    l0 = start_level
    bs = {l0: b2}
    for l in range(l0, L - 1):
        bs[l + 1] = restrict_mm(bs[l], hier.P1s[l])
    u = hier.coarse_solve(bs[L - 1])
    for l in range(L - 2, l0 - 1, -1):
        u = prolong_mm(u, hier.P1s[l])
        for _ in range(cycles_per_level):
            if (use_packed and hier.sides[l] >= min_side
                    and hier.w33s[l] is not None):
                u = vcycle_packed(hier, u, bs[l], pre_sweeps, post_sweeps,
                                  omega, symmetric, _level=l,
                                  min_side=min_side, fused=fused, plan=plan)
            else:
                u = cycle_stencil(hier, u, bs[l], gamma, pre_sweeps,
                                  post_sweeps, omega, symmetric, _level=l)
    return u


def solve_stencil(hier: StencilHierarchy, b2, u0=None,
                  tolerance: float = 1e-9,
                  compute_error_every_n_iters: int = 5, n_iters: int = 100,
                  pre_sweeps: int = 1, post_sweeps: int = 1,
                  omega: float = 1.0, symmetric: bool = True,
                  device=None) -> SolveResult:
    """V-cycles on the hierarchy's own precision with the reference's
    stopping rule (multigrid.hpp:311-337): the rss of the fine level is
    read every ``compute_error_every_n_iters`` V-cycles (0: only after
    ``n_iters``) and each reading goes into ``history``. ``b2`` goes to
    ``device`` (None: ``"cuda"``), where the hierarchy must be."""
    device = resolve_device(device)
    if hier.coarse_lu.device.type != device.type:
        raise ValueError(f"the hierarchy is on {hier.coarse_lu.device}, "
                         f"the solve on {device}")
    b2 = torch.as_tensor(b2, device=device)
    S0 = hier.levels[0]
    u = torch.zeros_like(b2) if u0 is None else torch.as_tensor(
        u0, device=device)
    every = compute_error_every_n_iters
    it, error = 0, 100.0
    history = []
    while it < n_iters and error > tolerance:
        k = (min(every - (it % every), n_iters - it) if every
             else n_iters - it)
        for _ in range(k):
            u = vcycle_stencil(hier, u, b2, pre_sweeps, post_sweeps, omega,
                               symmetric)
        it += k
        if every and it % every == 0:
            error = check_rss(float(rss_from_residual(b2 - S0.matvec2(u))))
            history.append((it, error))
    return SolveResult(u=u, iterations=it, error=error,
                       converged=error <= tolerance, history=history)


def build_fine_stencil_f64(side: int, device=None) -> Stencil2D:
    """The Poisson fine operator in f64 planes, from its scipy matrix;
    ``device`` None means ``"cuda"``."""
    return Stencil2D.from_scipy(poisson.laplacian_scipy(side), side,
                                dtype=torch.float64,
                                device=resolve_device(device))


def solve_ir(side: int, b2_f64, hier32: StencilHierarchy | None = None,
             tolerance: float = 1e-9, n_refine: int = 30,
             cycles_per_refine: int = 2, device=None,
             **cycle_kw) -> SolveResult:
    """Mixed-precision iterative refinement of the Poisson problem: f32
    V-cycles (``cycle_kw`` their options) inside an f64 defect correction.
    Each refine reads the f64 rss, stops at ``tolerance``, else adds
    ``cycles_per_refine`` V-cycles' correction; ``iterations`` counts the
    V-cycles. ``hier32`` None: the host-built masked f32 hierarchy.
    ``device`` None means ``"cuda"``."""
    device = resolve_device(device)
    if hier32 is None:
        hier32 = build_stencil_hierarchy(side, dtype=torch.float32,
                                         device=device)
    A64 = build_fine_stencil_f64(side, device)
    b64 = torch.as_tensor(b2_f64, device=device)
    u = torch.zeros_like(b64)
    history = []
    it = 0
    error = 100.0
    for _ in range(n_refine):
        r = b64 - A64.matvec2(u)
        error = check_rss(float(rss_from_residual(r)))
        history.append((it, error))
        if error <= tolerance:
            break
        e = torch.zeros(r.shape, dtype=torch.float32, device=device)
        r32 = r.to(torch.float32)
        for _ in range(cycles_per_refine):
            e = vcycle_stencil(hier32, e, r32, **cycle_kw)
        u = u + e.to(torch.float64)
        it += cycles_per_refine
    return SolveResult(u=u, iterations=it, error=error,
                       converged=error <= tolerance, history=history)


SMOOTHERS = ("auto", "packed", "fused", "masked", "strided", "chebyshev")


class StructuredSolver:
    """Single-device structured solver: the hierarchy and the level plan
    are built once, then solves are cheap to repeat.

    Same defaults as the JAX solver: ``smoother="auto"``,
    ``precision="df32"``, ``fmg=True``, ``cycles_per_refine=3``. The fine
    operator is the Poisson matrix of ``side``, ``A_planes`` ((3,3,n,n)
    planes, models/varcoef.py; its hierarchy is built on the device) or
    ``A_fine`` (a scipy matrix; its hierarchy is built on the host).
    ``device_setup`` None takes JAX's rule: the Poisson hierarchy is
    built on the device unless the smoother is "strided" or ``A_fine`` is
    given; False builds it on the host. ``config`` (a
    config.StructuredConfig) gives ``smoother``, ``pre_sweeps``,
    ``post_sweeps``, ``omega``, ``symmetric``, ``cycles_per_refine`` and
    ``packed_min_side`` where the argument is None: an explicit argument
    first, then the config, then the default (JAX's rule,
    amg_tpu/structured.py:704-740). The solve loops run on the host with
    one device-to-host read of the rss per refine. ``device`` None means
    ``"cuda"``; pass ``device="cpu"`` to run on the CPU.

    Loops, as in the JAX package: the packed df32 loop for a constant
    operator with a packed smoother (side >= packed_min_side, >= 2
    levels); the unpacked df32 loop otherwise (variable operators, the
    unpacked smoothers, small sides); the f64 loop for
    ``precision="f64"``; ``solve_ir``, the host-stepped refine with an
    f64 residual, whatever the precision.
    """

    def __init__(self, side: int, n_levels: int | None = None,
                 smoother: str | None = None, pre_sweeps: int | None = None,
                 post_sweeps: int | None = None, omega: float | None = None,
                 symmetric: bool | None = None,
                 cycles_per_refine: int | None = None,
                 A_fine=None, A_planes=None,
                 device_setup: bool | None = None, fmg: bool = True,
                 precision: str = "df32", config=None,
                 packed_min_side: int | None = None, device=None):
        def resolve(name, explicit, default):
            if explicit is not None:
                return explicit
            v = getattr(config, name, None)
            return default if v is None else v

        smoother = resolve("smoother", smoother, "auto")
        pre_sweeps = resolve("pre_sweeps", pre_sweeps, 1)
        post_sweeps = resolve("post_sweeps", post_sweeps, 1)
        omega = resolve("omega", omega, 1.0)
        symmetric = resolve("symmetric", symmetric, True)
        cycles_per_refine = resolve("cycles_per_refine", cycles_per_refine, 3)
        packed_min_side = resolve("packed_min_side", packed_min_side,
                                  PACKED_MIN_SIDE)
        if smoother not in SMOOTHERS:
            raise ValueError(f"unknown smoother {smoother!r}; expected one "
                             f"of {SMOOTHERS}")
        if precision not in ("df32", "f64"):
            raise ValueError(f"unknown precision {precision!r}; "
                             "expected 'df32' or 'f64'")
        if A_fine is not None and A_planes is not None:
            raise ValueError("pass A_fine or A_planes, not both")
        self.side = side
        self.device = resolve_device(device)
        self.pre_sweeps = pre_sweeps
        self.post_sweeps = post_sweeps
        self.omega = omega
        self.symmetric = symmetric
        self.cycles_per_refine = cycles_per_refine
        self.packed_min_side = packed_min_side
        self.precision = precision
        self.fmg = fmg
        # smoother="auto" is packed levels, WITH the fused kernels on the
        # Poisson operator; other operators and an explicit "packed" keep
        # the plain packed ops (as in JAX)
        self.fused_packed = (smoother == "auto" and A_fine is None
                             and A_planes is None)
        self.smoother = "packed" if smoother == "auto" else smoother
        if device_setup is None:
            device_setup = A_fine is None and self.smoother != "strided"
        if self.device.type == "cuda":
            # the refine count depends on the f32 transfer matmuls'
            # precision (amg_tpu/structured.py fmg_stencil note): no TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if A_planes is not None:
            A_planes = torch.as_tensor(A_planes)
            if tuple(A_planes.shape) != (3, 3, side, side):
                raise ValueError(f"A_planes must be (3, 3, {side}, {side}), "
                                 f"got {tuple(A_planes.shape)}")
            self.hier = build_stencil_hierarchy_planes(
                A_planes, n_levels, device=self.device,
                smoother=self.smoother, packed_min_side=packed_min_side)
            self.A64 = Stencil2D(side=side, c=A_planes.to(
                device=self.device, dtype=torch.float64))
        elif device_setup and A_fine is None:
            self.hier = build_stencil_hierarchy_device(
                side, n_levels, device=self.device, smoother=self.smoother)
            # the f64 fine operator as exact static weights
            self.A64 = Stencil2D.const(poisson_const_w33(side, 1)[0], side,
                                       torch.float64)
        else:
            if A_fine is None:
                A_fine = poisson.laplacian_scipy(side)
            self.hier = build_stencil_hierarchy(
                side, n_levels, torch.float32, A_fine, self.smoother,
                self.device)
            self.A64 = Stencil2D.from_scipy(A_fine, side,
                                            dtype=torch.float64,
                                            device=self.device)
        self.device_setup = device_setup
        # a constant fine operator's df32 residual reads its weights only
        self.w33 = self.A64.w33
        self.c_df = (DF32.from_f64(self.A64.c)
                     if self.w33 is None and precision == "df32" else None)
        self.m = (side - 1) // 2
        # the packed loop keeps the whole solve state color-packed
        self.packed_loop = (precision == "df32" and self.w33 is not None
                            and self.smoother == "packed"
                            and side >= packed_min_side
                            and self.hier.n_levels >= 2)
        self.plan = level_plan(self.hier.sides, self.pre_sweeps,
                               self.post_sweeps, self.packed_min_side,
                               self.fused_packed, var=self.hier.is_var,
                               smoother=self.smoother)
        # K4 needs power-of-two weights (2^k - 1 grids); other sides take
        # the general df32 residual, as the JAX package does
        self.df_kernel = (self.fused_packed and self.w33 is not None
                          and is_pow2_weights(self.w33))

    # -- pieces of the solve loop ------------------------------------------

    def _vcycle(self, u2, b2, level: int = 0, packed_in: bool = False):
        if self.smoother != "packed":
            return vcycle_stencil(self.hier, u2, b2, self.pre_sweeps,
                                  self.post_sweeps, self.omega,
                                  self.symmetric, _level=level)
        return vcycle_packed(self.hier, u2, b2, self.pre_sweeps,
                             self.post_sweeps, self.omega, self.symmetric,
                             _level=level, _packed_in=packed_in,
                             min_side=self.packed_min_side,
                             fused=self.fused_packed, plan=self.plan)

    def _cycles(self, r32):
        """cycles_per_refine V-cycles on A e = r from e = 0."""
        e = torch.zeros_like(r32)
        for _ in range(self.cycles_per_refine):
            e = self._vcycle(e, r32)
        return e

    def _fmg(self, b32):
        """The unpacked loops' start: an f32 FMG pass from the fine level
        (the JAX defaults for min_side and fused), or 0 with fmg=False."""
        if not self.fmg:
            return torch.zeros_like(b32)
        return fmg_stencil(self.hier, b32, 1, self.pre_sweeps,
                           self.post_sweeps, self.omega, self.symmetric)

    def _df_residual(self, b_df: DF32, u: DF32) -> DF32:
        if self.w33 is not None:
            return df_residual_const(self.w33, b_df, u)
        return df_residual(self.c_df, b_df, u)

    def _residual_hi_rss(self, b4: DF32, u4: DF32):
        if self.df_kernel:
            return fused_df_residual_rss(self.w33, b4, u4, self.m)
        r = df_residual_const_packed(self.w33, b4, u4, self.m)
        return r.hi, df_rss_fast(r)

    def _fmg_start(self, b4: DF32) -> DF32:
        """Nested-iteration start with the fine level packed: restrict b to
        level 1, FMG the coarse hierarchy, prolong back, then one packed
        fine-level V-cycle; 0 with fmg=False."""
        if not self.fmg:
            return DF32.from_f32(torch.zeros_like(b4.hi))
        bc = restrict_packed(b4.hi, self.m)
        uc = fmg_stencil(self.hier, bc, 1, self.pre_sweeps,
                         self.post_sweeps, self.omega, self.symmetric,
                         start_level=1,
                         min_side=self.packed_min_side,
                         fused=self.fused_packed, plan=self.plan)
        u0f = prolong_add_packed(torch.zeros_like(b4.hi), uc, self.m)
        return DF32.from_f32(self._vcycle(u0f, b4.hi, packed_in=True))

    def _b64(self, b2_f64) -> torch.Tensor:
        b64 = torch.as_tensor(b2_f64, device=self.device)
        if b64.dtype != torch.float64:
            raise ValueError(f"the rhs must be float64, got {b64.dtype}")
        return b64

    def _rtol_base(self, b2_f64) -> float:
        """rss(b) exactly as the active loop computes it for rtol."""
        if self.precision == "f64":
            return float(rss_from_residual(self._b64(b2_f64)))
        b_df = (self.prepare_b(b2_f64) if self.packed_loop
                else DF32.from_f64(self._b64(b2_f64)))
        return float(df_rss_fast(b_df))

    def _stats(self, final: torch.Tensor, it: int) -> torch.Tensor:
        return torch.stack([final.to(torch.float64),
                            torch.tensor(float(it), dtype=torch.float64,
                                         device=final.device)])

    # -- the unpacked loops --------------------------------------------------

    def _solve_unpacked(self, b2_f64, tolerance: float, n_refine: int,
                        rtol: float):
        """The df32 loop on unpacked fields, with the JAX loop's semantics:
        the rss lags one correction and every pass refines, so the loop
        runs one refine past convergence; the final rss is always
        recomputed (df_rss)."""
        b_df = DF32.from_f64(self._b64(b2_f64))
        tol_eff = tolerance
        if rtol > 0.0:
            tol_eff = max(tolerance, rtol * float(df_rss_fast(b_df)))
        u = DF32.from_f32(self._fmg(b_df.hi))
        err = float("inf")
        it = 0
        while err > tol_eff and it < n_refine:
            r = self._df_residual(b_df, u)
            # the one host sync of the refine
            err = check_rss(float(df_rss_fast(r)))
            u = df_add_f32(u, self._cycles(r.hi))
            it += 1
        final = df_rss(self._df_residual(b_df, u))
        return u.to_f64(), self._stats(final, it)

    def _solve_f64(self, b2_f64, tolerance: float, n_refine: int,
                   rtol: float):
        """The native-f64 loop (JAX's solve_loop_f64): f64 residual and
        rss, f32 V-cycles on the residual, the FMG start in f32 cast to
        f64; the rss lags one correction, every pass refines, and the
        final rss is recomputed."""
        b64 = self._b64(b2_f64)
        tol_eff = tolerance
        if rtol > 0.0:
            tol_eff = max(tolerance, rtol * float(rss_from_residual(b64)))
        u = self._fmg(b64.to(torch.float32)).to(torch.float64)
        err = float("inf")
        it = 0
        while err > tol_eff and it < n_refine:
            r = b64 - self.A64.matvec2(u)
            err = check_rss(float(rss_from_residual(r)))
            u = u + self._cycles(r.to(torch.float32)).to(torch.float64)
            it += 1
        final = rss_from_residual(b64 - self.A64.matvec2(u))
        return u, self._stats(final, it)

    # -- public entry points -------------------------------------------------

    def prepare_b(self, b2_f64: torch.Tensor) -> DF32:
        """f64 (side, side) rhs -> packed df32, once per rhs."""
        if not self.packed_loop:
            raise ValueError("the prepared-rhs path needs the packed df32 "
                             "loop (constant operator, smoother 'auto' or "
                             "'packed', side >= packed_min_side, >= 2 "
                             "levels)")
        b_df = DF32.from_f64(self._b64(b2_f64))
        return DF32(hi=pack(b_df.hi, self.m), lo=pack(b_df.lo, self.m))

    def finalize_u(self, u4_df: DF32) -> torch.Tensor:
        return (unpack(u4_df.hi, self.m).to(torch.float64)
                + unpack(u4_df.lo, self.m).to(torch.float64))

    def solve_ir_device_prepared(self, b4_df: DF32, tolerance: float = 1e-7,
                                 n_refine: int = 40, rtol: float = 0.0):
        """Defect-correction solve on a prepared rhs. Returns
        ``(u4_df, stats)``: the packed df32 iterate and the f64 tensor
        ``[final_rss, refines]``.

        Loop semantics of the JAX device loop: the rss is lagged (it is the
        rss of u before the latest correction), a refine runs only while it
        is above the tolerance and counts only then, so a converged loop
        exits through a residual-only pass whose rss is the final one; on
        budget exhaustion the final rss is recomputed."""
        tol_eff = tolerance
        if rtol > 0.0:
            tol_eff = max(tolerance, rtol * float(df_rss_fast(b4_df)))
        u4 = self._fmg_start(b4_df)
        err = float("inf")
        err_t = None
        it = 0
        while err > tol_eff and it < n_refine:
            r_hi, err_t = self._residual_hi_rss(b4_df, u4)
            err = check_rss(float(err_t))  # the refine's one host sync
            if err > tol_eff:
                e4 = torch.zeros_like(r_hi)
                for _ in range(self.cycles_per_refine):
                    e4 = self._vcycle(e4, r_hi, packed_in=True)
                u4 = df_add_f32(u4, e4)
                it += 1
        if err > tol_eff:
            err_t = self._residual_hi_rss(b4_df, u4)[1]
        return u4, self._stats(err_t, it)

    def solve_ir_device(self, b2_f64: torch.Tensor, tolerance: float = 1e-7,
                        n_refine: int = 40, rtol: float = 0.0):
        """Solve A u = b to rss <= tolerance (or rtol * rss(b)): returns
        ``(u, stats)`` with u the f64 (side, side) field and stats the f64
        tensor ``[final_rss, refines]``."""
        if self.precision == "f64":
            return self._solve_f64(b2_f64, tolerance, n_refine, rtol)
        if not self.packed_loop:
            return self._solve_unpacked(b2_f64, tolerance, n_refine, rtol)
        u4, stats = self.solve_ir_device_prepared(self.prepare_b(b2_f64),
                                                  tolerance, n_refine, rtol)
        return self.finalize_u(u4), stats

    def solve_ir_fused(self, b2_f64: torch.Tensor, tolerance: float = 1e-7,
                       n_refine: int = 40, rtol: float = 0.0) -> SolveResult:
        """Solve and report: ``iterations`` counts the refine loop's
        V-cycles (the FMG start excluded)."""
        u, stats = self.solve_ir_device(b2_f64, tolerance, n_refine, rtol)
        err_v, it_v = stats.tolist()
        iters = int(it_v) * self.cycles_per_refine
        tol_eff = tolerance
        if rtol > 0.0:
            tol_eff = max(tolerance, rtol * self._rtol_base(b2_f64))
        return SolveResult(u=u, iterations=iters, error=err_v,
                           converged=err_v <= tol_eff,
                           history=[(iters, err_v)])

    def _refine_step(self, u64: torch.Tensor, b64: torch.Tensor):
        """One host-stepped refine: ``(u + cycles(b - A u), rss(u))``, the
        f64 residual's rss of the iterate it started from."""
        r = b64 - self.A64.matvec2(u64)
        err = rss_from_residual(r)
        return u64 + self._cycles(r.to(torch.float32)).to(torch.float64), err

    def _residual_rss(self, u64: torch.Tensor, b64: torch.Tensor):
        return rss_from_residual(b64 - self.A64.matvec2(u64))

    def warmup(self, refine_step: bool = False) -> None:
        """One solve on a zero rhs, which builds the CUDA kernels on first
        use; ``refine_step=True`` runs one host-stepped refine first."""
        z = torch.zeros((self.side, self.side), dtype=torch.float64,
                        device=self.device)
        if refine_step:
            float(self._refine_step(z, z)[1])
        _, stats = self.solve_ir_device(z, 1e-7, 40)
        stats.tolist()

    def solve_ir(self, b2_f64, tolerance: float = 1e-7,
                 n_refine: int = 40) -> SolveResult:
        """The host-stepped refine loop from u = 0 (no FMG start), with
        the JAX loop's lagged semantics: each step returns the corrected
        iterate and the rss of the one it started from, and the
        correction is kept only while that rss is above ``tolerance``, so
        the stopping step's cycles run and are discarded. ``history``
        holds (V-cycles so far, rss) of every step; ``iterations`` the
        V-cycles of the kept corrections."""
        b64 = self._b64(b2_f64)
        u = torch.zeros_like(b64)
        history = []
        it = 0
        error = float("inf")
        for _ in range(n_refine):
            u_next, err = self._refine_step(u, b64)
            error = check_rss(float(err))  # the step's one host sync
            history.append((it, error))
            if error <= tolerance:
                break
            u = u_next
            it += self.cycles_per_refine
        return SolveResult(u=u, iterations=it, error=error,
                           converged=error <= tolerance, history=history)
