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
  their constant levels the V-cycle legs are the fused CUDA kernels K2/K3
  (K1 the standalone sweep when the sweep counts are not 1), from side
  8191 the split level (K1, the fused residual + restriction K8,
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

Which machinery runs on which level is decided once, from what the
hierarchy holds, and every cycle dispatches on it: the hierarchy's
``kinds`` name the unpacked cycle's machinery on each level, kernels
included (``masked_legs``: the masked legs K10/K11 with the coarsest LU
between, on constant masked levels whose fields fit one block's shared
memory, 127^2 and below; ``masked_k12``: the masked sweep K12 on a level
given by its planes alone), and :func:`level_plan` puts the packed
cycle's kinds on top of them (``StructuredSolver.plan``). On CPU tensors
every kernel wrapper runs its plain twin, bitwise the plain ops, so the
same kinds drive the CPU tests.
"""

from __future__ import annotations

import weakref
from types import SimpleNamespace

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
from amg_tpu_torch.ops.coarse import cusolver_linalg
from amg_tpu_torch.ops.kernels import (fused_df_residual_rss,
                                       fused_down_leg_packed, fused_gs4_sweep,
                                       fused_gs4_sweep_packed,
                                       fused_residual_restrict_packed,
                                       fused_up_leg_packed, graph_loop,
                                       masked_cycle, masked_gs4_sweep_var)
from amg_tpu_torch.ops.kernels._build import count_launch, require_f32
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
from amg_tpu_torch.utils import tracing
from amg_tpu_torch.utils.debugging import check_rss
from amg_tpu_torch.utils.device import resolve_device
from amg_tpu_torch.utils.metrics import rss_from_residual

# Level thresholds. PACKED_MIN_SIDE, FUSED_MIN_SIDE and SPLIT_MIN_SIDE were
# measured on a TPU v5e for the JAX package (amg_tpu/structured.py) and are
# kept as they are: packed levels from PACKED_MIN_SIDE up, with
# smoother="fused" the fused masked sweep (K5/K6) from FUSED_MIN_SIDE up,
# and from SPLIT_MIN_SIDE up a fused level is split (sweep K1, residual +
# restriction K8, up leg K3), the side from which the JAX package's full
# down leg does not fit the TPU's VMEM (ops/pallas/packed_cycle.py
# eligible / eligible_split). FUSED_PACKED_MIN_SIDE is the card's own
# choice: the fused packed kernels (K1, K2/K3) take every constant packed
# level, where the TPU's VMEM gate kept the JAX package to 1023 and up: on
# an H100 a plain packed visit of the 511^2 or 255^2 level is about 870
# graph nodes and 1.2 ms, the legs' visit 13 nodes and 0.04 ms. The CPU
# takes the same plan through the kernels' plain twins, which are the
# plain packed ops in the same order, so the bits are the same either way.
PACKED_MIN_SIDE = 200
FUSED_PACKED_MIN_SIDE = PACKED_MIN_SIDE
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
    ``chunk_loops``: ``solve_stencil``'s chunk loops (and their graphs),
    dropped with the hierarchy or when it moves.

    ``kinds``: the machinery of each level in the unpacked cycle, decided
    from what the hierarchy holds when it is built and again when its
    buffers move or change dtype (:meth:`_level_kinds`); every cycle
    dispatches on them. A caller may set plain kinds (``masked`` in place
    of ``masked_legs`` and ``masked_k12``) to run the plain ops.
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
        self.chunk_loops = {}
        self.kinds = self._level_kinds()

    def _apply(self, fn, recurse=True):
        self.chunk_loops = {}
        module = super()._apply(fn, recurse)
        self.kinds = self._level_kinds()
        return module

    def _level_kinds(self) -> tuple:
        """Each level's machinery in the unpacked cycle, in the JAX
        package's order of choice:

        * ``direct``: the coarsest level's LU solve;
        * ``strided``: four-color sweeps on strided sub-lattices
          (smoother="strided");
        * ``chebyshev``: the degree-4 Chebyshev smoother
          (smoother="chebyshev", on a level with a lambda_max bound: stored,
          or analytic from constant weights);
        * ``fused_const`` / ``fused_var``: the fused sweep K5 / K6
          (smoother="fused", side >= FUSED_MIN_SIDE; K6 on a level given by
          its planes alone);
        * ``masked_legs``: the V-cycle from this level down as the masked
          legs K10/K11 with the coarsest LU between: an f32 hierarchy whose
          levels from here to the coarsest but one are all constant and
          masked, entered at a side whose fields fit one block's shared
          memory (``masked_cycle.fits``: 127^2 and below on 2^k - 1
          hierarchies);
        * ``masked_k12``: masked four-color sweeps by K12 on a level given
          by its planes alone, f32 and contiguous;
        * ``masked``: the plain masked four-color sweeps (the stored masks,
          or masks built in each sweep).

        The kernels' wrappers run their plain twins on CPU tensors, so the
        kinds do not depend on the device."""
        last = self.n_levels - 1
        kinds = []
        for l, (s, w33) in enumerate(zip(self.sides[:last], self.w33s)):
            c = getattr(self, f"c_{l}", None)
            if self.smoother == "strided":
                kinds.append("strided")
            elif self.smoother == "chebyshev" and (
                    self.lam_maxes is not None or w33 is not None):
                kinds.append("chebyshev")
            elif self.smoother == "fused" and s >= FUSED_MIN_SIDE:
                kinds.append("fused_const" if w33 is not None
                             else "fused_var")
            elif (w33 is None and c.dtype == torch.float32
                  and c.is_contiguous()):
                kinds.append("masked_k12")
            else:
                kinds.append("masked")
        f32 = self.coarse_lu.dtype == torch.float32
        for l in range(last):
            if (f32 and masked_cycle.fits(self.sides[l], last - l)
                    and all(kinds[k] == "masked" and self.w33s[k] is not None
                            for k in range(l, last))):
                kinds[l] = "masked_legs"
        return (*kinds, "direct")

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
        """Direct solve on the coarsest level (nc x nc field). On the card
        torch.linalg takes cuSOLVER from the first solve on
        (``cusolver_linalg``)."""
        if b2.is_cuda:
            cusolver_linalg()
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
                                   dtype=torch.float32,
                                   smoother: str = "masked", device=None
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
                                   dtype=torch.float32,
                                   smoother: str = "masked", device=None,
                                   packed_min_side: int = PACKED_MIN_SIDE
                                   ) -> StencilHierarchy:
    """A variable-coefficient hierarchy from fine (3,3,n,n) planes: the
    Galerkin chain as the closed-form plane contraction
    (ops/rap.rap_stencil_planes), run on ``device`` (None means
    ``"cuda"``) in ``dtype`` (the set-up span ``setup.galerkin_planes``).
    The levels keep their planes: no constant stencil is detected, as in
    the JAX package. With
    ``smoother="chebyshev"`` each level's lambda_max is the power-iteration
    estimate (``estimate_lam_max``, seed 0)."""
    device = resolve_device(device)
    side = int(c_fine.shape[-1])
    sides = _level_sides(side, n_levels)
    planes = [c_fine.to(device=device, dtype=dtype).contiguous()]
    with tracing.setup_span("setup.galerkin_planes", device):
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


def _smooth(hier: StencilHierarchy, l: int, kind: str, u2, b2, sweeps: int,
            omega: float, symmetric: bool):
    """``sweeps`` smoothing steps on a non-packed level by the machinery
    ``kind`` names: K12, the strided sweep, the degree-4 Chebyshev
    smoother, the fused sweep K5/K6, or else the plain masked sweep with
    the stored masks, or masks built here."""
    S = hier.levels[l]
    if kind == "masked_k12":
        b2 = b2.contiguous()
        for _ in range(sweeps):
            u2 = masked_gs4_sweep_var(S, u2.contiguous(), b2, omega,
                                      symmetric)
    elif kind == "strided":
        for _ in range(sweeps):
            u2 = gs4_sweep(S, u2, b2, omega, symmetric)
    elif kind == "chebyshev":
        lam = (hier.lam_maxes[l] if hier.lam_maxes is not None
               else const_lam_max(S.w33))
        for _ in range(sweeps):
            u2 = chebyshev_smooth(S, u2, b2, lam, degree=4)
    elif kind in ("fused_const", "fused_var"):
        for _ in range(sweeps):
            u2 = fused_gs4_sweep(S, u2, b2, omega, symmetric)
    else:
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
    (:func:`vcycle_stencil`) and gamma = 2 the W-cycle. Each level runs
    the machinery its kind (``hier.kinds``) names: a V-cycle that reaches
    a ``masked_legs`` level runs the rest of the way down and back as the
    masked legs K10/K11 and the coarsest level's LU between them, bitwise
    the plain ops."""
    return _cycle_at(hier, u2, b2, gamma, pre_sweeps, post_sweeps, omega,
                     symmetric, _level, False)


def _call_kind(hier: StencilHierarchy, l: int, gamma: int, u2, b2) -> str:
    """Level ``l``'s kind for one visit: the hierarchy's, but the plain
    masked sweep where its kernels cannot take the visit: a W-cycle
    (gamma != 1) through ``masked_legs``, or fields other than the f32
    that K10/K11 and K12 take."""
    kind = hier.kinds[l]
    if kind == "masked_legs" and gamma != 1:
        return "masked"
    if (kind in ("masked_legs", "masked_k12")
            and not u2.dtype == b2.dtype == torch.float32):
        return "masked"
    return kind


def _cycle_at(hier: StencilHierarchy, u2, b2, gamma: int, pre_sweeps: int,
              post_sweeps: int, omega: float, symmetric: bool, l: int,
              in_masked: bool):
    """cycle_stencil's visit of level ``l``; ``in_masked``: the level above
    was swept masked (a run of masked levels counts as one plain masked
    cycle, ``tracing.MASKED_CYCLES``; a ``masked_legs`` entry as one of
    K10/K11's)."""
    kind = _call_kind(hier, l, gamma, u2, b2)
    last = hier.n_levels - 1
    with _visit(hier, l, kind):
        if kind == "direct":
            return hier.coarse_solve(b2)
        if kind == "masked_legs":
            count_launch(tracing.MASKED_CYCLES["kernel"])
            w33s = hier.w33s[l:last]
            b2 = b2.contiguous()
            bc, ws = masked_cycle.masked_down_leg(u2.contiguous(), b2, w33s,
                                                  pre_sweeps, omega,
                                                  symmetric)
            with _visit(hier, last, hier.kinds[last]):
                uc = hier.coarse_solve(bc).contiguous()
            return masked_cycle.masked_up_leg(uc, b2, ws, w33s, post_sweeps,
                                              omega, symmetric)
        masked = kind in ("masked", "masked_k12")
        if masked and not in_masked:
            count_launch(tracing.MASKED_CYCLES["plain"])
        if hier.w33s[l] is None:
            count_launch(tracing.VAR_LEVELS[
                "kernel" if kind in ("fused_var", "masked_k12") else "plain"])
        S = hier.levels[l]
        u2 = _smooth(hier, l, kind, u2, b2, pre_sweeps, omega, symmetric)
        r = b2 - S.matvec2(u2)
        bc = restrict_mm(r, hier.P1s[l])
        uc = torch.zeros_like(bc)
        for _ in range(gamma):
            uc = _cycle_at(hier, uc, bc, gamma, pre_sweeps, post_sweeps,
                           omega, symmetric, l + 1, masked)
        u2 = u2 + prolong_mm(uc, hier.P1s[l])
        return _smooth(hier, l, kind, u2, b2, post_sweeps, omega, symmetric)


def _visit(hier: StencilHierarchy, l: int, kind: str):
    """The tracing span of one visit of level ``l``: ``vcycle.level`` with
    the level, its side and its machinery (``kind``; ``coarse`` for the
    coarsest level's LU, the kind ``direct``). Tracing off: the null
    context."""
    if not tracing.enabled():
        return tracing.span("vcycle.level")
    return tracing.span("vcycle.level", level=l, side=hier.sides[l],
                        machinery="coarse" if kind == "direct" else kind)


def vcycle_stencil(hier: StencilHierarchy, u2, b2, pre_sweeps: int = 1,
                   post_sweeps: int = 1, omega: float = 1.0,
                   symmetric: bool = True, *, _level: int = 0):
    """One V-cycle on unpacked fields from level ``_level`` down: the
    smoother="fused" solve cycle and the masked levels of a packed one
    (:func:`cycle_stencil` with gamma = 1)."""
    return cycle_stencil(hier, u2, b2, 1, pre_sweeps, post_sweeps, omega,
                         symmetric, _level=_level)


# the packed V-cycle's kinds on constant levels; with "packed_var", every
# kind that vcycle_packed runs packed
CONST_PACKED = ("packed", "legs", "split", "sweep")
PACKED = CONST_PACKED + ("packed_var",)


def level_plan(hier: StencilHierarchy, pre_sweeps: int, post_sweeps: int,
               min_side: int, fused: bool) -> tuple:
    """Each level's machinery in the packed V-cycle (:func:`vcycle_packed`):
    the packed kinds from ``min_side`` up, the hierarchy's own kinds
    (``hier.kinds``) below:

    * ``packed``: plain PyTorch packed ops, constant stencil;
    * ``packed_var``: plain PyTorch packed ops on packed planes (a level
      given by its planes alone);
    * ``legs``: the fused down/up legs (K2/K3), constant levels of side
      >= FUSED_PACKED_MIN_SIDE (every packed one) with one pre- and one
      post-sweep (``fused``);
    * ``split``: the same levels of side >= SPLIT_MIN_SIDE: the fused
      sweep (K1), the fused residual + restriction (K8), then the up leg
      (K3), as the JAX package runs its levels of M >= 4096;
    * ``sweep``: the fused packed sweep (K1) with plain residual and
      transfers, the same levels with other sweep counts.

    The GPU kernels take every size; the TPU's VMEM eligibility gates
    survive only as SPLIT_MIN_SIDE, so on a 2^k - 1 hierarchy the plan
    picks what the JAX package picks, but for the fused kinds on the
    constant packed levels below 1023^2, where the JAX package runs the
    plain packed ops.
    """
    kinds = list(hier.kinds)
    for l, s in enumerate(hier.sides[:-1]):
        if s < min_side:
            continue
        if hier.w33s[l] is None:
            kinds[l] = "packed_var"
        elif fused and s >= FUSED_PACKED_MIN_SIDE:
            if pre_sweeps == post_sweeps == 1:
                kinds[l] = "split" if s >= SPLIT_MIN_SIDE else "legs"
            else:
                kinds[l] = "sweep"
        else:
            kinds[l] = "packed"
    return tuple(kinds)


def vcycle_packed(hier: StencilHierarchy, u2, b2, pre_sweeps: int = 1,
                  post_sweeps: int = 1, omega: float = 1.0,
                  symmetric: bool = True, _level: int = 0,
                  _packed_in: bool = False, min_side: int | None = None,
                  fused: bool = False, plan: tuple | None = None):
    """V-cycle with color-packed smoothing, residual and transfers on the
    levels of side >= min_side and the unpacked cycle below; the same
    leg order and iterates as the unpacked cycle up to rounding.
    Variable-coefficient levels sweep with their packed planes.

    ``plan`` (from :func:`level_plan`) names each level's machinery; when
    None it is the plan of the arguments. With ``_packed_in`` the fields
    arrive and return packed ((4, M, M)), so a solve loop pays pack and
    unpack once per solve."""
    if min_side is None:
        min_side = PACKED_MIN_SIDE
    if plan is None:
        plan = level_plan(hier, pre_sweeps, post_sweeps, min_side, fused)
    l = _level
    if not _packed_in and plan[l] not in PACKED:
        return vcycle_stencil(hier, u2, b2, pre_sweeps, post_sweeps, omega,
                              symmetric, _level=l)
    with _visit(hier, l, plan[l]):
        return _vcycle_packed_at(hier, u2, b2, pre_sweeps, post_sweeps, omega,
                                 symmetric, l, _packed_in, min_side, fused,
                                 plan)


def _vcycle_packed_at(hier: StencilHierarchy, u2, b2, pre_sweeps: int,
                      post_sweeps: int, omega: float, symmetric: bool,
                      l: int, _packed_in: bool, min_side: int, fused: bool,
                      plan: tuple):
    """vcycle_packed's visit of level ``l``, a packed one."""
    kind = plan[l]
    S = hier.levels[l]
    m = (S.side - 1) // 2
    if kind == "packed_var":
        count_launch(tracing.VAR_LEVELS["plain"])
        cp = hier.packed_planes(l)

        def sweep(u4_, b4_):
            return gs4_sweep_packed_var(cp, u4_, b4_, m, omega, symmetric)

        def resid(u4_, b4_):
            return residual_packed_var(cp, u4_, b4_, m)
    else:
        count_launch(tracing.PACKED_LEVELS[
            "plain" if kind == "packed" else "kernel"])
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
    gamma = 1 a packed V-cycle on the levels where the plan packs a
    constant level, the unpacked cycle of ``gamma`` everywhere else (as in
    the JAX package, so a variable or fused hierarchy never takes a packed
    cycle here). ``plan`` None: :func:`level_plan` of the arguments on a
    smoother="packed" hierarchy, else the hierarchy's kinds.

    The b-chain uses restrict_mm / prolong_mm: the JAX package measured the
    4095^2 refine count to depend on this chain's precision, which is why
    TF32 stays off (StructuredSolver)."""
    if min_side is None:
        min_side = PACKED_MIN_SIDE
    if plan is None:
        plan = (level_plan(hier, pre_sweeps, post_sweeps, min_side, fused)
                if hier.smoother == "packed" else hier.kinds)
    # what runs on each level; a visit of level l is the b-chain's
    # restriction from it on the way down, the prolongation to it and its
    # cycles on the way up
    kinds = [k if gamma == 1 and k in CONST_PACKED
             else _call_kind(hier, l, gamma, b2, b2)
             for l, k in enumerate(plan)]
    L = hier.n_levels
    l0 = start_level
    bs = {l0: b2}
    for l in range(l0, L - 1):
        with _visit(hier, l, kinds[l]):
            bs[l + 1] = restrict_mm(bs[l], hier.P1s[l])
    with _visit(hier, L - 1, kinds[L - 1]):
        u = hier.coarse_solve(bs[L - 1])
    for l in range(L - 2, l0 - 1, -1):
        with _visit(hier, l, kinds[l]):
            u = prolong_mm(u, hier.P1s[l])
            for _ in range(cycles_per_level):
                if kinds[l] in CONST_PACKED:
                    u = vcycle_packed(hier, u, bs[l], pre_sweeps,
                                      post_sweeps, omega, symmetric,
                                      _level=l, min_side=min_side,
                                      fused=fused, plan=plan)
                else:
                    u = cycle_stencil(hier, u, bs[l], gamma, pre_sweeps,
                                      post_sweeps, omega, symmetric,
                                      _level=l)
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
    ``n_iters``) and each reading goes into ``history``. The V-cycles
    between two readings are one chunk (JAX's jitted ``chunk``): on the
    card one CUDA graph launch, and each reading one rss graph launch and
    one read (``graph_loop.ChunkLoop``, kept with the hierarchy). ``b2``
    goes to ``device`` (None: ``"cuda"``), where the hierarchy must be;
    ``u0`` and ``b2`` are copied into the loop's buffers."""
    return _solve_stencil(hier, b2, u0, tolerance,
                          compute_error_every_n_iters, n_iters, pre_sweeps,
                          post_sweeps, omega, symmetric, device)


def _solve_stencil(hier: StencilHierarchy, b2, u0, tolerance: float,
                   every: int, n_iters: int, pre_sweeps: int,
                   post_sweeps: int, omega: float, symmetric: bool, device,
                   host: bool = False) -> SolveResult:
    """``solve_stencil`` under the graph driver on the card, or under the
    host driver of the same pieces (the CPU's; ``host=True``: the card's
    oracle)."""
    device = resolve_device(device)
    if hier.coarse_lu.device.type != device.type:
        raise ValueError(f"the hierarchy is on {hier.coarse_lu.device}, "
                         f"the solve on {device}")
    b2 = torch.as_tensor(b2, device=device)
    u = torch.zeros_like(b2) if u0 is None else torch.as_tensor(
        u0, device=device)
    key = (pre_sweeps, post_sweeps, omega, symmetric,
           *((t.dtype, tuple(t.shape), t.device) for t in (u, b2)))
    loop = hier.chunk_loops.get(key)
    if loop is None:
        ref = weakref.ref(hier)     # the hierarchy holds the loop
        loop = hier.chunk_loops[key] = graph_loop.ChunkLoop(
            lambda uu, bb: vcycle_stencil(ref(), uu, bb, pre_sweeps,
                                          post_sweeps, omega, symmetric),
            lambda uu, bb: rss_from_residual(
                bb - ref().levels[0].matvec2(uu)), u, b2)
    u, it, error, history = loop.solve(u, b2, tolerance, every, n_iters,
                                       host or device.type != "cuda")
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


def _assign(dst: DF32, src: DF32) -> None:
    """Write a df32 value into the buffers of ``dst`` (a loop's state)."""
    dst.hi.copy_(src.hi)
    dst.lo.copy_(src.lo)


class StructuredSolver:
    """Single-device structured solver: the hierarchy, with each level's
    machinery, is built once, then solves are cheap to repeat.

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
    amg_tpu/structured.py:704-740). On the card each solve loop is one CUDA
    graph with its convergence control on the device (JAX's one
    ``lax.while_loop`` program; ``ops/kernels/graph_loop.py``), captured
    by ``warmup`` or the first solve; on the CPU the same loop pieces run
    under a host driver. ``device`` None means
    ``"cuda"``; pass ``device="cpu"`` to run on the CPU.

    Loops, as in the JAX package: the packed df32 loop for a constant
    operator with a packed smoother (side >= packed_min_side, >= 2
    levels); the unpacked df32 loop otherwise (variable operators, the
    unpacked smoothers, small sides); the f64 loop for
    ``precision="f64"``; ``solve_ir``, the host-stepped refine with an
    f64 residual, whatever the precision. Every loop's V-cycles run
    ``plan``; the unpacked loops' FMG start takes the JAX defaults
    (:func:`fmg_stencil`: no fused kernel, packed levels from
    PACKED_MIN_SIDE on a packed hierarchy).
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
        with tracing.setup_span("setup.hierarchy", self.device):
            if A_planes is not None:
                self.hier = build_stencil_hierarchy_planes(
                    A_planes, n_levels, device=self.device,
                    smoother=self.smoother, packed_min_side=packed_min_side)
                self.A64 = Stencil2D(side=side, c=A_planes.to(
                    device=self.device, dtype=torch.float64))
            elif device_setup and A_fine is None:
                self.hier = build_stencil_hierarchy_device(
                    side, n_levels, device=self.device,
                    smoother=self.smoother)
                # the f64 fine operator as exact static weights
                self.A64 = Stencil2D.const(poisson_const_w33(side, 1)[0],
                                           side, torch.float64)
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
        # K4 needs power-of-two weights (2^k - 1 grids); other sides take
        # the general df32 residual, as the JAX package does
        self.df_kernel = (self.fused_packed and self.w33 is not None
                          and is_pow2_weights(self.w33))
        self._loop = None         # the solve loop (_loop_state)
        self._refine = None       # solve_ir's step (_refine_state)
        self._graphs = {}         # their programs' graphs on the card

    @property
    def plan(self) -> tuple:
        """Each level's machinery in the solve's V-cycles, kernels
        included: :func:`level_plan` with the packed smoother, else the
        hierarchy's kinds."""
        if self.smoother != "packed":
            return self.hier.kinds
        return level_plan(self.hier, self.pre_sweeps, self.post_sweeps,
                          self.packed_min_side, self.fused_packed)

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
        if tuple(b64.shape) != (self.side, self.side):
            raise ValueError(f"the rhs must be ({self.side}, {self.side}), "
                             f"got {tuple(b64.shape)}")
        return b64

    # -- the solve loops, in JAX's cond/body form ----------------------------

    def _loop_state(self) -> SimpleNamespace:
        """The solve loop (built once): its buffers, the
        ``graph_loop.DeviceLoop`` of its pieces and its programs, each a
        (pre, post) pair: "device" (solve_ir_device: the f64 rhs ``b64``
        in, the f64 ``u_out`` out) and, for the packed loop, "prepared"
        (solve_ir_device_prepared: the packed df32 rhs ``b4`` in, the
        packed iterate ``u4`` out). Every program writes ``stats``
        ([final rss, refines, the effective tolerance])."""
        if self._loop is None:
            dev = self.device
            L = SimpleNamespace(
                tol_in=torch.zeros((), dtype=torch.float64, device=dev),
                rtol=torch.zeros((), dtype=torch.float64, device=dev),
                tol_eff=torch.zeros((), dtype=torch.float64, device=dev),
                err=torch.zeros((), dtype=torch.float64, device=dev),
                it=torch.zeros((), dtype=torch.int32, device=dev),
                n=torch.zeros((), dtype=torch.int32, device=dev),
                stats=torch.zeros(3, dtype=torch.float64, device=dev),
                b64=torch.zeros((self.side, self.side), dtype=torch.float64,
                                device=dev))
            if self.precision == "f64":
                self._f64_loop(L)
            elif self.packed_loop:
                self._packed_df32_loop(L)
            else:
                self._unpacked_df32_loop(L)
            self._loop = L
        return self._loop

    def _start(self, L, rss_b: torch.Tensor) -> None:
        """The state at entry: tol_eff = max(tol, rtol * rss(b)) (tol where
        rtol is 0), err = inf, it = 0."""
        L.tol_eff.copy_(torch.where(L.rtol > 0.0,
                                    torch.maximum(L.tol_in, L.rtol * rss_b),
                                    L.tol_in))
        L.err.fill_(float("inf"))
        L.it.zero_()

    def _finish(self, L, final: torch.Tensor) -> None:
        L.stats.copy_(torch.stack([final, L.it.to(torch.float64),
                                   L.tol_eff]))

    def _packed_df32_loop(self, L) -> None:
        """JAX's solve_core_packed: the state (u4 df32, err, it) stays
        color-packed. The rss is lagged (that of u before the latest
        correction); a pass refines only while it is above the tolerance
        and counts only then, so a converged loop exits through a
        residual-only pass whose rss is the final one; on budget
        exhaustion the final rss is recomputed."""
        M = self.m + 1

        def f4():
            return torch.zeros((4, M, M), dtype=torch.float32,
                               device=self.device)
        b4 = L.b4 = DF32(hi=f4(), lo=f4())
        u4 = L.u4 = DF32(hi=f4(), lo=f4())
        L.u_out = torch.zeros_like(L.b64)

        def start(prepare=False):
            tracing.begin("solve")
            with tracing.span("solve.start"):
                if prepare:
                    _assign(b4, self._prepare(L.b64))
                self._start(L, df_rss_fast(b4))
                _assign(u4, self._fmg_start(b4))

        def body():
            with tracing.span("solve.residual"):
                L.r_hi, err = self._residual_hi_rss(b4, u4)
                L.err.copy_(err)

        def refine():
            with tracing.span("solve.refine"):
                e4 = torch.zeros_like(L.r_hi)
                for _ in range(self.cycles_per_refine):
                    e4 = self._vcycle(e4, L.r_hi, packed_in=True)
                _assign(u4, df_add_f32(u4, e4))

        def final():
            with tracing.span("solve.final"):
                L.err.copy_(self._residual_hi_rss(b4, u4)[1])

        def stats(finalize=False):
            with tracing.span("solve.finish"):
                self._finish(L, L.err)
                if finalize:
                    L.u_out.copy_(self.finalize_u(u4))
            tracing.end("solve")

        L.loop = graph_loop.DeviceLoop(body, refine, final, err=L.err,
                                       tol=L.tol_eff, it=L.it, n=L.n)
        L.programs = {"device": (lambda: start(True), lambda: stats(True)),
                      "prepared": (start, stats)}

    def _unpacked_df32_loop(self, L) -> None:
        """JAX's solve_loop_df32 on unpacked fields: the rss lags one
        correction and every pass refines, so the loop runs one refine
        past convergence; the final rss is always recomputed (df_rss)."""
        def f2():
            return torch.zeros((self.side, self.side), dtype=torch.float32,
                               device=self.device)
        b_df, u = DF32(hi=f2(), lo=f2()), DF32(hi=f2(), lo=f2())
        L.u_out = torch.zeros_like(L.b64)

        def start():
            tracing.begin("solve")
            with tracing.span("solve.start"):
                _assign(b_df, DF32.from_f64(L.b64))
                self._start(L, df_rss_fast(b_df))
                _assign(u, DF32.from_f32(self._fmg(b_df.hi)))

        def body():
            with tracing.span("solve.residual"):
                r = self._df_residual(b_df, u)
                L.err.copy_(df_rss_fast(r))
            with tracing.span("solve.refine"):
                _assign(u, df_add_f32(u, self._cycles(r.hi)))

        def finish():
            with tracing.span("solve.finish"):
                self._finish(L, df_rss(self._df_residual(b_df, u)))
                L.u_out.copy_(u.to_f64())
            tracing.end("solve")

        L.loop = graph_loop.DeviceLoop(body, err=L.err, tol=L.tol_eff,
                                       it=L.it, n=L.n)
        L.programs = {"device": (start, finish)}

    def _f64_loop(self, L) -> None:
        """JAX's solve_loop_f64: f64 residual and rss, f32 V-cycles on the
        residual, the FMG start in f32 cast to f64; the rss lags one
        correction, every pass refines, and the final rss is
        recomputed."""
        u = L.u_out = torch.zeros_like(L.b64)

        def start():
            tracing.begin("solve")
            with tracing.span("solve.start"):
                self._start(L, rss_from_residual(L.b64))
                u.copy_(self._fmg(L.b64.to(torch.float32)).to(torch.float64))

        def body():
            with tracing.span("solve.residual"):
                r = L.b64 - self.A64.matvec2(u)
                L.err.copy_(rss_from_residual(r))
            with tracing.span("solve.refine"):
                u.copy_(u + self._cycles(r.to(torch.float32))
                        .to(torch.float64))

        def finish():
            with tracing.span("solve.finish"):
                self._finish(L, rss_from_residual(L.b64
                                                  - self.A64.matvec2(u)))
            tracing.end("solve")

        L.loop = graph_loop.DeviceLoop(body, err=L.err, tol=L.tol_eff,
                                       it=L.it, n=L.n)
        L.programs = {"device": (start, finish)}

    def _graph(self, name: str) -> graph_loop.LoopGraph:
        """The program's loop graph on the card, captured and instantiated
        at its first use (JAX compiles at the first call)."""
        g = self._graphs.get(name)
        if g is None:
            L = self._loop_state()
            g = self._graphs[name] = L.loop.graph(*L.programs[name])
        return g

    def _run(self, name: str, tolerance: float, n_refine: int, rtol: float,
             host: bool) -> SimpleNamespace:
        """One solve of program ``name`` on the inputs already in its
        buffers: on the card one launch of its graph (no host read), on
        the CPU, or with ``host=True`` anywhere, the plain host driver of
        the same pieces."""
        L = self._loop_state()
        L.tol_in.fill_(tolerance)
        L.rtol.fill_(rtol)
        L.n.fill_(n_refine)
        if host or self.device.type != "cuda":
            L.loop.run_host(*L.programs[name])
        else:
            self._graph(name).launch()
        return L

    def _solve_device(self, b2_f64, tolerance: float, n_refine: int,
                      rtol: float, host: bool = False):
        """solve_ir_device's program: ``(u, stats3)`` (clones), stats3 =
        [final rss, refines, effective tolerance]. ``host=True`` is the
        host-driven oracle of the same pieces. Host spans while tracing is
        on: ``entry.solve_ir_device`` around ``entry.copy_in``,
        ``entry.launch`` and ``entry.clone_out``."""
        with tracing.span("entry.solve_ir_device"):
            b64 = self._b64(b2_f64)
            L = self._loop_state()
            with tracing.span("entry.copy_in"):
                L.b64.copy_(b64)
            with tracing.span("entry.launch"):
                self._run("device", tolerance, n_refine, rtol, host)
            with tracing.span("entry.clone_out"):
                return L.u_out.clone(), L.stats.clone()

    def _require_packed(self) -> None:
        if not self.packed_loop:
            raise ValueError("the prepared-rhs path needs the packed df32 "
                             "loop (constant operator, smoother 'auto' or "
                             "'packed', side >= packed_min_side, >= 2 "
                             "levels)")

    def _solve_prepared(self, b4_df: DF32, tolerance: float, n_refine: int,
                        rtol: float, host: bool = False):
        self._require_packed()
        L = self._loop_state()
        for name, t in (("b.hi", b4_df.hi), ("b.lo", b4_df.lo)):
            require_f32(name, t, L.b4.hi.shape, L.b4.hi.device)
        _assign(L.b4, b4_df)
        self._run("prepared", tolerance, n_refine, rtol, host)
        return DF32(hi=L.u4.hi.clone(), lo=L.u4.lo.clone()), L.stats.clone()

    # -- public entry points -------------------------------------------------

    def _prepare(self, b64: torch.Tensor) -> DF32:
        b_df = DF32.from_f64(b64)
        return DF32(hi=pack(b_df.hi, self.m), lo=pack(b_df.lo, self.m))

    def prepare_b(self, b2_f64: torch.Tensor) -> DF32:
        """f64 (side, side) rhs -> packed df32, once per rhs."""
        self._require_packed()
        return self._prepare(self._b64(b2_f64))

    def finalize_u(self, u4_df: DF32) -> torch.Tensor:
        return (unpack(u4_df.hi, self.m).to(torch.float64)
                + unpack(u4_df.lo, self.m).to(torch.float64))

    def solve_ir_device_prepared(self, b4_df: DF32, tolerance: float = 1e-7,
                                 n_refine: int = 40, rtol: float = 0.0):
        """Defect-correction solve on a prepared rhs (JAX's
        solve_core_packed; see ``_packed_df32_loop``). Returns ``(u4_df,
        stats)``: the packed df32 iterate, to give to ``finalize_u`` or to
        keep packed into a following solve, and the f64 tensor
        ``[final_rss, refines]``. On the card one graph launch and no host
        synchronization."""
        u4, stats = self._solve_prepared(b4_df, tolerance, n_refine, rtol)
        return u4, stats[:2]

    def solve_ir_device(self, b2_f64: torch.Tensor, tolerance: float = 1e-7,
                        n_refine: int = 40, rtol: float = 0.0):
        """Solve A u = b to rss <= tolerance (or rtol * rss(b)): returns
        ``(u, stats)`` with u the f64 (side, side) field and stats the f64
        tensor ``[final_rss, refines]``. On the card one graph launch
        (the loop's convergence control runs on the device) and no host
        synchronization, so solves pipeline."""
        u, stats = self._solve_device(b2_f64, tolerance, n_refine, rtol)
        return u, stats[:2]

    def solve_ir_fused(self, b2_f64: torch.Tensor, tolerance: float = 1e-7,
                       n_refine: int = 40, rtol: float = 0.0) -> SolveResult:
        """Solve and report with one fetch of the stats: ``iterations``
        counts the refine loop's V-cycles (the FMG start excluded)."""
        u, stats = self._solve_device(b2_f64, tolerance, n_refine, rtol)
        err_v, it_v, tol_eff = stats.tolist()
        check_rss(err_v)
        iters = int(it_v) * self.cycles_per_refine
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

    def _refine_state(self) -> SimpleNamespace:
        """``solve_ir``'s program (JAX's jitted ``refine_step``) on fixed
        f64 buffers (built once): ``step`` writes ``_refine_step(u, b)``
        into ``u_next`` and ``err``."""
        if self._refine is None:
            def f64(shape=(self.side, self.side)):
                return torch.zeros(shape, dtype=torch.float64,
                                   device=self.device)
            R = SimpleNamespace(u=f64(), b=f64(), u_next=f64(), err=f64(()))

            def step():
                u_next, err = self._refine_step(R.u, R.b)
                R.u_next.copy_(u_next)
                R.err.copy_(err)
            R.step = step
            self._refine = R
        return self._refine

    def _refine_graph(self) -> graph_loop.StraightGraph:
        """The refine program's graph on the card, captured at its first
        use (its warm-up runs the step once on the buffers)."""
        g = self._graphs.get("refine")
        if g is None:
            g = self._graphs["refine"] = graph_loop.StraightGraph(
                self._refine_state().step, self.device)
        return g

    def warmup(self, refine_step: bool = False) -> None:
        """JAX's compile step: on the card, capture and instantiate the
        solve loop's graphs (both programs of the packed loop); then one
        solve on a zero rhs, with one read of its stats.
        ``refine_step=True`` also readies ``solve_ir``: on the card its
        refine graph, on the CPU one refine."""
        z = torch.zeros((self.side, self.side), dtype=torch.float64,
                        device=self.device)
        if refine_step:
            if self.device.type == "cuda":
                self._refine_graph()
            else:
                float(self._refine_step(z, z)[1])
        if self.device.type == "cuda":
            for name in self._loop_state().programs:
                self._graph(name)
        with tracing.setup_span("setup.warm_solve"):
            _, stats = self.solve_ir_device(z, 1e-7, 40)
            stats.tolist()

    def solve_ir(self, b2_f64, tolerance: float = 1e-7,
                 n_refine: int = 40) -> SolveResult:
        """The host-stepped refine loop from u = 0 (no FMG start), with
        the JAX loop's lagged semantics: each step returns the corrected
        iterate and the rss of the one it started from, and the
        correction is kept only while that rss is above ``tolerance``, so
        the stopping step's cycles run and are discarded. On the card each
        step is one launch of the refine graph and one read of its rss.
        ``history`` holds (V-cycles so far, rss) of every step;
        ``iterations`` the V-cycles of the kept corrections."""
        return self._solve_ir(b2_f64, tolerance, n_refine)

    def _solve_ir(self, b2_f64, tolerance: float, n_refine: int,
                  host: bool = False) -> SolveResult:
        """``solve_ir`` under the graph driver on the card, or under the
        host driver of the same step (the CPU's; ``host=True``: the
        card's oracle)."""
        b64 = self._b64(b2_f64)
        R = self._refine_state()
        graph = None
        if not host and self.device.type == "cuda":
            graph = self._refine_graph()    # before the inputs go in
        R.b.copy_(b64)
        R.u.zero_()
        history = []
        it = 0
        error = float("inf")
        for _ in range(n_refine):
            if graph is None:
                R.step()
            else:
                graph.launch()
            error = check_rss(float(R.err))  # the step's one host sync
            history.append((it, error))
            if error <= tolerance:
                break
            R.u.copy_(R.u_next)
            it += self.cycles_per_refine
        return SolveResult(u=R.u.clone(), iterations=it, error=error,
                           converged=error <= tolerance, history=history)
