"""Distributed structured multigrid: row-partitioned V-cycles with ghost-
strip exchanges and coarse-level agglomeration.

PyTorch port of ``amg_tpu/parallel/structured_dist.py``, constant-
coefficient levels. The 2-D grid is cut into D contiguous row slabs, the
mesh. The JAX package runs one program per device under ``shard_map``; here
the mesh is a leading slab axis: the padded (n_pad, n) field is viewed as
(D, B, n) and every per-slab function runs on all D slabs in one set of
batched tensor ops, so a level costs the same launches for any D. The
collectives become tensor ops on that axis:

* ``lax.axis_index`` is a (D, 1, 1) row offset, ``slab * B``;
* ``lax.ppermute`` by h is a shift by h along the slab axis, zero-filled;
* ``all_gather(tiled=True)`` is a reshape, ``psum`` a sum.

All D slabs live on one device (``device``): on the card a mesh of slabs,
whose ``halo="rdma"`` exchange is the CUDA kernel K7 (ops/kernels/halo.py),
written as a put through per-slab pointer tables so that slabs on peer
cards change where the pointers point, not the kernel.

Layout invariants (``build_dist_hierarchy``), as in the JAX package:

* sharded level l has ``n_pad_l = D * B_l`` rows, ``B_l`` even, so a slab's
  local row parity is the global one and the four colors align;
* ``B_{l+1} = B_l / 2``: a coarse slab depends on its own fine slab plus
  one halo row (restriction) and one coarse halo row (prolongation);
* padding rows (global row >= side) keep u = 0 and a zero residual.

Halo modes (``halo=``): ``"sweep"`` one G-row ghost-strip exchange of
(u, b) per smoothing call, the color steps run on the extended slab
(temporal blocking) and G = steps + 2 rows also cover the residual and
restriction that follow; ``"overlap"`` the same with the slab interior
swept apart from two boundary bands (bitwise equal; JAX's accelerator
default); ``"rdma"`` the same with K7 as the exchange where it is single-
hop; ``"step"`` a one-row halo before every color step (JAX's CPU default).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from amg_tpu_torch.models import poisson
from amg_tpu_torch.ops.doublefloat import (DF32, df_add, df_add_f32,
                                           df_apply_const, df_neg, df_rss)
from amg_tpu_torch.ops.kernels.halo import (rdma_halo_exchange,
                                            rdma_halo_exchange_plain)
from amg_tpu_torch.ops.transfer import linear_interp_1d
from amg_tpu_torch.sparse.stencil import FOUR_COLORS, W2D, Stencil2D
from amg_tpu_torch.structured import (SolveResult, StencilHierarchy,
                                      _not_yet, cycle_stencil,
                                      max_levels_for_side)
from amg_tpu_torch.utils.device import resolve_device

HALO_MODES = ("overlap", "sweep", "step", "rdma", "packed")


# ---------------------------------------------------------------------------
# Slab-axis helpers: every field is (D, R, n), slab d's row r is global row
# d * B + r (+ a window offset).


def _row0(D: int, B: int, device) -> torch.Tensor:
    """Each slab's first global row, (D, 1, 1): ``lax.axis_index * B``."""
    return (torch.arange(D, device=device) * B).reshape(D, 1, 1)


def _global_rows(D: int, B: int, R: int, device):
    """(D, R, 1) global row of each slab's first R rows."""
    return torch.arange(R, device=device).reshape(1, R, 1) + _row0(D, B,
                                                                   device)


def _halo(u):
    """(top, bot): each slab's neighbour rows above and below, (D, 1, n),
    zeros at the line's ends (JAX ``_halo``)."""
    z = torch.zeros_like(u[:1, :1])
    return (torch.cat([z, u[:-1, -1:]], dim=0),
            torch.cat([u[1:, :1], z], dim=0))


def _conv9_const(w33, x):
    """9-point constant-stencil apply on (..., R, n) windows with zero
    padding on all sides; rows 0 and R-1 see zeros above/below."""
    R, n = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1))
    out = None
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            w = w33[dj + 1][di + 1]
            if w == 0.0:
                continue
            t = w * xp[..., 1 + dj:1 + dj + R, 1 + di:1 + di + n]
            out = t if out is None else out + t
    return out


def _extend(strips, u, b, G: int):
    """(u_ext, b_ext): the (D, B + 2G, n) slabs framed by the receive strips
    of a (u, b) exchange, (D, 2G, 2n)."""
    n = u.shape[2]
    return (torch.cat([strips[:, :G, :n], u, strips[:, G:, :n]], dim=1),
            torch.cat([strips[:, :G, n:], b, strips[:, G:, n:]], dim=1))


def _windows(x, G: int):
    """Each slab with the G global rows above and below it, zeros beyond
    the line's ends: (D, B + 2G, n), a view of the padded field. Reaches
    as many neighbour slabs as G needs."""
    D, B, n = x.shape
    full = F.pad(x.reshape(D * B, n), (0, 0, G, G))
    return full.unfold(0, B + 2 * G, B).transpose(1, 2)


def _exchange_strips(u, b, G: int):
    """One ghost-strip exchange of u and b (JAX ``_exchange_strips``):
    single-hop (G <= B) through K7's plain version, multi-hop (G > B, tiny
    slabs) as windows of the padded field."""
    if G <= u.shape[1]:
        return _extend(rdma_halo_exchange_plain((u, b), G), u, b, G)
    return _windows(u, G), _windows(b, G)


def ghost_rows(sweeps: int, symmetric: bool) -> int:
    """G = color steps + 2, rounded up to even (parity alignment)."""
    g = (8 if symmetric else 4) * sweeps + 2
    return g + g % 2


# ---------------------------------------------------------------------------
# Ghost-strip sweeps on constant levels.


def _masked_steps_const(w33, x, bx, row0, side: int, sweeps: int,
                        omega: float, symmetric: bool):
    """Masked four-color steps on (D, R, n) windows whose row r is global
    row ``row0 + r`` (row0: (D, 1, 1)). Rows outside [0, side) never update;
    rows near the window edges go invalid, for the caller to discard."""
    R, n = x.shape[-2:]
    row_g = torch.arange(R, device=x.device).reshape(1, R, 1) + row0
    col = torch.arange(n, device=x.device).reshape(1, 1, n)
    valid = (row_g >= 0) & (row_g < side)
    masks = [((row_g % 2) == pj) & ((col % 2) == pi) & valid
             for pj, pi in FOUR_COLORS]
    order = [0, 1, 2, 3]
    if symmetric:
        order = order + order[::-1]
    inv_diag = 1.0 / w33[1][1]
    for _ in range(sweeps):
        for c in order:
            r = bx - _conv9_const(w33, x)
            x = x + torch.where(masks[c], omega * r * inv_diag, 0.0)
    return x


def _gs4_sweep_ghost_const(w33, u, b, side: int, sweeps: int, omega: float,
                           symmetric: bool):
    """``sweeps`` GS sweeps with ONE ghost-strip exchange. Returns (u_ext,
    b_ext, G): rows [G-2, G+B+2) of u_ext are what the global masked sweep
    gives."""
    D, B, _ = u.shape
    G = ghost_rows(sweeps, symmetric)
    u_ext, b_ext = _exchange_strips(u, b, G)
    u_ext = _masked_steps_const(w33, u_ext, b_ext,
                                _row0(D, B, u.device) - G, side, sweeps,
                                omega, symmetric)
    return u_ext, b_ext, G


def _gs4_sweep_overlap_const(w33, u, b, side: int, sweeps: int,
                             omega: float, symmetric: bool):
    """The ghost sweep with the slab interior swept from local rows only
    and two boundary bands (G + 2M rows) from the exchanged strips; bitwise
    equal to the ghost sweep. On one stream the bands run after the
    interior; overlapping them with the exchange is later work."""
    D, B, _ = u.shape
    M = (8 if symmetric else 4) * sweeps
    G = ghost_rows(sweeps, symmetric)
    if B < 2 * M:  # slab too thin to split
        return _gs4_sweep_ghost_const(w33, u, b, side, sweeps, omega,
                                      symmetric)
    row0 = _row0(D, B, u.device)
    u_ext_in, b_ext_in = _exchange_strips(u, b, G)
    u_local = _masked_steps_const(w33, u, b, row0, side, sweeps, omega,
                                  symmetric)          # valid on [M, B-M)
    H = G + 2 * M
    top = _masked_steps_const(w33, u_ext_in[:, :H], b_ext_in[:, :H],
                              row0 - G, side, sweeps, omega, symmetric)
    lo = B + 2 * G - H
    bot = _masked_steps_const(w33, u_ext_in[:, lo:], b_ext_in[:, lo:],
                              row0 + B + G - H, side, sweeps, omega,
                              symmetric)
    u_ext = torch.cat([top[:, :G + M], u_local[:, M:B - M],
                       bot[:, H - (G + M):]], dim=1)
    return u_ext, b_ext_in, G


def _gs4_sweep_rdma_const(w33, u, b, side: int, sweeps: int, omega: float,
                          symmetric: bool):
    """The ghost sweep with K7 as the exchange: u and b ride one launch.
    JAX's rule: with one slab, or strips that span more than one
    neighbour slab (G > B), the level takes the ghost sweep."""
    D, B, _ = u.shape
    G = ghost_rows(sweeps, symmetric)
    if D == 1 or G > B:
        return _gs4_sweep_ghost_const(w33, u, b, side, sweeps, omega,
                                      symmetric)
    u, b = u.contiguous(), b.contiguous()
    u_ext, b_ext = _extend(rdma_halo_exchange((u, b), G), u, b, G)
    u_ext = _masked_steps_const(w33, u_ext, b_ext,
                                _row0(D, B, u.device) - G, side, sweeps,
                                omega, symmetric)
    return u_ext, b_ext, G


GHOST_SWEEPS = {"sweep": _gs4_sweep_ghost_const,
                "overlap": _gs4_sweep_overlap_const,
                "rdma": _gs4_sweep_rdma_const}


# ---------------------------------------------------------------------------
# halo="step": a one-row halo before every color step.


def _matvec_const(w33, u, side: int):
    """A u on the slabs with a 1-row halo; padding rows act as identity."""
    D, B, _ = u.shape
    top, bot = _halo(u)
    av = _conv9_const(w33, torch.cat([top, u, bot], dim=1))[:, 1:1 + B]
    return torch.where(_global_rows(D, B, B, u.device) < side, av, u)


def _gs4_sweep_local_const(w33, u, b, side: int, omega: float,
                           symmetric: bool):
    """One GS sweep with a halo exchange before each color step."""
    D, B, n = u.shape
    row_par = torch.arange(B, device=u.device).reshape(1, B, 1) % 2
    col_par = torch.arange(n, device=u.device).reshape(1, 1, n) % 2
    inv_diag = 1.0 / w33[1][1]
    order = list(FOUR_COLORS)
    if symmetric:
        order = order + order[::-1]
    for pj, pi in order:
        r = b - _matvec_const(w33, u, side)
        mask = ((row_par == pj) & (col_par == pi)).to(u.dtype)
        u = u + (omega * mask) * (r * inv_diag)
    return u


# ---------------------------------------------------------------------------
# Transfers.


def _restrict_from_ext(r01, Bc: int, nc: int, nc_real: int):
    """Full-weighting restriction from slab rows 0..B (B + 1 rows, row B
    the next slab's first): the (D, Bc, nc) coarse slabs, rows beyond the
    real coarse grid zeroed."""
    D = r01.shape[0]
    out = None
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            t = float(W2D[dj + 1, di + 1]) * r01[
                :, 1 + dj:dj + 2 * Bc:2, 1 + di:di + 2 * nc:2]
            out = t if out is None else out + t
    return torch.where(_global_rows(D, Bc, Bc, r01.device) < nc_real,
                       out, 0.0)


def _restrict_local(r, Bc: int, nc: int, nc_real: int):
    """Full-weighting restriction of the slabs with a one-row halo."""
    _, bot = _halo(r)
    return _restrict_from_ext(torch.cat([r, bot], dim=1), Bc, nc, nc_real)


def _prolong_from_z(z, B: int, n: int):
    out = None
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            t = float(W2D[dj + 1, di + 1]) * z[
                :, 1 + dj:1 + dj + B, 1 + di:1 + di + n]
            out = t if out is None else out + t
    return out


def _scatter_coarse(block, B: int, n: int):
    """(D, Bc + 1, nc) coarse rows (row 0 the halo row above the slab) at
    the odd fine points of a zero (D, B + 2, n + 2) frame."""
    D, Bc1, nc = block.shape
    z = block.new_zeros((D, B + 2, n + 2))
    z[:, 0:2 * Bc1 - 1:2, 2:2 * nc + 1:2] = block
    return z


def _prolong_local(uc, B: int, n: int):
    """Bilinear prolongation onto the fine slabs from the coarse slabs and
    their top coarse halo row."""
    top, _ = _halo(uc)
    return _prolong_from_z(_scatter_coarse(torch.cat([top, uc], dim=1),
                                           B, n), B, n)


def _prolong_from_replicated(uc_full, B: int, n: int, Bc: int, D: int):
    """Prolongate the replicated coarse field onto every slab: each slab's
    coarse rows plus the row above, gathered as windows of the padded
    field (JAX's per-device ``dynamic_slice``)."""
    ucp = F.pad(uc_full, (0, 0, 1, D * Bc - uc_full.shape[0]))
    block = ucp.unfold(0, Bc + 1, Bc).transpose(1, 2)   # (D, Bc + 1, nc)
    return _prolong_from_z(_scatter_coarse(block, B, n), B, n)


# ---------------------------------------------------------------------------
# The df32 residual.


def _df_residual_const(w33, b_df: DF32, u_df: DF32, side: int) -> DF32:
    """r = b - A u on the slabs in double-float32: a one-row halo of hi and
    lo, the 9 weights as exact (hi, lo) pairs (df_apply_const); padding
    rows carry zero residual."""
    D, B, _ = u_df.hi.shape
    framed = []
    for x in (u_df.hi, u_df.lo):
        top, bot = _halo(x)
        framed.append(F.pad(torch.cat([top, x, bot], dim=1), (1, 1)))
    r = df_add(b_df, df_neg(df_apply_const(w33, *framed)))
    keep = _global_rows(D, B, B, u_df.hi.device) < side
    return DF32(hi=torch.where(keep, r.hi, 0.0),
                lo=torch.where(keep, r.lo, 0.0))


# ---------------------------------------------------------------------------
# Hierarchy.


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """The distribution's static metadata (JAX ``DistConfig``, without its
    TPU interpret-mode setting). ``w33s``: each sharded level's constant
    3x3 weights."""

    n_devices: int
    sides: tuple            # grid side per level (all levels)
    blocks: tuple           # B_l rows per slab, sharded levels
    n_sharded: int          # number of sharded levels
    pre_sweeps: int = 1
    post_sweeps: int = 1
    omega: float = 1.0
    symmetric: bool = True
    w33s: tuple = ()
    halo: str = "overlap"


def plan_distribution(side: int, n_levels: int, n_devices: int,
                      min_rows: int = 2):
    """The most sharded levels whose halving, even blocks stay >= min_rows
    rows, the coarsest level always replicated. Returns (sides, blocks,
    n_sharded)."""
    sides = [side]
    for _ in range(n_levels - 1):
        sides.append((sides[-1] - 1) // 2)
    for Ls in range(n_levels - 1, 0, -1):
        mult = 1 << Ls
        B0 = -(-side // n_devices)
        B0 = -(-B0 // mult) * mult
        if B0 // (1 << (Ls - 1)) >= min_rows:
            return tuple(sides), tuple(B0 >> l for l in range(Ls)), Ls
    return tuple(sides), (), 0


def _visible_devices() -> int:
    """``n_devices=None``: the number of visible CUDA devices."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("n_devices=None counts the visible CUDA devices "
                           "and there are none; pass n_devices")
    return n


def _galerkin_chain(A_fine, sides) -> list:
    """The scipy Galerkin RAP chain under the tensor-product bilinear
    transfer, on the host (multigrid.hpp:211-243)."""
    mats = [A_fine.tocsr()]
    for l in range(len(sides) - 1):
        P1 = linear_interp_1d(sides[l], sides[l + 1])
        P2 = sp.kron(P1, P1).tocsr()
        mats.append((P2.T @ (mats[-1] @ P2)).tocsr())
    return mats


def build_dist_hierarchy(side: int, n_levels: int | None = None,
                         n_devices: int | None = None, dtype=torch.float32,
                         A_fine=None, force_var: bool = False, device=None):
    """Host setup: the plan, every level's constant weights from the scipy
    RAP chain (``Stencil2D.from_scipy`` in ``dtype``), and the replicated
    coarse sub-hierarchy (levels n_sharded..) as a masked-smoother
    ``StencilHierarchy`` on ``device`` (None: ``"cuda"``) with the dense LU
    of the coarsest level. Returns ``(cfg, sub_hier)``; the JAX package's
    per-level coefficient placeholders have no counterpart."""
    device = resolve_device(device)
    if force_var:
        raise _not_yet("force_var (variable-coefficient sharded levels)",
                       "Queue 1 item 13, structured_dist")
    if n_devices is None:
        n_devices = _visible_devices()
    if n_levels is None:
        n_levels = max_levels_for_side(side)
    sides, blocks, Ls = plan_distribution(side, n_levels, n_devices)
    if Ls == 0:
        raise ValueError(f"side {side} with {n_levels} levels leaves no "
                         f"level to shard over {n_devices} slabs")
    if A_fine is None:
        A_fine = poisson.laplacian_scipy(side)
    mats = _galerkin_chain(A_fine, sides)
    w33s = []
    for l, A in enumerate(mats):
        w33 = Stencil2D.from_scipy(A, sides[l], dtype=dtype).w33
        if w33 is None:
            raise _not_yet(f"a variable-coefficient level (side {sides[l]}"
                           "; a non-constant A_fine)",
                           "Queue 1 item 13, structured_dist")
        w33s.append(w33)
    lu, piv = torch.linalg.lu_factor(
        torch.as_tensor(mats[-1].toarray(), dtype=dtype))
    sub_sides = sides[Ls:]
    P1s = [torch.as_tensor(linear_interp_1d(sub_sides[i], sub_sides[i + 1]
                                            ).toarray(),
                           dtype=dtype, device=device)
           for i in range(len(sub_sides) - 1)]
    sub_hier = StencilHierarchy(sub_sides, w33s[Ls:], lu.to(device),
                                piv.to(device), P1s, smoother="masked")
    cfg = DistConfig(n_devices=n_devices, sides=sides, blocks=blocks,
                     n_sharded=Ls, w33s=tuple(w33s[:Ls]))
    return cfg, sub_hier


# ---------------------------------------------------------------------------
# The V-cycle.


def vcycle_dist(cfg: DistConfig, sub_hier: StencilHierarchy, u, b):
    """One V-cycle on (D, B_0, n_0) slabs (JAX ``_vcycle_local`` on every
    slab at once): the sharded down-leg, one V-cycle of the replicated
    sub-hierarchy from zero, the sharded up-leg."""
    D, Ls = cfg.n_devices, cfg.n_sharded
    ghost = GHOST_SWEEPS.get(cfg.halo)
    if ghost is None and cfg.halo != "step":
        raise ValueError(f"halo mode {cfg.halo!r} has no sweep here")
    us, bs = [u] + [None] * (Ls - 1), [b] + [None] * (Ls - 1)

    def smooth_only(l, u_, b_, sweeps):
        w33, B, side = cfg.w33s[l], cfg.blocks[l], cfg.sides[l]
        if ghost is not None:
            u_ext, _, G = ghost(w33, u_, b_, side, sweeps, cfg.omega,
                                cfg.symmetric)
            return u_ext[:, G:G + B]
        for _ in range(sweeps):
            u_ = _gs4_sweep_local_const(w33, u_, b_, side, cfg.omega,
                                        cfg.symmetric)
        return u_

    b_repl = None
    for l in range(Ls):
        w33, B, side = cfg.w33s[l], cfg.blocks[l], cfg.sides[l]
        nc = cfg.sides[l + 1]
        Bc = cfg.blocks[l + 1] if l < Ls - 1 else B // 2
        if ghost is not None:
            # one exchange covers pre-smooth, residual and restriction:
            # ghost rows at distance <= 2 are still exact after the sweep
            u_ext, b_ext, G = ghost(w33, us[l], bs[l], side, cfg.pre_sweeps,
                                    cfg.omega, cfg.symmetric)
            us[l] = u_ext[:, G:G + B]
            # residual on slab rows 0..B, from window rows G-1..G+B+1
            r01 = (b_ext[:, G:G + B + 1]
                   - _conv9_const(w33, u_ext[:, G - 1:G + B + 2])[:, 1:B + 2])
            r01 = torch.where(_global_rows(D, B, B + 1, u.device) < side,
                              r01, 0.0)
            coarse = _restrict_from_ext(r01, Bc, nc, nc)
        else:
            for _ in range(cfg.pre_sweeps):
                us[l] = _gs4_sweep_local_const(w33, us[l], bs[l], side,
                                               cfg.omega, cfg.symmetric)
            coarse = _restrict_local(bs[l] - _matvec_const(w33, us[l], side),
                                     Bc, nc, nc)
        if l < Ls - 1:
            bs[l + 1], us[l + 1] = coarse, torch.zeros_like(coarse)
        else:
            b_repl = coarse.reshape(D * Bc, nc)[:nc]     # all_gather
    # the agglomerated levels, computed once for every slab
    u_repl = cycle_stencil(sub_hier, torch.zeros_like(b_repl), b_repl,
                           cfg.pre_sweeps, cfg.post_sweeps, cfg.omega,
                           cfg.symmetric)
    for l in range(Ls - 1, -1, -1):
        B, n = cfg.blocks[l], cfg.sides[l]
        if l == Ls - 1:
            us[l] = us[l] + _prolong_from_replicated(u_repl, B, n, B // 2, D)
        else:
            us[l] = us[l] + _prolong_local(us[l + 1], B, n)
        us[l] = smooth_only(l, us[l], bs[l], cfg.post_sweeps)
    return us[0]


# ---------------------------------------------------------------------------
# The solver.


class DistStructuredSolver:
    """Row-partitioned structured Poisson solver over a mesh of D slabs on
    one device (JAX ``DistStructuredSolver``, constant-coefficient levels).

    ``n_devices`` is the number of slabs (None: the visible CUDA devices);
    ``halo`` None is ``"overlap"`` on the card and ``"step"`` on the CPU,
    as JAX picks by backend; ``device`` None is ``"cuda"`` (raises without
    one). ``solve`` is the reference's V-cycle loop; ``solve_ir``,
    ``solve_ir_device`` and ``solve_ir_fused`` the df32 defect correction
    (``cycles_per_refine`` V-cycles in ``dtype`` per refine), a host loop
    with one host sync per refine where JAX runs one device program.
    """

    def __init__(self, side: int, n_levels: int | None = None,
                 n_devices: int | None = None, dtype=torch.float32,
                 pre_sweeps: int = 1, post_sweeps: int = 1,
                 omega: float = 1.0, symmetric: bool = True, A_fine=None,
                 halo: str | None = None, force_var: bool = False,
                 cycles_per_refine: int | None = None, config=None,
                 device=None):
        if config is not None:
            raise _not_yet("config=MeshConfig", "Queue 1 item 12, config.py")
        self.device = resolve_device(device)
        if halo is None:
            halo = "overlap" if self.device.type == "cuda" else "step"
        if halo not in HALO_MODES:
            raise ValueError(f"unknown halo mode {halo!r}")
        if halo == "packed":
            raise _not_yet("halo='packed' (pack_rect, packed_steps_window)",
                           "Queue 1 item 13, structured_dist")
        if self.device.type == "cuda":
            # the sub-hierarchy's transfer matmuls in full f32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        cfg, self.sub_hier = build_dist_hierarchy(
            side, n_levels, n_devices, dtype, A_fine, force_var=force_var,
            device=self.device)
        self.cfg = dataclasses.replace(
            cfg, pre_sweeps=pre_sweeps, post_sweeps=post_sweeps,
            omega=omega, symmetric=symmetric, halo=halo)
        self.dtype = dtype
        self.side = side
        self.cycles_per_refine = (2 if cycles_per_refine is None
                                  else cycles_per_refine)
        self.n_pad = self.cfg.n_devices * self.cfg.blocks[0]

    def _tensor(self, f) -> torch.Tensor:
        """A tensor on the solver's device; numpy input is copied."""
        if not isinstance(f, torch.Tensor):
            f = torch.from_numpy(np.array(f))
        return f.to(self.device)

    def _pad(self, f2, dtype) -> torch.Tensor:
        out = torch.zeros((self.n_pad, self.side), dtype=dtype,
                          device=self.device)
        out[:self.side] = self._tensor(f2).to(dtype)
        return out.reshape(self.cfg.n_devices, self.cfg.blocks[0], self.side)

    def pad_field(self, f2) -> torch.Tensor:
        """(side, side) -> (D, B_0, side) slabs in ``dtype``, zero padding
        rows."""
        return self._pad(f2, self.dtype)

    def unpad(self, f) -> torch.Tensor:
        """(D, B_0, side) slabs -> the (side, side) field (a view)."""
        return f.reshape(self.n_pad, self.side)[:self.side]

    def vcycle(self, u_pad, b_pad):
        return vcycle_dist(self.cfg, self.sub_hier, u_pad, b_pad)

    def rss(self, u_pad, b_pad) -> float:
        r = b_pad - _matvec_const(self.cfg.w33s[0], u_pad, self.side)
        return float((r * r).sum(dim=(1, 2)).sum())      # psum

    def solve(self, b2, tolerance=1e-7, compute_error_every_n_iters=5,
              n_iters=100) -> SolveResult:
        """The reference's outer loop (multigrid.hpp:311-337): V-cycles in
        ``dtype``, the rss every ``compute_error_every_n_iters``."""
        b_pad = self.pad_field(b2)
        u = torch.zeros_like(b_pad)
        every = compute_error_every_n_iters
        it, error = 0, 100.0
        history = []
        while it < n_iters and error > tolerance:
            k = (min(every - (it % every), n_iters - it) if every
                 else n_iters - it)
            for _ in range(k):
                u = self.vcycle(u, b_pad)
            it += k
            if every and it % every == 0:
                error = self.rss(u, b_pad)
                history.append((it, error))
        return SolveResult(u=self.unpad(u), iterations=it, error=error,
                           converged=error <= tolerance, history=history)

    def solve_pcg(self, b2, tolerance: float = 1e-5, n_iters: int = 100):
        raise _not_yet("DistStructuredSolver.solve_pcg", "Queue 1 item 9, "
                       "Krylov, then item 13")

    # -- the df32 defect correction -----------------------------------------

    def _split_b(self, b2) -> DF32:
        """The rhs as padded df32 slabs: an f64 rhs splits exactly into
        hi + lo, an f32 one has lo = 0."""
        b = self._tensor(b2)
        hi = b.to(torch.float32)
        lo = ((b - hi.to(torch.float64)).to(torch.float32)
              if b.dtype == torch.float64 else torch.zeros_like(hi))
        return DF32(hi=self._pad(hi, torch.float32),
                    lo=self._pad(lo, torch.float32))

    def _residual(self, b_df: DF32, u_df: DF32) -> DF32:
        return _df_residual_const(self.cfg.w33s[0], b_df, u_df, self.side)

    def _cycles(self, r_hi):
        """cycles_per_refine V-cycles on A e = r from e = 0, in ``dtype``;
        the f32 correction."""
        r = r_hi.to(self.dtype)
        e = torch.zeros_like(r)
        for _ in range(self.cycles_per_refine):
            e = self.vcycle(e, r)
        return e.to(torch.float32)

    def solve_ir_device(self, b2, tolerance=1e-9, n_refine: int = 40):
        """The defect-correction loop of JAX's one-program solve: from
        u = 0, each pass computes the df32 residual and its rss (the one
        host sync) and refines while the rss is above the tolerance, so
        the carried rss lags one correction; the final rss is recomputed.
        Returns ``(u_hi, u_lo, stats)``: padded f32 slabs and the f64
        tensor ``[final_rss, refines]``."""
        b_df = self._split_b(b2)
        u = DF32.from_f32(torch.zeros_like(b_df.hi))
        err, it = float("inf"), 0
        while err > tolerance and it < n_refine:
            r = self._residual(b_df, u)
            err = float(df_rss(r))
            u = df_add_f32(u, self._cycles(r.hi))
            it += 1
        final = df_rss(self._residual(b_df, u))
        stats = torch.stack([final, torch.tensor(float(it),
                                                 dtype=torch.float64,
                                                 device=final.device)])
        return u.hi, u.lo, stats

    def _result_u(self, uh, ul) -> torch.Tensor:
        return (self.unpad(uh).to(torch.float64)
                + self.unpad(ul).to(torch.float64))

    def solve_ir_fused(self, b2, tolerance=1e-9,
                       n_refine: int = 40) -> SolveResult:
        """solve_ir_device and one read of its stats; ``iterations``
        counts V-cycles, u is the f64 (side, side) field."""
        uh, ul, stats = self.solve_ir_device(b2, tolerance, n_refine)
        error, it = stats.tolist()
        iters = int(it) * self.cycles_per_refine
        return SolveResult(u=self._result_u(uh, ul), iterations=iters,
                           error=error, converged=error <= tolerance,
                           history=[(iters, error)])

    def solve_ir(self, b2, tolerance=1e-9, n_refine: int = 40
                 ) -> SolveResult:
        """The host-stepped defect correction: each refine's rss is checked
        before its V-cycles run, so it stops as soon as the rss is at the
        tolerance."""
        b_df = self._split_b(b2)
        u = DF32.from_f32(torch.zeros_like(b_df.hi))
        history, it, error = [], 0, float("inf")
        for _ in range(n_refine):
            r = self._residual(b_df, u)
            error = float(df_rss(r))
            history.append((it, error))
            if error <= tolerance:
                break
            u = df_add_f32(u, self._cycles(r.hi))
            it += self.cycles_per_refine
        return SolveResult(u=self._result_u(u.hi, u.lo), iterations=it,
                           error=error, converged=error <= tolerance,
                           history=history)
