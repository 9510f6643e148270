"""Distributed structured multigrid: row-partitioned V-cycles with ghost-
strip exchanges and coarse-level agglomeration.

PyTorch port of ``amg_tpu/parallel/structured_dist.py``: constant- and
variable-coefficient sharded levels. The 2-D grid is cut into D contiguous
row slabs, the mesh. The JAX package runs one program per device under
``shard_map``; here the mesh is a leading slab axis: the padded (n_pad, n)
field is viewed as (D, B, n) and every per-slab function runs on all D
slabs in one set of batched tensor ops, so a level costs the same launches
for any D. The collectives become tensor ops on that axis:

* ``lax.axis_index`` is a (D, 1, 1) row offset, ``slab * B``;
* ``lax.ppermute`` by h is a shift by h along the slab axis, zero-filled;
* ``all_gather(tiled=True)`` is a reshape, ``psum`` a sum.

In one block all its slabs live on one device: on the card a mesh of
slabs, whose ``halo="rdma"`` exchange is the CUDA kernel K7
(ops/kernels/halo.py), a put that addresses every slab from one base
pointer and the slab stride. The D slabs are cut into blocks of D/P
consecutive slabs (parallel/launch.py) in two ways: one process driving
several cards, a thread a block (a card group; the default wherever a
process sees more than one card, JAX's one program over the local
devices), or a process a block under a process group. The exchanges,
sums and gathers go through launch.py's collectives; ``halo="rdma"``
there is K7's peer form, which also puts the strips at the ends of the
block straight into the receive memory of its neighbour blocks (on the
same card or another) and waits on flags there, in one launch. Its
memory is made when the solver is built, by every block together, and
released by ``close()``.

Layout invariants (``build_dist_hierarchy``), as in the JAX package:

* sharded level l has ``n_pad_l = D * B_l`` rows, ``B_l`` even, so a slab's
  local row parity is the global one and the four colors align;
* ``B_{l+1} = B_l / 2``: a coarse slab depends on its own fine slab plus
  one halo row (restriction) and one coarse halo row (prolongation);
* padding rows (global row >= side) keep u = 0 and a zero residual; on a
  variable level their planes are an identity row.

Halo modes (``halo=``): ``"sweep"`` one G-row ghost-strip exchange of
(u, b) per smoothing call, the color steps run on the extended slab
(temporal blocking) and G = steps + 2 rows also cover the residual and
restriction that follow; ``"overlap"`` the same with the slab interior
swept apart from two boundary bands (bitwise equal; JAX's accelerator
default); ``"rdma"`` the same with K7 as the exchange where it is single-
hop; ``"packed"`` the same exchange with the color steps run color-packed
(sparse/packed.py pack_rect; the iterates of ``"sweep"`` up to the order
of the floating-point sums); ``"step"`` a one-row halo before every color
step (JAX's CPU default). Variable levels take one strip exchange of
(u, b) per smoothing call under every mode but ``"step"``, on planes
whose strips were exchanged once, when the solver was built.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from amg_tpu_torch.krylov import _step
from amg_tpu_torch.models import poisson
from amg_tpu_torch.ops.doublefloat import (DF32, df_add, df_add_f32,
                                           df_apply_const, df_neg, df_rss)
from amg_tpu_torch.ops.kernels import graph_loop
from amg_tpu_torch.ops.kernels.halo import (rdma_halo_exchange,
                                            rdma_halo_exchange_peer)
from amg_tpu_torch.ops.transfer import linear_interp_1d
from amg_tpu_torch.parallel import launch
from amg_tpu_torch.sparse.packed import (pack_rect, packed_steps_window,
                                         unpack_rect)
from amg_tpu_torch.sparse.stencil import (FOUR_COLORS, W2D, Stencil2D,
                                          color_masks)
from amg_tpu_torch.structured import (SolveResult, StencilHierarchy,
                                      galerkin_chain,
                                      max_levels_for_side, vcycle_stencil)
from amg_tpu_torch.utils.debugging import check_rss
from amg_tpu_torch.utils.device import resolve_device

HALO_MODES = ("overlap", "sweep", "step", "rdma", "packed")


# ---------------------------------------------------------------------------
# Slab-axis helpers: every field is (D, R, n), D the slabs this block
# holds; slab d's row r is global row (first slab + d) * B + r (+ a window
# offset).


def _row0(D: int, B: int, device) -> torch.Tensor:
    """Each slab's first global row, (D, 1, 1): ``lax.axis_index * B``."""
    return ((torch.arange(D, device=device) + launch.first_slab(D)) * B
            ).reshape(D, 1, 1)


def _global_rows(D: int, B: int, R: int, device):
    """(D, R, 1) global row of each slab's first R rows."""
    return torch.arange(R, device=device).reshape(1, R, 1) + _row0(D, B,
                                                                   device)


def _halo(u):
    """(top, bot): each slab's neighbour rows above and below, (D, 1, n),
    zeros at the line's ends (JAX ``_halo``)."""
    D, B, n = u.shape
    above, below = (e[None] for e in
                    launch.edges(u.reshape(D * B, n), 1, dim=0))
    return (torch.cat([above, u[:-1, -1:]], dim=0),
            torch.cat([u[1:, :1], below], dim=0))


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
    the line's ends: (..., D, B + 2G, n) from (..., D, B, n), a view of
    the padded field. Reaches as many neighbour slabs as G needs."""
    D, B, n = x.shape[-3:]
    full = launch.frame(x.reshape(*x.shape[:-3], D * B, n), G)
    return full.unfold(-2, B + 2 * G, B).transpose(-1, -2)


def _exchange_strips(u, b, G: int):
    """One ghost-strip exchange of u and b (JAX ``_exchange_strips``):
    single-hop (G <= B) as ``launch.strips``, across the blocks when
    there are several; multi-hop (G > B, tiny slabs) as windows of the
    padded field, u and b in one exchange."""
    if G > u.shape[1]:
        ub = _windows(torch.stack([u, b]), G)
        return ub[0], ub[1]
    return _extend(launch.strips(torch.cat([u, b], dim=2), G), u, b, G)


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
                          symmetric: bool, recv: dict):
    """The ghost sweep with K7 as the exchange: u and b ride one launch,
    into the receive buffer kept in ``recv`` by exchange shape (D, G, n)
    (rdma_buffers; on one stream, ``_extend`` has copied the strips out
    before the next exchange of the shape writes them). In one block K7
    puts between the slabs of the tensor; over several blocks on the card
    its peer form also puts into the neighbour blocks' memory (processes,
    or the cards of a card group); over several blocks on the CPU, and in
    a card group's graph warm-ups (``launch.warming``), the strips are its
    plain version, ``launch.strips``. JAX's rule: with one
    slab in all, or strips that span more than one neighbour slab
    (G > B), the level takes the ghost sweep."""
    D, B, n = u.shape
    G = ghost_rows(sweeps, symmetric)
    if D * launch.process_count() == 1 or G > B:
        return _gs4_sweep_ghost_const(w33, u, b, side, sweeps, omega,
                                      symmetric)
    u, b = u.contiguous(), b.contiguous()
    if launch.process_count() == 1:
        strips = rdma_halo_exchange((u, b), G, out=recv[(D, G, n)])
    elif u.is_cuda and not launch.warming():
        strips = rdma_halo_exchange_peer((u, b), G, recv.get((D, G, n)))
    else:
        strips = launch.strips(torch.cat([u, b], dim=2), G)
    u_ext, b_ext = _extend(strips, u, b, G)
    u_ext = _masked_steps_const(w33, u_ext, b_ext,
                                _row0(D, B, u.device) - G, side, sweeps,
                                omega, symmetric)
    return u_ext, b_ext, G


def rdma_buffers(cfg, dtype, device) -> dict:
    """K7's receive buffers of a solver under ``halo="rdma"``, by exchange
    shape (D/P, G, n): one for each constant sharded level whose slabs
    hold the G strip rows of its pre- or post-smoothing, with more than
    one slab in all. In one block a (D, 2G, 2n) tensor each; over several
    blocks on the card K7's peer memory (collective: every block makes it
    together; launch.peer_buffers takes CUDA IPC across processes and
    peer access between the cards of a card group); over several blocks
    on the CPU none (the plain exchange needs none)."""
    if cfg.halo != "rdma" or cfg.n_devices == 1:
        return {}
    Dl = cfg.n_devices // launch.process_count()
    shapes = []
    for w33, B, n in zip(cfg.w33s, cfg.blocks, cfg.sides):
        for sweeps in (cfg.pre_sweeps, cfg.post_sweeps):
            G = ghost_rows(sweeps, cfg.symmetric)
            if w33 is not None and G <= B and (Dl, G, n) not in shapes:
                shapes.append((Dl, G, n))
    if launch.process_count() == 1:
        return {(D, G, n): torch.empty((D, 2 * G, 2 * n), dtype=dtype,
                                       device=device)
                for D, G, n in shapes}
    if torch.device(device).type != "cuda" or not shapes:
        return {}
    peer = launch.open_peer_strips([(D, G, 2 * n) for D, G, n in shapes],
                                   dtype)
    return {(D, G, W // 2): s for (D, G, W), s in peer.items()}


def _gs4_sweep_packed_const(w33, u, b, side: int, sweeps: int,
                            omega: float, symmetric: bool):
    """The ghost sweep with its color steps run color-packed: after the
    one strip exchange the extended slabs are packed into parity quarters
    (pack_rect), the steps evaluate the stencil only at the points they
    update, and the slabs are unpacked for the residual and restriction
    that follow. The ghost sweep's contract, its iterates up to the order
    of the floating-point sums."""
    D, B, n = u.shape
    G = ghost_rows(sweeps, symmetric)
    u_ext, b_ext = _exchange_strips(u, b, G)
    m = (n - 1) // 2
    u4 = packed_steps_window(w33, pack_rect(u_ext, m), pack_rect(b_ext, m),
                             _row0(D, B, u.device) - G,  # even: B, G even
                             side, sweeps, omega, symmetric)
    return unpack_rect(u4, m), b_ext, G


GHOST_SWEEPS = {"sweep": _gs4_sweep_ghost_const,
                "overlap": _gs4_sweep_overlap_const,
                "rdma": _gs4_sweep_rdma_const,
                "packed": _gs4_sweep_packed_const}


# ---------------------------------------------------------------------------
# Variable-coefficient levels: (3, 3, D, B, n) planes, an identity row on
# every padding row. Under a ghost mode the plane strips are exchanged once
# (the planes do not change during a solve; JAX exchanges them in every
# V-cycle and XLA hoists that out of its solve loops), and each smoothing
# call pays one (u, b) strip exchange, as on a constant level.


def var_ghost_rows(cfg) -> int:
    """The one G of every variable level: it serves the pre-smooth, the
    residual and the post-smooth (a deeper strip is always valid)."""
    return max(ghost_rows(cfg.pre_sweeps, cfg.symmetric),
               ghost_rows(cfg.post_sweeps, cfg.symmetric))


def _exchange_planes(c, G: int):
    """(3, 3, D, B, n) planes -> (3, 3, D, B + 2G, n) with the neighbour
    slabs' ghost strips, zeros beyond the line's ends (the Dirichlet
    boundary); multi-hop when G > B."""
    return _windows(c, G) if G else c


def extend_planes(cfg, planes) -> tuple:
    """Each variable level's planes with their ghost strips (None on a
    constant level), contiguous: what a solver keeps for its V-cycles."""
    G = var_ghost_rows(cfg)
    return tuple(None if c is None else _exchange_planes(c, G).contiguous()
                 for c in planes)


def _conv9_window(c_ext, x):
    """9-point A x on (D, R, n) windows with their (3, 3, D, R, n) planes;
    zero padding supplies the window and boundary truncation."""
    R, n = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1))
    out = torch.zeros_like(x)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            out = out + c_ext[dj + 1, di + 1] * xp[
                ..., 1 + dj:1 + dj + R, 1 + di:1 + di + n]
    return out


def _masked_steps_var(c_ext, x, bx, sweeps: int, omega: float,
                      symmetric: bool):
    """Masked color steps on windows with variable coefficients. Rows with
    a zero diagonal (window padding beyond the line's ends) never update
    (the reference's zero-diagonal guard, smoother.hpp:136); padding rows
    have an identity row and b = 0, so they stay 0. Local parity is the
    global one because B and G are even."""
    R, n = x.shape[-2:]
    row_par = torch.arange(R, device=x.device).reshape(R, 1) % 2
    col_par = torch.arange(n, device=x.device).reshape(1, n) % 2
    diag = c_ext[1, 1]
    nz = diag != 0
    inv = torch.where(nz, 1.0 / torch.where(nz, diag, 1.0), 0.0)
    order = list(FOUR_COLORS)
    if symmetric:
        order = order + order[::-1]
    for _ in range(sweeps):
        for pj, pi in order:
            r = bx - _conv9_window(c_ext, x)
            mask = (row_par == pj) & (col_par == pi)
            x = x + torch.where(mask, (omega * r) * inv, 0.0)
    return x


def _gs4_sweep_ghost_var(c_ext, u, b, sweeps: int, omega: float,
                         symmetric: bool, G: int):
    """``sweeps`` GS sweeps on a variable level with ONE (u, b) strip
    exchange, the ghost sweep's contract: rows [G-2, G+B+2) of u_ext are
    exact when G >= steps + 2. Returns (u_ext, b_ext)."""
    u_ext, b_ext = _exchange_strips(u, b, G)
    return (_masked_steps_var(c_ext, u_ext, b_ext, sweeps, omega,
                              symmetric), b_ext)


# ---------------------------------------------------------------------------
# halo="step": a one-row halo before every color step.


def _matvec_var(c, u):
    """A u on the slabs of a variable level, (3, 3, D, B, n) planes, with a
    1-row halo (JAX ``_matvec_local``); padding rows are identity rows."""
    D, B, n = u.shape
    top, bot = _halo(u)
    up = F.pad(torch.cat([top, u, bot], dim=1), (1, 1))
    out = torch.zeros_like(u)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            out = out + c[dj + 1, di + 1] * up[
                :, 1 + dj:1 + dj + B, 1 + di:1 + di + n]
    return out


def _gs4_sweep_local_var(c, u, b, omega: float, symmetric: bool):
    """One GS sweep on a variable level with a halo exchange before each
    color step (JAX ``_gs4_sweep_local``)."""
    D, B, n = u.shape
    row_par = torch.arange(B, device=u.device).reshape(1, B, 1) % 2
    col_par = torch.arange(n, device=u.device).reshape(1, 1, n) % 2
    inv_diag = 1.0 / c[1, 1]
    order = list(FOUR_COLORS)
    if symmetric:
        order = order + order[::-1]
    for pj, pi in order:
        r = b - _matvec_var(c, u)
        mask = ((row_par == pj) & (col_par == pi)).to(u.dtype)
        u = u + (omega * mask) * (r * inv_diag)
    return u


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
    """Prolongate the replicated coarse field onto this block's slabs of
    D: each slab's coarse rows plus the row above, gathered as windows of
    the padded field (JAX's per-device ``dynamic_slice``)."""
    ucp = F.pad(uc_full, (0, 0, 1, D * Bc - uc_full.shape[0]))
    block = ucp.unfold(0, Bc + 1, Bc).transpose(1, 2)   # (D, Bc + 1, nc)
    block = launch.device_mesh_1d(D).local(block)
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


def build_dist_hierarchy(side: int, n_levels: int | None = None,
                         n_devices: int | None = None, dtype=torch.float32,
                         A_fine=None, force_var: bool = False, device=None):
    """Host setup: the plan, the scipy RAP chain, each sharded level's
    constant weights (``Stencil2D.from_scipy`` in ``dtype``) or, on a
    variable level (a non-constant ``A_fine``, or every sharded level with
    ``force_var``), its (3, 3, D, B, n) planes on ``device`` with an
    identity row on every padding row; and the replicated coarse
    sub-hierarchy (levels n_sharded..) as a masked-smoother
    ``StencilHierarchy`` with the dense LU of the coarsest level, with its
    planes and masks where a level is variable. ``device`` None means
    ``"cuda"``. Returns ``(cfg, planes, sub_hier)``, ``planes`` one entry a
    sharded level, None on a constant one (JAX's placeholder)."""
    device = resolve_device(device)
    if n_devices is None:
        n_devices = launch.visible_cards()
    if n_levels is None:
        n_levels = max_levels_for_side(side)
    sides, blocks, Ls = plan_distribution(side, n_levels, n_devices)
    if Ls == 0:
        raise ValueError(f"side {side} with {n_levels} levels leaves no "
                         f"level to shard over {n_devices} slabs")
    if A_fine is None:
        A_fine = poisson.laplacian_scipy(side)
    mats = galerkin_chain(A_fine, sides, native=False)  # as JAX: scipy
    stencils = [Stencil2D.from_scipy(A, s, dtype=dtype)
                for A, s in zip(mats, sides)]
    w33s, planes = [], []
    for l in range(Ls):
        S, n = stencils[l], sides[l]
        w33s.append(None if force_var else S.w33)
        if w33s[-1] is not None:
            planes.append(None)
            continue
        cp = torch.zeros((3, 3, n_devices * blocks[l], n), dtype=dtype)
        cp[:, :, :n] = S.c
        cp[1, 1, n:] = 1.0                      # identity rows on padding
        planes.append(cp.reshape(3, 3, n_devices, blocks[l], n).to(device))
    lu, piv = torch.linalg.lu_factor(
        torch.as_tensor(mats[-1].toarray(), dtype=dtype))
    subs = stencils[Ls:]
    sub_sides = sides[Ls:]
    P1s = [torch.as_tensor(linear_interp_1d(sub_sides[i], sub_sides[i + 1]
                                            ).toarray(),
                           dtype=dtype, device=device)
           for i in range(len(sub_sides) - 1)]
    var_kw = {}
    if any(S.w33 is None for S in subs):
        var_kw = dict(planes=[S.c.to(device) for S in subs],
                      masks=[color_masks(s, dtype, device)
                             for s in sub_sides])
    sub_hier = StencilHierarchy(sub_sides, [S.w33 for S in subs],
                                lu.to(device), piv.to(device), P1s,
                                smoother="masked", **var_kw)
    cfg = DistConfig(n_devices=n_devices, sides=sides, blocks=blocks,
                     n_sharded=Ls, w33s=tuple(w33s))
    return cfg, tuple(planes), sub_hier


# ---------------------------------------------------------------------------
# The V-cycle.


def vcycle_dist(cfg: DistConfig, sub_hier: StencilHierarchy, u, b,
                recv: dict | None = None, planes=None, planes_ext=None):
    """One V-cycle on (D, B_0, n_0) slabs (JAX ``_vcycle_local`` on every
    slab at once): the sharded down-leg, one V-cycle of the replicated
    sub-hierarchy from zero, the sharded up-leg. ``recv``: the caller's
    dict of ``halo="rdma"`` receive buffers (rdma_buffers), kept across
    calls (None: rdma_buffers' for this V-cycle, in one block; over
    several blocks on the card K7 needs the solver's). ``planes``: each
    sharded level's planes (None on a constant level;
    build_dist_hierarchy), for the slabs in ``u``; ``planes_ext``: the
    same with their ghost strips (extend_planes; None: exchanged here, as
    JAX does in every V-cycle)."""
    D, Ls = u.shape[0], cfg.n_sharded
    ghost = GHOST_SWEEPS.get(cfg.halo)
    if ghost is None and cfg.halo != "step":
        raise ValueError(f"halo mode {cfg.halo!r} has no sweep here")
    if cfg.halo == "rdma":
        if recv is None:
            recv = (rdma_buffers(cfg, u.dtype, u.device)
                    if launch.process_count() == 1 else {})
        ghost = functools.partial(ghost, recv=recv)
    var = [w is None for w in cfg.w33s]
    if any(var) and planes is None:
        raise ValueError("a variable-coefficient level needs its planes")
    Gv = None
    if ghost is not None and any(var):
        Gv = var_ghost_rows(cfg)
        if planes_ext is None:
            planes_ext = extend_planes(cfg, planes)
    us, bs = [u] + [None] * (Ls - 1), [b] + [None] * (Ls - 1)

    def smooth_only(l, u_, b_, sweeps):
        w33, B, side = cfg.w33s[l], cfg.blocks[l], cfg.sides[l]
        if var[l] and Gv is not None:
            u_ext, _ = _gs4_sweep_ghost_var(planes_ext[l], u_, b_, sweeps,
                                            cfg.omega, cfg.symmetric, Gv)
            return u_ext[:, Gv:Gv + B]
        if var[l]:
            for _ in range(sweeps):
                u_ = _gs4_sweep_local_var(planes[l], u_, b_, cfg.omega,
                                          cfg.symmetric)
            return u_
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
            # ghost rows at distance <= 2 are still exact after the sweep;
            # the residual on slab rows 0..B, from window rows G-1..G+B+1
            if var[l]:
                G, c_ext = Gv, planes_ext[l]
                u_ext, b_ext = _gs4_sweep_ghost_var(
                    c_ext, us[l], bs[l], cfg.pre_sweeps, cfg.omega,
                    cfg.symmetric, G)
                au = _conv9_window(c_ext[:, :, :, G - 1:G + B + 2],
                                   u_ext[:, G - 1:G + B + 2])
            else:
                u_ext, b_ext, G = ghost(w33, us[l], bs[l], side,
                                        cfg.pre_sweeps, cfg.omega,
                                        cfg.symmetric)
                au = _conv9_const(w33, u_ext[:, G - 1:G + B + 2])
            us[l] = u_ext[:, G:G + B]
            r01 = b_ext[:, G:G + B + 1] - au[:, 1:B + 2]
            r01 = torch.where(_global_rows(D, B, B + 1, u.device) < side,
                              r01, 0.0)
            coarse = _restrict_from_ext(r01, Bc, nc, nc)
        elif var[l]:
            for _ in range(cfg.pre_sweeps):
                us[l] = _gs4_sweep_local_var(planes[l], us[l], bs[l],
                                             cfg.omega, cfg.symmetric)
            coarse = _restrict_local(bs[l] - _matvec_var(planes[l], us[l]),
                                     Bc, nc, nc)
        else:
            for _ in range(cfg.pre_sweeps):
                us[l] = _gs4_sweep_local_const(w33, us[l], bs[l], side,
                                               cfg.omega, cfg.symmetric)
            coarse = _restrict_local(bs[l] - _matvec_const(w33, us[l], side),
                                     Bc, nc, nc)
        if l < Ls - 1:
            bs[l + 1], us[l + 1] = coarse, torch.zeros_like(coarse)
        else:                                            # all_gather
            b_repl = launch.all_gather_slabs(coarse).reshape(-1, nc)[:nc]
    # the agglomerated levels, computed once for every slab
    u_repl = vcycle_stencil(sub_hier, torch.zeros_like(b_repl), b_repl,
                            cfg.pre_sweeps, cfg.post_sweeps, cfg.omega,
                            cfg.symmetric)
    for l in range(Ls - 1, -1, -1):
        B, n = cfg.blocks[l], cfg.sides[l]
        if l == Ls - 1:
            us[l] = us[l] + _prolong_from_replicated(u_repl, B, n, B // 2,
                                                     cfg.n_devices)
        else:
            us[l] = us[l] + _prolong_local(us[l + 1], B, n)
        us[l] = smooth_only(l, us[l], bs[l], cfg.post_sweeps)
    return us[0]


# ---------------------------------------------------------------------------
# The solver.


class DistStructuredSolver(launch.ProgramSolver):
    """Row-partitioned structured Poisson solver over a mesh of D slabs
    (JAX ``DistStructuredSolver``).

    ``n_devices`` is the number of slabs and ``device`` where they go
    (``launch.slab_devices``): ``device`` None in a process outside a
    process group spreads them over the visible cards as JAX's mesh over
    ``jax.devices()[:D]`` does, K' cards (the largest divisor of D not
    above the card count), D/K' consecutive slabs each, one slab a card
    when ``n_devices`` is None too; with one card every slab is on it. One
    device (``"cuda"``, ``"cuda:1"``, ``"cpu"``) keeps every slab there; a
    sequence of K devices (``("cpu",) * K`` too) gives a block of D/K slabs
    to each. Over several devices the solver is a card group
    (``launch.CardGroup``): the setup is built once, on the host, each
    block's thread takes its slabs and a copy of the replicated
    sub-hierarchy, and ``solve``, ``solve_pcg``, ``solve_ir`` and
    ``solve_ir_fused`` run on every block and return block 0's result
    (its u on block 0's device); the slab-level methods (``pad_field``,
    ``unpad``, ``vcycle``, ``rss``, ``solve_ir_device``) run on a block,
    inside ``run(fn)``. Under a process group (parallel/launch.py) each
    process holds D/P slabs on its card and ``unpad`` gathers the field.
    With ``halo="rdma"`` on the card over several blocks the solver holds
    memory its neighbour blocks write, built with it and released by
    ``close()``, which every process calls; a card group's threads end
    there too. ``halo`` None is ``"overlap"`` on the card and ``"step"``
    on the CPU, as JAX picks by backend. ``A_fine`` (a scipy matrix) or
    ``force_var`` gives variable-coefficient sharded levels. ``solve`` is
    the reference's V-cycle loop and ``solve_pcg`` the AMG-preconditioned
    CG; on a constant fine level ``solve_ir``, ``solve_ir_device`` and
    ``solve_ir_fused`` are the df32 defect correction
    (``cycles_per_refine`` V-cycles in ``dtype`` per refine), ``solve_ir``
    with one host read per refine. ``config`` (a config.MeshConfig) gives
    ``n_devices``, ``halo`` and ``cycles_per_refine`` where the argument
    is None.

    JAX compiles five programs (``_vcycle``, ``_rss``, ``_pcg_device``,
    ``_refine``, ``_solve_device``); the port restates each in cond/body
    form on fixed buffers a block (``_state``) and runs it under one of
    two drivers, named by ``driver``:

    * ``"graph"`` (the default on the card: one block, a card group, a
      process group, or the mesh of both): each program one CUDA graph a
      block (``ops/kernels/graph_loop.py``), captured at its first use by
      the block's thread, one graph launch a call with no host read and
      no host collective inside; ``solve_pcg`` and ``solve_ir_device`` /
      ``solve_ir_fused`` a WHILE node, ``vcycle``, ``rss`` and
      ``solve_ir``'s refine straight graphs (``solve`` and ``solve_ir``
      read the rss between them, as JAX's host loops do). Over several
      blocks the collectives inside are the peer collective kernel
      (``launch.device_collectives``), K7's peer form the halo;
    * ``"host"``: the same pieces, stepped from the host (the CPU's, and
      the oracle on the card), the collectives the host ones.

    ``driver`` chooses it (None: the default); ``set_driver`` changes it.
    Under a process group a program call is collective: every process
    makes the same calls in the same order (``launch.ProgramSolver``).
    """

    def __init__(self, side: int, n_levels: int | None = None,
                 n_devices: int | None = None, dtype=torch.float32,
                 pre_sweeps: int = 1, post_sweeps: int = 1,
                 omega: float = 1.0, symmetric: bool = True, A_fine=None,
                 halo: str | None = None, force_var: bool = False,
                 cycles_per_refine: int | None = None, config=None,
                 device=None, driver: str | None = None):
        # a config.MeshConfig gives n_devices, halo and cycles_per_refine
        # where the argument is None (JAX's rule,
        # amg_tpu/parallel/structured_dist.py:849-866)
        if config is not None:
            if n_devices is None:
                n_devices = config.n_devices
            if halo is None:
                halo = getattr(config, "halo", None)
            if cycles_per_refine is None:
                cycles_per_refine = getattr(config, "cycles_per_refine", None)
        n_devices, self.devices = launch.slab_devices(n_devices, device)
        self.device = self.devices[0]
        self.driver = self._driver_for(driver)
        if halo is None:
            halo = "overlap" if self.device.type == "cuda" else "step"
        if halo not in HALO_MODES:
            raise ValueError(f"unknown halo mode {halo!r}")
        if self.device.type == "cuda":
            # the sub-hierarchy's transfer matmuls in full f32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        spread = len(self.devices) > 1
        # over several devices the setup is built once, on the host
        cfg, planes, sub_hier = build_dist_hierarchy(
            side, n_levels, n_devices, dtype, A_fine, force_var=force_var,
            device="cpu" if spread else self.device)
        self.cfg = dataclasses.replace(
            cfg, pre_sweeps=pre_sweeps, post_sweeps=post_sweeps,
            omega=omega, symmetric=symmetric, halo=halo)
        self.dtype = dtype
        self.side = side
        self.cycles_per_refine = (2 if cycles_per_refine is None
                                  else cycles_per_refine)
        self.n_pad = self.cfg.n_devices * self.cfg.blocks[0]
        if not spread:
            self._place(self.device, planes, sub_hier)
            return
        self._spread(lambda block, dev: block._place(
            dev, planes, copy.deepcopy(sub_hier).to(dev)))

    def _place(self, device, planes, sub_hier) -> "DistStructuredSolver":
        """Put this block's part of the setup on ``device``: its slabs of
        each variable level's planes and their ghost strips (exchanged
        once here), the sub-hierarchy, and the ``halo="rdma"`` receive
        buffers by exchange shape (over several blocks on the card K7's
        peer memory, which close() releases)."""
        self.device = device
        self.sub_hier = sub_hier
        self.mesh = launch.device_mesh_1d(self.cfg.n_devices)
        self.planes = tuple(None if c is None
                            else self.mesh.local(c, dim=2).to(device)
                            .contiguous() for c in planes)
        self.planes_ext = None
        if self.cfg.halo != "step" and any(c is not None for c in planes):
            self.planes_ext = extend_planes(self.cfg, self.planes)
        self._recv = rdma_buffers(self.cfg, self.dtype, device)
        self._peer = launch.process_count() > 1 and bool(self._recv)
        if device.type == "cuda" and launch.process_count() > 1:
            self._make_handles()
        self._loop = None               # the programs' buffers and pieces
        self._graphs = {}               # their graphs, by program
        self._coll = None               # the peer collectives' memory
        return self

    def _make_handles(self) -> None:
        """Create this block's library handles (cuSOLVER for the coarsest
        solve, cuBLAS for the transfers) now, while no block waits:
        creating one synchronizes the whole card (in a card thread) or
        this process's work on it, which mid-solve could wait for another
        block's collective that waits for this block."""
        nc = self.sub_hier.sides[-1]
        self.sub_hier.coarse_solve(torch.zeros((nc, nc), dtype=self.dtype,
                                               device=self.device))
        x = torch.zeros((2, 2), dtype=self.dtype, device=self.device)
        (x @ x).sum()
        torch.cuda.current_stream().synchronize()

    def close(self) -> None:
        """Collective under a process group on the card: release the peer
        collectives' memory and K7's peer memory (every process calls it,
        before the group is destroyed), then raise if one of K7's waits
        timed out. On a card group the same on every block, then its
        threads end (after a failure the peer memory is left to the
        process's end). The solver is not used after."""
        if self._blocks is not None:
            self._close_group(DistStructuredSolver.close)
            return
        self._close_programs()
        if self._peer:
            recv, self._recv, self._peer = self._recv, {}, False
            launch.close_peer_strips(recv)

    # -- the programs (launch.ProgramSolver runs them) ------------------------

    def _state(self) -> SimpleNamespace:
        """This block's programs in JAX's cond/body form on fixed buffers
        (built once): ``straight`` the pieces with no loop (``vcycle``:
        ``u`` <- V-cycle(``u``, ``b``); ``rss``; ``refine``: one df32
        refine from (``uh``, ``ul``) on (``bh``, ``bl``) into (``uh2``,
        ``ul2``) and ``r_err``), ``loops`` the ``graph_loop.DeviceLoop``
        and (pre, post) of ``pcg`` (JAX's pcg_fn: err = dot(r0, r0) at
        the start, every pass refines, the tolerance in ``dtype``) and
        ``ir`` (JAX's solve_fn: err starts at inf, the rss lags one
        refine, every pass refines, the final rss recomputed)."""
        if self._loop is not None:
            return self._loop
        dev, dt = self.device, self.dtype
        f32, f64, i32 = torch.float32, torch.float64, torch.int32
        shape = (self.cfg.n_devices // launch.process_count(),
                 self.cfg.blocks[0], self.side)

        def z(shape_=shape, dtype=dt):
            return torch.zeros(shape_, dtype=dtype, device=dev)
        L = SimpleNamespace(
            u=z(), b=z(), rss=z(()), r=z(), z=z(), p=z(), rz=z(()),
            p_err=z(()), p_tol=z(()), p_err64=z((), f64),
            p_tol64=z((), f64), p_it=z((), i32), p_n=z((), i32),
            p_stats=z((2,)))

        def vcycle():
            L.u.copy_(self._vcycle_raw(L.u, L.b))

        def rss():
            r = L.b - self._matvec(L.u)
            L.rss.copy_(self._dot(r, r))

        def precond(r):
            return -self._vcycle_raw(torch.zeros_like(r), r)

        def A_neg(x):
            return -self._matvec(x)

        def set_err(r):
            L.p_err.copy_(self._dot(r, r))
            L.p_err64.copy_(L.p_err)

        def pcg_pre():
            r = -L.b
            z_ = precond(r)
            L.u.zero_()
            L.r.copy_(r)
            L.z.copy_(z_)
            L.p.copy_(z_)
            L.rz.copy_(self._dot(r, z_))
            set_err(r)
            L.p_tol64.copy_(L.p_tol)
            L.p_it.zero_()

        def pcg_body():
            for buf, x in zip((L.u, L.r, L.z, L.p, L.rz),
                              _step(A_neg, precond, L.u, L.r, L.z, L.p,
                                    L.rz, dot=self._dot)):
                buf.copy_(x)
            set_err(L.r)

        def pcg_post():
            L.p_stats.copy_(torch.stack([L.p_err, L.p_it.to(dt)]))

        L.straight = {"vcycle": vcycle, "rss": rss}
        L.loops = {"pcg": (graph_loop.DeviceLoop(
            pcg_body, err=L.p_err64, tol=L.p_tol64, it=L.p_it, n=L.p_n),
            pcg_pre, pcg_post)}
        if self.cfg.w33s[0] is not None:
            self._df32_programs(L, shape, z)
        self._loop = L
        return L

    def _df32_programs(self, L, shape, z) -> None:
        """The df32 defect correction's programs (a constant fine level):
        JAX's ``_refine`` and ``_solve_device``."""
        f32, f64 = torch.float32, torch.float64
        for name in ("bh", "bl", "uh", "ul", "uh2", "ul2"):
            setattr(L, name, z(shape, f32))
        L.r_err, L.err, L.tol = (z((), f64) for _ in range(3))
        L.it, L.n = z((), torch.int32), z((), torch.int32)
        L.ir_stats = z((2,), f64)
        b_df, u = DF32(hi=L.bh, lo=L.bl), DF32(hi=L.uh, lo=L.ul)

        def refine_into(err, uh, ul):
            r = self._residual(b_df, u)
            err.copy_(self._rss_df(r))
            un = df_add_f32(u, self._cycles(r.hi))
            uh.copy_(un.hi)
            ul.copy_(un.lo)

        def ir_pre():
            L.uh.zero_()
            L.ul.zero_()
            L.err.fill_(float("inf"))
            L.it.zero_()

        def ir_post():
            final = self._rss_df(self._residual(b_df, u))
            L.ir_stats.copy_(torch.stack([final, L.it.to(f64)]))

        L.straight["refine"] = lambda: refine_into(L.r_err, L.uh2, L.ul2)
        L.loops["ir"] = (graph_loop.DeviceLoop(
            lambda: refine_into(L.err, L.uh, L.ul), err=L.err, tol=L.tol,
            it=L.it, n=L.n), ir_pre, ir_post)

    def _tensor(self, f) -> torch.Tensor:
        """A tensor on the solver's device; numpy input is copied."""
        if not isinstance(f, torch.Tensor):
            f = torch.from_numpy(np.array(f))
        return f.to(self.device)

    def _pad(self, f2, dtype) -> torch.Tensor:
        out = torch.zeros((self.n_pad, self.side), dtype=dtype,
                          device=self.device)
        out[:self.side] = self._tensor(f2).to(dtype)
        return self.mesh.local(out.reshape(self.cfg.n_devices,
                                           self.cfg.blocks[0], self.side))

    @launch.block_local
    def pad_field(self, f2) -> torch.Tensor:
        """(side, side) -> this block's (D/P, B_0, side) slabs in
        ``dtype``, zero padding rows."""
        return self._pad(f2, self.dtype)

    @launch.block_local
    def unpad(self, f2) -> torch.Tensor:
        """Slabs -> the (side, side) field: a view in one block, gathered
        from every block over several (where K7's peer form ran, after a
        check that none of its waits timed out)."""
        f = launch.all_gather_slabs(f2)
        if self._peer:
            torch.cuda.current_stream(f.device).synchronize()
            next(iter(self._recv.values())).check()
        return f.reshape(self.n_pad, self.side)[:self.side]

    def _vcycle_raw(self, u_pad, b_pad):
        return vcycle_dist(self.cfg, self.sub_hier, u_pad, b_pad, self._recv,
                           self.planes, self.planes_ext)

    @launch.block_local
    def vcycle(self, u_pad, b_pad):
        """One V-cycle (JAX's ``_vcycle``): one graph launch under the
        graph driver."""
        L = self._state()

        def inputs():
            L.u.copy_(u_pad)
            L.b.copy_(b_pad)
        self._run("vcycle", inputs)
        return L.u.clone()

    def _matvec(self, u_pad):
        """A u on the fine slabs (padding rows identity)."""
        if self.planes[0] is not None:
            return _matvec_var(self.planes[0], u_pad)
        return _matvec_const(self.cfg.w33s[0], u_pad, self.side)

    @staticmethod
    def _dot(x, y) -> torch.Tensor:
        """sum(x * y) over every slab: each slab's sum (one reduction of
        its own: a batched one rounds by the number of slabs in the
        batch), then the D slab sums as one vector, summed. Over several
        blocks each block puts its slab sums at its slabs' places of a
        zero (D,) vector and ``psum`` adds the vectors (every entry one
        block's value plus zeros, so exact), so every block, and one block
        alone, sums the same vector: a card group's or the processes' PCG
        iterates are one block's bitwise for any number of blocks."""
        return launch.slab_total(torch.stack([(x[d] * y[d]).sum()
                                              for d in range(len(x))]))

    def _read_rss(self) -> float:
        error = check_rss(float(self._state().rss))
        self._check()
        return error

    @launch.block_local
    def rss(self, u_pad, b_pad) -> float:
        """The rss of the slabs summed over every block (JAX's ``_rss``):
        one graph launch under the graph driver, then its read."""
        L = self._state()

        def inputs():
            L.u.copy_(u_pad)
            L.b.copy_(b_pad)
        self._run("rss", inputs)
        return self._read_rss()

    @launch.every_block
    def solve(self, b2, tolerance=1e-7, compute_error_every_n_iters=5,
              n_iters=100) -> SolveResult:
        """The reference's outer loop (multigrid.hpp:311-337): V-cycles in
        ``dtype`` (one ``vcycle`` program each), the rss every
        ``compute_error_every_n_iters`` (the ``rss`` program and its
        read), as JAX's host loop."""
        b_pad = self.pad_field(b2)
        L = self._state()
        self._build("vcycle")
        self._build("rss")
        L.b.copy_(b_pad)
        L.u.zero_()
        every = compute_error_every_n_iters
        it, error = 0, 100.0
        history = []
        while it < n_iters and error > tolerance:
            k = (min(every - (it % every), n_iters - it) if every
                 else n_iters - it)
            for _ in range(k):
                self._go("vcycle")
            it += k
            if every and it % every == 0:
                self._go("rss")
                error = self._read_rss()
                history.append((it, error))
        return SolveResult(u=self.unpad(L.u.clone()), iterations=it,
                           error=error, converged=error <= tolerance,
                           history=history)

    @launch.block_local
    def solve_pcg_device(self, b2, tolerance: float = 1e-5,
                         n_iters: int = 100):
        """JAX's ``_pcg_device`` program: AMG-preconditioned CG from
        u = 0, with no host read (one graph launch under the graph
        driver). Returns ``(u_pad, stats)``: this block's slabs and the
        tensor ``[rss, iterations]`` in ``dtype``."""
        L = self._state()
        b = self.pad_field(b2)

        def inputs():
            L.b.copy_(b)
            L.p_tol.fill_(tolerance)
            L.p_n.fill_(n_iters)
        self._run("pcg", inputs)
        return L.u.clone(), L.p_stats.clone()

    @launch.every_block
    def solve_pcg(self, b2, tolerance: float = 1e-5, n_iters: int = 100
                  ) -> SolveResult:
        """AMG-preconditioned CG on the negated (SPD) system, M^-1 minus
        one V-cycle from zero, in ``dtype`` (JAX ``pcg_fn``): the inner
        products and the rss summed over the slabs, the rss of the
        recurrence residual checked against ``tolerance`` (in ``dtype``)
        once per iteration, on the device under the graph driver (once a
        pass on the host under the host one). Constant and variable fine
        levels; one history entry, as JAX."""
        u, stats = self.solve_pcg_device(b2, tolerance, n_iters)
        error, it = stats.tolist()
        self._check()
        check_rss(error)
        it = int(it)
        return SolveResult(u=self.unpad(u), iterations=it, error=error,
                           converged=error <= tolerance,
                           history=[(it, error)])

    # -- the df32 defect correction (constant fine level) -------------------

    def _need_const(self, name: str, hint: str = ""):
        if self.cfg.w33s[0] is None:
            raise NotImplementedError(
                f"{name} requires a constant-stencil fine level{hint}")

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

    def _rss_df(self, r: DF32) -> torch.Tensor:
        return launch.psum(df_rss(r))

    def _cycles(self, r_hi):
        """cycles_per_refine V-cycles on A e = r from e = 0, in ``dtype``;
        the f32 correction."""
        r = r_hi.to(self.dtype)
        e = torch.zeros_like(r)
        for _ in range(self.cycles_per_refine):
            e = self._vcycle_raw(e, r)
        return e.to(torch.float32)

    def _df32_inputs(self, b2):
        """The rhs split into the df32 programs' buffers, u = 0."""
        L = self._state()
        b_df = self._split_b(b2)

        def inputs():
            L.bh.copy_(b_df.hi)
            L.bl.copy_(b_df.lo)
            L.uh.zero_()
            L.ul.zero_()
        return L, inputs

    @launch.block_local
    def solve_ir_device(self, b2, tolerance=1e-9, n_refine: int = 40):
        """The defect-correction loop of JAX's one-program solve: from
        u = 0, each pass computes the df32 residual and its rss and
        refines while the rss is above the tolerance, so the carried rss
        lags one correction; the final rss is recomputed. Under the graph
        driver one graph launch and no host read; under the host driver
        one read of the rss a pass. Returns ``(u_hi, u_lo, stats)``:
        padded f32 slabs and the f64 tensor ``[final_rss, refines]``."""
        self._need_const("solve_ir_device")
        L, write = self._df32_inputs(b2)

        def inputs():
            write()
            L.tol.fill_(tolerance)
            L.n.fill_(n_refine)
        self._run("ir", inputs)
        return L.uh.clone(), L.ul.clone(), L.ir_stats.clone()

    def _result_u(self, uh, ul) -> torch.Tensor:
        return (self.unpad(uh).to(torch.float64)
                + self.unpad(ul).to(torch.float64))

    @launch.every_block
    def solve_ir_fused(self, b2, tolerance=1e-9,
                       n_refine: int = 40) -> SolveResult:
        """solve_ir_device and one read of its stats; ``iterations``
        counts V-cycles, u is the f64 (side, side) field."""
        uh, ul, stats = self.solve_ir_device(b2, tolerance, n_refine)
        error, it = stats.tolist()
        self._check()
        check_rss(error)
        iters = int(it) * self.cycles_per_refine
        return SolveResult(u=self._result_u(uh, ul), iterations=iters,
                           error=error, converged=error <= tolerance,
                           history=[(iters, error)])

    @launch.every_block
    def solve_ir(self, b2, tolerance=1e-9, n_refine: int = 40
                 ) -> SolveResult:
        """The host-stepped defect correction (JAX's ``_refine`` program a
        step, one graph launch under the graph driver): each step returns
        the corrected iterate and the rss of the one it started from, and
        the correction is kept only while that rss is above the
        tolerance, so it stops as soon as the rss is at the tolerance."""
        self._need_const("solve_ir", "; use solve() or the ELL distributed "
                         "path for variable coefficients")
        L, inputs = self._df32_inputs(b2)
        self._build("refine")
        inputs()
        history, it, error = [], 0, float("inf")
        for _ in range(n_refine):
            self._go("refine")
            error = check_rss(float(L.r_err))
            self._check()
            history.append((it, error))
            if error <= tolerance:
                break
            L.uh.copy_(L.uh2)
            L.ul.copy_(L.ul2)
            it += self.cycles_per_refine
        return SolveResult(u=self._result_u(L.uh.clone(), L.ul.clone()),
                           iterations=it, error=error,
                           converged=error <= tolerance, history=history)
