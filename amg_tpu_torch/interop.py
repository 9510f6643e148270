"""Carry state from the JAX package across to the port, through numpy.

The port never imports JAX: callers convert their JAX arrays with
``numpy.asarray`` first, and these functions build the port's objects from
the numpy arrays. Used by the tests to start both implementations from the
same state. Like every entry point of the port, ``device`` None means
``"cuda"`` and raises without a CUDA device; the inputs are checked first.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from amg_tpu_torch.multigrid import Hierarchy, Level
from amg_tpu_torch.ops.coarse import pivots_from_jax, setup_coarse_solver
from amg_tpu_torch.ops.doublefloat import DF32
from amg_tpu_torch.ops.smoothers import MulticolorGaussSeidel
from amg_tpu_torch.parallel.ell_dist import ShardedOp
from amg_tpu_torch.parallel.structured_dist import DistConfig
from amg_tpu_torch.sparse.stencil import color_masks
from amg_tpu_torch.sparse.ell import ELL
from amg_tpu_torch.structured import PACKED_MIN_SIDE, StencilHierarchy
from amg_tpu_torch.utils.device import resolve_device


def hierarchy_from_numpy(sides, w33s, coarse_lu, coarse_piv, P1s,
                         device=None, planes=None, smoother: str = "masked",
                         packed_min_side: int = PACKED_MIN_SIDE,
                         masks=None, lam_maxes=None) -> StencilHierarchy:
    """A StencilHierarchy from a JAX hierarchy's arrays: ``coarse_lu`` and
    ``coarse_piv`` from ``jax.scipy.linalg.lu_factor``, ``P1s`` the dense
    transfer matrices, ``sides`` its static metadata, ``w33s`` its levels'
    constant weights (None on a variable level) and ``planes``, one
    (3,3,n,n) array per level, where the levels have them (a variable or
    host-built hierarchy). A host-built hierarchy also carries ``masks``,
    one (4,n,n) array per level, and any hierarchy its Chebyshev bounds
    ``lam_maxes`` (floats), so that a test can start the port from JAX's
    power-iteration estimates.

    ``jax.scipy.linalg.lu_factor`` returns 0-based pivots;
    ``torch.linalg.lu_solve`` expects LAPACK's 1-based int32 pivots."""
    device = resolve_device(device)
    lu = torch.tensor(np.asarray(coarse_lu), device=device)
    piv = pivots_from_jax(coarse_piv, device)
    P1s = [torch.tensor(np.asarray(P), device=device) for P in P1s]
    if planes is not None:
        planes = [planes_from_numpy(c, device) for c in planes]
    if masks is not None:
        masks = [torch.tensor(np.asarray(m), device=device) for m in masks]
    return StencilHierarchy(sides, w33s, lu, piv, P1s, planes=planes,
                            smoother=smoother,
                            packed_min_side=packed_min_side, masks=masks,
                            lam_maxes=lam_maxes)


def dist_hierarchy_from_numpy(cfg_fields: dict, sub_sides, sub_w33s,
                              coarse_lu, coarse_piv, sub_P1s, device=None,
                              sub_planes=None):
    """The port's ``(DistConfig, sub-hierarchy)`` from a JAX distributed
    hierarchy: ``cfg_fields`` the JAX ``DistConfig``'s fields as a dict
    (``dataclasses.asdict``; its TPU interpret-mode setting is dropped),
    and the replicated sub-hierarchy's sides, constant weights, LU factors
    and dense transfer matrices as numpy; ``sub_planes``, one (3,3,n,n)
    array a level, where its levels are variable (they then get JAX's
    stored color masks too). The sharded levels' planes come through
    ``dist_planes_from_numpy``."""
    names = {f.name for f in dataclasses.fields(DistConfig)}
    fields = {k: v for k, v in cfg_fields.items() if k in names}
    for k in ("sides", "blocks", "w33s"):
        fields[k] = tuple(fields[k])
    cfg = DistConfig(**fields)
    masks = None
    if sub_planes is not None:
        dtype = torch.as_tensor(np.array(coarse_lu)).dtype
        masks = [color_masks(s, dtype, resolve_device(device))
                 for s in sub_sides]
    return cfg, hierarchy_from_numpy(sub_sides, sub_w33s, coarse_lu,
                                     coarse_piv, sub_P1s, device=device,
                                     planes=sub_planes, masks=masks)


def dist_planes_from_numpy(c, n_devices: int, device=None) -> torch.Tensor:
    """A sharded variable level's planes from JAX's (3, 3, n_pad, n) array
    (``build_dist_hierarchy``'s coefficients, identity padding rows) as
    the port's (3, 3, D, B, n) slabs, dtype kept."""
    c = np.asarray(c)
    if c.ndim != 4 or c.shape[:2] != (3, 3) or c.shape[2] % n_devices:
        raise ValueError(f"planes must be (3, 3, n_pad, n) with n_pad a "
                         f"multiple of {n_devices}, got {c.shape}")
    return torch.tensor(c.reshape(3, 3, n_devices, -1, c.shape[3]),
                        device=resolve_device(device))


def sharded_op_from_numpy(data, cols, B_row: int, B_x: int, W: int,
                          device=None) -> ShardedOp:
    """A ShardedOp from a JAX ``ShardedOp``'s arrays: ``data`` and
    ``cols`` (D * B_row, K) in window coordinates (values kept in their
    dtype), as the port's (D, B_row, K) slabs."""
    data, cols = np.asarray(data), np.asarray(cols)
    if data.ndim != 2 or cols.shape != data.shape or data.shape[0] % B_row:
        raise ValueError(f"ShardedOp data {data.shape} and cols "
                         f"{cols.shape} must be (D * {B_row}, K)")
    if cols.min() < 0 or cols.max() >= B_x + 2 * W:
        raise ValueError(f"ShardedOp cols must lie in [0, {B_x + 2 * W})")
    device = resolve_device(device)
    D, K = data.shape[0] // B_row, data.shape[1]
    return ShardedOp(
        data=torch.tensor(data.reshape(D, B_row, K), device=device),
        cols=torch.tensor(cols.astype(np.int64).reshape(D, B_row, K),
                          device=device),
        B_row=int(B_row), B_x=int(B_x), W=int(W))


def planes_from_numpy(c, device=None) -> torch.Tensor:
    """(3,3,n,n) coefficient planes from numpy, dtype kept."""
    c = np.asarray(c)
    if c.ndim != 4 or c.shape[:2] != (3, 3) or c.shape[2] != c.shape[3]:
        raise ValueError(f"planes must be (3, 3, n, n), got {c.shape}")
    return torch.tensor(c, device=resolve_device(device))


def df32_from_numpy(hi, lo, device=None) -> DF32:
    """A (packed) df32 state from its two f32 numpy components."""
    hi = np.asarray(hi)
    lo = np.asarray(lo)
    if hi.dtype != np.float32 or lo.dtype != np.float32:
        raise ValueError(f"df32 components must be float32, got "
                         f"{hi.dtype} and {lo.dtype}")
    device = resolve_device(device)
    return DF32(hi=torch.tensor(hi, device=device),
                lo=torch.tensor(lo, device=device))


def ell_from_numpy(data, cols, shape, device=None) -> ELL:
    """An ELL from a JAX ELL's arrays: ``data`` (n_rows, K) values kept in
    their dtype, ``cols`` (n_rows, K) int column indices, ``shape``
    (n_rows, n_cols)."""
    data, cols = np.asarray(data), np.asarray(cols)
    shape = tuple(int(s) for s in shape)
    if data.ndim != 2 or cols.shape != data.shape or data.shape[0] != shape[0]:
        raise ValueError(f"ELL data {data.shape} and cols {cols.shape} must "
                         f"be (n_rows, K) with n_rows = shape[0] of {shape}")
    if not np.issubdtype(cols.dtype, np.integer):
        raise ValueError(f"ELL cols must be integers, got {cols.dtype}")
    device = resolve_device(device)
    return ELL(data=torch.tensor(data, device=device),
               cols=torch.tensor(cols.astype(np.int64), device=device),
               shape=shape)


def ell_hierarchy_from_numpy(levels, smoother=None, device=None) -> Hierarchy:
    """An ELL ``Hierarchy`` from a JAX hierarchy's arrays: ``levels`` holds
    one dict a level, ``{"A": ..., "P": ..., "R": ...}``, each a
    ``(data, cols, shape)`` triple (P and R None or absent on the
    coarsest). The smoother's per-level state (default
    MulticolorGaussSeidel) and the coarse LU are rebuilt, as
    ``load_hierarchy`` rebuilds them."""
    if smoother is None:
        smoother = MulticolorGaussSeidel()

    def ell(spec):
        return None if spec is None else ell_from_numpy(*spec, device=device)

    out = []
    for spec in levels:
        A = ell(spec["A"])
        out.append(Level(A=A, P=ell(spec.get("P")), R=ell(spec.get("R")),
                         smoother_state=smoother.setup(A)))
    return Hierarchy(out, setup_coarse_solver(out[-1].A))
