"""Hierarchy and solution checkpoints.

PyTorch port of ``amg_tpu/utils/checkpoint.py:16-141``. The setup product
(level operators, transfers, the coarse factorization) is saved once and
reloaded, skipping the host SpGEMM chain on restart; solution snapshots
make the outer iteration resumable. The files are the JAX package's
``.npz`` format key for key, so either package loads what the other
saved: LU pivots are stored 0-based (JAX's), ELL columns as int32.

Loads return tensors on ``device`` (None means ``"cuda"``).
"""

from __future__ import annotations

import numpy as np
import torch

from amg_tpu_torch.ops.coarse import pivots_from_jax, pivots_to_jax
from amg_tpu_torch.utils.device import resolve_device


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_stencil_hierarchy(path: str, hier) -> None:
    """Save a ``StencilHierarchy``: a level with planes as ``c{i}``, a
    plane-free constant level as its 3x3 weights ``w{i}``, and the
    Chebyshev bounds ``lam_maxes`` where the hierarchy has them."""
    from amg_tpu_torch.structured import StencilHierarchy

    if not isinstance(hier, StencilHierarchy):
        raise TypeError(f"expected a StencilHierarchy, got {type(hier)}")
    arrs = {"sides": np.asarray(hier.sides),
            "coarse_lu": _np(hier.coarse_lu),
            "coarse_piv": pivots_to_jax(hier.coarse_piv),
            "smoother": np.asarray(hier.smoother)}
    if hier.lam_maxes is not None:
        arrs["lam_maxes"] = np.asarray(hier.lam_maxes)
    for i, (w33, S) in enumerate(zip(hier.w33s, hier.levels)):
        if S.c is None:
            arrs[f"w{i}"] = np.asarray(w33)
        else:
            arrs[f"c{i}"] = _np(S.c)
    np.savez_compressed(path, **arrs)


def load_stencil_hierarchy(path: str, dtype=None, device=None):
    """Reload a ``StencilHierarchy`` saved by either package: a ``c{i}``
    level gets its planes (its constant stencil detected, as JAX's
    ``Stencil2D.from_planes`` does) and color masks, a ``w{i}`` level its
    weights; the transfers are rebuilt."""
    from amg_tpu_torch.ops.rap import interp1d_dense
    from amg_tpu_torch.sparse.stencil import Stencil2D, color_masks
    from amg_tpu_torch.structured import StencilHierarchy

    device = resolve_device(device)
    z = np.load(path)
    sides = tuple(int(s) for s in z["sides"])
    lu = torch.tensor(z["coarse_lu"], device=device)
    dt = dtype or lu.dtype
    w33s, planes, masks = [], [], []
    for i, side in enumerate(sides):
        if f"w{i}" in z:
            w33s.append(tuple(tuple(float(v) for v in row)
                              for row in z[f"w{i}"]))
            planes.append(None)
            masks.append(None)
            continue
        c = torch.tensor(z[f"c{i}"], device=device, dtype=dtype)
        w33s.append(Stencil2D.from_planes(c, side).w33)
        planes.append(c)
        masks.append(color_masks(side, c.dtype, device))
    has_planes = any(c is not None for c in planes)
    P1s = [interp1d_dense(sides[l], sides[l + 1], dt, device)
           for l in range(len(sides) - 1)]
    return StencilHierarchy(
        sides, w33s, lu, pivots_from_jax(z["coarse_piv"], device), P1s,
        planes=planes if has_planes else None,
        smoother=str(z["smoother"]) if "smoother" in z else "masked",
        masks=masks if has_planes else None,
        lam_maxes=(tuple(float(v) for v in z["lam_maxes"])
                   if "lam_maxes" in z else None))


def _ell_arrays(prefix: str, M) -> dict:
    return {f"{prefix}_data": _np(M.data),
            f"{prefix}_cols": _np(M.cols).astype(np.int32),
            f"{prefix}_shape": np.asarray(M.shape)}


def save_hierarchy(path: str, hier) -> None:
    """Save an ELL ``multigrid.Hierarchy``: every level's operator and
    transfers (the Galerkin chain's product, multigrid.hpp:211-243)."""
    from amg_tpu_torch.multigrid import Hierarchy

    if not isinstance(hier, Hierarchy):
        raise TypeError(f"expected a Hierarchy, got {type(hier)}")
    arrs = {"n_levels": np.asarray(hier.n_levels)}
    for i, lev in enumerate(hier.levels):
        arrs.update(_ell_arrays(f"A{i}", lev.A))
        if lev.P is not None:
            arrs.update(_ell_arrays(f"P{i}", lev.P))
            arrs.update(_ell_arrays(f"R{i}", lev.R))
    np.savez_compressed(path, **arrs)


def load_hierarchy(path: str, smoother=None, device=None):
    """Reload an ELL hierarchy; the smoother's per-level state (default
    MulticolorGaussSeidel: the host coloring, pattern only) and the coarse
    LU are rebuilt."""
    from amg_tpu_torch.interop import ell_hierarchy_from_numpy

    z = np.load(path)

    def ell(prefix):
        if f"{prefix}_data" not in z:
            return None
        return (z[f"{prefix}_data"], z[f"{prefix}_cols"],
                tuple(int(s) for s in z[f"{prefix}_shape"]))

    levels = [{"A": ell(f"A{i}"), "P": ell(f"P{i}"), "R": ell(f"R{i}")}
              for i in range(int(z["n_levels"]))]
    return ell_hierarchy_from_numpy(levels, smoother=smoother, device=device)


def save_solution(path: str, u, iteration: int, error: float) -> None:
    np.savez_compressed(path, u=_np(torch.as_tensor(u)), iteration=iteration,
                        error=error)


def load_solution(path: str, device=None):
    """(u on ``device``, iteration, error)."""
    z = np.load(path)
    return (torch.tensor(z["u"], device=resolve_device(device)),
            int(z["iteration"]), float(z["error"]))
