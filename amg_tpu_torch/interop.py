"""Carry state from the JAX package across to the port, through numpy.

The port never imports JAX: callers convert their JAX arrays with
``numpy.asarray`` first, and these functions build the port's objects from
the numpy arrays. Used by the tests to start both implementations from the
same state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from amg_tpu_torch.ops.doublefloat import DF32
from amg_tpu_torch.parallel.structured_dist import DistConfig
from amg_tpu_torch.structured import PACKED_MIN_SIDE, StencilHierarchy


def hierarchy_from_numpy(sides, w33s, coarse_lu, coarse_piv, P1s,
                         device=None, planes=None, smoother: str = "masked",
                         packed_min_side: int = PACKED_MIN_SIDE
                         ) -> StencilHierarchy:
    """A StencilHierarchy from a JAX hierarchy's arrays: ``coarse_lu`` and
    ``coarse_piv`` from ``jax.scipy.linalg.lu_factor``, ``P1s`` the dense
    transfer matrices, ``sides`` its static metadata, and either ``w33s``
    (a constant hierarchy) or ``planes``, one (3,3,n,n) array per level
    (a variable one; ``w33s`` then all None).

    ``jax.scipy.linalg.lu_factor`` returns 0-based pivots;
    ``torch.linalg.lu_solve`` expects LAPACK's 1-based int32 pivots."""
    lu = torch.tensor(np.asarray(coarse_lu), device=device)
    piv = torch.tensor(np.asarray(coarse_piv).astype(np.int32) + 1,
                       device=device)
    P1s = [torch.tensor(np.asarray(P), device=device) for P in P1s]
    if planes is not None:
        planes = [planes_from_numpy(c, device) for c in planes]
    return StencilHierarchy(sides, w33s, lu, piv, P1s, planes=planes,
                            smoother=smoother,
                            packed_min_side=packed_min_side)


def dist_hierarchy_from_numpy(cfg_fields: dict, sub_sides, sub_w33s,
                              coarse_lu, coarse_piv, sub_P1s, device=None):
    """The port's ``(DistConfig, sub-hierarchy)`` from a JAX distributed
    hierarchy: ``cfg_fields`` the JAX ``DistConfig``'s fields as a dict
    (``dataclasses.asdict``; its TPU interpret-mode setting is dropped),
    and the replicated sub-hierarchy's sides, constant weights, LU factors
    and dense transfer matrices as numpy."""
    names = {f.name for f in dataclasses.fields(DistConfig)}
    fields = {k: v for k, v in cfg_fields.items() if k in names}
    for k in ("sides", "blocks", "w33s"):
        fields[k] = tuple(fields[k])
    sub_hier = hierarchy_from_numpy(sub_sides, sub_w33s, coarse_lu,
                                    coarse_piv, sub_P1s, device=device)
    return DistConfig(**fields), sub_hier


def planes_from_numpy(c, device=None) -> torch.Tensor:
    """(3,3,n,n) coefficient planes from numpy, dtype kept."""
    c = np.asarray(c)
    if c.ndim != 4 or c.shape[:2] != (3, 3) or c.shape[2] != c.shape[3]:
        raise ValueError(f"planes must be (3, 3, n, n), got {c.shape}")
    return torch.tensor(c, device=device)


def df32_from_numpy(hi, lo, device=None) -> DF32:
    """A (packed) df32 state from its two f32 numpy components."""
    hi = np.asarray(hi)
    lo = np.asarray(lo)
    if hi.dtype != np.float32 or lo.dtype != np.float32:
        raise ValueError(f"df32 components must be float32, got "
                         f"{hi.dtype} and {lo.dtype}")
    return DF32(hi=torch.tensor(hi, device=device),
                lo=torch.tensor(lo, device=device))
