"""Carry state from the JAX package across to the port, through numpy.

The port never imports JAX: callers convert their JAX arrays with
``numpy.asarray`` first, and these functions build the port's objects from
the numpy arrays. Used by the tests to start both implementations from the
same state.
"""

from __future__ import annotations

import numpy as np
import torch

from amg_tpu_torch.ops.doublefloat import DF32
from amg_tpu_torch.structured import StencilHierarchy


def hierarchy_from_numpy(sides, w33s, coarse_lu, coarse_piv, P1s,
                         device=None) -> StencilHierarchy:
    """A StencilHierarchy from a JAX hierarchy's arrays: ``coarse_lu`` and
    ``coarse_piv`` from ``jax.scipy.linalg.lu_factor``, ``P1s`` the dense
    transfer matrices, ``sides`` and ``w33s`` its static metadata.

    ``jax.scipy.linalg.lu_factor`` returns 0-based pivots;
    ``torch.linalg.lu_solve`` expects LAPACK's 1-based int32 pivots."""
    lu = torch.tensor(np.asarray(coarse_lu), device=device)
    piv = torch.tensor(np.asarray(coarse_piv).astype(np.int32) + 1,
                       device=device)
    P1s = [torch.tensor(np.asarray(P), device=device) for P in P1s]
    return StencilHierarchy(sides, w33s, lu, piv, P1s)


def df32_from_numpy(hi, lo, device=None) -> DF32:
    """A (packed) df32 state from its two f32 numpy components."""
    hi = np.asarray(hi)
    lo = np.asarray(lo)
    if hi.dtype != np.float32 or lo.dtype != np.float32:
        raise ValueError(f"df32 components must be float32, got "
                         f"{hi.dtype} and {lo.dtype}")
    return DF32(hi=torch.tensor(hi, device=device),
                lo=torch.tensor(lo, device=device))
