"""Numerics debugging helpers: determinism, non-finite values, agreement
across slabs.

PyTorch port of ``amg_tpu/utils/debugging.py``. JAX's NaN check
(``jax_debug_nans``) inspects every jitted output; here the flag makes the
port's solve loops raise ``FloatingPointError`` when the rss they read on
the host anyway is not finite, so it adds no device sync. The device
loops (one CUDA graph on the card) read nothing on the host while they
run: ``solve_ir_fused`` checks the stats it fetches.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_NAN_CHECKS = False


def enable_nan_checks():
    """Make the solve loops raise on a non-finite rss."""
    global _NAN_CHECKS
    _NAN_CHECKS = True


def disable_nan_checks():
    global _NAN_CHECKS
    _NAN_CHECKS = False


def check_rss(error: float) -> float:
    """``error`` (an rss already on the host), after raising
    FloatingPointError if the checks are on and it is not finite."""
    if _NAN_CHECKS and not math.isfinite(error):
        raise FloatingPointError(f"non-finite rss {error}")
    return error


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def assert_reproducible(fn, *args, runs: int = 2):
    """Assert that ``fn(*args)`` returns the same bits on every run; returns
    the first result as numpy."""
    outs = [_host(fn(*args)) for _ in range(runs)]
    for o in outs[1:]:
        np.testing.assert_array_equal(outs[0], o)
    return outs[0]


def assert_shards_consistent(arr, mesh=None, expected_spec=None):
    """Assert that a value replicated across the slabs of a distributed
    solver holds the same bits on every slab of this block: ``arr``'s axis
    0 is the slabs (``DistStructuredSolver``'s layout), ``mesh`` the
    solver's ``launch.SlabMesh`` (``device_mesh_1d``; when given, axis 0
    must hold its ``slabs_per_process``), ``expected_spec`` the layout
    the value should have, replicated (None or ``()``; JAX's ``P()``), as
    JAX's form takes them."""
    if expected_spec is not None and len(tuple(expected_spec)):
        raise ValueError(f"a replicated value is checked, not one laid out "
                         f"as {expected_spec!r}")
    if mesh is not None and len(arr) != mesh.slabs_per_process:
        raise ValueError(f"axis 0 holds {len(arr)} slabs, the mesh gives "
                         f"this block {mesh.slabs_per_process}")
    vals = _host(arr)
    for v in vals[1:]:
        np.testing.assert_array_equal(vals[0], v)
