"""amg_tpu_torch's StructuredSolver end to end against amg_tpu's on the
same right-hand side (CPU; the JAX side in f64 mode, x64): the main path
prepare_b -> solve_ir_device_prepared -> finalize_u at 255^2 and 511^2,
and the unpacked df32 loop below packed_min_side at 127^2.

Both must take the same number of refines and reach rss <= 1e-7, and the
two solutions must agree within a bound derived from their residuals (see
_solution_bound): the f32 transfer matmuls round differently in the two
frameworks, so the iterates are not bitwise equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amg_tpu import structured as jst
from amg_tpu.models import poisson as jpoisson

from amg_tpu_torch import structured as tst

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _solution_bound(rss1, rss2, side):
    """|u1 - u2|_max <= |u1 - u2|_2 <= |A^-1|_2 (|r1|_2 + |r2|_2) for two
    iterates of one system; |A^-1|_2 = 1 / lambda_min(A) with
    lambda_min = 8 sin^2(pi h / 4) / h^2 (about pi^2 / 2 on [-1, 1]^2)."""
    h = 2.0 / (side + 1)
    lam = 8.0 * np.sin(np.pi * h / 4.0) ** 2 / (h * h)
    return (np.sqrt(rss1) + np.sqrt(rss2)) / lam


def _f64_rss(u, b, side):
    """Independent rss of b - A u (f64 5-point Laplacian, numpy)."""
    h = 2.0 / (side + 1)
    up = np.pad(u, 1)
    Au = (up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
          - 4.0 * u) / (h * h)
    return float(((b - Au) ** 2).sum())


@pytest.mark.parametrize("side", [255, 511])
def test_solver_matches_jax(side):
    b_np = np.asarray(jpoisson.rhs(side, dtype=jnp.float64)).reshape(side,
                                                                     side)
    js = jst.StructuredSolver(side)
    ju4, jstats = js.solve_ir_device_prepared(js.prepare_b(jnp.asarray(b_np)),
                                              tolerance=1e-7)
    ju = np.asarray(js.finalize_u(ju4))
    j_rss, j_it = np.asarray(jstats)

    ts = tst.StructuredSolver(side, device=CPU)
    tu4, tstats = ts.solve_ir_device_prepared(
        ts.prepare_b(torch.tensor(b_np)), tolerance=1e-7)
    tu = ts.finalize_u(tu4).numpy()
    t_rss, t_it = tstats.tolist()

    assert int(t_it) == int(j_it) == 2
    assert t_rss <= 1e-7 and j_rss <= 1e-7
    # the reported (df32) rss agrees with an independent f64 residual
    t_ind, j_ind = _f64_rss(tu, b_np, side), _f64_rss(ju, b_np, side)
    assert abs(t_ind - t_rss) <= 0.05 * t_ind
    assert np.abs(tu - ju).max() <= _solution_bound(t_ind, j_ind, side)


def test_unpacked_loop_matches_jax():
    """Below packed_min_side (200) both solvers run the unpacked df32 loop
    (lagged rss, no skip pass, final rss recomputed)."""
    side = 127
    b_np = np.asarray(jpoisson.rhs(side, dtype=jnp.float64)).reshape(side,
                                                                     side)
    ju, jstats = jst.StructuredSolver(side).solve_ir_device(
        jnp.asarray(b_np), tolerance=1e-7)
    j_rss, j_it = np.asarray(jstats)
    ts = tst.StructuredSolver(side, device=CPU)
    assert not ts.packed_loop
    tu, tstats = ts.solve_ir_device(torch.tensor(b_np), tolerance=1e-7)
    t_rss, t_it = tstats.tolist()
    assert int(t_it) == int(j_it)
    assert t_rss <= 1e-7 and j_rss <= 1e-7
    assert np.abs(tu.numpy() - np.asarray(ju)).max() <= _solution_bound(
        _f64_rss(tu.numpy(), b_np, side), _f64_rss(np.asarray(ju), b_np,
                                                   side), side)
