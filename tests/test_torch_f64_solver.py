"""amg_tpu_torch's precision="f64" loop and the constant smoother="fused"
solve against amg_tpu's on the same operator and right-hand side (CPU;
the JAX side with x64).

The f64 loop is JAX's solve_loop_f64: native f64 residual and rss, f32
V-cycles, the FMG start in f32, a lagged rss with every pass refining and
the final rss recomputed. Both packages must take the same number of
refines, and the solutions must agree within the bound derived from
their residuals (tests/test_torch_solver.py): the f32 transfer matmuls
round differently in the two frameworks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amg_tpu import structured as jst
from amg_tpu.models import poisson as jpoisson
from amg_tpu.models import varcoef as jvar

from amg_tpu_torch import structured as tst

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = 1e-7


def _solution_bound(rss1, rss2, side):
    """|u1 - u2|_max <= |A^-1|_2 (|r1|_2 + |r2|_2); for the Poisson and the
    a >= 1 jump operators |A^-1|_2 <= h^2 / (8 sin^2(pi h / 4))."""
    h = 2.0 / (side + 1)
    lam = 8.0 * np.sin(np.pi * h / 4.0) ** 2 / (h * h)
    return (np.sqrt(rss1) + np.sqrt(rss2)) / lam


def _rhs(side):
    return np.asarray(jpoisson.rhs(side, dtype=jnp.float64)).reshape(side,
                                                                     side)


@pytest.mark.parametrize("side,var,kw", [
    (127, False, {"precision": "f64"}),
    (127, True, {"precision": "f64"}),
    (255, False, {"smoother": "fused"}),
], ids=["const-f64", "var-f64", "const-fused-df32"])
def test_solve_matches_jax(side, var, kw):
    b = _rhs(side)
    jkw, tkw = dict(kw), dict(kw)
    if var:
        planes = np.asarray(jvar.jump_planes(side, a_in=100.0))
        jkw["A_planes"] = jnp.asarray(planes)
        tkw["A_planes"] = torch.tensor(planes)
    ju, jstats = jst.StructuredSolver(side, **jkw).solve_ir_device(
        jnp.asarray(b), tolerance=TOL)
    ju, (j_rss, j_it) = np.asarray(ju), np.asarray(jstats)
    ts = tst.StructuredSolver(side, device=CPU, **tkw)
    assert not ts.packed_loop
    tu, tstats = ts.solve_ir_device(torch.tensor(b), tolerance=TOL)
    t_rss, t_it = tstats.tolist()
    assert tu.dtype == torch.float64
    assert int(t_it) == int(j_it) >= 2
    assert t_rss <= TOL and j_rss <= TOL
    assert np.abs(tu.numpy() - ju).max() <= _solution_bound(t_rss, j_rss,
                                                            side)
    if kw.get("precision") == "f64":
        # the f64 loop's rss is the f64 rss of the returned u, to roundoff
        A = ts.A64
        r = torch.tensor(b) - A.matvec2(tu)
        assert abs(float((r * r).sum()) - t_rss) <= 1e-6 * t_rss


def test_f64_loop_rtol_and_budget():
    side = 127
    s = tst.StructuredSolver(side, precision="f64", device=CPU)
    assert s.c_df is None and s.A64.w33 is not None
    b = torch.tensor(_rhs(side))
    _, stats = s.solve_ir_device(b, tolerance=1e-30, n_refine=2)
    err, it = stats.tolist()
    assert it == 2 and err > 1e-30      # recomputed after the last refine
    res = s.solve_ir_fused(b, tolerance=0.0, rtol=1e-12)
    base = float((b * b).sum())         # the f64 loop's own rtol base
    assert res.converged and res.error <= 1e-12 * base
