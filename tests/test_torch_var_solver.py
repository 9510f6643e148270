"""amg_tpu_torch's variable-coefficient solve against amg_tpu's on the same
jump-coefficient operator (a = 100 in the centered square, the bench.py
var rows' problem) and right-hand side (CPU; the JAX side with x64):
``StructuredSolver(side, A_planes=...)`` with smoother="auto" (packed-var
levels, no kernel) and smoother="fused" (the unpacked cycle; K6 sweeps on
the levels of side >= FUSED_MIN_SIDE), both through the unpacked df32
loop.

Both must take the same number of refines and reach rss <= 1e-7, and the
solutions must agree within a bound derived from their residuals (see
_solution_bound): the f32 transfer matmuls round differently in the two
frameworks, so the iterates are not bitwise equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amg_tpu import structured as jst
from amg_tpu.models import poisson as jpoisson
from amg_tpu.models import varcoef as jvar

from amg_tpu_torch import structured as tst
from amg_tpu_torch.models import varcoef as tvar

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = 1e-7


def _solution_bound(rss1, rss2, side):
    """|u1 - u2|_max <= |A^-1|_2 (|r1|_2 + |r2|_2). With a >= 1 every face
    coefficient is >= 1, so A - A_poisson is positive semidefinite and
    |A^-1|_2 <= 1 / lambda_min(A_poisson) = h^2 / (8 sin^2(pi h / 4))."""
    h = 2.0 / (side + 1)
    lam = 8.0 * np.sin(np.pi * h / 4.0) ** 2 / (h * h)
    return (np.sqrt(rss1) + np.sqrt(rss2)) / lam


def _f64_rss(u, b, planes):
    """Independent rss of b - A u in f64 numpy: the f32 planes both
    packages solve with, widened, and their own 9 shifted products."""
    n = u.shape[0]
    up = np.pad(u, 1)
    Au = sum(planes[dj + 1, di + 1].astype(np.float64)
             * up[1 + dj:1 + dj + n, 1 + di:1 + di + n]
             for dj in (-1, 0, 1) for di in (-1, 0, 1))
    return float(((b - Au) ** 2).sum())


def _both(side, **kw):
    """One solve of each package on the same planes and rhs."""
    planes = np.asarray(jvar.jump_planes(side, a_in=100.0))
    b = np.asarray(jpoisson.rhs(side, dtype=jnp.float64)).reshape(side, side)
    ju, jstats = jst.StructuredSolver(
        side, A_planes=jnp.asarray(planes), **kw).solve_ir_device(
        jnp.asarray(b), tolerance=TOL)
    ts = tst.StructuredSolver(side, A_planes=torch.tensor(planes),
                              device=CPU, **kw)
    tu, tstats = ts.solve_ir_device(torch.tensor(b), tolerance=TOL)
    return ts, b, planes, (np.asarray(ju), *np.asarray(jstats)), \
        (tu.numpy(), *tstats.tolist())


@pytest.mark.parametrize("side,smoother", [(127, "auto"), (255, "auto"),
                                           (255, "fused")])
def test_var_solve_matches_jax(side, smoother):
    ts, b, planes, (ju, j_rss, j_it), (tu, t_rss, t_it) = _both(
        side, smoother=smoother)
    assert not ts.packed_loop and ts.hier.is_var
    assert ts.plan[0] == ("packed_var" if smoother == "auto" and side > 200
                          else "masked_k12")
    assert int(t_it) == int(j_it) >= 2
    assert t_rss <= TOL and j_rss <= TOL
    t_ind, j_ind = _f64_rss(tu, b, planes), _f64_rss(ju, b, planes)
    assert t_ind <= TOL and j_ind <= TOL
    assert np.abs(tu - ju).max() <= _solution_bound(t_ind, j_ind, side)


@pytest.mark.parametrize("var", [True, False], ids=["K6-var", "K5-const"])
def test_fused_sweep_calls_per_solve(monkeypatch, var):
    """With FUSED_MIN_SIDE at the fine side, a smoother="fused" df32 solve
    calls the fused sweep 2 (1 + 3 it) times: pre and post on the fine
    level in the FMG start's last cycle and in each of the 3 cycles of
    every refine, the loop's overshoot refine included in ``it``. This is
    the launch total chip_smoke.py asserts for K5 and K6 on the card."""
    side = 127
    monkeypatch.setattr(tst, "FUSED_MIN_SIDE", side)
    calls = []
    orig = tst.fused_gs4_sweep
    monkeypatch.setattr(tst, "fused_gs4_sweep",
                        lambda *a, **k: calls.append(a[0].w33) or orig(
                            *a, **k))
    kw = {"A_planes": tvar.jump_planes(side, device=CPU)} if var else {}
    s = tst.StructuredSolver(side, smoother="fused", device=CPU, **kw)
    assert s.plan[0] == ("fused_var" if var else "fused_const")
    b = torch.tensor(np.asarray(jpoisson.rhs(side, dtype=jnp.float64))
                     ).reshape(side, side)
    _, stats = s.solve_ir_device(b, tolerance=TOL)
    err, it = stats.tolist()
    assert err <= TOL and it >= 2
    assert len(calls) == 2 * (1 + 3 * int(it))
    assert all((w is None) == var for w in calls)


def test_var_solve_rtol_and_budget():
    side = 127
    s = tst.StructuredSolver(side, A_planes=tvar.jump_planes(side,
                                                             device=CPU),
                             device=CPU)
    b = torch.tensor(np.asarray(jpoisson.rhs(side, dtype=jnp.float64))
                     ).reshape(side, side)
    _, stats = s.solve_ir_device(b, tolerance=TOL, n_refine=1)
    err, it = stats.tolist()
    assert it == 1 and err > TOL     # recomputed after the last refine
    res = s.solve_ir_fused(b, tolerance=0.0, rtol=1e-12)
    assert res.converged and 0.0 < res.error
    with pytest.raises(ValueError):
        s.prepare_b(b)                # the var loop is unpacked
    with pytest.raises(ValueError):
        s.solve_ir_device(b.float())  # a float64 rhs only
