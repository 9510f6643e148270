"""Shared checks of the other tests/test_torch_solver_*.py (no test of
its own): one StructuredSolver option set, built by amg_tpu and by
amg_tpu_torch, run on the same Poisson right-hand side (CPU; the JAX
side with x64).

Held to: the same refine count; rss <= tol on both sides, and the port's
reported rss against an independent f64 scipy residual within 5 %; the
two solutions within the bound their residuals give (``solution_bound``:
the f32 cycles round in each framework's own order, so the iterates are
not bitwise equal).

``solve_ir``: the same steps and V-cycle counts. Each step, given JAX's
iterate, returns the same rss up to the f64 rounding of the two
residuals (|r1 - r2| under 1e-12 |b|, so the rss within 1e-12 (rss + 2 |r|
|b|); the port's equals an independent scipy residual's where JAX's parts
from both by 2e-7 at 1e-8) and an iterate within 2e-4 relative (the f32
cycles: measured 2.0e-6 at 127^2 on the Poisson problem, 8.7e-6 on the
jump one from A_fine and 8.1e-5 from its f32 planes, whose contrast of
100 magnifies the rounding; in f64 the same cycles agree to 1e-9,
tests/test_torch_host_hierarchy.py). Each history rss above 1e-14 of
rss(b) within 0.1 relative: the iterates part by those f32 roundings,
and the operator, whose norm is 8/h^2, amplifies them in the next
residual, which is 1e-3 of the one before in norm (measured gaps up to
4e-2 at 127^2).
"""

import numpy as np
import torch

import jax.numpy as jnp

from amg_tpu import structured as jst
from amg_tpu.models import poisson as jpoisson
from amg_tpu.models import varcoef as jvar

from amg_tpu_torch import structured as tst

CPU = torch.device("cpu")
IR_RTOL = 0.1
STEP_RTOL = 2e-4
RSS_FLOOR = 1e-14


def operator(problem: str, side: int):
    """The fine operator's scipy matrix: Poisson or the jump problem."""
    if problem == "poisson":
        return jpoisson.laplacian_scipy(side)
    return jvar.jump_scipy(side)


def rhs(side: int) -> np.ndarray:
    return np.asarray(jpoisson.rhs(side, dtype=jnp.float64)).reshape(side,
                                                                     side)


def solvers(side: int, **kw):
    """(JAX solver, port solver) for the same options; an ``A_fine`` goes
    to both as the same scipy matrix."""
    return (jst.StructuredSolver(side, **kw),
            tst.StructuredSolver(side, device=CPU, **kw))


def independent_rss(A, u: np.ndarray, b: np.ndarray) -> float:
    r = b.reshape(-1) - A @ u.reshape(-1)
    return float(r @ r)


def solution_bound(rss1: float, rss2: float, side: int) -> float:
    """|u1 - u2|_max <= |A^-1|_2 (|r1|_2 + |r2|_2) for two iterates of one
    system; |A^-1|_2 = 1 / lambda_min, lambda_min = 8 sin^2(pi h / 4) / h^2
    for the Poisson operator and at most that for the jump one (a >= 1)."""
    h = 2.0 / (side + 1)
    lam = 8.0 * np.sin(np.pi * h / 4.0) ** 2 / (h * h)
    return (np.sqrt(rss1) + np.sqrt(rss2)) / lam


def check_device_solve(js, ts, A, side: int, tol: float = 1e-7) -> int:
    """solve_ir_device on both sides; returns the refine count."""
    b = rhs(side)
    ju, jstats = js.solve_ir_device(jnp.asarray(b), tolerance=tol)
    j_rss, j_it = (float(x) for x in np.asarray(jstats))
    tu, tstats = ts.solve_ir_device(torch.tensor(b), tolerance=tol)
    t_rss, t_it = tstats.tolist()
    assert int(t_it) == int(j_it), (t_it, j_it)
    assert t_rss <= tol and j_rss <= tol
    tu, ju = tu.numpy(), np.asarray(ju)
    t_ind, j_ind = independent_rss(A, tu, b), independent_rss(A, ju, b)
    assert abs(t_ind - t_rss) <= 0.05 * t_ind + 1e-3 * tol
    assert np.abs(tu - ju).max() <= solution_bound(t_ind, j_ind, side)
    return int(t_it)


def check_solve_ir(js, ts, A, side: int, tol: float = 1e-7):
    """The host-stepped solve_ir on both sides; returns the port's
    result."""
    b = rhs(side)
    want = js.solve_ir(jnp.asarray(b), tolerance=tol)
    got = ts.solve_ir(torch.tensor(b), tolerance=tol)
    assert want.converged and got.converged
    assert got.iterations == want.iterations
    assert [i for i, _ in got.history] == [i for i, _ in want.history]
    floor = RSS_FLOOR * float(np.sum(b * b))
    for (_, g), (_, w) in zip(got.history, want.history):
        if w > floor:
            assert abs(g - w) <= IR_RTOL * w, (g, w)
    rss_b = float(np.sum(b * b))
    ju = jnp.zeros_like(jnp.asarray(b))
    for _ in want.history:
        ju_next, jerr = js._refine_step(ju, jnp.asarray(b))
        tu_next, terr = ts._refine_step(torch.tensor(np.asarray(ju)),
                                        torch.tensor(b))
        jerr, terr = float(jerr), float(terr)
        assert abs(terr - jerr) <= 1e-12 * (jerr + 2 * np.sqrt(jerr * rss_b))
        ju_next = np.asarray(ju_next)
        assert (np.abs(tu_next.numpy() - ju_next).max()
                <= STEP_RTOL * np.abs(ju_next).max())
        ju = jnp.asarray(ju_next)
    tu, ju = got.u.numpy(), np.asarray(want.u)
    t_ind, j_ind = independent_rss(A, tu, b), independent_rss(A, ju, b)
    # the result holds u of the last kept correction: its rss is the last
    # history entry's
    assert abs(t_ind - got.error) <= 0.05 * t_ind + 1e-3 * tol
    assert np.abs(tu - ju).max() <= solution_bound(t_ind, j_ind, side)
    return got


def check_host_built(side: int, kw: dict, given: str | None):
    """A solver whose hierarchy is built on the host: ``given`` names the
    fine matrix passed as ``A_fine`` (None: ``device_setup=False`` with
    the Poisson operator)."""
    A = operator(given or "poisson", side)
    if given:
        kw = dict(kw, A_fine=A)
    js, ts = solvers(side, **kw)
    assert not ts.device_setup
    assert ts.hier.masks[0] is not None           # stored host masks
    assert (ts.w33 is None) == (given == "jump")
    # A_fine turns the fused kernels off, as in JAX; a host-built Poisson
    # hierarchy without A_fine keeps them (on the CPU: their plain
    # versions)
    assert ts.fused_packed == (given is None and "smoother" not in kw)
    assert ts.packed_loop == (given != "jump" and "smoother" not in kw
                              and side >= ts.packed_min_side)
    check_device_solve(js, ts, A, side)
    check_solve_ir(js, ts, A, side)
