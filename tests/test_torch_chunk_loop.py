"""JAX's last single-process host loops over jitted programs, restated on
fixed buffers and run on the CPU under the host driver (the card's CUDA
graphs run the same pieces: tests/test_torch_cuda.py, chip_smoke.py
``graph_solves``):

* ``multigrid.solve`` / ``Multigrid.solve`` and ``solve_stencil``: one
  chunk of V-cycles between two reads of the rss (JAX's jitted
  ``cycle_chunk`` / ``chunk``; ``graph_loop.ChunkLoop``, kept with the
  hierarchy);
* ``StructuredSolver.solve_ir``: one refine a step (JAX's jitted
  ``refine_step``; ``StructuredSolver._refine_state``).

Each is held bitwise against the host loop it replaced (restated here
from the same steps: converged, out of budget, no checks, a remainder
chunk, a given u0, which the loop copies and leaves as it was), and
against amg_tpu's on the same inputs: the testlib run at 35^2 (35
V-cycles to 7.19199e-11; JAX's rss within 1e-9 and u within rtol 1e-9,
tests/test_torch_multigrid.py's bounds), ``solve_stencil`` on a carried
hierarchy (the check points equal, the history within 1e-6 and u within
1e-9 relative, tests/test_torch_host_hierarchy.py's) and ``solve_ir``
(tests/test_torch_solver_cases.py's ``check_solve_ir``).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amg_tpu import multigrid as jmg
from amg_tpu import structured as jst
from amg_tpu.models import poisson as jpoisson

from amg_tpu_torch import multigrid as tmg
from amg_tpu_torch import structured as tst
from amg_tpu_torch.interop import hierarchy_from_numpy
from amg_tpu_torch.models import poisson
from amg_tpu_torch.ops.smoothers import (MulticolorGaussSeidel,
                                         SparseGaussSeidel)
from amg_tpu_torch.ops.transfer import BilinearInterpolator2D

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_solver_cases import check_solve_ir, operator  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
RSS_RTOL = 1e-6
# (tolerance, every, n_iters): converged, out of budget with a remainder
# chunk, no checks at all, checks every cycle
CASES = [(1e-9, 2, 100), (0.0, 3, 7), (1e-9, 0, 5), (1e-9, 1, 6)]


def _old_loop(cycle, rss, u, b, tol, every, n_iters):
    """The host loop the chunk loops replaced: V-cycles between checks,
    one host read of the rss a check."""
    it, error, history = 0, 100.0, []
    while it < n_iters and error > tol:
        k = (min(every - (it % every), n_iters - it) if every
             else n_iters - it)
        for _ in range(k):
            u = cycle(u, b)
        it += k
        if every and it % every == 0:
            error = float(rss(u, b))
            history.append((it, error))
    return u, it, error, history


def _same(res, old):
    u, it, error, history = old
    assert torch.equal(res.u, u)
    assert (res.iterations, res.error, res.history) == (it, error, history)


@pytest.fixture(scope="module")
def bilinear():
    A, b = poisson.poisson2d(31, device=CPU)
    amg = tmg.Multigrid(BilinearInterpolator2D(31), MulticolorGaussSeidel(),
                        A, b, 4, 1e-9, 1, 100, device=CPU)
    return amg, A, b


@pytest.mark.parametrize("tol,every,n", CASES)
def test_multigrid_solve_bitwise_the_old_loop(bilinear, tol, every, n):
    amg, A, b = bilinear
    h, sm = amg.hierarchy, amg.smoother
    u0 = torch.from_numpy(np.random.default_rng(1).standard_normal(b.shape))
    kept = u0.clone()
    for start in (None, u0):
        res = tmg.solve(h, sm, b, start, tol, every, n)
        old = _old_loop(lambda u, bb: tmg.vcycle(h, sm, u, bb),
                        lambda u, bb: tmg.rss(A, u, bb),
                        torch.zeros_like(b) if start is None else start, b,
                        tol, every, n)
        _same(res, old)
        assert res.converged == (old[2] <= tol)
        host = tmg._solve(h, sm, b, start, tol, every, n, host=True)
        assert torch.equal(host.u, res.u) and host.history == res.history
    assert torch.equal(u0, kept) and res.u is not u0


def test_chunk_loops_live_with_the_hierarchy(capsys):
    """One loop for the smoother's options and the buffers' kind, reused
    by the next solve (another smoother object of the same options too),
    dropped when the hierarchy moves; display_error prints each check."""
    A, b = poisson.poisson2d(31, device=CPU)
    h = tmg.build_hierarchy(A, 3, BilinearInterpolator2D(31),
                            MulticolorGaussSeidel(), device=CPU)
    sm = MulticolorGaussSeidel()
    tmg.solve(h, sm, b, n_iters=4, compute_error_every_n_iters=2)
    res = tmg.solve(h, MulticolorGaussSeidel(), b, n_iters=3,
                    compute_error_every_n_iters=2, display_error=True)
    assert len(h.chunk_loops) == 1
    assert next(iter(h.chunk_loops.values())).graphs == {}  # the CPU's
    assert capsys.readouterr().out == "".join(
        f"Iter: {i} | Error: {e}\n" for i, e in res.history)
    tmg.solve(h, MulticolorGaussSeidel(omega=0.9), b, n_iters=2)
    assert len(h.chunk_loops) == 2
    h.to(CPU)
    assert h.chunk_loops == {}


def test_multigrid_object_bitwise_the_old_loop():
    """Multigrid.solve: the free solve from its stored iterate, which it
    then replaces; the second solve starts where the first ended."""
    A, b = poisson.poisson2d(31, device=CPU)
    amg = tmg.Multigrid(BilinearInterpolator2D(31), MulticolorGaussSeidel(),
                        A, b, 4, 1e-12, 2, 6, device=CPU)
    u = torch.zeros_like(b)
    for _ in range(2):
        res = amg.solve(verbose=False)
        old = _old_loop(
            lambda x, bb: tmg.vcycle(amg.hierarchy, amg.smoother, x, bb),
            lambda x, bb: tmg.rss(A, x, bb), u, amg.b, 1e-12, 2, 6)
        _same(res, old)
        assert torch.equal(amg.get_soln(0), res.u)
        u = res.u


def test_testlib_matches_jax():
    """The reference's testlib run (8 levels, symmetric GS, 1e-9 checked
    every 5): 35 V-cycles to 7.19199e-11 in both packages; then the free
    solve from a given u0 with a remainder chunk on both hierarchies."""
    A, b = poisson.poisson2d(35, device=CPU)
    jA, jb = jpoisson.poisson2d(35)
    amg = tmg.Multigrid(None, SparseGaussSeidel(), A, b, 8, 1e-9, 5, 100,
                        device=CPU)
    jamg = jmg.Multigrid(None, None, jA, jb, 8, 1e-9, 5, 100)
    res, jres = amg.solve(verbose=False), jamg.solve(verbose=False)
    assert res.converged and res.iterations == jres.iterations == 35
    assert res.error == pytest.approx(7.19199e-11, rel=1e-3)
    assert res.error == pytest.approx(jres.error, rel=1e-9)
    assert [i for i, _ in res.history] == [i for i, _ in jres.history]
    np.testing.assert_allclose(res.u.numpy(), np.asarray(jres.u), rtol=1e-9)
    u0 = np.random.default_rng(2).standard_normal(b.shape[0])
    kw = dict(tolerance=0.0, compute_error_every_n_iters=3, n_iters=7)
    got = tmg.solve(amg.hierarchy, amg.smoother, b, torch.from_numpy(u0),
                    **kw)
    want = jmg.solve(jamg.hierarchy, jamg.smoother, jb, jnp.asarray(u0),
                     **kw)
    assert got.iterations == want.iterations == 7
    assert [i for i, _ in got.history] == [i for i, _ in want.history]
    np.testing.assert_allclose([e for _, e in got.history],
                               [e for _, e in want.history], rtol=1e-9)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), rtol=1e-9)


def _carry(jh):
    """The port's hierarchy from a JAX host-built one's arrays."""
    return hierarchy_from_numpy(
        jh.sides, [lv.w33 for lv in jh.levels], np.asarray(jh.coarse_lu),
        np.asarray(jh.coarse_piv), [np.asarray(P) for P in jh.P1s],
        device=CPU, planes=[np.asarray(lv.c) for lv in jh.levels],
        smoother=jh.smoother, masks=[np.asarray(m) for m in jh.masks],
        lam_maxes=jh.lam_maxes)


@pytest.fixture(scope="module")
def stencil():
    side = 63
    jh = jst.build_stencil_hierarchy(side, dtype=jnp.float64)
    b = np.asarray(jpoisson.rhs(side)).reshape(side, side)
    return jh, _carry(jh), b


@pytest.mark.parametrize("tol,every,n", CASES)
def test_solve_stencil_bitwise_the_old_loop(stencil, tol, every, n):
    _, h, b = stencil
    b2 = torch.tensor(b)
    u0 = torch.from_numpy(np.random.default_rng(3).standard_normal(b.shape))
    kept = u0.clone()
    for start, kw in ((None, {}), (u0, dict(pre_sweeps=2, omega=0.9))):
        res = tst.solve_stencil(h, b2, start, tol, every, n, device=CPU,
                                **kw)
        S0 = h.levels[0]
        old = _old_loop(
            lambda u, bb: tst.vcycle_stencil(h, u, bb, kw.get(
                "pre_sweeps", 1), 1, kw.get("omega", 1.0), True),
            lambda u, bb: tst.rss_from_residual(bb - S0.matvec2(u)),
            torch.zeros_like(b2) if start is None else start, b2, tol,
            every, n)
        _same(res, old)
        host = tst._solve_stencil(h, b2, start, tol, every, n,
                                  kw.get("pre_sweeps", 1), 1,
                                  kw.get("omega", 1.0), True, CPU,
                                  host=True)
        assert torch.equal(host.u, res.u) and host.history == res.history
    assert torch.equal(u0, kept)
    assert len(h.chunk_loops) >= 2


@pytest.mark.parametrize("every,n,tol", [(1, 100, 1e-9), (4, 10, 0.0)])
def test_solve_stencil_matches_jax(stencil, every, n, tol):
    jh, h, b = stencil
    kw = dict(tolerance=tol, compute_error_every_n_iters=every, n_iters=n)
    want = jst.solve_stencil(jh, jnp.asarray(b), **kw)
    got = tst.solve_stencil(h, torch.tensor(b), device=CPU, **kw)
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    assert [i for i, _ in got.history] == [i for i, _ in want.history]
    floor = 1e-14 * float(np.sum(b * b))
    for (_, g), (_, w) in zip(got.history, want.history):
        if w > floor:
            assert abs(g - w) <= RSS_RTOL * w, (g, w)
    want_u = np.asarray(want.u)
    assert (np.abs(got.u.numpy() - want_u).max()
            <= 1e-9 * np.abs(want_u).max())


def _old_solve_ir(s, b2, tol, n_refine):
    """The host loop StructuredSolver.solve_ir's refine program
    replaced."""
    b64 = torch.as_tensor(b2)
    u = torch.zeros_like(b64)
    history, it, error = [], 0, float("inf")
    for _ in range(n_refine):
        u_next, err = s._refine_step(u, b64)
        error = float(err)
        history.append((it, error))
        if error <= tol:
            break
        u = u_next
        it += s.cycles_per_refine
    return u, it, error, history


def test_structured_solve_ir_bitwise_the_old_loop():
    side = 63
    s = tst.StructuredSolver(side, device=CPU)
    b2 = poisson.rhs(side, device=CPU).reshape(side, side)
    for tol, n in ((1e-9, 40), (1e-9, 2), (0.0, 1)):
        res = s.solve_ir(b2, tol, n)
        _same(res, _old_solve_ir(s, b2, tol, n))
        host = s._solve_ir(b2, tol, n, host=True)
        assert torch.equal(host.u, res.u) and host.history == res.history
    assert res.iterations == s.cycles_per_refine and len(res.history) == 1
    assert s._graphs == {}                  # the CPU: no graph
    s.warmup(refine_step=True)


def test_structured_solve_ir_matches_jax():
    side = 63
    A = operator("poisson", side)
    js = jst.StructuredSolver(side)
    ts = tst.StructuredSolver(side, device=CPU)
    res = check_solve_ir(js, ts, A, side)
    assert res.converged and res.history[-1][1] <= 1e-7
