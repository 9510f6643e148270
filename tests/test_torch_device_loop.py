"""The device loops in JAX's cond/body form (``ops/kernels/graph_loop.py``)
on the CPU, where the host driver runs the same pieces the card's graph
replays.

(a) Each loop -- StructuredSolver's packed df32 loop (constant 127^2 with
    packed_min_side 100, and 255^2), its unpacked df32 and f64 loops
    (jump 127^2) and solve_pcg_device (255^2, f64) -- gives the host
    loops it replaced (copied below as ``host_*``) bitwise: the same
    pieces in the same order. Against JAX's solve_ir_device /
    solve_pcg_device on the same inputs: the same refine or iteration
    count, and the tolerances of tests/test_torch_solver*.py (the two
    solutions within the bound their residuals give, the f32 cycles
    rounding in each framework's own order) and tests/test_torch_krylov.py
    (PCG in f64: u within 1e-10 of max|u|). The rtol exit and the
    exhausted budget are cases of both. The unpacked and f64 loops'
    JAX cases are in tests/test_torch_device_loop_jax.py (a file of
    their own, so the test workers run the two halves side by side).
(b) The pieces and the condition issue no host read: a dispatch mode that
    raises on ``aten._local_scalar_dense`` (float(), .item(), bool()) and
    ``aten.lift_fresh`` (torch.tensor of a host value) wraps one pass of
    every piece and each mode of the condition.
(c) The condition (did, keep, it) as a plain function against the
    condition kernel's logic, over the edge cases.

Also the launch bookkeeping the graph path needs: the capture tally, the
credit of a graph's device counts, and K4's per-stream counter.
"""

import math
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from amg_tpu import krylov as jk
from amg_tpu import structured as jst
from amg_tpu.models import poisson as jpoisson
from amg_tpu.models import varcoef as jvar

from amg_tpu_torch import krylov as tk
from amg_tpu_torch import structured as tst
from amg_tpu_torch.ops.doublefloat import (DF32, df_add_f32, df_rss,
                                           df_rss_fast)
from amg_tpu_torch.ops.kernels import _build, graph_loop, packed_df
from amg_tpu_torch.ops.kernels.graph_loop import (FINAL, START, STEP,
                                                  STEP_IF, loop_condition)
from amg_tpu_torch.utils.metrics import rss_from_residual

torch.set_num_threads(1)
CPU = torch.device("cpu")
SOL_RSS_RTOL = 0.1        # an unconverged final rss, JAX against the port
PCG_U_RTOL = 1e-10        # tests/test_torch_krylov.py, f64


# -- the host loops the cond/body form replaced ------------------------------

def _stats(final, it):
    return torch.stack([final.to(torch.float64),
                        torch.tensor(float(it), dtype=torch.float64)])


def host_packed(s, b4_df, tolerance, n_refine, rtol):
    tol_eff = tolerance
    if rtol > 0.0:
        tol_eff = max(tolerance, rtol * float(df_rss_fast(b4_df)))
    u4 = s._fmg_start(b4_df)
    err = float("inf")
    err_t = None
    it = 0
    while err > tol_eff and it < n_refine:
        r_hi, err_t = s._residual_hi_rss(b4_df, u4)
        err = float(err_t)
        if err > tol_eff:
            e4 = torch.zeros_like(r_hi)
            for _ in range(s.cycles_per_refine):
                e4 = s._vcycle(e4, r_hi, packed_in=True)
            u4 = df_add_f32(u4, e4)
            it += 1
    if err > tol_eff:
        err_t = s._residual_hi_rss(b4_df, u4)[1]
    return u4, _stats(err_t, it)


def host_unpacked(s, b2_f64, tolerance, n_refine, rtol):
    b_df = DF32.from_f64(b2_f64)
    tol_eff = tolerance
    if rtol > 0.0:
        tol_eff = max(tolerance, rtol * float(df_rss_fast(b_df)))
    u = DF32.from_f32(s._fmg(b_df.hi))
    err = float("inf")
    it = 0
    while err > tol_eff and it < n_refine:
        r = s._df_residual(b_df, u)
        err = float(df_rss_fast(r))
        u = df_add_f32(u, s._cycles(r.hi))
        it += 1
    final = df_rss(s._df_residual(b_df, u))
    return u.to_f64(), _stats(final, it)


def host_f64(s, b64, tolerance, n_refine, rtol):
    tol_eff = tolerance
    if rtol > 0.0:
        tol_eff = max(tolerance, rtol * float(rss_from_residual(b64)))
    u = s._fmg(b64.to(torch.float32)).to(torch.float64)
    err = float("inf")
    it = 0
    while err > tol_eff and it < n_refine:
        r = b64 - s.A64.matvec2(u)
        err = float(rss_from_residual(r))
        u = u + s._cycles(r.to(torch.float32)).to(torch.float64)
        it += 1
    final = rss_from_residual(b64 - s.A64.matvec2(u))
    return u, _stats(final, it)


def host_pcg(hier, b2, tolerance, n_iters, fused=False, min_side=None):
    A = hier.levels[0]

    def A_neg(x):
        return -A.matvec2(x)

    precond = tk._preconditioner(hier, fused, min_side)
    tol = tk._tolerance(tolerance, b2.dtype)
    r = -b2
    z = precond(r)
    u, p, rz = torch.zeros_like(b2), z, tk._dot(r, z)
    err = rss_from_residual(r)
    it = 0
    while float(err) > tol and it < n_iters:
        u, r, z, p, rz = tk._step(A_neg, precond, u, r, z, p, rz)
        err = rss_from_residual(r)
        it += 1
    return u, torch.stack([err, torch.tensor(float(it), dtype=b2.dtype)])


# -- (a) the loops against the host loops and against JAX --------------------

# (id, side, StructuredSolver options, jump operator, tol, n_refine, rtol,
# the loop it runs)
SOLVES = [
    ("const127-packed", 127, {"packed_min_side": 100}, False, 1e-7, 40,
     0.0, "packed"),
    ("const255-packed", 255, {}, False, 1e-7, 40, 0.0, "packed"),
    ("const255-budget", 255, {}, False, 1e-7, 1, 0.0, "packed"),
    ("const255-rtol", 255, {}, False, 1e-12, 40, 1e-6, "packed"),
    ("jump127-df32", 127, {}, True, 1e-7, 40, 0.0, "unpacked"),
    ("jump127-df32-budget", 127, {}, True, 1e-7, 2, 0.0, "unpacked"),
    ("jump127-df32-rtol", 127, {}, True, 1e-12, 40, 1e-8, "unpacked"),
    ("jump127-f64", 127, {"precision": "f64"}, True, 1e-7, 40, 0.0, "f64"),
    ("jump127-f64-budget", 127, {"precision": "f64"}, True, 1e-7, 2, 0.0,
     "f64"),
    ("jump127-f64-rtol", 127, {"precision": "f64"}, True, 1e-12, 40, 1e-8,
     "f64"),
]
SOLVE_IDS = [c[0] for c in SOLVES]


def _rhs(side):
    return np.asarray(jpoisson.rhs(side, dtype=jnp.float64)).reshape(side,
                                                                      side)


def _planes(side):
    return np.asarray(jvar.jump_planes(side, a_in=100.0))


def _port(side, kw, jump):
    if jump:
        kw = dict(kw, A_planes=torch.tensor(_planes(side)))
    return tst.StructuredSolver(side, device=CPU, **kw)


def _f64_rss(u, b, planes):
    """Independent f64 rss of b - A u (numpy, the planes widened)."""
    n = u.shape[0]
    up = np.pad(u, 1)
    Au = sum(planes[dj + 1, di + 1].astype(np.float64)
             * up[1 + dj:1 + dj + n, 1 + di:1 + di + n]
             for dj in (-1, 0, 1) for di in (-1, 0, 1))
    return float(((b - Au) ** 2).sum())


def _const_planes(side):
    w = np.asarray(tst.poisson_const_w33(side, 1)[0], dtype=np.float64)
    return np.broadcast_to(w[:, :, None, None], (3, 3, side, side))


def _bound(rss1, rss2, side):
    """tests/test_torch_solver_cases.py solution_bound."""
    h = 2.0 / (side + 1)
    lam = 8.0 * np.sin(np.pi * h / 4.0) ** 2 / (h * h)
    return (np.sqrt(rss1) + np.sqrt(rss2)) / lam


@pytest.mark.parametrize("case", SOLVES, ids=SOLVE_IDS)
def test_loop_gives_the_host_loop_bitwise(case):
    _, side, kw, jump, tol, n, rtol, loop = case
    s = _port(side, kw, jump)
    assert (s.precision == "f64") == (loop == "f64")
    assert s.packed_loop == (loop == "packed")
    b = torch.tensor(_rhs(side))
    if loop == "packed":
        b4 = s.prepare_b(b)
        u4, stats = s.solve_ir_device_prepared(b4, tol, n, rtol)
        h4, hstats = host_packed(s, b4, tol, n, rtol)
        assert torch.equal(u4.hi, h4.hi) and torch.equal(u4.lo, h4.lo)
        assert torch.equal(stats, hstats)
        want_u = s.finalize_u(h4)
    else:
        host = host_f64 if loop == "f64" else host_unpacked
        want_u, hstats = host(s, b, tol, n, rtol)
    u, stats = s.solve_ir_device(b, tol, n, rtol)
    assert torch.equal(u, want_u) and torch.equal(stats, hstats)
    assert stats.dtype == torch.float64 and stats.shape == (2,)
    # the oracle entry the card's checks call: the same pieces, host-driven
    hu, hstats3 = s._solve_device(b, tol, n, rtol, host=True)
    assert torch.equal(hu, u) and torch.equal(hstats3[:2], stats)
    res = s.solve_ir_fused(b, tol, n, rtol)
    err, it = hstats.tolist()
    assert res.iterations == int(it) * s.cycles_per_refine
    assert res.error == err
    tol_eff = max(tol, rtol * float(df_rss_fast(
        b4 if loop == "packed" else DF32.from_f64(b)))) \
        if loop != "f64" and rtol > 0 else \
        (max(tol, rtol * float(rss_from_residual(b))) if rtol > 0 else tol)
    assert res.converged == (err <= tol_eff)
    if n < 40:
        assert int(it) == n and not res.converged     # budget exhausted
    if rtol > 0:
        assert res.converged and err > tol            # the rtol exit


def check_against_jax(case):
    """(a) against JAX: the case's solve through both packages."""
    _, side, kw, jump, tol, n, rtol, loop = case
    b = _rhs(side)
    jkw = dict(kw)
    if jump:
        jkw["A_planes"] = jnp.asarray(_planes(side))
    js = jst.StructuredSolver(side, **jkw)
    ju, jstats = js.solve_ir_device(jnp.asarray(b), tolerance=tol,
                                    n_refine=n, rtol=rtol)
    j_rss, j_it = (float(x) for x in np.asarray(jstats))
    ts = _port(side, kw, jump)
    tu, tstats = ts.solve_ir_device(torch.tensor(b), tolerance=tol,
                                    n_refine=n, rtol=rtol)
    t_rss, t_it = tstats.tolist()
    assert int(t_it) == int(j_it)
    planes = _planes(side) if jump else _const_planes(side)
    tu, ju = tu.numpy(), np.asarray(ju)
    t_ind, j_ind = _f64_rss(tu, b, planes), _f64_rss(ju, b, planes)
    assert np.abs(tu - ju).max() <= _bound(t_ind, j_ind, side)
    if n < 40:
        assert int(t_it) == n and t_rss > tol and j_rss > tol
        assert abs(t_rss - j_rss) <= SOL_RSS_RTOL * j_rss
    elif rtol == 0:
        assert t_rss <= tol and j_rss <= tol


PACKED = [c for c in SOLVES if c[7] == "packed"]


@pytest.mark.parametrize("case", PACKED, ids=[c[0] for c in PACKED])
def test_loop_matches_jax(case):
    check_against_jax(case)


# (id, tolerance, n_iters): f64 at 255^2 on the packed hierarchy
PCGS = [("converged", 1e-9, 50), ("budget", 1e-9, 2)]


@pytest.mark.parametrize("case", PCGS, ids=[c[0] for c in PCGS])
def test_pcg_loop_gives_the_host_loop_and_jax(case):
    _, tol, n = case
    side = 255
    b = _rhs(side)
    th = tst.build_stencil_hierarchy_device(side, dtype=torch.float64,
                                            device=CPU, smoother="packed")
    tb = torch.tensor(b)
    u, stats = tk.solve_pcg_device(th, tb, tolerance=tol, n_iters=n)
    hu, hstats = host_pcg(th, tb, tol, n)
    assert torch.equal(u, hu) and torch.equal(stats, hstats)
    ou, ostats = tk._solve_pcg_device(th, tb, tol, n, False, None,
                                      host=True)
    assert torch.equal(ou, u) and torch.equal(ostats, stats)
    jh = jst.build_stencil_hierarchy_device(side, dtype=jnp.float64,
                                            smoother="packed")
    ju, jstats = jk.solve_pcg_device(jh, jnp.asarray(b), tolerance=tol,
                                     n_iters=n)
    j_err, j_it = np.asarray(jstats)
    t_err, t_it = stats.tolist()
    assert int(t_it) == int(j_it)
    ju = np.asarray(ju)
    assert np.abs(u.numpy() - ju).max() <= PCG_U_RTOL * np.abs(ju).max()
    if n < 50:
        assert int(t_it) == n and t_err > tol
    else:
        assert t_err <= tol


def test_pcg_f32_fused_gives_the_host_loop():
    """The f32 fused PCG of the card's main path: the err and the
    tolerance reach the condition as f64, exactly."""
    side = 255
    th = tst.build_stencil_hierarchy_device(side, device=CPU,
                                            smoother="packed")
    tb = torch.tensor(_rhs(side), dtype=torch.float32)
    u, stats = tk.solve_pcg_device(th, tb, tolerance=1e-5, n_iters=50,
                                   fused=True)
    hu, hstats = host_pcg(th, tb, 1e-5, 50, fused=True)
    assert torch.equal(u, hu) and torch.equal(stats, hstats)
    assert stats.dtype == torch.float32


# -- (b) no host read in the pieces or the condition -------------------------

class NoHostRead(TorchDispatchMode):
    """Raises on the ops that read a tensor on the host or make one from a
    host value."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default,
                    torch.ops.aten.lift_fresh.default):
            raise AssertionError(f"host read: {func}")
        return func(*args, **(kwargs or {}))


def test_no_host_read_mode_catches_reads():
    t = torch.ones(())
    with NoHostRead():
        with pytest.raises(AssertionError):
            float(t)
        with pytest.raises(AssertionError):
            bool(t > 0)
        with pytest.raises(AssertionError):
            torch.tensor(1.0)


def _every_piece(L):
    pre, post = L.programs["device"] if hasattr(L, "programs") else L.program
    loop = L.loop
    return [pre, loop.body, loop.refine, loop.final, post]


@pytest.mark.parametrize("case", [SOLVES[1], SOLVES[4], SOLVES[7]],
                         ids=["packed", "unpacked", "f64"])
def test_solver_pieces_read_nothing_on_the_host(case):
    _, side, kw, jump, tol, n, rtol, loop = case
    s = _port(side, kw, jump)
    L = s._loop_state()
    L.b64.copy_(torch.tensor(_rhs(side)))
    L.tol_in.fill_(tol)
    L.n.fill_(n)
    programs = [L.programs["device"]] + ([L.programs["prepared"]]
                                         if loop == "packed" else [])
    with NoHostRead():
        for pre, post in programs:
            for fn in (pre, L.loop.body, L.loop.refine, L.loop.final, post):
                if fn is not None:
                    fn()
            for mode in (START, STEP, STEP_IF, FINAL):
                loop_condition(L.err, L.tol_eff, L.it, L.n, mode)
    assert math.isfinite(float(L.stats[0]))


def test_pcg_pieces_read_nothing_on_the_host():
    side = 255
    th = tst.build_stencil_hierarchy_device(side, device=CPU,
                                            smoother="packed")
    tb = torch.tensor(_rhs(side), dtype=torch.float32)
    L = tk._pcg_loop(th, tb.shape, tb.dtype, CPU, True, None)
    L.b.copy_(tb)
    L.tol.fill_(1e-5)
    L.n.fill_(50)
    with NoHostRead():
        for fn in _every_piece(L):
            if fn is not None:
                fn()
        for mode in (START, STEP):
            loop_condition(L.err64, L.tol64, L.it, L.n, mode)
    assert int(L.it) == 1             # START leaves it, STEP adds 1


# -- (c) the condition -------------------------------------------------------

def kernel_logic(err, tol, it, n, mode):
    """csrc/graph_loop.cu loop_condition in Python: (branch, loop, it) with
    None for a handle the mode does not set."""
    above = err > tol
    if mode == START:
        return None, above and it < n, it
    if mode == FINAL:
        return above, None, it
    did = int(above) if mode == STEP_IF else 1
    it += did
    branch = bool(did) if mode == STEP_IF else None
    return branch, above and it < n, it


ERRS = [0.0, 1e-8, 1e-7, 2e-7, math.inf, math.nan]


@pytest.mark.parametrize("mode", [START, STEP, STEP_IF, FINAL],
                         ids=["start", "step", "step_if", "final"])
@pytest.mark.parametrize("err", ERRS, ids=[str(e) for e in ERRS])
def test_condition_matches_the_kernel_logic(mode, err):
    for tol in (1e-7, 0.0, math.inf):
        for it0 in (0, 1, 39, 40):
            for n in (0, 1, 2, 40):
                it = torch.tensor(it0, dtype=torch.int32)
                did, keep = loop_condition(
                    torch.tensor(err, dtype=torch.float64),
                    torch.tensor(tol, dtype=torch.float64), it,
                    torch.tensor(n, dtype=torch.int32), mode)
                branch, loop, it_k = kernel_logic(err, tol, it0, n, mode)
                assert int(it) == it_k
                if branch is not None:
                    assert bool(did) == branch
                if loop is not None:
                    assert bool(keep) == loop
                if mode in (START, FINAL):
                    assert int(it) == it0


def _toy(refine: bool, final: bool, halve=0.5):
    """A toy loop: err halves each pass; refine and final count runs."""
    t = {"err": torch.zeros((), dtype=torch.float64),
         "tol": torch.zeros((), dtype=torch.float64),
         "it": torch.zeros((), dtype=torch.int32),
         "n": torch.zeros((), dtype=torch.int32)}
    runs = {"body": 0, "refine": 0, "final": 0}
    x = torch.zeros((), dtype=torch.float64)

    def body():
        runs["body"] += 1
        t["err"].copy_(x)
        x.mul_(halve)

    def count(k):
        def f():
            runs[k] += 1
        return f
    loop = graph_loop.DeviceLoop(body, count("refine") if refine else None,
                                 count("final") if final else None, **t)
    return loop, t, x, runs


@pytest.mark.parametrize("refine", [False, True], ids=["step", "step_if"])
@pytest.mark.parametrize("x0,tol,n", [(1.0, 0.1, 40), (1.0, 0.1, 2),
                                      (1.0, 0.1, 0), (0.05, 0.1, 40),
                                      (math.nan, 0.1, 40)])
def test_host_driver_runs_the_loop_semantics(refine, x0, tol, n):
    loop, t, x, runs = _toy(refine, refine)

    def pre():
        x.fill_(x0)
        t["err"].fill_(math.inf)
        t["it"].zero_()
        t["tol"].fill_(tol)
        t["n"].fill_(n)
    loop.run_host(pre, lambda: None)
    # the same loop written out (JAX's cond/body with the lagged err)
    err, it, passes, refines, xv = math.inf, 0, 0, 0, x0
    while err > tol and it < n:
        err, xv = xv, xv * 0.5
        passes += 1
        did = err > tol if refine else True
        it += did
        refines += did and refine
    assert runs["body"] == passes and int(t["it"]) == it
    assert runs["refine"] == refines
    assert runs["final"] == (int(err > tol) if refine else 0)


def test_graph_needs_a_card():
    loop, _, _, _ = _toy(True, True)
    with pytest.raises(ValueError):
        loop.graph(lambda: None, lambda: None)
    with pytest.raises(TypeError):
        graph_loop.DeviceLoop(lambda: None, err=torch.zeros(()),
                              tol=torch.zeros((), dtype=torch.float64),
                              it=torch.zeros((), dtype=torch.int32),
                              n=torch.zeros((), dtype=torch.int32))


# -- launch bookkeeping -------------------------------------------------------

class _Counter:
    __name__ = "toy"
    launches = 0


def test_capture_tally_defers_launches():
    c = _Counter()
    _build.count_launch(c)
    with _build.capture_tally() as tally:
        _build.count_launch(c)
        _build.count_launch(c)
    _build.count_launch(c)
    assert c.launches == 2 and tally[c] == 2
    _build.credit(tally, 3)
    assert c.launches == 8


def test_graph_settle_credits_each_piece_by_its_runs():
    """LoopGraph.settle: pre and post once a replay, body once a pass,
    refine once a refining pass, final once a recomputation, the
    condition kernel at start, each step and (with final) the final
    branch."""
    body, refine, pre, post, fin = (_Counter() for _ in range(5))
    g = graph_loop.LoopGraph.__new__(graph_loop.LoopGraph)
    g._pieces = {"pre": (None, Counter({pre: 2})),
                 "post": (None, Counter({post: 1})),
                 "body": (None, Counter({body: 1})),
                 "refine": (None, Counter({refine: 3})),
                 "final": ("captured", Counter({body: 1}))}
    g._settled = [0, 0, 0, 0]
    g._exec = None
    before = graph_loop.loop_condition.launches
    g.execs = torch.tensor([2, 7, 5, 1])          # 2 solves
    g.settle()
    assert (pre.launches, post.launches, refine.launches) == (4, 2, 15)
    assert body.launches == 7 + 1
    assert graph_loop.loop_condition.launches - before == 2 + 7 + 2
    g.settle()                                    # nothing new
    assert body.launches == 8


def test_k4_counter_keyed_by_stream():
    dev = CPU
    a = packed_df._counter(dev, 111)
    assert packed_df._counter(dev, 111) is a
    b = packed_df._counter(dev, 222)
    assert b is not a and int(a) == 0 == int(b)
    mine = packed_df.new_counter(dev)
    with packed_df.stream_counter(dev, 111, mine):
        assert packed_df._counter(dev, 111) is mine
        assert packed_df._counter(dev, 222) is b
    assert packed_df._counter(dev, 111) is a
    with packed_df.stream_counter(dev, 333, mine):
        assert packed_df._counter(dev, 333) is mine
    assert (dev.index, 333) not in packed_df._COUNTERS


def test_loop_inputs_are_checked():
    """The rhs goes into the loop's buffers by copy, which would broadcast
    a wrong shape: the entry points refuse it first."""
    side = 255
    s = tst.StructuredSolver(side, device=CPU)
    b = torch.tensor(_rhs(side))
    with pytest.raises(ValueError):
        s.solve_ir_device(b[:-1, :-1])
    with pytest.raises(ValueError):
        s.solve_ir_device(b[0])
    b4 = s.prepare_b(b)
    with pytest.raises(ValueError):
        s.solve_ir_device_prepared(DF32(hi=b4.hi[:, :-1], lo=b4.lo[:, :-1]))
    with pytest.raises(TypeError):
        s.solve_ir_device_prepared(DF32(hi=b4.hi.double(), lo=b4.lo))
