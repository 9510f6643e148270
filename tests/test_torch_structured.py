"""amg_tpu_torch's hierarchy, V-cycle and StructuredSolver against
amg_tpu on the same inputs (CPU; the JAX side in f64 mode, x64).

Tolerances: the hierarchy's static data is compared exactly and the coarse
LU solve to 1e-12 (f64 roundoff of a 9 x 9 solve); the V-cycle to 1e-5
relative, the JAX test's bound for its fused legs (f32 reassociation);
the call counts of the kernel wrappers follow the level plan. Whole
solves against JAX are in tests/test_torch_solver.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amg_tpu import structured as jst
from amg_tpu.models import poisson as jpoisson

from amg_tpu_torch import structured as tst
from amg_tpu_torch.config import StructuredConfig
from amg_tpu_torch.interop import df32_from_numpy, hierarchy_from_numpy
from amg_tpu_torch.models import poisson as tpoisson
from amg_tpu_torch.ops.kernels import _build
from amg_tpu_torch.utils import tracing

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _jax_hier(side, dtype=jnp.float64):
    return jst.build_stencil_hierarchy_device(side, dtype=dtype,
                                              smoother="packed")


@pytest.mark.parametrize("side", [63, 255])
def test_hierarchy_matches_jax(side):
    jh = _jax_hier(side)
    th = tst.build_stencil_hierarchy_device(side, dtype=torch.float64,
                                           device=CPU)
    assert th.sides == tuple(jh.sides)
    assert th.w33s == tuple(lv.w33 for lv in jh.levels)
    assert th.n_levels == tst.max_levels_for_side(side) == len(jh.sides)
    for tP, jP in zip(th.P1s, jh.P1s):
        np.testing.assert_array_equal(tP.numpy(), np.asarray(jP))
    nc = th.sides[-1]
    b = np.random.default_rng(side).standard_normal((nc, nc))
    want = jax.scipy.linalg.lu_solve((jh.coarse_lu, jh.coarse_piv),
                                     jnp.asarray(b).reshape(-1))
    got = th.coarse_solve(torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy().reshape(-1), np.asarray(want),
                               rtol=1e-12, atol=1e-12)


def test_interop_round_trip():
    side = 127
    jh = _jax_hier(side)
    th = hierarchy_from_numpy(
        jh.sides, [lv.w33 for lv in jh.levels], np.asarray(jh.coarse_lu),
        np.asarray(jh.coarse_piv), [np.asarray(P) for P in jh.P1s],
        device=CPU)
    own = tst.build_stencil_hierarchy_device(side, dtype=torch.float64,
                                           device=CPU)
    assert th.sides == own.sides and th.w33s == own.w33s
    assert th.coarse_piv.dtype == torch.int32
    # 0-based JAX pivots became 1-based LAPACK pivots
    np.testing.assert_array_equal(th.coarse_piv.numpy(),
                                  np.asarray(jh.coarse_piv) + 1)
    b2 = tpoisson.rhs(side, device=CPU).reshape(side, side)
    u_interop = tst.vcycle_packed(th, torch.zeros_like(b2), b2, min_side=0)
    u_own = tst.vcycle_packed(own, torch.zeros_like(b2), b2, min_side=0)
    np.testing.assert_allclose(u_interop.numpy(), u_own.numpy(),
                               rtol=1e-12, atol=1e-14)
    hi = np.random.default_rng(0).standard_normal((4, 8, 8)).astype(
        np.float32)
    lo = (hi * 1e-8).astype(np.float32)
    d = df32_from_numpy(hi, lo, device=CPU)
    np.testing.assert_array_equal(d.hi.numpy(), hi)
    np.testing.assert_array_equal(d.lo.numpy(), lo)
    with pytest.raises(ValueError):
        df32_from_numpy(hi.astype(np.float64), lo)


def test_vcycle_legs_match_jax_fused(monkeypatch):
    """vcycle_packed with the leg kernels' plain versions (threshold
    lowered to 200 so that side 255 takes them) against JAX's
    vcycle_packed(fused=True) with its Pallas legs in interpret mode (the
    tests/test_packed_cycle.py pattern)."""
    from unittest import mock

    from amg_tpu.ops.pallas import packed_cycle, packed_rbgs

    side = 255
    jh = _jax_hier(side, jnp.float32)
    b_np = np.asarray(jpoisson.rhs(side, dtype=jnp.float64),
                      dtype=np.float32).reshape(side, side)
    b2 = jnp.asarray(b_np)
    orig_sweep = packed_rbgs.fused_gs4_sweep_packed
    orig_down = packed_cycle.fused_down_leg_packed
    orig_up = packed_cycle.fused_up_leg_packed
    with mock.patch.object(jst, "FUSED_PACKED_MIN_SIDE", 200), \
            mock.patch.object(jst, "_mosaic_ok", lambda: True), \
            mock.patch(
                "amg_tpu.ops.pallas.packed_rbgs.fused_gs4_sweep_packed",
                new=lambda *a, **k: orig_sweep(
                    *a, **{**k, "interpret": True})), \
            mock.patch(
                "amg_tpu.ops.pallas.packed_cycle.fused_down_leg_packed",
                new=lambda *a, **k: orig_down(
                    *a, **{**k, "interpret": True})), \
            mock.patch(
                "amg_tpu.ops.pallas.packed_cycle.fused_up_leg_packed",
                new=lambda *a, **k: orig_up(*a, **{**k, "interpret": True})):
        want = np.asarray(jst.vcycle_packed(jh, jnp.zeros_like(b2), b2,
                                            min_side=100, fused=True))

    monkeypatch.setattr(tst, "FUSED_PACKED_MIN_SIDE", 200)
    th = tst.build_stencil_hierarchy_device(side, device=CPU)
    plan = tst.level_plan(th, 1, 1, 100, True)
    assert plan[:2] == ("legs", "packed")
    tb = torch.as_tensor(b_np)
    got = tst.vcycle_packed(th, torch.zeros_like(tb), tb, min_side=100,
                            fused=True).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
    assert _build.library.cache_info().currsize == 0


def _counting(monkeypatch, name):
    calls = []
    orig = getattr(tst, name)

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(tst, name, counted)
    return calls


@pytest.mark.parametrize("smoother,sweeps", [("auto", 1), ("auto", 2),
                                             ("packed", 1)])
def test_kernel_call_counts_follow_the_plan(monkeypatch, smoother, sweeps):
    """With the fused threshold at the fine side, one solve calls the legs
    1 + 3 it times (FMG fine pass + 3 cycles per refine), the df32
    residual it + 1 times, and, with two sweeps, the fused sweep
    4 (1 + 3 it) times: the launch totals chip_smoke.py asserts on the
    card. An explicit smoother="packed" keeps the plain packed ops (as in
    JAX) and calls no kernel wrapper."""
    side = 255
    monkeypatch.setattr(tst, "FUSED_PACKED_MIN_SIDE", side)
    counts = {n: _counting(monkeypatch, n) for n in (
        "fused_gs4_sweep_packed", "fused_down_leg_packed",
        "fused_up_leg_packed", "fused_df_residual_rss")}
    s = tst.StructuredSolver(side, smoother=smoother, pre_sweeps=sweeps,
                             post_sweeps=sweeps, device=CPU)
    b2 = tpoisson.rhs(side, device=CPU).reshape(side, side)
    res = s.solve_ir_fused(b2, tolerance=1e-7)
    it = res.iterations // s.cycles_per_refine
    assert res.converged and it >= 1
    n = {k: len(v) for k, v in counts.items()}
    if smoother == "packed":
        assert "legs" not in s.plan and not any(n.values())
        return
    assert s.plan[0] == ("legs" if sweeps == 1 else "sweep")
    assert n["fused_df_residual_rss"] == it + 1
    if sweeps == 1:
        assert n["fused_down_leg_packed"] == n["fused_up_leg_packed"] \
            == 1 + 3 * it
        assert n["fused_gs4_sweep_packed"] == 0
    else:
        assert n["fused_gs4_sweep_packed"] == 4 * (1 + 3 * it)
        assert n["fused_down_leg_packed"] == 0


def test_level_plan_at_production_sides():
    """Fused levels: split from 8191 up (JAX's split level at M = 4096),
    legs on every other constant packed level, 255 and up, the masked
    legs K10/K11 from 127 down; so 8191 is one split level and five legs,
    and no level runs the plain packed ops."""
    for side, split, legs in ((1023, 0, 3), (4095, 0, 5), (8191, 1, 5)):
        # the hierarchy's shapes alone, on the meta device
        hier = tst.build_stencil_hierarchy_device(side, device="meta")
        plan = tst.level_plan(hier, 1, 1, tst.PACKED_MIN_SIDE, True)
        assert plan[:split] == ("split",) * split
        assert plan.count("split") == split and plan.count("legs") == legs
        assert plan[split:split + legs] == ("legs",) * legs
        assert hier.sides[split + legs] == 127
        assert set(plan[split + legs:-1]) == {"masked_legs"}
        assert plan[-1] == "direct" and not {"sweep", "packed"} & set(plan)
        assert not {"legs", "split"} & set(
            tst.level_plan(hier, 1, 1, 200, False))


@pytest.mark.parametrize("sweeps", [1, 2])
@pytest.mark.parametrize("side", [511, 1023])
def test_fused_packed_levels_solve_as_the_plain_ones(monkeypatch, side,
                                                     sweeps):
    """Every constant packed level from FUSED_PACKED_MIN_SIDE up takes the
    fused kernels (the legs with one sweep, K1 with two). On the CPU their
    plain twins are the plain packed ops in the same order, so a solve
    returns u, the stats and the iterations of the plan with those levels
    forced to the plain packed ops, bit for bit. With min_side 100 the
    127^2 level is packed too, below the fused threshold: the plain
    visits are its own, one a V-cycle that reaches it (the FMG start runs
    one from each level below the fine one, then the fine one)."""
    s = tst.StructuredSolver(side, packed_min_side=100, pre_sweeps=sweeps,
                             post_sweeps=sweeps, device=CPU)
    b2 = tpoisson.rhs(side, device=CPU).reshape(side, side)
    j127 = s.hier.sides.index(127)
    fused = "legs" if sweeps == 1 else "sweep"
    assert s.plan[:j127 + 1] == (fused,) * j127 + ("packed",)

    def solve():
        tracing.reset()
        res = s.solve_ir_fused(b2, tolerance=1e-7)
        c = tracing.report()["counters"]
        return res, (c["packed_levels_kernel"], c["packed_levels_plain"])

    res, got = solve()
    with monkeypatch.context() as m:
        m.setattr(tst, "FUSED_PACKED_MIN_SIDE", side + 1)
        assert s.plan[:j127 + 1] == ("packed",) * (j127 + 1)
        ref, want = solve()
    assert res.converged and res.iterations == ref.iterations
    assert torch.equal(res.u, ref.u)
    assert (res.error, res.history) == (ref.error, ref.history)
    it = res.iterations // s.cycles_per_refine
    visits = [j + 1 + s.cycles_per_refine * it for j in range(j127 + 1)]
    assert got == (sum(visits[:-1]), visits[-1])
    assert want == (0, sum(visits))


def test_budget_exhaustion_and_rtol():
    side = 255
    s = tst.StructuredSolver(side, device=CPU)
    b2 = tpoisson.rhs(side, device=CPU).reshape(side, side)
    _, stats = s.solve_ir_device(b2, tolerance=1e-7, n_refine=1)
    err, it = stats.tolist()
    assert it == 1 and err > 1e-7     # recomputed after the last refine
    res = s.solve_ir_fused(b2, tolerance=0.0, rtol=1e-10)
    assert res.converged and res.error > 0.0


@pytest.mark.parametrize("kwargs", [
    {"smoother": "chebyshev"}, {"fmg": False}, {"A_fine": "poisson"},
    {"smoother": "strided"}, {"smoother": "masked"},
])
def test_unported_options_raise(kwargs):
    """The options the port once refused now build and solve (against JAX:
    tests/test_torch_solver_*.py); config=, once refused too, gives what
    the arguments leave None and never overrides an explicit option."""
    side = 255
    if "A_fine" in kwargs:
        kwargs = {"A_fine": tpoisson.laplacian_scipy(side)}
    c = tst.StructuredSolver(side, device=CPU, config=StructuredConfig(
        smoother="packed", cycles_per_refine=2), **kwargs)
    assert c.cycles_per_refine == 2
    assert c.smoother == kwargs.get("smoother", "packed")
    s = tst.StructuredSolver(side, device=CPU, **kwargs)
    res = s.solve_ir_fused(tpoisson.rhs(side, device=CPU).reshape(side, side),
                           tolerance=1e-7)
    assert res.converged and res.error <= 1e-7


def test_unported_entry_points_raise():
    """solve_ir, once refused, runs the host-stepped refine; the
    prepared-rhs path still refuses a solver without the packed loop, and
    an unknown precision or smoother raises."""
    s = tst.StructuredSolver(255, device=CPU)
    res = s.solve_ir(tpoisson.rhs(255, device=CPU).reshape(255, 255))
    assert res.converged and res.error <= 1e-7
    assert res.iterations == s.cycles_per_refine * (len(res.history) - 1)
    with pytest.raises(ValueError):        # below packed_min_side
        tst.StructuredSolver(127, device=CPU).prepare_b(
            tpoisson.rhs(127, device=CPU).reshape(127, 127))
    with pytest.raises(ValueError):        # an unpacked smoother
        tst.StructuredSolver(255, smoother="masked", device=CPU).prepare_b(
            tpoisson.rhs(255, device=CPU).reshape(255, 255))
    with pytest.raises(ValueError):
        tst.StructuredSolver(255, precision="f16", device=CPU)
    with pytest.raises(ValueError):
        tst.StructuredSolver(255, smoother="jacobi", device=CPU)


def test_warmup_refine_step():
    s = tst.StructuredSolver(127, device=CPU)
    s.warmup(refine_step=True)
    z = torch.zeros((127, 127), dtype=torch.float64)
    u, err = s._refine_step(z, z)
    assert float(err) == 0.0 and float(u.abs().max()) == 0.0
    assert float(s._residual_rss(z, z)) == 0.0


def _default_device_calls():
    from amg_tpu_torch.models import varcoef as tvar
    return {
        "StructuredSolver": lambda: tst.StructuredSolver(63),
        "build_stencil_hierarchy_device":
            lambda: tst.build_stencil_hierarchy_device(63),
        "build_stencil_hierarchy_planes":
            lambda: tst.build_stencil_hierarchy_planes(
                torch.zeros(3, 3, 63, 63)),
        "build_stencil_hierarchy":
            lambda: tst.build_stencil_hierarchy(31),
        "build_fine_stencil_f64": lambda: tst.build_fine_stencil_f64(31),
        "solve_stencil": lambda: tst.solve_stencil(
            tst.build_stencil_hierarchy(31, device=CPU),
            torch.zeros(31, 31)),
        "solve_ir": lambda: tst.solve_ir(31, torch.zeros(31, 31)),
        "poisson.rhs": lambda: tpoisson.rhs(63),
        "varcoef.jump_planes": lambda: tvar.jump_planes(63),
    }


@pytest.mark.parametrize("entry", list(_default_device_calls()))
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """With no device given, an entry point means "cuda": without a CUDA
    device it raises and names device="cpu", it never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _default_device_calls()[entry]()
