"""The masked V-cycle's legs K10/K11 (ops/kernels/masked_cycle.py) on the
CPU: their plain twins against the unpacked cycle they stand in for (the
hierarchy's kinds set to the plain ``masked``), the wrappers' input
checks, no launch counted on the CPU, the levels the hierarchy's kinds
name ``masked_legs`` and the masked-cycle counters. The kernels themselves
are held to the plain cycle on the card (tests/test_torch_cuda.py
test_masked_legs_*)."""

import numpy as np
import pytest
import torch

from amg_tpu_torch import StructuredSolver, poisson, varcoef
from amg_tpu_torch import structured
from amg_tpu_torch.ops import kernels as K
from amg_tpu_torch.ops.kernels import masked_cycle as mc
from amg_tpu_torch.ops.rap import interp1d_dense, poisson_const_w33
from amg_tpu_torch.sparse.stencil import const_planes
from amg_tpu_torch.structured import (StencilHierarchy, _call_kind,
                                      _factor_coarse, _level_sides,
                                      build_stencil_hierarchy_device,
                                      build_stencil_hierarchy_planes,
                                      cycle_stencil, vcycle_stencil)
from amg_tpu_torch.utils import tracing

CPU = torch.device("cpu")
NINE_POINT = ((-0.5, -1.0, -0.5), (-1.0, 6.0, -1.0), (-0.5, -1.0, -0.5))
OTHER_POINT = ((0.0, -1.0, -0.5), (-1.0, 4.5, -1.0), (0.0, -1.0, 0.0))


def const_hierarchy(side: int, weights: str, smoother: str = "packed"
                    ) -> StencilHierarchy:
    """A hierarchy from ``side`` down to 3^2: the Poisson one ("five": the
    fine level 5-point, the Galerkin levels 9-point), or one weight tuple
    on every level ("nine", "other")."""
    if weights == "five":
        return build_stencil_hierarchy_device(side, smoother=smoother,
                                              device=CPU)
    w33 = {"nine": NINE_POINT, "other": OTHER_POINT}[weights]
    sides = _level_sides(side, None)
    lu, piv = _factor_coarse(const_planes(w33, sides[-1]), CPU)
    P1s = [interp1d_dense(sides[l], sides[l + 1], device=CPU)
           for l in range(len(sides) - 1)]
    return StencilHierarchy(sides, [w33] * len(sides), lu, piv, P1s,
                            smoother=smoother)


def plain_kinds(hier):
    """The hierarchy with plain kinds: its cycles take the plain ops."""
    hier.kinds = tuple("masked" if k in ("masked_legs", "masked_k12") else k
                       for k in hier.kinds)
    return hier


def fields(side: int, seed: int, zero_u: bool):
    rng = np.random.default_rng(seed)
    b = torch.as_tensor(rng.standard_normal((side, side)),
                        dtype=torch.float32)
    u = (torch.zeros_like(b) if zero_u else torch.as_tensor(
        rng.standard_normal((side, side)), dtype=torch.float32))
    return u, b


def legs(hier, u2, b2, pre, post, omega, symmetric):
    """K10 -> the coarsest LU -> K11 through the wrappers."""
    w33s = hier.w33s[:-1]
    bc, ws = mc.masked_down_leg(u2, b2, w33s, pre, omega, symmetric)
    uc = hier.coarse_solve(bc).contiguous()
    return mc.masked_up_leg(uc, b2, ws, w33s, post, omega, symmetric), ws


# (symmetric, omega, (pre, post), u = 0): the plain twin's two corners
CORNERS = [(True, 1.0, (1, 1), True), (False, 0.9, (2, 3), False)]


@pytest.mark.parametrize("symmetric,omega,sweeps,zero_u", CORNERS)
@pytest.mark.parametrize("weights", ["five", "nine", "other"])
@pytest.mark.parametrize("side", [127, 31, 7])
def test_plain_twin_is_vcycle_stencil(side, weights, symmetric, omega,
                                      sweeps, zero_u):
    hier = const_hierarchy(side, weights)
    u, b = fields(side, side, zero_u)
    got, ws = legs(hier, u, b, *sweeps, omega, symmetric)
    assert torch.equal(got, vcycle_stencil(hier, u, b, *sweeps, omega,
                                           symmetric))
    want = vcycle_stencil(plain_kinds(hier), u, b, *sweeps, omega, symmetric)
    assert torch.equal(got, want)
    assert ws.shape == (mc.workspace_floats(side, hier.n_levels - 1),)


def test_plain_twin_workspace_holds_the_levels():
    """The workspace: level l0's smoothed u, then each lower level's
    smoothed u and b, as the down leg leaves them."""
    hier = const_hierarchy(31, "five")
    u, b = fields(31, 3, False)
    bc, ws = mc.masked_down_leg(u, b, hier.w33s[:-1], 2, 0.9, True)
    u0 = structured._smooth(hier, 0, "masked", u, b, 2, 0.9, True)
    assert torch.equal(ws[:31 * 31].reshape(31, 31), u0)
    b1 = structured.restrict_mm(b - hier.levels[0].matvec2(u0),
                                hier.P1s[0])
    assert torch.equal(ws[31 * 31 + 15 * 15:31 * 31 + 2 * 15 * 15]
                       .reshape(15, 15), b1)
    assert bc.shape == (3, 3)


def test_input_checks_raise():
    hier = const_hierarchy(15, "five")
    w33s = hier.w33s[:-1]
    u, b = fields(15, 1, False)
    with pytest.raises(ValueError, match="shape"):
        mc.masked_down_leg(u[:, :13].contiguous(), b, w33s)
    with pytest.raises(TypeError, match="float32"):
        mc.masked_down_leg(u.double(), b, w33s)
    with pytest.raises(ValueError, match="expected cpu"):
        mc.masked_down_leg(u.to("meta"), b, w33s)
    with pytest.raises(ValueError, match="contiguous"):
        mc.masked_down_leg(u.t(), b, w33s)
    with pytest.raises(ValueError, match="constant weights"):
        mc.masked_down_leg(u, b, (None,) + w33s[1:])
    with pytest.raises(ValueError, match="does not fit"):
        mc.masked_down_leg(u, b, w33s + w33s)      # 15 -> 7 -> 3 -> 1 -> 0
    bc, ws = mc.masked_down_leg(u, b, w33s)
    with pytest.raises(ValueError, match="shape"):
        mc.masked_up_leg(bc, b, ws[:-1].contiguous(), w33s)
    with pytest.raises(ValueError, match="shape"):
        mc.masked_up_leg(bc[:2, :2].contiguous(), b, ws, w33s)
    big = torch.zeros((255, 255))
    with pytest.raises(ValueError, match="does not fit"):
        mc.masked_down_leg(big, big, poisson_const_w33(255, 6)[:-1])


def test_fits_is_the_shared_memory_rule():
    assert mc.smem_bytes(127) == 4 * (8 * 65 * 65 + 127 * 63) == 167204
    assert mc.fits(127, 5) and mc.fits(135, 3)  # 135 67 33, then 16
    assert not mc.fits(255, 6) and mc.smem_bytes(255) > mc.SMEM_LIMIT
    assert not mc.fits(127, 0) and not mc.fits(31, 5)  # 31 15 7 3 1 0
    assert mc.workspace_floats(127, 5) == 127 ** 2 + 2 * sum(
        n * n for n in (63, 31, 15, 7))


def test_no_launch_counted_on_the_cpu():
    """The wrappers and a whole CPU solve take the plain twin: no K10/K11
    launch; the masked cycles are counted as the plan names them, every
    one K10/K11's (the FMG start's cycle from each masked_legs level, then
    the fine V-cycle and 3 V-cycles a refine), none in plain ops."""
    K.reset_launch_counts()
    tracing.reset()
    hier = const_hierarchy(63, "nine")
    u, b = fields(63, 2, False)
    legs(hier, u, b, 1, 1, 1.0, True)
    s = StructuredSolver(255, device=CPU)
    res = s.solve_ir_fused(poisson.rhs(255, device=CPU).reshape(255, 255),
                           1e-7)
    c = K.launch_counts()
    assert c["masked_down_leg"] == c["masked_up_leg"] == 0
    got = tracing.counters()
    assert got["masked_cycles_kernel"] \
        == s.plan.count("masked_legs") + 1 + res.iterations > 0
    assert got["masked_cycles_plain"] == 0


def test_plain_masked_cycles_count_runs_of_masked_levels():
    """One count a cycle that reaches the masked levels: K10/K11's for a
    V-cycle through masked_legs levels, the plain ops' for a W-cycle
    there and for V- and W-cycles alike with plain kinds; none for a
    cycle without them."""
    hier = const_hierarchy(63, "five", smoother="masked")
    u, b = fields(63, 4, True)

    def counts(h, gamma=1):
        tracing.reset()
        cycle_stencil(h, u, b, gamma)
        c = tracing.counters()
        return c["masked_cycles_kernel"], c["masked_cycles_plain"]
    assert counts(hier) == (1, 0)
    assert counts(hier, 2) == (0, 1)
    plain_kinds(hier)
    for gamma in (1, 2):
        assert counts(hier, gamma) == (0, 1)
    assert counts(const_hierarchy(63, "five", smoother="strided")) == (0, 0)


def _legs(hier, gamma: int = 1) -> list:
    """Whether a cycle of ``gamma`` with f32 fields runs K10/K11 from each
    level: the level's kind for the visit."""
    f32 = torch.zeros(())
    return [_call_kind(hier, l, gamma, f32, f32) == "masked_legs"
            for l in range(hier.n_levels)]


def test_engagement_rule():
    """The kinds name masked_legs for the benchmark cells' masked entry
    (127^2 of the 4095^2 Poisson hierarchy) and every level below it; not
    for the level above (255^2, over the shared memory), the coarsest
    level, gamma = 2, plane levels, an f64 hierarchy, and the Chebyshev
    and strided smoothers."""
    hier = build_stencil_hierarchy_device(4095, smoother="packed", device=CPU)
    l127 = hier.sides.index(127)
    assert hier.sides[l127:] == (127, 63, 31, 15, 7, 3)
    assert all(_legs(hier)[l127:10])
    assert not _legs(hier)[l127 - 1]
    assert not _legs(hier)[10]
    assert not _legs(hier, gamma=2)[l127]
    assert _legs(const_hierarchy(127, "other"))[0]
    planes = build_stencil_hierarchy_planes(
        varcoef.jump_planes(127, device=CPU), device=CPU)
    assert not any(_legs(planes))
    f64 = build_stencil_hierarchy_device(127, dtype=torch.float64,
                                         device=CPU)
    assert not _legs(f64)[0]
    for sm in ("chebyshev", "strided"):
        h = build_stencil_hierarchy_device(127, smoother=sm, device=CPU)
        assert not any(_legs(h))
    fused = build_stencil_hierarchy_device(127, smoother="fused", device=CPU)
    assert _legs(fused)[0]
