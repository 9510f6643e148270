"""K12, the masked four-color sweep on planes (ops/kernels/rbgs.py
``masked_gs4_sweep_var``, csrc/rbgs_var.cu ``masked_var_sweep_kernel``),
on the CPU: the wrapper against ``gs4_sweep_masked``, its input checks,
the levels the hierarchy's kinds name ``masked_k12`` and what the unpacked
cycle does there: the sweep, the counters of variable-level visits and
the span's machinery. On CPU tensors the wrapper runs the plain sweep, so
the cycle's dispatch runs here as it runs on the card, and the plain
yardstick is the same hierarchy with plain kinds. The kernel itself is
held to the plain sweep on the card (tests/test_torch_cuda.py
test_masked_var_sweep_kernel and test_masked_var_sweep_in_the_solve)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from amg_tpu_torch import StructuredSolver, structured, varcoef
from amg_tpu_torch.ops import kernels as K
from amg_tpu_torch.ops.kernels.rbgs import masked_gs4_sweep_var
from amg_tpu_torch.ops.rap import poisson_const_w33, rap_stencil_planes
from amg_tpu_torch.sparse.stencil import (Stencil2D, color_masks,
                                          color_masks_iota, gs4_sweep_masked)
from amg_tpu_torch.structured import (_call_kind, build_stencil_hierarchy,
                                      build_stencil_hierarchy_device,
                                      build_stencil_hierarchy_planes,
                                      vcycle_stencil)
from amg_tpu_torch.utils import tracing

torch.set_num_threads(1)
CPU = torch.device("cpu")
# what a visit's kind reads of its fields
F32 = SimpleNamespace(dtype=torch.float32)
F64 = SimpleNamespace(dtype=torch.float64)


def _planes(kind: str, n: int) -> torch.Tensor:
    """Kellogg's f32 planes at side n, or a Galerkin level of them (the
    planes of side 2n + 1 coarsened once)."""
    if kind == "kellogg":
        return varcoef.kellogg_planes(n, torch.float32, device=CPU)
    return rap_stencil_planes(varcoef.kellogg_planes(2 * n + 1, torch.float32,
                                                     device=CPU))


def _fields(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.standard_normal((n, n)), dtype=torch.float32)
            for _ in range(2))


def _kellogg_hier(side: int, smoother: str, **kw):
    return build_stencil_hierarchy_planes(
        varcoef.kellogg_planes(side, device=CPU), smoother=smoother,
        device=CPU, **kw)


def _engages(hier, fields=F32) -> list:
    """Whether a V-cycle's visit of each level with these fields sweeps it
    with K12."""
    return [_call_kind(hier, l, 1, fields, fields) == "masked_k12"
            for l in range(hier.n_levels)]


def plain_kinds(hier):
    """The hierarchy with plain kinds: its cycles take the plain ops."""
    hier.kinds = tuple("masked" if k in ("masked_legs", "masked_k12") else k
                       for k in hier.kinds)
    return hier


@pytest.mark.parametrize("omega", [1.0, 0.8])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("planes", ["kellogg", "galerkin"])
@pytest.mark.parametrize("side", [7, 31, 100])
def test_wrapper_is_the_plain_sweep(side, planes, symmetric, omega):
    """On CPU tensors the wrapper returns gs4_sweep_masked's bits, with the
    masks built from iota or stored on the host."""
    S = Stencil2D(side=side, c=_planes(planes, side))
    u, b = _fields(side, side + len(planes))
    got = masked_gs4_sweep_var(S, u, b, omega, symmetric)
    assert torch.equal(got, gs4_sweep_masked(
        S, u, b, color_masks_iota(side), omega, symmetric))
    assert torch.equal(got, gs4_sweep_masked(
        S, u, b, color_masks(side, torch.float32), omega, symmetric))


def _bad_call(case: str):
    n = 15
    c = _planes("kellogg", n)
    u, b = _fields(n, 3)
    S = Stencil2D(side=n, c=c)
    if case == "dtype":
        return (TypeError, "float32"), (S, u.double(), b)
    if case == "plane_dtype":
        return (TypeError, "float32"), (Stencil2D(side=n, c=c.double()), u,
                                        b)
    if case == "shape":
        return (ValueError, "shape"), (S, u[:, :13].contiguous(), b)
    if case == "device":
        return (ValueError, "expected cpu"), (S, u, b.to("meta"))
    if case == "planes_noncontiguous":
        t = c.transpose(2, 3).contiguous().transpose(2, 3)
        return (ValueError, "contiguous"), (Stencil2D(side=n, c=t), u, b)
    if case == "field_noncontiguous":
        return (ValueError, "contiguous"), (S, u.t(), b)
    w33 = poisson_const_w33(n, 1)[0]
    return (ValueError, "planes alone"), (Stencil2D.const(w33, n), u, b)


@pytest.mark.parametrize("case", ["dtype", "plane_dtype", "shape", "device",
                                  "planes_noncontiguous",
                                  "field_noncontiguous", "constant"])
def test_input_checks_raise(case):
    (err, match), args = _bad_call(case)
    with pytest.raises(err, match=match):
        masked_gs4_sweep_var(*args)


@pytest.mark.parametrize("smoother,side", [("fused", 255), ("masked", 255),
                                           ("packed", 511)])
def test_rule_engages_on_masked_plane_levels(smoother, side):
    """Kellogg's plane hierarchy, f32 fields: every level but the
    coarsest, for smoother="fused" (all below FUSED_MIN_SIDE), "masked",
    and "auto" (the solver's "packed": the plan's masked levels below
    PACKED_MIN_SIDE, and the FMG's unpacked cycles on every level); CPU
    fields as the card's, since the wrapper runs the plain sweep there."""
    hier = _kellogg_hier(side, smoother)
    last = hier.n_levels - 1
    assert _engages(hier) == [l < last for l in range(last + 1)]
    u, b = _fields(side, 1)
    assert _engages(hier, u) == _engages(hier)
    if smoother == "packed":
        s = StructuredSolver(side, A_planes=varcoef.kellogg_planes(
            side, device=CPU), device=CPU)
        masked = [l for l, k in enumerate(s.plan) if k == "masked_k12"]
        assert masked and all(s.hier.sides[l] < structured.PACKED_MIN_SIDE
                              for l in masked)
        assert all(_engages(s.hier)[l] for l in masked)


def test_rule_engages_on_a_host_built_plane_level():
    """A host-built hierarchy (stored masks, detected constant weights):
    the levels that carry no constant weights engage, the others not."""
    hier = build_stencil_hierarchy(31, A_fine=varcoef.jump_scipy(31),
                                   smoother="masked", device=CPU)
    got = _engages(hier)
    want = [w is None and l < hier.n_levels - 1
            for l, w in enumerate(hier.w33s)]
    assert got == want and any(want)


def _never(case: str, monkeypatch) -> list:
    if case == "constant":
        return _engages(build_stencil_hierarchy_device(63, device=CPU))
    if case == "host_constant":
        return _engages(build_stencil_hierarchy(63, smoother="masked",
                                                device=CPU))
    if case in ("strided", "chebyshev"):
        return _engages(_kellogg_hier(63, case))
    if case == "fused_var":
        monkeypatch.setattr(structured, "FUSED_MIN_SIDE", 63)
        hier = _kellogg_hier(63, "fused")
        assert hier.kinds[0] == "fused_var"
        return _engages(hier)[:1]
    if case == "f64_fields":
        return _engages(_kellogg_hier(63, "masked"), F64)
    return _engages(_kellogg_hier(63, "masked", dtype=torch.float64))


@pytest.mark.parametrize("case", ["constant", "host_constant", "strided",
                                  "chebyshev", "fused_var", "f64_fields",
                                  "f64_planes"])
def test_rule_never_engages(case, monkeypatch):
    """Not on constant levels (device- or host-built), the strided and
    Chebyshev smoothers, a level K6 sweeps, f64 fields or f64 planes."""
    assert not any(_never(case, monkeypatch))


def _k12_sweeps(monkeypatch) -> list:
    """From here on the sides of the sweeps given to K12's wrapper are
    recorded."""
    calls = []

    def sweep(*args):
        calls.append(args[0].side)
        return masked_gs4_sweep_var(*args)
    monkeypatch.setattr(structured, "masked_gs4_sweep_var", sweep)
    return calls


@pytest.mark.parametrize("sweeps", [(1, 1), (2, 3)])
def test_cycle_sweeps_with_k12_where_the_rule_holds(monkeypatch, sweeps):
    """vcycle_stencil on Kellogg's masked plane hierarchy, whose kinds
    name masked_k12: the same bits as the plain cycle (the hierarchy with
    plain kinds), K12's wrapper called for each sweep of each level but
    the coarsest, every visit counted as the kernel's, and the level spans
    naming the machinery masked_k12."""
    u, b = _fields(63, 9)
    want = vcycle_stencil(plain_kinds(_kellogg_hier(63, "masked")), u, b,
                          *sweeps, 0.8)
    hier = _kellogg_hier(63, "masked")
    calls = _k12_sweeps(monkeypatch)
    tracing.reset()
    tracing.enable()
    try:
        got = vcycle_stencil(hier, u, b, *sweeps, 0.8)
        rep = tracing.report()
    finally:
        tracing.disable()
    assert torch.equal(got, want)
    sides = hier.sides[:-1]
    assert sorted(calls) == sorted(sides * sum(sweeps))
    c = rep["counters"]
    assert (c["var_levels_kernel"], c["var_levels_plain"]) == (len(sides), 0)
    kinds = {(s["attrs"]["side"], s["attrs"]["machinery"])
             for s in rep["spans"] if s["name"] == "vcycle.level"}
    assert kinds == {(n, "masked_k12") for n in sides} | {(3, "coarse")}


def _predicted(s, refines: int) -> tuple:
    """(kernel, plain) visits of variable levels a solve: the FMG start's
    unpacked cycles from each level l (levels l to the coarsest but one,
    the hierarchy's kinds, here all masked_k12) all swept by a kernel,
    then 3 V-cycles a refine, the plan's masked_k12 and fused levels a
    kernel's, its packed-var ones plain."""
    L = len(s.plan)
    assert s.hier.kinds == ("masked_k12",) * (L - 1) + ("direct",)
    fmg = sum(L - 1 - l for l in range(L - 1))
    cycles = s.cycles_per_refine * refines
    kernel = sum(k in ("masked_k12", "fused_var") for k in s.plan)
    plain = sum(k == "packed_var" for k in s.plan)
    return fmg + cycles * kernel, cycles * plain


# (case, options): the f64 loop with the masked smoother, the fused one
# below FUSED_MIN_SIDE, and the packed-var levels above masked ones
SOLVES = [("fused", {"smoother": "fused", "precision": "f64"}),
          ("masked", {"smoother": "masked"}),
          ("packed_var", {"packed_min_side": 31, "precision": "f64"})]


@pytest.mark.parametrize("case,kw", SOLVES, ids=[c[0] for c in SOLVES])
def test_solve_with_the_rule_holding_is_the_plain_solve(monkeypatch, case,
                                                        kw):
    """Kellogg's 63^2 solve with its plan on the CPU: u and the stats
    bitwise the plain solve's (the hierarchy with plain kinds), the
    variable-level visits counted by the plan, and none left to the plain
    masked sweep."""
    b = torch.tensor(np.random.default_rng(5).standard_normal((63, 63)))
    planes = varcoef.kellogg_planes(63, device=CPU)

    def solve(plain=False):
        s = StructuredSolver(63, A_planes=planes, device=CPU, **kw)
        if plain:
            plain_kinds(s.hier)
        tracing.reset()
        u, stats = s.solve_ir_device(b, 1e-7, 40)
        return s, u, stats, tracing.counters()
    _, want_u, want_stats, plain = solve(plain=True)
    assert plain["var_levels_kernel"] == 0
    calls = _k12_sweeps(monkeypatch)
    s, u, stats, got = solve()
    assert torch.equal(u, want_u) and torch.equal(stats, want_stats)
    refines = int(stats[1])
    assert (got["var_levels_kernel"], got["var_levels_plain"]) \
        == _predicted(s, refines)
    assert got["var_levels_kernel"] + got["var_levels_plain"] \
        == plain["var_levels_plain"]
    assert calls and K.launch_counts()["masked_gs4_sweep_var"] == 0
