"""Kellogg's intersecting-interfaces operator in the box scheme
(``amg_tpu_torch.models.varcoef``: ``kellogg_cells``, ``box_planes``) on
the CPU: the planes against the benchmark reference's flux-form apply
(``portbench/reference/kellogg.py``, which builds A u from the cell
coefficients with no planes) and against a scipy assembly edge by edge
(``_box_scipy``), their symmetry and their Poisson limit; the f64 solve of the
plane operator held to the reference's rss; the counters of
variable-coefficient level visits and the Galerkin chain's set-up span.

Tolerances: the planes' apply against the flux form, 1e-13 of max |A u|:
both are f64 sums of the same five terms per node in another order
(edge x difference against coefficient x value), so they differ by a few
ulps of the largest term, which for a random field is of the size of
A u itself; the scipy assembly within 1e-14 relative, entry by entry: its
diagonal sums the node's four edges in another order.
"""

import numpy as np
import pytest
import torch

from amg_tpu_torch import StructuredSolver, structured
from amg_tpu_torch.models import varcoef
from amg_tpu_torch.ops.rap import poisson_planes
from amg_tpu_torch.sparse.stencil import Stencil2D
from amg_tpu_torch.utils import tracing
from portbench.reference import kellogg as ref
from portbench.reference import operators, rhs

torch.set_num_threads(1)
CPU = torch.device("cpu")
SIDES = (15, 63)
KINDS = ("random", "kellogg")


def _box_scipy(p_cells):
    """Host (scipy CSR, f64) assembly of ``box_planes``' operator from a
    numpy (n+1, n+1) cell coefficient, edge by edge."""
    import scipy.sparse as sp

    p = np.asarray(p_cells, dtype=np.float64)
    n = p.shape[0] - 1
    inv_h2 = 1.0 / (2.0 / (n + 1)) ** 2
    # ej[J, i]: the edge between nodes (J-1, i) and (J, i) (J = 0 and n
    # reach the boundary), its cells (J, i) and (J, i+1); ei[j, I]: between
    # (j, I-1) and (j, I), its cells (j, I) and (j+1, I)
    ej = 0.5 * (p[:, :-1] + p[:, 1:])
    ei = 0.5 * (p[:-1, :] + p[1:, :])
    node = np.arange(n * n).reshape(n, n)
    a = np.concatenate([node[:-1].ravel(), node[:, :-1].ravel()])
    b = np.concatenate([node[1:].ravel(), node[:, 1:].ravel()])
    w = np.concatenate([ej[1:-1].ravel(), ei[:, 1:-1].ravel()]) * inv_h2
    diag = -(ej[:-1] + ej[1:] + ei[:, :-1] + ei[:, 1:]) * inv_h2
    rows = np.concatenate([a, b, node.ravel()])
    cols = np.concatenate([b, a, node.ravel()])
    vals = np.concatenate([w, w, diag.ravel()])
    return sp.csr_matrix((vals, (rows, cols)), shape=(n * n, n * n))


def _cells(kind, n, seed=7):
    """Kellogg's cells, or cell coefficients log-uniform in [1e-2, 1e2]."""
    if kind == "kellogg":
        return varcoef.kellogg_cells(n, device=CPU)
    g = torch.Generator().manual_seed(seed + n)
    return 10.0 ** (4.0 * torch.rand((n + 1, n + 1), generator=g,
                                     dtype=torch.float64) - 2.0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIDES)
def test_planes_match_the_flux_form(n, kind):
    p = _cells(kind, n)
    c = varcoef.box_planes(p)
    assert c.shape == (3, 3, n, n) and c.dtype == torch.float64
    g = torch.Generator().manual_seed(n)
    for _ in range(3):
        u = torch.randn((n, n), generator=g, dtype=torch.float64)
        want = ref.flux_apply(p, u)
        got = Stencil2D(side=n, c=c).matvec2(u)
        assert (got - want).abs().max() <= 1e-13 * want.abs().max()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIDES)
def test_planes_match_the_scipy_assembly(n, kind):
    p = _cells(kind, n)
    got = Stencil2D.from_scipy(_box_scipy(p.numpy()), n).c
    torch.testing.assert_close(got, varcoef.box_planes(p), rtol=1e-14,
                               atol=0)


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_unit_coefficient_is_the_poisson_planes(dtype):
    n = 31
    one = torch.ones((n + 1, n + 1), dtype=torch.float64)
    assert torch.equal(varcoef.box_planes(one, dtype),
                       poisson_planes(n, dtype, CPU))


@pytest.mark.parametrize("kind", KINDS)
def test_planes_are_symmetric(kind):
    n = 63
    c = varcoef.box_planes(_cells(kind, n))
    assert torch.equal(c[2, 1, :-1], c[0, 1, 1:])
    assert torch.equal(c[1, 2, :, :-1], c[1, 0, :, 1:])
    for a, b in ((0, 0), (0, 2), (2, 0), (2, 2)):
        assert not c[a, b].any()
    A = _box_scipy(_cells(kind, n).numpy())
    assert abs(A - A.T).max() == 0.0


def test_kellogg_cells_and_the_axes():
    """R in the first and third quadrants, 1 in the others; the interfaces
    run through node (n - 1) / 2, where an edge along an axis couples by
    (R + 1) / 2 over h^2 and the cross point's diagonal is -2 (R + 1) /
    h^2; the frozen copy in the reference is the same."""
    n = 15
    p = varcoef.kellogg_cells(n, device=CPU)
    m = (n + 1) // 2
    R = varcoef.KELLOGG_R
    assert R == ref.R == 161.4476387975881
    assert torch.equal(p, ref.cells(n))
    assert (p[:m, :m] == R).all() and (p[m:, m:] == R).all()
    assert (p[:m, m:] == 1).all() and (p[m:, :m] == 1).all()
    c = varcoef.box_planes(p)
    inv_h2 = ((n + 1) / 2.0) ** 2
    k = m - 1                                   # the node at 0
    assert c[1, 2, k, 3] == pytest.approx((R + 1) / 2 * inv_h2, rel=1e-15)
    assert c[1, 1, k, k] == pytest.approx(-2 * (R + 1) * inv_h2, rel=1e-15)
    assert c[1, 1, 2, 2] == pytest.approx(-4 * R * inv_h2, rel=1e-15)
    assert torch.equal(varcoef.kellogg_planes(n, device=CPU), c)
    assert torch.equal(ref.planes(p), c)


def _sources(n, seed):
    """One to three Gaussian sources, drawn from ``seed`` as the
    benchmark's sweep mix draws them."""
    g = np.random.default_rng(seed)
    src = [(float(g.choice((-1.0, 1.0)) * g.uniform(1.0, 5.0)),
            float(g.uniform(5.0, 20.0)), float(g.uniform(-0.5, 0.5)),
            float(g.uniform(-0.5, 0.5)))
           for _ in range(int(g.integers(1, 4)))]
    return rhs.gaussian_sources(n, src, CPU)


@pytest.mark.parametrize("n", (63, 127))
def test_f64_solve_meets_the_reference_rss(n):
    planes = varcoef.kellogg_planes(n, device=CPU)
    s = StructuredSolver(n, A_planes=planes, smoother="fused",
                         precision="f64", device=CPU)
    assert s.A64.c is planes             # the residual's exact operator
    tol = 1e-7
    p = ref.cells(n)
    for seed in (2**31 + 1, 2**33 + 5):
        b = _sources(n, seed)
        u, stats = s.solve_ir_device(b, tol, 40)
        stated, refines = stats.tolist()
        assert stated <= tol and refines < 40
        assert operators.rss(b, ref.flux_apply(p, u)) <= tol


def _predicted(s, refines):
    """(kernel, plain) visits of variable levels a solve, from the level
    plan: the FMG start cycles from each level l up (levels l to the
    coarsest but one, the hierarchy's kinds), then 3 V-cycles a refine
    visit each such level once (the solver's plan); a level counts as the
    kernel's where its kind sweeps it with K6 or K12."""
    var = [k != "direct" for k in s.plan] if s.hier.is_var else []
    sweeps = ("fused_var", "masked_k12")
    fmg_kernel = [k in sweeps for k in s.hier.kinds]
    kernel = [k in sweeps for k in s.plan]
    fmg = [(l2, v) for l in range(len(var)) for l2, v in enumerate(var)
           if l2 >= l and v]
    cycles = s.cycles_per_refine * refines
    n_k = sum(fmg_kernel[l] for l, _ in fmg) + cycles * sum(
        kernel[l] for l, v in enumerate(var) if v)
    n_all = len(fmg) + cycles * sum(var)
    return n_k, n_all - n_k


# (case, side, options, plane operator, FUSED_MIN_SIDE)
COUNTS = [("masked", 63, {"smoother": "fused", "precision": "f64"}, True,
           None),
          ("k6", 63, {"smoother": "fused", "precision": "f64"}, True, 63),
          ("packed_var", 63, {"packed_min_side": 31, "precision": "f64"},
           True, None),
          ("constant", 63, {"smoother": "fused", "precision": "f64"}, False,
           None)]


@pytest.mark.parametrize("case,n,kw,var,fused_min", COUNTS,
                         ids=[c[0] for c in COUNTS])
def test_var_level_counters_follow_the_plan(monkeypatch, case, n, kw, var,
                                            fused_min):
    if fused_min is not None:
        monkeypatch.setattr(structured, "FUSED_MIN_SIDE", fused_min)
    planes = varcoef.kellogg_planes(n, device=CPU) if var else None
    s = StructuredSolver(n, A_planes=planes, device=CPU, **kw)
    if case == "packed_var":
        assert s.plan[:2] == ("packed_var", "packed_var")
    tracing.reset()
    _, stats = s.solve_ir_device(_sources(n, 2**32 + 9), 1e-7, 40)
    got = tracing.counters()
    want = _predicted(s, int(stats[1]))
    assert (got["var_levels_kernel"], got["var_levels_plain"]) == want
    if case == "k6":
        assert want[0] > 0
    if case == "constant":
        assert want == (0, 0)
    tracing.reset()
    assert tracing.counters()["var_levels_plain"] == 0


def test_galerkin_planes_setup_span():
    """The plane Galerkin chain is the set-up span
    ``setup.galerkin_planes``: its seconds in ``report()["setup"]``, and
    while tracing is on a span inside ``setup.hierarchy``."""
    before = tracing.setup_seconds().get("setup.galerkin_planes", 0.0)
    tracing.enable()
    try:
        StructuredSolver(63, A_planes=varcoef.kellogg_planes(63, device=CPU),
                         precision="f64", device=CPU)
        rep = tracing.report()
    finally:
        tracing.disable()
    assert rep["setup"]["setup.galerkin_planes"] > before
    spans = rep["spans"]
    (g,) = [s for s in spans if s["name"] == "setup.galerkin_planes"]
    assert spans[g["parent"]]["name"] == "setup.hierarchy"
    n_before = tracing.setup_seconds()["setup.galerkin_planes"]
    StructuredSolver(63, precision="f64", device=CPU)
    assert tracing.setup_seconds()["setup.galerkin_planes"] == n_before
