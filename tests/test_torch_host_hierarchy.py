"""amg_tpu_torch's host-built hierarchy (``build_stencil_hierarchy``) and
the one-shot loops ``solve_stencil`` / ``solve_ir`` against amg_tpu's on
the same inputs (CPU; the JAX side with x64).

The port takes scipy's Galerkin product where JAX takes its native C++
RAP, which sums the same terms in another order: planes and detected
weights agree within 1e-12 relative (f64) and 1 f32 ulp (f32), masks and
transfers exactly. A hierarchy carried across from JAX (interop, its
lambda_max estimates included) runs the same loops as JAX's: V-cycle
counts and the history's check points equal exactly, the iterate within
1e-9 relative, and each history rss above 1e-14 of rss(b) within 1e-6
relative (f64 cycles: XLA fuses the sums in its own order, and the
residual's own rounding is about 1e-13 on entries of 2e-7 at an rss of
1e-10, 63^2; below the floor the rss is rounding alone). ``solve_ir``'s
f32 cycles: within 5e-3 relative, because each refine's f32 correction is
rounded in each side's own order (about 1e-7 of the residual it
corrects) and the rss after it is about 1e-4 of the one before (measured
gaps up to 1.1e-3 at 255^2). A hierarchy the port builds itself gives the
same counts.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amg_tpu import structured as jst
from amg_tpu.models import poisson as jpoisson
from amg_tpu.models import varcoef as jvar

from amg_tpu_torch import structured as tst
from amg_tpu_torch.interop import hierarchy_from_numpy
from amg_tpu_torch.sparse.stencil import estimate_lam_max

torch.set_num_threads(1)
CPU = torch.device("cpu")
PROBLEMS = ["poisson", "jump"]
RSS_RTOL = 1e-6
RSS_RTOL_F32 = 5e-3
RSS_FLOOR = 1e-14


def _history_close(got, want, b, rtol):
    assert [i for i, _ in got.history] == [i for i, _ in want.history]
    floor = RSS_FLOOR * float(np.sum(b * b))
    for (_, g), (_, w) in zip(got.history, want.history):
        if w > floor:
            assert abs(g - w) <= rtol * w, (g, w)


def _A(problem, side):
    if problem == "poisson":
        return jpoisson.laplacian_scipy(side)
    return jvar.jump_scipy(side)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _carry(jh, smoother=None):
    """The port's hierarchy from a JAX host-built one's arrays."""
    return hierarchy_from_numpy(
        jh.sides, [lv.w33 for lv in jh.levels], np.asarray(jh.coarse_lu),
        np.asarray(jh.coarse_piv), [np.asarray(P) for P in jh.P1s],
        device=CPU, planes=[np.asarray(lv.c) for lv in jh.levels],
        smoother=smoother or jh.smoother,
        masks=[np.asarray(m) for m in jh.masks], lam_maxes=jh.lam_maxes)


def _w33_close(tw, jw, rtol):
    assert (tw is None) == (jw is None)
    if tw is not None:
        assert _rel(tw, jw) <= rtol


@pytest.mark.parametrize("side", [63, 127])
@pytest.mark.parametrize("problem", PROBLEMS)
def test_host_hierarchy_matches_jax(problem, side):
    A = _A(problem, side)
    jh = jst.build_stencil_hierarchy(side, dtype=jnp.float64, A_fine=A)
    th = tst.build_stencil_hierarchy(side, dtype=torch.float64, A_fine=A,
                                     device=CPU)
    assert th.sides == tuple(jh.sides) and th.smoother == "masked"
    assert th.lam_maxes is None and jh.lam_maxes is None
    for tS, jS, tm, jm in zip(th.levels, jh.levels, th.masks, jh.masks):
        _w33_close(tS.w33, jS.w33, 1e-12)
        assert _rel(tS.c, jS.c) <= 1e-12
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    for tP, jP in zip(th.P1s, jh.P1s):
        np.testing.assert_array_equal(tP.numpy(), np.asarray(jP))
    nc = th.sides[-1]
    b = np.random.default_rng(side).standard_normal((nc, nc))
    want = jax.scipy.linalg.lu_solve((jh.coarse_lu, jh.coarse_piv),
                                     jnp.asarray(b).reshape(-1))
    assert _rel(th.coarse_solve(torch.tensor(b)).numpy().reshape(-1),
                want) <= 1e-12
    if problem == "jump":
        assert th.levels[0].w33 is None


@pytest.mark.parametrize("problem", PROBLEMS)
def test_host_hierarchy_f32(problem):
    side = 127
    A = _A(problem, side)
    jh = jst.build_stencil_hierarchy(side, A_fine=A)
    th = tst.build_stencil_hierarchy(side, A_fine=A, device=CPU)
    for tS, jS in zip(th.levels, jh.levels):
        assert tS.c.dtype == torch.float32
        _w33_close(tS.w33, jS.w33, 1.2e-7)
        assert _rel(tS.c, jS.c) <= 1.2e-7
    assert th.coarse_lu.dtype == torch.float32


@pytest.mark.parametrize("problem", PROBLEMS)
def test_chebyshev_lam_maxes(problem):
    """Constant levels: the analytic bound, as JAX's; variable levels: the
    port's seeded estimate, and JAX's value from JAX's start vector."""
    side = 63
    A = _A(problem, side)
    jh = jst.build_stencil_hierarchy(side, dtype=jnp.float64, A_fine=A,
                                     smoother="chebyshev")
    th = tst.build_stencil_hierarchy(side, dtype=torch.float64, A_fine=A,
                                     smoother="chebyshev", device=CPU)
    assert len(th.lam_maxes) == len(jh.lam_maxes) == th.n_levels
    for l, (tS, jS) in enumerate(zip(th.levels, jh.levels)):
        if tS.w33 is not None:
            assert abs(th.lam_maxes[l] - jh.lam_maxes[l]) \
                <= 1e-12 * jh.lam_maxes[l]
            continue
        assert th.lam_maxes[l] == float(estimate_lam_max(tS, seed=0))
        x0 = jax.random.normal(jax.random.PRNGKey(0), (tS.side, tS.side),
                               dtype=jnp.float64)
        got = float(estimate_lam_max(tS, x0=torch.tensor(np.asarray(x0))))
        assert abs(got - jh.lam_maxes[l]) <= 1e-10 * jh.lam_maxes[l]


@pytest.mark.parametrize("smoother", ["masked", "strided", "chebyshev"])
@pytest.mark.parametrize("problem", PROBLEMS)
def test_solve_stencil_matches_jax(problem, smoother):
    side = 63
    A = _A(problem, side)
    jh = jst.build_stencil_hierarchy(side, dtype=jnp.float64, A_fine=A,
                                     smoother=smoother)
    b = np.asarray(jpoisson.rhs(side)).reshape(side, side)
    want = jst.solve_stencil(jh, jnp.asarray(b), tolerance=1e-9,
                             compute_error_every_n_iters=1)
    got = tst.solve_stencil(_carry(jh), torch.tensor(b), tolerance=1e-9,
                            compute_error_every_n_iters=1, device=CPU)
    assert want.converged and got.converged
    assert got.iterations == want.iterations
    _history_close(got, want, b, RSS_RTOL)
    assert _rel(got.u, want.u) <= 1e-9
    # the port's own host build: the same counts
    own = tst.solve_stencil(
        tst.build_stencil_hierarchy(side, dtype=torch.float64, A_fine=A,
                                    smoother=smoother, device=CPU),
        torch.tensor(b), tolerance=1e-9, compute_error_every_n_iters=1,
        device=CPU)
    assert own.iterations == want.iterations


@pytest.mark.parametrize("every", [0, 3, 5])
def test_solve_stencil_checks_every_n(every):
    side = 127
    jh = jst.build_stencil_hierarchy(side, dtype=jnp.float64)
    b = np.asarray(jpoisson.rhs(side)).reshape(side, side)
    kw = dict(tolerance=1e-9, compute_error_every_n_iters=every, n_iters=12)
    want = jst.solve_stencil(jh, jnp.asarray(b), **kw)
    got = tst.solve_stencil(_carry(jh), torch.tensor(b), device=CPU, **kw)
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    _history_close(got, want, b, RSS_RTOL)


@pytest.mark.parametrize("side", [31, 63, 127, 255])
def test_free_solve_ir_matches_jax(side):
    b = np.asarray(jpoisson.rhs(side)).reshape(side, side)
    want = jst.solve_ir(side, jnp.asarray(b), tolerance=1e-9)
    jh = jst.build_stencil_hierarchy(side, dtype=jnp.float32)
    carried = tst.solve_ir(side, torch.tensor(b), _carry(jh),
                           tolerance=1e-9, device=CPU)
    own = tst.solve_ir(side, torch.tensor(b), tolerance=1e-9, device=CPU)
    assert want.converged
    for got in (carried, own):
        assert got.converged and got.iterations == want.iterations
        _history_close(got, want, b, RSS_RTOL_F32)


def test_free_solve_ir_cycle_options():
    """cycle_kw reach the V-cycles: two sweeps a side, omega 0.9."""
    side = 63
    b = np.asarray(jpoisson.rhs(side)).reshape(side, side)
    kw = dict(pre_sweeps=2, post_sweeps=2, omega=0.9)
    want = jst.solve_ir(side, jnp.asarray(b), tolerance=1e-9,
                        cycles_per_refine=1, **kw)
    got = tst.solve_ir(side, torch.tensor(b), tolerance=1e-9,
                       cycles_per_refine=1, device=CPU, **kw)
    assert got.iterations == want.iterations
    assert len(got.history) == len(want.history)


@pytest.mark.parametrize("side", [63, 255])
def test_build_fine_stencil_f64(side):
    jS = jst.build_fine_stencil_f64(side)
    tS = tst.build_fine_stencil_f64(side, device=CPU)
    assert tS.w33 == jS.w33 and tS.dtype == torch.float64
    np.testing.assert_array_equal(tS.c.numpy(), np.asarray(jS.c))


def test_solve_stencil_refuses_another_device():
    th = tst.build_stencil_hierarchy(31, device=CPU)
    with pytest.raises(ValueError, match="hierarchy is on"):
        tst.solve_stencil(th, torch.zeros(31, 31), device="meta")


def test_hierarchy_arguments_checked():
    """A level without weights needs planes; per-level lists need every
    level; packed planes are kept only for the levels without weights."""
    th = tst.build_stencil_hierarchy(255, A_fine=jvar.jump_scipy(255),
                                     smoother="packed", device=CPU)
    lu, piv = th.coarse_lu, th.coarse_piv
    w33s, planes = [S.w33 for S in th.levels], [S.c for S in th.levels]
    with pytest.raises(ValueError, match="needs its planes"):
        tst.StencilHierarchy(th.sides, w33s, lu, piv, th.P1s)
    with pytest.raises(ValueError, match="masks on every level"):
        tst.StencilHierarchy(th.sides, w33s, lu, piv, th.P1s, planes=planes,
                             masks=th.masks[:-1])
    with pytest.raises(ValueError, match="lam_maxes on every level"):
        tst.StencilHierarchy(th.sides, w33s, lu, piv, th.P1s, planes=planes,
                             lam_maxes=[2.0])
    packed = {name for name, _ in th.named_buffers() if name.startswith("cp_")}
    assert packed == {f"cp_{l}" for l, S in enumerate(th.levels[:-1])
                      if S.w33 is None and S.side >= tst.PACKED_MIN_SIDE}
    assert packed == {"cp_0"}
    poisson = tst.build_stencil_hierarchy(255, smoother="packed", device=CPU)
    assert not any(n.startswith("cp_") for n, _ in poisson.named_buffers())
