"""The port's ELL smoothers and coloring (amg_tpu_torch/ops/smoothers.py,
utils/coloring.py) against amg_tpu's, f64 on the CPU, on the same numpy
inputs: the testlib direct oracle (test/testlib.cpp:76-107), one
``apply`` of each smoother within 1e-13 of JAX's, the ``smooth`` cadence,
the omega validations, the greedy colors of the Poisson and Galerkin
patterns, and each smoother under ``Multigrid`` to JAX's V-cycle count."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amg_tpu.models import poisson as jpoisson
from amg_tpu.multigrid import Multigrid as JMultigrid
from amg_tpu.multigrid import build_hierarchy as jbuild_hierarchy
from amg_tpu.ops import smoothers as J
from amg_tpu.sparse.ell import ELL as JELL
from amg_tpu.utils import coloring as jcoloring
from amg_tpu_torch.models import poisson
from amg_tpu_torch.multigrid import Multigrid, build_hierarchy
from amg_tpu_torch.ops import smoothers as T
from amg_tpu_torch.ops.transfer import (BilinearInterpolator2D,
                                        LinearInterpolator)
from amg_tpu_torch.sparse.ell import ELL
from amg_tpu_torch.utils import coloring

torch.set_num_threads(1)


def _pair(M):
    return ELL.from_scipy(M, device="cpu"), JELL.from_scipy(M)


def _galerkin(n, levels=2):
    """Level ``levels - 1`` of the reference's LinearInterpolator chain."""
    h = build_hierarchy(poisson.laplacian_scipy(n), levels,
                        smoother=T.Jacobi(), device="cpu")
    return h.levels[-1].A.to_scipy()


SMOOTHERS = {
    "jacobi": (lambda m: m.Jacobi(omega=0.8)),
    "spgs": (lambda m: m.SparseGaussSeidel()),
    "sor": (lambda m: m.SuccessiveOverRelaxation(omega=1.5)),
    "mcgs": (lambda m: m.MulticolorGaussSeidel(omega=1.2)),
    "mcgs_forward": (lambda m: m.MulticolorGaussSeidel(symmetric=False)),
}


@pytest.mark.parametrize("name", ["jacobi", "sor", "spgs", "mcgs"])
def test_direct_oracle(name):
    """The 4-dof problem: 100 iterations reach the direct solution
    (testlib.cpp:76-107), as JAX's do."""
    A, b = poisson.poisson2d(2, device="cpu")
    u_exact = torch.linalg.solve(A.to_dense(), b)
    got = SMOOTHERS[name](T)
    got.n_iters = 100
    res = got.smooth(A, torch.zeros_like(b), b)
    torch.testing.assert_close(res.u, u_exact, rtol=0, atol=1e-8)
    ref = SMOOTHERS[name](J)
    ref.n_iters = 100
    jA, jb = jpoisson.poisson2d(2)
    jres = ref.smooth(jA, jnp.zeros_like(jb), jb)
    np.testing.assert_allclose(res.u.numpy(), np.asarray(jres.u), rtol=1e-13)


@pytest.mark.parametrize("level", ["poisson", "galerkin"])
@pytest.mark.parametrize("name", sorted(SMOOTHERS))
def test_one_apply_equals_jax(name, level):
    M = poisson.laplacian_scipy(9) if level == "poisson" else _galerkin(11)
    A, jA = _pair(M)
    rng = np.random.default_rng(3)
    u0 = rng.standard_normal(M.shape[0])
    b = rng.standard_normal(M.shape[0])
    sm, jsm = SMOOTHERS[name](T), SMOOTHERS[name](J)
    u_t = torch.from_numpy(u0)
    got = sm.apply(sm.setup(A), u_t, torch.from_numpy(b))
    ref = jsm.apply(jsm.setup(jA), jnp.asarray(u0), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-13 * np.abs(np.asarray(ref)).max())
    np.testing.assert_array_equal(u_t.numpy(), u0)  # u is not written


@pytest.mark.parametrize("every,n_iters,tol", [(3, 10, 1e-30), (0, 6, 1e-9),
                                               (7, 1000, 1e-9)])
def test_smooth_cadence_equals_jax(every, n_iters, tol):
    """Checks every ``every`` iterations (0: never), the last partial chunk
    unchecked, the reference's sentinel 100 when never checked
    (smoother.hpp:189-214)."""
    A, b = poisson.poisson2d(3, device="cpu")
    jA, jb = jpoisson.poisson2d(3)
    res = T.SparseGaussSeidel(tol, every, n_iters).smooth(
        A, torch.zeros_like(b), b)
    jres = J.SparseGaussSeidel(tol, every, n_iters).smooth(
        jA, jnp.zeros_like(jb), jb)
    assert res.iterations == jres.iterations
    assert res.converged == jres.converged
    assert [i for i, _ in res.history] == [i for i, _ in jres.history]
    np.testing.assert_allclose([e for _, e in res.history],
                               [e for _, e in jres.history], rtol=1e-9)
    if every == 0:
        assert res.error == 100.0 and res.iterations == n_iters
    if every == 7:
        assert res.converged and res.iterations % 7 == 0


def test_smooth_verbose_prints(capsys):
    A, b = poisson.poisson2d(2, device="cpu")
    T.Jacobi(1e-9, 10, 100).smooth(A, torch.zeros_like(b), b, verbose=True)
    assert "Jacobi converged after" in capsys.readouterr().out


@pytest.mark.parametrize("make", [
    lambda: T.SuccessiveOverRelaxation(omega=-0.01),
    lambda: T.SuccessiveOverRelaxation(omega=2.01),
    lambda: T.MulticolorGaussSeidel(omega=-0.5),
    lambda: T.MulticolorGaussSeidel(omega=2.5),
])
def test_omega_validation(make):
    """Omega outside [0, 2] raises (testlib.cpp:64-71,
    smoother.hpp:286-293)."""
    with pytest.raises(ValueError, match="omega"):
        make()


def test_base_ctor_variants():
    """The 3-argument base ctor (testlib.cpp:109-115)."""
    j = T.Jacobi(1e-10, 100, 100)
    s = T.SuccessiveOverRelaxation(1.0, 1e-10, 100, 100)
    assert (j.tolerance, j.compute_error_every_n_iters, j.n_iters) == \
        (1e-10, 100, 100)
    assert s.omega == 1.0 and s.n_iters == 100


def _patterns():
    out = {"poisson": poisson.laplacian_scipy(12)}
    for name, interp, n, L in (("linear", LinearInterpolator(5), 35, 5),
                               ("bilinear", BilinearInterpolator2D(31), 31,
                                4)):
        h = build_hierarchy(poisson.laplacian_scipy(n), L, interp,
                            T.Jacobi(), device="cpu")
        for l in range(1, L):
            out[f"{name}{l}"] = h.levels[l].A.to_scipy()
    return out


def test_greedy_coloring_equals_jax():
    """First-fit colors of the Poisson pattern and the Galerkin-coarsened
    ones equal JAX's (its numpy loop or native path, the same
    algorithm), and each is a proper coloring."""
    for name, M in _patterns().items():
        E = ELL.from_scipy(M, device="cpu")
        cols, data = E.cols.numpy(), E.data.numpy()
        got = coloring.greedy_coloring(cols, data, M.shape[0])
        ref = jcoloring.greedy_coloring(cols.astype(np.int32), data,
                                        M.shape[0])
        np.testing.assert_array_equal(got, np.asarray(ref), err_msg=name)
        r, c = M.nonzero()
        off = r != c
        assert not np.any(got[r[off]] == got[c[off]]), name


@pytest.mark.parametrize("n", [6, 7])
def test_closed_form_colorings_equal_jax(n):
    np.testing.assert_array_equal(coloring.red_black_2d(n),
                                  jcoloring.red_black_2d(n))
    np.testing.assert_array_equal(coloring.four_color_2d(n),
                                  jcoloring.four_color_2d(n))
    E = poisson.laplacian(n, device="cpu")
    np.testing.assert_array_equal(
        coloring.greedy_coloring(E.cols.numpy(), E.data.numpy(), n * n),
        coloring.red_black_2d(n))


def _color_ordered_sweep(dense, b, u0, colors, omega, symmetric):
    """One multicolor sweep by hand: each color's rows updated together
    from the current u, colors in order (then reversed if symmetric)."""
    order = list(range(int(colors.max()) + 1))
    if symmetric:
        order += order[::-1]
    u = u0.copy()
    for c in order:
        rows = np.nonzero(colors == c)[0]
        new = u.copy()
        for i in rows:
            s = dense[i] @ u - dense[i, i] * u[i]
            new[i] = u[i] + omega * ((b[i] - s) / dense[i, i] - u[i])
        u = new
    return u


@pytest.mark.parametrize("symmetric", [False, True])
def test_padded_color_holding_row_0(symmetric):
    """Row 0 in a color with fewer rows than the widest: the port writes
    each color's rows once, so row 0 takes its own update (JAX writes its
    padded slots, which point at row 0, back as well)."""
    n = 4
    E = poisson.laplacian(n, device="cpu")
    colors = coloring.red_black_2d(n)
    colors[5] = 2               # color 0 (row 0's) now has 7 rows, color 1 8
    assert colors[0] == 0 and (colors == 0).sum() < (colors == 1).sum()
    rng = np.random.default_rng(5)
    u0, b = rng.standard_normal(n * n), rng.standard_normal(n * n)
    sm = T.MulticolorGaussSeidel(omega=1.1, symmetric=symmetric,
                                 colors=colors)
    got = sm.apply(sm.setup(E), torch.from_numpy(u0), torch.from_numpy(b))
    want = _color_ordered_sweep(E.to_dense().numpy(), b, u0, colors, 1.1,
                                symmetric)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)
    assert got[0] != u0[0]


def test_refresh_state_equals_setup():
    """Panels refreshed from new values equal a fresh setup's."""
    M = _galerkin(11)
    E = ELL.from_scipy(M, device="cpu")
    sm = T.MulticolorGaussSeidel()
    st = sm.setup(E)
    scaled = ELL(data=E.data * 2.5, cols=E.cols, shape=E.shape)
    fresh = sm.setup(scaled)
    new = T.MulticolorGaussSeidel.refresh_state(st, scaled.data)
    for a, b in zip(new.data + new.diag, fresh.data + fresh.diag):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


MG_SMOOTHERS = {
    "jacobi": lambda m: m.Jacobi(omega=0.9, n_iters=2),
    "sor": lambda m: m.SuccessiveOverRelaxation(omega=1.5),
    "mcgs": lambda m: m.MulticolorGaussSeidel(),
}


@pytest.mark.parametrize("name", sorted(MG_SMOOTHERS))
def test_multigrid_count_equals_jax(name):
    """Each smoother under the 8-level Multigrid at 23^2 converges in
    JAX's V-cycle count, to JAX's rss within 1e-9 relative."""
    A, b = poisson.poisson2d(23, device="cpu")
    jA, jb = jpoisson.poisson2d(23)
    res = Multigrid(None, MG_SMOOTHERS[name](T), A, b, 6, 1e-9, 5, 100,
                    device="cpu").solve(verbose=False)
    jres = JMultigrid(None, MG_SMOOTHERS[name](J), jA, jb, 6, 1e-9, 5,
                      100).solve(verbose=False)
    assert res.converged and jres.converged
    assert res.iterations == jres.iterations
    assert res.error == pytest.approx(jres.error, rel=1e-9)


def test_jax_hierarchy_colors_equal_ports():
    """The multicolor state's color classes equal JAX's on every level of
    the reference hierarchy."""
    M = poisson.laplacian_scipy(15)
    h = build_hierarchy(M, 4, smoother=T.MulticolorGaussSeidel(),
                        device="cpu")
    jh = jbuild_hierarchy(M, 4, smoother=J.MulticolorGaussSeidel())
    for lev, jlev in zip(h.levels, jh.levels):
        st, jst = lev.smoother_state, jlev.smoother_state
        assert st.n_colors == jst.n_colors
        for c in range(st.n_colors):
            valid = np.asarray(jst.color_valid[c])
            np.testing.assert_array_equal(
                st.rows[c].numpy(), np.asarray(jst.color_rows[c])[valid])


def test_row_0_color_is_the_largest():
    """Greedy first-fit puts row 0 in color 0, and color 0 is the largest
    on the hierarchies of these tests, so JAX's padded color writes (see
    test_padded_color_holding_row_0) never reach row 0 there."""
    from amg_tpu_torch.multigrid import build_hierarchy_device

    hiers = [
        build_hierarchy(poisson.laplacian_scipy(35), 8,
                        smoother=T.MulticolorGaussSeidel(), device="cpu"),
        build_hierarchy(poisson.laplacian_scipy(31), 4,
                        BilinearInterpolator2D(31),
                        T.MulticolorGaussSeidel(), device="cpu"),
        build_hierarchy_device(poisson.laplacian_scipy(35), 8,
                               device="cpu")[0],
        build_hierarchy_device(poisson.laplacian_scipy(255), 10,
                               device="cpu")[0],
    ]
    for h in hiers:
        for lev in h.levels:
            sizes = [len(r) for r in lev.smoother_state.rows]
            assert 0 in lev.smoother_state.rows[0].tolist()
            assert sizes[0] == max(sizes), sizes
