"""The port's device Galerkin RAP (amg_tpu_torch/ops/ell_rap.py) and the
device-built hierarchy against amg_tpu's, f64 on the CPU: the plans'
arrays equal JAX's, every level within 1e-14 of JAX's and of the scipy
SpGEMM chain, the value rebuild equal to a fresh build."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amg_tpu.models import poisson as jpoisson
from amg_tpu.multigrid import build_hierarchy_device as jbuild_device
from amg_tpu.multigrid import solve as jsolve
from amg_tpu.ops import ell_rap as JR
from amg_tpu.ops.smoothers import MulticolorGaussSeidel as JMCGS
from amg_tpu.sparse.ell import ELL as JELL
from amg_tpu_torch.models import poisson
from amg_tpu_torch.multigrid import (build_hierarchy, build_hierarchy_device,
                                     rebuild_hierarchy_values, solve, vcycle)
from amg_tpu_torch.ops.ell_rap import apply_rap_chain, build_rap_plans
from amg_tpu_torch.ops.smoothers import (MulticolorGaussSeidel,
                                         SparseGaussSeidel)
from amg_tpu_torch.ops.transfer import LinearInterpolator
from amg_tpu_torch.sparse.ell import ELL

torch.set_num_threads(1)

CASES = [(35, 8), (20, 4)]


def _scipy_chain(A_sp, n_levels):
    interp = LinearInterpolator(n_levels)
    mats = [A_sp.tocsr()]
    for _ in range(n_levels - 1):
        n_h = mats[-1].shape[0]
        P, R = interp.make_operators_scipy(n_h, interp.coarse_size(n_h))
        mats.append((R @ (mats[-1] @ P)).tocsr())
    return mats


def _both(n, n_levels):
    M = poisson.laplacian_scipy(n)
    plans, mats = build_rap_plans(ELL.from_scipy(M, device="cpu"),
                                   n_levels)
    jplans, jmats = JR.build_rap_plans(JELL.from_scipy(M), n_levels)
    return M, plans, mats, jplans, jmats


@pytest.mark.parametrize("n,n_levels", CASES)
def test_plans_equal_jax(n, n_levels):
    _, plans, _, jplans, _ = _both(n, n_levels)
    for p, jp in zip(plans, jplans):
        assert (p.n_h, p.n_H, p.K, p.K_out) == (jp.n_h, jp.n_H, jp.K,
                                                jp.K_out)
        for name in ("assign", "out_cols", "weights"):
            np.testing.assert_array_equal(getattr(p, name).numpy(),
                                          np.asarray(getattr(jp, name)))


@pytest.mark.parametrize("n,n_levels", CASES)
def test_levels_equal_jax_and_scipy(n, n_levels):
    M, _, mats, _, jmats = _both(n, n_levels)
    ref = _scipy_chain(M, n_levels)
    for l in range(1, n_levels):
        scale = abs(ref[l]).max()
        assert abs(mats[l].to_scipy() - ref[l]).max() <= 1e-14 * scale, l
        jd = np.asarray(jmats[l].data)
        assert np.abs(mats[l].data.numpy() - jd).max() <= 1e-14 * scale, l
        np.testing.assert_array_equal(mats[l].cols.numpy(),
                                      np.asarray(jmats[l].cols))


@pytest.mark.parametrize("n,n_levels", CASES)
def test_apply_on_random_values_equals_jax(n, n_levels):
    """The fixed-order gather sum against JAX's scatter-add, on values
    that are not a stencil's (every slot of the pattern random)."""
    _, plans, _, jplans, _ = _both(n, n_levels)
    rng = np.random.default_rng(11)
    for p, jp in zip(plans, jplans):
        data = rng.standard_normal((p.n_h, p.K))
        got = p.apply(torch.from_numpy(data)).data.numpy()
        ref = np.asarray(jp.apply(jnp.asarray(data)).data)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-14 * np.abs(ref).max())


def test_apply_sums_in_slot_order():
    """An output slot is the left-to-right sum of its contributions in
    ascending index: bitwise the sum written out in numpy."""
    _, plans, _, _, _ = _both(20, 3)
    p = plans[0]
    rng = np.random.default_rng(2)
    data = rng.standard_normal((p.n_h, p.K))
    a = np.arange(p.n_H)
    rows3 = np.stack([2 * a, 2 * a + 1, 2 * a + 2], axis=1)
    gv = np.repeat(data[rows3].reshape(p.n_H, 3 * p.K), 2, axis=1) * \
        p.weights.numpy()
    assign = p.assign.numpy()
    want = np.zeros((p.n_H, p.K_out))
    for r in range(p.n_H):
        for j in range(6 * p.K):
            if assign[r, j] < p.K_out:
                want[r, assign[r, j]] += gv[r, j]
    np.testing.assert_array_equal(p.apply(torch.from_numpy(data)).data.numpy(),
                                  want)


def test_chain_scales_linearly():
    """The value-only rebuild is exact for scaled coefficients."""
    E = poisson.laplacian(20, device="cpu")
    plans, mats = build_rap_plans(E, 4)
    datas = apply_rap_chain(plans, E.data * 3.0)
    for l in range(1, 4):
        got = ELL(data=datas[l], cols=mats[l].cols, shape=mats[l].shape)
        assert abs(got.to_scipy() - 3.0 * mats[l].to_scipy()).max() < 1e-12


def test_rebuild_values_equals_fresh_build():
    """Refreshing the values equals building anew from the scaled
    operator: levels, panels and one V-cycle."""
    A, b = poisson.poisson2d(20, device="cpu")
    sm = MulticolorGaussSeidel()
    hier, plans = build_hierarchy_device(A, 4, smoother=sm, device="cpu")
    scaled = ELL(data=A.data * 2.5, cols=A.cols, shape=A.shape)
    hier2 = rebuild_hierarchy_values(hier, plans, scaled.data)
    fresh, _ = build_hierarchy_device(scaled, 4, smoother=sm, device="cpu")
    for lev, flev in zip(hier2.levels, fresh.levels):
        scale = float(flev.A.data.abs().max())
        assert float((lev.A.data - flev.A.data).abs().max()) <= 1e-13 * scale
        for x, y in zip(lev.smoother_state.diag, flev.smoother_state.diag):
            assert float((x - y).abs().max()) <= 1e-13 * scale
    u2 = vcycle(hier2, sm, torch.zeros_like(b), b)
    uf = vcycle(fresh, sm, torch.zeros_like(b), b)
    torch.testing.assert_close(u2, uf, rtol=1e-12, atol=1e-14)


def test_rebuild_needs_the_multicolor_smoother():
    A = poisson.laplacian(9, device="cpu")
    hier, plans = build_hierarchy_device(A, 3, smoother=SparseGaussSeidel(),
                                         device="cpu")
    with pytest.raises(NotImplementedError):
        rebuild_hierarchy_values(hier, plans, A.data)


def test_device_hierarchy_solve_equals_jax():
    """The device-built hierarchy at 35^2, 8 levels, multicolor GS: JAX's
    V-cycle count and rss, and the host chain's levels."""
    A, b = poisson.poisson2d(35, device="cpu")
    hier, _ = build_hierarchy_device(A, 8, device="cpu")
    res = solve(hier, MulticolorGaussSeidel(), b, tolerance=1e-9,
                compute_error_every_n_iters=5, n_iters=100)
    jA, jb = jpoisson.poisson2d(35)
    jhier, _ = jbuild_device(jA, 8)
    jres = jsolve(jhier, JMCGS(), jb, tolerance=1e-9,
                  compute_error_every_n_iters=5, n_iters=100)
    assert res.converged and res.iterations == jres.iterations
    assert res.error == pytest.approx(jres.error, rel=1e-9)
    host = build_hierarchy(A, 8, smoother=MulticolorGaussSeidel(),
                           device="cpu")
    for lev, hlev in zip(hier.levels, host.levels):
        d = abs(lev.A.to_scipy() - hlev.A.to_scipy()).max()
        assert d <= 1e-14 * abs(hlev.A.to_scipy()).max()
