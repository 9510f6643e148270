"""The variable-coefficient building blocks of amg_tpu_torch against
amg_tpu's on the same inputs (CPU; the JAX side with x64): the
jump-coefficient model, the closed-form Galerkin RAP chain, plane stencil
operators, the df32 plane residual, the packed-var ops, the plane
hierarchy and its interop.

Tolerances: elementwise f32 and f64 arithmetic in the reference's
operation order is compared bitwise (the model planes, the f32 RAP chain,
the df32 residual's TwoProd/TwoSum steps, data movement). Plane stencil
arithmetic in f64 within 1e-12 relative, the bound tests/test_packed.py
holds the JAX packed ops to, and the f64 RAP chain within 1e-12 (XLA may
order the f64 sums of a fused expression differently). The scipy assembly
(f64 throughout) against the f32 planes within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amg_tpu import structured as jst
from amg_tpu.models import varcoef as jvar
from amg_tpu.ops import doublefloat as jdf
from amg_tpu.ops import rap as jrap
from amg_tpu.sparse import packed as jp
from amg_tpu.sparse import stencil as jsten

from amg_tpu_torch import structured as tst
from amg_tpu_torch.interop import hierarchy_from_numpy, planes_from_numpy
from amg_tpu_torch.models import varcoef as tvar
from amg_tpu_torch.ops import doublefloat as tdf
from amg_tpu_torch.ops import rap as trap
from amg_tpu_torch.sparse import packed as tp
from amg_tpu_torch.sparse.stencil import (Stencil2D, color_masks_iota,
                                          detect_const_stencil,
                                          gs4_sweep_masked)

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _close(t, j, rtol=1e-12):
    want = np.asarray(j)
    assert np.abs(t.numpy() - want).max() <= rtol * np.abs(want).max()


def _field(side, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(
        (side, side)).astype(dtype)


def _jump(side, dtype=jnp.float32, **kw):
    """The jump planes from both packages: (torch, numpy from JAX)."""
    tdt = torch.float32 if dtype == jnp.float32 else torch.float64
    return (tvar.jump_planes(side, dtype=tdt, device=CPU, **kw),
            np.asarray(jvar.jump_planes(side, dtype=dtype, **kw)))


@pytest.mark.parametrize("a_in,eps_y", [(100.0, 1.0), (1.0, 0.1),
                                        (1e3, 1.0)])
def test_jump_planes_bitwise(a_in, eps_y):
    side = 63
    t, j = _jump(side, a_in=a_in, eps_y=eps_y)
    assert t.dtype == torch.float32
    _eq(t, j)
    _eq(tvar.jump_coefficient(side, a_in, device=CPU),
        jvar.jump_coefficient(side, a_in))


def test_jump_planes_bitwise_f64():
    t, j = _jump(31, dtype=jnp.float64, a_in=100.0)
    _eq(t, j)


@pytest.mark.parametrize("a_in,eps_y", [(100.0, 1.0), (1.0, 0.1)])
def test_jump_scipy_matches_planes(a_in, eps_y):
    side = 31
    A = tvar.jump_scipy(side, a_in, eps_y=eps_y)
    assert abs(A - jvar.jump_scipy(side, a_in, eps_y=eps_y)).max() == 0.0
    S = Stencil2D.from_scipy(A, side)
    t, _ = _jump(side, a_in=a_in, eps_y=eps_y)
    # a uniform coefficient is a constant (anisotropic) stencil
    assert (S.w33 is None) == (a_in != 1.0) and S.c.dtype == torch.float64
    _close(t.double(), S.c.numpy(), rtol=1e-6)


def test_poisson_planes_bitwise_and_unit_jump():
    side = 63
    t = trap.poisson_planes(side, device=CPU)
    _eq(t, jrap.poisson_planes(side))
    _eq(tvar.jump_planes(side, a_in=1.0, device=CPU), t)
    w33 = trap.poisson_const_w33(side, 1)[0]
    assert detect_const_stencil(t.numpy(), side) == w33
    assert Stencil2D.from_planes(t, side).w33 == w33
    assert Stencil2D.from_planes(_jump(side)[0], side).w33 is None


def test_rap_chain_bitwise_f32():
    side = 127            # six levels: 127 63 31 15 7 3
    t, j = _jump(side)
    tj, jj = t, jnp.asarray(j)
    n_levels = 0
    while tj.shape[-1] > 3:
        tj, jj = trap.rap_stencil_planes(tj), jrap.rap_stencil_planes(jj)
        _eq(tj, jj)
        n_levels += 1
    assert n_levels == 5


def test_rap_chain_f64():
    t, j = _jump(63, dtype=jnp.float64)
    for _ in range(4):
        t, j = trap.rap_stencil_planes(t), jax.jit(
            jrap.rap_stencil_planes)(jnp.asarray(j))
        _close(t, j)


def test_plane_matvec2_and_inv_diag():
    side = 63
    t, j = _jump(side, dtype=jnp.float64)
    u = _field(side, 1)
    JS = jsten.Stencil2D(c=jnp.asarray(j), side=side, w33=None)
    S = Stencil2D(side=side, c=t)
    _close(S.matvec2(torch.tensor(u)), JS.matvec2(jnp.asarray(u)))
    _eq(S.inv_diag(), JS.inv_diag())
    _eq(S.diag(), JS.diag())


@pytest.mark.parametrize("symmetric", [True, False])
def test_gs4_sweep_masked_on_planes(symmetric):
    side = 31
    t, j = _jump(side, dtype=jnp.float64)
    u, b = _field(side, 2), _field(side, 3)
    want = jsten.gs4_sweep_masked(
        jsten.Stencil2D(c=jnp.asarray(j), side=side, w33=None),
        jnp.asarray(u), jnp.asarray(b), jsten.color_masks_iota(
            side, jnp.float64), 0.9, symmetric)
    got = gs4_sweep_masked(Stencil2D(side=side, c=t), torch.tensor(u),
                           torch.tensor(b),
                           color_masks_iota(side, torch.float64), 0.9,
                           symmetric)
    _close(got, want)


def test_df_residual_bitwise():
    side = 63
    t, j = _jump(side, dtype=jnp.float64)
    c_t, c_j = tdf.DF32.from_f64(t), jdf.DF32.from_f64(jnp.asarray(j))
    b, u = _field(side, 4), _field(side, 5)
    b_t, b_j = tdf.DF32.from_f64(torch.tensor(b)), jdf.DF32.from_f64(
        jnp.asarray(b))
    u_t, u_j = tdf.DF32.from_f64(torch.tensor(u)), jdf.DF32.from_f64(
        jnp.asarray(u))
    r_t = tdf.df_residual(c_t, b_t, u_t)
    r_j = jdf.df_residual(c_j, b_j, u_j)
    _eq(r_t.hi, r_j.hi)
    _eq(r_t.lo, r_j.lo)


def test_pack_planes_bitwise():
    side = 63
    m = (side - 1) // 2
    t, j = _jump(side)
    cp = tp.pack_planes(t, m)
    assert cp.shape == (3, 3, 4, m + 1, m + 1)
    _eq(cp, jp.pack_planes(jnp.asarray(j), m))


@pytest.mark.parametrize("symmetric", [True, False])
def test_gs4_sweep_packed_var_matches_jax(symmetric):
    side = 63
    m = (side - 1) // 2
    t, j = _jump(side, dtype=jnp.float64)
    u, b = _field(side, 6), _field(side, 7)
    want = jp.gs4_sweep_packed_var(jp.pack_planes(jnp.asarray(j), m),
                                   jp.pack(jnp.asarray(u), m),
                                   jp.pack(jnp.asarray(b), m), m, 0.9,
                                   symmetric)
    u4 = tp.pack(torch.tensor(u), m)
    u_copy = u4.clone()
    got = tp.gs4_sweep_packed_var(tp.pack_planes(t, m), u4,
                                  tp.pack(torch.tensor(b), m), m, 0.9,
                                  symmetric)
    _close(got, want)
    assert torch.equal(u4, u_copy)
    assert float(got[3][m, :].abs().max()) == 0.0   # pad cells stay 0


def test_residual_packed_var_matches_jax():
    side = 63
    m = (side - 1) // 2
    t, j = _jump(side, dtype=jnp.float64)
    u, b = _field(side, 8), _field(side, 9)
    want = jp.residual_packed_var(jp.pack_planes(jnp.asarray(j), m),
                                  jp.pack(jnp.asarray(u), m),
                                  jp.pack(jnp.asarray(b), m), m)
    got = tp.residual_packed_var(tp.pack_planes(t, m),
                                 tp.pack(torch.tensor(u), m),
                                 tp.pack(torch.tensor(b), m), m)
    _close(got, want)
    # and equals the unpacked plane residual
    _close(tp.unpack(got, m),
           torch.tensor(b) - Stencil2D(side=side, c=t).matvec2(
               torch.tensor(u)))


@pytest.mark.parametrize("smoother", ["packed", "fused"])
def test_plane_hierarchy_matches_jax(smoother):
    side = 255
    t, j = _jump(side)
    jh = jst.build_stencil_hierarchy_planes(jnp.asarray(j),
                                            smoother=smoother)
    th = tst.build_stencil_hierarchy_planes(t, device=CPU,
                                            smoother=smoother)
    assert th.sides == tuple(jh.sides) and th.is_var
    assert th.smoother == smoother
    for tl, jl in zip(th.levels, jh.levels):
        assert tl.w33 is None and jl.w33 is None
        _eq(tl.c, jl.c)
    for tP, jP in zip(th.P1s, jh.P1s):
        _eq(tP, jP)
    # packed planes are built once, on the packed levels only
    assert hasattr(th, "cp_0") == (smoother == "packed")
    assert not hasattr(th, "cp_1")
    _eq(th.packed_planes(0), jp.pack_planes(jh.levels[0].c, 127))
    nc = th.sides[-1]
    bc = np.random.default_rng(10).standard_normal((nc, nc)).astype(
        np.float32)
    want = jax.scipy.linalg.lu_solve((jh.coarse_lu, jh.coarse_piv),
                                     jnp.asarray(bc).reshape(-1))
    got = th.coarse_solve(torch.tensor(bc))
    np.testing.assert_allclose(got.numpy().reshape(-1), np.asarray(want),
                               rtol=1e-5, atol=1e-7)


def test_plane_interop_round_trip():
    side = 127
    t, j = _jump(side)
    jh = jst.build_stencil_hierarchy_planes(jnp.asarray(j),
                                            smoother="packed")
    th = hierarchy_from_numpy(
        jh.sides, [None] * len(jh.sides), np.asarray(jh.coarse_lu),
        np.asarray(jh.coarse_piv), [np.asarray(P) for P in jh.P1s],
        planes=[np.asarray(lv.c) for lv in jh.levels], smoother="packed",
        packed_min_side=100, device=CPU)
    own = tst.build_stencil_hierarchy_planes(t, device=CPU,
                                             smoother="packed",
                                             packed_min_side=100)
    assert th.is_var and hasattr(th, "cp_0") and hasattr(own, "cp_0")
    for a, b in zip(th.levels, own.levels):
        assert torch.equal(a.c, b.c)
    b2 = torch.tensor(_field(side, 11, np.float32))
    u_interop = tst.vcycle_packed(th, torch.zeros_like(b2), b2,
                                  min_side=100)
    u_own = tst.vcycle_packed(own, torch.zeros_like(b2), b2, min_side=100)
    assert float((u_interop - u_own).abs().max()
                 / u_own.abs().max()) < 1e-5
    with pytest.raises(ValueError):
        planes_from_numpy(np.zeros((3, 3, 5, 4)))


def test_var_vcycle_packed_matches_jax():
    """The packed-var V-cycle (the smoother="auto" var solve cycle) from
    the same hierarchy state: the JAX hierarchy carried across."""
    side = 255
    _, j = _jump(side)
    jh = jst.build_stencil_hierarchy_planes(jnp.asarray(j),
                                            smoother="packed")
    th = hierarchy_from_numpy(
        jh.sides, [None] * len(jh.sides), np.asarray(jh.coarse_lu),
        np.asarray(jh.coarse_piv), [np.asarray(P) for P in jh.P1s],
        planes=[np.asarray(lv.c) for lv in jh.levels], smoother="packed",
        device=CPU)
    b = _field(side, 12, np.float32)
    want = np.asarray(jst.vcycle_packed(jh, jnp.zeros_like(jnp.asarray(b)),
                                        jnp.asarray(b)))
    plan = tst.level_plan(th, 1, 1, 200, False)
    assert plan[0] == "packed_var" and plan[1] == "masked_k12"
    got = tst.vcycle_packed(th, torch.zeros(side, side), torch.tensor(b),
                            plan=plan).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
