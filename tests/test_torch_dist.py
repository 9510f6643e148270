"""amg_tpu_torch.parallel.structured_dist against amg_tpu's on the CPU: the
distribution plan, the host hierarchy, the strip exchanges, the sharded
df32 residual, and one V-cycle with halo="sweep" and halo="step" on the
8-virtual-device mesh of tests/conftest.py (f64, x64).

The port runs the D slabs as one tensor axis on one device; the JAX
package one shard per virtual device. The V-cycles start from the same
numpy state and the same operator (interop.dist_hierarchy_from_numpy) and
agree within rtol 1e-11 / atol 1e-13, the JAX package's own bound between
its distributed and single-device V-cycles (tests/test_distributed.py).
The exchanges and the df32 residual are copies and exact error-free
arithmetic, so they are compared bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import PartitionSpec as P

from amg_tpu.models import poisson as jpoisson
from amg_tpu.ops import transfer as jtransfer
from amg_tpu.ops.doublefloat import DF32 as JDF32
from amg_tpu.parallel import structured_dist as J
from amg_tpu.sparse import stencil as jstencil

from amg_tpu_torch import structured as tst
from amg_tpu_torch.interop import dist_hierarchy_from_numpy
from amg_tpu_torch.models import poisson as tpoisson
from amg_tpu_torch.ops import transfer as ttransfer
from amg_tpu_torch.ops.doublefloat import DF32
from amg_tpu_torch.parallel import structured_dist as T
from amg_tpu_torch.sparse import stencil as tstencil

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL, ATOL = 1e-11, 1e-13


def _mesh(D):
    return jax.make_mesh((D,), (J.AXIS,), devices=jax.devices()[:D])


def _port_state(js):
    """The port's (cfg, sub_hier) from a JAX solver's, through numpy."""
    fields = {f.name: getattr(js.cfg, f.name)
              for f in dataclasses.fields(js.cfg)}
    sh = js.sub_hier
    return dist_hierarchy_from_numpy(
        fields, sh.sides, [S.w33 for S in sh.levels],
        np.asarray(sh.coarse_lu), np.asarray(sh.coarse_piv),
        [np.asarray(P1) for P1 in sh.P1s], device=CPU)


def vcycle_pair(side, D, halo, seed=0):
    """One V-cycle of JAX's solver and of the port on its state, from the
    same random u (zero on padding rows) and the Poisson rhs: returns both
    (n_pad, side) results as numpy."""
    js = J.DistStructuredSolver(side, n_devices=D, dtype=jnp.float64,
                                halo=halo)
    b_pad = js.pad_field(jpoisson.rhs(side, dtype=jnp.float64
                                      ).reshape(side, side))
    u0 = np.random.default_rng(seed).standard_normal(b_pad.shape)
    u0[side:] = 0.0
    ju = np.asarray(js.vcycle(jnp.asarray(u0), b_pad))
    cfg, sub = _port_state(js)
    shape = (D, cfg.blocks[0], side)
    tu = T.vcycle_dist(cfg, sub, torch.tensor(u0).reshape(shape),
                       torch.tensor(np.asarray(b_pad)).reshape(shape))
    return tu.reshape(-1, side).numpy(), ju


# -- model, transfer and stencil pieces -------------------------------------


@pytest.mark.parametrize("n", [3, 7, 31])
def test_scipy_operators_match_jax(n):
    for tf, jf in ((tpoisson.laplacian_scipy, jpoisson.laplacian_scipy),
                   (tpoisson.second_order_central_difference,
                    jpoisson.second_order_central_difference)):
        a, b = tf(n), jf(n)
        assert a.shape == b.shape and (a != b).nnz == 0
    nc = (n - 1) // 2
    a = ttransfer.linear_interp_1d(n, nc)
    assert (a != jtransfer.linear_interp_1d(n, nc)).nnz == 0
    for h in (1.0 / 50, 2.0 / (n + 1), 0.1):
        assert (tpoisson.points_n_from_grid_spacing_h(h)
                == jpoisson.points_n_from_grid_spacing_h(h))
    np.testing.assert_array_equal(tstencil.W2D, jstencil.W2D)


# -- plan and hierarchy ------------------------------------------------------


@pytest.mark.parametrize("D", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("side", [7, 31, 63, 255, 4095])
def test_plan_distribution_matches_jax(side, D):
    for n_levels in range(1, tst.max_levels_for_side(side) + 1):
        assert (T.plan_distribution(side, n_levels, D)
                == J.plan_distribution(side, n_levels, D))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("side,D", [(31, 8), (63, 4), (63, 2), (127, 3)])
def test_build_dist_hierarchy_matches_jax(side, D, dtype):
    """The config (plan and every sharded level's w33, which
    Stencil2D.from_scipy finds on the scipy RAP chain) is equal; the
    replicated sub-hierarchy's weights and transfers equal, its LU within
    1e-12."""
    jcfg, _, jsub = J.build_dist_hierarchy(side, n_devices=D,
                                           dtype=getattr(jnp, dtype))
    cfg, sub = T.build_dist_hierarchy(side, n_devices=D,
                                      dtype=getattr(torch, dtype),
                                      device=CPU)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert all(w is not None for w in cfg.w33s)
    assert sub.sides == jsub.sides
    assert sub.w33s == tuple(S.w33 for S in jsub.levels)
    for P1, jP1 in zip(sub.P1s, jsub.P1s):
        np.testing.assert_array_equal(P1.numpy(), np.asarray(jP1))
    np.testing.assert_allclose(sub.coarse_lu.numpy(),
                               np.asarray(jsub.coarse_lu),
                               rtol=1e-12 if dtype == "float64" else 1e-6,
                               atol=0)
    np.testing.assert_array_equal(sub.coarse_piv.numpy() - 1,
                                  np.asarray(jsub.coarse_piv))


# -- exchanges -----------------------------------------------------------------


@pytest.mark.parametrize("G", [2, 4, 6, 10])
@pytest.mark.parametrize("D", [1, 2, 8])
def test_exchange_strips_matches_jax(D, G):
    """Single-hop (G <= B = 4) and multi-hop (G > B) strip exchanges."""
    B, n = 4, 5
    rng = np.random.default_rng(D * 10 + G)
    u = rng.standard_normal((D * B, n))
    b = rng.standard_normal((D * B, n))
    fn = jax.jit(jax.shard_map(
        lambda u_, b_: J._exchange_strips(u_, b_, G, D), mesh=_mesh(D),
        in_specs=(P(J.AXIS, None), P(J.AXIS, None)),
        out_specs=(P(J.AXIS, None), P(J.AXIS, None))))
    ju, jb = (np.asarray(x).reshape(D, B + 2 * G, n)
              for x in fn(jnp.asarray(u), jnp.asarray(b)))
    tu, tb = T._exchange_strips(torch.tensor(u).reshape(D, B, n),
                                torch.tensor(b).reshape(D, B, n), G)
    np.testing.assert_array_equal(tu.numpy(), ju)
    np.testing.assert_array_equal(tb.numpy(), jb)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_halo_rows_and_df_residual_match_jax(D):
    """The one-row halo (via the step-mode matvec) and the sharded df32
    residual with exact (hi, lo) weight pairs, bitwise."""
    side = 31
    cfg, _ = T.build_dist_hierarchy(side, n_devices=D, device=CPU)
    B, w33 = cfg.blocks[0], cfg.w33s[0]
    rng = np.random.default_rng(D)
    fields = []
    for scale in (1.0, 1e-8, 1.0, 1e-8):
        f = (rng.standard_normal((D * B, side)) * scale).astype(np.float32)
        f[side:] = 0.0
        fields.append(f)

    def body(uh_, ul_, bh_, bl_):
        r = J._df_residual_const(w33, JDF32(hi=bh_, lo=bl_),
                                 JDF32(hi=uh_, lo=ul_), side, B, D)
        return r.hi, r.lo, J._matvec_const(w33, uh_, side, B, D)

    spec = P(J.AXIS, None)
    jout = jax.jit(jax.shard_map(body, mesh=_mesh(D), in_specs=(spec,) * 4,
                                 out_specs=(spec,) * 3))(
        *map(jnp.asarray, fields))
    t = [torch.tensor(f).reshape(D, B, side) for f in fields]
    r = T._df_residual_const(w33, DF32(hi=t[2], lo=t[3]),
                             DF32(hi=t[0], lo=t[1]), side)
    av = T._matvec_const(w33, t[0], side)
    for got, want in zip((r.hi, r.lo, av), jout):
        np.testing.assert_array_equal(got.reshape(-1, side).numpy(),
                                      np.asarray(want))


# -- V-cycles ------------------------------------------------------------------


@pytest.mark.parametrize("halo", ["sweep", "step"])
@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("side", [31, 63])
def test_vcycle_matches_jax(side, D, halo):
    tu, ju = vcycle_pair(side, D, halo)
    np.testing.assert_allclose(tu, ju, rtol=RTOL, atol=ATOL)
    assert np.abs(tu[side:]).max() == 0.0   # padding rows stay zero


@pytest.mark.parametrize("halo", ["sweep", "overlap", "rdma", "step"])
@pytest.mark.parametrize("D", [1, 3, 8])
@pytest.mark.parametrize("side", [31, 63])
def test_vcycle_matches_single_device(side, D, halo):
    """The port's distributed V-cycle from u = 0 against the port's single-
    device cycle_stencil on the closed-form hierarchy (f64)."""
    s = T.DistStructuredSolver(side, n_devices=D, dtype=torch.float64,
                               halo=halo, device=CPU)
    hier = tst.build_stencil_hierarchy_device(
        side, len(s.cfg.sides), dtype=torch.float64, device=CPU)
    b2 = tpoisson.rhs(side, device=CPU).reshape(side, side)
    bp = s.pad_field(b2)
    got = s.unpad(s.vcycle(torch.zeros_like(bp), bp))
    want = tst.cycle_stencil(hier, torch.zeros_like(b2), b2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


# -- entry point ----------------------------------------------------------------


def test_halo_default_and_modes():
    s = T.DistStructuredSolver(31, n_devices=2, device=CPU)
    assert s.cfg.halo == "step"          # JAX's choice off the accelerator
    assert s.n_pad == 32 and s.dtype == torch.float32
    with pytest.raises(ValueError, match="unknown halo"):
        T.DistStructuredSolver(31, n_devices=2, halo="ring", device=CPU)


def test_unported_options_raise():
    def make(**kw):
        return T.DistStructuredSolver(31, n_devices=2, device=CPU, **kw)

    for kw in ({"halo": "packed"}, {"force_var": True},
               {"config": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make(**kw)
    A = tpoisson.laplacian_scipy(31) @ sp.diags(np.linspace(1.0, 2.0,
                                                            31 * 31))
    with pytest.raises(NotImplementedError, match="variable-coefficient"):
        make(A_fine=A)
    with pytest.raises(NotImplementedError, match="Krylov"):
        make().solve_pcg(np.zeros((31, 31)))
    # a constant A_fine is the Poisson operator again
    assert make(A_fine=tpoisson.laplacian_scipy(31)).cfg.w33s == \
        make().cfg.w33s


def test_device_none_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.DistStructuredSolver(31, n_devices=2)
    with pytest.raises(RuntimeError, match="n_devices=None"):
        T.DistStructuredSolver(31, device=CPU)
