"""amg_tpu_torch.parallel.structured_dist's variable-coefficient sharded
levels against amg_tpu's on the CPU (the 8-virtual-device mesh of
tests/conftest.py, f64): the padded planes of build_dist_hierarchy, the
plane strip exchange, the planes matvec, and V-cycles under every halo
mode, for force_var on the Poisson problem and for the jump problem
(a = 100, models/varcoef.py) given as A_fine.

The V-cycles start from the same numpy state: JAX's planes and
sub-hierarchy carried across (interop.dist_planes_from_numpy,
dist_hierarchy_from_numpy), the same random u. They agree within rtol
1e-11 / atol 1e-13, the JAX package's bound between its distributed and
single-device V-cycles; the planes and the exchange are copies, compared
bitwise. As in JAX, the ghost-strip var sweep gives the per-step sweep's
iterates bitwise (omega = 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from amg_tpu.models import poisson as jpoisson
from amg_tpu.models import varcoef as jvarcoef
from amg_tpu.parallel import structured_dist as J

from amg_tpu_torch.interop import (dist_hierarchy_from_numpy,
                                   dist_planes_from_numpy)
from amg_tpu_torch.models import poisson as tpoisson
from amg_tpu_torch.models import varcoef as tvarcoef
from amg_tpu_torch.parallel import structured_dist as T

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL, ATOL = 1e-11, 1e-13


def _mesh(D):
    return jax.make_mesh((D,), (J.AXIS,), devices=jax.devices()[:D])


def _kw(kind, side, port):
    if kind == "force_var":
        return {"force_var": True}
    mod = tvarcoef if port else jvarcoef
    return {"A_fine": mod.jump_scipy(side)}


def _port_state(js):
    """The port's (cfg, planes, sub_hier) from a JAX solver's."""
    fields = {f.name: getattr(js.cfg, f.name)
              for f in dataclasses.fields(js.cfg)}
    sh = js.sub_hier
    var_sub = any(S.w33 is None for S in sh.levels)
    cfg, sub = dist_hierarchy_from_numpy(
        fields, sh.sides, [S.w33 for S in sh.levels],
        np.asarray(sh.coarse_lu), np.asarray(sh.coarse_piv),
        [np.asarray(P1) for P1 in sh.P1s], device=CPU,
        sub_planes=([np.asarray(S.c) for S in sh.levels] if var_sub
                    else None))
    planes = tuple(None if w is not None
                   else dist_planes_from_numpy(np.asarray(c),
                                               cfg.n_devices, CPU)
                   for w, c in zip(js.cfg.w33s, js.coeffs))
    return cfg, planes, sub


def var_vcycle_pair(side, D, halo, kind, seed=0):
    js = J.DistStructuredSolver(side, n_devices=D, dtype=jnp.float64,
                                halo=halo, **_kw(kind, side, False))
    b_pad = js.pad_field(jpoisson.rhs(side, dtype=jnp.float64
                                      ).reshape(side, side))
    u0 = np.random.default_rng(seed).standard_normal(b_pad.shape)
    u0[side:] = 0.0
    ju = np.asarray(js.vcycle(jnp.asarray(u0), b_pad))
    cfg, planes, sub = _port_state(js)
    shape = (D, cfg.blocks[0], side)
    tu = T.vcycle_dist(cfg, sub, torch.tensor(u0).reshape(shape),
                       torch.tensor(np.asarray(b_pad)).reshape(shape),
                       planes=planes)
    return tu.reshape(-1, side).numpy(), ju


@pytest.mark.parametrize("kind", ["force_var", "jump"])
@pytest.mark.parametrize("side,D", [(31, 8), (63, 4)])
def test_build_dist_hierarchy_var_matches_jax(side, D, kind):
    """Equal config, planes (identity padding rows) and sub-hierarchy
    planes; constant sub-levels of force_var keep their weights."""
    jcfg, jc, jsub = J.build_dist_hierarchy(side, n_devices=D,
                                            dtype=jnp.float64,
                                            **_kw(kind, side, False))
    cfg, planes, sub = T.build_dist_hierarchy(side, n_devices=D,
                                              dtype=torch.float64,
                                              device=CPU,
                                              **_kw(kind, side, True))
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert all(w is None for w in cfg.w33s)
    for l, (c, jcl) in enumerate(zip(planes, jc)):
        assert c.shape == (3, 3, D, cfg.blocks[l], cfg.sides[l])
        np.testing.assert_array_equal(c.reshape(3, 3, -1, c.shape[-1])
                                      .numpy(), np.asarray(jcl))
    assert sub.w33s == tuple(S.w33 for S in jsub.levels)
    if kind == "jump":
        for l, S in enumerate(jsub.levels):
            np.testing.assert_array_equal(getattr(sub, f"c_{l}").numpy(),
                                          np.asarray(S.c))


@pytest.mark.parametrize("G", [2, 4, 10])
@pytest.mark.parametrize("D", [1, 2, 8])
def test_exchange_planes_matches_jax(D, G):
    """Single-hop (G <= B = 4) and multi-hop plane strips, bitwise."""
    B, n = 4, 5
    c = np.random.default_rng(D * 10 + G).standard_normal((3, 3, D * B, n))
    fn = jax.jit(jax.shard_map(
        lambda c_: J._exchange_planes(c_, G, D), mesh=_mesh(D),
        in_specs=P(None, None, J.AXIS, None),
        out_specs=P(None, None, J.AXIS, None)))
    want = np.asarray(fn(jnp.asarray(c))).reshape(3, 3, D, B + 2 * G, n)
    got = T._exchange_planes(torch.tensor(c).reshape(3, 3, D, B, n), G)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_matvec_var_matches_jax(D):
    """The planes matvec with its one-row halo (rss and PCG operator)
    within 1e-14 of JAX's (XLA may contract its multiply-adds), and the
    port's windowed var conv over exchanged strips bitwise equal to it."""
    side = 31
    jcfg, jc, _ = J.build_dist_hierarchy(side, n_devices=D,
                                         dtype=jnp.float64,
                                         A_fine=jvarcoef.jump_scipy(side))
    B = jcfg.blocks[0]
    u = np.random.default_rng(D).standard_normal((D * B, side))
    u[side:] = 0.0
    fn = jax.jit(jax.shard_map(
        lambda c_, u_: J._matvec_local(c_, u_, D), mesh=_mesh(D),
        in_specs=(P(None, None, J.AXIS, None), P(J.AXIS, None)),
        out_specs=P(J.AXIS, None)))
    want = np.asarray(fn(jc[0], jnp.asarray(u)))
    c = dist_planes_from_numpy(np.asarray(jc[0]), D, CPU)
    ut = torch.tensor(u).reshape(D, B, side)
    got = T._matvec_var(c, ut)
    np.testing.assert_allclose(got.reshape(-1, side).numpy(), want,
                               rtol=1e-14, atol=1e-14 * np.abs(want).max())
    # the same rows from the windowed conv on exchanged strips
    G = 4
    c_ext = T._exchange_planes(c, G)
    u_ext = T._windows(ut, G)
    np.testing.assert_array_equal(
        T._conv9_window(c_ext, u_ext)[:, G:G + B].numpy(), got.numpy())


@pytest.mark.parametrize("D,halo", [(8, h) for h in ("sweep", "step",
                                                     "overlap", "packed")]
                         + [(2, "sweep")])
def test_force_var_vcycle_matches_jax(D, halo):
    tu, ju = var_vcycle_pair(31, D, halo, "force_var")
    np.testing.assert_allclose(tu, ju, rtol=RTOL, atol=ATOL)
    assert np.abs(tu[31:]).max() == 0.0


@pytest.mark.parametrize("side,D,halo", [
    (31, 2, "sweep"), (31, 4, "sweep"), (31, 8, "sweep"), (31, 8, "step"),
    (63, 4, "sweep"), (63, 8, "step"), (31, 4, "rdma")])
def test_jump_vcycle_matches_jax(side, D, halo):
    """The jump problem under row slabs: variable sharded levels and
    variable levels in the replicated sub-hierarchy (var levels take the
    plain strip exchange under "rdma", as in JAX)."""
    tu, ju = var_vcycle_pair(side, D, halo, "jump", seed=side + D)
    np.testing.assert_allclose(tu, ju, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["force_var", "jump"])
def test_var_ghost_sweep_equals_step(kind):
    """JAX's contract (tests/test_distributed.py): the var ghost-strip
    V-cycle gives the per-color-step one bitwise, on the port's own
    build; the planes' strips were exchanged once, at setup."""
    side, D = 63, 8
    b2 = tpoisson.rhs(side, device=CPU).reshape(side, side)
    us = {}
    for halo in ("step", "sweep", "overlap", "packed"):
        s = T.DistStructuredSolver(side, n_devices=D, dtype=torch.float64,
                                   halo=halo, device=CPU,
                                   **_kw(kind, side, True))
        assert all(w is None for w in s.cfg.w33s)
        assert (s.planes_ext is None) == (halo == "step")
        bp = s.pad_field(b2)
        us[halo] = s.unpad(s.vcycle(torch.zeros_like(bp), bp))
    for halo in ("sweep", "overlap", "packed"):
        assert torch.equal(us[halo], us["step"]), halo


def test_jump_solve_matches_jax():
    """solve() on the jump problem, f64, the rss checked every cycle:
    JAX's V-cycle count, its rss history within 1e-6 and u within 1e-10
    (the JAX package's bound for its distributed solves)."""
    side, D = 63, 4
    b = np.asarray(jpoisson.rhs(side, dtype=jnp.float64)).reshape(side,
                                                                 side)
    kw = dict(tolerance=1e-9, compute_error_every_n_iters=1, n_iters=60)
    jr = J.DistStructuredSolver(side, n_devices=D, dtype=jnp.float64,
                                halo="sweep",
                                A_fine=jvarcoef.jump_scipy(side)
                                ).solve(jnp.asarray(b), **kw)
    ts = T.DistStructuredSolver(side, n_devices=D, dtype=torch.float64,
                                halo="sweep", device=CPU,
                                A_fine=tvarcoef.jump_scipy(side))
    tr = ts.solve(b, **kw)
    assert tr.converged and jr.converged
    assert tr.iterations == jr.iterations
    np.testing.assert_allclose([e for _, e in tr.history],
                               [e for _, e in jr.history], rtol=1e-6)
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), rtol=0,
                               atol=1e-10)
    # the rss reads the planes: an independent f64 evaluation agrees
    c = tvarcoef.jump_planes(side, dtype=torch.float64, device=CPU)
    up = torch.nn.functional.pad(tr.u, (1, 1, 1, 1))
    Au = sum(c[dj + 1, di + 1] * up[1 + dj:1 + dj + side,
                                    1 + di:1 + di + side]
             for dj in (-1, 0, 1) for di in (-1, 0, 1))
    ind = float(((torch.tensor(b) - Au) ** 2).sum())
    np.testing.assert_allclose(tr.error, ind, rtol=1e-6)
