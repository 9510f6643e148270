"""amg_tpu_torch.parallel.ell_dist against amg_tpu's on the CPU (the
8-virtual-device mesh of tests/conftest.py): the sharded operators, the
window exchanges and extended panels (host numpy and copies: bitwise),
the solver's structure (sharded prefix, colors, strip depths from the
true bandwidth), and EllDistSolver's solve, solve_pcg (f64) and solve_ir
(f32 V-cycles, df32 residual) on the reference's flat pipeline and the
bilinear one.

The f64 V-cycles agree with JAX's within rtol 1e-11 / atol 1e-13 (the
row sums of the gathers round apart; the JAX package holds its
distributed ELL solve to 1e-8 of its single-device one), the rss
histories within 1e-6 (near 1e-10 the rss is mostly the rounding of the
residual). The replicated sub-hierarchy runs the port's multicolor GS;
JAX's drops row 0's update where row 0's color has padding (ROADMAP
Queue 3), so the hierarchies here are ones where row 0's color is the
largest, which test_row_0_color_is_the_largest asserts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import PartitionSpec as P

from amg_tpu.config import MeshConfig as JMeshConfig
from amg_tpu.models import poisson as jpoisson
from amg_tpu.ops.transfer import BilinearInterpolator2D as JBilinear
from amg_tpu.parallel import ell_dist as J

from amg_tpu_torch.config import MeshConfig
from amg_tpu_torch.interop import sharded_op_from_numpy
from amg_tpu_torch.models import poisson as tpoisson
from amg_tpu_torch.ops.transfer import BilinearInterpolator2D
from amg_tpu_torch.parallel import ell_dist as T

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL, ATOL = 1e-11, 1e-13


def _mesh(D):
    return jax.make_mesh((D,), (J.AXIS,), devices=jax.devices()[:D])


def _problem(n):
    A, b = jpoisson.poisson2d(n)
    At, bt = tpoisson.poisson2d(n, device=CPU)
    return A, b, At, bt


def _long_range(n=31):
    """JAX's tests/test_ell_dist.py case: a 1-D Laplacian with in-block
    couplings of reach 10 (true bandwidth 10, block overflow W ~ 1)."""
    main = 2.0 * np.ones(n)
    off = -1.0 * np.ones(n - 1)
    A = sp.diags([off, main, off], [-1, 0, 1]).tolil()
    for i in range(2, 6):
        A[i, i + 10] = -0.2
        A[i + 10, i] = -0.2
        A[i, i] += 0.2
        A[i + 10, i + 10] += 0.2
    return A.tocsr(), np.random.default_rng(0).standard_normal(n)


@pytest.mark.parametrize("B_row,B_x", [(10, 10), (6, 10), (10, 6)])
def test_sharded_op_matches_jax(B_row, B_x):
    """ShardedOp.build: data, window columns and W equal; the slab matvec
    equals scipy's (identity padding rows keep x's zeros)."""
    D = 4
    M = (jpoisson.laplacian_scipy(6) if B_row == B_x
         else sp.random(D * B_row - 3, D * B_x - 2, density=0.2,
                        random_state=1, format="csr"))
    jop = J.ShardedOp.build(M, D, B_row, B_x, jnp.float64)
    op = T.ShardedOp.build(M, D, B_row, B_x, torch.float64, device=CPU)
    assert (op.B_row, op.B_x, op.W) == (jop.B_row, jop.B_x, jop.W)
    np.testing.assert_array_equal(op.data.reshape(D * B_row, -1).numpy(),
                                  np.asarray(jop.data))
    np.testing.assert_array_equal(op.cols.reshape(D * B_row, -1).numpy(),
                                  np.asarray(jop.cols))
    carried = sharded_op_from_numpy(jop.data, jop.cols, B_row, B_x, jop.W,
                                    device=CPU)
    assert torch.equal(carried.data, op.data)
    assert torch.equal(carried.cols, op.cols)
    x = np.zeros(D * B_x)
    x[:M.shape[1]] = np.random.default_rng(0).standard_normal(M.shape[1])
    y = T._matvec_local(op, torch.tensor(x).reshape(D, B_x)).reshape(-1)
    np.testing.assert_allclose(y[:M.shape[0]].numpy(), M @ x[:M.shape[1]],
                               rtol=1e-13, atol=1e-14)
    if B_row == B_x:
        assert y[M.shape[0]:].abs().max() == 0.0


def test_sharded_op_from_numpy_checks():
    with pytest.raises(ValueError, match="must be"):
        sharded_op_from_numpy(np.zeros((7, 3)), np.zeros((7, 3), int), 2,
                              2, 1, device=CPU)
    with pytest.raises(ValueError, match="must lie in"):
        sharded_op_from_numpy(np.zeros((4, 3)), np.full((4, 3), 9), 2, 2,
                              1, device=CPU)


@pytest.mark.parametrize("W", [1, 3, 5])
@pytest.mark.parametrize("D", [1, 2, 8])
def test_window_exchanges_match_jax(D, W):
    """_exchange_w and _exchange_strips_1d, bitwise."""
    B = 6
    rng = np.random.default_rng(D + W)
    u, b = rng.standard_normal((2, D * B))
    spec = P(J.AXIS)
    left, right = (np.asarray(x).reshape(D, W) for x in jax.jit(
        jax.shard_map(lambda x: J._exchange_w(x, W, D), mesh=_mesh(D),
                      in_specs=spec, out_specs=(spec, spec)))(
        jnp.asarray(u)))
    tl, tr = T._exchange_w(torch.tensor(u).reshape(D, B), W)
    np.testing.assert_array_equal(tl.numpy(), left)
    np.testing.assert_array_equal(tr.numpy(), right)
    ju, jb = (np.asarray(x).reshape(D, B + 2 * W) for x in jax.jit(
        jax.shard_map(lambda x, y: J._exchange_strips_1d(x, y, W, D),
                      mesh=_mesh(D), in_specs=(spec, spec),
                      out_specs=(spec, spec)))(jnp.asarray(u),
                                               jnp.asarray(b)))
    tu, tb = T._exchange_strips_1d(torch.tensor(u).reshape(D, B),
                                   torch.tensor(b).reshape(D, B), W)
    np.testing.assert_array_equal(tu.numpy(), ju)
    np.testing.assert_array_equal(tb.numpy(), jb)


@pytest.mark.parametrize("halo", ["step", "strips"])
@pytest.mark.parametrize("n,L,D", [(35, 6, 8), (20, 5, 4)])
def test_solver_structure_matches_jax(n, L, D, halo):
    """Sharded prefix, blocks, strip depths (true bandwidth), colors and
    diagonals, extended panels and the boundary prolongation: equal."""
    A, b, At, bt = _problem(n)
    js = J.EllDistSolver(A, b, L, n_devices=D, dtype=jnp.float64,
                         halo=halo)
    ts = T.EllDistSolver(At, bt, L, n_devices=D, halo=halo, device=CPU)
    assert (ts.Ls, ts.sizes, ts.Bs) == (js.Ls, js.sizes, js.Bs)
    assert ts._ext_meta == js._ext_meta
    assert (halo == "strips") == any(h is not None for h in ts._ext_meta)
    for l, (lv, jlv) in enumerate(zip(ts.levels, js.levels)):
        C = lv["masks"].shape[0]
        np.testing.assert_array_equal(lv["masks"].reshape(C, -1).numpy(),
                                      np.asarray(jlv["masks"]))
        np.testing.assert_array_equal(lv["diag"].reshape(-1).numpy(),
                                      np.asarray(jlv["diag"]))
        for key in "ARP":
            assert lv[key].W == jlv[key].W
        for t, j in zip(ts._ext[l], js._ext_arrs[l]):
            np.testing.assert_array_equal(
                t.numpy().reshape(np.asarray(j).shape), np.asarray(j))
    np.testing.assert_array_equal(ts._Pb_cols.reshape(-1, ts._Pb_cols.shape[
        -1]).numpy(), np.asarray(js._Pb_cols))


@pytest.mark.parametrize("halo,D,L", [("step", 8, 6), ("strips", 8, 6),
                                      ("strips", 4, 6), ("step", 2, 5)])
def test_solve_and_pcg_match_jax(halo, D, L):
    """solve() with the rss every cycle and solve_pcg, f64: JAX's counts,
    histories within 1e-6, u within rtol 1e-11 / atol 1e-13."""
    A, b, At, bt = _problem(35)
    js = J.EllDistSolver(A, b, L, n_devices=D, dtype=jnp.float64,
                         halo=halo)
    ts = T.EllDistSolver(At, bt, L, n_devices=D, halo=halo, device=CPU)
    kw = dict(tolerance=1e-9, compute_error_every_n_iters=1, n_iters=60)
    jr, tr = js.solve(**kw), ts.solve(**kw)
    assert tr.converged and jr.converged
    assert tr.iterations == jr.iterations
    np.testing.assert_allclose([e for _, e in tr.history],
                               [e for _, e in jr.history], rtol=1e-6)
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), rtol=RTOL,
                               atol=ATOL)
    jp, tp = (s.solve_pcg(tolerance=1e-9, n_iters=50) for s in (js, ts))
    assert tp.converged and tp.iterations == jp.iterations
    assert tp.history == [(tp.iterations, tp.error)]
    np.testing.assert_allclose(tp.error, jp.error, rtol=1e-6)
    np.testing.assert_allclose(tp.u.numpy(), np.asarray(jp.u), rtol=RTOL,
                               atol=ATOL)


def test_bilinear_vcycles_match_jax():
    """The bilinear transfer (chip_smoke.py's 1023^2 cell, cut to 31^2): five
    V-cycles from zero under "strips"."""
    n = 31
    A, b, At, bt = _problem(n)
    js = J.EllDistSolver(A, b, 4, n_devices=4, dtype=jnp.float64,
                         interpolator=JBilinear(n), halo="strips")
    ts = T.EllDistSolver(At, bt, 4, n_devices=4, halo="strips",
                         interpolator=BilinearInterpolator2D(n), device=CPU)
    assert ts._ext_meta == js._ext_meta and ts._ext_meta[0] is not None
    ju, tu = js.pad_vec(b), ts.pad_vec(bt)
    jb, tb = ju, tu
    ju, tu = jnp.zeros_like(ju), torch.zeros_like(tu)
    for _ in range(5):
        ju, tu = js.vcycle_once(ju, jb), ts.vcycle_once(tu, tb)
        np.testing.assert_allclose(ts.rss(tu, tb), js.rss(ju, jb),
                                   rtol=1e-9)
    np.testing.assert_allclose(ts.unpad_vec(tu).numpy(),
                               np.asarray(js.unpad_vec(ju)), rtol=RTOL,
                               atol=ATOL)


def test_strips_equal_step():
    """JAX's contract: the ghost-strip sweep gives the per-step iterates
    (rtol 1e-12 / atol 1e-13, JAX's bound)."""
    A, b, At, bt = _problem(35)
    us = []
    for halo in ("step", "strips"):
        s = T.EllDistSolver(At, bt, 6, n_devices=8, halo=halo, device=CPU)
        bp = s.pad_vec(s.b)
        u = torch.zeros_like(bp)
        for _ in range(3):
            u = s.vcycle_once(u, bp)
        us.append(s.unpad_vec(u).numpy())
    np.testing.assert_allclose(us[1], us[0], rtol=1e-12, atol=1e-13)


def test_strips_true_bandwidth_gating():
    """The long-range coupling: strips are ineligible (their depth comes
    from the true reach, not W), as in JAX, and the solve matches JAX's
    and the direct solution."""
    A, b = _long_range()
    js = J.EllDistSolver(A, b, n_levels=2, n_devices=2, halo="strips")
    ts = T.EllDistSolver(A, b, n_levels=2, n_devices=2, halo="strips",
                         device=CPU)
    assert ts._ext_meta == js._ext_meta == [None]
    jr = js.solve(tolerance=1e-9, n_iters=100)
    tr = ts.solve(tolerance=1e-9, n_iters=100)
    assert tr.converged and tr.iterations == jr.iterations
    np.testing.assert_allclose(tr.u.numpy(), np.linalg.solve(A.toarray(),
                                                             b),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), rtol=RTOL,
                               atol=ATOL)


def test_solve_ir_matches_jax():
    """The df32 defect correction around f32 V-cycles ("strips"): JAX's
    refines, the history within 1e-3 (f32 V-cycles round apart), u within
    1e-10 of JAX's and 1e-5 of the direct solution (JAX's bound)."""
    A, b, At, bt = _problem(35)
    js = J.EllDistSolver(A, b, 6, n_devices=8, dtype=jnp.float32,
                         halo="strips")
    ts = T.EllDistSolver(At, bt, 6, n_devices=8, dtype=torch.float32,
                         halo="strips", device=CPU)
    jr, tr = js.solve_ir(tolerance=1e-9), ts.solve_ir(tolerance=1e-9)
    assert tr.converged and tr.error <= 1e-9
    assert tr.iterations == jr.iterations
    np.testing.assert_allclose([e for _, e in tr.history],
                               [e for _, e in jr.history], rtol=1e-3)
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), rtol=0,
                               atol=1e-10)
    u_dir = np.linalg.solve(At.to_dense().numpy(), bt.numpy())
    assert np.abs(tr.u.numpy() - u_dir).max() < 1e-5
    f64 = T.EllDistSolver(At, bt, 6, n_devices=8, device=CPU)
    with pytest.raises(NotImplementedError, match="f32"):
        f64.solve_ir()


def test_config_and_options():
    """config= as JAX reads it; bad halo and a problem too small raise."""
    side = 15
    A = tpoisson.laplacian_scipy(side)
    b = tpoisson.rhs(side, device=CPU).numpy()
    s = T.EllDistSolver(A, b, 3, n_devices=2, dtype=torch.float32,
                        device=CPU, config=MeshConfig(cycles_per_refine=3,
                                                      halo="strips"))
    js = J.EllDistSolver(A, b, 3, n_devices=2, dtype=jnp.float32,
                         config=JMeshConfig(cycles_per_refine=3,
                                            halo="strips"))
    assert (s.cycles_per_refine, s.halo) == (3, "strips")
    assert s._ext_meta == js._ext_meta
    res = s.solve_ir(tolerance=1e-9, n_refine=40)
    assert res.converged and res.iterations % 3 == 0
    assert res.iterations == js.solve_ir(tolerance=1e-9).iterations
    s2 = T.EllDistSolver(A, b, 3, n_devices=2, device=CPU,
                         cycles_per_refine=1,
                         config=MeshConfig(cycles_per_refine=3,
                                           halo="overlap"))
    assert (s2.cycles_per_refine, s2.halo) == (1, "step")
    with pytest.raises(ValueError, match="unknown halo"):
        T.EllDistSolver(A, b, 3, n_devices=2, halo="ring", device=CPU)
    with pytest.raises(ValueError, match="too small"):
        T.EllDistSolver(A[:3, :3], b[:3], 2, n_devices=8, device=CPU)


def test_device_none_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    A = tpoisson.laplacian_scipy(7)
    b = np.ones(49)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.EllDistSolver(A, b, 2, n_devices=2)
    with pytest.raises(RuntimeError, match="n_devices=None"):
        T.EllDistSolver(A, b, 2, device=CPU)


def test_row_0_color_is_the_largest():
    """On the sub-hierarchies of these tests row 0 is in color 0 and
    color 0 is the largest, so JAX's padded color writes never reach
    row 0 there."""
    At, bt = tpoisson.poisson2d(35, device=CPU)
    cases = [T.EllDistSolver(At, bt, L, n_devices=D, device=CPU)
             for L, D in ((8, 8), (6, 8), (6, 4), (5, 2))]
    At, bt = tpoisson.poisson2d(31, device=CPU)
    cases.append(T.EllDistSolver(At, bt, 4, n_devices=4, device=CPU,
                                 interpolator=BilinearInterpolator2D(31)))
    A, b = _long_range()
    cases.append(T.EllDistSolver(A, b, 2, n_devices=2, device=CPU))
    for s in cases:
        for lev in s.sub_hier.levels:
            sizes = [len(r) for r in lev.smoother_state.rows]
            assert 0 in lev.smoother_state.rows[0].tolist()
            assert sizes[0] == max(sizes), sizes
