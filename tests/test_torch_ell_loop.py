"""EllDistSolver's four programs in cond/body form on the CPU, where the
host driver runs them (the card's graphs run the same pieces:
tests/test_torch_cuda.py, chip_smoke.py ``ell_graph_solves``):

* the drivers: "host" on the CPU, "graph" refused there;
* each program's host driver bitwise against the host loop it replaced
  (restated here from the solver's own steps), converged and out of
  budget: ``solve`` (JAX's host loop over ``_vcycle`` and ``_rss``),
  ``solve_pcg`` (``_pcg``: err = dot(r0, r0) at the start, every pass
  refines, the tolerance in ``dtype``) and ``solve_ir`` (``_refine`` a
  step: the rss of the iterate it started from, the cycles always run);
* the programs against amg_tpu's EllDistSolver on the 8-device CPU mesh
  of tests/conftest.py: u within rtol 1e-11 / atol 1e-13, the f64
  histories within 1e-6, the df32 ones (f32 V-cycles) within 1e-3 and
  their u within 1e-10, tests/test_torch_ell_dist.py's bounds;
* card groups of 2 and 4 CPU blocks (a thread a block) bitwise one block
  for ``solve``, ``solve_pcg`` and ``solve_ir``, under "step" and
  "strips": the sums go slab by slab (``launch.slab_total``);
* the edge strips along the last dim of the ELL vectors (flat and the
  stacked (2, D·B) u and b) assembled from a gather
  (``launch._edges_device``'s plain form) against
  ``launch._edges_group``, one and several hops.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amg_tpu.models import poisson as jpoisson
from amg_tpu.parallel import ell_dist as J

from amg_tpu_torch.models import poisson
from amg_tpu_torch.ops.doublefloat import DF32, df_add_f32
from amg_tpu_torch.parallel import ell_dist as T
from amg_tpu_torch.parallel import launch

torch.set_num_threads(1)
CPU = torch.device("cpu")
N, LEVELS, D = 35, 6, 8
RTOL, ATOL = 1e-11, 1e-13


@pytest.fixture(scope="module")
def problem():
    return poisson.poisson2d(N, device=CPU)


def test_drivers_on_the_cpu(problem):
    A, b = problem
    s = T.EllDistSolver(A, b, LEVELS, n_devices=4, device=CPU)
    assert s.driver == "host"
    with pytest.raises(ValueError, match="graph driver"):
        T.EllDistSolver(A, b, LEVELS, n_devices=4, device=CPU,
                        driver="graph")
    with pytest.raises(ValueError, match="unknown driver"):
        s.set_driver("device")
    s.set_driver("host")
    s.warmup()                          # the host driver captures nothing
    assert s.driver == "host" and s._graphs == {}
    s.close()


def _old_solve(s, tol, every, n_iters):
    """The host loop ``solve`` replaced: one V-cycle call a V-cycle, the
    rss read every ``every``."""
    bp = s.pad_vec(s.b)
    A0 = s.levels[0]["A"]
    u = torch.zeros_like(bp)
    it, error, history = 0, 100.0, []
    while it < n_iters and error > tol:
        k = (min(every - (it % every), n_iters - it) if every
             else n_iters - it)
        for _ in range(k):
            u = s._vcycle_raw(u, bp)
        it += k
        if every and it % every == 0:
            r = bp - T._matvec_local(A0, u)
            error = float(T._dot(r, r))
            history.append((it, error))
    return s.unpad_vec(u), it, error, history


def _old_pcg(s, tol, n_iters):
    """The host loop the PCG program replaced: one read of the rss a
    pass."""
    b = s.pad_vec(s.b)
    A0 = s.levels[0]["A"]
    tol = float(torch.tensor(tol, dtype=b.dtype))

    def precond(r):
        return -s._vcycle_raw(torch.zeros_like(r), r)
    r = -b
    z = precond(r)
    u, p, rz = torch.zeros_like(b), z, T._dot(r, z)
    err, it = T._dot(r, r), 0
    while float(err) > tol and it < n_iters:
        u, r, z, p, rz = T._step(lambda x: -T._matvec_local(A0, x), precond,
                                 u, r, z, p, rz, dot=T._dot)
        err = T._dot(r, r)
        it += 1
    error = float(err)
    return s.unpad_vec(u), it, error, [(it, error)]


def _old_ir(s, tol, n_refine):
    """The host loop the refine program replaced: the residual and its
    rss, the check, then the cycles (skipped on the last step)."""
    bh = s._b64.astype(np.float32)
    bl = (s._b64 - bh.astype(np.float64)).astype(np.float32)
    b_df = DF32(hi=s.pad_vec(torch.from_numpy(bh)),
                lo=s.pad_vec(torch.from_numpy(bl)))
    u = DF32.from_f32(torch.zeros_like(b_df.hi))
    history, it, error = [], 0, float("inf")
    for _ in range(n_refine):
        r = s._df_residual(u, b_df)
        error = float(T._rss_df(r))
        history.append((it, error))
        if error <= tol:
            break
        e = torch.zeros_like(r.hi)
        for _ in range(s.cycles_per_refine):
            e = s._vcycle_raw(e, r.hi)
        u = df_add_f32(u, e)
        it += s.cycles_per_refine
    u64 = (s.unpad_vec(u.hi).to(torch.float64)
           + s.unpad_vec(u.lo).to(torch.float64))
    return u64, it, error, history


def _same(res, old):
    u, it, error, history = old
    assert torch.equal(res.u, u)
    assert (res.iterations, res.error, res.history) == (it, error, history)


@pytest.mark.parametrize("halo,Dn", [("step", 8), ("strips", 4)])
def test_programs_bitwise_the_host_loops_they_replaced(problem, halo, Dn):
    A, b = problem
    s = T.EllDistSolver(A, b, LEVELS, n_devices=Dn, halo=halo, device=CPU)
    for tol, every, n in ((1e-9, 2, 100), (0.0, 3, 7), (1e-9, 0, 4)):
        _same(s.solve(tol, every, n), _old_solve(s, tol, every, n))
    for tol, n in ((1e-9, 100), (1e-9, 2)):
        _same(s.solve_pcg(tol, n), _old_pcg(s, tol, n))
    s32 = T.EllDistSolver(A, b, LEVELS, n_devices=Dn, halo=halo,
                          dtype=torch.float32, device=CPU)
    for tol, n in ((1e-9, 40), (1e-9, 2)):
        res = s32.solve_ir(tol, n)
        _same(res, _old_ir(s32, tol, n))
    assert len(res.history) == 2 and not res.converged
    # solve_pcg in f32: the tolerance in the solver's dtype
    _same(s32.solve_pcg(1e-5, 100), _old_pcg(s32, 1e-5, 100))
    bp = s.pad_vec(s.b)
    u = s.vcycle_once(torch.zeros_like(bp), bp)
    assert torch.equal(u, s._vcycle_raw(torch.zeros_like(bp), bp))
    r = bp - T._matvec_local(s.levels[0]["A"], u)
    assert s.rss(u, bp) == float(T._dot(r, r))


def test_programs_match_jax():
    """solve (the rss every 2 cycles, a remainder chunk), the V-cycle and
    rss programs, solve_pcg (f64, "strips" on 8 slabs) and solve_ir (f32
    V-cycles) against amg_tpu's."""
    jA, jb = jpoisson.poisson2d(N)
    A, b = poisson.poisson2d(N, device=CPU)
    js = J.EllDistSolver(jA, jb, LEVELS, n_devices=D, dtype=jnp.float64,
                         halo="strips")
    ts = T.EllDistSolver(A, b, LEVELS, n_devices=D, halo="strips",
                         device=CPU)
    for kw in (dict(tolerance=1e-9, compute_error_every_n_iters=2),
               dict(tolerance=0.0, compute_error_every_n_iters=3,
                    n_iters=7)):
        jr, tr = js.solve(**kw), ts.solve(**kw)
        assert tr.iterations == jr.iterations
        assert tr.converged == jr.converged
        assert [i for i, _ in tr.history] == [i for i, _ in jr.history]
        np.testing.assert_allclose([e for _, e in tr.history],
                                   [e for _, e in jr.history], rtol=1e-6)
        np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u),
                                   rtol=RTOL, atol=ATOL)
    jbp, tbp = js.pad_vec(jb), ts.pad_vec(b)
    ju = js.vcycle_once(jnp.zeros_like(jbp), jbp)
    tu = ts.vcycle_once(torch.zeros_like(tbp), tbp)
    np.testing.assert_allclose(ts.unpad_vec(tu).numpy(),
                               np.asarray(js.unpad_vec(ju)), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ts.rss(tu, tbp), js.rss(ju, jbp), rtol=1e-9)
    for n in (50, 3):
        jp, tp = js.solve_pcg(1e-9, n), ts.solve_pcg(1e-9, n)
        assert tp.iterations == jp.iterations
        assert tp.history == [(tp.iterations, tp.error)]
        np.testing.assert_allclose(tp.error, jp.error, rtol=1e-6)
        np.testing.assert_allclose(tp.u.numpy(), np.asarray(jp.u),
                                   rtol=RTOL, atol=ATOL)
    js32 = J.EllDistSolver(jA, jb, LEVELS, n_devices=D, dtype=jnp.float32,
                           halo="step")
    ts32 = T.EllDistSolver(A, b, LEVELS, n_devices=D, dtype=torch.float32,
                           halo="step", device=CPU)
    jr, tr = js32.solve_ir(tolerance=1e-9), ts32.solve_ir(tolerance=1e-9)
    assert tr.converged and tr.iterations == jr.iterations
    assert [i for i, _ in tr.history] == [i for i, _ in jr.history]
    np.testing.assert_allclose([e for _, e in tr.history],
                               [e for _, e in jr.history], rtol=1e-3)
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), rtol=0,
                               atol=1e-10)


def _runs(A, b, halo, device):
    """solve, solve_pcg and solve_ir of one layout of the D slabs, a few
    passes each (a remainder chunk of V-cycles)."""
    out = {}
    s = T.EllDistSolver(A, b, LEVELS, n_devices=D, halo=halo, device=device)
    s32 = T.EllDistSolver(A, b, LEVELS, n_devices=D, halo=halo,
                          dtype=torch.float32, device=device)
    try:
        assert s.driver == "host"
        for name, call in (
                ("solve", lambda: s.solve(0.0, 2, 5)),
                ("pcg", lambda: s.solve_pcg(1e-9, 4)),
                ("ir", lambda: s32.solve_ir(1e-9, 3))):
            r = call()
            out[name] = (r.u, r.iterations, r.error, r.history)
    finally:
        s.close()
        s32.close()
    return out


@pytest.mark.parametrize("halo", ["step", "strips"])
def test_card_group_bitwise_one_block(problem, halo):
    """2 and 4 CPU blocks (D/K slabs each, a thread a block, the host
    collectives) give one block's u, counts and rss bitwise."""
    A, b = problem
    one = _runs(A, b, halo, CPU)
    for K in (2, 4):
        got = _runs(A, b, halo, ("cpu",) * K)
        for name, (u, it, err, hist) in one.items():
            gu, git, gerr, ghist = got[name]
            assert torch.equal(gu, u), (K, name)
            assert (git, gerr, ghist) == (it, err, hist), (K, name)


def _group(K, fn):
    g = launch.CardGroup(("cpu",) * K)
    try:
        return g.run(fn)
    finally:
        g.close()


@pytest.mark.parametrize("K,Dl,B,G", [(2, 4, 6, 1), (4, 2, 6, 6),
                                      (4, 1, 6, 4), (3, 1, 4, 9)])
def test_last_dim_edges_from_a_gather_bitwise_the_host_strips(K, Dl, B, G):
    """The ELL exchanges' shapes: a block's line of Dl slabs of B entries,
    flat (Dl·B,) (``_exchange_w``'s W windows) and the stacked (2, Dl·B)
    u and b (``_exchange_strips_1d``'s H strips, the df32 residual's hi
    and lo), edges along the last dim: the strips assembled from one
    gather (launch._edges_device's plain form) equal _edges_group's
    copies, one hop (G <= Dl·B) and several; zeros beyond the line's
    ends."""
    L = Dl * B

    def block(k):
        x = torch.arange(L, dtype=torch.float64) + 100.0 * (k + 1)
        ub = torch.stack([x, -x - 0.5])
        return (launch._edges_device(x, G, -1, None),
                launch._edges_group(x, G, -1),
                launch._edges_device(ub, G, -1, None),
                launch._edges_group(ub, G, -1))
    for k, (d1, g1, d2, g2) in enumerate(_group(K, block)):
        for a, b in ((d1, g1), (d2, g2)):
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), k
        assert d2[0].shape == (2, G)
        if k == 0:
            assert not d1[0].any()           # the line's start: zeros
        if k == K - 1:
            assert not d2[1].any()           # its end
        else:
            assert d1[1][0] == 100.0 * (k + 2)   # the next block's first
