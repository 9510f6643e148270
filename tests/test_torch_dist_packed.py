"""amg_tpu_torch's distributed halo="packed" and DistStructuredSolver.
solve_pcg against amg_tpu's on the CPU (the 8-virtual-device mesh of
tests/conftest.py).

* pack_rect, unpack_rect and packed_steps_window (sparse/packed.py) on
  row slabs, bitwise against JAX's (copies, and the same elementwise
  arithmetic in the same order);
* the packed V-cycle from JAX's state within rtol 1e-11 / atol 1e-13 of
  JAX's packed one, and within JAX's own bound of the port's "sweep" one
  (rtol 1e-12 / atol 1e-13, tests/test_distributed.py: the same iterates
  up to the order of the floating-point sums); its df32 solve takes
  JAX's refines;
* the distributed PCG (f64): JAX's iteration count, u within 1e-10 of the
  largest |u| (JAX's bound against its single-device PCG), its rss within
  1e-3 (the last recurrence rss, near the tolerance, rounds apart), on
  constant levels (halo "sweep" and "step") and on variable ones
  (force_var), and the single-device port's iteration count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amg_tpu.models import poisson as jpoisson
from amg_tpu.parallel import structured_dist as J
from amg_tpu.sparse import packed as jpacked

from amg_tpu_torch import krylov as tkrylov
from amg_tpu_torch import structured as tst
from amg_tpu_torch.models import poisson as tpoisson
from amg_tpu_torch.parallel import structured_dist as T
from amg_tpu_torch.sparse import packed as tpacked

from test_torch_dist import ATOL, RTOL, vcycle_pair

torch.set_num_threads(1)
CPU = torch.device("cpu")
W33S = (((-1.0, -2.0, -1.0), (-2.0, 12.0, -2.0), (-1.0, -2.0, -1.0)),
        ((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0)))


def _rhs(side):
    return np.asarray(jpoisson.rhs(side, dtype=jnp.float64)
                      ).reshape(side, side)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("w33", W33S)
@pytest.mark.parametrize("R,n", [(10, 15), (24, 31)])
def test_pack_rect_and_window_steps_match_jax(R, n, w33, symmetric):
    m = (n - 1) // 2
    rng = np.random.default_rng(R + n)
    u = rng.standard_normal((3, R, n))
    b = rng.standard_normal((3, R, n))
    row0 = np.array([-4, R - 4, 2 * R - 4])
    u4 = tpacked.pack_rect(torch.tensor(u), m)
    b4 = tpacked.pack_rect(torch.tensor(b), m)
    assert torch.equal(tpacked.unpack_rect(u4, m), torch.tensor(u))
    got = tpacked.packed_steps_window(
        w33, u4, b4, torch.tensor(row0).reshape(3, 1, 1), n, 2, 0.9,
        symmetric)
    for d in range(3):
        ju4 = jpacked.pack_rect(jnp.asarray(u[d]), m)
        np.testing.assert_array_equal(u4[:, d].numpy(), np.asarray(ju4))
        want = jpacked.packed_steps_window(
            w33, ju4, jpacked.pack_rect(jnp.asarray(b[d]), m), int(row0[d]),
            n, 2, 0.9, symmetric)
        np.testing.assert_array_equal(got[:, d].numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            tpacked.unpack_rect(got, m)[d].numpy(),
            np.asarray(jpacked.unpack_rect(want, m)))


def test_pack_rect_rejects_odd_rows():
    with pytest.raises(ValueError, match="even rows"):
        tpacked.pack_rect(torch.zeros(5, 7), 3)


@pytest.mark.parametrize("side,D", [(31, 2), (31, 4), (31, 8), (63, 8)])
def test_packed_vcycle_matches_jax(side, D):
    tu, ju = vcycle_pair(side, D, "packed", seed=3)
    np.testing.assert_allclose(tu, ju, rtol=RTOL, atol=ATOL)
    assert np.abs(tu[side:]).max() == 0.0


@pytest.mark.parametrize("D", [1, 3, 8])
def test_packed_vcycle_matches_sweep(D):
    side = 63
    b2 = tpoisson.rhs(side, device=CPU).reshape(side, side)
    us = {}
    for halo in ("sweep", "packed"):
        s = T.DistStructuredSolver(side, n_devices=D, dtype=torch.float64,
                                   halo=halo, device=CPU)
        bp = s.pad_field(b2)
        us[halo] = s.unpad(s.vcycle(torch.zeros_like(bp), bp)).numpy()
    np.testing.assert_allclose(us["packed"], us["sweep"], rtol=1e-12,
                               atol=1e-13)


def test_packed_solve_ir_matches_jax():
    """The df32 defect correction with packed f32 V-cycles: JAX's refine
    count, u within 1e-10 (the JAX package's bound for its distributed
    df32 solves), the rss history within 1e-3 (each refine's f32 V-cycles
    round apart: XLA contracts the f32 multiply-adds)."""
    side = 31
    b = _rhs(side)
    jr = J.DistStructuredSolver(side, n_devices=8, halo="packed"
                                ).solve_ir(jnp.asarray(b), tolerance=1e-9)
    ts = T.DistStructuredSolver(side, n_devices=8, halo="packed",
                                device=CPU)
    tr = ts.solve_ir(b, tolerance=1e-9)
    assert tr.converged and jr.converged and tr.error <= 1e-9
    assert tr.iterations == jr.iterations
    np.testing.assert_allclose([e for _, e in tr.history],
                               [e for _, e in jr.history], rtol=1e-3)
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), rtol=0,
                               atol=1e-10)
    fused = ts.solve_ir_fused(b, tolerance=1e-9)
    assert fused.converged and fused.iterations >= tr.iterations


@pytest.mark.parametrize("halo,D,kw", [("sweep", 8, {}), ("step", 8, {}),
                                       ("sweep", 4, {"force_var": True})])
def test_pcg_matches_jax(halo, D, kw):
    side = 31
    b = _rhs(side)
    jr = J.DistStructuredSolver(side, n_devices=D, dtype=jnp.float64,
                                halo=halo, **kw).solve_pcg(
        jnp.asarray(b), tolerance=1e-9, n_iters=50)
    tr = T.DistStructuredSolver(side, n_devices=D, dtype=torch.float64,
                                halo=halo, device=CPU, **kw).solve_pcg(
        b, tolerance=1e-9, n_iters=50)
    assert tr.converged and jr.converged
    assert tr.iterations == jr.iterations
    assert tr.history == [(tr.iterations, tr.error)]
    np.testing.assert_allclose(tr.error, jr.error, rtol=1e-3)
    scale = float(np.abs(np.asarray(jr.u)).max())
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), rtol=0,
                               atol=1e-10 * scale)


def test_pcg_matches_single_device():
    """JAX's contract: the distributed PCG takes the single-device PCG's
    iterations and iterates, here the port's solve_pcg_stencil."""
    side = 31
    s = T.DistStructuredSolver(side, n_devices=8, dtype=torch.float64,
                               device=CPU)
    b2 = tpoisson.rhs(side, device=CPU).reshape(side, side)
    rd = s.solve_pcg(b2, tolerance=1e-9, n_iters=50)
    hier = tst.build_stencil_hierarchy(side, len(s.cfg.sides),
                                       dtype=torch.float64, device=CPU)
    rs = tkrylov.solve_pcg_stencil(hier, b2, tolerance=1e-9, n_iters=50)
    assert rd.converged and rs.converged
    assert rd.iterations == rs.iterations
    scale = float(rs.u.abs().max())
    np.testing.assert_allclose(rd.u.numpy(), rs.u.numpy(), rtol=0,
                               atol=1e-10 * scale)
