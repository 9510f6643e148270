"""DistStructuredSolver's five programs (JAX's ``_vcycle``, ``_rss``,
``_pcg_device``, ``_refine`` and ``_solve_device``), run as the port's
cond/body pieces under the host driver, against amg_tpu's on the CPU (63^2
on the 8-virtual-device mesh of tests/conftest.py): JAX's counts, u within
atol 1e-10 (the bound of tests/test_torch_dist_solve.py), the rss of the
f64 programs within rtol 1e-6 (that file's bound for its f64 history) and
of the df32 programs, whose V-cycles run in f32 and round apart from
JAX's, within rtol 1e-3. Two JAX solvers, one compile a program.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amg_tpu.models import poisson as jpoisson
from amg_tpu.parallel import structured_dist as J

from amg_tpu_torch.parallel import structured_dist as T

torch.set_num_threads(1)
CPU = torch.device("cpu")
SIDE, D = 63, 8
ATOL, RTOL = 1e-10, 1e-6
RTOL_F32 = 1e-3     # the rss after f32 V-cycles (largest seen: 2.1e-4)


@pytest.fixture(scope="module")
def b2():
    return np.asarray(jpoisson.rhs(SIDE, dtype=jnp.float64)
                      ).reshape(SIDE, SIDE)


def test_vcycle_rss_and_pcg_programs(b2):
    """f64, halo "sweep" in JAX and "rdma" in the port (K7's plain
    version, bitwise "sweep"'s): one V-cycle from zero, the rss of its
    iterate, and the PCG loop to 1e-9."""
    js = J.DistStructuredSolver(SIDE, n_devices=D, dtype=jnp.float64,
                                halo="sweep")
    ts = T.DistStructuredSolver(SIDE, n_devices=D, dtype=torch.float64,
                                halo="rdma", device=CPU)
    assert ts.driver == "host"
    jb, tb = js.pad_field(jnp.asarray(b2)), ts.pad_field(b2)
    ju = js.vcycle(jnp.zeros_like(jb), jb)
    tu = ts.vcycle(torch.zeros_like(tb), tb)
    np.testing.assert_allclose(tu.reshape(-1, SIDE).numpy(),
                               np.asarray(ju), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ts.rss(tu, tb), js.rss(ju, jb), rtol=RTOL)
    jr = js.solve_pcg(jnp.asarray(b2), tolerance=1e-9)
    tr = ts.solve_pcg(b2, tolerance=1e-9)
    assert tr.converged and jr.converged
    assert tr.iterations == jr.iterations
    np.testing.assert_allclose(tr.error, jr.error, rtol=RTOL)
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), rtol=0,
                               atol=ATOL)


def test_refine_and_solve_device_programs(b2):
    """The df32 defect correction (f32 V-cycles, halo "step"): JAX's
    ``_refine`` a step (``solve_ir``: its history) and the one-program
    ``_solve_device`` (``solve_ir_device`` / ``solve_ir_fused``: its
    stats)."""
    js = J.DistStructuredSolver(SIDE, n_devices=D, halo="step")
    ts = T.DistStructuredSolver(SIDE, n_devices=D, halo="step", device=CPU)
    jr = js.solve_ir(jnp.asarray(b2), tolerance=1e-9)
    tr = ts.solve_ir(b2, tolerance=1e-9)
    assert tr.converged and jr.converged
    assert tr.iterations == jr.iterations
    assert [i for i, _ in tr.history] == [i for i, _ in jr.history]
    np.testing.assert_allclose([e for _, e in tr.history],
                               [e for _, e in jr.history], rtol=RTOL_F32)
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), rtol=0,
                               atol=ATOL)
    _, _, jstats = js.solve_ir_device(jnp.asarray(b2), tolerance=1e-9)
    uh, ul, tstats = ts.solve_ir_device(b2, tolerance=1e-9)
    assert tstats[1].item() == float(jstats[1])
    np.testing.assert_allclose(tstats[0].item(), float(jstats[0]),
                               rtol=RTOL_F32)
    jf = js.solve_ir_fused(jnp.asarray(b2), tolerance=1e-9)
    tf = ts.solve_ir_fused(b2, tolerance=1e-9)
    assert tf.iterations == jf.iterations and tf.converged
    np.testing.assert_allclose(tf.error, jf.error, rtol=RTOL_F32)
    np.testing.assert_allclose(tf.u.numpy(), np.asarray(jf.u), rtol=0,
                               atol=ATOL)
    assert torch.equal(tf.u, ts._result_u(uh, ul))
