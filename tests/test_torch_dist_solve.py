"""amg_tpu_torch's DistStructuredSolver against amg_tpu's on the CPU: the
solves at 63^2 on the 8-virtual-device mesh of tests/conftest.py. Each
must take JAX's iteration count and give a u within 1e-10 of JAX's (the
bound the JAX package holds its distributed df32 solve to against its
single-chip one, tests/test_distributed.py), at tolerance 1e-9.
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
SIDE = 63


def _rhs():
    return np.asarray(jpoisson.rhs(SIDE, dtype=jnp.float64)
                      ).reshape(SIDE, SIDE)


def test_solve_matches_jax():
    """The V-cycle loop in f64, the rss checked every cycle."""
    b = _rhs()
    kw = dict(tolerance=1e-9, compute_error_every_n_iters=1, n_iters=50)
    jr = J.DistStructuredSolver(SIDE, n_devices=8, dtype=jnp.float64
                                ).solve(jnp.asarray(b), **kw)
    tr = T.DistStructuredSolver(SIDE, n_devices=8, dtype=torch.float64,
                                device=CPU).solve(b, **kw)
    assert tr.converged and jr.converged
    assert tr.iterations == jr.iterations
    assert [i for i, _ in tr.history] == [i for i, _ in jr.history]
    np.testing.assert_allclose([e for _, e in tr.history],
                               [e for _, e in jr.history], rtol=1e-6)
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("halo", ["sweep", "step"])
def test_solve_ir_and_fused_match_jax(halo):
    """The df32 defect correction, f32 V-cycles: the host-stepped loop and
    the lagged one-program loop."""
    b = _rhs()
    js = J.DistStructuredSolver(SIDE, n_devices=8, halo=halo)
    ts = T.DistStructuredSolver(SIDE, n_devices=8, halo=halo, device=CPU)
    for name in ("solve_ir", "solve_ir_fused"):
        jr = getattr(js, name)(jnp.asarray(b), tolerance=1e-9)
        tr = getattr(ts, name)(b, tolerance=1e-9)
        assert tr.converged and jr.converged, name
        assert tr.error <= 1e-9 and tr.u.dtype == torch.float64
        assert tr.iterations == jr.iterations, name
        np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), rtol=0,
                                   atol=1e-10)
