"""amg_tpu_torch.krylov against amg_tpu.krylov in f32 (CPU): at 1e-5, the
tolerance of bench.py's PCG row, with fused=True as that row runs it, the
port takes JAX's iteration count at 255^2 and 511^2. (On the CPU JAX's
Mosaic kernels are off and the port's wrappers take their plain versions,
so fused=True runs the packed cycle on both sides.)
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amg_tpu import krylov as jk
from amg_tpu import structured as jst
from amg_tpu.models import poisson as jpoisson

from amg_tpu_torch import krylov as tk
from amg_tpu_torch import structured as tst

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("side", [255, 511])
def test_pcg_f32_iterations_match_jax(side):
    """The same iteration count as JAX's device loop; the port's host and
    device loops are one iteration, bitwise."""
    jh = jst.build_stencil_hierarchy_device(side, smoother="packed")
    th = tst.build_stencil_hierarchy_device(side, device=CPU,
                                            smoother="packed")
    b = np.asarray(jpoisson.rhs(side, dtype=jnp.float64)).reshape(side, side)
    _, jstats = jk.solve_pcg_device(jh, jnp.asarray(b, dtype=jnp.float32),
                                    tolerance=1e-5, n_iters=50, fused=True)
    tb = torch.tensor(b, dtype=torch.float32)
    tu, tstats = tk.solve_pcg_device(th, tb, tolerance=1e-5, n_iters=50,
                                     fused=True)
    host = tk.solve_pcg_stencil(th, tb, tolerance=1e-5, n_iters=50)
    j_it = int(np.asarray(jstats)[1])
    assert int(tstats[1]) == j_it == host.iterations
    assert torch.equal(tu, host.u) and float(tstats[0]) <= 1e-5
