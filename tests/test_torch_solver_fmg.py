"""StructuredSolver with ``fmg=False`` (the refine loop starts from u = 0)
in the packed df32, unpacked df32 and f64 loops, and the host-stepped
solve_ir on the jump problem's plane hierarchy, in amg_tpu_torch against
amg_tpu on the same rhs (CPU; the JAX side with x64). The checks and
their tolerances are tests/test_torch_solver_cases.py's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amg_tpu import structured as jst
from amg_tpu.models import varcoef as jvar

from amg_tpu_torch import structured as tst
from amg_tpu_torch.sparse.stencil import Stencil2D
from test_torch_solver_cases import (check_device_solve, check_solve_ir,
                                operator, solvers)

torch.set_num_threads(1)

# (loop, side, options)
LOOPS = [("packed-df32", 255, {}), ("unpacked-df32", 127, {}),
         ("f64", 127, {"precision": "f64"})]


@pytest.mark.parametrize("loop,side,kw", LOOPS, ids=[c[0] for c in LOOPS])
def test_fmg_false_matches_jax(loop, side, kw):
    js, ts = solvers(side, fmg=False, **kw)
    assert not ts.fmg and ts.packed_loop == (loop == "packed-df32")
    check_device_solve(js, ts, operator("poisson", side), side)


def test_solve_ir_jump_planes_matches_jax():
    """solve_ir on the device-built plane hierarchy of the jump problem:
    the f64 residual reads the fine planes in f64 whatever the loop's
    precision; the independent rss takes the same planes."""
    side = 127
    planes = np.asarray(jvar.jump_planes(side))
    js = jst.StructuredSolver(side, A_planes=jnp.asarray(planes))
    ts = tst.StructuredSolver(side, A_planes=torch.tensor(planes),
                              device="cpu")
    A = Stencil2D(side=side, c=torch.tensor(planes, dtype=torch.float64)
                  ).to_scipy()
    res = check_solve_ir(js, ts, A, side)
    assert res.iterations == ts.cycles_per_refine * (len(res.history) - 1)
