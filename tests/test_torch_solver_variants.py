"""StructuredSolver with the unpacked smoothers ("masked", "strided",
"chebyshev") in amg_tpu_torch against amg_tpu on the same rhs (CPU; the
JAX side with x64): the df32 device loop and the host-stepped solve_ir.
The checks and their tolerances are tests/test_torch_solver_cases.py's.
"""

import pytest
import torch

from test_torch_solver_cases import (check_device_solve, check_solve_ir,
                                operator, solvers)

torch.set_num_threads(1)
SIDE = 127


@pytest.mark.parametrize("smoother", ["masked", "strided", "chebyshev"])
def test_unpacked_smoothers_match_jax(smoother):
    js, ts = solvers(SIDE, smoother=smoother)
    assert ts.smoother == smoother and not ts.packed_loop
    # JAX's rule: the strided sweep takes the host-built hierarchy
    assert ts.device_setup == (smoother != "strided")
    # the masked levels, all 127^2 and below, run K10/K11
    kind = "masked_legs" if smoother == "masked" else smoother
    assert set(ts.plan[:-1]) == {kind} and ts.plan[-1] == "direct"
    assert ts.hier.smoother == smoother
    if smoother == "chebyshev":
        assert ts.hier.lam_maxes == js.hier.lam_maxes
    A = operator("poisson", SIDE)
    check_device_solve(js, ts, A, SIDE)
    check_solve_ir(js, ts, A, SIDE)
