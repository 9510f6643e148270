"""StructuredSolver on a host-built Poisson hierarchy in amg_tpu_torch
against amg_tpu on the same rhs, on the packed df32 loop (255^2; CPU,
the JAX side with x64): the Poisson matrix given as ``A_fine`` (plain
packed levels, no fused kernels, as in JAX) and ``device_setup=False``
(the fused legs' plan on host-built levels, their plain versions on the
CPU). The checks and their tolerances are
tests/test_torch_solver_cases.py's.
"""

import pytest
import torch

from test_torch_solver_cases import check_host_built

torch.set_num_threads(1)

# (case, side, options besides A_fine, the fine problem given as A_fine)
CASES = [("poisson-A_fine", 255, {}, "poisson"),
         ("auto-host", 255, {"device_setup": False}, None)]


@pytest.mark.parametrize("case,side,kw,given", CASES,
                         ids=[c[0] for c in CASES])
def test_host_built_solver_matches_jax(case, side, kw, given):
    check_host_built(side, kw, given)
