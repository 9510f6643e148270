"""StructuredSolver on a host-built hierarchy (``A_fine=``, or
``device_setup=False``) in amg_tpu_torch against amg_tpu on the same rhs
(CPU; the JAX side with x64), on the unpacked loop (127^2: the jump
problem given as ``A_fine``, and the masked smoother on the host-built
Poisson hierarchy); tests/test_torch_solver_host_packed.py runs the
packed loop at 255^2. The port's Galerkin chain is scipy's, JAX's its
native RAP; the checks and their tolerances are
tests/test_torch_solver_cases.py's.
"""

import pytest
import torch

from amg_tpu_torch import structured as tst
from amg_tpu_torch.models import varcoef as tvar
from test_torch_solver_cases import check_host_built, operator

torch.set_num_threads(1)

# (case, side, options besides A_fine, the fine problem given as A_fine)
CASES = [("jump-A_fine", 127, {}, "jump"),
         ("masked-host", 127, {"device_setup": False, "smoother": "masked"},
          None)]


@pytest.mark.parametrize("case,side,kw,given", CASES,
                         ids=[c[0] for c in CASES])
def test_host_built_solver_matches_jax(case, side, kw, given):
    check_host_built(side, kw, given)


def test_A_fine_and_A_planes_refused():
    side = 63
    with pytest.raises(ValueError, match="not both"):
        tst.StructuredSolver(side, A_fine=operator("jump", side),
                             A_planes=tvar.jump_planes(side, device="cpu"),
                             device="cpu")
