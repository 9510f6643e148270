"""The constant Poisson solve at 4095^2 on the CPU, the port against the
JAX package: the refine count of solve_ir_fused at 1e-7 (a one-off
measurement, marked slow; about a minute and 2 GiB each):

    python -m pytest -m slow tests/test_torch_refine4095.py -s

The TPU record has 2 refines at 4095^2 (bf16-pass MXU transfers there);
the port on the card takes 3. This run shows what the JAX package itself
takes on the CPU, with exact f32 transfers.
"""

import jax.numpy as jnp
import pytest
import torch

from amg_tpu.models import poisson as jpoisson
from amg_tpu.structured import StructuredSolver as JSolver

from amg_tpu_torch import StructuredSolver, poisson

SIDE = 4095


@pytest.mark.slow
def test_4095_refines_match_jax():
    b = jpoisson.rhs(SIDE, dtype=jnp.float64).reshape(SIDE, SIDE)
    js = JSolver(SIDE)
    jr = js.solve_ir_fused(b, tolerance=1e-7)
    ts = StructuredSolver(SIDE, device="cpu")
    tr = ts.solve_ir_fused(poisson.rhs(SIDE, device="cpu"
                                       ).reshape(SIDE, SIDE), tolerance=1e-7)
    j_ref = jr.iterations // js.cycles_per_refine
    t_ref = tr.iterations // ts.cycles_per_refine
    print(f"\n{SIDE}^2 solve_ir_fused 1e-7 on the CPU: JAX {j_ref} refines "
          f"({jr.iterations} V-cycles) rss {jr.error!r}; port {t_ref} "
          f"refines ({tr.iterations} V-cycles) rss {tr.error!r}; port plan "
          f"{ts.plan}")
    assert jr.converged and tr.converged
    assert t_ref == j_ref
    assert isinstance(tr.u, torch.Tensor)
