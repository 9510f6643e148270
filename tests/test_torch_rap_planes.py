"""amg_tpu_torch.ops.rap's plane hierarchy names against amg_tpu's, on the
CPU: ``build_hierarchy_planes`` (the fine planes and three closed-form
RAP coarsenings) and ``rap_stencil_planes_jit`` (JAX's jitted form; the
port runs the same function op by op) on the 63^2 jump planes in f64,
within tests/test_torch_varcoef.py's f64 RAP tolerance: 1e-12 of the
largest entry (XLA may order the f64 sums of a fused expression
differently).
"""

import numpy as np
import torch

import jax.numpy as jnp

from amg_tpu.models import varcoef as jvar
from amg_tpu.ops import rap as jrap

from amg_tpu_torch.models import varcoef as tvar
from amg_tpu_torch.ops import rap as trap

SIDE = 63
LEVELS = 4
RTOL = 1e-12


def _close(t, j, rtol=RTOL):
    want = np.asarray(j)
    assert t.shape == want.shape
    assert np.abs(t.numpy() - want).max() <= rtol * np.abs(want).max()


def _planes():
    return (tvar.jump_planes(SIDE, dtype=torch.float64, device="cpu"),
            jvar.jump_planes(SIDE, dtype=jnp.float64))


def test_build_hierarchy_planes_f64():
    t, j = _planes()
    tl = trap.build_hierarchy_planes(t, LEVELS)
    jl = jrap.build_hierarchy_planes(j, LEVELS)
    assert len(tl) == len(jl) == LEVELS
    assert [p.shape[-1] for p in tl] == [63, 31, 15, 7]
    assert tl[0] is t
    for a, b in zip(tl, jl):
        _close(a, b)


def test_rap_stencil_planes_jit_f64():
    t, j = _planes()
    for _ in range(LEVELS - 1):
        t, j = trap.rap_stencil_planes_jit(t), jrap.rap_stencil_planes_jit(j)
        _close(t, j)
    np.testing.assert_array_equal(
        trap.rap_stencil_planes_jit(t).numpy(),
        trap.rap_stencil_planes(t).numpy())
