"""The port's unpacked cycles and full multigrid against amg_tpu's, called
with JAX's positional arguments (CPU, f64).

``vcycle_stencil(h, u, b, pre, post, omega, symmetric)``,
``cycle_stencil(h, u, b, gamma, pre, post, omega, symmetric)`` and
``fmg_stencil(h, b, cycles_per_level, pre, post, omega, symmetric, gamma,
start_level, min_side, fused)`` take the same positions in both packages:
``cycle_stencil(h, u, b, 2)`` is a W-cycle in both, ``fmg_stencil(h, b, 2)``
two cycles a level. On the masked and the packed hierarchy at sides 63 and
127, from a numpy-seeded start and rhs; iterates within rtol 1e-11 (f64
rounding of the same operations in another order: the port's recursion
against JAX's loops, torch's matmuls against XLA's).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amg_tpu import structured as jst

from amg_tpu_torch import structured as tst

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL = 1e-11

SIDES = pytest.mark.parametrize("side", [63, 127])
SMOOTHERS = pytest.mark.parametrize("smoother", ["masked", "packed"])


@functools.lru_cache(maxsize=None)
def _pair(side, smoother):
    """The same f64 hierarchy on both sides, a start and a rhs (built once
    per side and smoother; the cycles do not change them)."""
    jh = jst.build_stencil_hierarchy_device(side, dtype=jnp.float64,
                                            smoother=smoother)
    th = tst.build_stencil_hierarchy_device(side, dtype=torch.float64,
                                            device=CPU, smoother=smoother)
    rng = np.random.default_rng(side)
    u, b = (rng.standard_normal((side, side)) for _ in range(2))
    return jh, th, u, b


def _close(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got.numpy() - want).max() <= RTOL * scale


# (label, positional arguments after (hier, u, b))
CYCLES = {"vcycle": ("vcycle_stencil", ()),
          "w_cycle": ("cycle_stencil", (2,)),
          "v_two_sweeps": ("cycle_stencil", (1, 2, 2)),
          "w_cycle_all": ("cycle_stencil", (2, 1, 2, 0.9, False))}


@SIDES
@SMOOTHERS
@pytest.mark.parametrize("case", list(CYCLES))
def test_cycle_matches_jax(side, smoother, case):
    name, args = CYCLES[case]
    jh, th, u, b = _pair(side, smoother)
    want = getattr(jst, name)(jh, jnp.asarray(u), jnp.asarray(b), *args)
    got = getattr(tst, name)(th, torch.tensor(u), torch.tensor(b), *args)
    _close(got, want)


# (label, positional arguments after (hier, b), keyword arguments): two
# cycles a level; a W-cycle on each level (gamma = 2, so no packed cycle);
# and two cycles a level with the packed V-cycle on levels >= 31
FMGS = {"cycles_per_level_2": ((2,), {}),
        "gamma_2": ((1, 1, 1, 1.0, True, 2), {}),
        "cycles_2_packed_levels": ((2,), {"min_side": 31})}


@SIDES
@SMOOTHERS
@pytest.mark.parametrize("case", list(FMGS))
def test_fmg_matches_jax(side, smoother, case):
    args, kw = FMGS[case]
    jh, th, _, b = _pair(side, smoother)
    want = jst.fmg_stencil(jh, jnp.asarray(b), *args, **kw)
    got = tst.fmg_stencil(th, torch.tensor(b), *args, **kw)
    _close(got, want)


@SMOOTHERS
def test_cycle_gamma_1_is_the_vcycle(smoother):
    """The port's cycle_stencil with its defaults is vcycle_stencil, bit
    for bit, and a W-cycle is not."""
    _, th, u, b = _pair(63, smoother)
    u, b = torch.tensor(u), torch.tensor(b)
    v = tst.vcycle_stencil(th, u, b)
    assert torch.equal(tst.cycle_stencil(th, u, b), v)
    assert torch.equal(tst.cycle_stencil(th, u, b, 1), v)
    assert not torch.equal(tst.cycle_stencil(th, u, b, 2), v)
