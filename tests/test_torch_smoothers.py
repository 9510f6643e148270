"""amg_tpu_torch's stencil smoothers, transfers and operator members
against amg_tpu/sparse/stencil.py and utils/metrics.py on the same inputs
(CPU; both sides in f64).

Operators: the 5-point Poisson stencil without planes (JAX's
``Stencil2D.const``), a 9-point Galerkin level given as constant planes,
and the jump-coefficient planes (models/varcoef.py). Tolerance: 1e-12
relative to the largest value, for arithmetic that both sides order alike
but XLA may fuse; data movement (masks, the scipy form, dtype casts) is
compared exactly. ``estimate_lam_max`` starts from JAX's own random
vector (``x0``): torch cannot draw JAX's numbers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amg_tpu import structured as jst
from amg_tpu.models import varcoef as jvar
from amg_tpu.sparse import stencil as jsten
from amg_tpu.utils import metrics as jmetrics

from amg_tpu_torch.sparse import stencil as tsten
from amg_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)
OPS = ["const5", "galerkin9", "jump"]
SIDE = 63


def _close(t, j, rtol=1e-12):
    want = np.asarray(j)
    got = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-300)


def _ops(name, side=SIDE):
    """(JAX operator, port operator) of the same f64 stencil."""
    if name == "const5":
        w33 = jst.build_stencil_hierarchy_device(side).levels[0].w33
        return (jsten.Stencil2D.const(w33, side, dtype=jnp.float64),
                tsten.Stencil2D.const(w33, side, torch.float64))
    if name == "galerkin9":
        w33 = jst.build_stencil_hierarchy_device(2 * side + 1).levels[1].w33
        c = np.asarray(jsten.const_planes(w33, side, jnp.float64))
    else:
        c = np.asarray(jvar.jump_planes(side), dtype=np.float64)
    return (jsten.Stencil2D.from_planes(jnp.asarray(c), side),
            tsten.Stencil2D.from_planes(torch.tensor(c), side))


def _fields(side=SIDE, seed=0, k=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((side, side)) for _ in range(k)]


@pytest.mark.parametrize("op", OPS)
def test_operator_members(op):
    jS, tS = _ops(op)
    assert tS.n_rows == jS.n_rows == SIDE * SIDE
    assert tS.nnz == jS.nnz
    assert tS.dtype == torch.float64 and jS.dtype == jnp.float64
    assert tS.w33 == jS.w33
    (u,) = _fields(k=1)
    _close(tS.matvec(torch.tensor(u.reshape(-1))),
           jS.matvec(jnp.asarray(u.reshape(-1))))
    tA, jA = tS.to_scipy(), jS.to_scipy()
    assert tA.shape == jA.shape and (tA != jA).nnz == 0
    t32, j32 = tS.astype(torch.float32), jS.astype(jnp.float32)
    assert t32.dtype == torch.float32 and t32.w33 == j32.w33
    if tS.c is not None:
        np.testing.assert_array_equal(t32.c.numpy(), np.asarray(j32.c))
    _close(t32.matvec2(torch.tensor(u, dtype=torch.float32)).double(),
           j32.matvec2(jnp.asarray(u, dtype=jnp.float32)), rtol=1e-6)


@pytest.mark.parametrize("color", jsten.FOUR_COLORS)
@pytest.mark.parametrize("op", OPS)
def test_gs4_color_update(op, color):
    jS, tS = _ops(op)
    if jS.w33 is not None and jS.c.size == 0:
        # JAX's strided update reads planes: give it the constant ones
        jS = jsten.Stencil2D(c=jsten.const_planes(jS.w33, SIDE, jnp.float64),
                             side=SIDE, w33=jS.w33)
    u, b = _fields(seed=1)
    pj, pi = color
    got = tsten.gs4_color_update(tS, torch.tensor(u), torch.tensor(b), pj,
                                 pi, 0.9)
    want = jsten.gs4_color_update(jS, jnp.asarray(u), jnp.asarray(b), pj,
                                  pi, 0.9)
    _close(got, want)
    # only the color's sub-lattice moves
    mask = np.zeros((SIDE, SIDE), bool)
    mask[pj::2, pi::2] = True
    np.testing.assert_array_equal(got.numpy()[~mask], u[~mask])


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("op", OPS)
def test_gs4_sweep(op, symmetric):
    jS, tS = _ops(op)
    if jS.c.size == 0:
        jS = jsten.Stencil2D(c=jsten.const_planes(jS.w33, SIDE, jnp.float64),
                             side=SIDE, w33=jS.w33)
    u, b = _fields(seed=2)
    got = tsten.gs4_sweep(tS, torch.tensor(u), torch.tensor(b), 1.0,
                          symmetric)
    want = jsten.gs4_sweep(jS, jnp.asarray(u), jnp.asarray(b), 1.0,
                           symmetric)
    _close(got, want)
    # the strided sweep equals the masked one (the same color updates)
    masks = tsten.color_masks(SIDE, torch.float64)
    _close(got, tsten.gs4_sweep_masked(tS, torch.tensor(u), torch.tensor(b),
                                       masks, 1.0, symmetric).numpy())


@pytest.mark.parametrize("n", [7, 62, 63])
def test_color_masks(n):
    np.testing.assert_array_equal(tsten.color_masks(n).numpy(),
                                  np.asarray(jsten.color_masks(n)))
    assert tsten.color_masks(n, torch.float32).dtype == torch.float32
    np.testing.assert_array_equal(
        tsten.color_masks(n, torch.float32).numpy(),
        tsten.color_masks_iota(n).numpy())


@pytest.mark.parametrize("op", OPS)
def test_jacobi_and_dinv(op):
    jS, tS = _ops(op)
    u, b = _fields(seed=3)
    _close(tsten.jacobi_sweep(tS, torch.tensor(u), torch.tensor(b), 0.7),
           jsten.jacobi_sweep(jS, jnp.asarray(u), jnp.asarray(b), 0.7))
    _close(tsten.dinv_matvec2(tS, torch.tensor(u)),
           jsten.dinv_matvec2(jS, jnp.asarray(u)))


@pytest.mark.parametrize("level", range(6))
def test_const_lam_max(level):
    w33 = jst.build_stencil_hierarchy_device(127).levels[level].w33
    assert tsten.const_lam_max(w33) == jsten.const_lam_max(w33)


@pytest.mark.parametrize("degree", [3, 4])
@pytest.mark.parametrize("op", OPS)
def test_chebyshev_smooth(op, degree):
    jS, tS = _ops(op)
    u, b = _fields(seed=4)
    lam = (jsten.const_lam_max(jS.w33) if jS.w33 is not None
           else float(jsten.estimate_lam_max(jS)))
    _close(tsten.chebyshev_smooth(tS, torch.tensor(u), torch.tensor(b), lam,
                                  degree),
           jsten.chebyshev_smooth(jS, jnp.asarray(u), jnp.asarray(b), lam,
                                  degree))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("op", ["galerkin9", "jump"])
def test_estimate_lam_max(op, seed):
    jS, tS = _ops(op)
    x0 = jax.random.normal(jax.random.PRNGKey(seed), (SIDE, SIDE),
                           dtype=jnp.float64)
    want = float(jsten.estimate_lam_max(jS, seed=seed))
    got = tsten.estimate_lam_max(tS, seed=seed,
                                 x0=torch.tensor(np.asarray(x0)))
    assert abs(float(got) - want) <= 1e-12 * want
    # the port's own start: reproducible for a seed, and from a generator
    a = float(tsten.estimate_lam_max(tS, seed=seed))
    g = torch.Generator().manual_seed(seed)
    assert a == float(tsten.estimate_lam_max(tS, generator=g))
    assert 0.0 < a


@pytest.mark.parametrize("n", [7, 63, 127])
def test_restrict_and_prolong(n):
    rng = np.random.default_rng(n)
    r = rng.standard_normal((n, n))
    nc = (n - 1) // 2
    uc = rng.standard_normal((nc, nc))
    _close(tsten.restrict_fw(torch.tensor(r)),
           jsten.restrict_fw(jnp.asarray(r)))
    _close(tsten.prolong(torch.tensor(uc), n),
           jsten.prolong(jnp.asarray(uc), n))
    with pytest.raises(ValueError):
        tsten.prolong(torch.tensor(uc), n + 2)


@pytest.mark.parametrize("op", OPS)
def test_rss(op):
    jS, tS = _ops(op)
    u, b = _fields(seed=5)
    got = tmetrics.rss(tS, torch.tensor(u.reshape(-1)),
                       torch.tensor(b.reshape(-1)))
    want = jmetrics.rss(jS, jnp.asarray(u.reshape(-1)),
                        jnp.asarray(b.reshape(-1)))
    _close(got, want)
