"""amg_tpu_torch packed and stencil ops against amg_tpu on the same inputs.

Inputs come from numpy.random.default_rng; both sides run in f64 (the
JAX side with x64, tests/conftest.py). Tolerances: data movement and the
problem setup are compared bitwise; stencil arithmetic to 1e-12 relative,
the bound tests/test_packed.py holds the JAX packed ops to (f64 roundoff
of a few dozen operations on O(1/h^2) terms).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amg_tpu.models import poisson as jpoisson
from amg_tpu.ops.rap import poisson_const_w33 as j_w33
from amg_tpu.sparse import packed as jp
from amg_tpu.sparse.stencil import Stencil2D as JStencil2D
from amg_tpu.sparse.stencil import color_masks_iota as j_masks
from amg_tpu.sparse.stencil import gs4_sweep_masked as j_gs4_masked
from amg_tpu.utils.metrics import rss_from_residual as j_rss

from amg_tpu_torch.models import poisson as tpoisson
from amg_tpu_torch.ops.rap import poisson_const_w33 as t_w33
from amg_tpu_torch.sparse import packed as tp
from amg_tpu_torch.sparse.stencil import Stencil2D as TStencil2D
from amg_tpu_torch.sparse.stencil import color_masks_iota as t_masks
from amg_tpu_torch.sparse.stencil import gs4_sweep_masked as t_gs4_masked
from amg_tpu_torch.utils.metrics import rss_from_residual as t_rss

torch.set_num_threads(1)

RTOL = 1e-12


def _field(side, seed, shape=None):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape or (side, side))


def _close(got_t, want_j, rtol=RTOL):
    want = np.asarray(want_j)
    got = got_t.numpy()
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() / scale <= rtol


@pytest.mark.parametrize("side", [63, 255])
def test_pack_unpack_bitwise(side):
    m = (side - 1) // 2
    u = _field(side, side)
    j4 = np.asarray(jp.pack(jnp.asarray(u), m))
    t4 = tp.pack(torch.as_tensor(u), m)
    assert t4.is_contiguous()
    np.testing.assert_array_equal(t4.numpy(), j4)
    np.testing.assert_array_equal(tp.unpack(t4, m).numpy(), u)
    np.testing.assert_array_equal(
        tp.unpack(t4, m).numpy(), np.asarray(jp.unpack(jnp.asarray(j4), m)))


@pytest.mark.parametrize("side", [31, 63])
@pytest.mark.parametrize("symmetric", [True, False])
def test_gs4_sweep_packed_matches_jax(side, symmetric):
    m = (side - 1) // 2
    w33 = t_w33(side, 1)[0]
    u, b = _field(side, 1), _field(side, 2)
    want = jp.gs4_sweep_packed(jp.pack(jnp.asarray(u), m),
                               jp.pack(jnp.asarray(b), m), w33, m, 0.9,
                               symmetric)
    got = tp.gs4_sweep_packed(tp.pack(torch.as_tensor(u), m),
                              tp.pack(torch.as_tensor(b), m), w33, m, 0.9,
                              symmetric)
    _close(got, want)


@pytest.mark.parametrize("level", [0, 2])
def test_residual_packed_matches_jax(level):
    side = 63
    w33 = t_w33(side, 3)[level]
    m = (side - 1) // 2
    u, b = _field(side, 3), _field(side, 4)
    want = jp.residual_packed(jp.pack(jnp.asarray(u), m),
                              jp.pack(jnp.asarray(b), m), w33, m)
    got = tp.residual_packed(tp.pack(torch.as_tensor(u), m),
                             tp.pack(torch.as_tensor(b), m), w33, m)
    _close(got, want)
    # pad cells carry exactly zero residual
    assert float(got[3][m, :].abs().max()) == 0.0
    assert float(got[3][:, m].abs().max()) == 0.0


def test_restrict_and_prolong_packed_match_jax():
    side = 63
    m = (side - 1) // 2
    r = _field(side, 5)
    _close(tp.restrict_packed(tp.pack(torch.as_tensor(r), m), m),
           jp.restrict_packed(jp.pack(jnp.asarray(r), m), m))
    u = _field(side, 6)
    uc = _field(m, 7)
    _close(tp.prolong_add_packed(tp.pack(torch.as_tensor(u), m),
                                 torch.as_tensor(uc), m),
           jp.prolong_add_packed(jp.pack(jnp.asarray(u), m),
                                 jnp.asarray(uc), m))


def test_packed_ops_leave_inputs_untouched():
    side = 31
    m = (side - 1) // 2
    w33 = t_w33(side, 1)[0]
    u4 = tp.pack(torch.as_tensor(_field(side, 8)), m)
    b4 = tp.pack(torch.as_tensor(_field(side, 9)), m)
    u_copy = u4.clone()
    tp.gs4_sweep_packed(u4, b4, w33, m)
    tp.prolong_add_packed(u4, torch.ones(m, m, dtype=u4.dtype), m)
    assert torch.equal(u4, u_copy)


@pytest.mark.parametrize("symmetric", [True, False])
def test_gs4_sweep_masked_matches_jax(symmetric):
    side = 31
    w33 = t_w33(side, 2)[1]
    n = (side - 1) // 2
    u, b = _field(n, 10), _field(n, 11)
    want = j_gs4_masked(JStencil2D.const(w33, n, jnp.float64),
                        jnp.asarray(u), jnp.asarray(b),
                        j_masks(n, jnp.float64), 0.9, symmetric)
    got = t_gs4_masked(TStencil2D.const(w33, n),
                       torch.as_tensor(u), torch.as_tensor(b),
                       t_masks(n, torch.float64), 0.9, symmetric)
    _close(got, want)


def test_color_masks_equal_jax():
    np.testing.assert_array_equal(t_masks(9, torch.float64).numpy(),
                                  np.asarray(j_masks(9, jnp.float64)))


@pytest.mark.parametrize("level", [0, 1])
def test_matvec2_matches_jax(level):
    side = 63
    w33 = t_w33(side, 2)[level]
    n = side if level == 0 else (side - 1) // 2
    u = _field(n, 12)
    want = JStencil2D.const(w33, n, jnp.float64).matvec2(jnp.asarray(u))
    got = TStencil2D.const(w33, n).matvec2(torch.as_tensor(u))
    _close(got, want)


def test_rss_from_residual_matches_jax():
    r = _field(63, 14)
    got = float(t_rss(torch.as_tensor(r)))
    want = float(j_rss(jnp.asarray(r)))
    assert abs(got - want) <= RTOL * want


@pytest.mark.parametrize("side", [31, 255, 1023])
def test_poisson_const_w33_identical(side):
    assert t_w33(side, 6) == j_w33(side, 6)


@pytest.mark.parametrize("side", [35, 255])
def test_rhs_bitwise(side):
    got = tpoisson.rhs(side, device=torch.device("cpu"))
    want = np.asarray(jpoisson.rhs(side, dtype=jnp.float64))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    assert tpoisson.grid_spacing_h(side) == jpoisson.grid_spacing_h(side)
