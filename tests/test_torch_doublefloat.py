"""amg_tpu_torch df32 arithmetic against amg_tpu's on the same inputs.

The error-free transformations are elementwise f32 operations that both
frameworks round one at a time, so their results are compared bitwise.
The rss reductions sum in another order than XLA's: df_rss_fast (f32
inner sums) within 1e-6 relative, df_rss (f64 sums) within 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amg_tpu.ops import doublefloat as jdf
from amg_tpu.ops.rap import poisson_const_w33
from amg_tpu.sparse import packed as jp

from amg_tpu_torch.ops import doublefloat as tdf
from amg_tpu_torch.sparse import packed as tp

torch.set_num_threads(1)


def _f32(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_from_f64_bitwise_and_guard():
    x = np.random.default_rng(0).standard_normal(1000) * 1e3
    t = tdf.DF32.from_f64(torch.as_tensor(x))
    j = jdf.DF32.from_f64(jnp.asarray(x))
    _eq(t.hi, j.hi)
    _eq(t.lo, j.lo)
    np.testing.assert_array_equal(t.to_f64().numpy(), np.asarray(j.to_f64()))
    with pytest.raises(ValueError):
        tdf.DF32.from_f64(torch.as_tensor(x, dtype=torch.float32))
    with pytest.raises(ValueError):
        jdf.DF32.from_f64(jnp.asarray(x, dtype=jnp.float32))


def test_two_sum_and_df_add_f32_bitwise():
    a, b = _f32(1, 4096), _f32(2, 4096, 1e-5)
    ts, te = tdf.two_sum(torch.as_tensor(a), torch.as_tensor(b))
    js, je = jdf.two_sum(jnp.asarray(a), jnp.asarray(b))
    _eq(ts, js)
    _eq(te, je)
    lo = _f32(3, 4096, 1e-8)
    x = _f32(4, 4096, 1e-3)
    t = tdf.df_add_f32(tdf.DF32(torch.as_tensor(a), torch.as_tensor(lo)),
                       torch.as_tensor(x))
    j = jdf.df_add_f32(jdf.DF32(jnp.asarray(a), jnp.asarray(lo)),
                       jnp.asarray(x))
    _eq(t.hi, j.hi)
    _eq(t.lo, j.lo)


def _packed_df(side, seed):
    m = (side - 1) // 2
    M = m + 1
    hi = _f32(seed, (4, M, M))
    lo = _f32(seed + 1, (4, M, M), 1e-8)
    return (tdf.DF32(torch.as_tensor(hi), torch.as_tensor(lo)),
            jdf.DF32(jnp.asarray(hi), jnp.asarray(lo)))


@pytest.mark.parametrize("side,level,pow2", [
    (255, 0, True),     # fine Poisson weights on a 2^k - 1 grid
    (255, 1, False),    # coarse level: centre -3/h^2 is not a power of 2
    (99, 0, False),     # h = 1/50: no weight is a power of 2
])
def test_df_residual_const_packed_matches_jax(side, level, pow2):
    m = (side - 1) // 2
    w33 = poisson_const_w33(side, 2)[level]
    assert tdf.is_pow2_weights(w33) == jdf.is_pow2_weights(w33) == pow2
    tb, jb = _packed_df(side, 10)
    tu, ju = _packed_df(side, 20)
    t = tp.df_residual_const_packed(w33, tb, tu, m)
    j = jp.df_residual_const_packed(w33, jb, ju, m)
    _eq(t.hi, j.hi)
    _eq(t.lo, j.lo)


@pytest.mark.parametrize("side,level", [(63, 0), (63, 1)])
def test_df_residual_const_unpacked_matches_jax(side, level):
    w33 = poisson_const_w33(side, 2)[level]
    n = side if level == 0 else (side - 1) // 2
    hi, lo = _f32(40, (n, n)), _f32(41, (n, n), 1e-8)
    uh, ul = _f32(42, (n, n)), _f32(43, (n, n), 1e-8)
    t = tdf.df_residual_const(
        w33, tdf.DF32(torch.as_tensor(hi), torch.as_tensor(lo)),
        tdf.DF32(torch.as_tensor(uh), torch.as_tensor(ul)))
    j = jdf.df_residual_const(
        w33, jdf.DF32(jnp.asarray(hi), jnp.asarray(lo)),
        jdf.DF32(jnp.asarray(uh), jnp.asarray(ul)))
    _eq(t.hi, j.hi)
    _eq(t.lo, j.lo)


def test_df_rss_matches_jax():
    tr, jr = _packed_df(255, 30)
    fast_t = float(tdf.df_rss_fast(tr))
    fast_j = float(jdf.df_rss_fast(jr))
    assert abs(fast_t - fast_j) / fast_j < 1e-6
    full_t = float(tdf.df_rss(tr))
    full_j = float(jdf.df_rss(jr))
    assert abs(full_t - full_j) / full_j < 1e-12
    # the squares themselves (TwoProd) are elementwise: bitwise
    sq_t = tdf.df_mul(tr, tr)
    sq_j = jdf.df_mul(jr, jr)
    _eq(sq_t.hi, sq_j.hi)
    _eq(sq_t.lo, sq_j.lo)
