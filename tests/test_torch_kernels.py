"""The port's kernel wrappers (amg_tpu_torch/ops/kernels) on CPU tensors
against the JAX Pallas kernels they replace, run as the JAX package's own
tests run them (interpret mode, side 255, tg = 32 and 128).

On the CPU a wrapper takes its plain PyTorch version, so these tests check
the plain versions, the wrappers' signatures and input checks, and that no
kernel launch is counted. Bounds are the JAX tests' own
(tests/test_packed_rbgs.py, test_packed_cycle.py, test_packed_df.py):
f32 reassociation between the Pallas body and the plain ops. The CUDA
kernels themselves are compared with the plain versions on the card
(chip_smoke.py, tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amg_tpu.ops import doublefloat as jdf
from amg_tpu.ops.pallas import packed_cycle as jcycle
from amg_tpu.ops.pallas import packed_df as jdfk
from amg_tpu.ops.pallas import packed_rbgs as jrbgs
from amg_tpu.ops.rap import poisson_const_w33
from amg_tpu.sparse import packed as jp

from amg_tpu_torch.ops import kernels as K
from amg_tpu_torch.ops.doublefloat import DF32
from amg_tpu_torch.ops.kernels import _build
from amg_tpu_torch.sparse import packed as tp

torch.set_num_threads(1)

SIDE = 255
M_ = (SIDE - 1) // 2
W33 = poisson_const_w33(SIDE, 1)[0]
TGS = pytest.mark.parametrize("tg", [32, 128], ids=["multi-tile",
                                                    "one-tile"])


def _np_f32(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(seed, scale=1.0):
    """A packed f32 field for both sides, from one numpy draw."""
    x = _np_f32(seed, (SIDE, SIDE), scale)
    return tp.pack(torch.as_tensor(x), M_), jp.pack(jnp.asarray(x), M_)


def _rel(got_t, want_j):
    want = np.asarray(want_j, dtype=np.float64)
    return (np.abs(got_t.numpy().astype(np.float64) - want).max()
            / np.abs(want).max())


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    K.reset_launch_counts()
    yield
    assert all(n == 0 for n in K.launch_counts().values())
    assert _build.library.cache_info().currsize == 0, "CPU path built CUDA"


@TGS
@pytest.mark.parametrize("symmetric", [True, False])
def test_sweep_matches_pallas(tg, symmetric):
    tu, ju = _both(0)
    tb, jb = _both(1)
    want = jrbgs.fused_gs4_sweep_packed(ju, jb, W33, M_, 0.9, symmetric,
                                        interpret=True, tg=tg)
    got = K.fused_gs4_sweep_packed(tu, tb, W33, M_, 0.9, symmetric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=2e-6)


@TGS
def test_down_leg_matches_pallas(tg):
    tu, ju = _both(2)
    tb, jb = _both(3)
    ju_out, jbc = jcycle.fused_down_leg_packed(ju, jb, W33, M_, 0.9, True,
                                               tg=tg, interpret=True)
    tu_out, tbc = K.fused_down_leg_packed(tu, tb, W33, M_, 0.9, True)
    np.testing.assert_allclose(tu_out.numpy(), np.asarray(ju_out),
                               rtol=2e-6, atol=2e-6)
    assert _rel(tbc[:M_, :M_], jbc[:M_, :M_]) < 1e-5
    assert tbc.shape == (M_ + 1, M_ + 1)
    assert float(tbc[M_, :].abs().max()) == 0.0
    assert float(tbc[:, M_].abs().max()) == 0.0


@TGS
def test_up_leg_matches_pallas(tg):
    tu, ju = _both(4)
    tb, jb = _both(5)
    uc = _np_f32(6, (M_, M_))
    tuc = torch.nn.functional.pad(torch.as_tensor(uc), (0, 1, 0, 1))
    juc = jnp.pad(jnp.asarray(uc), ((0, 1), (0, 1)))
    want = jcycle.fused_up_leg_packed(ju, jb, juc, W33, M_, 0.9, True,
                                      tg=tg, interpret=True)
    got = K.fused_up_leg_packed(tu, tb, tuc, W33, M_, 0.9, True)
    assert _rel(got, want) < 1e-5


@TGS
def test_df_residual_rss_matches_pallas(tg):
    tuh, juh = _both(7)
    tul, jul = _both(8, 1e-8)
    tbh, jbh = _both(9)
    tbl, jbl = _both(10, 1e-8)
    jrh, parts = jdfk.fused_df_residual_rss(
        W33, jdf.DF32(jbh, jbl), jdf.DF32(juh, jul), M_, tg=tg,
        interpret=True)
    rh, rss = K.fused_df_residual_rss(W33, DF32(tbh, tbl), DF32(tuh, tul),
                                      M_)
    assert rss.dtype == torch.float64 and rss.dim() == 0
    assert _rel(rh, jrh) < 1e-6
    rss_j = float(np.asarray(parts)[:, 0, 0].astype(np.float64).sum())
    assert abs(float(rss) - rss_j) / rss_j < 1e-5


def test_df_residual_rss_refuses_non_pow2_weights():
    tu, _ = _both(11)
    w_bad = tuple(tuple(w * 1.1 for w in row) for row in W33)
    with pytest.raises(ValueError):
        K.fused_df_residual_rss(w_bad, DF32.from_f32(tu), DF32.from_f32(tu),
                                M_)


def _calls(u4, b4):
    """Each wrapper called on (u4, b4)-shaped inputs."""
    uc = torch.zeros(M_ + 1, M_ + 1)
    return {
        "sweep": lambda: K.fused_gs4_sweep_packed(u4, b4, W33, M_),
        "down": lambda: K.fused_down_leg_packed(u4, b4, W33, M_),
        "up": lambda: K.fused_up_leg_packed(u4, b4, uc, W33, M_),
        "df": lambda: K.fused_df_residual_rss(W33, DF32.from_f32(b4),
                                              DF32.from_f32(u4), M_),
    }


@pytest.mark.parametrize("kernel", ["sweep", "down", "up", "df"])
@pytest.mark.parametrize("bad", ["dtype", "shape", "noncontiguous"])
def test_wrappers_refuse_bad_inputs(kernel, bad):
    u4, _ = _both(12)
    b4, _ = _both(13)
    if bad == "dtype":
        u4 = u4.double()
    elif bad == "shape":
        u4 = u4[:, :-1, :-1].contiguous()
    else:
        u4 = u4.transpose(1, 2)
        assert not u4.is_contiguous()
    with pytest.raises((TypeError, ValueError)):
        _calls(u4, b4)[kernel]()
