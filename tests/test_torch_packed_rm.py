"""K9's layout and plain version (amg_tpu_torch/ops/kernels/packed_rm.py)
against amg_tpu/ops/pallas/packed_rm.py on the same inputs (CPU).

The layout conversions are compared bitwise; the sweep against the Pallas
kernel in interpret mode, at the JAX test's pipelines and tile sizes and
its bound, 1e-5 relative (tests/test_packed_rm.py). On the CPU the wrapper
takes the plain version; the CUDA kernel is compared with it on the card
(chip_smoke.py, tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amg_tpu.ops.pallas import packed_rm as jrm
from amg_tpu.ops.rap import poisson_const_w33
from amg_tpu.sparse import packed as jp

from amg_tpu_torch.ops import kernels as K
from amg_tpu_torch.ops.kernels import _build
from amg_tpu_torch.ops.kernels.packed_rm import (from_rm, fused_gs4_sweep_rm,
                                                 to_rm)
from amg_tpu_torch.sparse import packed as tp

torch.set_num_threads(1)

SIDE = 255
M_ = (SIDE - 1) // 2
W33 = poisson_const_w33(SIDE, 1)[0]


def _both(seed):
    x = np.random.default_rng(seed).standard_normal((SIDE, SIDE)).astype(
        np.float32)
    return tp.pack(torch.as_tensor(x), M_), jp.pack(jnp.asarray(x), M_)


@pytest.fixture(autouse=True)
def _no_launch_no_build():
    K.reset_launch_counts()
    yield
    assert K.fused_gs4_sweep_rm.launches == 0
    assert _build.library.cache_info().currsize == 0, "CPU path built CUDA"


def test_layout_matches_jax_and_round_trips():
    tu, ju = _both(0)
    t_rm = to_rm(tu)
    assert t_rm.shape == (M_ + 1, 4 * (M_ + 1)) and t_rm.is_contiguous()
    np.testing.assert_array_equal(t_rm.numpy(), np.asarray(jrm.to_rm(ju)))
    back = from_rm(t_rm)
    assert back.is_contiguous()
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jrm.from_rm(jrm.to_rm(ju))))
    assert torch.equal(back, tu)


@pytest.mark.parametrize("pipe,tg", [("sb", 32), ("db", 16)])
def test_rm_sweep_matches_pallas(pipe, tg):
    tu, ju = _both(1)
    tb, jb = _both(2)
    want = np.asarray(jrm.fused_gs4_sweep_rm(
        jrm.to_rm(ju), jrm.to_rm(jb), W33, M_, 0.9, True, tg=tg,
        pipeline=pipe, interpret=True), dtype=np.float64)
    got = fused_gs4_sweep_rm(to_rm(tu), to_rm(tb), W33, M_, 0.9, True)
    assert got.shape == want.shape
    assert (np.abs(got.numpy().astype(np.float64) - want).max()
            / np.abs(want).max()) < 1e-5


@pytest.mark.parametrize("symmetric", [True, False])
def test_rm_sweep_is_the_packed_sweep(symmetric):
    """Through the layouts, the row-grouped sweep is the packed sweep
    bitwise (what the card checks of K9 against K1)."""
    tu, _ = _both(3)
    tb, _ = _both(4)
    got = from_rm(fused_gs4_sweep_rm(to_rm(tu), to_rm(tb), W33, M_, 0.9,
                                     symmetric))
    assert torch.equal(got, tp.gs4_sweep_packed(tu, tb, W33, M_, 0.9,
                                                symmetric))


@pytest.mark.parametrize("bad", ["dtype", "shape", "noncontiguous"])
def test_rm_sweep_refuses_bad_inputs(bad):
    tu, _ = _both(5)
    tb, _ = _both(6)
    u_rm, b_rm = to_rm(tu), to_rm(tb)
    if bad == "dtype":
        u_rm = u_rm.double()
    elif bad == "shape":
        u_rm = tu                  # the (4, M, M) layout, not (M, 4M)
    else:
        u_rm = u_rm.t().contiguous().t()
        assert not u_rm.is_contiguous()
    with pytest.raises((TypeError, ValueError)):
        fused_gs4_sweep_rm(u_rm, b_rm, W33, M_)
