"""amg_tpu_torch's distributed V-cycle against amg_tpu's with
halo="overlap" and halo="rdma" on the CPU (the 8-virtual-device mesh of
tests/conftest.py, f64): JAX's RDMA kernel runs in TPU interpret mode, at
side 63 only (the simulated remote copies are slow); the port's K7 wrapper
takes its plain version on CPU tensors. Same numpy state and operator,
rtol 1e-11 / atol 1e-13 (the JAX package's bound against its
single-device V-cycle). Split from test_torch_dist.py to keep each file
short under xdist's per-file scheduling."""

import numpy as np
import pytest

from test_torch_dist import ATOL, RTOL, vcycle_pair


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("side", [31, 63])
def test_overlap_vcycle_matches_jax(side, D):
    tu, ju = vcycle_pair(side, D, "overlap", seed=1)
    np.testing.assert_allclose(tu, ju, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_rdma_vcycle_matches_jax(D):
    tu, ju = vcycle_pair(63, D, "rdma", seed=2)
    np.testing.assert_allclose(tu, ju, rtol=RTOL, atol=ATOL)
