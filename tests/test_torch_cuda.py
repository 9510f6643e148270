"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: each test skips where no CUDA device is present. On a GPU
machine (which has no JAX, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Bounds are the JAX package's own for these kernels
(tests/test_packed_cycle.py, tests/test_packed_df.py); the kernels keep the
plain versions' operation order and are built with -fmad=false, so they
are expected to agree exactly.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from amg_tpu_torch import (DistStructuredSolver, StructuredSolver, poisson,
                           varcoef)
from amg_tpu_torch.ops import kernels as K
from amg_tpu_torch.ops.doublefloat import DF32
from amg_tpu_torch.ops.kernels.packed_cycle import (down_leg_plain,
                                                    up_leg_plain)
from amg_tpu_torch.ops.kernels.halo import rdma_halo_exchange_plain
from amg_tpu_torch.ops.kernels.packed_df import df_residual_rss_plain
from amg_tpu_torch.ops.kernels.rbgs import fused_gs4_sweep_plain
from amg_tpu_torch.ops.rap import poisson_const_w33
from amg_tpu_torch.sparse.packed import gs4_sweep_packed, pack
from amg_tpu_torch.sparse.stencil import Stencil2D

pytestmark = pytest.mark.cuda

SIDE = 1023               # M = 512, the 1023^2 solve's fine level
M_ = (SIDE - 1) // 2
W33 = poisson_const_w33(SIDE, 1)[0]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _field(dev, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal((SIDE, SIDE)) * scale
    return pack(torch.as_tensor(x, dtype=torch.float32, device=dev), M_)


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("symmetric", [True, False])
def test_sweep_kernel(dev, symmetric):
    u4, b4 = _field(dev, 0), _field(dev, 1)
    got = K.fused_gs4_sweep_packed(u4, b4, W33, M_, 0.9, symmetric)
    torch.cuda.synchronize()
    assert K.fused_gs4_sweep_packed.launches > 0
    assert _rel(got, gs4_sweep_packed(u4, b4, W33, M_, 0.9,
                                      symmetric)) <= 2e-6
    assert float(got[3][M_, :].abs().max()) == 0.0


def test_leg_kernels(dev):
    u4, b4 = _field(dev, 2), _field(dev, 3)
    gu, gbc = K.fused_down_leg_packed(u4, b4, W33, M_, 0.9, True)
    ru, rbc = down_leg_plain(u4, b4, W33, M_, 0.9, True)
    assert _rel(gu, ru) <= 2e-6 and _rel(gbc, rbc) <= 1e-5
    assert float(gbc[M_, :].abs().max()) == float(gbc[:, M_].abs().max()) \
        == 0.0
    uc_pad = F.pad(_field(dev, 4)[0, :M_, :M_], (0, 1, 0, 1))
    got = K.fused_up_leg_packed(u4, b4, uc_pad, W33, M_, 0.9, True)
    assert _rel(got, up_leg_plain(u4, b4, uc_pad, W33, M_, 0.9,
                                  True)) <= 1e-5


def test_df_kernel(dev):
    b_df = DF32(_field(dev, 5), _field(dev, 6, 1e-8))
    u_df = DF32(_field(dev, 7), _field(dev, 8, 1e-8))
    rh, rss = K.fused_df_residual_rss(W33, b_df, u_df, M_)
    rh_ref, rss_ref = df_residual_rss_plain(W33, b_df, u_df, M_)
    assert _rel(rh, rh_ref) <= 1e-6
    assert abs(float(rss) - float(rss_ref)) <= 1e-5 * float(rss_ref)


def test_solve_goes_through_the_kernels(dev):
    s = StructuredSolver(SIDE, device=dev)
    b2 = poisson.rhs(SIDE, device=dev).reshape(SIDE, SIDE)
    K.reset_launch_counts()
    res = s.solve_ir_fused(b2, tolerance=1e-7)
    it = res.iterations // s.cycles_per_refine
    assert res.converged and res.u.is_cuda
    counts = K.launch_counts()
    assert counts["fused_down_leg_packed"] == 1 + 3 * it
    assert counts["fused_df_residual_rss"] == it + 1


def _rbgs_op(var, side, dev):
    if var:
        return Stencil2D(side=side, c=varcoef.jump_planes(side, device=dev))
    return Stencil2D.const(poisson_const_w33(side, 1)[0], side)


@pytest.mark.parametrize("side", [31, 255, 1023])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("var", [False, True], ids=["K5", "K6"])
def test_rbgs_kernels(dev, var, symmetric, side):
    """K5/K6 against their plain version at sides with a ragged last
    tile (31 < one tile, 255 and 1023 not multiples of 32)."""
    S = _rbgs_op(var, side, dev)
    rng = np.random.default_rng(side)
    u, b = (torch.as_tensor(rng.standard_normal((side, side)),
                            dtype=torch.float32, device=dev)
            for _ in range(2))
    K.reset_launch_counts()
    got = K.fused_gs4_sweep(S, u, b, 0.9, symmetric)
    torch.cuda.synchronize()
    name = "fused_gs4_sweep_var" if var else "fused_gs4_sweep_const"
    assert K.launch_counts()[name] == 1
    assert _rel(got, fused_gs4_sweep_plain(S, u, b, 0.9, symmetric)) <= 2e-6


def test_var_solve_on_the_card(dev):
    """The jump-coefficient solve (smoother="auto": packed-var levels, no
    kernel) on the card takes the port's CPU solve's refine count."""
    side = 255
    planes = varcoef.jump_planes(side, device="cpu")
    b2 = poisson.rhs(side, device="cpu").reshape(side, side)
    res = StructuredSolver(side, A_planes=planes.to(dev), device=dev
                           ).solve_ir_fused(b2.to(dev), tolerance=1e-7)
    ref = StructuredSolver(side, A_planes=planes, device="cpu"
                           ).solve_ir_fused(b2, tolerance=1e-7)
    assert res.converged and res.u.is_cuda
    assert res.iterations == ref.iterations


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D,B,n,G", [(2, 10, 31, 10), (8, 10, 31, 10),
                                     (3, 16, 33, 2), (4, 64, 255, 10),
                                     (1, 12, 7, 4)])
def test_halo_kernel(dev, D, B, n, G, dtype):
    """K7 equals its plain version bitwise (a copy): G == B, odd widths,
    one slab, u and b apart and stacked."""
    g = torch.Generator(device=dev).manual_seed(D * B + n)
    u, b = (torch.randn((D, B, n), generator=g, device=dev, dtype=dtype)
            for _ in range(2))
    K.reset_launch_counts()
    got = K.rdma_halo_exchange((u, b), G)
    got_st = K.rdma_halo_exchange(torch.cat([u, b], dim=2), G)
    torch.cuda.synchronize()
    assert K.launch_counts()["rdma_halo_exchange"] == 2
    ref = rdma_halo_exchange_plain((u, b), G)
    assert torch.equal(got, ref) and torch.equal(got_st, ref)
    assert got.data_ptr() not in (u.data_ptr(), b.data_ptr())


def test_dist_rdma_on_the_card(dev):
    """The distributed solve with K7 on the card: the V-cycle bitwise equal
    to halo="sweep", and the CPU's refine count."""
    side = 255
    b2 = poisson.rhs(side, device="cpu").reshape(side, side)
    us = {}
    for halo in ("rdma", "sweep"):
        s = DistStructuredSolver(side, n_devices=4, halo=halo, device=dev)
        bp = s.pad_field(b2)
        K.reset_launch_counts()
        us[halo] = s.vcycle(torch.zeros_like(bp), bp)
        torch.cuda.synchronize()
        assert K.launch_counts()["rdma_halo_exchange"] == (
            2 * 3 if halo == "rdma" else 0)   # B = 64, 32, 16 >= G = 10
    assert torch.equal(us["rdma"], us["sweep"])
    res = DistStructuredSolver(side, n_devices=4, halo="rdma", device=dev
                               ).solve_ir_fused(b2.to(dev), tolerance=1e-7)
    ref = DistStructuredSolver(side, n_devices=4, halo="rdma", device="cpu"
                               ).solve_ir_fused(b2, tolerance=1e-7)
    assert res.converged and res.u.is_cuda
    assert res.iterations == ref.iterations
