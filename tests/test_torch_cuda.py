"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: each test skips where no CUDA device is present. On a GPU
machine (which has no JAX, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The kernels keep the plain versions' operation order and are built with
-fmad=false: K1, K2, K3, K5, K6, K8, K9 and K4's r.hi are held bitwise
equal to their plain versions (torch.equal), K9 also to K1 through the
layout conversions; K4's rss (summed in another order) to the JAX
package's own bound for that kernel (tests/test_packed_df.py).
"""

import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from amg_tpu_torch import (DistStructuredSolver, StructuredSolver, poisson,
                           varcoef)
from amg_tpu_torch.ops import kernels as K
from amg_tpu_torch.ops.doublefloat import DF32, is_pow2_weights
from amg_tpu_torch.ops.kernels.packed_cycle import (down_leg_plain,
                                                    residual_restrict_plain,
                                                    up_leg_plain)
from amg_tpu_torch.ops.kernels.packed_rm import (from_rm,
                                                 fused_gs4_sweep_rm_plain,
                                                 to_rm)
from amg_tpu_torch.ops.kernels.halo import rdma_halo_exchange_plain
from amg_tpu_torch.ops.kernels.packed_df import df_residual_rss_plain
from amg_tpu_torch.ops.kernels.rbgs import fused_gs4_sweep_plain
from amg_tpu_torch.ops.rap import poisson_const_w33
from amg_tpu_torch.sparse.packed import gs4_sweep_packed, pack
from amg_tpu_torch.sparse.stencil import Stencil2D
from amg_tpu_torch.structured import vcycle_packed

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


# the three weight instantiations of K1, K2 and K3: the fine level's
# 5-point Poisson weights, a Galerkin level's 9-point ones, and another zero
# pattern
NINE_POINT = ((-0.5, -1.0, -0.5), (-1.0, 6.0, -1.0), (-0.5, -1.0, -0.5))
OTHER_POINT = ((0.0, -1.0, -0.5), (-1.0, 4.5, -1.0), (0.0, -1.0, 0.0))


def _weights(name, side):
    return {"five": poisson_const_w33(side, 1)[0], "nine": NINE_POINT,
            "other": OTHER_POINT}[name]


def _pads_zero(u4, m):
    return (float(u4[1][:, m].abs().max()) == float(u4[2][m, :].abs().max())
            == float(u4[3][m, :].abs().max())
            == float(u4[3][:, m].abs().max()) == 0.0)


# M = 513 (ragged: 4-byte copies, edge tiles), 512 and 2048 (the 1023^2
# and 4095^2 fine levels)
LEG_SIDES = pytest.mark.parametrize("side", [1025, 1023, 4095])


@LEG_SIDES
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("weights", ["five", "nine", "other"])
def test_sweep_kernel(dev, side, symmetric, weights):
    """K1 bitwise equal to its plain version (omega 0.9 and 1), pad cells
    exactly 0."""
    m, (u4, b4) = _fields_at(dev, side, side + 1)
    w33 = _weights(weights, side)
    K.reset_launch_counts()
    for omega in (0.9, 1.0):
        got = K.fused_gs4_sweep_packed(u4, b4, w33, m, omega, symmetric)
        assert torch.equal(got, gs4_sweep_packed(u4, b4, w33, m, omega,
                                                 symmetric))
        assert _pads_zero(got, m)
    torch.cuda.synchronize()
    assert K.launch_counts()["fused_gs4_sweep_packed"] == 2


@LEG_SIDES
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("weights", ["five", "nine", "other"])
def test_leg_kernels(dev, side, symmetric, weights):
    """K2 and K3 bitwise equal to their plain versions (omega 0.9 and 1),
    pad rows and columns exactly 0."""
    m, (u4, b4) = _fields_at(dev, side, side + 2)
    w33 = _weights(weights, side)
    uc_pad = F.pad(_fields_at(dev, side, side + 3)[1][0][0, :m, :m],
                   (0, 1, 0, 1))
    for omega in (0.9, 1.0):
        gu, gbc = K.fused_down_leg_packed(u4, b4, w33, m, omega, symmetric)
        ru, rbc = down_leg_plain(u4, b4, w33, m, omega, symmetric)
        assert torch.equal(gu, ru) and torch.equal(gbc, rbc)
        assert float(gbc[m, :].abs().max()) == float(
            gbc[:, m].abs().max()) == 0.0
        got = K.fused_up_leg_packed(u4, b4, uc_pad, w33, m, omega, symmetric)
        assert torch.equal(got, up_leg_plain(u4, b4, uc_pad, w33, m, omega,
                                             symmetric))
        assert _pads_zero(got, m)


# M = 101 and 129 (ragged: 4-byte copies, edge tiles), 512, 2048 and 4096
# (the 1023^2, 4095^2 and 8191^2 fine levels)
@pytest.mark.parametrize("side", [201, 257, 1023, 4095, 8191])
def test_df_kernel(dev, side):
    """K4: r.hi bitwise equal to the plain version's, pad cells exactly 0,
    the rss within 1e-5 relative and the same bits on a repeated call."""
    m = (side - 1) // 2
    w33 = poisson_const_w33(side, 1)[0]
    if not is_pow2_weights(w33):     # the ragged sides are not 2^k - 1
        w33 = ((0.0, -1.0, 0.0), (-1.0, 4.0, -1.0), (0.0, -1.0, 0.0))
    rng = np.random.default_rng(side)

    def f(scale=1.0):
        x = rng.standard_normal((side, side)) * scale
        return pack(torch.as_tensor(x, dtype=torch.float32, device=dev), m)
    b_df = DF32(f(), f(1e-8))
    u_df = DF32(f(), f(1e-8))
    rh, rss = K.fused_df_residual_rss(w33, b_df, u_df, m)
    rh_ref, rss_ref = df_residual_rss_plain(w33, b_df, u_df, m)
    assert torch.equal(rh, rh_ref)
    assert _pads_zero(rh, m)
    assert rss.dtype == torch.float64 and rss.shape == ()
    assert abs(float(rss) - float(rss_ref)) <= 1e-5 * float(rss_ref)
    rh2, rss2 = K.fused_df_residual_rss(w33, b_df, u_df, m)
    assert torch.equal(rh2, rh) and float(rss2) == float(rss)


def _fields_at(dev, side, seed):
    m = (side - 1) // 2
    rng = np.random.default_rng(seed)
    return m, [pack(torch.as_tensor(rng.standard_normal((side, side)),
                                    dtype=torch.float32, device=dev), m)
               for _ in range(2)]


@pytest.mark.parametrize("weights", ["five", "nine"])
@pytest.mark.parametrize("side", [201, 2047, 8191])
def test_residual_restrict_kernel(dev, side, weights):
    """K8 bitwise equal to its plain version at M = 101 (ragged: 4-byte
    copies, edge tiles), 1024 and 4096; pad row and column exactly 0."""
    m, (u4, b4) = _fields_at(dev, side, side)
    w33 = _weights(weights, side)
    K.reset_launch_counts()
    got = K.fused_residual_restrict_packed(u4, b4, w33, m)
    torch.cuda.synchronize()
    assert K.launch_counts()["fused_residual_restrict_packed"] == 1
    assert torch.equal(got, residual_restrict_plain(u4, b4, w33, m))
    assert float(got[m, :].abs().max()) == float(got[:, m].abs().max()) \
        == 0.0


@pytest.mark.parametrize("omega", [0.9, 1.0])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("weights", ["five", "nine", "other"])
@pytest.mark.parametrize("side", [201, 1023, 4095, 8191])
def test_rm_sweep_kernel(dev, side, weights, symmetric, omega):
    """K9 bitwise equal to its plain version, and through the layouts to
    K1 on the same fields, at M = 101 (ragged: 4-byte copies, edge tiles),
    512, 2048 and 4096; pad cells exactly 0."""
    m, (u4, b4) = _fields_at(dev, side, side + 1)
    w33 = _weights(weights, side)
    u_rm, b_rm = to_rm(u4), to_rm(b4)
    K.reset_launch_counts()
    got = K.fused_gs4_sweep_rm(u_rm, b_rm, w33, m, omega, symmetric)
    torch.cuda.synchronize()
    assert K.launch_counts()["fused_gs4_sweep_rm"] == 1
    assert torch.equal(got, fused_gs4_sweep_rm_plain(u_rm, b_rm, w33, m,
                                                     omega, symmetric))
    k1 = K.fused_gs4_sweep_packed(u4, b4, w33, m, omega, symmetric)
    assert torch.equal(from_rm(got), k1)
    assert _pads_zero(from_rm(got), m)


def test_split_vcycle_on_the_card(dev):
    """A V-cycle at 2047^2 with plan[0] forced to "split" (K1, K8, K3 on
    the fine level) against the solver's legs plan."""
    side = 2047
    s = StructuredSolver(side, device=dev)
    assert s.plan[:2] == ("legs", "legs")
    split = ("split",) + s.plan[1:]
    b2 = poisson.rhs(side, dtype=torch.float32, device=dev).reshape(side,
                                                                   side)
    K.reset_launch_counts()
    u_split = vcycle_packed(s.hier, torch.zeros_like(b2), b2, fused=True,
                            plan=split)
    torch.cuda.synchronize()
    c = K.launch_counts()
    assert (c["fused_gs4_sweep_packed"], c["fused_residual_restrict_packed"],
            c["fused_down_leg_packed"], c["fused_up_leg_packed"]) \
        == (1, 1, 1, 2)
    u_legs = vcycle_packed(s.hier, torch.zeros_like(b2), b2, fused=True,
                           plan=s.plan)
    assert _rel(u_split, u_legs) <= 1e-5


def test_solve_goes_through_the_kernels(dev):
    """After warmup (the loop graphs' capture), one solve is one graph
    launch whose replays run the kernels: the legs 1 + 3 it times, K4
    it + 1 times, the condition kernel at the start, each of the it + 1
    passes and the final branch."""
    s = StructuredSolver(SIDE, device=dev)
    s.warmup()
    b2 = poisson.rhs(SIDE, device=dev).reshape(SIDE, SIDE)
    K.reset_launch_counts()
    res = s.solve_ir_fused(b2, tolerance=1e-7)
    it = res.iterations // s.cycles_per_refine
    assert res.converged and res.u.is_cuda
    counts = K.launch_counts()
    assert counts["fused_down_leg_packed"] == 1 + 3 * it
    assert counts["fused_df_residual_rss"] == it + 1
    assert counts["loop_condition"] == it + 3
    assert s._graphs["device"].launches == 2       # warmup's and this one


# (case, StructuredSolver options, jump operator): one of each loop
LOOPS = [("packed", {}, False), ("unpacked", {}, True),
         ("f64", {"precision": "f64"}, True),
         ("masked", {"smoother": "masked"}, False)]


@pytest.mark.parametrize("case,kw,jump", LOOPS, ids=[c[0] for c in LOOPS])
def test_loop_graph_is_the_host_loop(dev, case, kw, jump):
    """The solve loop's graph against the host driver of the same pieces
    on the card: u and stats bitwise, at 255^2, with rtol and with an
    exhausted budget; the dispatch reads nothing on the host."""
    side = 255
    if jump:
        kw = dict(kw, A_planes=varcoef.jump_planes(side, device=dev))
    s = StructuredSolver(side, device=dev, **kw)
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    for tol, n, rtol in ((1e-7, 40, 0.0), (1e-7, 1, 0.0), (0.0, 40, 1e-9)):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            u, stats = s.solve_ir_device(b2, tol, n, rtol)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        hu, hstats = s._solve_device(b2, tol, n, rtol, host=True)
        assert torch.equal(u, hu) and torch.equal(stats, hstats[:2])
    if s.packed_loop:
        b4 = s.prepare_b(b2)
        u4, stats = s.solve_ir_device_prepared(b4, 1e-7)
        h4, hstats = s._solve_prepared(b4, 1e-7, 40, 0.0, host=True)
        assert torch.equal(u4.hi, h4.hi) and torch.equal(u4.lo, h4.lo)
        assert torch.equal(stats, hstats[:2])


def test_pcg_graph_is_the_host_loop(dev):
    from amg_tpu_torch import build_stencil_hierarchy_device, krylov
    side = 1023
    h = build_stencil_hierarchy_device(side, smoother="packed", device=dev)
    b = poisson.rhs(side, dtype=torch.float32, device=dev).reshape(side,
                                                                   side)
    for n in (50, 2):
        u, stats = krylov.solve_pcg_device(h, b, 1e-5, n, fused=True)
        hu, hstats = krylov._solve_pcg_device(h, b, 1e-5, n, True, None,
                                              host=True)
        assert torch.equal(u, hu) and torch.equal(stats, hstats)


# (case, StructuredSolver options, entry point): the options and loops
# without a kernel of their own, on the card against the CPU
VARIANTS = [("solve_ir", {}, "solve_ir"),
            ("fmg_false", {"fmg": False}, "solve_ir_fused"),
            ("masked", {"smoother": "masked"}, "solve_ir_fused"),
            ("strided", {"smoother": "strided"}, "solve_ir_fused"),
            ("chebyshev", {"smoother": "chebyshev"}, "solve_ir_fused")]


@pytest.mark.parametrize("case,kw,entry", VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_variants_on_the_card(dev, case, kw, entry):
    """solve_ir, fmg=False and the unpacked smoothers at 255^2: on the card
    the port's CPU solve's V-cycle count and history check points."""
    side = 255
    b2 = poisson.rhs(side, device="cpu").reshape(side, side)

    def run(d):
        s = StructuredSolver(side, device=d, **kw)
        return getattr(s, entry)(b2.to(d), tolerance=1e-7)
    res, ref = run(dev), run("cpu")
    assert res.converged and res.u.is_cuda and res.error <= 1e-7
    assert res.iterations == ref.iterations
    assert [i for i, _ in res.history] == [i for i, _ in ref.history]


def _rbgs_op(var, side, dev):
    if var:
        return Stencil2D(side=side, c=varcoef.jump_planes(side, device=dev))
    return Stencil2D.const(poisson_const_w33(side, 1)[0], side)


@pytest.mark.parametrize("side", [31, 255, 1023])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("var", [False, True], ids=["K5", "K6"])
def test_rbgs_kernels(dev, var, symmetric, side):
    """K5/K6 bitwise equal to their plain version at sides with a ragged
    last tile (31 < one tile, 255 and 1023 not multiples of 32)."""
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
    assert torch.equal(got, fused_gs4_sweep_plain(S, u, b, 0.9, symmetric))


@pytest.mark.parametrize("omega", [1.0, 0.9])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("weights", ["five", "nine", "other"])
@pytest.mark.parametrize("side", [127, 1000, 1023, 4095])
def test_const_sweep_kernel(dev, side, weights, symmetric, omega):
    """K5 bitwise equal to its plain version (di outer, dj inner, zero
    weights skipped) on each weight pattern it instantiates: the Poisson
    5-point weights, 9-point ones and another zero pattern; an even side
    (1000) and odd ones, 4095 the path's."""
    S = Stencil2D.const(_weights(weights, side), side)
    g = torch.Generator(device=dev).manual_seed(side + len(weights))
    u, b = (torch.randn((side, side), generator=g, device=dev)
            for _ in range(2))
    got = K.fused_gs4_sweep(S, u, b, omega, symmetric)
    assert torch.equal(got, fused_gs4_sweep_plain(S, u, b, omega, symmetric))


@pytest.mark.parametrize("omega", [1.0, 0.9])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("planes", ["jump", "random"])
@pytest.mark.parametrize("side", [127, 1000, 1023, 4095])
def test_var_sweep_kernel(dev, side, planes, symmetric, omega):
    """K6 bitwise equal to its plain version: the jump planes and random
    positive planes, an even side (1000) and odd ones, 4095 the path's."""
    g = torch.Generator(device=dev).manual_seed(side)
    if planes == "jump":
        c = varcoef.jump_planes(side, device=dev)
    else:
        c = torch.rand((3, 3, side, side), generator=g, device=dev) + 0.5
        c[1, 1] += 8.0
    S = Stencil2D(side=side, c=c)
    u, b = (torch.randn((side, side), generator=g, device=dev)
            for _ in range(2))
    got = K.fused_gs4_sweep(S, u, b, omega, symmetric)
    assert torch.equal(got, fused_gs4_sweep_plain(S, u, b, omega, symmetric))


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
                                     (1, 12, 7, 4), (4, 64, 256, 10),
                                     (3, 8, 32, 3)])
def test_halo_kernel(dev, D, B, n, G, dtype):
    """K7 equals its plain version bitwise (a copy): G == B, odd widths
    (element copies) and widths of whole 16-byte vectors, one slab; u and
    b apart and stacked, into a new tensor and into ``out=``, and as
    strided views (the slab rows of a framed field)."""
    g = torch.Generator(device=dev).manual_seed(D * B + n)
    u, b = (torch.randn((D, B, n), generator=g, device=dev, dtype=dtype)
            for _ in range(2))
    framed = torch.randn((2, D, B + 2 * G, n + 4), generator=g, device=dev,
                         dtype=dtype)
    uv, bv = framed[0, :, G:G + B, 4:], framed[1, :, G:G + B, 4:]
    out = torch.full((D, 2 * G, 2 * n), float("nan"), device=dev,
                     dtype=dtype)
    K.reset_launch_counts()
    got = K.rdma_halo_exchange((u, b), G)
    got_st = K.rdma_halo_exchange(torch.cat([u, b], dim=2), G)
    got_out = K.rdma_halo_exchange((u, b), G, out=out)
    got_view = K.rdma_halo_exchange((uv, bv), G)
    torch.cuda.synchronize()
    assert K.launch_counts()["rdma_halo_exchange"] == 4
    ref = rdma_halo_exchange_plain((u, b), G)
    assert torch.equal(got, ref) and torch.equal(got_st, ref)
    assert got_out is out and torch.equal(out, ref)
    assert torch.equal(got_view, rdma_halo_exchange_plain(
        (uv.contiguous(), bv.contiguous()), G))
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
        s.warmup()        # the graphs' captures launch each piece once
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


def test_card_group_rdma_on_one_card(dev):
    """Two blocks of a card group on the one card, halo="rdma": K7's peer
    form between the blocks' streams, the one-block V-cycles and a bitwise
    equal u; K7 14 a V-cycle in each block (2 x levels 0-6 at 4095^2; 3
    levels here, B = 64, 32, 16 >= G = 10)."""
    side = 255
    b2 = poisson.rhs(side, device="cpu").reshape(side, side)
    one = DistStructuredSolver(side, n_devices=4, halo="rdma", device=dev
                               ).solve_ir_fused(b2.to(dev), tolerance=1e-7)
    s = DistStructuredSolver(side, n_devices=4, halo="rdma",
                             device=("cuda:0", "cuda:0"))
    try:
        s.warmup()        # the graphs' captures launch each piece once
        K.reset_launch_counts()
        two = s.solve_ir_fused(b2.to(dev), tolerance=1e-7)
        launches = K.launch_counts()["rdma_halo_exchange"]
    finally:
        s.close()
    assert two.iterations == one.iterations and torch.equal(two.u, one.u)
    assert launches == 2 * (2 * 3) * two.iterations


# one process of the 2 x 2 mesh on the one card (gloo: the processes
# share it), its two blocks on two streams
MESH_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from amg_tpu_torch import DistStructuredSolver, poisson
    from amg_tpu_torch.ops import kernels as K
    from amg_tpu_torch.parallel import launch
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    launch.initialize_distributed(f"localhost:{port}", 2, rank,
                                  local_devices=2)
    assert torch.distributed.get_backend() == "gloo"
    side = 255
    b2 = poisson.rhs(side, device="cpu").reshape(side, side)
    s = DistStructuredSolver(side, n_devices=4, halo="rdma",
                             device=("cuda:0", "cuda:0"))
    try:
        K.reset_launch_counts()
        res = s.solve_ir_fused(b2.to("cuda"), tolerance=1e-7)
        k7 = K.launch_counts()["rdma_halo_exchange"]
    finally:
        s.close()
    np.savez(out, u=res.u.cpu().numpy(), it=res.iterations, k7=k7)
    torch.distributed.destroy_process_group()
""")


def test_mesh_rdma_on_one_card(dev, tmp_path):
    """2 processes x 2 blocks on the one card, halo="rdma": K7's peer form
    between the blocks of a process (pointers) and across the processes
    (CUDA IPC) in one launch; each process gives the one-block V-cycles
    and a bitwise equal u, K7 2 x 3 levels a V-cycle in each block."""
    side = 255
    b2 = poisson.rhs(side, device="cpu").reshape(side, side)
    one = DistStructuredSolver(side, n_devices=4, halo="rdma", device=dev
                               ).solve_ir_fused(b2.to(dev), tolerance=1e-7)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_WORKER, str(rank), str(port),
         str(tmp_path / f"rank{rank}.npz")],
        cwd=Path(__file__).resolve().parents[1], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        assert int(got["it"]) == one.iterations
        assert np.array_equal(got["u"], one.u.cpu().numpy())
        assert int(got["k7"]) == 2 * (2 * 3) * one.iterations


# DistStructuredSolver's programs as CUDA graphs (one block, and a card
# group of two blocks on the one card) against the host driver of the
# same pieces: (halo, dtype, force_var)
DIST_GRAPH = [("rdma", torch.float32, False), ("sweep", torch.float32, False),
              ("overlap", torch.float64, False), ("step", torch.float64, True),
              ("packed", torch.float32, False)]


def _dist_programs(s, b2):
    """Every program's outputs, in one order: vcycle, rss, the PCG loop
    (converged and out of budget), the df32 loop and refine (a constant
    fine level), and the V-cycle loop."""
    out = []
    bp = s.pad_field(b2)
    u = s.vcycle(torch.zeros_like(bp), bp)
    out += [u, torch.tensor(s.rss(u, bp))]
    bt = b2.to(s.dtype)
    for n in (100, 2):
        out += list(s.solve_pcg_device(bt, 1e-12 if s.dtype ==
                                       torch.float64 else 1e-5, n))
    if s.cfg.w33s[0] is not None:
        for n in (40, 1):
            out += list(s.solve_ir_device(b2, 1e-9, n))
        r = s.solve_ir(b2, 1e-9)
        out += [r.u, torch.tensor(r.history)]
    r = s.solve(b2, 1e-9, compute_error_every_n_iters=2, n_iters=12)
    out += [r.u, torch.tensor(r.history)]
    return out


@pytest.mark.parametrize("halo,dtype,var", DIST_GRAPH,
                         ids=[f"{h}-{str(d)[6:]}{'-var' if v else ''}"
                              for h, d, v in DIST_GRAPH])
def test_dist_graph_is_the_host_driver(dev, halo, dtype, var):
    """One block of 4 slabs at 255^2: every program's graph gives the host
    driver's outputs bitwise."""
    side = 255
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    s = DistStructuredSolver(side, n_devices=4, dtype=dtype, halo=halo,
                             force_var=var, device=dev)
    assert s.driver == "graph"
    got = _dist_programs(s, b2)
    s.set_driver("host")
    want = _dist_programs(s, b2)
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), k
    assert set(s._graphs) >= {"vcycle", "rss", "pcg"}


def test_dist_graph_one_launch_no_host_read(dev):
    """solve_ir_device and solve_pcg_device dispatch one graph launch and
    read nothing on the host (set_sync_debug_mode("error")); a piece that
    reads the host fails to capture under that mode."""
    side = 255
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    s = DistStructuredSolver(side, n_devices=4, halo="rdma", device=dev)
    s.warmup()
    g = s._graphs
    n0 = {k: g[k].launches for k in ("ir", "pcg")}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s.solve_ir_device(b2, 1e-7)
        s.solve_pcg_device(b2.float(), 1e-5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert {k: g[k].launches - n0[k] for k in n0} == {"ir": 1, "pcg": 1}
    from amg_tpu_torch.ops.kernels import graph_loop
    bad = torch.zeros((), device=dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            graph_loop.StraightGraph(lambda: bad.add_(float(bad)), dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("halo", ["rdma", "sweep"])
def test_dist_graph_card_group_on_one_card(dev, halo):
    """Two blocks of a card group on the one card: each block's graphs
    (captured and replayed by its thread, the collectives the peer
    collective kernel) give the host driver's outputs and one block's,
    bitwise; one graph launch a solve a block."""
    side = 255
    b2 = poisson.rhs(side, device=dev).reshape(side, side)

    def runs(s):
        r = [s.solve_ir_fused(b2, 1e-7), s.solve_pcg(b2.float(), 1e-5),
             s.solve(b2, 1e-7, compute_error_every_n_iters=2, n_iters=12)]
        return [(x.u, x.iterations, x.error, x.history) for x in r]
    one = runs(DistStructuredSolver(side, n_devices=4, halo=halo,
                                    device=dev))
    s = DistStructuredSolver(side, n_devices=4, halo=halo,
                             device=("cuda:0", "cuda:0"))
    try:
        assert s.driver == "graph"
        got = runs(s)
        n0 = s.run(lambda blk: blk._graphs["ir"].launches)
        s.solve_ir_fused(b2, 1e-9)
        n1 = s._group.run(lambda k: s._blocks[k]._graphs["ir"].launches)
        s.set_driver("host")
        host = runs(s)
    finally:
        s.close()
    assert n1 == [n0 + 1] * 2
    for a, b, c in zip(got, host, one):
        assert torch.equal(a[0], b[0]) and torch.equal(a[0], c[0])
        assert a[1:] == b[1:]
        # one block's counts; its rss within 1e-12 (a block's df32 rss is
        # summed over its slabs, then over the blocks: the card group's
        # rule, chip_smoke.py CARD_RTOL)
        assert a[1] == c[1]
        for (i, e), (ci, ce) in zip(a[3], c[3]):
            assert i == ci and abs(e / ce - 1) <= 1e-12


def _collective_case(k, lost=False):
    """One block's calls: the peer collective against its plain version,
    bitwise: sums in block order (f32, f64; one element, and more than a
    CTA's chunks) and gathers (a few words, and several chunks a CTA),
    three times each (both slot parities)."""
    from amg_tpu_torch.ops.kernels import peer_collective as pc
    from amg_tpu_torch.parallel import launch
    dev = torch.device("cuda", torch.cuda.current_device())
    mem = launch.GroupCollectives(1 << 20, timeout_s=0.5)
    try:
        if lost:
            if k == 0:
                pc.peer_collective(torch.ones(4, device=dev), mem, pc.SUM)
                torch.cuda.current_stream().synchronize()
                with pytest.raises(RuntimeError, match="timed out"):
                    mem.check()
            return True
        g = torch.Generator(device="cpu").manual_seed(k)
        ok = True
        for _ in range(3):
            for shape, dtype, mode in (
                    ((), torch.float64, pc.SUM), ((), torch.float32, pc.SUM),
                    ((70000,), torch.float64, pc.SUM),
                    ((3,), torch.float32, pc.GATHER),
                    ((4, 257, 511), torch.float32, pc.GATHER)):
                x = (torch.randn(shape, generator=g, dtype=torch.float64)
                     * 10.0 ** (4 * k)).to(dtype).to(dev)
                got = pc.peer_collective(x, mem, mode)
                want = (launch._gather_host(x) if mode == pc.GATHER
                        else launch._psum_host(x))
                ok = ok and torch.equal(got, want)
        torch.cuda.current_stream().synchronize()
        mem.check()
        return ok
    finally:
        mem.close()


@pytest.mark.parametrize("blocks", [2, 3])
def test_peer_collective_against_its_plain_version(dev, blocks):
    from amg_tpu_torch.parallel import launch
    g = launch.CardGroup(("cuda:0",) * blocks)
    try:
        assert g.run(_collective_case) == [True] * blocks
    finally:
        g.close()


def test_peer_collective_lost_block_times_out(dev):
    """Block 1 never calls: block 0's wait ends at its bound and its
    status raises."""
    from amg_tpu_torch.parallel import launch
    g = launch.CardGroup(("cuda:0",) * 2)
    try:
        assert g.run(lambda k: _collective_case(k, lost=True)) == [True] * 2
    finally:
        g.close()


# EllDistSolver's four programs as CUDA graphs (one block, and a card
# group of two blocks on the one card) against the host driver of the
# same pieces: (halo, dtype)
ELL_GRAPH = [("step", torch.float64), ("strips", torch.float64),
             ("strips", torch.float32)]


def _ell_programs(s):
    """Every program's outputs, in one order: vcycle_once, rss, solve
    (the rss every 2 cycles, and a budget), the PCG loop (converged and
    out of budget) and, in f32, solve_ir."""
    out = []
    bp = s.pad_vec(s.b)
    u = s.vcycle_once(torch.zeros_like(bp), bp)
    out += [u, torch.tensor(s.rss(u, bp))]
    for kw in (dict(tolerance=1e-9, compute_error_every_n_iters=2),
               dict(tolerance=0.0, compute_error_every_n_iters=3,
                    n_iters=7)):
        r = s.solve(**kw)
        out += [r.u, torch.tensor(r.history + [(r.iterations, r.error)])]
    tol = 1e-9 if s.dtype == torch.float64 else 1e-5
    for n in (100, 2):
        r = s.solve_pcg(tol, n)
        out += [r.u, torch.tensor(r.history)]
    if s.dtype == torch.float32:
        for n in (40, 2):
            r = s.solve_ir(1e-9, n)
            out += [r.u, torch.tensor(r.history)]
    return out


def _ell_solver(dev, halo, dtype, device=None):
    from amg_tpu_torch.ops.transfer import BilinearInterpolator2D
    from amg_tpu_torch.parallel.ell_dist import EllDistSolver
    side = 255
    A, b = poisson.poisson2d(side, device=dev)
    return EllDistSolver(A, b, 7, n_devices=4, dtype=dtype, halo=halo,
                         interpolator=BilinearInterpolator2D(side),
                         device=device or dev)


@pytest.mark.parametrize("halo,dtype", ELL_GRAPH,
                         ids=[f"{h}-{str(d)[6:]}" for h, d in ELL_GRAPH])
def test_ell_graph_is_the_host_driver(dev, halo, dtype):
    """One block of 4 slabs at 255^2 (the bilinear pipeline): every
    program's graph gives the host driver's outputs bitwise; the PCG is
    one graph launch a call with no host read inside."""
    s = _ell_solver(dev, halo, dtype)
    assert s.driver == "graph"
    got = _ell_programs(s)
    assert set(s._graphs) >= {"vcycle", "rss", "pcg"}
    n0 = s._graphs["pcg"].launches
    bp = s.pad_vec(s.b)
    L = s._state()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s._run("pcg", lambda: (L.b.copy_(bp), L.p_tol.fill_(1e-9),
                               L.p_n.fill_(100)))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert s._graphs["pcg"].launches == n0 + 1
    s.set_driver("host")
    want = _ell_programs(s)
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), k
    s.close()


def test_ell_graph_card_group_on_one_card(dev):
    """Two blocks of a card group on the one card ("strips", f32): each
    block's graphs (the collectives the peer collective kernel) give the
    host driver's results and one block's, bitwise; one graph launch a
    refine a block."""
    def runs(s):
        r = [s.solve(1e-9, 2), s.solve_pcg(1e-5), s.solve_ir(1e-9)]
        return [(x.u, x.iterations, x.error, x.history) for x in r]
    one = runs(_ell_solver(dev, "strips", torch.float32))
    s = _ell_solver(dev, "strips", torch.float32, ("cuda:0", "cuda:0"))
    try:
        assert s.driver == "graph"
        got = runs(s)
        n0 = s.run(lambda blk: blk._graphs["refine"].launches)
        r = s.solve_ir(1e-9)
        n1 = s._group.run(lambda k: s._blocks[k]._graphs["refine"].launches)
        s.set_driver("host")
        host = runs(s)
    finally:
        s.close()
    assert n1 == [n0 + len(r.history)] * 2
    for a, b, c in zip(got, host, one):
        assert torch.equal(a[0], b[0]) and torch.equal(a[0], c[0])
        assert a[1:] == b[1:] == c[1:]


def _chunk_graphs(loops) -> int:
    return sum(g.launches for loop in loops for g in loop.graphs.values())


def test_chunk_graphs_are_the_host_driver(dev):
    """multigrid.solve (the bilinear pipeline at 255^2), Multigrid.solve
    (testlib 35^2, symmetric GS) and solve_stencil (255^2, masked): the
    chunk graphs give the host driver's u, counts and histories bitwise,
    one graph launch a chunk and one a check."""
    from amg_tpu_torch import (BilinearInterpolator2D,
                               MulticolorGaussSeidel, Multigrid,
                               SparseGaussSeidel, build_stencil_hierarchy)
    from amg_tpu_torch import multigrid as mg
    from amg_tpu_torch import structured as st
    A, b = poisson.poisson2d(255, device=dev)
    amg = Multigrid(BilinearInterpolator2D(255), MulticolorGaussSeidel(), A,
                    b, 7, 1e-9, 1, 100, device=dev)
    h, sm = amg.hierarchy, amg.smoother
    for tol, every, n in ((1e-9, 1, 100), (0.0, 3, 7), (1e-9, 0, 4)):
        n0 = _chunk_graphs(h.chunk_loops.values())
        r = mg.solve(h, sm, b, None, tol, every, n)
        launches = _chunk_graphs(h.chunk_loops.values()) - n0
        hr = mg._solve(h, sm, b, None, tol, every, n, host=True)
        assert torch.equal(r.u, hr.u) and r.history == hr.history
        chunks = -(-r.iterations // every) if every else 1
        assert launches == chunks + len(r.history)
    A, b = poisson.poisson2d(35, device=dev)
    t = Multigrid(None, SparseGaussSeidel(), A, b, 8, 1e-9, 5, 100,
                  device=dev)
    r = t.solve(verbose=False)
    hr = mg._solve(t.hierarchy, t.smoother, t.b, None, 1e-9, 5, 100,
                   host=True)
    assert r.iterations == 35 and torch.equal(r.u, hr.u)
    assert r.history == hr.history
    hs = build_stencil_hierarchy(255, dtype=torch.float64, device=dev)
    b2 = poisson.rhs(255, device=dev).reshape(255, 255)
    for tol, every, n in ((1e-9, 2, 100), (0.0, 4, 10)):
        r = st.solve_stencil(hs, b2, None, tol, every, n, device=dev)
        hr = st._solve_stencil(hs, b2, None, tol, every, n, 1, 1, 1.0, True,
                               dev, host=True)
        assert torch.equal(r.u, hr.u) and r.history == hr.history


def test_refine_graph_is_the_host_driver(dev):
    """StructuredSolver.solve_ir at 1023^2 (K2/K3 in its cycles): one
    refine graph launch a step, u and history bitwise the host
    driver's."""
    s = StructuredSolver(SIDE, device=dev)
    s.warmup(refine_step=True)
    b2 = poisson.rhs(SIDE, device=dev).reshape(SIDE, SIDE)
    n0 = s._graphs["refine"].launches
    K.reset_launch_counts()
    r = s.solve_ir(b2, 1e-7)
    counts = K.launch_counts()
    assert s._graphs["refine"].launches - n0 == len(r.history)
    assert counts["fused_down_leg_packed"] > 0
    hr = s._solve_ir(b2, 1e-7, 40, host=True)
    assert r.converged and torch.equal(r.u, hr.u)
    assert r.history == hr.history


# one of 2 processes on the one card (gloo: the processes share it), each a
# block of 2 slabs, every program a CUDA graph (ROADMAP 6c step 3): "runs"
# drives DistStructuredSolver 255^2 D = 4 "rdma" and EllDistSolver 255^2
# "strips" (f32) under the graph driver, then the host driver; "lost"
# leaves process 1 alive but calling nothing after the captures
PROC_GRAPH_WORKER = textwrap.dedent("""
    import os
    import sys
    import time
    import numpy as np
    import torch
    from amg_tpu_torch import DistStructuredSolver, poisson
    from amg_tpu_torch.ops.kernels import peer_collective as pc
    from amg_tpu_torch.ops.transfer import BilinearInterpolator2D
    from amg_tpu_torch.parallel import launch
    from amg_tpu_torch.parallel.ell_dist import EllDistSolver
    rank, port, out, mode = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                             sys.argv[4])
    launch.initialize_distributed(f"localhost:{port}", 2, rank)
    assert torch.distributed.get_backend() == "gloo"
    side = 255
    b2 = poisson.rhs(side, device="cuda").reshape(side, side)
    if mode == "lost":
        pc.TIMEOUT_S = 2.0
        s = DistStructuredSolver(side, n_devices=4, halo="sweep")
        s.warmup()
        torch.cuda.synchronize()
        if rank == 1:
            done = os.path.join(os.path.dirname(out), "rank0.npz")
            t0 = time.monotonic()
            while not os.path.exists(done) and time.monotonic() - t0 < 120:
                time.sleep(0.1)
            os._exit(0)
        t0 = time.monotonic()
        try:
            s.solve_ir_fused(b2, tolerance=1e-7)
            what = ""
        except RuntimeError as exc:
            what = str(exc)
        np.savez(out + ".part.npz", seconds=time.monotonic() - t0,
                 what=what)
        os.replace(out + ".part.npz", out)
        sys.stdout.flush()
        os._exit(0)
    A, b = poisson.poisson2d(side, device="cuda")

    def dist_runs(s):
        return [s.solve_ir_fused(b2, 1e-7), s.solve_pcg(b2.float(), 1e-5),
                s.solve(b2, 1e-7, compute_error_every_n_iters=2,
                        n_iters=12)]

    def ell_runs(s):
        return [s.solve(1e-9, 2), s.solve_pcg(1e-5), s.solve_ir(1e-9)]
    got = {}
    for name, make, runs in (
            ("dist", lambda: DistStructuredSolver(side, n_devices=4,
                                                  halo="rdma"), dist_runs),
            ("ell", lambda: EllDistSolver(
                A, b, 7, n_devices=4, dtype=torch.float32, halo="strips",
                interpolator=BilinearInterpolator2D(side)), ell_runs)):
        s = make()
        try:
            assert s.driver == "graph", s.driver
            runs(s)                       # the programs captured
            n0 = {k: g.launches for k, g in s._graphs.items()}
            graph = runs(s)
            n1 = {k: g.launches for k, g in s._graphs.items()}
            s.set_driver("host")
            host = runs(s)
        finally:
            s.close()
        for i, (g, h) in enumerate(zip(graph, host)):
            for tag, r in (("graph", g), ("host", h)):
                got[f"{name}{i}_{tag}_u"] = r.u.cpu().numpy()
                got[f"{name}{i}_{tag}_stats"] = np.array(
                    [r.iterations, r.error]
                    + [x for pair in r.history for x in pair])
        got[f"{name}_launches"] = np.array(
            [n1[k] - n0[k] for k in sorted(n1)])
        got[f"{name}_programs"] = np.array(sorted(n1))
    np.savez(out, **got)
    torch.distributed.destroy_process_group()
""")


def _spawn_pair(tmp_path, mode):
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", PROC_GRAPH_WORKER, str(rank), str(port),
         str(tmp_path / f"rank{rank}.npz"), mode],
        cwd=Path(__file__).resolve().parents[1], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    outs = [p.communicate(timeout=420)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


def test_proc_graphs_are_the_host_driver_and_one_process(dev, tmp_path):
    """2 processes on the one card: DistStructuredSolver ("rdma": K7's
    peer form and the peer collective kernel inside the graphs across the
    processes) and EllDistSolver ("strips", f32) default to the graph
    driver; each call's graphs give the host driver's u, counts, rss and
    histories bitwise, in both processes, and one process's u and counts
    (the ELL's rss too); one graph launch a program run a process."""
    from amg_tpu_torch.ops.transfer import BilinearInterpolator2D
    from amg_tpu_torch.parallel.ell_dist import EllDistSolver
    side = 255
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    A, b = poisson.poisson2d(side, device=dev)
    one = {"dist": DistStructuredSolver(side, n_devices=4, halo="rdma",
                                        device=dev),
           "ell": EllDistSolver(A, b, 7, n_devices=4, dtype=torch.float32,
                                halo="strips", device=dev,
                                interpolator=BilinearInterpolator2D(side))}
    ref = {"dist": [one["dist"].solve_ir_fused(b2, 1e-7),
                    one["dist"].solve_pcg(b2.float(), 1e-5),
                    one["dist"].solve(b2, 1e-7,
                                      compute_error_every_n_iters=2,
                                      n_iters=12)],
           "ell": [one["ell"].solve(1e-9, 2), one["ell"].solve_pcg(1e-5),
                   one["ell"].solve_ir(1e-9)]}
    _spawn_pair(tmp_path, "runs")
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        for name, rs in ref.items():
            for i, r in enumerate(rs):
                g, h = (got[f"{name}{i}_{t}_u"] for t in ("graph", "host"))
                gs, hs = (got[f"{name}{i}_{t}_stats"]
                          for t in ("graph", "host"))
                assert np.array_equal(g, h) and np.array_equal(gs, hs), \
                    (rank, name, i)
                assert np.array_equal(g, r.u.cpu().numpy()), (rank, name, i)
                assert gs[0] == r.iterations, (rank, name, i)
                if name == "ell":
                    assert gs[1] == r.error, (rank, name, i)
            runs = dict(zip(got[f"{name}_programs"],
                            got[f"{name}_launches"]))
            first, _, last = rs
            if name == "dist":
                want = {"ir": 1, "pcg": 1, "vcycle": last.iterations,
                        "rss": len(last.history)}
            else:
                want = {"vcycle": first.iterations,
                        "rss": len(first.history), "pcg": 1,
                        "refine": len(last.history)}
            assert {k: v for k, v in runs.items() if v} == want, \
                (rank, name, runs)


def test_proc_graph_lost_process_raises(dev, tmp_path):
    """Process 1 stays alive but calls nothing after the captures: process
    0's graph launch does not hang; its peer collectives' waits end at
    their bound (2 s here) and the solve raises on the status."""
    _spawn_pair(tmp_path, "lost")
    got = np.load(tmp_path / "rank0.npz")
    assert "peer collective: a wait" in str(got["what"]), got["what"]
    assert float(got["seconds"]) < 60.0
