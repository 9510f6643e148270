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
    s = StructuredSolver(SIDE, device=dev)
    b2 = poisson.rhs(SIDE, device=dev).reshape(SIDE, SIDE)
    K.reset_launch_counts()
    res = s.solve_ir_fused(b2, tolerance=1e-7)
    it = res.iterations // s.cycles_per_refine
    assert res.converged and res.u.is_cuda
    counts = K.launch_counts()
    assert counts["fused_down_leg_packed"] == 1 + 3 * it
    assert counts["fused_df_residual_rss"] == it + 1


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
