"""Smoke run of the amg_tpu_torch port on one CUDA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1-K6) from amg_tpu_torch/csrc, checks
each against its plain PyTorch version on the card and times both, then
drives the solves through the user entry points with an independent f64
residual check and the kernels' launch counts:

* the constant-coefficient Poisson df32 solve (StructuredSolver ->
  prepare_b -> solve_ir_device_prepared -> finalize_u) at 1023^2 and
  4095^2 (K2-K4), and at 1023^2 with two sweeps (K1);
* the variable-coefficient jump problem (a = 100, models/varcoef.py)
  through solve_ir_device: smoother="auto" at 2047^2 and 4095^2 (no
  kernel), smoother="fused" at 4095^2 (K6), precision="f64" at 4095^2;
* the constant problem with smoother="fused" at 4095^2 (K5);
* the card against the port's own CPU solve at 1023^2 (constant) and
  255^2 (variable).

Any failed check raises, so the exit code is non-zero. The line before
the last of stdout is the card's name and power limit, the one before it
the kernels' JSON; the last line is one JSON object with "ok" and the
device. Needs a CUDA device and nvcc; imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from amg_tpu_torch import StructuredSolver, poisson, varcoef
from amg_tpu_torch.ops import kernels as K
from amg_tpu_torch.ops.doublefloat import DF32
from amg_tpu_torch.ops.kernels import _build
from amg_tpu_torch.ops.kernels.packed_cycle import (down_leg_plain,
                                                    up_leg_plain)
from amg_tpu_torch.ops.kernels.packed_df import df_residual_rss_plain
from amg_tpu_torch.ops.kernels.rbgs import fused_gs4_sweep_plain
from amg_tpu_torch.ops.rap import poisson_const_w33
from amg_tpu_torch.sparse.packed import gs4_sweep_packed, pack
from amg_tpu_torch.sparse.stencil import Stencil2D

TOL = 1e-7
PARITY_SIDES = (1023, 4095)            # M = 512 and 2048
SOLVE_SIDES = (1023, 4095)
RBGS_SIDES = (1023, 4095)              # K5/K6 run at 4095 on the path

# H100 SXM data-sheet peaks (700 W): device memory rate and f32 outside
# the tensor cores; the least time of a kernel is the larger of its
# bytes over the first and its f32 operations over the second.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Kernel-vs-plain bounds, max|kernel - plain| / max|plain|. They are the
# JAX package's own interpret-mode bounds for these kernels
# (tests/test_packed_cycle.py, tests/test_packed_df.py): room for f32
# reassociation. The kernels keep the plain versions' operation order and
# are built with -fmad=false, so 0 is expected. K5/K6 take K1's bound.
BOUND = {"sweep_u": 2e-6, "down_u": 2e-6, "down_bc": 1e-5, "up_u": 1e-5,
         "df_rhi": 1e-6, "df_rss": 1e-5, "rbgs_u": 2e-6}

KERNEL_INFO = {
    "fused_gs4_sweep_packed": ("amg_tpu_torch/csrc/packed_sweep.cu",
                               "amg_tpu/ops/pallas/packed_rbgs.py:674"),
    "fused_down_leg_packed": ("amg_tpu_torch/csrc/packed_cycle.cu",
                              "amg_tpu/ops/pallas/packed_cycle.py:186"),
    "fused_up_leg_packed": ("amg_tpu_torch/csrc/packed_cycle.cu",
                            "amg_tpu/ops/pallas/packed_cycle.py:465"),
    "fused_df_residual_rss": ("amg_tpu_torch/csrc/packed_df.cu",
                              "amg_tpu/ops/pallas/packed_df.py:258"),
    "fused_gs4_sweep_const": ("amg_tpu_torch/csrc/rbgs_sweep.cu",
                              "amg_tpu/ops/pallas/rbgs.py:544"),
    "fused_gs4_sweep_var": ("amg_tpu_torch/csrc/rbgs_sweep.cu",
                            "amg_tpu/ops/pallas/rbgs.py:584"),
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def rel_err(got, ref) -> tuple[float, float]:
    d = float((got.double() - ref.double()).abs().max())
    return d, d / max(float(ref.double().abs().max()), 1e-300)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for moving nbytes and doing
    ops f32 operations at the data-sheet peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_ops(w33, cells: int, symmetric: bool = True) -> int:
    """f32 operations of one GS sweep: per cell update a multiply and an
    add per nonzero off-diagonal weight, then 5 (b - acc, * inv_diag,
    - u, * omega, + u); each cell updates twice when symmetric."""
    k = sum(1 for dj in range(3) for di in range(3)
            if (dj, di) != (1, 1) and w33[dj][di] != 0.0)
    return cells * (2 if symmetric else 1) * (2 * k + 5)


def packed_fields(side: int, seed: int, dev):
    m = (side - 1) // 2
    rng = np.random.default_rng(seed)

    def f(scale=1.0):
        x = rng.standard_normal((side, side)) * scale
        return pack(torch.as_tensor(x, dtype=torch.float32, device=dev), m)
    return m, f


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def interleaved(name: str, size: str, kern, plain, reps: int, times: dict):
    """plain, kernel, kernel, plain: the better of two runs of each,
    compared within one call."""
    p1 = time_ms(plain, max(reps // 5, 2))
    k1 = time_ms(kern, reps)
    k2 = time_ms(kern, reps)
    p2 = time_ms(plain, max(reps // 5, 2))
    kms, pms = min(k1, k2), min(p1, p2)
    print(f"time {name} {size}: kernel {kms:.4f} ms, plain {pms:.4f} ms "
          f"(x{pms / kms:.1f})")
    times[name] = (kms, pms)


def parity_and_timing(dev):
    """Phases 2 and 3 for K1-K4: each kernel against its plain version,
    and both timed, at the main path's M = 512 and 2048. Returns per-kernel
    max_abs_err, {kernel: (kernel ms, plain ms)} and {kernel: bound} at
    M = 2048."""
    errs = {k: 0.0 for k in list(KERNEL_INFO)[:4]}
    times, bounds = {}, {}
    for side in PARITY_SIDES:
        M = (side + 1) // 2
        w33 = poisson_const_w33(side, 1)[0]
        m, f = packed_fields(side, seed=side, dev=dev)
        u4, b4 = f(), f()
        uc_pad = F.pad(torch.as_tensor(
            np.random.default_rng(side + 1).standard_normal((m, m)),
            dtype=torch.float32, device=dev), (0, 1, 0, 1))
        u_df, b_df = DF32(hi=f(), lo=f(1e-8)), DF32(hi=f(), lo=f(1e-8))

        for symmetric in (True, False):
            got = K.fused_gs4_sweep_packed(u4, b4, w33, m, 0.9, symmetric)
            ref = gs4_sweep_packed(u4, b4, w33, m, 0.9, symmetric)
            d, r = rel_err(got, ref)
            errs["fused_gs4_sweep_packed"] = max(
                errs["fused_gs4_sweep_packed"], d)
            print(f"parity K1 sweep M={M} symmetric={symmetric} omega=0.9: "
                  f"max_abs {d:.3e} rel {r:.3e} (bound {BOUND['sweep_u']})")
            require(r <= BOUND["sweep_u"], "K1 sweep parity")
            require(float(got[1][:, m].abs().max()) == 0.0
                    and float(got[2][m, :].abs().max()) == 0.0
                    and float(got[3][m, :].abs().max()) == 0.0
                    and float(got[3][:, m].abs().max()) == 0.0,
                    "K1 pad cells exactly 0")

        gu, gbc = K.fused_down_leg_packed(u4, b4, w33, m, 0.9, True)
        ru, rbc = down_leg_plain(u4, b4, w33, m, 0.9, True)
        du, r_u = rel_err(gu, ru)
        dbc, r_bc = rel_err(gbc, rbc)
        errs["fused_down_leg_packed"] = max(errs["fused_down_leg_packed"],
                                            du, dbc)
        print(f"parity K2 down leg M={M}: u max_abs {du:.3e} rel {r_u:.3e} "
              f"(bound {BOUND['down_u']}); bc max_abs {dbc:.3e} rel "
              f"{r_bc:.3e} (bound {BOUND['down_bc']})")
        require(r_u <= BOUND["down_u"] and r_bc <= BOUND["down_bc"],
                "K2 down-leg parity")
        require(float(gbc[m, :].abs().max()) == 0.0
                and float(gbc[:, m].abs().max()) == 0.0,
                "K2 bc_pad pad row and column exactly 0")

        got = K.fused_up_leg_packed(u4, b4, uc_pad, w33, m, 0.9, True)
        ref = up_leg_plain(u4, b4, uc_pad, w33, m, 0.9, True)
        d, r = rel_err(got, ref)
        errs["fused_up_leg_packed"] = max(errs["fused_up_leg_packed"], d)
        print(f"parity K3 up leg M={M}: max_abs {d:.3e} rel {r:.3e} "
              f"(bound {BOUND['up_u']})")
        require(r <= BOUND["up_u"], "K3 up-leg parity")
        require(float(got[3][m, :].abs().max()) == 0.0
                and float(got[3][:, m].abs().max()) == 0.0,
                "K3 pad cells exactly 0")

        rh, rss = K.fused_df_residual_rss(w33, b_df, u_df, m)
        rh_ref, rss_ref = df_residual_rss_plain(w33, b_df, u_df, m)
        d, r = rel_err(rh, rh_ref)
        rss_rel = abs(float(rss) - float(rss_ref)) / float(rss_ref)
        errs["fused_df_residual_rss"] = max(errs["fused_df_residual_rss"], d)
        print(f"parity K4 df residual M={M}: r.hi max_abs {d:.3e} rel "
              f"{r:.3e} (bound {BOUND['df_rhi']}); rss rel {rss_rel:.3e} "
              f"(bound {BOUND['df_rss']})")
        require(r <= BOUND["df_rhi"] and rss_rel <= BOUND["df_rss"],
                "K4 df residual parity")
        require(float(rh[3][m, :].abs().max()) == 0.0
                and float(rh[3][:, m].abs().max()) == 0.0,
                "K4 pad cells exactly 0")

        reps = 50 if M <= 512 else 20
        pairs = {
            "fused_gs4_sweep_packed": (
                lambda: K.fused_gs4_sweep_packed(u4, b4, w33, m),
                lambda: gs4_sweep_packed(u4, b4, w33, m)),
            "fused_down_leg_packed": (
                lambda: K.fused_down_leg_packed(u4, b4, w33, m),
                lambda: down_leg_plain(u4, b4, w33, m)),
            "fused_up_leg_packed": (
                lambda: K.fused_up_leg_packed(u4, b4, uc_pad, w33, m),
                lambda: up_leg_plain(u4, b4, uc_pad, w33, m)),
            "fused_df_residual_rss": (
                lambda: K.fused_df_residual_rss(w33, b_df, u_df, m),
                lambda: df_residual_rss_plain(w33, b_df, u_df, m)),
        }
        t = {}
        for name, (kern, plain) in pairs.items():
            interleaved(name, f"M={M}", kern, plain, reps, t)
        if M == 2048:
            times.update(t)
            f4 = u4.nbytes          # one packed (4, M, M) f32 field
            cells = side * side
            sweep = sweep_ops(w33, cells)
            n_parts = _build.library().amg_df_partials_count(M)
            # residual 2k + 3 ops a cell, restriction 4, prolongation 3
            bounds.update({
                "fused_gs4_sweep_packed": bound(3 * f4, sweep),
                "fused_down_leg_packed": bound(3 * f4 + uc_pad.nbytes,
                                               sweep + 15 * cells),
                "fused_up_leg_packed": bound(3 * f4 + uc_pad.nbytes,
                                             sweep + 3 * cells),
                # 5 TwoSum-cascade terms of 10 ops, a TwoSum, the square
                "fused_df_residual_rss": bound(5 * f4 + 4 * n_parts,
                                               60 * cells),
            })
    return errs, times, bounds


def rbgs_parity_and_timing(dev):
    """K5/K6 against their plain version at n = 1023 and 4095: symmetric
    and forward, omega 1 and 0.9; K5 on the Poisson weights, K6 on the
    jump-coefficient planes and on random positive planes. Times both at
    n = 4095 (the path's size), K5 on Poisson and K6 on the jump planes."""
    errs = {"fused_gs4_sweep_const": 0.0, "fused_gs4_sweep_var": 0.0}
    times, bounds = {}, {}
    for side in RBGS_SIDES:
        g = torch.Generator(device=dev).manual_seed(side)
        u = torch.randn((side, side), generator=g, device=dev)
        b = torch.randn((side, side), generator=g, device=dev)
        rand = torch.rand((3, 3, side, side), generator=g, device=dev) + 0.5
        rand[1, 1] += 8.0
        w33 = poisson_const_w33(side, 1)[0]
        ops = {"K5 poisson": Stencil2D.const(w33, side),
               "K6 jump": Stencil2D(side=side, c=varcoef.jump_planes(
                   side, device=dev)),
               "K6 random": Stencil2D(side=side, c=rand)}
        for label, S in ops.items():
            name = ("fused_gs4_sweep_const" if S.w33 is not None
                    else "fused_gs4_sweep_var")
            for symmetric in (True, False):
                for omega in (1.0, 0.9):
                    got = K.fused_gs4_sweep(S, u, b, omega, symmetric)
                    ref = fused_gs4_sweep_plain(S, u, b, omega, symmetric)
                    d, r = rel_err(got, ref)
                    errs[name] = max(errs[name], d)
                    print(f"parity {label} n={side} symmetric={symmetric} "
                          f"omega={omega}: max_abs {d:.3e} rel {r:.3e} "
                          f"(bound {BOUND['rbgs_u']})")
                    require(r <= BOUND["rbgs_u"], f"{label} parity")
        if side == 4095:
            for label, name in (("K5 poisson", "fused_gs4_sweep_const"),
                                ("K6 jump", "fused_gs4_sweep_var")):
                S = ops[label]
                interleaved(name, f"n={side}",
                            lambda: K.fused_gs4_sweep(S, u, b),
                            lambda: fused_gs4_sweep_plain(S, u, b), 20,
                            times)
            cells = side * side
            bounds["fused_gs4_sweep_const"] = bound(3 * u.nbytes,
                                                    sweep_ops(w33, cells))
            # 8 off-diagonal terms and a division per update
            bounds["fused_gs4_sweep_var"] = bound(
                3 * u.nbytes + ops["K6 jump"].c.nbytes, cells * 2 * 22)
        del ops, rand
    return errs, times, bounds


def f64_rss(u: torch.Tensor, b: torch.Tensor, side: int) -> float:
    """Independent rss of b - A u: plain f64 5-point Laplacian (-4/h^2
    diagonal, +1/h^2 neighbours, zero Dirichlet boundary)."""
    h = poisson.grid_spacing_h(side)
    up = F.pad(u, (1, 1, 1, 1))
    Au = (up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
          - 4.0 * u) / (h * h)
    return float(torch.sum((b - Au) ** 2))


def f64_rss_planes(u: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                   ) -> float:
    """Independent rss of b - A u for (3,3,n,n) planes, in f64 with its
    own 9 shifted products (zero Dirichlet boundary)."""
    n = u.shape[0]
    up = F.pad(u, (1, 1, 1, 1))
    Au = torch.zeros_like(u)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            Au += (c[dj + 1, di + 1].double()
                   * up[1 + dj:1 + dj + n, 1 + di:1 + di + n])
    return float(torch.sum((b - Au) ** 2))


def solution_bound(rss1: float, rss2: float, side: int) -> float:
    """Bound on max|u1 - u2| for two iterates of the same system:
    |u1 - u2|_max <= |A^-1|_2 (|r1|_2 + |r2|_2), |A^-1|_2 = 1/lambda_min
    with lambda_min = 8 sin^2(pi h / 4) / h^2 (about pi^2 / 2) for the
    Poisson operator, and at most that for the jump operator (a >= 1)."""
    h = poisson.grid_spacing_h(side)
    lam_min = 8.0 * np.sin(np.pi * h / 4.0) ** 2 / (h * h)
    return (rss1 ** 0.5 + rss2 ** 0.5) / lam_min


def solve_once(s: StructuredSolver, b2: torch.Tensor):
    """The constant main path: prepare_b -> solve_ir_device_prepared ->
    finalize_u."""
    u4, stats = s.solve_ir_device_prepared(s.prepare_b(b2), tolerance=TOL)
    u = s.finalize_u(u4)
    err, it = stats.tolist()
    return u, err, int(it)


def solve_device(s: StructuredSolver, b2, tol: float, n_refine: int = 40):
    u, stats = s.solve_ir_device(b2, tolerance=tol, n_refine=n_refine)
    err, it = stats.tolist()
    return u, err, int(it)


def drive(fn, launches: dict):
    """One run of a path with the launch counts set to 0 just before it
    and read just after; adds them to ``launches``."""
    K.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    for k, n in counts.items():
        launches[k] += n
    return out, counts


def wall_median(fn, reps: int) -> tuple[float, list]:
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), walls


def const_solves(dev, launches: dict):
    """Phase 4: the constant Poisson solve at 1023^2 and 4095^2 (legs),
    and at 1023^2 with two sweeps (K1)."""
    configs = [(side, 1) for side in SOLVE_SIDES] + [(1023, 2)]
    solvers, rhs = {}, {}
    for side, sweeps in configs:
        t0 = time.perf_counter()
        s = StructuredSolver(side, pre_sweeps=sweeps, post_sweeps=sweeps,
                             device=dev)
        s.warmup()
        torch.cuda.synchronize()
        print(f"setup+warmup {side}^2 sweeps={sweeps}: plan {s.plan}, "
              f"{time.perf_counter() - t0:.2f} s")
        solvers[(side, sweeps)] = s
        rhs[side] = poisson.rhs(side, device=dev).reshape(side, side)

    results = {}
    for side, sweeps in configs:
        (u, err, it), c = drive(
            lambda: solve_once(solvers[(side, sweeps)], rhs[side]), launches)
        results[(side, sweeps)] = (u, err, it)
        ind = f64_rss(u, rhs[side], side)
        print(f"solve {side}^2 sweeps={sweeps}: refines {it}, rss "
              f"{err:.6e}, independent f64 rss {ind:.6e}, launches {c}")
        require(bool(torch.isfinite(u).all()) and u.shape == (side, side),
                f"finite u of shape ({side}, {side})")
        require(err <= TOL and ind <= TOL, f"{side}^2 converged to {TOL}")
        require(c["fused_df_residual_rss"] == it + 1, "K4 = it + 1")
        if sweeps == 1:
            legs = 1 + 3 * it if side == 1023 else 6 + 9 * it
            require(c["fused_down_leg_packed"] == legs
                    and c["fused_up_leg_packed"] == legs,
                    f"K2 = K3 = {legs} at {side}^2")
            require(c["fused_gs4_sweep_packed"] == 0, "K1 off the legs path")
        else:
            require(c["fused_gs4_sweep_packed"] == 4 * (1 + 3 * it),
                    "K1 = 4 (1 + 3 it) with two sweeps")
            require(c["fused_down_leg_packed"] == 0, "legs off at 2 sweeps")
        require(c["fused_gs4_sweep_const"] == c["fused_gs4_sweep_var"] == 0,
                "K5/K6 off the packed path")

    for side in SOLVE_SIDES:
        med, walls = wall_median(
            lambda: solve_once(solvers[(side, 1)], rhs[side]), 5)
        print(f"solve wall {side}^2: median of 5 {med:.6f} s (all {walls})")

    # the card's solve against the port's own CPU solve, 1023^2
    u_gpu, _, it_gpu = results[(1023, 1)]
    b_cpu = poisson.rhs(1023, device="cpu").reshape(1023, 1023)
    u_cpu, _, it_cpu = solve_once(StructuredSolver(1023, device="cpu"),
                                  b_cpu)
    du = float((u_gpu.cpu() - u_cpu).abs().max())
    bnd = solution_bound(f64_rss(u_gpu.cpu(), b_cpu, 1023),
                         f64_rss(u_cpu, b_cpu, 1023), 1023)
    print(f"gpu vs cpu 1023^2: refines {it_gpu} / {it_cpu}, max|du| "
          f"{du:.3e} (bound {bnd:.3e})")
    require(it_gpu == it_cpu, "same refine count on GPU and CPU")
    require(du <= bnd, "GPU and CPU solutions within the residual bound")


# (label, side, StructuredSolver options, tolerance, n_refine, the TPU's
# recorded V-cycle count where it has one: BENCH_r05.json var rows)
VAR_ROWS = (
    ("var auto df32", 2047, {}, 1e-7, 40, 21),
    ("var auto df32", 4095, {}, 1e-5, 40, 42),
    ("var fused df32", 4095, {"smoother": "fused"}, 1e-5, 40, None),
    ("var f64", 4095, {"precision": "f64"}, 1e-7, 40, None),
)


def var_solves(dev, launches: dict):
    """Phase 5: the jump-coefficient solve through solve_ir_device, each
    row checked by an independent f64 rss; the constant fused solve (K5);
    the card against the CPU at 255^2."""
    for label, side, kw, tol, n_refine, tpu_cycles in VAR_ROWS:
        t0 = time.perf_counter()
        planes = varcoef.jump_planes(side, a_in=100.0, device=dev)
        s = StructuredSolver(side, A_planes=planes, device=dev, **kw)
        b2 = poisson.rhs(side, device=dev).reshape(side, side)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        (u, err, it), c = drive(lambda: solve_device(s, b2, tol, n_refine),
                                launches)
        ind = f64_rss_planes(u, b2, planes)
        cycles = it * s.cycles_per_refine
        tpu = f" (TPU v5e record: {tpu_cycles})" if tpu_cycles else ""
        print(f"solve {label} {side}^2 tol {tol:g}: plan {s.plan}, setup "
              f"{setup:.2f} s, refines {it}, V-cycles {cycles}{tpu}, rss "
              f"{err:.6e}, independent f64 rss {ind:.6e}, launches {c}")
        require(bool(torch.isfinite(u).all()) and u.shape == (side, side),
                f"{label} {side}^2: finite u of shape ({side}, {side})")
        if kw.get("precision") == "f64":
            # open question (b): does native f64 get past the TPU's 1e-6
            # stall at 4095^2? Required: 1e-5; reported: 1e-7 reached or not
            print(f"var f64 {side}^2 reached {tol:g}: {err <= tol} "
                  f"(final rss {err:.6e})")
            require(err <= 1e-5 and ind <= 1e-5, "var f64 rss <= 1e-5")
        else:
            require(err <= tol and ind <= tol,
                    f"{label} {side}^2 converged to {tol:g}")
        fused = kw.get("smoother") == "fused"
        require(c["fused_gs4_sweep_var"] == (2 * (1 + 3 * it) if fused
                                             else 0),
                f"{label}: K6 = 2 (1 + 3 it) on the fused path, else 0")
        require(sum(n for k, n in c.items()
                    if k != "fused_gs4_sweep_var") == 0,
                f"{label}: no other kernel on a variable operator")
        med, walls = wall_median(lambda: solve_device(s, b2, tol, n_refine),
                                 3)
        print(f"solve wall {label} {side}^2: median of 3 {med:.6f} s "
              f"(all {walls})")
        del s, planes

    side = 4095
    s = StructuredSolver(side, smoother="fused", device=dev)
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    (u, err, it), c = drive(lambda: solve_device(s, b2, TOL), launches)
    ind = f64_rss(u, b2, side)
    print(f"solve const fused df32 {side}^2: plan {s.plan}, refines {it}, "
          f"rss {err:.6e}, independent f64 rss {ind:.6e}, launches {c}")
    require(err <= TOL and ind <= TOL, f"const fused {side}^2 converged")
    require(c["fused_gs4_sweep_const"] == 2 * (1 + 3 * it),
            "K5 = 2 (1 + 3 it) on the const fused path")
    require(sum(n for k, n in c.items() if k != "fused_gs4_sweep_const")
            == 0, "const fused: no other kernel")
    del s

    side = 255
    planes = varcoef.jump_planes(side, a_in=100.0, device="cpu")
    b_cpu = poisson.rhs(side, device="cpu").reshape(side, side)
    u_gpu, _, it_gpu = solve_device(
        StructuredSolver(side, A_planes=planes.to(dev), device=dev),
        b_cpu.to(dev), TOL)
    u_cpu, _, it_cpu = solve_device(
        StructuredSolver(side, A_planes=planes, device="cpu"), b_cpu, TOL)
    du = float((u_gpu.cpu() - u_cpu).abs().max())
    bnd = solution_bound(f64_rss_planes(u_gpu.cpu(), b_cpu, planes),
                         f64_rss_planes(u_cpu, b_cpu, planes), side)
    print(f"gpu vs cpu var {side}^2: refines {it_gpu} / {it_cpu}, max|du| "
          f"{du:.3e} (bound {bnd:.3e})")
    require(it_gpu == it_cpu, "same var refine count on GPU and CPU")
    require(du <= bnd, "var GPU and CPU solutions within the residual bound")


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU "
                           "only")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}")

    # phase 1: build the kernels from the sources in the checkout
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s")
    print(_build.build_log())

    # phases 2-3: parity and timing, kernel against plain
    errs, times, bounds = parity_and_timing(dev)
    e56, t56, b56 = rbgs_parity_and_timing(dev)
    errs.update(e56)
    times.update(t56)
    bounds.update(b56)

    # phases 4-5: every path through the user entry points, each with the
    # launch counts set to 0 just before it and read just after
    launches = {k: 0 for k in KERNEL_INFO}
    const_solves(dev, launches)
    var_solves(dev, launches)
    require(all(n > 0 for n in launches.values()),
            f"every kernel launched on its path: {launches}")

    kernels = []
    for name, (src, replaces) in KERNEL_INFO.items():
        kms, pms = times[name]
        bms, by = bounds[name]
        # no single PyTorch call computes a GS sweep, a V-cycle leg or a
        # df32 residual: there is no library time to set beside these
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": kms,
                        "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                        "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
