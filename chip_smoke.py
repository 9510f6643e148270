"""Smoke run of the amg_tpu_torch port on one CUDA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from amg_tpu_torch/csrc, checks each against
its plain PyTorch version on the card and times both, then drives the
constant-coefficient Poisson solve through the user entry points
(StructuredSolver -> prepare_b -> solve_ir_device_prepared -> finalize_u)
at 1023^2 and 4095^2 and checks the result with an independent f64
residual. Any failed check raises, so the exit code is non-zero. The last
line of stdout is one JSON object with "ok" and the device.

Needs a CUDA device and nvcc; imports neither JAX nor the JAX package.
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

from amg_tpu_torch import StructuredSolver, poisson
from amg_tpu_torch.ops import kernels as K
from amg_tpu_torch.ops.doublefloat import DF32
from amg_tpu_torch.ops.kernels import _build
from amg_tpu_torch.ops.kernels.packed_cycle import (down_leg_plain,
                                                    up_leg_plain)
from amg_tpu_torch.ops.kernels.packed_df import df_residual_rss_plain
from amg_tpu_torch.ops.rap import poisson_const_w33
from amg_tpu_torch.sparse.packed import gs4_sweep_packed, pack

TOL = 1e-7
PARITY_SIDES = (1023, 4095)            # M = 512 and 2048
SOLVE_SIDES = (1023, 4095)

# Kernel-vs-plain bounds, max|kernel - plain| / max|plain|. They are the
# JAX package's own interpret-mode bounds for these kernels
# (tests/test_packed_cycle.py, tests/test_packed_df.py): room for f32
# reassociation. The kernels keep the plain versions' operation order and
# are built with -fmad=false, so 0 is expected.
BOUND = {"sweep_u": 2e-6, "down_u": 2e-6, "down_bc": 1e-5, "up_u": 1e-5,
         "df_rhi": 1e-6, "df_rss": 1e-5}

KERNEL_INFO = {
    "fused_gs4_sweep_packed": ("amg_tpu_torch/csrc/packed_sweep.cu",
                               "amg_tpu/ops/pallas/packed_rbgs.py:674"),
    "fused_down_leg_packed": ("amg_tpu_torch/csrc/packed_cycle.cu",
                              "amg_tpu/ops/pallas/packed_cycle.py:186"),
    "fused_up_leg_packed": ("amg_tpu_torch/csrc/packed_cycle.cu",
                            "amg_tpu/ops/pallas/packed_cycle.py:465"),
    "fused_df_residual_rss": ("amg_tpu_torch/csrc/packed_df.cu",
                              "amg_tpu/ops/pallas/packed_df.py:258"),
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


def parity_and_timing(dev):
    """Phases 2 and 3: each kernel against its plain version, and both
    timed, at the main path's M = 512 and 2048. Returns per-kernel
    max_abs_err and {(kernel, M): (kernel ms, plain ms)}."""
    errs = {k: 0.0 for k in KERNEL_INFO}
    times = {}
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
        for name, (kern, plain) in pairs.items():
            # plain, kernel, kernel, plain: compare within one call
            p1 = time_ms(plain, reps // 5)
            k1 = time_ms(kern, reps)
            k2 = time_ms(kern, reps)
            p2 = time_ms(plain, reps // 5)
            kms, pms = min(k1, k2), min(p1, p2)
            print(f"time {name} M={M}: kernel {kms:.4f} ms, plain "
                  f"{pms:.4f} ms (x{pms / kms:.1f})")
            times[name, M] = (kms, pms)
    return errs, times


def f64_rss(u: torch.Tensor, b: torch.Tensor, side: int) -> float:
    """Independent rss of b - A u: plain f64 5-point Laplacian (-4/h^2
    diagonal, +1/h^2 neighbours, zero Dirichlet boundary)."""
    h = poisson.grid_spacing_h(side)
    up = F.pad(u, (1, 1, 1, 1))
    Au = (up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
          - 4.0 * u) / (h * h)
    return float(torch.sum((b - Au) ** 2))


def solution_bound(rss1: float, rss2: float, side: int) -> float:
    """Bound on max|u1 - u2| for two iterates of the same system:
    |u1 - u2|_max <= |A^-1|_2 (|r1|_2 + |r2|_2), |A^-1|_2 = 1/lambda_min
    with lambda_min = 8 sin^2(pi h / 4) / h^2 (about pi^2 / 2)."""
    h = poisson.grid_spacing_h(side)
    lam_min = 8.0 * np.sin(np.pi * h / 4.0) ** 2 / (h * h)
    return (rss1 ** 0.5 + rss2 ** 0.5) / lam_min


def solve_once(s: StructuredSolver, b2: torch.Tensor):
    u4, stats = s.solve_ir_device_prepared(s.prepare_b(b2), tolerance=TOL)
    u = s.finalize_u(u4)
    err, it = stats.tolist()
    return u, err, int(it)


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
    errs, times = parity_and_timing(dev)

    # phase 4: the solve through the user entry points
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

    K.reset_launch_counts()
    results = {}
    per_solve = {}
    for side, sweeps in configs:
        before = K.launch_counts()
        u, err, it = solve_once(solvers[(side, sweeps)], rhs[side])
        torch.cuda.synchronize()
        after = K.launch_counts()
        per_solve[(side, sweeps)] = {k: after[k] - before[k] for k in after}
        results[(side, sweeps)] = (u, err, it)
    launches = K.launch_counts()

    for (side, sweeps), (u, err, it) in results.items():
        c = per_solve[(side, sweeps)]
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
    require(all(n > 0 for n in launches.values()),
            f"every kernel launched on the main path: {launches}")

    for side in SOLVE_SIDES:
        s = solvers[(side, 1)]
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve_once(s, rhs[side])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"solve wall {side}^2: median of 5 "
              f"{statistics.median(walls):.6f} s (all {walls})")

    # phase 5: the card's solve against the port's own CPU solve, 1023^2
    u_gpu, _, it_gpu = results[(1023, 1)]
    b_cpu = poisson.rhs(1023).reshape(1023, 1023)
    u_cpu, _, it_cpu = solve_once(StructuredSolver(1023), b_cpu)
    du = float((u_gpu.cpu() - u_cpu).abs().max())
    bound = solution_bound(f64_rss(u_gpu.cpu(), b_cpu, 1023),
                           f64_rss(u_cpu, b_cpu, 1023), 1023)
    print(f"gpu vs cpu 1023^2: refines {it_gpu} / {it_cpu}, max|du| "
          f"{du:.3e} (bound {bound:.3e})")
    require(it_gpu == it_cpu, "same refine count on GPU and CPU")
    require(du <= bound, "GPU and CPU solutions within the residual bound")

    kernels = []
    for name, (src, replaces) in KERNEL_INFO.items():
        kms, pms = times[name, 2048]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": kms,
                        "plain_ms": pms})
    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
