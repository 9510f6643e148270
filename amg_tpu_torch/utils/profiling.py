"""Where a solve's time goes on the GPU: wall time, device busy time by
kernel, launch count and idle share, from ``torch.profiler``.

    python -m amg_tpu_torch.utils.profiling --sides 1023 4095
    python -m amg_tpu_torch.utils.profiling --sides 4095 --var --tol 1e-5 \
        [--smoother fused] [--precision f64]
    python -m amg_tpu_torch.utils.profiling --sides 4095 --dist 4 \
        [--halo rdma|sweep|overlap|step]

For each side: one warm solve is timed, then a second one is traced. The
constant problem's packed loop runs prepare_b -> solve_ir_device_prepared
-> finalize_u; ``--var`` (the jump-coefficient problem, a = 100) and the
other loops run solve_ir_device; ``--dist D`` the distributed solve on D
row slabs of the card (DistStructuredSolver.solve_ir_fused). Device busy
time is the
sum of the GPU kernels' and copies' own times in the trace (one stream, so
they do not overlap); the idle share is 1 - busy / (untraced wall). Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_solve(side: int, device="cuda", top: int = 12,
                  var: bool = False, smoother: str = "auto",
                  precision: str = "df32", tol: float = 1e-7,
                  dist: int = 0, halo: str = "rdma") -> dict:
    """Trace one warm solve at ``side``; returns the summary it prints."""
    from amg_tpu_torch import (DistStructuredSolver, StructuredSolver,
                               poisson, varcoef)
    from amg_tpu_torch.ops import kernels as K

    b2 = poisson.rhs(side, device=device).reshape(side, side)
    if dist:
        d = DistStructuredSolver(side, n_devices=dist, halo=halo,
                                 device=device)

        def solve():
            r = d.solve_ir_fused(b2, tolerance=tol)
            return r.error, r.iterations // d.cycles_per_refine
    else:
        planes = varcoef.jump_planes(side, device=device) if var else None
        s = StructuredSolver(side, A_planes=planes, smoother=smoother,
                             precision=precision, device=device)
        s.warmup()

        def solve():
            if not s.packed_loop:
                return s.solve_ir_device(b2, tolerance=tol)[1].tolist()
            u4, stats = s.solve_ir_device_prepared(s.prepare_b(b2),
                                                   tolerance=tol)
            s.finalize_u(u4)
            return stats.tolist()

    solve()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    K.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        err, it = solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    gpu = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in gpu)
    gpu.sort(key=_device_us, reverse=True)
    host = sorted((e for e in prof.key_averages()
                   if e.key.startswith("aten::")),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    summary = {
        "side": side, "var": var, "smoother": smoother,
        "precision": precision, "tol": tol, "dist": dist, "halo": halo,
        "wall_s": wall_plain, "wall_traced_s": wall,
        "refines": int(it), "rss": err, "device_busy_s": busy_us * 1e-6,
        "idle_share": 1.0 - busy_us * 1e-6 / wall_plain,
        "gpu_launches": sum(e.count for e in gpu),
        "our_kernel_launches": K.launch_counts(),
        "top_kernels": [(e.key[:90], e.count, _device_us(e) * 1e-3)
                        for e in gpu[:top]],
        "top_host_ops": [(e.key, e.count, e.self_cpu_time_total * 1e-3)
                         for e in host[:top]],
    }
    what = (f"dist D={dist} halo={halo}" if dist else
            f"var={var} smoother={smoother} precision={precision}")
    print(f"side {side} {what} tol={tol:g}: wall {wall_plain:.6f} s (traced {wall:.6f} s), "
          f"refines {int(it)}, rss "
          f"{err:.3e}, device busy {summary['device_busy_s']:.6f} s, "
          f"idle share {summary['idle_share']:.4f}, GPU launches "
          f"{summary['gpu_launches']}, kernel wrappers "
          f"{summary['our_kernel_launches']}")
    for name, count, ms in summary["top_kernels"]:
        print(f"  device {ms:10.4f} ms  {count:6d}x  {name}")
    for name, count, ms in summary["top_host_ops"]:
        print(f"  host   {ms:10.4f} ms  {count:6d}x  {name}")
    return summary


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sides", type=int, nargs="+", default=[1023, 4095])
    ap.add_argument("--var", action="store_true",
                    help="the jump-coefficient problem (a = 100)")
    ap.add_argument("--smoother", default="auto",
                    choices=["auto", "packed", "fused"])
    ap.add_argument("--precision", default="df32", choices=["df32", "f64"])
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--dist", type=int, default=0, metavar="D",
                    help="the distributed solve on D row slabs")
    ap.add_argument("--halo", default="rdma",
                    choices=["rdma", "sweep", "overlap", "step"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    for side in args.sides:
        profile_solve(side, var=args.var, smoother=args.smoother,
                      precision=args.precision, tol=args.tol,
                      dist=args.dist, halo=args.halo)


if __name__ == "__main__":
    main()
