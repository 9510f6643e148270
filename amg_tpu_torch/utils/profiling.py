"""Profiling: where a solve's time goes on the GPU, and the helpers of
``amg_tpu/utils/profiling.py`` (``Roofline``, ``KernelStats``,
``time_fn``, ``trace``) with the H100's peaks in place of the TPU's.

``profile_solve`` and the command line report wall time, device busy time
by kernel, launch count and idle share, from ``torch.profiler``:

    python -m amg_tpu_torch.utils.profiling --sides 1023 4095
    python -m amg_tpu_torch.utils.profiling --sides 4095 --var --tol 1e-5 \
        [--smoother fused] [--precision f64]
    python -m amg_tpu_torch.utils.profiling --sides 4095 --dist 4 \
        [--halo rdma|sweep|overlap|step] [--graph]
    python -m amg_tpu_torch.utils.profiling --sides 2047 4095 --pcg \
        --tol 1e-5
    python -m amg_tpu_torch.utils.profiling --sides 4095 \
        [--smoother masked|strided|chebyshev] [--no-fmg] [--solve-ir]

For each side: one warm solve is timed, then a second one is traced. The
constant problem's packed loop runs prepare_b -> solve_ir_device_prepared
-> finalize_u; ``--var`` (the jump-coefficient problem, a = 100) and the
other loops run solve_ir_device; ``--dist D`` the distributed solve on D
row slabs of the card (DistStructuredSolver.solve_ir_fused, under its
host driver; with ``--graph`` under its graph driver, one CUDA graph a
solve: the capture seconds, the graph's span on the card and the
dispatch of one solve_ir_device are reported too, and the trace is the
host driver's); ``--pcg``
the f32 PCG (solve_pcg_device, fused=True, on the packed hierarchy),
whose "refines" are its iterations; ``--no-fmg`` starts the refine loop
from zero (fmg=False); ``--solve-ir`` runs StructuredSolver.solve_ir
(f64 residual, from zero, one refine graph a step), whose "refines" are
its steps, the stopping one included. Device busy time is the sum of the GPU
kernels' and copies' own times in the trace (one stream, so they do not
overlap); the idle share is 1 - busy / (untraced wall). The solve loops
that run as CUDA graphs (StructuredSolver's and solve_pcg_device's)
are timed as the graph, and traced as their host-driven oracle, which
launches the same kernels: CUPTI's records of a graph whose WHILE body
runs many passes faulted the card (an illegal address at 16 passes on an
H100 80GB HBM3, driver 13.0, torch 2.11). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from amg_tpu_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Peak rates for roofline context. Defaults: the NVIDIA H100 80GB
    HBM3 (SXM) data sheet, 3.35 TB/s of HBM and 67 TFLOP/s of f32 outside
    the tensor cores, at the full 700 W; override for another card."""

    hbm_gbps: float = 3350.0
    f32_tflops: float = 67.0

    def stencil_sweep_sol_s(self, n_points: int, n_planes: int = 9,
                            bytes_per: int = 4, passes: float = 12.0):
        """Speed-of-light seconds of one fused stencil sweep: ``passes``
        full-field memory transfers (9 coefficient planes + b + u read, u
        written)."""
        return passes * n_points * bytes_per / (self.hbm_gbps * 1e9)


@dataclasses.dataclass
class KernelStats:
    name: str
    seconds: float
    nnz: int
    sweeps: int = 1

    @property
    def nnz_per_s(self) -> float:
        return self.nnz * self.sweeps / self.seconds

    def summary(self, roofline: Roofline | None = None,
                n_points: int | None = None) -> str:
        s = (f"{self.name}: {self.seconds * 1e3:.3f} ms, "
             f"{self.nnz_per_s / 1e9:.2f} Gnnz/s")
        if roofline and n_points:
            sol = roofline.stencil_sweep_sol_s(n_points)
            s += f" ({100 * sol / (self.seconds / self.sweeps):.0f}% of SoL)"
        return s


def _sync(out) -> None:
    """Wait for the device work behind ``out`` (a tensor or a tuple/list
    of them) when it is on a CUDA device."""
    ts = out if isinstance(out, (tuple, list)) else (out,)
    for t in ts:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)


def time_fn(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Mean wall seconds of ``fn(*args)``, after ``warmup`` calls; the
    timed loop ends in ``torch.cuda.synchronize()`` when the result is on
    the card."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """A ``torch.profiler`` trace of the block (CPU, and the card when
    there is one); yields the profiler (JAX's yields ``log_dir``: the port
    has no XProf, and its callers read ``key_averages()``), and writes a
    Chrome trace, ``trace.json``, into the directory ``log_dir`` if
    given. While tracing is on (``utils/tracing``), the program's spans
    of the block go into ``trace.json`` as their own process, on the
    profiler's clock: calibration stamps taken under the profiler before
    and after the block are CUPTI's first and last ``trace_stamp``
    kernels, and each pairs with its own device time."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    stamps = []
    if tracing.enabled():
        tracing.reset()
    with profile(activities=acts) as prof:
        stamps += tracing.calibration_stamps()
        yield prof
        stamps += tracing.calibration_stamps()
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        if tracing.enabled():
            _add_spans(path, stamps)


def _add_spans(path: str, stamps: list) -> None:
    """Add the program's spans (``tracing.chrome_events``) to the Chrome
    trace at ``path``; their clock from the CUPTI records of the
    calibration ``stamps`` (half before the traced block, half after),
    else the host clock's, as it is."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    recs = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                  if e.get("cat") == "kernel"
                  and "trace_stamp" in e.get("name", ""))
    half = len(stamps) // 2
    kernels = recs[:half] + recs[len(recs) - half:] if half else []
    to_us = tracing.profiler_clock(kernels, stamps)
    events += tracing.chrome_events(to_us=to_us)
    with open(path, "w") as f:
        json.dump(doc, f)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_solve(side: int, device="cuda", top: int = 12,
                  var: bool = False, smoother: str = "auto",
                  precision: str = "df32", tol: float = 1e-7,
                  dist: int = 0, halo: str = "rdma",
                  pcg: bool = False, fmg: bool = True,
                  solve_ir: bool = False, graph: bool = False) -> dict:
    """Trace one warm solve at ``side``; returns the summary it prints."""
    from amg_tpu_torch import (DistStructuredSolver, StructuredSolver,
                               build_stencil_hierarchy_device, krylov,
                               poisson, solve_pcg_device, varcoef)
    from amg_tpu_torch.ops import kernels as K

    b2 = poisson.rhs(side, device=device).reshape(side, side)
    if pcg:
        hier = build_stencil_hierarchy_device(side, device=device,
                                              smoother="packed")
        b32 = b2.to(torch.float32)

        def solve(host=False):
            if host:
                return krylov._solve_pcg_device(hier, b32, tol, 50, True,
                                                None, host=True)[1].tolist()
            return solve_pcg_device(hier, b32, tolerance=tol, n_iters=50,
                                    fused=True)[1].tolist()
    elif dist:
        d = DistStructuredSolver(side, n_devices=dist, halo=halo,
                                 device=device,
                                 driver="graph" if graph else "host")
        extra = {}
        if graph:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d.warmup()
            torch.cuda.synchronize()
            extra["capture_s"] = time.perf_counter() - t0

        def solve(host=False):
            if host:
                d.set_driver("host")
            try:
                r = d.solve_ir_fused(b2, tolerance=tol)
            finally:
                d.set_driver("graph" if graph else "host")
            return r.error, r.iterations // d.cycles_per_refine
    else:
        planes = varcoef.jump_planes(side, device=device) if var else None
        s = StructuredSolver(side, A_planes=planes, smoother=smoother,
                             precision=precision, fmg=fmg, device=device)
        s.warmup(refine_step=solve_ir)

        def solve(host=False):
            if solve_ir:
                r = s._solve_ir(b2, tol, 40, host=host)
                return r.error, len(r.history)
            if not s.packed_loop:
                return s._solve_device(b2, tol, 40, 0.0,
                                       host=host)[1][:2].tolist()
            u4, stats = s._solve_prepared(s.prepare_b(b2), tol, 40, 0.0,
                                          host=host)
            s.finalize_u(u4)
            return stats[:2].tolist()

    solve()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    if dist and graph:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            start.record()
            t0 = time.perf_counter()
            d.solve_ir_device(b2, tol)
            extra["dispatch_ms"] = (time.perf_counter() - t0) * 1e3
            stop.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        extra["span_s"] = start.elapsed_time(stop) * 1e-3
    K.reset_launch_counts()
    graph = graph or not dist
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        err, it = solve(host=graph)
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
        "pcg": pcg, "fmg": fmg, "solve_ir": solve_ir,
        "traced_host_oracle": graph, "wall_s": wall_plain,
        "wall_traced_s": wall,
        "refines": int(it), "rss": err, "device_busy_s": busy_us * 1e-6,
        "idle_share": 1.0 - busy_us * 1e-6 / wall_plain,
        "gpu_launches": sum(e.count for e in gpu),
        "our_kernel_launches": K.launch_counts(),
        "top_kernels": [(e.key[:90], e.count, _device_us(e) * 1e-3)
                        for e in gpu[:top]],
        "top_host_ops": [(e.key, e.count, e.self_cpu_time_total * 1e-3)
                         for e in host[:top]],
    }
    if dist:
        summary.update(extra)
    what = ("pcg f32 fused" if pcg else
            f"dist D={dist} halo={halo}" if dist else
            f"var={var} smoother={smoother} precision={precision} "
            f"fmg={fmg}{' solve_ir' if solve_ir else ''}")
    traced = " of the host-driven oracle" if graph else ""
    print(f"side {side} {what} tol={tol:g}: wall {wall_plain:.6f} s "
          f"(traced{traced} {wall:.6f} s), "
          f"refines {int(it)}, rss "
          f"{err:.3e}, device busy {summary['device_busy_s']:.6f} s, "
          f"idle share {summary['idle_share']:.4f}, GPU launches "
          f"{summary['gpu_launches']}, kernel wrappers "
          f"{summary['our_kernel_launches']}")
    if dist and "capture_s" in summary:
        print(f"  graph: capture + instantiate {summary['capture_s']:.3f} "
              f"s, span on the card {summary['span_s']:.6f} s, dispatch "
              f"{summary['dispatch_ms']:.3f} ms")
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
                    choices=["auto", "packed", "fused", "masked",
                             "strided", "chebyshev"])
    ap.add_argument("--precision", default="df32", choices=["df32", "f64"])
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--dist", type=int, default=0, metavar="D",
                    help="the distributed solve on D row slabs")
    ap.add_argument("--halo", default="rdma",
                    choices=["rdma", "sweep", "overlap", "step"])
    ap.add_argument("--pcg", action="store_true",
                    help="the f32 AMG-preconditioned CG (fused=True)")
    ap.add_argument("--no-fmg", action="store_true",
                    help="start the refine loop from zero (fmg=False)")
    ap.add_argument("--solve-ir", action="store_true",
                    help="the host-stepped StructuredSolver.solve_ir")
    ap.add_argument("--graph", action="store_true",
                    help="with --dist: the solver's graph driver")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    for side in args.sides:
        profile_solve(side, var=args.var, smoother=args.smoother,
                      precision=args.precision, tol=args.tol,
                      dist=args.dist, halo=args.halo, pcg=args.pcg,
                      fmg=not args.no_fmg, solve_ir=args.solve_ir,
                      graph=args.graph)


if __name__ == "__main__":
    main()
