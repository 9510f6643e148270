"""One run of one cell: set-up, the measured window, the per-layer
readings, and the comparison with the plain reference that decides
``correct``.

Everything particular to a cell is data, found by name: the cell in
``BENCHMARK.json``; its configuration ``configs/<config>.json`` (the
operator, the solver's driver ``drivers/<driver>.py`` and its options,
the tolerance the comparison holds it to); its traffic mix
``traffic/<mix>.json`` (``traffic.py``); its operator
``operators/<kind>.py``; each per-layer metric a reader
``metrics/<metric>.py``. A run on several processes (``worker.py``)
runs this same code on every rank; rank 0 reports.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import random
import statistics
import sys
import time
from collections import deque
from pathlib import Path
from types import SimpleNamespace

import torch
import torch.distributed as dist

from portbench import traffic
from portbench.reference import operators

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"
# solves whose fields the reference checks, drawn from the seed
SAMPLE = 8
# top-level module names that may not be loaded once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "amg_tpu")
# the mix run once more under the profiler after the window (--trace 1)
TRACE_SECONDS = 0.5


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    return json.loads(MANIFEST.read_text())


def cell_plan(name: str, bench: dict | None = None) -> SimpleNamespace:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    mix, end-to-end metric names and per-layer metric entries."""
    bench = manifest() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {MANIFEST.name}")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    mix = traffic.load(HERE / "traffic" / f"{cell['traffic']}.json")

    def here(m):
        return "workloads" not in m or name in m["workloads"]
    e2e = [m["name"] for m in bench["end_to_end"] if here(m)]
    layer = [m for m in bench["per_layer"] if here(m) and m["moves"] in e2e]
    return SimpleNamespace(cell=cell, config=config, mix=mix, e2e=e2e,
                           layer=layer)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Comm:
    """The ranks' control channel (a gloo group beside the program's own
    group); one process: no-ops."""

    def __init__(self, world: int):
        self.world = world
        self.group = dist.new_group(backend="gloo") if world > 1 else None

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank."""
        if self.group is None:
            return flag
        t = torch.tensor([int(flag)])
        dist.broadcast(t, 0, group=self.group)
        return bool(t.item())

    def gather(self, obj) -> list:
        if self.group is None:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


class Reservoir:
    """A uniform sample of SAMPLE solves' fields, drawn from the seed,
    copied into buffers made in set-up (no allocation in the window)."""

    def __init__(self, seed: int, like: torch.Tensor, k: int = SAMPLE):
        self.rng = random.Random(seed)
        self.bufs = [torch.empty_like(like) for _ in range(k)]
        self.meta = [None] * k
        self.seen = 0

    def offer(self, u: torch.Tensor, meta) -> None:
        k = len(self.bufs)
        slot = (self.seen if self.seen < k
                else self.rng.randrange(self.seen + 1))
        self.seen += 1
        if slot < k:
            self.bufs[slot].copy_(u)
            self.meta[slot] = meta

    def items(self) -> list:
        return [(u, m) for u, m in zip(self.bufs, self.meta) if m is not None]


def operator(config: dict):
    """The configuration's operator, ``operators/<kind>.py``: what the
    benchmark hands to both sides besides the rhs (``inputs``) and the
    reference's f64 A u (``reference_apply``)."""
    kind = config["operator"]["kind"]
    return load_module(HERE / "operators" / f"{kind}.py",
                       f"portbench_operator_{kind}")


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# the host's ranges in a traced stretch: what the host was doing
SUBMIT = "host: in the entry point (launch)"
READ = "host: waiting for the stats"


def _plain(name):
    return contextlib.nullcontext()


def run_window(drv, limit: int, pool: list, mix: dict, seconds: float,
               comm: Comm, sample: Reservoir | None, rank: int,
               label=_plain):
    """The closed loop of the mix for ``seconds``: returns the per-solve
    records and the window's (start, end) on the host clock. Issues stop
    at the deadline (rank 0's clock, agreed after every read); the solves
    in flight then finish and count. ``label(name)``: a context around
    each call and each read (the profiler's ranges when traced)."""
    k = int(mix["in_flight"])
    if k > limit:
        raise ValueError(f"the driver keeps at most {limit} solves in "
                         f"flight, the mix asks for {k}")
    pending, records = deque(), []
    i, go = 0, True
    comm.barrier()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        while go and len(pending) < k:
            t_call = time.perf_counter()
            with label(SUBMIT):
                p = drv.submit(pool[i % len(pool)])
            pending.append((i, t_call, time.perf_counter(), p))
            i += 1
        if not pending:
            break
        j, t_call, t_ret, p = pending.popleft()
        with label(READ):
            u, rss, refines = drv.read(p)
        t_read = time.perf_counter()
        records.append(SimpleNamespace(t_call=t_call, t_ret=t_ret,
                                       t_read=t_read, rss=rss,
                                       refines=refines))
        if sample is not None and rank == 0:
            sample.offer(u, j % len(pool))
        del u, p
        go = comm.agree(go and time.perf_counter() < deadline)
    t1 = time.perf_counter()
    return records, (t0, t1)


def _union(spans: list) -> list:
    """Sorted disjoint (start, end) covering ``spans``."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_busy(events, DeviceType) -> dict:
    """Busy time of the card in a profiler trace (kineto events), where
    CUPTI records the kernels of a CUDA graph's straight parts but none
    of its conditional (WHILE) body: each graph launch (a
    ``cudaGraphLaunch``, or any one call whose correlation id several
    device operations carry) counts from its first recorded device
    operation's start to its last one's end (the body runs between them,
    on the same stream), every other device operation by its own span.
    The window runs from the first traced host range's start to the last
    one's end. Returns the window, the busy union in it, the device
    operations by name and the idle gaps labelled with the host range
    they fall in (times in ns); None without a host range."""
    host, launches, groups, ops = [], set(), {}, {}
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.name() in (SUBMIT, READ):
            # the host's ranges (and their copies on the card's timeline,
            # which are no operations)
            if e.device_type() != DeviceType.CUDA:
                host.append((start, end, e.name()))
        elif e.device_type() == DeviceType.CUDA:
            groups.setdefault(e.correlation_id(), []).append((start, end))
            ops[e.name()] = ops.get(e.name(), 0) + e.duration_ns()
        elif "GraphLaunch" in e.name():
            launches.add(e.correlation_id())
    if not host:
        return None
    w0, w1 = min(h[0] for h in host), max(h[1] for h in host)
    spans, in_graphs = [], 0
    for corr, group in groups.items():
        # one call that put several operations on the card: a graph
        if corr and (corr in launches or len(group) > 1):
            in_graphs += len(group)
            spans.append((min(s for s, _ in group), max(e for _, e in group)))
        else:
            spans.extend(group)
    def clipped(spans):
        return _union([(max(s, w0), min(e, w1)) for s, e in spans
                       if e > w0 and s < w1])
    busy = clipped(spans)
    recorded = clipped([x for g in groups.values() for x in g])
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            mid = (s + prev) / 2
            what = [h[2] for h in host if h[0] <= mid <= h[1]]
            gaps.append((s - prev, what[0] if what else
                         "host: between calls"))
        prev = max(prev, e)
    return {"window": w1 - w0, "busy": sum(e - s for s, e in busy),
            "recorded": sum(e - s for s, e in recorded),
            "ops": ops, "gaps": gaps, "launches": len(launches),
            "device_events": sum(len(g) for g in groups.values()),
            "in_graphs": in_graphs}


def trace_mix(drv, limit: int, pool: list, mix: dict, comm: Comm,
              rank: int, device) -> dict:
    """The mix once more, for TRACE_SECONDS, under torch.profiler (the
    host's ranges and the card's operations): busy and window seconds
    (``device_busy``), the busiest device operations and the longest idle
    gaps, by what the host was doing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_window(drv, limit, pool, mix, TRACE_SECONDS, comm, None, rank,
                   label=record_function)
        sync(device)
    got = device_busy(prof.profiler.kineto_results.events(), DeviceType)
    if got is None:
        raise RuntimeError("the profiler recorded none of the host's ranges")
    print(f"trace: {got['launches']} graph launches, "
          f"{got['device_events']} device operations recorded "
          f"({got['in_graphs']} in graph launches), busy "
          f"{got['busy'] * 1e-9:.6f} s of {got['window'] * 1e-9:.6f} s "
          f"({got['recorded'] * 1e-9:.6f} s in the recorded operations "
          f"alone)",
          file=sys.stderr, flush=True)
    ops = sorted(got["ops"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(got["gaps"], key=lambda g: -g[0])[:10]
    return {"busy_s": got["busy"] * 1e-9, "window_s": got["window"] * 1e-9,
            "device_ops": [[n, t * 1e-9] for n, t in ops],
            "idle_gaps": [[what, t * 1e-9] for t, what in gaps]}


def window_summary(records: list, window: float) -> str:
    """One line on the window's solves: their count, refines and host
    latencies (what a reader of the run's standard error looks at
    first)."""
    if not records:
        return f"window: no solve completed in {window:.3f} s"
    refines = {}
    for r in records:
        refines[r.refines] = refines.get(r.refines, 0) + 1
    lat = sorted(r.t_read - r.t_call for r in records)
    return (f"window: {len(records)} solves in {window:.3f} s, refines "
            f"{dict(sorted(refines.items()))}, latency min / median / max "
            f"{lat[0]:.5f} / {statistics.median(lat):.5f} / {lat[-1]:.5f} s")


def p95(values: list) -> float:
    """The 95th percentile by nearest rank."""
    v = sorted(values)
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, rank: int = 0, world: int = 1,
             overrides: dict | None = None, faults=None,
             bench: dict | None = None) -> dict | None:
    """One run of cell ``name`` on ``device`` (rank ``rank`` of ``world``
    processes, the group already joined). ``t_start``: the process's (or
    the launcher's) start, ``time.time()``. ``overrides`` replaces keys of
    the configuration's ``solver`` (the tests' small sides); ``faults``
    wraps the driver (the tests' broken timed paths); ``bench`` replaces
    ``BENCHMARK.json`` (the tests' cells that it does not list). Returns
    rank 0's result (the JSON line's fields and the comparison), None
    elsewhere."""
    phases = [("imports and process start", time.time() - t_start)]

    def phase(what):
        sync(device)
        phases.append((what, time.time() - t_start
                       - sum(t for _, t in phases)))
    plan = cell_plan(name, bench)
    config, mix = plan.config, plan.mix
    solver = dict(config["solver"], **(overrides or {}))
    side = int(solver["side"])
    comm = Comm(world)
    drv_mod = load_module(HERE / "drivers" / f"{config['driver']}.py",
                          f"portbench_driver_{config['driver']}")
    op = operator(config)
    inputs = op.inputs(dict(config, solver=solver), device)
    pool = traffic.make_pool(mix, seed, side, device)
    phase("inputs and rhs pool")
    drv = drv_mod.Driver(solver, inputs, device)
    if faults is not None:
        drv = faults(drv)
    phase("solver and hierarchy")
    drv.warmup()
    phase("graph capture and warm-up solve")
    # the mix's own pattern once: every shape and every cached block the
    # window takes
    run_window(drv, drv_mod.MAX_IN_FLIGHT, pool, mix, 0.0, comm, None, rank)
    sample = Reservoir(seed, pool[0]) if rank == 0 else None
    gc.collect()
    phase("the mix's warm-up solves")
    comm.barrier()
    setup_s = time.time() - t_start
    phase("waiting for the other ranks")
    if rank == 0:
        print("setup: " + ", ".join(f"{w} {t:.2f} s" for w, t in phases),
              file=sys.stderr, flush=True)
    records, (t0, t1) = run_window(drv, drv_mod.MAX_IN_FLIGHT, pool, mix,
                                   seconds, comm, sample, rank)
    sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    # the profiler's device trace: on the card only
    traced = (trace_mix(drv, drv_mod.MAX_IN_FLIGHT, pool, mix, comm, rank,
                        device)
              if trace and device.type == "cuda" else None)
    cycles = drv.cycles_per_refine
    drv.close()
    del drv
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    peaks = comm.gather(peak)
    busy = comm.gather(traced["busy_s"] if traced else None)
    window_s = comm.gather(traced["window_s"] if traced else None)
    comm.barrier()
    if rank != 0:
        return None

    tol = float(solver["tolerance"])
    ok = [r for r in records if r.rss <= tol]
    window = t1 - t0
    print(window_summary(records, window), file=sys.stderr, flush=True)
    # what a per-layer reader reads
    run = SimpleNamespace(
        solver=solver, seed=seed, device=device, records=records,
        trace=traced, cycles_per_refine=cycles, inputs=inputs)
    e2e = {"setup_s": (setup_s, "s")}
    if ok:
        e2e["solve_s"] = (window / len(ok), "s")
        e2e["solve_p95_s"] = (p95([r.t_read - r.t_call for r in records]),
                              "s")
    metrics = {}
    if not trace:
        for m in plan.e2e:
            if m in e2e:
                metrics[m] = {"value": e2e[m][0], "unit": e2e[m][1]}
    else:
        for m in plan.layer:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 "portbench_metric_" + m["name"]
                                 .replace(".", "_"))
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the comparison with the reference, once the program's state is gone:
    # the rss rule the configuration states, for every sampled solve
    apply = op.reference_apply(dict(config, solver=solver), inputs)
    rss_ref = [operators.rss(pool[k], apply(u)) for u, k in sample.items()]
    worst = max(rss_ref) if rss_ref else None
    if worst is not None and not math.isfinite(worst):
        worst = None                    # a field that is not finite
    checks = {"rss_max": {"value": worst, "limit": tol}}
    correct = bool(ok) and worst is not None and worst <= tol
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": world, "memory_peak_bytes": max(peaks)}
    if traced is not None:
        dev["busy_s"] = statistics.fmean(busy)
        dev["window_s"] = statistics.fmean(window_s)
    out = {"correct": correct, "attempted": len(records),
           "failed": len(records) - len(ok), "metrics": metrics,
           "device": dev}
    if traced is not None:
        out["breakdown"] = {"device_ops": traced["device_ops"],
                            "idle_gaps": traced["idle_gaps"]}
    out["checks"] = checks
    return out
