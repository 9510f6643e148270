"""The readings that the comparison's limit is set from, for one cell:
the reference's rss of the program's solve of every right-hand side in
the pools of the given seeds (each seed's pool is the mix's whole set,
in its order and with its signs; the lower reading: the largest), and of
the program's own f32 path in its place on the first ``--control-count``
of the pools of a few seeds (the control, ``Driver.control``; the upper
reading: the smallest). Not part of a benchmark run.

    python3 portbench/control.py --workload <cell> --seeds 1 2 \
        --control-seeds 7 8 9 [--control-count 8] [--cycles 20]

Runs at the cell's own size, on its cards (a cell on N cards starts N
ranks of this script, as ``run.py`` does). Prints one JSON line: per
seed the program's stated rss, refines and reference rss, the control's
reference rss, and the two readings.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(name: str, seeds, control_seeds, cycles: int, device,
             rank: int = 0, world: int = 1, overrides=None,
             control_count: int = 8) -> dict | None:
    import torch
    from portbench import harness, traffic

    plan = harness.cell_plan(name)
    config, mix = plan.config, plan.mix
    solver = dict(config["solver"], **(overrides or {}))
    side = int(solver["side"])
    drv_mod = harness.load_module(
        harness.HERE / "drivers" / f"{config['driver']}.py",
        f"portbench_driver_{config['driver']}")
    op = harness.operator(config)
    inputs = op.inputs(dict(config, solver=solver), device)
    drv = drv_mod.Driver(solver, inputs, device)
    drv.warmup()
    apply = op.reference_apply(dict(config, solver=solver), inputs)
    rows = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        pool = traffic.make_pool(mix, seed, side, device)
        row = {"seed": seed}
        if seed in seeds:
            stated, refines, ref = [], [], []
            for b in pool:
                u, rss, k = drv.read(drv.submit(b))
                stated.append(rss)
                refines.append(k)
                ref.append(harness.operators.rss(b, apply(u)))
            row.update(stated=stated, refines=refines, reference=ref)
        if seed in control_seeds:
            row["control"] = [harness.operators.rss(b, apply(
                drv.control(b, cycles))) for b in pool[:control_count]]
        rows.append(row)
        del pool
    drv.close()
    if rank != 0:
        return None
    lower = max(x for r in rows for x in r.get("reference", []))
    upper = min(x for r in rows for x in r.get("control", [float("inf")]))
    return {"workload": name, "side": side,
            "tolerance": float(solver["tolerance"]),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "lower": lower, "upper": upper, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-count", type=int, default=8)
    ap.add_argument("--cycles", type=int, default=20)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    from portbench import harness

    chips = int(harness.cell_plan(args.workload).cell["chips"])
    if args.rank is None and chips > 1:
        from portbench.run import free_port
        port = free_port()
        base = [sys.executable, __file__,
                *(sys.argv[1:] if argv is None else argv)]
        procs = [subprocess.Popen(base + ["--rank", str(r), "--world",
                                          str(chips), "--port", str(port)])
                 for r in range(chips)]
        codes = [p.wait() for p in procs]
        return max(codes)
    device = torch.device("cuda", 0)
    if args.rank is not None:
        from amg_tpu_torch.parallel import launch
        launch.initialize_distributed(f"localhost:{args.port}", args.world,
                                      args.rank)
        device = torch.device("cuda", torch.cuda.current_device())
    t0 = time.time()
    out = readings(args.workload, args.seeds, args.control_seeds,
                   args.cycles, device, args.rank or 0, args.world,
                   control_count=args.control_count)
    if out is not None:
        out["seconds"] = time.time() - t0
        print(json.dumps(out), flush=True)
    if args.rank is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
