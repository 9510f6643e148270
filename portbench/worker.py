"""One rank of a cell on several processes, started by ``run.py``: joins
the process group (``amg_tpu_torch.parallel.launch.initialize_distributed``
on ``localhost:<port>``, its card ``cuda:<rank>``, or the CPU where there
is no card), runs the cell, and on rank 0 writes the result to
``<out>/result.json``. Exits non-zero if JAX or ``amg_tpu`` got loaded.

    python portbench/worker.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> --rank <r> --world <N> --port <p> --t-start <epoch> \
        --out <dir> [--solver-json '{"side": 63}']
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    for name, kind in (("workload", str), ("seed", int), ("seconds", float),
                       ("trace", int), ("rank", int), ("world", int),
                       ("port", int), ("t-start", float), ("out", str)):
        ap.add_argument(f"--{name}", type=kind, required=True)
    # keys of the configuration's solver replaced (the CPU tests' sides)
    ap.add_argument("--solver-json", default="{}")
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist
    from amg_tpu_torch.parallel import launch
    from portbench import harness

    launch.initialize_distributed(f"localhost:{args.port}", args.world,
                                  args.rank)
    device = (torch.device("cuda", torch.cuda.current_device())
              if torch.cuda.is_available() else torch.device("cpu"))
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), device, args.t_start,
                               rank=args.rank, world=args.world,
                               overrides=json.loads(args.solver_json))
    finally:
        dist.destroy_process_group()
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules that must not load were loaded: {found}",
              file=sys.stderr)
        return 3
    if out is not None:
        (Path(args.out) / "result.json").write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
