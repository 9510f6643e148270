"""Run one cell of ``BENCHMARK.json`` and print its result as the last line
of standard output:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (and the device's busy seconds in a traced stretch
of the mix after the window).
A cell on one card runs in this process on card 0; a cell on N cards
starts N worker processes (``worker.py``), a card and a rank each,
joined by ``torch.distributed`` on a free local port, and prints rank 0's
result. The numbers compared with the reference are the last lines of
standard error and the last key of the result. Exits non-zero, and
prints no result, without the cards the cell asks for, when a run is
not whole, or when JAX or ``amg_tpu`` got loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# the caches any library of the program might keep, inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, str(ROOT / "build" / "portbench" / sub))

# a worker that does not finish by then fails the run
WORKER_TIMEOUT_S = 330.0


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2) -> None:
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(code)


def report(out: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result line."""
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def _die_with_parent() -> None:
    import ctypes
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)      # PR_SET_PDEATHSIG


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn(args, chips: int, overrides: dict | None = None) -> dict:
    """Rank 0's result of ``chips`` worker processes, a card each. A worker
    that fails ends the others; one that does not finish in
    WORKER_TIMEOUT_S (counted from this process's start) fails the run."""
    out_dir = tempfile.mkdtemp(prefix="portbench-")
    port = free_port()
    procs, logs = [], []
    try:
        for rank in range(chips):
            log = open(Path(out_dir) / f"rank{rank}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).with_name("worker.py")),
                 "--workload", args.workload, "--seed", str(args.seed),
                 "--seconds", str(args.seconds), "--trace", str(args.trace),
                 "--rank", str(rank), "--world", str(chips),
                 "--port", str(port), "--t-start", repr(T_START),
                 "--out", out_dir,
                 "--solver-json", json.dumps(overrides or {})],
                stdout=log, stderr=subprocess.STDOUT,
                preexec_fn=_die_with_parent))
        deadline = T_START + WORKER_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad or time.time() > deadline:
                break
            time.sleep(0.2)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
        text = [(Path(out_dir) / f"rank{r}.log").read_text()
                for r in range(chips)]
        codes = [p.returncode for p in procs]
        if any(codes):
            for r, t in enumerate(text):
                print(f"--- rank {r} (exit {codes[r]})\n{t[-4000:]}",
                      file=sys.stderr)
            fail(f"a worker failed or timed out: exit codes {codes}")
        print(text[0][-6000:], file=sys.stderr, end="")
        return json.loads((Path(out_dir) / "result.json").read_text())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(out_dir, ignore_errors=True)


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from portbench import harness

    plan = harness.cell_plan(args.workload)
    chips = int(plan.cell["chips"])
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        fail(f"{args.workload} needs {chips} cards, "
             f"{torch.cuda.device_count()} visible")
    if chips == 1:
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), torch.device("cuda", 0),
                               T_START)
    else:
        # built once here (nvcc), loaded by every worker
        from amg_tpu_torch.ops.kernels._build import library
        library()
        out = spawn(args, chips)
    found = harness.forbidden_modules()
    if found:
        fail(f"modules that must not load were loaded: {found}", 3)
    report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
