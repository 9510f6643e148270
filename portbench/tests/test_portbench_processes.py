"""The four-process path on the CPU: ``run.py``'s launcher starts four
ranks of ``worker.py`` (gloo, a slab each), they solve collectively, and
rank 0's result comes back whole and correct; a rank that fails ends the
run. The four-process cell is not in ``BENCHMARK.json`` (its
configuration and mix are kept as files): a copy of the benchmark lists
it, as a later benchmark would, and the copy's harness runs it
unedited."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent


def spawn(tmp_path, bench, cell, side, trace=0):
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys, types\nsys.path.insert(0, '.')\n"
            "from portbench import run\n"
            f"args = types.SimpleNamespace(workload={cell!r}, "
            f"seed=2**31 + 5, seconds=1.0, trace={trace})\n"
            f"print(json.dumps(run.spawn(args, 4, {{'side': {side}}})))")
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=600)


@pytest.mark.parametrize("trace", [0, 1])
def test_four_ranks_on_the_cpu(tmp_path, dist_bench, trace):
    cell, bench = dist_bench
    got = spawn(tmp_path, bench, cell, 63, trace)
    assert got.returncode == 0, got.stderr[-3000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4
    assert out["attempted"] >= 1 and out["failed"] == 0
    want = ({"solve_s", "setup_s"} if trace == 0
            else {"solver.vcycles_per_solve"})
    assert set(out["metrics"]) == want


def test_a_failing_rank_fails_the_run(tmp_path, dist_bench):
    cell, bench = dist_bench
    got = spawn(tmp_path, bench, cell, 62)  # not 2^k - 1: every rank raises
    assert got.returncode != 0
    assert "exit codes" in got.stderr
