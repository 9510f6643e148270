"""``BENCHMARK.json`` against the contract's form, its names against the
files that hold each configuration, mix and reader, and the harness
driven by data: a cell, a mix and a reader added as files in a copy
appear as entries with no edit to the harness."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in METRICS]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_form(m):
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_setup_s_and_every_cell_reports_enough():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for w in BENCH["workloads"]:
        plan = harness.cell_plan(w["name"], BENCH)
        assert "setup_s" in plan.e2e and len(plan.e2e) >= 2
        assert plan.layer, w["name"]


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_where_listed(m):
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
        assert m["moves"] in harness.cell_plan(cell, BENCH).e2e, cell


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_reader_is_a_file_with_read(m):
    reader = harness.load_module(PB / "metrics" / f"{m['name']}.py", "r")
    assert callable(reader.read)


def test_files_exist_by_name():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (PB / "drivers" / f"{cfg['driver']}.py").is_file()
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    for w in BENCH["workloads"]:
        assert (PB / "traffic" / f"{w['traffic']}.json").is_file()
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(BENCH["workloads"])


def test_chips():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


def test_lines():
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    for c in BENCH["configs"]:
        assert 1 <= len(c["source"]) <= 200
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


def test_added_files_become_entries(tmp_path):
    """A copy of the benchmark gains a mix, a cell and a reader by files
    and entries alone: the copy's harness, unedited, plans the new cell
    with the new reader."""
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    mix = json.loads((PB / "traffic" / "step.json").read_text())
    mix.update(name="burst", in_flight=2)
    (tmp_path / "portbench" / "traffic" / "burst.json").write_text(
        json.dumps(mix))
    (tmp_path / "portbench" / "metrics" / "solver.refines_max.py").write_text(
        'def read(run):\n    return max(r.refines for r in run.records)\n')
    bench["workloads"].append({"name": "poisson4095.burst",
                               "config": "poisson2d_4095",
                               "traffic": "burst", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "solver.refines_max",
                               "unit": "refines", "better": "lower",
                               "source": "program_counter",
                               "layer": "solver", "moves": "solve_s",
                               "workloads": ["poisson4095.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from portbench import harness\n"
            "p = harness.cell_plan('poisson4095.burst')\n"
            "print(p.mix['in_flight'], [m['name'] for m in p.layer])")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "2"
    assert "solver.refines_max" in out.stdout


def test_no_card_exits_nonzero_without_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "poisson4095.sweep", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "metrics" not in out.stdout and "{" not in out.stdout


def test_only_the_benchmark_fails_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    files gives no result: the program is not there to measure."""
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.')\n"
         "import torch\nfrom portbench import harness\n"
         "harness.run_cell('poisson4095.sweep', 1, 0.1, False, "
         "torch.device('cpu'), 0.0, overrides={'side': 31})"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "amg_tpu_torch" in out.stderr
