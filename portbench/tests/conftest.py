"""The benchmark's tests: the repository root on the path, the ``cuda``
fixture that skips a test where there is no card (decided when the test
runs, never at import), and the manifest with the four-process cell,
whose configuration and mix the benchmark keeps as files for a later
cell (``dist_bench``)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


DIST = "poisson4095_dist4.step"


@pytest.fixture
def dist_bench():
    """(the four-process cell's name, ``BENCHMARK.json`` with it added)."""
    from portbench import harness
    bench = harness.manifest()
    bench["configs"] = bench["configs"] + [{
        "name": "poisson2d_4095_dist4", "source": "x", "reduced": [],
        "file": "portbench/configs/poisson2d_4095_dist4.json", "why": "x"}]
    bench["workloads"] = bench["workloads"] + [{
        "name": DIST, "config": "poisson2d_4095_dist4", "traffic": "step",
        "chips": 4, "why": "x"}]
    for m in bench["per_layer"]:
        if m["name"] == "solver.vcycles_per_solve":
            m["workloads"] = m["workloads"] + [DIST]
    return DIST, bench
