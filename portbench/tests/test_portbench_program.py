"""The readers of what the program counts and times itself
(``amg_tpu_torch.utils.tracing``): nothing off the card, nothing where
the program has no such counter or span (a program without the tracing
module), and the program's own reading where it has one."""

import sys
from types import SimpleNamespace

import pytest
import torch

from portbench import harness

PB = harness.HERE
READERS = ("loop.kernels_per_solve", "setup.capture_s")


def reader(name):
    return harness.load_module(PB / "metrics" / f"{name}.py",
                               "portbench_metric_" + name.replace(".", "_"))


@pytest.mark.parametrize("name", READERS)
def test_nothing_on_the_cpu(name):
    run = SimpleNamespace(device=torch.device("cpu"), records=[])
    assert reader(name).read(run) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_the_module(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "amg_tpu_torch.utils.tracing", None)
    run = SimpleNamespace(device=SimpleNamespace(type="cuda"), records=[])
    assert reader(name).read(run) is None


def test_readings_of_a_report():
    """A run that carries the program's report reads it: kernels over
    solves, the capture spans' set-up sum; no solve, no ratio."""
    counters = {"kernels": 900, "solves": 3}
    program = {"counters": counters, "setup": {"setup.capture": 4.5}}
    run = SimpleNamespace(device=SimpleNamespace(type="cuda"),
                          program=program)
    assert reader("loop.kernels_per_solve").read(run) == 300
    assert reader("setup.capture_s").read(run) == 4.5
    counters["solves"] = 0
    assert reader("loop.kernels_per_solve").read(run) is None
