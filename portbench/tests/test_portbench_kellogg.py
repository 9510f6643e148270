"""The ``jump4095.sweep`` cell on the CPU at a small side: the operator
module's planes against the reference's flux form, a sound run
``correct``, an answer in a lower precision or off by a relative 1e-3
not; the new readers (nothing off the card, nothing where the program
lacks the counter or span, the program's reading where it has it) and
K6's yardstick.

Tolerance of the planes against the flux form: 1e-13 of max |A u|, two
f64 sums of the same five terms per node in another order (a few ulps
of the largest term, of the size of A u for a random field)."""

import sys
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, var_roofline
from portbench.reference import kellogg

CELL = "jump4095.sweep"
SIDE = 63
SEED = 2**32 + 4242
CPU = torch.device("cpu")


def config(side=SIDE):
    plan = harness.cell_plan(CELL)
    return dict(plan.config, solver=dict(plan.config["solver"], side=side))


@pytest.mark.parametrize("n", (15, 63))
def test_operator_planes_are_the_flux_form(n):
    cfg = config(n)
    op = harness.operator(cfg)
    planes = op.inputs(cfg, CPU)["planes"]
    assert planes.shape == (3, 3, n, n) and planes.dtype == torch.float64
    apply = op.reference_apply(cfg, {"planes": planes})
    p = kellogg.cells(n)
    for seed in range(3):
        u = torch.randn((n, n), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(seed))
        want = kellogg.flux_apply(p, u)
        assert (apply(u) - want).abs().max() <= 1e-13 * want.abs().max()


def test_configuration():
    plan = harness.cell_plan(CELL)
    cfg = plan.config
    assert cfg["operator"]["kind"] == "kellogg"
    assert cfg["driver"] == "structured"
    assert cfg["solver"]["side"] == 4095
    assert cfg["solver"]["options"] == {"smoother": "fused",
                                        "precision": "f64"}
    assert plan.cell["chips"] == 1 and plan.cell["traffic"] == "sweep"
    names = {m["name"] for m in plan.layer}
    assert {"kernel.var_sweep_roofline", "setup.galerkin_s",
            "plain.var_levels_per_solve", "solver.vcycles_per_solve",
            "loop.kernels_per_solve", "device.idle_share",
            "setup.capture_s"} <= names


class Broken:
    """The driver with its answers changed where they are produced."""

    def __init__(self, drv, fault):
        self.drv, self.fault = drv, fault
        self.cycles_per_refine = drv.cycles_per_refine

    def warmup(self):
        self.drv.warmup()

    def submit(self, b):
        return self.drv.submit(b)

    def read(self, p):
        u, rss, refines = self.drv.read(p)
        return self.fault(u), rss, refines

    def close(self):
        self.drv.close()


def in_f32(u):
    """The answer rounded to f32: a lower precision than the cell's."""
    return u.to(torch.float32).to(torch.float64)


def scaled(u):
    """The answer off by a relative 1e-3 everywhere (rss ~ 1e-6 |b|^2,
    about 4e-3 at 63^2)."""
    return u * (1.0 + 1e-3)


def run(faults=None):
    return harness.run_cell(CELL, SEED, 0.2, False, CPU, time.time(),
                            overrides={"side": SIDE}, faults=faults)


def test_sound_run_is_correct():
    out = run()
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["checks"]["rss_max"]["value"] <= 1e-7


@pytest.mark.parametrize("fault", (in_f32, scaled),
                         ids=lambda f: f.__name__)
def test_fault_is_caught(fault):
    out = run(faults=lambda d: Broken(d, fault))
    assert not out["correct"], out["checks"]
    assert out["checks"]["rss_max"]["value"] > 1e-7


READERS = ("setup.galerkin_s", "plain.var_levels_per_solve",
           "kernel.var_sweep_roofline")


def reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               "portbench_metric_" + name.replace(".", "_"))


@pytest.mark.parametrize("name", READERS)
def test_nothing_on_the_cpu(name):
    run = SimpleNamespace(device=CPU, records=[], seed=1,
                          inputs={"planes": torch.zeros((3, 3, 7, 7))})
    assert reader(name).read(run) is None


@pytest.mark.parametrize("name", READERS[:2])
def test_nothing_without_the_module(name, monkeypatch):
    from amg_tpu_torch import utils
    monkeypatch.delattr(utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "amg_tpu_torch.utils.tracing", None)
    run = SimpleNamespace(device=SimpleNamespace(type="cuda"), records=[])
    assert reader(name).read(run) is None


def test_readings_of_a_report():
    """The program's set-up sum of the Galerkin span, and the plain visits
    over the solves; a program without them (the parent's) gives
    nothing."""
    counters = {"var_levels_plain": 900, "solves": 3}
    program = {"counters": counters,
               "setup": {"setup.galerkin_planes": 0.25}}
    run = SimpleNamespace(device=SimpleNamespace(type="cuda"),
                          program=program)
    assert reader("setup.galerkin_s").read(run) == 0.25
    assert reader("plain.var_levels_per_solve").read(run) == 300
    counters["solves"] = 0
    assert reader("plain.var_levels_per_solve").read(run) is None
    old = SimpleNamespace(device=SimpleNamespace(type="cuda"),
                          program={"counters": {"solves": 3}, "setup": {}})
    assert reader("setup.galerkin_s").read(old) is None
    assert reader("plain.var_levels_per_solve").read(old) is None


def test_var_sweep_yardstick():
    """K6 at 4095^2: 48 B a cell (nine f32 planes, u and b read, u
    written) and 42 operations a cell (8 neighbours, twice)."""
    nbytes, ops = var_roofline.var_sweep(4095)
    assert nbytes == 48 * 4095 ** 2
    assert ops == 42 * 4095 ** 2
