"""The plain reference on small grids: its operator against a scipy
assembly, its check passing the port's CPU solve and failing a perturbed
field, and the traffic generator's pool fixed by the seed."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from portbench import harness, traffic
from portbench.reference import operators, rhs

SIDES = (63, 127)
SEED = 2**31 + 12345
CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def laplacian_scipy(n):
    h = 2.0 / (n + 1)
    D = sp.diags([np.ones(n - 1), -2.0 * np.ones(n), np.ones(n - 1)],
                 [-1, 0, 1]) / (h * h)
    return (sp.kron(sp.identity(n), D) + sp.kron(D, sp.identity(n))).tocsr()


@pytest.mark.parametrize("n", SIDES)
def test_poisson5_matches_scipy(n):
    u = torch.randn((n, n), dtype=torch.float64)
    want = laplacian_scipy(n) @ u.numpy().reshape(-1)
    got = operators.poisson5_apply(u).numpy().reshape(-1)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-6)


def test_reference_forcing_is_a_member():
    from amg_tpu_torch.models import poisson
    n = 63
    got = rhs.gaussian_sources(n, [(5.0, 10.0, 0.0, 0.0)], "cpu")
    want = poisson.rhs(n, device="cpu").reshape(n, n)
    torch.testing.assert_close(got, want, rtol=1e-14, atol=0)


def test_pool_fixed_by_seed():
    mix = traffic.load(harness.HERE / "traffic" / "sweep.json")
    a = traffic.make_pool(mix, SEED, 31, "cpu")
    b = traffic.make_pool(mix, SEED, 31, "cpu")
    c = traffic.make_pool(mix, SEED + 1, 31, "cpu")
    assert len(a) == mix["pool"]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


def test_every_seed_gets_the_same_set():
    """The seed orders the mix's right-hand sides and draws a sign for
    each; the set up to sign, so the work, is the same."""
    mix = traffic.load(harness.HERE / "traffic" / "sweep.json")
    pools = [traffic.make_pool(mix, s, 31, "cpu") for s in (1, SEED)]
    key = [sorted(b.abs().sum().item() for b in p) for p in pools]
    assert key[0] == key[1]
    for b in pools[1]:
        assert any(torch.equal(b, c) or torch.equal(b, -c)
                   for c in pools[0])


def test_a_negated_rhs_is_exactly_the_negation():
    b = rhs.gaussian_sources(31, [(2.0, 7.0, 0.3, -0.2)], "cpu")
    m = rhs.gaussian_sources(31, [(-2.0, 7.0, 0.3, -0.2)], "cpu")
    assert torch.equal(m, -b)


def test_pool_holds_distinct_right_hand_sides():
    mix = traffic.load(harness.HERE / "traffic" / "sweep.json")
    pool = traffic.make_pool(mix, SEED, 31, "cpu")
    keys = {round(b.abs().sum().item(), 9) for b in pool}
    assert len(pool) == mix["pool"] == len(keys) == 64


@pytest.mark.parametrize("cell", CELLS)
def test_cpu_solve_passes_and_perturbed_fails(cell):
    plan = harness.cell_plan(cell)
    solver = dict(plan.config["solver"], side=63)
    config = dict(plan.config, solver=solver)
    op = harness.operator(config)
    inputs = op.inputs(config, "cpu")
    mod = harness.load_module(
        harness.HERE / "drivers" / f"{config['driver']}.py", "drv")
    drv = mod.Driver(solver, inputs, torch.device("cpu"))
    b = traffic.make_pool(plan.mix, SEED, 63, "cpu")[0]
    u, stated, _ = drv.read(drv.submit(b))
    apply = op.reference_apply(config, inputs)
    tol = solver["tolerance"]
    assert stated <= tol
    assert operators.rss(b, apply(u)) <= tol
    bad = u.clone()
    bad[31, 31] += 1e-3
    assert operators.rss(b, apply(bad)) > tol
