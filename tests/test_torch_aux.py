"""The port's auxiliary modules against amg_tpu's, on the CPU: the config
dataclasses and each solver's ``config=`` rule (amg_tpu_torch/config.py),
checkpoints carried across in both directions (utils/checkpoint.py), and
the profiling and debugging helpers (utils/profiling.py,
utils/debugging.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amg_tpu import config as jconfig
from amg_tpu.models import poisson as jpoisson
from amg_tpu.multigrid import Multigrid as JMultigrid
from amg_tpu.multigrid import build_hierarchy as jbuild_hierarchy
from amg_tpu.multigrid import solve as jsolve
from amg_tpu.ops.smoothers import MulticolorGaussSeidel as JMCGS
from amg_tpu.parallel.structured_dist import \
    DistStructuredSolver as JDistSolver
from amg_tpu.structured import StructuredSolver as JStructuredSolver
from amg_tpu.structured import build_stencil_hierarchy as jbuild_stencil
from amg_tpu.structured import \
    build_stencil_hierarchy_device as jbuild_stencil_device
from amg_tpu.structured import solve_stencil as jsolve_stencil
from amg_tpu.utils import checkpoint as jckpt
from amg_tpu_torch import (DistStructuredSolver, MulticolorGaussSeidel,
                           Multigrid, StructuredSolver, build_hierarchy,
                           build_stencil_hierarchy,
                           build_stencil_hierarchy_device, config, poisson,
                           solve, solve_stencil)
from amg_tpu_torch.utils import checkpoint, debugging, profiling

torch.set_num_threads(1)


# -- config -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["SmootherConfig", "SolverConfig",
                                  "StructuredConfig", "MeshConfig"])
def test_config_defaults_equal_jax(name):
    got = dataclasses.asdict(getattr(config, name)())
    ref = dataclasses.asdict(getattr(jconfig, name)())
    assert got.keys() == ref.keys()
    if "dtype" in got:
        assert got.pop("dtype") == torch.float32
        assert ref.pop("dtype") == jnp.float32
    assert got == ref


@pytest.mark.parametrize("n_levels", [3, 0])
def test_multigrid_config_overrides(n_levels):
    """JAX's rule: the config overrides tolerance, cadence and n_iters,
    even an explicit tolerance, and gives n_levels only when it is falsy."""
    cfg = dict(n_levels=4, tolerance=1e-3, compute_error_every_n_iters=2,
               n_iters=7)
    A, b = poisson.poisson2d(7, device="cpu")
    jA, jb = jpoisson.poisson2d(7)
    got = Multigrid(None, None, A, b, n_levels, 1e-9, 5, 100,
                    config=config.SolverConfig(**cfg), device="cpu")
    ref = JMultigrid(None, None, jA, jb, n_levels, 1e-9, 5, 100,
                     config=jconfig.SolverConfig(**cfg))
    for attr in ("tolerance", "compute_error_every_n_iters", "n_iters",
                 "n_levels"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    assert got.tolerance == 1e-3 and got.n_iters == 7
    assert got.hierarchy.n_levels == ref.hierarchy.n_levels == (n_levels or 4)
    res, jres = got.solve(verbose=False), ref.solve(verbose=False)
    assert res.iterations == jres.iterations
    assert [i for i, _ in res.history] == [i for i, _ in jres.history]


@pytest.mark.parametrize("explicit", [{}, {"pre_sweeps": 1, "omega": 1.0,
                                           "smoother": "packed",
                                           "cycles_per_refine": 2}])
def test_structured_solver_config(explicit):
    """Explicit argument, then config, then default (JAX's rule)."""
    cfg = dict(smoother="masked", pre_sweeps=2, post_sweeps=3, omega=0.9,
               symmetric=False, cycles_per_refine=4, packed_min_side=9)
    got = StructuredSolver(15, config=config.StructuredConfig(**cfg),
                           device="cpu", **explicit)
    ref = JStructuredSolver(15, config=jconfig.StructuredConfig(**cfg),
                            **explicit)
    want = {**cfg, **explicit}
    for attr in ("pre_sweeps", "post_sweeps", "omega", "symmetric",
                 "cycles_per_refine", "packed_min_side"):
        assert getattr(got, attr) == want[attr], attr
    assert got.smoother == ref.smoother == want["smoother"]
    assert got.cycles_per_refine == ref.cycles_per_refine
    assert got.packed_min_side == ref.packed_min_side


def test_structured_solver_config_none_fields_keep_defaults():
    s = StructuredSolver(15, config=config.SolverConfig(), device="cpu")
    assert (s.smoother, s.pre_sweeps, s.cycles_per_refine) == ("packed", 1, 3)


@pytest.mark.parametrize("explicit", [{}, {"n_devices": 2, "halo": "step",
                                           "cycles_per_refine": 1}])
def test_dist_solver_config(explicit):
    cfg = dict(n_devices=4, halo="sweep", cycles_per_refine=3)
    got = DistStructuredSolver(31, config=config.MeshConfig(**cfg),
                               device="cpu", **explicit)
    ref = JDistSolver(31, config=jconfig.MeshConfig(**cfg), **explicit)
    want = {**cfg, **explicit}
    assert got.cfg.n_devices == ref.cfg.n_devices == want["n_devices"]
    assert got.cfg.halo == ref.cfg.halo == want["halo"]
    assert got.cycles_per_refine == ref.cycles_per_refine == \
        want["cycles_per_refine"]


# -- checkpoints --------------------------------------------------------------

def test_ell_checkpoint_jax_to_port(tmp_path):
    M = poisson.laplacian_scipy(15)
    b = poisson.rhs(15, device="cpu")
    jh = jbuild_hierarchy(M, 4, smoother=JMCGS())
    jckpt.save_hierarchy(str(tmp_path / "h.npz"), jh)
    h = checkpoint.load_hierarchy(str(tmp_path / "h.npz"), device="cpu")
    for lev, jlev in zip(h.levels, jh.levels):
        np.testing.assert_array_equal(lev.A.data.numpy(),
                                      np.asarray(jlev.A.data))
        np.testing.assert_array_equal(lev.A.cols.numpy(),
                                      np.asarray(jlev.A.cols))
    res = solve(h, MulticolorGaussSeidel(), b, compute_error_every_n_iters=1)
    jres = jsolve(jh, JMCGS(), jnp.asarray(b.numpy()),
                  compute_error_every_n_iters=1)
    assert res.converged and res.iterations == jres.iterations
    assert res.error == pytest.approx(jres.error, rel=1e-9)


def test_ell_checkpoint_port_to_jax(tmp_path):
    M = poisson.laplacian_scipy(15)
    b = poisson.rhs(15, device="cpu")
    h = build_hierarchy(M, 4, smoother=MulticolorGaussSeidel(),
                        device="cpu")
    checkpoint.save_hierarchy(str(tmp_path / "h.npz"), h)
    z = np.load(tmp_path / "h.npz")
    assert z["A0_cols"].dtype == np.int32 and "P3_data" not in z
    jh = jckpt.load_hierarchy(str(tmp_path / "h.npz"))
    res = solve(h, MulticolorGaussSeidel(), b, compute_error_every_n_iters=1)
    jres = jsolve(jh, JMCGS(), jnp.asarray(b.numpy()),
                  compute_error_every_n_iters=1)
    assert res.converged and res.iterations == jres.iterations
    assert res.error == pytest.approx(jres.error, rel=1e-9)


HIERARCHIES = {
    "device": (lambda: build_stencil_hierarchy_device(
        31, dtype=torch.float64, device="cpu"),
        lambda: jbuild_stencil_device(31, dtype=jnp.float64)),
    "host": (lambda: build_stencil_hierarchy(31, dtype=torch.float64,
                                             device="cpu"),
             lambda: jbuild_stencil(31, dtype=jnp.float64)),
}


@pytest.mark.parametrize("kind", sorted(HIERARCHIES))
def test_stencil_checkpoint_both_ways(kind, tmp_path):
    """A stencil hierarchy saved by either package solves to the other's
    V-cycle count once loaded by the other."""
    b2 = poisson.rhs(31, device="cpu").reshape(31, 31)
    jb2 = jnp.asarray(b2.numpy())
    build, jbuild = HIERARCHIES[kind]
    jckpt.save_stencil_hierarchy(str(tmp_path / "j.npz"), jbuild())
    checkpoint.save_stencil_hierarchy(str(tmp_path / "t.npz"), build())
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(zj.files) == sorted(zt.files)
    np.testing.assert_array_equal(zj["coarse_piv"], zt["coarse_piv"])
    h = checkpoint.load_stencil_hierarchy(str(tmp_path / "j.npz"),
                                          device="cpu")
    jh = jckpt.load_stencil_hierarchy(str(tmp_path / "t.npz"))
    res = solve_stencil(h, b2, tolerance=1e-9, device="cpu")
    jres = jsolve_stencil(jh, jb2, tolerance=1e-9)
    assert res.converged and res.iterations == jres.iterations
    assert res.error == pytest.approx(jres.error, rel=1e-9)
    assert h.w33s == tuple(lev.w33 for lev in jh.levels)


def test_solution_checkpoint_both_ways(tmp_path):
    u = torch.arange(6, dtype=torch.float64)
    checkpoint.save_solution(str(tmp_path / "t.npz"), u, 7, 1.5e-10)
    ju, it, err = jckpt.load_solution(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(np.asarray(ju), u.numpy())
    assert (it, err) == (7, 1.5e-10)
    jckpt.save_solution(str(tmp_path / "j.npz"), ju * 2, 8, 2e-9)
    u2, it2, err2 = checkpoint.load_solution(str(tmp_path / "j.npz"),
                                             device="cpu")
    torch.testing.assert_close(u2, u * 2, rtol=0, atol=0)
    assert (it2, err2) == (8, 2e-9)


# -- profiling and debugging ------------------------------------------------

def test_roofline_is_the_h100s():
    r = profiling.Roofline()
    assert (r.hbm_gbps, r.f32_tflops) == (3350.0, 67.0)
    assert r.stencil_sweep_sol_s(10 ** 6) == pytest.approx(
        12 * 4e6 / 3.35e12)
    s = profiling.KernelStats("sweep", 2e-3, 9 * 10 ** 6, sweeps=2)
    assert s.nnz_per_s == pytest.approx(9e9)
    assert "% of SoL" in s.summary(r, 10 ** 6)


def test_time_fn_and_trace_on_the_cpu(tmp_path):
    x = torch.ones(64, dtype=torch.float64)
    calls = []

    def f(v):
        calls.append(1)
        return v * 2

    t = profiling.time_fn(f, x, iters=3, warmup=1)
    assert t > 0 and len(calls) == 4
    log_dir = tmp_path / "trace"
    with profiling.trace(log_dir=str(log_dir)) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    assert (log_dir / "trace.json").exists()


def test_assert_reproducible():
    A, b = poisson.poisson2d(9, device="cpu")
    h = build_hierarchy(A, 3, smoother=MulticolorGaussSeidel(),
                        device="cpu")
    out = debugging.assert_reproducible(
        lambda: solve(h, MulticolorGaussSeidel(), b).u)
    assert out.shape == (81,)
    noise = iter(range(10))
    with pytest.raises(AssertionError):
        debugging.assert_reproducible(lambda: torch.tensor([next(noise)]))


def test_nan_checks_raise_in_the_solve_loops():
    A, b = poisson.poisson2d(9, device="cpu")
    b = b.clone()
    b[3] = float("nan")
    h = build_hierarchy(A, 3, smoother=MulticolorGaussSeidel(),
                        device="cpu")
    debugging.enable_nan_checks()
    try:
        with pytest.raises(FloatingPointError):
            solve(h, MulticolorGaussSeidel(), b, n_iters=10)
        with pytest.raises(FloatingPointError):
            MulticolorGaussSeidel(compute_error_every_n_iters=2,
                                  n_iters=4).smooth(A, torch.zeros_like(b), b)
        with pytest.raises(FloatingPointError):
            solve_stencil(build_stencil_hierarchy_device(
                15, dtype=torch.float64, device="cpu"),
                torch.full((15, 15), float("nan"), dtype=torch.float64),
                device="cpu")
    finally:
        debugging.disable_nan_checks()
    res = solve(h, MulticolorGaussSeidel(), b, n_iters=10)
    assert not res.converged


def test_assert_shards_consistent():
    d = DistStructuredSolver(31, n_devices=4, device="cpu")
    rep = torch.ones(4, 3).cumsum(1)
    debugging.assert_shards_consistent(rep)
    u = d.pad_field(poisson.rhs(31, device="cpu").reshape(31, 31))
    with pytest.raises(AssertionError):
        debugging.assert_shards_consistent(u)
