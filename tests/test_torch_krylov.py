"""amg_tpu_torch.krylov against amg_tpu.krylov on the same hierarchies and
right-hand sides (CPU).

In f64 both sides walk the same iteration: the same count and history
length, u within rtol 1e-10 (f64 rounding differences of the inner
products and the V-cycle's sums, amplified by the iteration). The
hierarchies are the packed one (the color-packed V-cycle) and one masked
one (the unpacked V-cycle, vcycle_stencil). The f32 runs are
in tests/test_torch_krylov_f32.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amg_tpu import krylov as jk
from amg_tpu import structured as jst
from amg_tpu.models import poisson as jpoisson

from amg_tpu_torch import krylov as tk
from amg_tpu_torch import structured as tst
from amg_tpu_torch.ops import kernels as K

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _rhs(side):
    return np.asarray(jpoisson.rhs(side, dtype=jnp.float64)).reshape(side,
                                                                      side)


def _pair(side, smoother="packed"):
    """The same f64 hierarchy and rhs on both sides."""
    jh = jst.build_stencil_hierarchy_device(side, dtype=jnp.float64,
                                            smoother=smoother)
    th = tst.build_stencil_hierarchy_device(side, dtype=torch.float64,
                                            device=CPU, smoother=smoother)
    b = _rhs(side)
    return jh, jnp.asarray(b), th, torch.tensor(b)


def _close(got, want, rtol):
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= rtol * np.abs(want).max()


@pytest.mark.parametrize("side", [255, 511])
def test_host_pcg_matches_jax_f64(side):
    jh, jb, th, tb = _pair(side)
    want = jk.solve_pcg_stencil(jh, jb, tolerance=1e-9, n_iters=50)
    got = tk.solve_pcg_stencil(th, tb, tolerance=1e-9, n_iters=50)
    assert got.converged and want.converged
    assert got.iterations == want.iterations
    assert len(got.history) == len(want.history)
    np.testing.assert_allclose([e for _, e in got.history],
                               [e for _, e in want.history], rtol=1e-6)
    _close(got.u, want.u, 1e-10)


@pytest.mark.parametrize("side", [255, 511])
def test_device_pcg_matches_jax_f64(side):
    jh, jb, th, tb = _pair(side)
    ju, jstats = jk.solve_pcg_device(jh, jb, tolerance=1e-9, n_iters=50)
    tu, tstats = tk.solve_pcg_device(th, tb, tolerance=1e-9, n_iters=50)
    j_err, j_it = np.asarray(jstats)
    t_err, t_it = tstats.tolist()
    assert tstats.dtype == torch.float64 and tstats.shape == (2,)
    assert int(t_it) == int(j_it) and t_err <= 1e-9
    _close(tu, ju, 1e-10)


def test_masked_hierarchy_pcg_matches_jax():
    """A masked hierarchy preconditions with the unpacked cycle
    (vcycle_stencil); the port's device loop walks
    its host loop's iteration bitwise."""
    jh, jb, th, tb = _pair(127, smoother="masked")
    want = jk.solve_pcg_stencil(jh, jb, tolerance=1e-9, n_iters=50)
    got = tk.solve_pcg_stencil(th, tb, tolerance=1e-9, n_iters=50)
    assert got.iterations == want.iterations
    _close(got.u, want.u, 1e-10)
    tu, tstats = tk.solve_pcg_device(th, tb, tolerance=1e-9, n_iters=50)
    assert int(tstats[1]) == got.iterations and torch.equal(tu, got.u)


def test_host_pcg_start_and_cycle_match_jax():
    """The host loop's u0 and cycle arguments: a nonzero start and the
    unpacked cycle on a packed hierarchy, against JAX's with its
    vcycle_stencil."""
    side = 127
    jh, jb, th, tb = _pair(side)
    u0 = 0.1 * np.sin(np.arange(side * side, dtype=np.float64)).reshape(
        side, side)
    want = jk.solve_pcg_stencil(jh, jb, tolerance=1e-9, n_iters=50,
                                u0=jnp.asarray(u0),
                                cycle=jst.vcycle_stencil)
    got = tk.solve_pcg_stencil(th, tb, tolerance=1e-9, n_iters=50,
                               u0=torch.tensor(u0),
                               cycle=tst.vcycle_stencil)
    assert got.converged and got.iterations == want.iterations
    _close(got.u, want.u, 1e-10)


def test_fused_pcg_leg_calls(monkeypatch):
    """With the fused threshold at the fine side, fused=True runs the legs
    once per V-cycle, (it + 1) times (the first preconditioning and one
    per iteration), the count chip_smoke.py checks on the card; on the
    CPU their plain versions give the packed cycle's bits."""
    side = 255
    monkeypatch.setattr(tst, "FUSED_PACKED_MIN_SIDE", side)
    th = tst.build_stencil_hierarchy_device(side, device=CPU,
                                            smoother="packed")
    b = torch.tensor(_rhs(side), dtype=torch.float32)
    calls = {"down": 0, "up": 0}
    for name, key in (("fused_down_leg_packed", "down"),
                      ("fused_up_leg_packed", "up")):
        orig = getattr(tst, name)

        def counted(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(tst, name, counted)
    K.reset_launch_counts()
    u, stats = tk.solve_pcg_device(th, b, tolerance=1e-5, n_iters=50,
                                   fused=True)
    it = int(stats[1])
    assert it >= 1 and calls["down"] == calls["up"] == it + 1
    assert all(n == 0 for n in K.launch_counts().values())
    u_plain, stats_plain = tk.solve_pcg_device(th, b, tolerance=1e-5,
                                               n_iters=50)
    assert torch.equal(u, u_plain) and torch.equal(stats, stats_plain)


def test_budget_exhaustion_and_nonconvergence():
    side = 31
    th = tst.build_stencil_hierarchy_device(side, device=CPU,
                                            smoother="packed")
    b = torch.tensor(_rhs(side), dtype=torch.float32)
    _, stats = tk.solve_pcg_device(th, b, tolerance=1e-30, n_iters=3)
    assert int(stats[1]) == 3 and float(stats[0]) > 1e-30
    res = tk.solve_pcg_stencil(th, b, tolerance=1e-30, n_iters=2)
    assert not res.converged and res.iterations == 2
    assert len(res.history) == 3
