"""The port's reference-parity pipeline (amg_tpu_torch/multigrid.py)
against amg_tpu's, f64 on the CPU: the testlib numbers
(test/testlib.cpp:147-213, BASELINE.md:11-16) with JAX's counts and rss,
one collected V-cycle level by level, the bilinear path, and the
reference object's getters, validations and display toggle."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amg_tpu.models import poisson as jpoisson
from amg_tpu.multigrid import Multigrid as JMultigrid
from amg_tpu.multigrid import vcycle as jvcycle
from amg_tpu.ops.smoothers import MulticolorGaussSeidel as JMCGS
from amg_tpu.ops.smoothers import SparseGaussSeidel as JSPGS
from amg_tpu.ops.transfer import BilinearInterpolator2D as JBilinear
from amg_tpu_torch import (BilinearInterpolator2D, LinearInterpolator,
                           MulticolorGaussSeidel, Multigrid,
                           SparseGaussSeidel, build_hierarchy, poisson,
                           rss, vcycle)

torch.set_num_threads(1)

DOFS = [1225, 612, 305, 152, 75, 37, 18, 8]


@pytest.fixture(scope="module")
def testlib():
    """The headline run in both packages: 8-level AMG with symmetric GS
    at 35^2, tol 1e-9 checked every 5 cycles, and the standalone GS."""
    A, b = poisson.poisson2d(35, device="cpu")
    jA, jb = jpoisson.poisson2d(35)
    amg = Multigrid(LinearInterpolator(8), SparseGaussSeidel(), A, b, 8,
                    1e-9, 5, 100, device="cpu")
    jamg = JMultigrid(None, None, jA, jb, 8, 1e-9, 5, 100)
    out = {"amg": amg, "jamg": jamg, "A": A, "b": b}
    # the collected V-cycle from one random start, before any solve
    u0 = np.random.default_rng(4).standard_normal(1225)
    out["collect"] = (
        vcycle(amg.hierarchy, amg.smoother, torch.from_numpy(u0), b,
               collect=True),
        jax.jit(lambda h, u, bb: jvcycle(h, jamg.smoother, u, bb,
                                         collect=True))(
            jamg.hierarchy, jnp.asarray(u0), jb))
    out["res"] = amg.solve(verbose=False)
    out["jres"] = jamg.solve(verbose=False)
    out["gs"] = SparseGaussSeidel(1e-9, 100, 1000).smooth(
        A, torch.zeros_like(b), b)
    out["jgs"] = JSPGS(1e-9, 100, 1000).smooth(jA, jnp.zeros_like(jb), jb)
    return out


def test_dof_sequence(testlib):
    amg, jamg = testlib["amg"], testlib["jamg"]
    assert [amg.get_n_dofs(l) for l in range(8)] == DOFS
    assert [jamg.get_n_dofs(l) for l in range(8)] == DOFS
    for l in range(1, 8):
        assert amg.get_soln(l - 1).shape[0] > amg.get_soln(l).shape[0]


def test_35_vcycles(testlib):
    res, jres = testlib["res"], testlib["jres"]
    assert res.converged and res.iterations == jres.iterations == 35
    assert res.error == pytest.approx(7.19199e-11, rel=1e-3)
    assert res.error == pytest.approx(jres.error, rel=1e-9)
    assert [i for i, _ in res.history] == [i for i, _ in jres.history]
    np.testing.assert_allclose(res.u.numpy(), np.asarray(jres.u),
                               rtol=1e-9)


def test_900_gs_sweeps(testlib):
    gs, jgs = testlib["gs"], testlib["jgs"]
    assert gs.converged and gs.iterations == jgs.iterations == 900
    assert gs.error < 1e-9
    assert gs.error == pytest.approx(jgs.error, rel=1e-9)


def test_amg_matches_standalone_gs(testlib):
    """Eigen isApprox at 1e-6 (testlib.cpp:208-212), in both packages."""
    for u_amg, u_gs in ((testlib["res"].u.numpy(), testlib["gs"].u.numpy()),
                        (np.asarray(testlib["jres"].u),
                         np.asarray(testlib["jgs"].u))):
        diff = np.linalg.norm(u_amg - u_gs)
        assert diff <= 1e-6 * min(np.linalg.norm(u_amg),
                                  np.linalg.norm(u_gs))


def test_collected_vcycle_per_level(testlib):
    (u, (us, bs, rs)), (ju, (jus, jbs, jrs)) = testlib["collect"]
    for name, got, ref in (("u", us, jus), ("b", bs, jbs), ("r", rs, jrs)):
        for l, (g, r) in enumerate(zip(got, ref)):
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                       atol=1e-12 * max(np.abs(r).max(), 1),
                                       err_msg=f"{name}[{l}]")
    np.testing.assert_array_equal(u.numpy(), us[0].numpy())


def test_bilinear_31_converges_fast():
    A, b = poisson.poisson2d(31, device="cpu")
    res = Multigrid(BilinearInterpolator2D(31), MulticolorGaussSeidel(), A,
                    b, 4, 1e-9, 1, 100, device="cpu").solve(verbose=False)
    jA, jb = jpoisson.poisson2d(31)
    jres = JMultigrid(JBilinear(31), JMCGS(), jA, jb, 4, 1e-9, 1,
                      100).solve(verbose=False)
    assert res.converged and res.iterations <= 12
    assert res.iterations == jres.iterations
    assert res.error == pytest.approx(jres.error, rel=1e-9)


def test_invalid_every_gt_niters_raises():
    """compute_error_every_n_iters > n_iters raises (testlib.cpp:130-136)."""
    A, b = poisson.poisson2d(2, device="cpu")
    with pytest.raises(ValueError, match="leq"):
        Multigrid(None, None, A, b, 8, 1e-9, 100, 10, device="cpu")


def test_invalid_dof_mismatch_raises():
    """A and b of other sizes raise (testlib.cpp:138-144)."""
    A, _ = poisson.poisson2d(3, device="cpu")
    with pytest.raises(ValueError, match="same number"):
        Multigrid(None, None, A, torch.zeros(11, dtype=torch.float64), 8,
                  1e-9, 5, 10, device="cpu")


def test_too_deep_hierarchy_raises():
    with pytest.raises(ValueError, match="too deep"):
        build_hierarchy(poisson.laplacian_scipy(5), 8, device="cpu")


def test_stateful_vcycle_and_getters():
    """The stateful vcycle updates the per-level mirrors as JAX's does
    (multigrid.hpp:263-305)."""
    A, b = poisson.poisson2d(9, device="cpu")
    jA, jb = jpoisson.poisson2d(9)
    amg = Multigrid(None, None, A, b, 3, 1e-9, 5, 100, device="cpu")
    jamg = JMultigrid(None, None, jA, jb, 3, 1e-9, 5, 100)
    assert float(amg.get_soln(0).abs().sum()) == 0
    torch.testing.assert_close(amg.get_rhs(0), b)
    assert amg.get_tolerance() == 1e-9
    assert amg.get_coefficient_matrix(1).n_rows == amg.get_n_dofs(1) == 40
    for _ in range(2):
        amg.vcycle()
        jamg.vcycle()
    for l in range(3):
        for get in ("get_soln", "get_rhs", "get_residual"):
            ref = np.asarray(getattr(jamg, get)(l))
            np.testing.assert_allclose(
                getattr(amg, get)(l).numpy(), ref, rtol=0,
                atol=1e-12 * max(np.abs(ref).max(), 1), err_msg=f"{get}({l})")
    e = float(rss(A, amg.get_soln(0), b))
    assert e < float(rss(A, torch.zeros_like(b), b)) * 1e-2


def test_display_error_toggles(capsys):
    A, b = poisson.poisson2d(9, device="cpu")
    amg = Multigrid(None, None, A, b, 3, 1e-9, 5, 10, device="cpu")
    amg.display_error_on()
    amg.solve(verbose=False)
    assert "Iter: 5 | Error:" in capsys.readouterr().out
    amg.display_error_off()  # the reference's sets true; fixed
    amg.solve(verbose=True)
    out = capsys.readouterr().out
    assert "Iter:" not in out and "AMG converged after" in out


def test_hierarchy_moves_with_to():
    A, _ = poisson.poisson2d(9, device="cpu")
    h = build_hierarchy(A, 3, smoother=MulticolorGaussSeidel(),
                        device="cpu")
    h = h.to(torch.float32)
    assert h.levels[1].A.dtype == torch.float32
    assert h.levels[1].A.cols.dtype == torch.int64
    assert h.levels[0].smoother_state.data[0].dtype == torch.float32
    assert h.coarse.lu.dtype == torch.float32
    assert set(h.setup_seconds) == {"rap", "upload", "smoother", "lu"}
