"""amg_tpu_torch imports cleanly: no JAX, no amg_tpu, no kernel build.

Each check runs in a fresh interpreter, so modules imported by other tests
in this process cannot hide an import. A stand-in ``nvcc`` first on PATH
(and under CUDA_HOME) records any call.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _fake_cuda_home(tmp_path, exit_code):
    marker = tmp_path / "nvcc_called"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(f"#!/bin/sh\ntouch '{marker}'\n"
                    f"echo 'stand-in nvcc failure' >&2\nexit {exit_code}\n")
    nvcc.chmod(0o755)
    env = dict(os.environ, CUDA_HOME=str(tmp_path),
               PATH=f"{nvcc.parent}{os.pathsep}{os.environ.get('PATH', '')}")
    return env, marker


def _run(code, env):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_import_pulls_in_no_jax_and_builds_nothing(tmp_path):
    env, marker = _fake_cuda_home(tmp_path, 1)
    proc = _run("""
        import importlib, pkgutil, sys
        import amg_tpu_torch
        for mod in pkgutil.walk_packages(amg_tpu_torch.__path__,
                                         "amg_tpu_torch."):
            importlib.import_module(mod.name)
        import chip_smoke
        for name in ("models.varcoef", "ops.kernels.rbgs", "utils.device",
                     "parallel.structured_dist", "ops.kernels.halo",
                     "ops.transfer", "ops.kernels.packed_rm", "krylov",
                     "sparse.ell", "utils.coloring", "ops.coarse",
                     "ops.smoothers", "ops.ell_rap", "multigrid", "config",
                     "utils.checkpoint", "utils.profiling",
                     "utils.debugging", "parallel.ell_dist",
                     "parallel.launch"):
            assert "amg_tpu_torch." + name in sys.modules, name
        for name in ("build_stencil_hierarchy", "solve_stencil", "solve_ir",
                     "build_fine_stencil_f64", "rss", "Stencil2D",
                     "vcycle_stencil", "ELL", "Hierarchy", "Level",
                     "Multigrid", "build_hierarchy", "galerkin_rap",
                     "n_H_dofs_from_n_h_dofs", "solve", "vcycle", "Jacobi",
                     "MulticolorGaussSeidel", "SmootherResult",
                     "SparseGaussSeidel", "SuccessiveOverRelaxation",
                     "BilinearInterpolator2D", "InterpolatorBase",
                     "LinearInterpolator", "SolveResult"):
            assert name in amg_tpu_torch.__all__, name
            assert callable(getattr(amg_tpu_torch, name)), name
        from amg_tpu_torch import structured
        assert structured.SolveResult is amg_tpu_torch.SolveResult
        from amg_tpu_torch.models import poisson
        for name in ("laplacian", "rhs_device", "poisson2d"):
            assert callable(getattr(poisson, name)), name
        from amg_tpu_torch import interop
        for name in ("ell_from_numpy", "ell_hierarchy_from_numpy",
                     "sharded_op_from_numpy", "dist_planes_from_numpy"):
            assert callable(getattr(interop, name)), name
        from amg_tpu_torch.parallel import ell_dist, launch
        for mod, names in ((ell_dist, ("EllDistSolver", "ShardedOp",
                                       "build_ext_panels")),
                           (launch, ("initialize_distributed",
                                     "device_mesh_1d"))):
            for name in names:
                assert callable(getattr(mod, name)), name
        from amg_tpu_torch.utils import profiling
        for name in ("Roofline", "KernelStats", "time_fn", "trace"):
            assert callable(getattr(profiling, name)), name
        from amg_tpu_torch.sparse import stencil
        for name in ("gs4_sweep", "gs4_color_update", "color_masks",
                     "jacobi_sweep", "dinv_matvec2", "estimate_lam_max",
                     "const_lam_max", "chebyshev_smooth", "restrict_fw",
                     "prolong"):
            assert callable(getattr(stencil, name)), name
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "amg_tpu"))
        assert not bad, bad
        from amg_tpu_torch.ops.kernels import _build
        assert _build.library.cache_info().currsize == 0
        print("clean")
    """, env)
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout
    assert not marker.exists(), "importing the package called nvcc"


def test_failed_build_raises_with_nvcc_stderr(tmp_path):
    env, marker = _fake_cuda_home(tmp_path, 2)
    proc = _run(f"""
        from pathlib import Path
        from amg_tpu_torch.ops.kernels import _build
        _build.BUILD_DIR = Path({str(tmp_path / 'build')!r})
        try:
            _build.library()
        except RuntimeError as e:
            assert "stand-in nvcc failure" in str(e), str(e)
            print("raised")
    """, env)
    assert proc.returncode == 0, proc.stderr
    assert "raised" in proc.stdout
    assert marker.exists()
    assert not list((tmp_path / "build").glob("*.so"))
