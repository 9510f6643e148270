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
                     "ops.transfer"):
            assert "amg_tpu_torch." + name in sys.modules, name
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
