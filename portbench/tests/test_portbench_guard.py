"""Nothing that the benchmark runs imports JAX or the JAX package: every
module under ``portbench/`` parsed, its imports' top-level names compared
whole (``amg_tpu_torch`` begins with ``amg_tpu``), the reference also
outside the program; and a fresh interpreter that loads the harness and
every driver and reader holds none of them."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "amg_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(p for p in PB.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert not names & (FORBIDDEN | {"amg_tpu_torch"})
    # and nothing of the harness that does
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module:
            assert not node.module.startswith("portbench.") or \
                node.module.startswith("portbench.reference")


def test_the_guard_compares_whole_names():
    from portbench import harness
    assert "amg_tpu" in harness.FORBIDDEN
    assert "amg_tpu_torch" not in harness.FORBIDDEN


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_help_loads_nothing_forbidden():
    code = ("import runpy, sys\nsys.argv = ['portbench/run.py', '--help']\n"
            "try:\n    runpy.run_path('portbench/run.py', "
            "run_name='__main__')\nexcept SystemExit:\n    pass")
    assert not _modules_after(code) & FORBIDDEN


def test_harness_drivers_and_readers_load_nothing_forbidden():
    code = ("import sys\nsys.path.insert(0, '.')\n"
            "from portbench import harness, control, roofline, kernels\n"
            "from pathlib import Path\n"
            "for p in sorted(Path('portbench/drivers').glob('*.py')) + "
            "sorted(Path('portbench/metrics').glob('*.py')):\n"
            "    harness.load_module(p, 'm_' + p.stem.replace('.', '_'))")
    loaded = _modules_after(code)
    assert "amg_tpu_torch" in loaded
    assert not loaded & FORBIDDEN
