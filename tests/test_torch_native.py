"""amg_tpu_torch's native setup engine (amg_tpu_torch/native) against
amg_tpu's (amg_tpu/native) on the same numpy and scipy inputs, on the CPU.

Both build one C++ source with one compiler and the same flags, so every
entry point is held bitwise: the sparse products and the transpose (the
indptr, indices and values), the coloring, the ELL panels, the GS sweeps
and the C++ V-cycle solve (its iterations, rss and u). Then the callers
that take the engine as JAX's do: ``build_stencil_hierarchy`` (planes
bitwise at 127^2) and ``greedy_coloring`` (on a MulticolorGaussSeidel
level). The engine builds into ``build/amg_tpu_torch``; two processes that
build it at once into an empty directory both load a whole library.

The tests skip only where there is no g++; a build that fails with g++
present fails them, with the compiler's message.
"""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from amg_tpu import structured as jst
from amg_tpu.native import bindings as jb
from amg_tpu.ops import smoothers as jsm
from amg_tpu.sparse.ell import ELL as JELL
from amg_tpu.utils import coloring as jcol

from amg_tpu_torch import structured as tst
from amg_tpu_torch.models import poisson
from amg_tpu_torch.native import bindings as tb
from amg_tpu_torch.ops import smoothers as tsm
from amg_tpu_torch.ops.transfer import linear_interp_1d
from amg_tpu_torch.sparse.ell import ELL
from amg_tpu_torch.utils import coloring as tcol

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++: the native engine is not "
                                "built, its callers take scipy")
REPO = Path(__file__).resolve().parents[1]
SIDE = 63
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def built():
    """Both engines loaded; a failed build fails here with its message."""
    assert tb.available(), f"the port's native engine: {tb.last_error()}"
    assert jb.available(), "amg_tpu's native engine did not build"
    assert tb.last_error() is None


def _same_csr(a, b):
    assert a.shape == b.shape
    for name in ("indptr", "indices", "data"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _chain(mod, side=SIDE):
    """bench.py's baseline hierarchy through ``mod``'s engine: the
    Poisson matrix, the bilinear transfers, R = P^T, native RAP."""
    n_levels = tst.max_levels_for_side(side)
    mats, Ps, Rs, s = [poisson.laplacian_scipy(side)], [], [], side
    for _ in range(n_levels - 1):
        nc = (s - 1) // 2
        P1 = linear_interp_1d(s, nc)
        P2 = sp.kron(P1, P1).tocsr()
        Ps.append(P2)
        Rs.append(mod.csr_transpose(P2))
        mats.append(mod.galerkin_rap(Rs[-1], mats[-1], P2))
        s = nc
    return mats, Ps, Rs


def _random_csr(seed, n, m, density):
    return sp.random(n, m, density=density, format="csr",
                     random_state=np.random.default_rng(seed))


def test_spgemm_bitwise():
    A, B = _random_csr(0, 97, 61, 0.08), _random_csr(1, 61, 83, 0.1)
    _same_csr(tb.spgemm(A, B), jb.spgemm(A, B))
    L = poisson.laplacian_scipy(SIDE)
    P1 = linear_interp_1d(SIDE, (SIDE - 1) // 2)
    P2 = sp.kron(P1, P1).tocsr()
    _same_csr(tb.spgemm(L, P2), jb.spgemm(L, P2))


def test_csr_transpose_bitwise():
    A = _random_csr(2, 37, 23, 0.15)
    got = tb.csr_transpose(A)
    _same_csr(got, jb.csr_transpose(A))
    np.testing.assert_array_equal(got.toarray(), A.toarray().T)


def test_galerkin_rap_chain_bitwise():
    """A 63^2 chain (6 levels) through each engine: every level's matrix
    and every R bitwise; against scipy's chain within the rounding."""
    got, want = _chain(tb), _chain(jb)
    assert len(got[0]) == 5
    for g, w in zip(got[0] + got[2], want[0] + want[2]):
        _same_csr(g, w)
    scipy_chain = tst.galerkin_chain(got[0][0], [63, 31, 15, 7, 3],
                                     native=False)
    for g, w in zip(got[0], scipy_chain):
        assert abs(g - w).max() <= 1e-13 * abs(w).max()


def test_greedy_coloring_native_bitwise():
    ell = ELL.from_scipy(_chain(tb)[0][1], dtype=torch.float64,
                         device="cpu")
    cols, data = ell.cols.numpy(), ell.data.numpy()
    got = tb.greedy_coloring_native(cols, data, ell.n_rows)
    np.testing.assert_array_equal(
        got, jb.greedy_coloring_native(cols, data, ell.n_rows))
    assert got.dtype == np.int64 and got.max() == 3   # a 9-point level


@pytest.mark.parametrize("k_max", [None, 12])
def test_ell_pack_bitwise(k_max):
    A = _chain(tb)[0][1]
    got, want = tb.ell_pack(A, k_max), jb.ell_pack(A, k_max)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="too small"):
        tb.ell_pack(A, 3)


def test_seq_sgs_bench_bitwise():
    A = poisson.laplacian_scipy(SIDE)
    b = np.random.default_rng(3).standard_normal(SIDE * SIDE)
    (t_s, t_u), (_, j_u) = tb.seq_sgs_bench(A, b, 7), jb.seq_sgs_bench(A, b,
                                                                       7)
    assert t_s >= 0.0
    np.testing.assert_array_equal(t_u, j_u)


def test_cpu_vcycle_solve_bitwise():
    """The C++ baseline at 63^2 to 1e-9 on the same hierarchy and rhs:
    the same iterations, rss and u."""
    mats, Ps, Rs = _chain(tb)
    b = poisson.rhs(SIDE, device="cpu").numpy()
    got = tb.cpu_vcycle_solve(mats, Ps, Rs, b, tol=1e-9, check_every=1)
    want = jb.cpu_vcycle_solve(mats, Ps, Rs, b, tol=1e-9, check_every=1)
    assert got[1] == want[1] and 1 < got[1] < 100
    assert got[2] == want[2] and got[2] <= 1e-9
    np.testing.assert_array_equal(got[3], want[3])


def test_build_stencil_hierarchy_planes_bitwise(monkeypatch):
    """The port's host hierarchy takes the native RAP as JAX's does: every
    level's planes (f32) and the detected stencils bitwise at 127^2."""
    side = 127
    calls = []
    real = tb.galerkin_rap
    monkeypatch.setattr(tb, "galerkin_rap",
                        lambda *a: calls.append(1) or real(*a))
    t = tst.build_stencil_hierarchy(side, device="cpu")
    assert len(calls) == 5
    j = jst.build_stencil_hierarchy(side)
    assert t.n_levels == len(j.levels) == 6
    for l, lev in enumerate(j.levels):
        np.testing.assert_array_equal(getattr(t, f"c_{l}").numpy(),
                                      np.asarray(lev.c))
    assert list(t.w33s) == [lev.w33 for lev in j.levels]


def test_dist_setup_keeps_scipy(monkeypatch):
    """JAX's distributed setup takes scipy's products: so does the
    port's, even with the engine loaded."""
    from amg_tpu_torch.parallel import structured_dist as tsd

    def fail(*a, **k):
        raise AssertionError("the distributed setup took the native RAP")
    monkeypatch.setattr(tb, "galerkin_rap", fail)
    cfg, _, _ = tsd.build_dist_hierarchy(31, n_devices=4,
                                         dtype=torch.float64, device="cpu")
    assert cfg.n_devices == 4


def test_greedy_coloring_on_a_multicolor_gs_level():
    """greedy_coloring (native first, as JAX's) on a 63^2 Galerkin level
    under MulticolorGaussSeidel: JAX's colors, the Python loop's colors,
    and the smoother's color rows from them."""
    A = _chain(tb)[0][1]
    ell = ELL.from_scipy(A, dtype=torch.float64, device="cpu")
    jell = JELL.from_scipy(A, dtype=jnp.float64)
    cols, data = ell.cols.numpy(), ell.data.numpy()
    got = tcol.greedy_coloring(cols, data, ell.n_rows)
    want = jcol.greedy_coloring(np.asarray(jell.cols), np.asarray(jell.data),
                                jell.n_rows)
    np.testing.assert_array_equal(got, want)
    # the loop the port takes without the engine
    np.testing.assert_array_equal(
        tcol.greedy_coloring_loop(cols, data, ell.n_rows), got)
    state = tsm.MulticolorGaussSeidel().setup(ell)
    jstate = jsm.MulticolorGaussSeidel().setup(jell)
    assert len(state.rows) == int(want.max()) + 1
    for c, rows in enumerate(state.rows):
        np.testing.assert_array_equal(rows.numpy(),
                                      np.nonzero(want == c)[0])
    assert np.asarray(jstate.color_rows).shape[0] == len(state.rows)


def test_concurrent_builds_into_one_directory(tmp_path):
    """Two processes build the engine into one empty directory at once:
    both load it, and one library is left in place."""
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        from amg_tpu_torch.native import bindings
        bindings.BUILD_DIR = Path({str(tmp_path)!r})
        sys.stdin.readline()                  # start together
        ok = bindings.available()
        print("loaded" if ok else bindings.last_error())
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        p.stdin.write("\n")
        p.stdin.flush()
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "loaded", out + err
    assert len(list(tmp_path.glob("libamgcore_*.so"))) == 1
    assert not [f for f in os.listdir(tmp_path) if f.startswith("tmp")]


def test_failed_build_keeps_the_message(tmp_path):
    """With g++ present a source that does not compile leaves available()
    False, warns, and last_error() holds the compiler's message."""
    bad = tmp_path / "amgcore.cpp"
    bad.write_text("this is not C++\n")
    code = textwrap.dedent(f"""
        import warnings
        from pathlib import Path
        from amg_tpu_torch.native import bindings
        bindings.SRC = Path({str(bad)!r})
        bindings.BUILD_DIR = Path({str(tmp_path / 'build')!r})
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert not bindings.available()
        assert any("did not build" in str(x.message) for x in w)
        assert "g++ failed" in bindings.last_error(), bindings.last_error()
        assert bindings.greedy_coloring_native([[0]], [[1.0]], 1) is None
        print("kept")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "kept" in proc.stdout
    assert not list((tmp_path / "build").glob("*.so"))
