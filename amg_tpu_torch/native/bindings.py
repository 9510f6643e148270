"""ctypes bindings of the native setup engine (``amgcore.cpp``).

Port of ``amg_tpu/native/bindings.py``: the same entry points, arguments
and results (scipy CSR matrices and numpy arrays; host code, no torch).
The library is built with g++ and JAX's flags (``-O3 -march=native
-shared -fPIC``), so one source gives the same bits on one machine, at
the first call, never at import. It goes to ``build/amg_tpu_torch/``
beside the package under a name that carries a hash of the source, the
flags and what ``-march=native`` means on this machine (g++'s expanded
target options), so a stale build, or one for another processor, is
never loaded. A build goes to a temporary
file that is moved into place whole: processes that build at once each
load a complete library.

Without g++ ``available()`` is False and the callers take scipy or numpy,
as in JAX. A build that fails where g++ is present is not silent: it
warns once, and ``last_error()`` holds the compiler's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "amgcore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "amg_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib = None
_tried = False
_error = None

_I8 = ctypes.POINTER(ctypes.c_int64)
_F8 = ctypes.POINTER(ctypes.c_double)


def _compiler() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ not found: the native setup engine "
                                "is not built, scipy and numpy are used")
    return gxx


def _library_path(gxx: str) -> Path:
    """The library's file: a hash of the source, the flags and the target
    options ``-march=native`` expands to here."""
    proc = subprocess.run([gxx, *CXX_FLAGS[:2], "-E", "-v", "-x", "c++",
                           os.devnull], capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S)
    target = [line for line in proc.stderr.splitlines() if " -march=" in line]
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update("\n".join(target).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libamgcore_{h.hexdigest()[:16]}.so"


def _build(gxx: str, so: Path) -> None:
    """g++ into a temporary file beside ``so``, then moved into place.
    Raises RuntimeError with the compiler's message."""
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        cmd = [gxx, *CXX_FLAGS, str(SRC), "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare(lib) -> None:
    lib.amg_spgemm_symbolic.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _I8, _I8, _I8, _I8, _I8]
    lib.amg_spgemm_numeric.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _I8, _I8, _F8, _I8, _I8, _F8,
        _I8, _I8, _F8]
    lib.amg_csr_transpose.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _I8, _I8, _F8, _I8, _I8, _F8]
    for void in (lib.amg_spgemm_symbolic, lib.amg_spgemm_numeric,
                 lib.amg_csr_transpose):
        void.restype = None
    lib.amg_greedy_color.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _I8, _F8, _I8]
    lib.amg_greedy_color.restype = ctypes.c_int64
    lib.amg_ell_pack.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _I8, _I8, _F8, ctypes.c_int64,
        _I8, _F8]
    lib.amg_ell_pack.restype = ctypes.c_int64
    lib.amg_seq_sgs_bench.argtypes = [
        ctypes.c_int64, _I8, _I8, _F8, _F8, _F8, ctypes.c_int64]
    lib.amg_seq_sgs_bench.restype = ctypes.c_double
    PI8 = ctypes.POINTER(_I8)
    PF8 = ctypes.POINTER(_F8)
    lib.amg_cpu_vcycle_solve.argtypes = [
        ctypes.c_int64, PI8, PI8, PF8, _I8, PI8, PI8, PF8, PI8, PI8,
        PF8, _F8, _F8, _F8, ctypes.c_double, ctypes.c_int64,
        ctypes.c_int64, _I8, _F8]
    lib.amg_cpu_vcycle_solve.restype = ctypes.c_double


def _load():
    """The library (built once per source hash), or None without one;
    the first call decides for the process."""
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            gxx = _compiler()
            so = _library_path(gxx)
            if not so.exists():
                _build(gxx, so)
            lib = ctypes.CDLL(str(so))
            _declare(lib)
        except FileNotFoundError as exc:
            _error = str(exc)
            return None
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            _error = str(exc)
            warnings.warn(f"the native setup engine did not build, scipy "
                          f"and numpy are used: {_error}", RuntimeWarning,
                          stacklevel=3)
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library is built and loaded (builds it at the first
    call)."""
    return _load() is not None


def last_error() -> str | None:
    """Why the library is not available: no g++, or the compiler's or the
    loader's message (None when it is, or before the first call)."""
    return _error


def _p(a, t):
    return a.ctypes.data_as(t)


def _csr_arrays(A):
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int64)
    data = np.ascontiguousarray(A.data, dtype=np.float64)
    return indptr, indices, data


def spgemm(A, B):
    """C = A @ B for scipy CSR inputs: the native two-pass SpGEMM, else
    scipy's product."""
    lib = _load()
    if lib is None:
        return (A @ B).tocsr()
    import scipy.sparse as sp

    n, k = A.shape
    k2, m = B.shape
    assert k == k2
    ai, aj, ad = _csr_arrays(A.tocsr())
    bi, bj, bd = _csr_arrays(B.tocsr())
    row_nnz = np.zeros(n, dtype=np.int64)
    lib.amg_spgemm_symbolic(n, m, _p(ai, _I8), _p(aj, _I8), _p(bi, _I8),
                            _p(bj, _I8), _p(row_nnz, _I8))
    c_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(row_nnz, out=c_indptr[1:])
    nnz = int(c_indptr[-1])
    c_indices = np.zeros(nnz, dtype=np.int64)
    c_data = np.zeros(nnz, dtype=np.float64)
    lib.amg_spgemm_numeric(n, m, _p(ai, _I8), _p(aj, _I8), _p(ad, _F8),
                           _p(bi, _I8), _p(bj, _I8), _p(bd, _F8),
                           _p(c_indptr, _I8), _p(c_indices, _I8),
                           _p(c_data, _F8))
    return sp.csr_matrix((c_data, c_indices, c_indptr), shape=(n, m))


def csr_transpose(A):
    """B = A^T for scipy CSR: the native counting transpose, else
    scipy's."""
    lib = _load()
    if lib is None:
        return A.T.tocsr()
    import scipy.sparse as sp

    n, m = A.shape
    ai, aj, ad = _csr_arrays(A.tocsr())
    nnz = len(aj)
    b_indptr = np.zeros(m + 1, dtype=np.int64)
    b_indices = np.zeros(nnz, dtype=np.int64)
    b_data = np.zeros(nnz, dtype=np.float64)
    lib.amg_csr_transpose(n, m, _p(ai, _I8), _p(aj, _I8), _p(ad, _F8),
                          _p(b_indptr, _I8), _p(b_indices, _I8),
                          _p(b_data, _F8))
    return sp.csr_matrix((b_data, b_indices, b_indptr), shape=(m, n))


def galerkin_rap(R, A, P):
    """A_H = R (A P) by two SpGEMMs (multigrid.hpp:219-223)."""
    return spgemm(R, spgemm(A, P))


def greedy_coloring_native(cols, data, n):
    """The greedy first-fit coloring over ELL arrays (n, K); None without
    the library (the caller takes the Python loop)."""
    lib = _load()
    if lib is None:
        return None
    cols64 = np.ascontiguousarray(cols, dtype=np.int64)
    data64 = np.ascontiguousarray(data, dtype=np.float64)
    K = cols64.shape[1] if cols64.ndim == 2 else 0
    colors = np.zeros(n, dtype=np.int64)
    lib.amg_greedy_color(n, K, _p(cols64, _I8), _p(data64, _F8),
                         _p(colors, _I8))
    return colors


def ell_pack(A, k_max=None):
    """CSR -> (data, cols) padded row panels of width ``k_max`` (None: the
    widest row); None without the library (the caller takes numpy).
    Raises ValueError if a row is wider than ``k_max``."""
    lib = _load()
    if lib is None:
        return None
    A = A.tocsr()
    n, m = A.shape
    deg = np.diff(A.indptr)
    K = int(deg.max()) if n else 1
    if k_max is None:
        k_max = max(K, 1)
    ai, aj, ad = _csr_arrays(A)
    cols = np.zeros((n, k_max), dtype=np.int64)
    data = np.zeros((n, k_max), dtype=np.float64)
    ret = lib.amg_ell_pack(n, m, _p(ai, _I8), _p(aj, _I8), _p(ad, _F8),
                           k_max, _p(cols, _I8), _p(data, _F8))
    if ret < 0:
        raise ValueError(f"k_max {k_max} too small; need {-ret}")
    return data, cols


def cpu_vcycle_solve(mats, Ps, Rs, b, tol=1e-9, check_every=5,
                     max_iters=100):
    """The single-thread C++ AMG solve, the reference's structure
    (multigrid.hpp:263-337): V-cycles with sequential symmetric GS, a
    dense LU on the coarsest level. ``mats``: the level matrices (scipy
    CSR, finest first); ``Ps`` / ``Rs``: the transfers (one fewer).
    Returns (seconds, iterations, rss, u), or None without the library."""
    lib = _load()
    if lib is None:
        return None
    L = len(mats)
    keep = []  # the contiguous arrays outlive the call

    def csr_ptrs(ms):
        iptr, idx, dat = [], [], []
        for M in ms:
            ai, aj, ad = _csr_arrays(M.tocsr())
            keep.extend((ai, aj, ad))
            iptr.append(_p(ai, _I8))
            idx.append(_p(aj, _I8))
            dat.append(_p(ad, _F8))
        return ((_I8 * len(ms))(*iptr), (_I8 * len(ms))(*idx),
                (_F8 * len(ms))(*dat))

    a_i, a_j, a_d = csr_ptrs(mats)
    p_i, p_j, p_d = csr_ptrs(Ps)
    r_i, r_j, r_d = csr_ptrs(Rs)
    level_n = np.asarray([M.shape[0] for M in mats], dtype=np.int64)
    lu = np.ascontiguousarray(mats[-1].toarray(), dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64)
    u = np.zeros(mats[0].shape[0], dtype=np.float64)
    iters_out = np.zeros(1, dtype=np.int64)
    rss_out = np.zeros(1, dtype=np.float64)
    secs = lib.amg_cpu_vcycle_solve(
        L, a_i, a_j, a_d, _p(level_n, _I8), p_i, p_j, p_d, r_i, r_j, r_d,
        _p(lu, _F8), _p(b, _F8), _p(u, _F8), tol, check_every, max_iters,
        _p(iters_out, _I8), _p(rss_out, _F8))
    return secs, int(iters_out[0]), float(rss_out[0]), u


def seq_sgs_bench(A, b, iters: int):
    """``iters`` sequential symmetric GS sweeps (the reference smoother's
    recurrence) from zero in native code: (seconds, u), or None without
    the library."""
    lib = _load()
    if lib is None:
        return None
    A = A.tocsr()
    n = A.shape[0]
    ai, aj, ad = _csr_arrays(A)
    u = np.zeros(n, dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64)
    secs = lib.amg_seq_sgs_bench(n, _p(ai, _I8), _p(aj, _I8), _p(ad, _F8),
                                 _p(u, _F8), _p(b, _F8), iters)
    return secs, u
