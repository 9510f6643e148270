"""Build and load the hand-written CUDA kernels of ``amg_tpu_torch/csrc``.

The sources are compiled with ``nvcc`` into one shared library with a plain
C interface, loaded with ``ctypes``: no PyTorch headers are compiled, so a
build takes seconds. The library goes to ``build/amg_tpu_torch/`` beside
the package, under a name that carries a hash of the sources and flags, so
a stale build is never loaded. Nothing is built when the package is
imported: the first kernel launch calls :func:`library`.

Flags: ``sm_90a`` (Hopper), ``-O3``, no fast math, and ``-fmad=false`` so
that no product is contracted into an FMA. The kernels then round every
operation as the plain PyTorch versions do, and the df32 TwoSum cascade
of ``packed_df.cu`` stays exact.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "amg_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_W9 = ctypes.POINTER(ctypes.c_float)
_PP = ctypes.POINTER(ctypes.c_void_p)
_LL = ctypes.c_longlong
# C entry points: (argtypes); each returns a cudaError_t as int
_SIGNATURES = {
    "amg_packed_sweep": (_P, _P, _P, _I, _W9, _F, _F, _I, _P),
    "amg_down_leg": (_P, _P, _P, _P, _I, _W9, _F, _F, _I, _P),
    "amg_up_leg": (_P, _P, _P, _P, _I, _W9, _F, _F, _I, _P),
    "amg_df_residual": (_P, _P, _P, _P, _P, _P, _I, _W9, _P),
    "amg_df_partials_count": (_I,),
    "amg_rbgs_sweep_const": (_P, _P, _P, _I, _W9, _F, _F, _I, _P),
    "amg_rbgs_sweep_var": (_P, _P, _P, _P, _I, _F, _I, _P),
    "amg_halo_exchange": (_PP, _I, _LL, _PP, _I, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels of amg_tpu_torch need it to build")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libamg_kernels_{_digest()}.so"
    if not so.exists():
        nvcc = _nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        (BUILD_DIR / f"{so.stem}.log").write_text(
            f"{' '.join(cmd)}\nseconds: {time.perf_counter() - t0:.2f}\n"
            f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def build_log() -> str:
    """nvcc's command, time and ptxas report of the loaded library's build
    ('' when it was built by an earlier process)."""
    log = BUILD_DIR / f"libamg_kernels_{_digest()}.log"
    return log.read_text() if log.exists() else ""


class LaunchCounter:
    """The launch count of a kernel whose wrapper serves more than one
    kernel (a one-kernel wrapper carries its own ``launches``)."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def weights(w33) -> ctypes.Array:
    """w33 rounded to f32 (row-major), as the kernels' argument."""
    return (ctypes.c_float * 9)(*(float(w) for row in w33 for w in row))


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_f32(name: str, t, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous f32 tensor of ``shape`` on
    ``device`` (what the kernels, and so their wrappers, accept)."""
    import torch

    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
