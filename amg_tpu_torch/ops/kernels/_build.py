"""Build and load the hand-written CUDA kernels of ``amg_tpu_torch/csrc``.

Each source is compiled by its own ``nvcc``, all started together, and the
objects are linked into one shared library with a plain C interface,
loaded with ``ctypes``: no PyTorch headers are compiled, so a build takes
seconds. The library goes to ``build/amg_tpu_torch/`` beside
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
import threading
import time
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

import torch

from amg_tpu_torch.utils import tracing

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "amg_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_W9 = ctypes.POINTER(ctypes.c_float)
# C entry points: (argtypes); each returns a cudaError_t as int
_SIGNATURES = {
    "amg_packed_sweep": (_P, _P, _P, _I, _W9, _F, _F, _I, _P),
    "amg_down_leg": (_P, _P, _P, _P, _I, _W9, _F, _F, _I, _P),
    "amg_up_leg": (_P, _P, _P, _P, _I, _W9, _F, _F, _I, _P),
    "amg_residual_restrict": (_P, _P, _P, _I, _W9, _P),
    "amg_packed_sweep_rm": (_P, _P, _P, _I, _W9, _F, _F, _I, _P),
    "amg_df_residual_rss": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _W9, _P),
    "amg_df_block_count": (_I,),
    "amg_rbgs_sweep_const": (_P, _P, _P, _I, _W9, _F, _F, _I, _P),
    "amg_rbgs_sweep_var": (_P, _P, _P, _P, _I, _F, _I, _P),
    "amg_masked_sweep_var": (_P, _P, _P, _P, _I, _F, _I, _P),
    "amg_halo_exchange": (_P,),      # csrc/halo.cu HaloCall, packed
    "amg_halo_exchange_peer": (_P,),             # HaloPeerCall, packed
    "amg_peer_alloc": (_I, ctypes.c_longlong, _P),
    "amg_peer_enable": (_I, _I),
    "amg_peer_free": (_I, _P),
    "amg_ipc_alloc": (_I, ctypes.c_longlong, _P, _P),
    "amg_ipc_open": (_I, _P, _P),
    "amg_ipc_close": (_I, _P),
    "amg_peer_collective": (_P,),   # csrc/peer_collective.cu, packed
    "amg_masked_down_leg": (_P,),   # csrc/masked_cycle.cu MaskedCall
    "amg_masked_up_leg": (_P,),
    # csrc/graph_loop.cu: the card, the pieces' graphs, the loop state,
    # the execs counts, the stream, then the outputs (graph, exec, failing
    # step)
    "amg_loop_graph": (_I,) + (_P,) * 14,
    "amg_loop_graph_launch": (_P, _P),
    "amg_loop_graph_destroy": (_P, _P),
    "amg_cuda_versions": (_P, _P),
    "amg_graph_node_types": (_P, _P, _I, _P),
    # the tracing stamps: the ring, its index and drop count, its records,
    # the stamp's code, the stream; the timer probe: out, steps, stream
    "amg_trace_stamp": (_P, _P, _I, ctypes.c_longlong, _P),
    "amg_timer_steps": (_P, _I, _P),
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


def compile_library(sources, out: Path) -> str:
    """Compile ``sources`` with one ``nvcc`` each, all at once, link the
    objects into the shared library ``out`` (moved into place whole) and
    return the commands, the time and the compilers' reports. Raises
    RuntimeError with nvcc's messages if a step fails."""
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [str(Path(tmp) / f"{p.stem}.o") for p in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)]
                for p, o in zip(sources, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        reports = [p.communicate() for p in procs]
        link = [nvcc, "-shared", "-o", str(Path(tmp) / "lib.so"), *objs]
        for cmd, proc, (_, err) in zip(cmds, procs, reports):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{err}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stderr}")
        os.replace(Path(tmp) / "lib.so", out)
    log = [f"seconds: {time.perf_counter() - t0:.2f} ({len(cmds)} nvcc in "
           f"parallel, then the link)"]
    for cmd, (so, se) in zip(cmds, reports):
        log.append(f"{' '.join(cmd)}\n{so}{se}")
    return "\n".join(log)


_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library. Threads
    of a card group that ask at once wait for one build (the others load
    what it built). The host span ``setup.kernels`` covers the build or
    the load."""
    with _BUILD_LOCK, tracing.setup_span("setup.kernels"):
        so = BUILD_DIR / f"libamg_kernels_{_digest()}.so"
        if not so.exists():
            log = compile_library(_sources(), so)
            (BUILD_DIR / f"{so.stem}.log").write_text(log)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib


_TALLY = threading.local()


@contextmanager
def capture_tally():
    """While a CUDA graph piece is captured on this thread, count_launch
    adds to the yielded Counter (by counter: a wrapper or a
    LaunchCounter) instead of the counters: those launches run at each
    replay of the piece, not now."""
    tally = Counter()
    _TALLY.tally = tally
    try:
        yield tally
    finally:
        _TALLY.tally = None


def count_launch(counter) -> None:
    """Add one to ``counter.launches`` (a kernel wrapper's count): one
    launch, counted exactly when the threads of a card group launch at
    once. Inside :func:`capture_tally` the launch is captured, not run:
    it goes to the tally."""
    tally = getattr(_TALLY, "tally", None)
    if tally is not None:
        tally[counter] += 1
        return
    with _COUNT_LOCK:
        counter.launches += 1


def credit(tally: Counter, runs: int) -> None:
    """Add ``runs`` replays of a captured piece's launches (its tally) to
    the counters."""
    with _COUNT_LOCK:
        for counter, n in tally.items():
            counter.launches += n * runs


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


def stream_of(t) -> int:
    """The raw handle of the current stream of CUDA tensor ``t``'s device
    (the capturing stream inside a CUDA graph capture), as the kernels'
    stream argument: one C call, no Stream object."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def require_f32(name: str, t, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous f32 tensor of ``shape`` on
    ``device`` (what the kernels, and so their wrappers, accept)."""
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
