"""K4: the fused df32 residual + rss on packed fields (``csrc/packed_df.cu``).

Port of the TPU kernel ``amg_tpu/ops/pallas/packed_df.py``
``fused_df_residual_rss``: the pow2-weight TwoSum-cascade residual
r = b - A u in double-float32, writing only r.hi (the V-cycles smooth r.hi;
r.lo feeds only the rss) and sum(hi^2 + 2 hi lo) as an f64 value, in one
launch: the kernel's last block sums the per-block f64 partials in a fixed
order, picked by a ticket counter that each launch leaves at 0. The plain
version is ``sparse.packed._df_residual_pow2_packed`` followed by
``df_rss_fast``.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from amg_tpu_torch.ops.doublefloat import DF32, df_rss_fast, is_pow2_weights
from amg_tpu_torch.ops.kernels._build import (check, count_launch, library,
                                              require_f32, stream_of, weights)
from amg_tpu_torch.sparse.packed import _df_residual_pow2_packed


def df_residual_rss_plain(w33, b4_df: DF32, u4_df: DF32, m: int):
    r = _df_residual_pow2_packed(w33, b4_df, u4_df, m)
    return r.hi, df_rss_fast(r)


# (device index, raw stream) -> the kernel's ticket counter: one int32,
# zeroed once; each launch leaves it at 0, and launches on one stream are
# ordered, so they can share it
_COUNTERS: dict = {}


def new_counter(dev: torch.device) -> torch.Tensor:
    """A zeroed ticket counter for K4 on ``dev``."""
    return torch.zeros(1, dtype=torch.int32, device=dev)


def _counter(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    c = _COUNTERS.get(key)
    if c is None:
        c = _COUNTERS[key] = new_counter(dev)
    return c


@contextmanager
def stream_counter(dev: torch.device, stream: int, counter: torch.Tensor):
    """K4 launches on ``stream`` use ``counter`` while inside: a CUDA graph
    captured there keeps its own counter, made before the capture (one
    made inside would be a capture-pool allocation), which each replay of
    the graph finds at 0 and leaves at 0. The stream's own counter comes
    back after."""
    key = (dev.index, stream)
    old = _COUNTERS.get(key)
    _COUNTERS[key] = counter
    try:
        yield counter
    finally:
        if old is None:
            del _COUNTERS[key]
        else:
            _COUNTERS[key] = old


def fused_df_residual_rss(w33, b4_df: DF32, u4_df: DF32, m: int):
    """Returns ``(r4_hi, rss)``: the f32 (4, M, M) residual hi part and the
    rss as a 0-dim f64 tensor on the fields' device. Requires
    power-of-two weights."""
    if not is_pow2_weights(w33):
        raise ValueError("fused_df_residual_rss needs power-of-two weights "
                         "(2^k - 1 Poisson grids); use "
                         "sparse.packed.df_residual_const_packed")
    M = m + 1
    dev = u4_df.hi.device
    for name, t in (("b.hi", b4_df.hi), ("b.lo", b4_df.lo),
                    ("u.hi", u4_df.hi), ("u.lo", u4_df.lo)):
        require_f32(name, t, (4, M, M), dev)
    if dev.type == "cpu":
        return df_residual_rss_plain(w33, b4_df, u4_df, m)
    lib = library()
    stream = stream_of(u4_df.hi)
    r_hi = torch.empty_like(u4_df.hi)
    partials = torch.empty(lib.amg_df_block_count(M), dtype=torch.float64,
                           device=dev)
    rss = torch.empty((), dtype=torch.float64, device=dev)
    check(lib.amg_df_residual_rss(
        b4_df.hi.data_ptr(), b4_df.lo.data_ptr(), u4_df.hi.data_ptr(),
        u4_df.lo.data_ptr(), r_hi.data_ptr(), partials.data_ptr(),
        _counter(dev, stream).data_ptr(), rss.data_ptr(), M, weights(w33),
        stream), "amg_df_residual_rss")
    count_launch(fused_df_residual_rss)
    return r_hi, rss


fused_df_residual_rss.launches = 0
