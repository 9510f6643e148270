"""K4: the fused df32 residual + rss on packed fields (``csrc/packed_df.cu``).

Port of the TPU kernel ``amg_tpu/ops/pallas/packed_df.py``
``fused_df_residual_rss``: the pow2-weight TwoSum-cascade residual
r = b - A u in double-float32, writing only r.hi (the V-cycles smooth r.hi;
r.lo feeds only the rss) and per-block partials of sum(hi^2 + 2 hi lo),
which the wrapper sums in f64. The plain version is
``sparse.packed._df_residual_pow2_packed`` followed by ``df_rss_fast``.
"""

from __future__ import annotations

import torch

from amg_tpu_torch.ops.doublefloat import DF32, df_rss_fast, is_pow2_weights
from amg_tpu_torch.ops.kernels._build import (check, library, require_f32,
                                              stream_of, weights)
from amg_tpu_torch.sparse.packed import _df_residual_pow2_packed


def df_residual_rss_plain(w33, b4_df: DF32, u4_df: DF32, m: int):
    r = _df_residual_pow2_packed(w33, b4_df, u4_df, m)
    return r.hi, df_rss_fast(r)


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
    r_hi = torch.empty_like(u4_df.hi)
    partials = torch.empty(lib.amg_df_partials_count(M), dtype=torch.float32,
                           device=dev)
    check(lib.amg_df_residual(
        b4_df.hi.data_ptr(), b4_df.lo.data_ptr(), u4_df.hi.data_ptr(),
        u4_df.lo.data_ptr(), r_hi.data_ptr(), partials.data_ptr(), M,
        weights(w33), stream_of(r_hi)), "amg_df_residual")
    fused_df_residual_rss.launches += 1
    return r_hi, partials.to(torch.float64).sum()


fused_df_residual_rss.launches = 0
