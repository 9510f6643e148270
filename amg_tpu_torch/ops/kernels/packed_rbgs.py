"""K1: the fused four-color GS sweep on packed fields (``csrc/packed_sweep.cu``).

Port of the TPU kernels ``amg_tpu/ops/pallas/packed_rbgs.py``
``fused_gs4_sweep_packed`` and ``fused_gs4_sweep_packed_2d``: the whole
(symmetric) sweep, 8 color steps, in one pass over u and b, with 2-D tiles
and a ghost ring held in shared memory. The plain version is
``sparse.packed.gs4_sweep_packed``.
"""

from __future__ import annotations

import torch

from amg_tpu_torch.ops.kernels._build import (check, count_launch, library,
                                              require_f32, stream_of, weights)
from amg_tpu_torch.sparse.packed import gs4_sweep_packed


def fused_gs4_sweep_packed(u4: torch.Tensor, b4: torch.Tensor, w33, m: int,
                           omega: float = 1.0, symmetric: bool = True
                           ) -> torch.Tensor:
    """One (symmetric) four-color GS sweep on contiguous f32 (4, M, M)
    packed fields, M = m+1; returns a new field. CPU tensors take the
    plain version, CUDA tensors the kernel."""
    M = m + 1
    require_f32("u4", u4, (4, M, M), u4.device)
    require_f32("b4", b4, (4, M, M), u4.device)
    if u4.device.type == "cpu":
        return gs4_sweep_packed(u4, b4, w33, m, omega, symmetric)
    out = torch.empty_like(u4)   # out of place: ghosts read the input
    check(library().amg_packed_sweep(
        u4.data_ptr(), b4.data_ptr(), out.data_ptr(), M, weights(w33),
        1.0 / w33[1][1], omega, int(symmetric), stream_of(u4)),
        "amg_packed_sweep")
    count_launch(fused_gs4_sweep_packed)
    return out


fused_gs4_sweep_packed.launches = 0
