"""K9: the fused four-color GS sweep on row-grouped fields
(``csrc/packed_sweep.cu`` ``amg_packed_sweep_rm``: K1's kernel on the
other layout).

Port of the TPU kernel ``amg_tpu/ops/pallas/packed_rm.py``
``fused_gs4_sweep_rm``: K1's sweep (``packed_rbgs.py``) on the (M, 4M)
row-grouped layout, whose row J holds the four quarters' row J side by
side. ``to_rm`` / ``from_rm`` convert from and to the (4, M, M) packed
layout, one copy each. The plain version is the packed sweep between the
two conversions. No solver calls it, in the JAX package or here.
"""

from __future__ import annotations

import torch

from amg_tpu_torch.ops.kernels._build import (check, count_launch, library,
                                              require_f32, stream_of, weights)
from amg_tpu_torch.sparse.packed import gs4_sweep_packed


def to_rm(u4: torch.Tensor) -> torch.Tensor:
    """(4, M, M) -> contiguous (M, 4M): row J holds all four quarters'
    row J."""
    _, M, _ = u4.shape
    return u4.permute(1, 0, 2).reshape(M, 4 * M).contiguous()


def from_rm(u_rm: torch.Tensor) -> torch.Tensor:
    """(M, 4M) -> contiguous (4, M, M)."""
    M = u_rm.shape[0]
    return u_rm.reshape(M, 4, M).permute(1, 0, 2).contiguous()


def fused_gs4_sweep_rm_plain(u_rm, b_rm, w33, m: int, omega: float = 1.0,
                             symmetric: bool = True) -> torch.Tensor:
    return to_rm(gs4_sweep_packed(from_rm(u_rm), from_rm(b_rm), w33, m,
                                  omega, symmetric))


def fused_gs4_sweep_rm(u_rm: torch.Tensor, b_rm: torch.Tensor, w33, m: int,
                       omega: float = 1.0, symmetric: bool = True
                       ) -> torch.Tensor:
    """One (symmetric) four-color GS sweep on contiguous f32 (M, 4M)
    row-grouped fields, M = m+1; returns a new field. CPU tensors take the
    plain version, CUDA tensors the kernel."""
    M = m + 1
    require_f32("u_rm", u_rm, (M, 4 * M), u_rm.device)
    require_f32("b_rm", b_rm, (M, 4 * M), u_rm.device)
    if u_rm.device.type == "cpu":
        return fused_gs4_sweep_rm_plain(u_rm, b_rm, w33, m, omega, symmetric)
    out = torch.empty_like(u_rm)   # out of place: ghosts read the input
    check(library().amg_packed_sweep_rm(
        u_rm.data_ptr(), b_rm.data_ptr(), out.data_ptr(), M, weights(w33),
        1.0 / w33[1][1], omega, int(symmetric), stream_of(u_rm)),
        "amg_packed_sweep_rm")
    count_launch(fused_gs4_sweep_rm)
    return out


fused_gs4_sweep_rm.launches = 0
