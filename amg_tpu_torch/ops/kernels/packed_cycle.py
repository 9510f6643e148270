"""K2, K3 and K8: the fused V-cycle legs and the fused residual +
restriction on packed fields (``csrc/packed_cycle.cu``).

Port of the TPU kernels ``amg_tpu/ops/pallas/packed_cycle.py``
``fused_down_leg_packed`` (pre-sweep + residual + full-weighting
restriction), ``fused_up_leg_packed`` (bilinear prolongation correction
+ post-sweep) and ``fused_residual_restrict_packed`` (residual +
restriction, the down half of a split level), each one pass over the
fields. The plain versions are built from ``sparse.packed``: sweep ->
residual_packed -> restrict_packed for the down leg, prolong_add_packed ->
sweep for the up leg, residual_packed -> restrict_packed for K8.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from amg_tpu_torch.ops.kernels._build import (check, count_launch, library,
                                              require_f32, stream_of, weights)
from amg_tpu_torch.sparse.packed import (gs4_sweep_packed,
                                         prolong_add_packed, residual_packed,
                                         restrict_packed)


def down_leg_plain(u4, b4, w33, m: int, omega: float = 1.0,
                   symmetric: bool = True):
    u4 = gs4_sweep_packed(u4, b4, w33, m, omega, symmetric)
    bc = restrict_packed(residual_packed(u4, b4, w33, m), m)
    return u4, F.pad(bc, (0, 1, 0, 1))


def up_leg_plain(u4, b4, uc_pad, w33, m: int, omega: float = 1.0,
                 symmetric: bool = True):
    u4 = prolong_add_packed(u4, uc_pad[:m, :m], m)
    return gs4_sweep_packed(u4, b4, w33, m, omega, symmetric)


def residual_restrict_plain(u4, b4, w33, m: int):
    return F.pad(restrict_packed(residual_packed(u4, b4, w33, m), m),
                 (0, 1, 0, 1))


def fused_down_leg_packed(u4: torch.Tensor, b4: torch.Tensor, w33, m: int,
                          omega: float = 1.0, symmetric: bool = True):
    """Pre-smooth + residual + restrict in one pass. Returns
    ``(u4_smoothed, bc_pad)``, ``bc_pad`` the (M, M) coarse rhs with a zero
    pad row and column (slice ``[:m, :m]``)."""
    M = m + 1
    require_f32("u4", u4, (4, M, M), u4.device)
    require_f32("b4", b4, (4, M, M), u4.device)
    if u4.device.type == "cpu":
        return down_leg_plain(u4, b4, w33, m, omega, symmetric)
    u_out = torch.empty_like(u4)
    bc_pad = torch.empty((M, M), dtype=u4.dtype, device=u4.device)
    check(library().amg_down_leg(
        u4.data_ptr(), b4.data_ptr(), u_out.data_ptr(), bc_pad.data_ptr(), M,
        weights(w33), 1.0 / w33[1][1], omega, int(symmetric),
        stream_of(u4)), "amg_down_leg")
    count_launch(fused_down_leg_packed)
    return u_out, bc_pad


def fused_up_leg_packed(u4: torch.Tensor, b4: torch.Tensor,
                        uc_pad: torch.Tensor, w33, m: int,
                        omega: float = 1.0, symmetric: bool = True
                        ) -> torch.Tensor:
    """Prolongation correction + post-smooth in one pass. ``uc_pad`` is the
    (M, M) coarse solution with a zero pad row and column."""
    M = m + 1
    require_f32("u4", u4, (4, M, M), u4.device)
    require_f32("b4", b4, (4, M, M), u4.device)
    require_f32("uc_pad", uc_pad, (M, M), u4.device)
    if u4.device.type == "cpu":
        return up_leg_plain(u4, b4, uc_pad, w33, m, omega, symmetric)
    u_out = torch.empty_like(u4)
    check(library().amg_up_leg(
        u4.data_ptr(), b4.data_ptr(), uc_pad.data_ptr(), u_out.data_ptr(), M,
        weights(w33), 1.0 / w33[1][1], omega, int(symmetric),
        stream_of(u4)), "amg_up_leg")
    count_launch(fused_up_leg_packed)
    return u_out


def fused_residual_restrict_packed(u4: torch.Tensor, b4: torch.Tensor, w33,
                                   m: int) -> torch.Tensor:
    """Residual + restriction in one pass over u and b. Returns the (M, M)
    coarse rhs ``bc_pad`` with a zero pad row and column (slice
    ``[:m, :m]``)."""
    M = m + 1
    require_f32("u4", u4, (4, M, M), u4.device)
    require_f32("b4", b4, (4, M, M), u4.device)
    if u4.device.type == "cpu":
        return residual_restrict_plain(u4, b4, w33, m)
    bc_pad = torch.empty((M, M), dtype=u4.dtype, device=u4.device)
    check(library().amg_residual_restrict(
        u4.data_ptr(), b4.data_ptr(), bc_pad.data_ptr(), M, weights(w33),
        stream_of(u4)), "amg_residual_restrict")
    count_launch(fused_residual_restrict_packed)
    return bc_pad


fused_down_leg_packed.launches = 0
fused_up_leg_packed.launches = 0
fused_residual_restrict_packed.launches = 0
