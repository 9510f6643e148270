"""K5 and K6: the fused four-color GS sweep on unpacked (n, n) fields
(``csrc/rbgs_sweep.cu`` K5, constant; ``csrc/rbgs_var.cu`` K6,
variable-coefficient); K12, the masked sweep on planes in K6's block.

Port of the TPU kernel ``amg_tpu/ops/pallas/rbgs.py`` ``fused_gs4_sweep``
(``pallas_call`` at :544 const, :584 var): the whole (symmetric) sweep, 8
color steps, in one launch. The TPU kernel works on a padded frame
(``PaddedStencil``: G1 ghost rows, lane-padded columns, identity-diagonal
padding planes); the card needs none of it, so the operand is the level's
own ``Stencil2D`` -- its static ``w33`` (K5) or its contiguous (3,3,n,n)
planes viewed as (9, n, n) (K6) -- and the fields stay (n, n).

The plain version, :func:`fused_gs4_sweep_plain`, is the kernels'
arithmetic with tensor ops on full fields. It is not
``sparse.stencil.gs4_sweep_masked``, which computes (b - A u) / diag with
the diagonal inside the sum and so rounds differently.

K12, :func:`masked_gs4_sweep_var` (``csrc/rbgs_var.cu``
``masked_var_sweep_kernel``; the port's own kernel, no TPU kernel: JAX
sweeps these levels with plain ``jnp`` ops), is K6's block with that
masked sweep's arithmetic: its plain version is ``gs4_sweep_masked`` with
parity masks, whose bits it gives.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from amg_tpu_torch.ops.kernels._build import (LaunchCounter, check,
                                              count_launch, library,
                                              require_f32, stream_of, weights)
from amg_tpu_torch.sparse.stencil import (FOUR_COLORS, Stencil2D,
                                          color_masks_iota, gs4_sweep_masked)

# K6's off-diagonal order (rbgs.py _OFFSETS): dj outer, di inner.
OFFSETS = tuple((dj, di) for dj in (-1, 0, 1) for di in (-1, 0, 1)
                if (dj, di) != (0, 0))


def fused_gs4_sweep_plain(S: Stencil2D, u2: torch.Tensor, b2: torch.Tensor,
                          omega: float = 1.0, symmetric: bool = True
                          ) -> torch.Tensor:
    """One (symmetric) four-color GS sweep in the kernels' operation order,
    any dtype: per color step, the off-diagonal sum (constant: di outer, dj
    inner, zero weights skipped; variable: OFFSETS order), then
    delta = (b - acc) * inv_diag - u and u + omega * delta on the color's
    cells. Neighbours outside the grid read 0."""
    n = S.side
    j = torch.arange(n, device=u2.device).reshape(n, 1) % 2
    i = torch.arange(n, device=u2.device).reshape(1, n) % 2
    if S.w33 is not None:
        w33 = S.w33
        terms = [((dj, di), w33[dj + 1][di + 1]) for di in (-1, 0, 1)
                 for dj in (-1, 0, 1)
                 if (dj, di) != (0, 0) and w33[dj + 1][di + 1] != 0.0]
        inv_diag = 1.0 / w33[1][1]
    else:
        terms = [((dj, di), S.c[dj + 1, di + 1]) for dj, di in OFFSETS]
        inv_diag = 1.0 / S.c[1, 1]
    order = list(FOUR_COLORS)
    if symmetric:
        order = order + order[::-1]
    for pj, pi in order:
        up = F.pad(u2, (1, 1, 1, 1))
        acc = torch.zeros_like(u2)
        for (dj, di), w in terms:
            acc = acc + w * up[1 + dj:1 + dj + n, 1 + di:1 + di + n]
        delta = (b2 - acc) * inv_diag - u2
        u2 = torch.where((j == pj) & (i == pi), u2 + omega * delta, u2)
    return u2


def fused_gs4_sweep(S: Stencil2D, u2: torch.Tensor, b2: torch.Tensor,
                    omega: float = 1.0, symmetric: bool = True
                    ) -> torch.Tensor:
    """One (symmetric) four-color GS sweep of the operator ``S`` on
    contiguous f32 (n, n) fields; returns a new field. CPU tensors take the
    plain version; CUDA tensors launch K5 (``S.w33`` set) or K6 (planes)."""
    n = S.side
    require_f32("u2", u2, (n, n), u2.device)
    require_f32("b2", b2, (n, n), u2.device)
    if S.w33 is None:
        require_f32("planes", S.c, (3, 3, n, n), u2.device)
    if u2.device.type == "cpu":
        return fused_gs4_sweep_plain(S, u2, b2, omega, symmetric)
    out = torch.empty_like(u2)   # out of place: ghosts read the input
    if S.w33 is not None:
        check(library().amg_rbgs_sweep_const(
            u2.data_ptr(), b2.data_ptr(), out.data_ptr(), n, weights(S.w33),
            1.0 / S.w33[1][1], omega, int(symmetric), stream_of(u2)),
            "amg_rbgs_sweep_const")
        count_launch(fused_gs4_sweep_const)
    else:
        check(library().amg_rbgs_sweep_var(
            u2.data_ptr(), b2.data_ptr(), S.c.data_ptr(), out.data_ptr(), n,
            omega, int(symmetric), stream_of(u2)), "amg_rbgs_sweep_var")
        count_launch(fused_gs4_sweep_var)
    return out


def masked_gs4_sweep_var(S: Stencil2D, u2: torch.Tensor, b2: torch.Tensor,
                         omega: float = 1.0, symmetric: bool = True
                         ) -> torch.Tensor:
    """One (symmetric) four-color masked GS sweep of the planes of ``S`` on
    contiguous f32 (n, n) fields; returns a new field. CPU tensors take
    ``gs4_sweep_masked`` with ``color_masks_iota``; CUDA tensors launch K12,
    which gives its bits."""
    n = S.side
    if S.c is None or S.w33 is not None:
        raise ValueError("masked_gs4_sweep_var sweeps an operator given by "
                         "its planes alone (w33 None)")
    require_f32("u2", u2, (n, n), u2.device)
    require_f32("b2", b2, (n, n), u2.device)
    require_f32("planes", S.c, (3, 3, n, n), u2.device)
    if u2.device.type == "cpu":
        return gs4_sweep_masked(S, u2, b2,
                                color_masks_iota(n, u2.dtype, u2.device),
                                omega, symmetric)
    out = torch.empty_like(u2)   # out of place: ghosts read the input
    check(library().amg_masked_sweep_var(
        u2.data_ptr(), b2.data_ptr(), S.c.data_ptr(), out.data_ptr(), n,
        omega, int(symmetric), stream_of(u2)), "amg_masked_sweep_var")
    count_launch(masked_gs4_sweep_var)
    return out


fused_gs4_sweep_const = LaunchCounter("fused_gs4_sweep_const")   # K5
fused_gs4_sweep_var = LaunchCounter("fused_gs4_sweep_var")       # K6
masked_gs4_sweep_var.launches = 0                                # K12
