"""Color-packed four-color Gauss-Seidel pipeline, as plain PyTorch ops.

PyTorch port of ``amg_tpu/sparse/packed.py:39-364``. These
functions are the CPU path of the solver, the plain versions the CUDA
kernels of ``amg_tpu_torch/ops/kernels`` are checked against, and the ops
of the packed levels below the kernels' threshold on the GPU.

Layout: n = 2m+1 (odd interior sides), M = m+1. Quarter q[pj][pi] =
``u4[2*pj + pi]`` holds the real points (2J+pj, 2I+pi); all four are padded
to (M, M): q00 is full, q01 has one zero pad column, q10 one pad row, q11
both. Pad cells stay exactly zero (updates are masked), which doubles as
the Dirichlet zero boundary.

Neighbor algebra: for target color (pj, pi) and offset (dj, di), the
source color is b = ((pj+dj) mod 2, (pi+di) mod 2) and the source index
shift is s = ((pj+dj-bj)//2, (pi+di-bi)//2) in {-1,0,1}^2: a unit-stride
shifted read of one quarter, zero outside.

The functions are pure: they return new tensors and leave their inputs
untouched (the sweeps clone once, then update quarters in place).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from amg_tpu_torch.ops.doublefloat import (DF32, df_add, df_mul, df_neg,
                                           is_pow2_weights, two_sum)

# color order must match sparse/stencil.py FOUR_COLORS (and its reverse for
# the symmetric sweep) so iterates agree with the masked path
COLORS = ((0, 0), (0, 1), (1, 0), (1, 1))


def pack(u2: torch.Tensor, m: int) -> torch.Tensor:
    """(n, n) field with n = 2m+1 -> contiguous (4, M, M) color-packed."""
    if u2.shape[-1] != 2 * m + 1:
        raise ValueError(f"pack expects an odd ({2*m+1})-sided field, "
                         f"got {tuple(u2.shape)}")
    M = m + 1
    u2p = F.pad(u2, (0, 1, 0, 1))        # (2M, 2M); pad row/col -> zeros
    return u2p.reshape(M, 2, M, 2).permute(1, 3, 0, 2).reshape(4, M, M)


def unpack(u4: torch.Tensor, m: int) -> torch.Tensor:
    """(4, M, M) color-packed -> (n, n), n = 2m+1 (inverse of pack; a
    strided view)."""
    M = m + 1
    n = 2 * m + 1
    u2p = u4.reshape(2, 2, M, M).permute(2, 0, 3, 1).reshape(2 * M, 2 * M)
    return u2p[:n, :n]


def _shift(q: torch.Tensor, sJ: int, sI: int) -> torch.Tensor:
    """out[..., J, I] = q[..., J+sJ, I+sI], zero outside (sJ, sI in
    {-1,0,1})."""
    if sJ == 0 and sI == 0:
        return q
    M, N = q.shape[-2:]
    qp = F.pad(q, (1, 1, 1, 1))
    return qp[..., 1 + sJ:1 + sJ + M, 1 + sI:1 + sI + N]


def _valid(pj: int, pi: int, m: int, dtype, device=None) -> torch.Tensor:
    """(M, M) 0/1 mask of the real cells of quarter (pj, pi)."""
    M = m + 1
    J = torch.arange(M, device=device).reshape(M, 1)
    I = torch.arange(M, device=device).reshape(1, M)
    Mj = M if pj == 0 else m
    Mi = M if pi == 0 else m
    return ((J < Mj) & (I < Mi)).to(dtype)


def _neighbors(pj: int, pi: int):
    """Static (weight-index, source-quarter, shift) list for one color."""
    out = []
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            if dj == 0 and di == 0:
                continue
            bj = (pj + dj) % 2
            bi = (pi + di) % 2
            sJ = (pj + dj - bj) // 2
            sI = (pi + di - bi) // 2
            out.append(((dj + 1, di + 1), 2 * bj + bi, (sJ, sI)))
    return out


def _acc(u4, w33, pj: int, pi: int):
    """Off-diagonal stencil accumulation at the (pj, pi) points."""
    acc = torch.zeros_like(u4[0])
    for (wj, wi), src, (sJ, sI) in _neighbors(pj, pi):
        w = w33[wj][wi]
        if w == 0.0:
            continue
        acc = acc + w * _shift(u4[src], sJ, sI)
    return acc


def gs4_sweep_packed(u4: torch.Tensor, b4: torch.Tensor, w33, m: int,
                     omega: float = 1.0, symmetric: bool = True
                     ) -> torch.Tensor:
    """One (symmetric) four-color GS sweep on packed fields: the iterates
    of gs4_sweep_masked on the unpacked field at 1/4 the stencil work."""
    inv_diag = 1.0 / w33[1][1]
    order = list(COLORS)
    if symmetric:
        order = order + order[::-1]
    u4 = u4.clone()
    for pj, pi in order:
        a = 2 * pj + pi
        acc = _acc(u4, w33, pj, pi)
        delta = (b4[a] - acc) * inv_diag - u4[a]
        mask = _valid(pj, pi, m, u4.dtype, u4.device)
        u4[a] = u4[a] + (omega * mask) * delta
    return u4


def pack_rect(u2: torch.Tensor, m: int) -> torch.Tensor:
    """(..., R, n) row slabs, R even and n = 2m+1 -> (4, ..., R/2, M)
    color-packed: the distributed form, where a slab keeps its own (even)
    row count and its columns span the grid side. Leading axes (the slabs)
    go between the color axis and the quarter, so ``u4[a]`` is every
    slab's quarter a."""
    R, n = u2.shape[-2:]
    if R % 2 or n != 2 * m + 1:
        raise ValueError(f"pack_rect expects even rows and side {2*m+1}, "
                         f"got {tuple(u2.shape)}")
    M = m + 1
    lead = u2.shape[:-2]
    k = len(lead)
    u2p = F.pad(u2, (0, 1))                        # (..., R, 2M)
    v = u2p.reshape(*lead, R // 2, 2, M, 2)        # (..., J, pj, I, pi)
    v = v.permute(k + 1, k + 3, *range(k), k, k + 2)
    return v.reshape(4, *lead, R // 2, M)


def unpack_rect(u4: torch.Tensor, m: int) -> torch.Tensor:
    """(4, ..., R/2, M) color-packed slabs -> (..., R, n) (inverse of
    pack_rect; a strided view)."""
    R2, M = u4.shape[-2:]
    lead = u4.shape[1:-2]
    k = len(lead)
    v = u4.reshape(2, 2, *lead, R2, M)             # (pj, pi, ..., J, I)
    v = v.permute(*range(2, k + 2), k + 2, 0, k + 3, 1)
    return v.reshape(*lead, 2 * R2, 2 * M)[..., :2 * m + 1]


def packed_steps_window(w33, u4, b4, row0_g, side: int, sweeps: int,
                        omega: float, symmetric: bool) -> torch.Tensor:
    """Color-packed GS steps on row windows (the packed form of
    structured_dist._masked_steps_const): quarter cell (a = 2pj+pi, J, I)
    of a window is global point (row0_g + 2J + pj, 2I + pi); points outside
    [0, side)^2 never update, and the rows near the window edges go
    invalid, for the caller's ghost margin to discard. ``row0_g`` is an int
    or a tensor that broadcasts against the (..., R/2, M) quarters (one
    offset a slab), and even, so that local parity is global parity."""
    R2, M = u4.shape[-2:]
    inv_diag = 1.0 / w33[1][1]
    iJ = torch.arange(R2, device=u4.device).reshape(R2, 1)
    iI = torch.arange(M, device=u4.device).reshape(1, M)
    order = list(COLORS)
    if symmetric:
        order = order + order[::-1]
    u4 = u4.clone()
    for _ in range(sweeps):
        for pj, pi in order:
            a = 2 * pj + pi
            row_g = row0_g + 2 * iJ + pj
            valid = (row_g >= 0) & (row_g < side) & (2 * iI + pi < side)
            acc = _acc(u4, w33, pj, pi)
            delta = (b4[a] - acc) * inv_diag - u4[a]
            u4[a] = u4[a] + torch.where(valid, omega * delta, 0.0)
    return u4


def residual_packed(u4: torch.Tensor, b4: torch.Tensor, w33, m: int
                    ) -> torch.Tensor:
    """r = b - A u, color-packed (pad cells carry zero residual)."""
    w_c = w33[1][1]
    r4 = torch.zeros_like(u4)
    for pj, pi in COLORS:
        a = 2 * pj + pi
        acc = _acc(u4, w33, pj, pi) + w_c * u4[a]
        mask = _valid(pj, pi, m, u4.dtype, u4.device)
        r4[a] = mask * (b4[a] - acc)
    return r4


def restrict_packed(r4: torch.Tensor, m: int) -> torch.Tensor:
    """Full-weighting restriction from the packed fine residual to the
    dense (m, m) coarse field (coarse (J, I) sits at fine (2J+1, 2I+1))."""
    r00, r01, r10, r11 = r4[0], r4[1], r4[2], r4[3]
    c = r11[:m, :m]
    c = c + 0.5 * (r01[:m, :m] + r01[1:m + 1, :m]
                   + r10[:m, :m] + r10[:m, 1:m + 1])
    c = c + 0.25 * (r00[:m, :m] + r00[:m, 1:m + 1]
                    + r00[1:m + 1, :m] + r00[1:m + 1, 1:m + 1])
    return c


def prolong_add_packed(u4: torch.Tensor, uc: torch.Tensor, m: int
                       ) -> torch.Tensor:
    """u4 + P uc for the bilinear P (coarse side m), color-packed: each
    quarter's correction is a sum of <= 4 unit-shifted coarse reads."""
    M = m + 1
    U = torch.zeros((M, M), dtype=uc.dtype, device=uc.device)
    U[:m, :m] = uc
    c11 = U
    c01 = 0.5 * (_shift(U, -1, 0) + U)
    c10 = 0.5 * (_shift(U, 0, -1) + U)
    c00 = 0.25 * (_shift(U, -1, -1) + _shift(U, -1, 0)
                  + _shift(U, 0, -1) + U)
    u4 = u4.clone()
    for a, corr, (pj, pi) in ((0, c00, (0, 0)), (1, c01, (0, 1)),
                              (2, c10, (1, 0)), (3, c11, (1, 1))):
        u4[a] = u4[a] + _valid(pj, pi, m, u4.dtype, u4.device) * corr
    return u4


def pack_planes(c: torch.Tensor, m: int) -> torch.Tensor:
    """(3,3,n,n) coefficient planes -> (3,3,4,M,M) color-packed:
    ``cp[dj+1, di+1, a]`` holds the (dj, di) coefficient at the color-a
    target points. The planes do not change during a solve, so the solver
    packs them once, when the hierarchy is built."""
    return torch.stack([torch.stack([pack(c[dj, di], m) for di in range(3)])
                        for dj in range(3)])


def _packed_inv_diag(diag: torch.Tensor) -> torch.Tensor:
    """1/diag with 0 where diag is 0 (the pad cells of a packed plane)."""
    nz = diag != 0
    one = torch.ones((), dtype=diag.dtype, device=diag.device)
    return torch.where(nz, 1.0 / torch.where(nz, diag, one),
                       torch.zeros((), dtype=diag.dtype, device=diag.device))


def gs4_sweep_packed_var(cp: torch.Tensor, u4: torch.Tensor,
                         b4: torch.Tensor, m: int, omega: float = 1.0,
                         symmetric: bool = True) -> torch.Tensor:
    """Variable-coefficient packed GS sweep: gs4_sweep_packed with the
    weights read from packed planes (pack_planes)."""
    order = list(COLORS)
    if symmetric:
        order = order + order[::-1]
    u4 = u4.clone()
    for pj, pi in order:
        a = 2 * pj + pi
        acc = torch.zeros_like(u4[a])
        for (wj, wi), src, (sJ, sI) in _neighbors(pj, pi):
            acc = acc + cp[wj, wi, a] * _shift(u4[src], sJ, sI)
        delta = (b4[a] - acc) * _packed_inv_diag(cp[1, 1, a]) - u4[a]
        mask = _valid(pj, pi, m, u4.dtype, u4.device)
        u4[a] = u4[a] + (omega * mask) * delta
    return u4


def residual_packed_var(cp: torch.Tensor, u4: torch.Tensor,
                        b4: torch.Tensor, m: int) -> torch.Tensor:
    """r = b - A u, color-packed, variable coefficients (pad cells carry
    zero residual)."""
    r4 = torch.zeros_like(u4)
    for pj, pi in COLORS:
        a = 2 * pj + pi
        acc = cp[1, 1, a] * u4[a]
        for (wj, wi), src, (sJ, sI) in _neighbors(pj, pi):
            acc = acc + cp[wj, wi, a] * _shift(u4[src], sJ, sI)
        mask = _valid(pj, pi, m, u4.dtype, u4.device)
        r4[a] = mask * (b4[a] - acc)
    return r4


def _df_residual_pow2_packed(w33, b4_df: DF32, u4_df: DF32, m: int) -> DF32:
    """Pow2-weight form of df_residual_const_packed: every nonzero weight
    is +/-2^j, so w * x is exact in f32 and the df32 accumulation is a
    TwoSum cascade (centre term first, then the _neighbors order); the lo
    components run in plain f32."""
    r_hi, r_lo = [], []
    for pj, pi in COLORS:
        a = 2 * pj + pi
        terms = [((1, 1), a, (0, 0))] + _neighbors(pj, pi)
        s = b4_df.hi[a]
        c = b4_df.lo[a]          # lo parts + accumulated roundoff
        for (wj, wi), src, (sJ, sI) in terms:
            w = w33[wj][wi]
            if w == 0.0:
                continue
            wf = -w                                  # exact in f32 (pow2)
            t = wf * _shift(u4_df.hi[src], sJ, sI)   # exact (pow2 w)
            s, e = two_sum(s, t)
            c = c + e + wf * _shift(u4_df.lo[src], sJ, sI)
        hi, lo = two_sum(s, c)
        mask = _valid(pj, pi, m, u4_df.hi.dtype, u4_df.hi.device)
        r_hi.append(mask * hi)
        r_lo.append(mask * lo)
    return DF32(hi=torch.stack(r_hi), lo=torch.stack(r_lo))


def df_residual_const_packed(w33, b4_df: DF32, u4_df: DF32, m: int) -> DF32:
    """r = b - A u in double-float32 on color-packed fields (constant
    stencil). Weights enter as exact (hi, lo) f32 pairs; pow2 weights take
    the TwoSum-cascade form."""
    if is_pow2_weights(w33):
        return _df_residual_pow2_packed(w33, b4_df, u4_df, m)

    dev = u4_df.hi.device
    r_hi, r_lo = [], []
    for pj, pi in COLORS:
        a = 2 * pj + pi
        acc = DF32.from_f32(torch.zeros_like(u4_df.hi[a]))
        terms = [((1, 1), a, (0, 0))] + _neighbors(pj, pi)
        for (wj, wi), src, (sJ, sI) in terms:
            w = w33[wj][wi]
            if w == 0.0:
                continue
            w_hi = float(np.float32(w))
            w_lo = float(np.float32(w - w_hi))
            x = DF32(hi=_shift(u4_df.hi[src], sJ, sI),
                     lo=_shift(u4_df.lo[src], sJ, sI))
            wdf = DF32(hi=torch.tensor(w_hi, dtype=torch.float32, device=dev),
                       lo=torch.tensor(w_lo, dtype=torch.float32, device=dev))
            acc = df_add(acc, df_mul(wdf, x))
        r = df_add(DF32(hi=b4_df.hi[a], lo=b4_df.lo[a]), df_neg(acc))
        mask = _valid(pj, pi, m, u4_df.hi.dtype, u4_df.hi.device)
        r_hi.append(mask * r.hi)
        r_lo.append(mask * r.lo)
    return DF32(hi=torch.stack(r_hi), lo=torch.stack(r_lo))
