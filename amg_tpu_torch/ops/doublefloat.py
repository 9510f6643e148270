"""Double-float32 (df32) arithmetic: an unevaluated pair ``hi + lo`` of f32
with ``|lo| <= ulp(hi)/2`` (~48-bit significand).

PyTorch port of ``amg_tpu/ops/doublefloat.py:33-257``. The error-free
transformations (Knuth TwoSum, Dekker TwoProd with Veltkamp splitting) rely
on every f32 operation rounding on its own: eager PyTorch runs each
operator as its own rounded elementwise pass, and nothing here may be
compiled with fast-math or re-associated.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

_SPLIT = 4097.0  # 2^12 + 1: Veltkamp split factor for the 24-bit f32 mantissa


def two_sum(a, b):
    """s + e = a + b exactly (Knuth), no magnitude ordering assumed."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """s + e = a + b exactly, assuming |a| >= |b| (Dekker fast path)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split_f32(a):
    """Veltkamp split: a = hi + lo with 12-bit halves (exact f32 products)."""
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """p + e = a * b exactly (Dekker TwoProd via Veltkamp splitting)."""
    p = a * b
    ah, al = split_f32(a)
    bh, bl = split_f32(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


@dataclasses.dataclass(frozen=True)
class DF32:
    """A double-float32 tensor pair: value = hi + lo elementwise."""

    hi: torch.Tensor
    lo: torch.Tensor

    @staticmethod
    def from_f64(x64: torch.Tensor) -> "DF32":
        if x64.dtype != torch.float64:
            # an f32 "f64" input would make lo zero: the solver would run
            # plain f32 dressed as df32 and stall above tolerance silently
            raise ValueError(
                f"DF32.from_f64 requires a float64 input, got {x64.dtype}; "
                "use DF32.from_f32 deliberately for f32 data")
        hi = x64.to(torch.float32)
        lo = (x64 - hi.to(torch.float64)).to(torch.float32)
        return DF32(hi=hi, lo=lo)

    @staticmethod
    def from_f32(x32: torch.Tensor) -> "DF32":
        return DF32(hi=x32, lo=torch.zeros_like(x32))

    def to_f64(self) -> torch.Tensor:
        return self.hi.to(torch.float64) + self.lo.to(torch.float64)

    @property
    def shape(self) -> torch.Size:
        return self.hi.shape


def df_add(a: DF32, b: DF32) -> DF32:
    """a + b with full double-float renormalization."""
    s, e = two_sum(a.hi, b.hi)
    e = e + a.lo + b.lo
    hi, lo = quick_two_sum(s, e)
    return DF32(hi=hi, lo=lo)


def df_add_f32(a: DF32, x) -> DF32:
    """a + x for plain-f32 x (e.g. a V-cycle correction)."""
    s, e = two_sum(a.hi, x)
    hi, lo = quick_two_sum(s, e + a.lo)
    return DF32(hi=hi, lo=lo)


def df_neg(a: DF32) -> DF32:
    return DF32(hi=-a.hi, lo=-a.lo)


def df_mul(a: DF32, b: DF32) -> DF32:
    """a * b (dropping the negligible lo*lo term)."""
    p, e = two_prod(a.hi, b.hi)
    e = e + a.hi * b.lo + a.lo * b.hi
    hi, lo = quick_two_sum(p, e)
    return DF32(hi=hi, lo=lo)


def df_residual(c_df: DF32, b_df: DF32, u_df: DF32) -> DF32:
    """r = b - A u in df32 on an n x n field for a 9-point operator with
    df32 coefficient planes ``c_df`` ((3,3,n,n) hi and lo): every product a
    TwoProd, every accumulation a TwoSum, in Stencil2D.matvec2's order."""
    n = u_df.hi.shape[0]
    uh = F.pad(u_df.hi, (1, 1, 1, 1))
    ul = F.pad(u_df.lo, (1, 1, 1, 1))
    acc = DF32.from_f32(torch.zeros_like(u_df.hi))
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            def sl(z):
                return z[1 + dj:1 + dj + n, 1 + di:1 + di + n]
            term = df_mul(DF32(hi=c_df.hi[dj + 1, di + 1],
                               lo=c_df.lo[dj + 1, di + 1]),
                          DF32(hi=sl(uh), lo=sl(ul)))
            acc = df_add(acc, term)
    return df_add(b_df, df_neg(acc))


def df_residual_const(w33, b_df: DF32, u_df: DF32) -> DF32:
    """r = b - A u in df32 on an n x n field for a constant 3x3 stencil
    (zero padding is the boundary truncation). Weights enter as exact
    (hi, lo) f32 pairs; pow2 weights take the exact-product TwoSum
    cascade."""
    n = u_df.hi.shape[0]
    uh = F.pad(u_df.hi, (1, 1, 1, 1))
    ul = F.pad(u_df.lo, (1, 1, 1, 1))

    def sl(z, dj, di):
        return z[1 + dj:1 + dj + n, 1 + di:1 + di + n]

    if is_pow2_weights(w33):
        s = b_df.hi
        c = b_df.lo
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                w = w33[dj + 1][di + 1]
                if w == 0.0:
                    continue
                wf = -w                       # exact in f32 (pow2)
                t = wf * sl(uh, dj, di)       # exact
                s, e = two_sum(s, t)
                c = c + e + wf * sl(ul, dj, di)
        hi, lo = two_sum(s, c)
        return DF32(hi=hi, lo=lo)

    return df_add(b_df, df_neg(df_apply_const(w33, uh, ul)))


_WEIGHTS: dict = {}


def _weight_df32(w: float, dev) -> DF32:
    """A stencil weight as its exact (hi, lo) f32 pair of 0-d tensors on
    ``dev``, made once: a later call (a CUDA graph capture among them)
    copies nothing from the host."""
    key = (float(w), str(dev))
    wdf = _WEIGHTS.get(key)
    if wdf is None:
        w_hi = float(np.float32(w))
        w_lo = float(np.float32(w - w_hi))
        wdf = _WEIGHTS[key] = DF32(
            hi=torch.tensor(w_hi, dtype=torch.float32, device=dev),
            lo=torch.tensor(w_lo, dtype=torch.float32, device=dev))
    return wdf


def df_apply_const(w33, uh_pad: torch.Tensor, ul_pad: torch.Tensor) -> DF32:
    """A u in df32 for a constant 3x3 stencil, general weights: ``uh_pad``
    and ``ul_pad`` are the (..., R+2, n+2) fields with their one-cell frame
    (zeros or neighbour rows); each weight enters as an exact (hi, lo) f32
    pair, every product a df_mul, every sum a df_add, dj outer. Leading
    axes are batch axes (the distributed solver's slabs)."""
    R, n = uh_pad.shape[-2] - 2, uh_pad.shape[-1] - 2
    dev = uh_pad.device
    acc = DF32.from_f32(torch.zeros_like(uh_pad[..., 1:-1, 1:-1]))
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            w = w33[dj + 1][di + 1]
            if w == 0.0:
                continue
            wdf = _weight_df32(w, dev)
            win = (..., slice(1 + dj, 1 + dj + R), slice(1 + di, 1 + di + n))
            acc = df_add(acc, df_mul(wdf, DF32(hi=uh_pad[win],
                                               lo=ul_pad[win])))
    return acc


def df_rss(r_df: DF32, dtype=None) -> torch.Tensor:
    """Residual sum of squares of a df32 residual: squares as df32
    TwoProds, the two reductions in ``dtype`` (None: f64, the port's
    default; JAX takes f32 only where x64 is off)."""
    dtype = torch.float64 if dtype is None else dtype
    sq = df_mul(r_df, r_df)
    return torch.sum(sq.hi.to(dtype)) + torch.sum(sq.lo.to(dtype))


def df_rss_fast(r_df: DF32, dtype=None) -> torch.Tensor:
    """rss of a df32 residual for loop control: plain f32 squares
    (hi^2 + 2 hi*lo; lo^2 is below 2^-48 relative), the last axis reduced
    in f32, the per-row sums in ``dtype`` (None: f64).

    Magnitude floor: an entry with |hi| below ~1e-19 squares to zero in
    f32; Poisson-class systems with O(1) forcing sit far above it."""
    sq = r_df.hi * r_df.hi + 2.0 * (r_df.hi * r_df.lo)
    rows = torch.sum(sq, dim=-1)
    return torch.sum(rows.to(torch.float64 if dtype is None else dtype))


def is_pow2_weights(w33) -> bool:
    """True iff every nonzero stencil weight is +/- a power of two, so that
    w * x is exact in f32 (the 2-D Poisson fine operator on 2^k - 1
    grids)."""
    for row in w33:
        for w in row:
            if w == 0.0:
                continue
            m_, _ = math.frexp(abs(float(w)))
            if m_ != 0.5:
                return False
    return True
