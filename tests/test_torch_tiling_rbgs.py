"""The tiled algorithm of K5 and K6, the constant and variable-coefficient
fused sweeps on unpacked (n, n) fields (csrc/rbgs_sweep.cu,
csrc/rbgs_var.cu, their block in csrc/rbgs_common.cuh), emulated in plain
PyTorch on the CPU against fused_gs4_sweep_plain, the version they are
held to.

A block copies a window of u and b around a TJ x TI tile (zero outside the
grid), runs the color steps in the window and keeps the tile. Cells next to
the window's edge read values that the steps outside the window would have
changed, and the wrong values spread inwards with the steps. This file
shows, where there is no card, that

* a ring of 3 rows above the tile, 2 below, 7 columns left and 6 right
  (symmetric sweep; forward: 1, 2, 3, 4) is exact when every inner window
  cell is updated, and that one row or column less on any side is not;
* the shipped block is exact: its even-aligned window (4 / 2 / 8 / 6
  symmetric, 2 / 2 / 4 / 4 forward) and its per-phase update regions (the
  trapezoid: each step updates only the cells of its color that can still
  reach the tile), copied from the kernel's margin table;
* each entry of that table is the least: one smaller is not exact;
* K5's block, the same window and regions with K5's own arithmetic (the
  constant weights summed di outer, dj inner, zero weights skipped: a
  ``Stencil2D.const`` operand) and its own tile, is exact too, and with any
  entry of the shared table one smaller it is not;
* K12's block (csrc/rbgs_var.cu masked_var_sweep_kernel), K6's tile,
  window and regions with the plain masked sweep's arithmetic (all nine
  terms with the diagonal in its place, (b - acc) * (1 / c_diag), u +
  omega * g), is exact against sparse.stencil.gs4_sweep_masked with
  parity masks, on grids smaller than one tile too.

Sizes: n = 127 and 255 and a ragged even n = 200 with the kernels' tiles
(K6 32 x 64, K5 32 x 114); 5-point and 9-point constant planes, the jump
planes and random positive planes (K6), 5-point and 9-point weights (K5);
f32; symmetric and forward; omega 1 and 0.9. K12: n = 7, 31, 127 and 200,
Kellogg's planes, a Galerkin level of them and random positive planes;
omega 1 and 0.8.
"""

import numpy as np
import pytest
import torch

from amg_tpu_torch.models import varcoef
from amg_tpu_torch.ops.kernels.rbgs import OFFSETS, fused_gs4_sweep_plain
from amg_tpu_torch.ops.rap import rap_stencil_planes
from amg_tpu_torch.sparse.stencil import (FOUR_COLORS, Stencil2D,
                                          color_masks_iota, gs4_sweep_masked)

torch.set_num_threads(1)

TILE = (32, 64)                     # csrc/rbgs_var.cu kTJ, kTI
K5_TILE = (32, 114)                 # csrc/rbgs_sweep.cu kTJ, kTI
# window margins around the tile (rows above, below, columns left, right)
LEAST = {True: (3, 2, 7, 6), False: (1, 2, 3, 4)}
SHIPPED = {True: (4, 2, 8, 6), False: (2, 2, 4, 4)}
# a copy of csrc/rbgs_common.cuh margin(), whose comment points back here: per
# load phase, rows above and below the tile and columns left / right for
# even, then odd columns
MARGINS = {True: ((2, 1, 6, 5, 5, 4), (1, 0, 4, 3, 3, 2),
                  (0, -1, 0, -1, 1, 0)),
           False: ((0, 1, 2, 3, 1, 2), (-1, 0, 0, 1, -1, 0))}
# the load phase of each color step
PHASE = {True: (0, 0, 1, 1, 1, 1, 2, 2), False: (0, 0, 1, 1)}

FIVE = ((0.0, -1.0, 0.0), (-1.0, 4.0, -1.0), (0.0, -1.0, 0.0))
NINE = ((-0.5, -1.0, -0.5), (-1.0, 6.0, -1.0), (-0.5, -1.0, -0.5))


def _planes(kind: str, n: int, rng) -> torch.Tensor:
    if kind == "jump":
        return varcoef.jump_planes(n, device="cpu")
    if kind == "kellogg":
        return varcoef.kellogg_planes(n, torch.float32, device="cpu")
    if kind == "galerkin":
        return rap_stencil_planes(varcoef.kellogg_planes(
            2 * n + 1, torch.float32, device="cpu"))
    if kind == "random":
        c = rng.random((3, 3, n, n)) + 0.5
        c[1, 1] += 8.0
        return torch.tensor(c, dtype=torch.float32)
    w33 = torch.tensor(FIVE if kind == "five" else NINE, dtype=torch.float32)
    return w33.reshape(3, 3, 1, 1).expand(3, 3, n, n).contiguous()


def _window(f, j0: int, i0: int, H: int, W: int):
    """f's last two axes on [j0, j0+H) x [i0, i0+W), zero outside."""
    n = f.shape[-1]
    S = torch.zeros(f.shape[:-2] + (H, W), dtype=f.dtype)
    a0, a1 = max(j0, 0), min(j0 + H, n)
    b0, b1 = max(i0, 0), min(i0 + W, n)
    if a0 < a1 and b0 < b1:
        S[..., a0 - j0:a1 - j0, b0 - i0:b1 - i0] = f[..., a0:a1, b0:b1]
    return S


def _region(margins, sym: bool, k: int, pi: int, Jt: int, It: int, J, I,
            tile=TILE):
    """Cells of the load phase of step k with column parity pi: absolute
    rows J and columns I against the phase's ``margins`` around the tile."""
    top, bot, l0, r0, l1, r1 = margins[PHASE[sym][k]]
    left, right = (l1, r1) if pi else (l0, r0)
    TJ, TI = tile
    rows = (J >= Jt - top) & (J <= Jt + TJ - 1 + bot)
    cols = (I >= It - left) & (I <= It + TI - 1 + right)
    return rows.reshape(-1, 1) & cols.reshape(1, -1)


def tiled(c, u, b, omega: float, sym: bool, ring: tuple, margins=None,
          tile=TILE, masked: bool = False):
    """K6 (``c`` (3,3,n,n) planes), K12 (the planes with ``masked``) or K5
    (``c`` a w33 tuple) as its blocks compute it: each ``tile`` with the
    window margins ``ring``; every inner window cell of the step's color
    updated, or, given per-phase ``margins`` (MARGINS[sym] for the
    kernels'), only those in the load phase regions."""
    n = u.shape[-1]
    TJ, TI = tile
    const = not isinstance(c, torch.Tensor)
    top, bot, left, right = ring
    H, W = TJ + top + bot, TI + left + right
    order = list(FOUR_COLORS) + (list(FOUR_COLORS)[::-1] if sym else [])
    out = torch.empty_like(u)
    for Jt in range(0, n, TJ):
        for It in range(0, n, TI):
            j0, i0 = Jt - top, It - left
            U, B = _window(u, j0, i0, H, W), _window(b, j0, i0, H, W)
            J = torch.arange(j0 + 1, j0 + H - 1)    # inner window cells
            I = torch.arange(i0 + 1, i0 + W - 1)
            real = (((J >= 0) & (J < n)).reshape(-1, 1)
                    & ((I >= 0) & (I < n)).reshape(1, -1))
            inner = (slice(1, H - 1), slice(1, W - 1))
            if const:      # K5: di outer, dj inner, zero weights skipped
                terms = [((dj, di), c[dj + 1][di + 1]) for di in (-1, 0, 1)
                         for dj in (-1, 0, 1)
                         if (dj, di) != (0, 0) and c[dj + 1][di + 1] != 0.0]
                inv = 1.0 / c[1][1]
            else:          # K6: OFFSETS order; K12: all nine in order
                C = _window(c, j0, i0, H, W)
                offsets = ([(dj, di) for dj in (-1, 0, 1)
                            for di in (-1, 0, 1)] if masked else OFFSETS)
                terms = [((dj, di), C[dj + 1, di + 1][inner])
                         for dj, di in offsets]
                inv = 1.0 / C[1, 1][inner]
            for k, (pj, pi) in enumerate(order):
                acc = torch.zeros((H - 2, W - 2), dtype=u.dtype)
                for (dj, di), w in terms:
                    acc = acc + w * U[1 + dj:H - 1 + dj, 1 + di:W - 1 + di]
                if masked:     # u + omega * g, g = (b - acc) * (1 / c_diag)
                    delta = (B[inner] - acc) * inv
                else:
                    delta = (B[inner] - acc) * inv - U[inner]
                mask = (real & ((J % 2) == pj).reshape(-1, 1)
                        & ((I % 2) == pi).reshape(1, -1))
                if margins is not None:
                    mask = mask & _region(margins, sym, k, pi, Jt, It, J,
                                          I, tile)
                U[inner] = torch.where(mask, U[inner] + omega * delta,
                                       U[inner])
            tj, ti = min(TJ, n - Jt), min(TI, n - It)
            out[Jt:Jt + tj, It:It + ti] = U[top:top + tj, left:left + ti]
    return out


def _exact(n: int, planes: str, sym: bool, ring, omega=0.9,
           margins=None) -> bool:
    rng = np.random.default_rng(n + len(planes))
    c = _planes(planes, n, rng)
    u, b = (torch.tensor(rng.standard_normal((n, n)), dtype=torch.float32)
            for _ in range(2))
    want = fused_gs4_sweep_plain(Stencil2D(side=n, c=c), u, b, omega, sym)
    return torch.equal(tiled(c, u, b, omega, sym, ring, margins), want)


@pytest.mark.parametrize("omega", [1.0, 0.9])
@pytest.mark.parametrize("sym", [True, False], ids=["symmetric", "forward"])
@pytest.mark.parametrize("planes", ["five", "nine", "jump", "random"])
@pytest.mark.parametrize("n", [127, 255, 200])
def test_shipped_block_is_exact(n, planes, sym, omega):
    assert _exact(n, planes, sym, SHIPPED[sym], omega, MARGINS[sym])


@pytest.mark.parametrize("omega", [1.0, 0.9])
@pytest.mark.parametrize("sym", [True, False], ids=["symmetric", "forward"])
@pytest.mark.parametrize("weights", ["five", "nine"])
@pytest.mark.parametrize("n", [127, 255, 200])
def test_k5_shipped_block_is_exact(n, weights, sym, omega):
    """K5's block (the shared window and regions, K5's tile) with K5's own
    arithmetic, bitwise against fused_gs4_sweep_plain's constant path."""
    w33 = FIVE if weights == "five" else NINE
    rng = np.random.default_rng(n + 7 * len(weights))
    u, b = (torch.tensor(rng.standard_normal((n, n)), dtype=torch.float32)
            for _ in range(2))
    want = fused_gs4_sweep_plain(Stencil2D.const(w33, n), u, b, omega, sym)
    got = tiled(w33, u, b, omega, sym, SHIPPED[sym], MARGINS[sym], K5_TILE)
    assert torch.equal(got, want)


@pytest.mark.parametrize("sym", [True, False], ids=["symmetric", "forward"])
@pytest.mark.parametrize("n", [127, 255])
def test_least_ring(n, sym):
    """LEAST is exact with every inner window cell updated, and one row or
    column less on any side is not (random positive planes: every term of
    the 9-point stencil present, the longest reach of the wrong values)."""
    ring = LEAST[sym]
    assert _exact(n, "random", sym, ring)
    for side in range(4):
        less = tuple(g - (s == side) for s, g in enumerate(ring))
        assert not _exact(n, "random", sym, less), less
    assert all(s >= g for s, g in zip(SHIPPED[sym], ring))
    assert SHIPPED[sym][0] % 2 == 0 and SHIPPED[sym][2] % 2 == 0


@pytest.mark.parametrize("field", range(6))
@pytest.mark.parametrize("sym,phase", [(True, 0), (True, 1), (True, 2),
                                       (False, 0), (False, 1)])
def test_least_margin(sym, phase, field):
    """Each entry of the kernel's margin table is the least: with it one
    smaller (one row or column of the phase's cells fewer updated), the
    shipped window is not exact (random positive planes)."""
    less = [list(m) for m in MARGINS[sym]]
    less[phase][field] -= 1
    assert not _exact(127, "random", sym, SHIPPED[sym], margins=less)


@pytest.mark.parametrize("field", range(6))
@pytest.mark.parametrize("sym,phase", [(True, 0), (True, 1), (True, 2),
                                       (False, 0), (False, 1)])
def test_k5_least_margin(sym, phase, field):
    """The shared margin table is the least for K5 too: with 9-point
    constant weights (every term present) and one entry one smaller, K5's
    block is not exact."""
    less = [list(m) for m in MARGINS[sym]]
    less[phase][field] -= 1
    rng = np.random.default_rng(3)
    u, b = (torch.tensor(rng.standard_normal((127, 127)),
                         dtype=torch.float32) for _ in range(2))
    want = fused_gs4_sweep_plain(Stencil2D.const(NINE, 127), u, b, 0.9, sym)
    got = tiled(NINE, u, b, 0.9, sym, SHIPPED[sym], less, K5_TILE)
    assert not torch.equal(got, want)


@pytest.mark.parametrize("omega", [1.0, 0.8])
@pytest.mark.parametrize("sym", [True, False], ids=["symmetric", "forward"])
@pytest.mark.parametrize("planes", ["kellogg", "galerkin", "random"])
@pytest.mark.parametrize("n", [7, 31, 127, 200])
def test_k12_shipped_block_is_exact(n, planes, sym, omega):
    """K12's block (K6's tile, window and regions) with the masked sweep's
    arithmetic, bitwise against gs4_sweep_masked with parity masks."""
    rng = np.random.default_rng(n + 11 * len(planes))
    c = _planes(planes, n, rng)
    u, b = (torch.tensor(rng.standard_normal((n, n)), dtype=torch.float32)
            for _ in range(2))
    want = gs4_sweep_masked(Stencil2D(side=n, c=c), u, b,
                            color_masks_iota(n), omega, sym)
    got = tiled(c, u, b, omega, sym, SHIPPED[sym], MARGINS[sym],
                masked=True)
    assert torch.equal(got, want)
