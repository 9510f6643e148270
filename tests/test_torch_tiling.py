"""The tiled algorithm of the packed CUDA kernels K1, K2, K3 and K8, emulated
in plain PyTorch on the CPU, against the plain versions they are held to.

Each kernel block copies a window of TJ x TI tile cells of all four packed
quarters plus a ring of GJ rows and GI columns (zero outside the domain),
runs the color steps on the window without ever updating its outermost
cells, and keeps the tile (csrc/packed_common.cuh). The values next to the
window's edge go wrong, and the wrong values spread inwards with the color
steps; the ring must hold them off the cells the block stores (K1, K3) or
reads for its residual and restriction (K2). K8 runs no color steps: its
ring only has to cover the residual's and the restriction's reach. This
file shows, where there is no card, that the shipped rings are exact
(bitwise equal to gs4_sweep_packed, up_leg_plain, down_leg_plain and
residual_restrict_plain) and that one row or column less is not.

Sizes: M = 101 and 129 with the kernels' 32 x 64 tiles, so that edge tiles
and a ragged M occur. f32, random fields from numpy, three weight patterns
(5-point, 9-point, another zero pattern), symmetric and forward sweeps.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from amg_tpu_torch.ops.kernels.packed_cycle import (down_leg_plain,
                                                    residual_restrict_plain,
                                                    up_leg_plain)
from amg_tpu_torch.sparse.packed import COLORS, gs4_sweep_packed

torch.set_num_threads(1)

# the kernels' tile (csrc/packed_common.cuh Tiling) and their rings (ghost
# rows, ghost columns): the shipped ones, and the least that is exact for
# every weight pattern. K1 and K3 sweep only; K2 also reads its residual one
# fine point further out and restricts one cell past the tile, and ships a
# wider ring (its columns a multiple of 4 for 16-byte rows).
TILE = (32, 64)
RING = {"K1": (2, 4), "K3": (2, 4), "K2": (6, 8)}
LEAST = {"K1": (2, 4), "K3": (2, 4), "K2": (3, 5)}
# K8 (csrc/packed_cycle.cu, on K3's tiling Up): its tile and ring, and the
# least ring. The kernel computes every quarter's residual on the tile's
# (TJ+1) x (TI+1) cells without a bounds test, which reads 2 rows and
# columns past the tile; the restriction needs only 1 (reads past the
# window below read 0).
RR_TILE = (32, 64)
RR_RING, RR_LEAST = (2, 4), (1, 1)

FIVE = ((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0))
NINE = ((-0.5, -1.0, -0.5), (-1.0, 6.0, -1.0), (-0.5, -1.0, -0.5))
OTHER = ((0.0, -1.0, -0.5), (-1.0, 4.5, -1.0), (0.0, -1.0, 0.0))
WEIGHTS = {"five": FIVE, "nine": NINE, "other": OTHER}


def _real(a: int, J, I, M: int):
    """Real cells of quarter a at window rows J and columns I (absolute)."""
    Mj, Mi = M - (a >> 1), M - (a & 1)
    return ((J >= 0) & (J < Mj)).reshape(-1, 1) & ((I >= 0) & (I < Mi))


def _window(f4, J0: int, I0: int, H: int, W: int):
    """f4's four quarters on [J0, J0+H) x [I0, I0+W), zero outside."""
    M = f4.shape[-1]
    S = torch.zeros((4, H, W), dtype=f4.dtype)
    j0, j1 = max(J0, 0), min(J0 + H, M)
    i0, i1 = max(I0, 0), min(I0 + W, M)
    if j0 < j1 and i0 < i1:
        S[:, j0 - J0:j1 - J0, i0 - I0:i1 - I0] = f4[:, j0:j1, i0:i1]
    return S


def _acc(U, w33, pj: int, pi: int, sl_r, sl_c):
    """sparse/packed.py _acc on the window cells (sl_r, sl_c): the
    neighbours in the _neighbors order, zero weights skipped."""
    H, W = U.shape[1:]
    acc = torch.zeros((sl_r.stop - sl_r.start, sl_c.stop - sl_c.start),
                      dtype=U.dtype)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            if dj == 0 and di == 0:
                continue
            w = w33[dj + 1][di + 1]
            if w == 0.0:
                continue
            bj, bi = (pj + dj) % 2, (pi + di) % 2
            sJ, sI = (pj + dj - bj) // 2, (pi + di - bi) // 2
            x = U[2 * bj + bi, sl_r.start + sJ:sl_r.stop + sJ,
                  sl_c.start + sI:sl_c.stop + sI]
            acc = acc + w * x
    return acc


def _sweep_window(U, B, w33, M, J0, I0, omega, symmetric):
    """The color steps on the window's inner cells (the outermost ring is
    never updated), each in gs4_sweep_packed's arithmetic."""
    H, W = U.shape[1:]
    inner_r, inner_c = slice(1, H - 1), slice(1, W - 1)
    J = torch.arange(J0 + 1, J0 + H - 1)
    I = torch.arange(I0 + 1, I0 + W - 1)
    inv_diag = 1.0 / w33[1][1]
    order = list(COLORS) + (list(COLORS)[::-1] if symmetric else [])
    for pj, pi in order:
        a = 2 * pj + pi
        acc = _acc(U, w33, pj, pi, inner_r, inner_c)
        ua = U[a, inner_r, inner_c]
        delta = (B[a, inner_r, inner_c] - acc) * inv_diag - ua
        mask = _real(a, J, I, M).to(U.dtype)
        U[a, inner_r, inner_c] = ua + (omega * mask) * delta


def _correct_window(U, uc_pad, J0, I0):
    """K3's correction pass: each window cell (J, I) reads the coarse
    values uc[J-1..J, I-1..I] (0 at index -1) and corrects the four
    quarters' real cells there, in prolong_add_packed's order."""
    M = uc_pad.shape[-1]
    H, W = U.shape[1:]
    Ucp = torch.zeros((M + 1, M + 1), dtype=uc_pad.dtype)
    Ucp[1:, 1:] = uc_pad                    # Ucp[J+1, I+1] = uc[J, I]

    def uc(dJ, dI):
        C = torch.zeros((H, W), dtype=uc_pad.dtype)
        j0, j1 = max(J0, 0), min(J0 + H, M)
        i0, i1 = max(I0, 0), min(I0 + W, M)
        if j0 < j1 and i0 < i1:
            C[j0 - J0:j1 - J0, i0 - I0:i1 - I0] = \
                Ucp[j0 + 1 + dJ:j1 + 1 + dJ, i0 + 1 + dI:i1 + 1 + dI]
        return C
    u0 = uc(0, 0)
    corr = (0.25 * (((uc(-1, -1) + uc(-1, 0)) + uc(0, -1)) + u0),
            0.5 * (uc(-1, 0) + u0), 0.5 * (uc(0, -1) + u0), u0)
    J = torch.arange(J0, J0 + H)
    I = torch.arange(I0, I0 + W)
    for a in range(4):
        U[a] = U[a] + _real(a, J, I, M).to(U.dtype) * corr[a]


def _residual_restrict_window(U, B, w33, M, J0, I0, GJ, GI, TJ, TI):
    """K2's residual (residual_packed's arithmetic) on window rows
    [GJ, GJ+TJ] and columns [GI, GI+TI], then the tile's restriction
    (restrict_packed's order)."""
    rows, cols = slice(GJ, GJ + TJ + 1), slice(GI, GI + TI + 1)
    J = torch.arange(J0 + GJ, J0 + GJ + TJ + 1)
    I = torch.arange(I0 + GI, I0 + GI + TI + 1)
    R = []
    for pj, pi in COLORS:
        a = 2 * pj + pi
        acc = _acc(U, w33, pj, pi, rows, cols) + w33[1][1] * U[a, rows, cols]
        R.append(_real(a, J, I, M).to(U.dtype) * (B[a, rows, cols] - acc))
    r00, r01, r10, r11 = R
    c = r11[:TJ, :TI]
    c = c + 0.5 * (r01[:TJ, :TI] + r01[1:, :TI] + r10[:TJ, :TI]
                   + r10[:TJ, 1:])
    c = c + 0.25 * (r00[:TJ, :TI] + r00[:TJ, 1:] + r00[1:, :TI]
                    + r00[1:, 1:])
    return c


def tiled(kind: str, u4, b4, w33, m: int, omega: float, symmetric: bool,
          ring: tuple, uc_pad=None):
    """Kernel ``kind`` (K1, K2, K3) as its blocks compute it, with ``ring``
    = (GJ, GI) ghost rows and columns around each TILE."""
    M = m + 1
    TJ, TI = TILE
    GJ, GI = ring
    out = torch.empty_like(u4)
    bc = torch.zeros((M, M), dtype=u4.dtype)
    for Jt in range(0, M, TJ):
        for It in range(0, M, TI):
            J0, I0 = Jt - GJ, It - GI
            U = _window(u4, J0, I0, TJ + 2 * GJ, TI + 2 * GI)
            B = _window(b4, J0, I0, TJ + 2 * GJ, TI + 2 * GI)
            if kind == "K3":
                _correct_window(U, uc_pad, J0, I0)
            _sweep_window(U, B, w33, M, J0, I0, omega, symmetric)
            tj, ti = min(TJ, M - Jt), min(TI, M - It)
            out[:, Jt:Jt + tj, It:It + ti] = U[:, GJ:GJ + tj, GI:GI + ti]
            if kind == "K2":
                c = _residual_restrict_window(U, B, w33, M, J0, I0, GJ, GI,
                                              TJ, TI)
                bc[Jt:Jt + tj, It:It + ti] = c[:tj, :ti]
    if kind == "K2":
        bc[m, :] = 0.0
        bc[:, m] = 0.0
        return out, bc
    return out


def _fields(M: int, seed: int):
    rng = np.random.default_rng(seed)
    m = M - 1
    f = [torch.tensor(rng.standard_normal((4, M, M)), dtype=torch.float32)
         for _ in range(2)]
    for x in f:                        # pad cells are 0 in a packed field
        x[1][:, m] = 0.0
        x[2][m, :] = 0.0
        x[3][m, :] = 0.0
        x[3][:, m] = 0.0
    uc = torch.zeros((M, M), dtype=torch.float32)
    uc[:m, :m] = torch.tensor(rng.standard_normal((m, m)),
                              dtype=torch.float32)
    return m, f[0], f[1], uc


def _plain(kind, u4, b4, w33, m, omega, symmetric, uc_pad):
    if kind == "K1":
        return gs4_sweep_packed(u4, b4, w33, m, omega, symmetric)
    if kind == "K3":
        return up_leg_plain(u4, b4, uc_pad, w33, m, omega, symmetric)
    return down_leg_plain(u4, b4, w33, m, omega, symmetric)


def _exact(kind, M, weights, symmetric, ring, omega=0.9):
    m, u4, b4, uc = _fields(M, M + len(weights))
    w33 = WEIGHTS[weights]
    want = _plain(kind, u4, b4, w33, m, omega, symmetric, uc)
    got = tiled(kind, u4, b4, w33, m, omega, symmetric, ring, uc)
    if kind == "K2":
        return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return torch.equal(got, want)


@pytest.mark.parametrize("M", [101, 129])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("weights", list(WEIGHTS))
@pytest.mark.parametrize("kind", list(RING))
def test_shipped_ring_is_exact(kind, weights, symmetric, M):
    assert _exact(kind, M, weights, symmetric, RING[kind])


@pytest.mark.parametrize("M", [101, 129])
@pytest.mark.parametrize("kind", list(LEAST))
def test_least_ring(kind, M):
    """LEAST is exact, and one ghost row less or one ghost column less is
    not, on the 9-point weights (every term present) and a symmetric sweep,
    the longest reach of the wrong values."""
    GJ, GI = LEAST[kind]
    assert all(_exact(kind, M, w, s, (GJ, GI))
               for w in WEIGHTS for s in (True, False))
    assert not _exact(kind, M, "nine", True, (GJ - 1, GI))
    assert not _exact(kind, M, "nine", True, (GJ, GI - 1))
    assert RING[kind][0] >= GJ and RING[kind][1] >= GI


def tiled_rr(u4, b4, w33, m: int, ring: tuple):
    """K8 as its blocks compute it: each RR_TILE with ``ring`` = (GJ, GI),
    the residual of every quarter on the cells the tile's restriction reads,
    then the restriction; a read outside the window reads 0."""
    M = m + 1
    TJ, TI = RR_TILE
    GJ, GI = ring
    bc = torch.zeros((M, M), dtype=u4.dtype)
    for Jt in range(0, M, TJ):
        for It in range(0, M, TI):
            J0, I0 = Jt - GJ, It - GI
            U, B = (F.pad(_window(f, J0, I0, TJ + 2 * GJ, TI + 2 * GI),
                          (2, 2, 2, 2)) for f in (u4, b4))
            c = _residual_restrict_window(U, B, w33, M, J0 - 2, I0 - 2,
                                          GJ + 2, GI + 2, TJ, TI)
            tj, ti = min(TJ, M - Jt), min(TI, M - It)
            bc[Jt:Jt + tj, It:It + ti] = c[:tj, :ti]
    bc[m, :] = 0.0
    bc[:, m] = 0.0
    return bc


def _rr_exact(M, weights, ring):
    m, u4, b4, _ = _fields(M, 2 * M + len(weights))
    w33 = WEIGHTS[weights]
    return torch.equal(tiled_rr(u4, b4, w33, m, ring),
                       residual_restrict_plain(u4, b4, w33, m))


@pytest.mark.parametrize("M", [101, 129])
@pytest.mark.parametrize("weights", list(WEIGHTS))
def test_rr_shipped_ring_is_exact(weights, M):
    assert _rr_exact(M, weights, RR_RING)


@pytest.mark.parametrize("M", [101, 129])
def test_rr_least_ring(M):
    """K8's least ring is exact for every weight pattern; one ghost row or
    column less is not (9-point weights)."""
    GJ, GI = RR_LEAST
    assert all(_rr_exact(M, w, RR_LEAST) for w in WEIGHTS)
    assert not _rr_exact(M, "nine", (GJ - 1, GI))
    assert not _rr_exact(M, "nine", (GJ, GI - 1))
    assert RR_RING[0] >= GJ and RR_RING[1] >= GI
