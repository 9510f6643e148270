"""9-point stencil operators on 2-D grids, their smoothers and the
bilinear grid transfer.

PyTorch port of ``amg_tpu/sparse/stencil.py``: the operator, the
four-color Gauss-Seidel sweep in its strided (``gs4_sweep``) and masked
(``gs4_sweep_masked``) forms, weighted Jacobi, the Chebyshev smoother with
its lambda_max bounds, and the full-weighting restriction and
prolongation on 2-D fields. An operator
is either constant (``w33``: static 3x3 weights, zero-padding boundary
semantics, no planes stored; every level of the Poisson hierarchy) or
variable (``c``: (3,3,n,n) coefficient planes; the levels of a
variable-coefficient hierarchy). Fields are indexed ``u2[j, i]`` with
``u2.reshape(-1)`` the reference's dof vector; ``c[dj+1, di+1][j, i]`` (or
``w33[dj+1][di+1]``) multiplies ``u2[j+dj, i+di]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

# Color visit order: the 2x2-block parity classes.
FOUR_COLORS = ((0, 0), (0, 1), (1, 0), (1, 1))

# Bilinear 3x3 transfer weights, the outer product of [0.5, 1, 0.5] with
# itself: the full-weighting restriction's and the prolongation's stencil
# (amg_tpu/sparse/stencil.py:415-416).
_W1D = np.array([0.5, 1.0, 0.5])
W2D = np.outer(_W1D, _W1D)


@dataclasses.dataclass(frozen=True)
class Stencil2D:
    """9-point operator on a side x side grid: constant when ``w33`` is
    set (``c`` may then be None), else given by the planes ``c``.

    When both are set, ``w33`` asserts that ``c`` is exactly that constant
    stencil (``detect_const_stencil``) and the operators use ``w33``. A
    plane-free operator's ``dtype`` is ``const_dtype`` (JAX keeps it in an
    empty placeholder array)."""

    side: int
    w33: tuple | None = None
    c: torch.Tensor | None = None
    const_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.w33 is None and self.c is None:
            raise ValueError("Stencil2D needs w33 or planes c")
        if self.c is not None and tuple(self.c.shape) != (3, 3, self.side,
                                                          self.side):
            raise ValueError(f"planes of shape {tuple(self.c.shape)} for "
                             f"side {self.side}")

    @property
    def n_rows(self) -> int:
        return self.side * self.side

    @property
    def dtype(self) -> torch.dtype:
        return self.const_dtype if self.c is None else self.c.dtype

    @property
    def nnz(self) -> int:
        """Stored couplings: a plane-free operator's in closed form (offset
        (dj, di) couples (n-|dj|)*(n-|di|) in-bounds points)."""
        if self.c is None:
            n = self.side
            return sum((n - abs(dj)) * (n - abs(di))
                       for dj in (-1, 0, 1) for di in (-1, 0, 1)
                       if self.w33[dj + 1][di + 1] != 0.0)
        return int(torch.count_nonzero(self.c))

    @staticmethod
    def const(w33, side: int, dtype=torch.float32) -> "Stencil2D":
        if w33 is None:
            raise ValueError("Stencil2D.const requires a w33 tuple")
        return Stencil2D(side=side, w33=w33, const_dtype=dtype)

    @staticmethod
    def from_planes(c: torch.Tensor, side: int) -> "Stencil2D":
        """Wrap (3,3,n,n) planes, detecting a constant stencil."""
        return Stencil2D(side=side, c=c, w33=detect_const_stencil(
            c.detach().cpu().numpy(), side))

    @staticmethod
    def from_scipy(A, side: int, dtype=None, device=None) -> "Stencil2D":
        """Planes of a sparse matrix with lexicographic dofs; raises if A
        couples beyond the 3x3 neighbourhood."""
        A = A.tocsr().copy()
        A.sum_duplicates()
        A.eliminate_zeros()
        A = A.tocoo()
        n = side
        c = np.zeros((3, 3, n, n), dtype=A.data.dtype)
        r_j, r_i = A.row // n, A.row % n
        dj, di = A.col // n - r_j, A.col % n - r_i
        if np.any(np.abs(dj) > 1) or np.any(np.abs(di) > 1):
            raise ValueError("matrix is not a 9-point stencil on this grid")
        c[dj + 1, di + 1, r_j, r_i] = A.data
        t = torch.as_tensor(c, device=device)
        if dtype is not None:
            t = t.to(dtype)
        return Stencil2D(side=side, c=t, w33=detect_const_stencil(
            t.cpu().numpy(), side))

    def matvec2(self, u2: torch.Tensor) -> torch.Tensor:
        """A @ u on the 2-D field: sum of 9 shifted products; the zero
        padding supplies the boundary truncation."""
        n = self.side
        up = F.pad(u2, (1, 1, 1, 1))
        out = torch.zeros_like(u2)
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                sl = up[1 + dj:1 + dj + n, 1 + di:1 + di + n]
                if self.w33 is None:
                    out = out + self.c[dj + 1, di + 1] * sl
                    continue
                w = self.w33[dj + 1][di + 1]
                if w == 0.0:
                    continue
                out = out + w * sl
        return out

    def matvec(self, u: torch.Tensor) -> torch.Tensor:
        """A @ u on the flat dof vector."""
        n = self.side
        return self.matvec2(u.reshape(n, n)).reshape(-1)

    def to_scipy(self):
        """The operator as a scipy CSR matrix with lexicographic dofs (a
        plane-free operator's planes are rebuilt first)."""
        import scipy.sparse as sp

        n = self.side
        c = (const_planes(self.w33, n, self.dtype) if self.c is None
             else self.c).detach().cpu().numpy()
        j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        rows, cols, vals = [], [], []
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                jj, ii = j + dj, i + di
                ok = (jj >= 0) & (jj < n) & (ii >= 0) & (ii < n)
                rows.append((j * n + i)[ok])
                cols.append((jj * n + ii)[ok])
                vals.append(c[dj + 1, di + 1][ok])
        mat = sp.coo_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(n * n, n * n)).tocsr()
        mat.eliminate_zeros()
        return mat

    def astype(self, dtype) -> "Stencil2D":
        return dataclasses.replace(
            self, c=None if self.c is None else self.c.to(dtype),
            const_dtype=dtype)

    def inv_diag(self):
        """1/diag: a Python float (constant) or a plane."""
        if self.w33 is not None:
            return 1.0 / self.w33[1][1]
        return 1.0 / self.c[1, 1]

    def diag(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """The diagonal plane (a constant operator's is uniform: the zero
        padding truncates only off-diagonal couplings)."""
        if self.c is not None:
            return self.c[1, 1]
        return torch.full((self.side, self.side), self.w33[1][1],
                          dtype=dtype, device=device)


def const_planes(w33, side: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """(3,3,n,n) coefficient planes of a constant stencil with zero-padding
    boundary semantics (used for the coarsest-level densify)."""
    n = side
    j = torch.arange(n, device=device).reshape(n, 1)
    i = torch.arange(n, device=device).reshape(1, n)
    zero = torch.zeros((), dtype=dtype, device=device)
    planes = []
    for dj in (-1, 0, 1):
        row = []
        for di in (-1, 0, 1):
            inb = ((j + dj >= 0) & (j + dj < n)
                   & (i + di >= 0) & (i + di < n))
            w = torch.tensor(w33[dj + 1][di + 1], dtype=dtype, device=device)
            row.append(torch.where(inb, w, zero))
        planes.append(torch.stack(row))
    return torch.stack(planes)


def detect_const_stencil(c_np: np.ndarray, side: int) -> tuple | None:
    """The 3x3 weight tuple if the planes are EXACTLY (bitwise) a constant
    stencil with zero-padding boundary semantics, else None."""
    n = side
    c_np = np.asarray(c_np)
    w = c_np[:, :, n // 2, n // 2]
    jj, ii = np.indices((n, n))
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            plane = c_np[dj + 1, di + 1]
            valid = ((jj + dj >= 0) & (jj + dj < n)
                     & (ii + di >= 0) & (ii + di < n))
            expect = np.where(valid, w[dj + 1, di + 1], plane.dtype.type(0))
            if not np.array_equal(plane, expect):
                return None
    return tuple(tuple(float(x) for x in row) for row in w)


def color_masks_iota(n: int, dtype=torch.float32, device=None
                     ) -> torch.Tensor:
    """(4, n, n) parity-class masks in FOUR_COLORS order."""
    j = torch.arange(n, device=device).reshape(n, 1)
    i = torch.arange(n, device=device).reshape(1, n)
    return torch.stack([((j % 2) == pj) & ((i % 2) == pi)
                        for pj, pi in FOUR_COLORS]).to(dtype)


def gs4_sweep_masked(S: Stencil2D, u2, b2, masks, omega: float = 1.0,
                     symmetric: bool = True):
    """Four-color GS sweep via full-grid masked updates: per color, the GS
    correction is computed everywhere and kept on that color's mask
    (colors forward, then reversed when symmetric)."""
    order = list(range(4))
    if symmetric:
        order = order + order[::-1]
    inv_diag = S.inv_diag()
    for ci in order:
        r = b2 - S.matvec2(u2)
        gs_delta = r * inv_diag
        u2 = u2 + (omega * masks[ci]) * gs_delta
    return u2


def _color_slices(n: int, pj: int, pi: int):
    """Shape of the (pj, pi)-parity sub-lattice."""
    return (n - pj + 1) // 2, (n - pi + 1) // 2


def gs4_color_update(S: Stencil2D, u2, b2, pj: int, pi: int,
                     omega: float = 1.0):
    """Gauss-Seidel update of the (j%2 == pj, i%2 == pi) color on its
    strided sub-lattice; points of one color share no 9-point edge, so
    they update independently. Reads the planes when the operator has
    them, else its constant weights (equal values: a constant plane is 0
    exactly where the zero-padded neighbour is)."""
    n = S.side
    nj, ni = _color_slices(n, pj, pi)
    up = F.pad(u2, (1, 1, 1, 1))
    acc = torch.zeros((nj, ni), dtype=u2.dtype, device=u2.device)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            if dj == 0 and di == 0:
                continue
            w = (S.w33[dj + 1][di + 1] if S.c is None
                 else S.c[dj + 1, di + 1, pj::2, pi::2])
            nb = up[1 + pj + dj:1 + pj + dj + 2 * nj - 1:2,
                    1 + pi + di:1 + pi + di + 2 * ni - 1:2]
            acc = acc + w * nb
    diag = S.w33[1][1] if S.c is None else S.c[1, 1, pj::2, pi::2]
    usub = u2[pj::2, pi::2]
    gs = (b2[pj::2, pi::2] - acc) / diag
    out = u2.clone()
    out[pj::2, pi::2] = usub + omega * (gs - usub)
    return out


def gs4_sweep(S: Stencil2D, u2, b2, omega: float = 1.0,
              symmetric: bool = True):
    """One four-color Gauss-Seidel sweep on strided sub-lattices (colors
    forward, then reversed when symmetric)."""
    order = list(FOUR_COLORS)
    if symmetric:
        order = order + order[::-1]
    for pj, pi in order:
        u2 = gs4_color_update(S, u2, b2, pj, pi, omega)
    return u2


def color_masks(n: int, dtype=torch.bool, device=None) -> torch.Tensor:
    """(4, n, n) masks of the 2x2-parity classes, built on the host."""
    j, i = np.indices((n, n))
    m = np.stack([((j % 2) == pj) & ((i % 2) == pi)
                  for pj, pi in FOUR_COLORS])
    return torch.as_tensor(m, device=device).to(dtype)


def jacobi_sweep(S: Stencil2D, u2, b2, omega: float = 0.8):
    """Weighted-Jacobi sweep."""
    r = b2 - S.matvec2(u2)
    return u2 + omega * r * S.inv_diag()


def dinv_matvec2(S: Stencil2D, x2):
    """D^-1 A x, the operator the polynomial smoother iterates."""
    return S.inv_diag() * S.matvec2(x2)


def estimate_lam_max(S: Stencil2D, iters: int = 12, seed: int = 0, *,
                     x0: torch.Tensor | None = None,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
    """Power-iteration estimate of lambda_max(D^-1 A) with a 5 % margin.

    The start vector is ``x0`` when given, else standard normal from
    ``generator`` (None: a new generator seeded with ``seed`` on the
    planes' device). JAX draws it from ``jax.random.normal(PRNGKey(seed))``,
    which torch cannot reproduce: pass JAX's vector as ``x0`` to compare."""
    n = S.side
    if x0 is None:
        if generator is None:
            device = S.c.device if S.c is not None else None
            generator = torch.Generator(device=device).manual_seed(seed)
        x0 = torch.randn((n, n), generator=generator, dtype=S.dtype,
                         device=generator.device)
    x = x0
    for _ in range(iters):
        y = dinv_matvec2(S, x)
        x = y / torch.sqrt(torch.sum(y * y))
    y = dinv_matvec2(S, x)
    lam = torch.sum(x * y) / torch.sum(x * x)   # D^-1 A is SPD-similar
    return torch.abs(lam) * 1.05


def const_lam_max(w33) -> float:
    """Analytic bound of lambda_max(D^-1 A) for a constant symmetric
    9-point stencil: its Fourier symbol is bilinear in (cos t1, cos t2) on
    [-1, 1]^2, so its largest value is at a corner."""
    wc = w33[1][1]
    wN = w33[0][1]
    wW = w33[1][0]
    wd = w33[0][0] if w33[0][0] != 0.0 else w33[0][2]
    best = 0.0
    for c1 in (1.0, -1.0):
        for c2 in (1.0, -1.0):
            s = (wc + 2 * wN * c1 + 2 * wW * c2 + 4 * wd * c1 * c2) / wc
            best = max(best, s)
    return best


def chebyshev_smooth(S: Stencil2D, u2, b2, lam_max, degree: int = 3,
                     lam_min_frac: float = 0.25):
    """Chebyshev polynomial smoother of ``degree``: damps the spectrum of
    D^-1 A in [lam_min_frac * lam_max, lam_max] with the three-term
    recurrence on the preconditioned residual (one SpMV and axpys a
    step, no color steps)."""
    theta = 0.5 * (1.0 + lam_min_frac) * lam_max
    delta = 0.5 * (1.0 - lam_min_frac) * lam_max
    sigma = theta / delta
    rho = 1.0 / sigma
    r = (b2 - S.matvec2(u2)) * S.inv_diag()
    d = r / theta
    u2 = u2 + d
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r = r - dinv_matvec2(S, d)
        d = rho_new * rho * d + 2.0 * rho_new / delta * r
        u2 = u2 + d
        rho = rho_new
    return u2


def restrict_fw(r2: torch.Tensor) -> torch.Tensor:
    """R @ r for R = kron(P1, P1)^T: the 3x3 bilinear window at stride 2
    centred on the odd fine points; fine side n = 2 nc + 1 -> nc."""
    n = r2.shape[0]
    nc = (n - 1) // 2
    out = torch.zeros((nc, nc), dtype=r2.dtype, device=r2.device)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            out = out + float(W2D[dj + 1, di + 1]) * r2[
                1 + dj:1 + dj + 2 * nc - 1:2, 1 + di:1 + di + 2 * nc - 1:2]
    return out


def prolong(uc2: torch.Tensor, n_fine: int) -> torch.Tensor:
    """P @ u_c: the coarse values on the odd fine points, then the 3x3
    bilinear kernel."""
    nc = uc2.shape[0]
    if n_fine != 2 * nc + 1:
        raise ValueError(f"prolong needs n_fine = 2 nc + 1, got ({n_fine}, "
                         f"{nc})")
    z = torch.zeros((n_fine + 2, n_fine + 2), dtype=uc2.dtype,
                    device=uc2.device)
    # fine point (2a+1, 2b+1) sits at padded index (2a+2, 2b+2)
    z[2:2 + 2 * nc:2, 2:2 + 2 * nc:2] = uc2
    out = torch.zeros((n_fine, n_fine), dtype=uc2.dtype, device=uc2.device)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            out = out + float(W2D[dj + 1, di + 1]) * z[
                1 + dj:1 + dj + n_fine, 1 + di:1 + di + n_fine]
    return out
