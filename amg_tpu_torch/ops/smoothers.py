"""Smoothers of the ELL path: weighted Jacobi, sequential-parity
Gauss-Seidel and SOR, multicolor Gauss-Seidel.

PyTorch port of ``amg_tpu/ops/smoothers.py:49-377`` (the reference's
include/amg/smoother.hpp). Every smoother is a pair of functions:

* ``setup(A: ELL) -> state``, once per level;
* ``apply(state, u, b) -> u``, one iteration, a new tensor (``u`` is not
  written);

and ``smooth`` is the standalone loop with the reference's stopping rule
(``while iter < n_iters && error > tol``, the rss checked every
``compute_error_every_n_iters``; smoother.hpp:189-214).

* ``Jacobi`` is the textbook weighted Jacobi ``u += w D^-1 (b - A u)``.
  The reference's Jacobi updates in place and is in fact a Gauss-Seidel
  recurrence; ``SuccessiveOverRelaxation(omega=1)`` is that behavior.
* ``SparseGaussSeidel`` (symmetric: a forward then a backward sweep) and
  ``SuccessiveOverRelaxation`` (forward) run the lexicographic sweep as a
  dense triangular solve, the same recurrence as the reference's
  forwardsweep/backwardsweep (smoother.hpp:148-174). Their state is dense
  (n, n), so they serve small levels (the parity runs).
* ``MulticolorGaussSeidel`` updates one color of rows at a time (rows of a
  color share no edge), from a greedy host coloring. Each color's update
  writes that color's rows only: JAX pads its per-color row lists with row
  0 and writes the padded slots back, so where row 0 lies in a color with
  padding its result depends on the order of its scatter; the port keeps
  one unpadded index per color and writes each row once.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from amg_tpu_torch.sparse.ell import ELL
from amg_tpu_torch.utils.coloring import greedy_coloring
from amg_tpu_torch.utils.debugging import check_rss
from amg_tpu_torch.utils.metrics import rss


@dataclasses.dataclass
class SmootherResult:
    """Outcome of a standalone smooth (the reference's convergence print,
    smoother.hpp:205-212)."""

    u: torch.Tensor
    iterations: int
    error: float
    converged: bool
    history: list  # (iteration, rss) at each check


def _check_omega(omega: float):
    if omega > 2 or omega < 0:
        raise ValueError(f"`omega` must be in [0, 2] but got omega={omega}")


class SmootherBase:
    """Hyperparameters of SmootherBase (smoother.hpp:25-37): tolerance
    1e-9, compute_error_every_n_iters 100, n_iters 1.
    ``compute_error_every_n_iters == 0`` means never check (the reference's
    SPGS, smoother.hpp:183-187)."""

    def __init__(self, tolerance=1e-9, compute_error_every_n_iters=100,
                 n_iters=1):
        self.tolerance = tolerance
        self.compute_error_every_n_iters = compute_error_every_n_iters
        self.n_iters = n_iters

    def setup(self, A: ELL) -> Any:
        raise NotImplementedError

    def apply(self, state, u, b):
        raise NotImplementedError

    def smooth(self, A: ELL, u, b, verbose=False) -> SmootherResult:
        """Iterate to tolerance (smoother.hpp:189-214). One iteration is
        one ``apply`` (a forward and a backward sweep for the symmetric
        GS). The sweeps between two checks are queued without a host
        sync; each check reads one value from the device."""
        state = self.setup(A)
        every = self.compute_error_every_n_iters
        n_iters = self.n_iters
        it = 0
        error = 100.0  # the reference's sentinel (smoother.hpp:193)
        history = []
        while it < n_iters and error > self.tolerance:
            k = (min(every - (it % every), n_iters - it) if every and every > 0
                 else n_iters - it)
            for _ in range(k):
                u = self.apply(state, u, b)
            it += k
            if every and it % every == 0:
                error = check_rss(float(rss(A, u, b)))
                history.append((it, error))
        converged = error <= self.tolerance
        if verbose and every:
            word = "converged" if converged else "did not converge"
            print(f"{type(self).__name__} {word} after {it} iterations.")
        return SmootherResult(u=u, iterations=it, error=error,
                              converged=converged, history=history)


# ---------------------------------------------------------------------------
# Weighted Jacobi


@dataclasses.dataclass(frozen=True)
class JacobiState:
    A: ELL
    inv_diag: torch.Tensor
    omega: float


class Jacobi(SmootherBase):
    """Weighted Jacobi ``u += omega D^-1 (b - A u)``, one sweep an
    iteration (the reference's Jacobi, smoother.hpp:223-264, replaced by
    the sparse textbook form)."""

    def __init__(self, *args, omega: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.omega = omega

    def setup(self, A: ELL) -> JacobiState:
        d = A.diag()
        # a zero diagonal leaves its entry as it is (smoother.hpp:136)
        inv = torch.where(d == 0, torch.zeros_like(d),
                          1.0 / torch.where(d == 0, torch.ones_like(d), d))
        return JacobiState(A=A, inv_diag=inv, omega=self.omega)

    def apply(self, state: JacobiState, u, b):
        r = b - state.A.matvec(u)
        return u + state.omega * state.inv_diag * r


# ---------------------------------------------------------------------------
# Sequential-parity Gauss-Seidel / SOR: dense triangular solves


@dataclasses.dataclass(frozen=True)
class SequentialGSState:
    """Dense split A = L + D + U. The forward sweep is the lower solve
    ``(D + wL) u' = w b + ((1-w) D - w U) u``, the backward sweep the upper
    one with L and U swapped; ``forward`` and ``backward`` hold the two
    triangular matrices."""

    forward: torch.Tensor       # D + w L
    backward: torch.Tensor      # D + w U
    strict_lower: torch.Tensor  # L
    strict_upper: torch.Tensor  # U
    diag: torch.Tensor
    omega: float
    ordering: str               # "forward" | "symmetric"


def _sequential_setup(A: ELL, omega: float, ordering: str
                      ) -> SequentialGSState:
    Ad = A.to_dense()
    d = torch.diagonal(Ad).clone()
    L = torch.tril(Ad, -1)
    U = torch.triu(Ad, 1)
    return SequentialGSState(
        forward=L * omega + torch.diag(d), backward=U * omega + torch.diag(d),
        strict_lower=L, strict_upper=U, diag=d, omega=omega,
        ordering=ordering)


def _sor_forward(state: SequentialGSState, u, b):
    """One forward SOR sweep; omega = 1 is Gauss-Seidel."""
    w = state.omega
    rhs = w * b + (1.0 - w) * state.diag * u - w * (state.strict_upper @ u)
    return torch.linalg.solve_triangular(state.forward, rhs[:, None],
                                         upper=False)[:, 0]


def _sor_backward(state: SequentialGSState, u, b):
    w = state.omega
    rhs = w * b + (1.0 - w) * state.diag * u - w * (state.strict_lower @ u)
    return torch.linalg.solve_triangular(state.backward, rhs[:, None],
                                         upper=True)[:, 0]


class SparseGaussSeidel(SmootherBase):
    """Symmetric Gauss-Seidel, sequential parity: one iteration is a
    forward sweep (rows 0..n-1) then a backward one (rows n-1..0), as
    SparseGaussSeidel::smooth (smoother.hpp:189-214). Defaults are the
    reference's AMG-smoother ctor: tolerance 1e-9, check-every 0 (never),
    n_iters 1 (smoother.hpp:183-187)."""

    def __init__(self, tolerance=1e-9, compute_error_every_n_iters=0,
                 n_iters=1):
        super().__init__(tolerance, compute_error_every_n_iters, n_iters)

    def setup(self, A: ELL) -> SequentialGSState:
        return _sequential_setup(A, omega=1.0, ordering="symmetric")

    def apply(self, state: SequentialGSState, u, b):
        return _sor_backward(state, _sor_forward(state, u, b), b)


class SuccessiveOverRelaxation(SmootherBase):
    """Sequential SOR, forward ordering, omega in [0, 2], validated at
    construction (SuccessiveOverRelaxation, smoother.hpp:271-373, 286-293).
    omega = 1 is a forward Gauss-Seidel sweep."""

    def __init__(self, omega: float = 1.0, tolerance=1e-9,
                 compute_error_every_n_iters=100, n_iters=1):
        super().__init__(tolerance, compute_error_every_n_iters, n_iters)
        _check_omega(omega)
        self.omega = omega

    def setup(self, A: ELL) -> SequentialGSState:
        return _sequential_setup(A, omega=self.omega, ordering="forward")

    def apply(self, state: SequentialGSState, u, b):
        return _sor_forward(state, u, b)


# ---------------------------------------------------------------------------
# Multicolor Gauss-Seidel


@dataclasses.dataclass(frozen=True)
class MulticolorGSState:
    """Per-color row panels of the ELL matrix, one entry per color: the
    color's rows (unpadded), their off-diagonal values (the diagonal slot
    zeroed), their columns and their diagonal."""

    rows: tuple   # (n_c,) int64 each
    data: tuple   # (n_c, K) each
    cols: tuple   # (n_c, K) each
    diag: tuple   # (n_c,) each
    omega: float
    symmetric: bool

    @property
    def n_colors(self) -> int:
        return len(self.rows)


def _color_panels(data_rows, cols_rows, rows):
    """(off-diagonal values, diagonal) of one color's rows; numpy or
    torch, the same arithmetic (a padded slot, col = row and value 0,
    adds zero to the diagonal)."""
    is_diag = cols_rows == rows[:, None]
    if isinstance(data_rows, np.ndarray):
        return (np.where(is_diag, 0, data_rows),
                np.where(is_diag, data_rows, 0).sum(axis=1))
    zero = torch.zeros((), dtype=data_rows.dtype, device=data_rows.device)
    return (torch.where(is_diag, zero, data_rows),
            torch.where(is_diag, data_rows, zero).sum(dim=1))


class MulticolorGaussSeidel(SmootherBase):
    """Multicolor Gauss-Seidel (red-black on the 5-point stencil) with
    over-relaxation ``omega`` and, ``symmetric``, the colors swept forward
    then backward. Colors come from ``greedy_coloring`` over the ELL
    pattern at setup, or from ``colors=``."""

    def __init__(self, omega: float = 1.0, symmetric: bool = True,
                 tolerance=1e-9, compute_error_every_n_iters=0, n_iters=1,
                 colors: np.ndarray | None = None):
        super().__init__(tolerance, compute_error_every_n_iters, n_iters)
        _check_omega(omega)
        self.omega = omega
        self.symmetric = symmetric
        self._colors = colors

    def setup(self, A: ELL) -> MulticolorGSState:
        n = A.n_rows
        data = A.data.cpu().numpy()
        cols = A.cols.cpu().numpy()
        colors = (np.asarray(self._colors) if self._colors is not None
                  else greedy_coloring(cols, data, n))
        n_colors = int(colors.max()) + 1 if n else 1
        per = {"rows": [], "data": [], "cols": [], "diag": []}
        for c in range(n_colors):
            rc = np.nonzero(colors == c)[0]
            off, diag = _color_panels(data[rc], cols[rc], rc)
            for key, arr in (("rows", rc), ("data", off), ("cols", cols[rc]),
                             ("diag", diag)):
                t = torch.from_numpy(np.ascontiguousarray(arr))
                if key in ("data", "diag"):
                    t = t.to(A.dtype)
                per[key].append(t.to(A.device))
        return MulticolorGSState(
            **{k: tuple(v) for k, v in per.items()},
            omega=self.omega, symmetric=self.symmetric)

    @staticmethod
    def refresh_state(state: MulticolorGSState,
                      A_data: torch.Tensor) -> MulticolorGSState:
        """New ELL values of the same pattern -> new color panels, on the
        device (the coloring is pattern-only and stays valid); used by
        ``multigrid.rebuild_hierarchy_values``."""
        offs, diags = zip(*(_color_panels(A_data[rows], cols, rows)
                            for rows, cols in zip(state.rows, state.cols)))
        return dataclasses.replace(state, data=offs, diag=diags)

    @staticmethod
    def _color_update(state: MulticolorGSState, u, b, c: int):
        """Update color c's rows of ``u`` in place."""
        rows = state.rows[c]
        offsum = torch.sum(state.data[c] * u[state.cols[c]], dim=1)
        gs = (b[rows] - offsum) / state.diag[c]
        u_c = u[rows]
        u.index_copy_(0, rows, u_c + state.omega * (gs - u_c))

    def apply(self, state: MulticolorGSState, u, b):
        order = list(range(state.n_colors))
        if state.symmetric:
            order = order + order[::-1]
        u = u.clone()
        for c in order:
            self._color_update(state, u, b, c)
        return u
