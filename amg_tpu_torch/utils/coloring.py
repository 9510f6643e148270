"""Graph coloring for the multicolor Gauss-Seidel sweep.

PyTorch port of ``amg_tpu/utils/coloring.py:19-61``. Rows of one color
share no matrix edge, so their Gauss-Seidel updates commute and run as one
vector step. Coloring runs on the host once per hierarchy setup.

``greedy_coloring`` is the greedy first-fit loop: rows in natural order,
each taking the smallest color that no neighbour already holds. As in JAX
it takes the native engine's loop first (``native/amgcore.cpp``
``amg_greedy_color``) and the Python loop where the engine is not
available; both give JAX's colors.
"""

from __future__ import annotations

import numpy as np

from amg_tpu_torch.native.bindings import greedy_coloring_native


def greedy_coloring(cols: np.ndarray, data: np.ndarray, n: int) -> np.ndarray:
    """Greedy first-fit coloring over an ELL pattern.

    Args:
      cols: (n, K) ELL column indices.
      data: (n, K) ELL values (zeros mark padding and are ignored).
      n: number of rows.

    Returns an int64 array (n,) of color ids from 0.
    """
    out = greedy_coloring_native(cols, data, n)
    return greedy_coloring_loop(cols, data, n) if out is None else out


def greedy_coloring_loop(cols: np.ndarray, data: np.ndarray,
                         n: int) -> np.ndarray:
    """``greedy_coloring``'s Python loop, the path without the native
    engine: the same colors."""
    cols = np.asarray(cols)
    rows = np.arange(n)[:, None]
    # each row's neighbours as Python lists, padding and the diagonal
    # pointed at a sentinel slot n that stays -1: lists index several
    # times faster than numpy scalars in the row loop, which is the
    # reference algorithm itself
    nbrs = np.where((np.asarray(data) != 0) & (cols != rows), cols,
                    n).tolist()
    colors = [-1] * (n + 1)
    for i, nb in enumerate(nbrs):
        used = {colors[j] for j in nb}
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return np.asarray(colors[:n], dtype=np.int64)


def red_black_2d(n: int) -> np.ndarray:
    """Red-black coloring of the n x n 5-point stencil, lexicographic dofs
    (dof = j*n + i): color = (i + j) % 2."""
    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return ((i + j) % 2).reshape(-1).astype(np.int64)


def four_color_2d(n: int) -> np.ndarray:
    """Four-coloring (2x2 blocks) that decouples 9-point stencils:
    color = (i % 2) + 2 * (j % 2)."""
    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return ((i % 2) + 2 * (j % 2)).reshape(-1).astype(np.int64)
