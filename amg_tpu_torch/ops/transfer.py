"""Grid-transfer operators in their host scipy form.

PyTorch port of ``amg_tpu/ops/transfer.py:98`` (``linear_interp_1d``): the
1-D linear interpolation whose Kronecker square is the structured
hierarchy's prolongation. The distributed solver's setup builds its scipy
Galerkin chain with it (parallel/structured_dist.py). The interpolator
classes are ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def linear_interp_1d(n_f: int, n_c: int) -> sp.csr_matrix:
    """1-D linear interpolation for n_f = 2*n_c + 1 interior points: column
    j has [0.5, 1, 0.5] at rows 2j, 2j+1, 2j+2."""
    if n_f != 2 * n_c + 1:
        raise ValueError(f"linear_interp_1d needs n_f = 2 n_c + 1, got "
                         f"({n_f}, {n_c})")
    rows = np.concatenate([2 * np.arange(n_c), 2 * np.arange(n_c) + 1,
                           2 * np.arange(n_c) + 2])
    cols = np.concatenate([np.arange(n_c)] * 3)
    vals = np.concatenate([np.full(n_c, 0.5), np.full(n_c, 1.0),
                           np.full(n_c, 0.5)])
    return sp.coo_matrix((vals, (rows, cols)), shape=(n_f, n_c)).tocsr()
