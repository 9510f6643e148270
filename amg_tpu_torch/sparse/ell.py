"""ELL (padded-row) sparse matrix: the general path's device format.

PyTorch port of ``amg_tpu/sparse/ell.py:31-163``. A sparse matrix is two
dense ``(n_rows, K)`` tensors, values and column indices, with every row
padded to the widest row's K, so a mat-vec is a gather, a multiply and a
row sum. CSR stays the host setup format (scipy, ``ELL.from_scipy``).

Padding convention, as in the JAX package: a padded slot holds ``col =
row`` clamped to ``n_cols - 1`` and ``val = 0``, so it gathers in range and
adds exactly zero. ``from_scipy`` sums duplicates, sorts each row's
columns and drops stored zeros, so K and the slot order are JAX's.

``cols`` is int64 (it indexes without a cast on every torch version);
checkpoints store it as int32, as JAX does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from amg_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ELL:
    """Padded-row sparse matrix.

    Attributes:
      data:  (n_rows, K) values; padded slots are 0.
      cols:  (n_rows, K) int64 column indices; padded slots hold the row
             index clamped to the columns.
      shape: (n_rows, n_cols).
    """

    data: torch.Tensor
    cols: torch.Tensor
    shape: tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def row_width(self) -> int:
        """K: the padded entries per row."""
        return self.data.shape[1]

    @property
    def nnz(self) -> int:
        """Number of stored (non-padding) entries; reads the device."""
        return int(torch.count_nonzero(self.data))

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device=None, dtype=None) -> "ELL":
        """The same matrix on ``device`` (values in ``dtype`` if given)."""
        return ELL(data=self.data.to(device=device, dtype=dtype),
                   cols=self.cols.to(device=device), shape=self.shape)

    def astype(self, dtype) -> "ELL":
        return ELL(data=self.data.to(dtype), cols=self.cols, shape=self.shape)

    # -- device ops ---------------------------------------------------------

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x``: gather, multiply, row sum (the reference's Eigen SpMV
        in the residual and rss, multigrid.hpp:272-274, common.hpp:17-27)."""
        return torch.sum(self.data * x[self.cols], dim=1)

    def _is_diag(self) -> torch.Tensor:
        rows = torch.arange(self.n_rows, device=self.cols.device)
        return self.cols == rows[:, None]

    def matvec_offdiag_and_diag(self, x: torch.Tensor):
        """(off-diagonal product, diagonal): the row sum split as the
        reference smoother's ``matvecprod`` splits it
        (smoother.hpp:101-117)."""
        is_diag = self._is_diag()
        zero = torch.zeros((), dtype=self.data.dtype, device=self.data.device)
        prod = torch.sum(torch.where(is_diag, zero, self.data * x[self.cols]),
                         dim=1)
        diag = torch.sum(torch.where(is_diag, self.data, zero), dim=1)
        return prod, diag

    def diag(self) -> torch.Tensor:
        """The diagonal."""
        zero = torch.zeros((), dtype=self.data.dtype, device=self.data.device)
        return torch.sum(torch.where(self._is_diag(), self.data, zero), dim=1)

    def to_dense(self) -> torch.Tensor:
        """Densify (small matrices only: oracles, the coarsest level). The
        padded slots add zero, so the sum does not depend on the order."""
        n, m = self.shape
        out = torch.zeros((n, m), dtype=self.data.dtype,
                          device=self.data.device)
        rows = torch.arange(n, device=self.cols.device)[:, None].expand_as(
            self.cols)
        return out.index_put_((rows, self.cols), self.data, accumulate=True)

    # -- host constructors ----------------------------------------------------

    @staticmethod
    def from_coo(rows, cols, vals, shape, dtype=None, sort_cols=True,
                 device=None) -> "ELL":
        """From host COO triplets, duplicates summed (Eigen
        setFromTriplets, interpolator.hpp:130)."""
        coo = sp.coo_matrix(
            (np.asarray(vals), (np.asarray(rows), np.asarray(cols))),
            shape=shape)
        return ELL.from_scipy(coo.tocsr(), dtype=dtype, sort_cols=sort_cols,
                              device=device)

    @staticmethod
    def from_scipy(mat, dtype=None, sort_cols=True, device=None) -> "ELL":
        """From a scipy sparse matrix (the host setup path): duplicates
        summed, columns ascending within a row (Eigen's CSC inner order,
        which the reference's Gauss-Seidel relies on), stored zeros
        dropped so K is the true widest row. ``device`` None means
        ``"cuda"``."""
        device = resolve_device(device)
        csr = mat.tocsr()
        csr.sum_duplicates()
        if sort_cols:
            csr.sort_indices()
        csr.eliminate_zeros()
        n, m = csr.shape
        deg = np.diff(csr.indptr)
        K = max(int(deg.max()) if n else 0, 1)
        data = np.zeros((n, K), dtype=csr.data.dtype)
        pad_col = np.minimum(np.arange(n, dtype=np.int64), max(m - 1, 0))
        cols = np.tile(pad_col[:, None], (1, K))
        row_idx = np.repeat(np.arange(n), deg)
        pos = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], deg)
        data[row_idx, pos] = csr.data
        cols[row_idx, pos] = csr.indices
        data = torch.from_numpy(data)
        if dtype is not None:
            data = data.to(dtype)
        return ELL(data=data.to(device),
                   cols=torch.from_numpy(cols).to(device), shape=(n, m))

    def to_scipy(self) -> sp.csr_matrix:
        """Back to scipy CSR on the host (setup and oracle use)."""
        data = self.data.cpu().numpy()
        cols = self.cols.cpu().numpy()
        n, K = data.shape
        rows = np.repeat(np.arange(n), K)
        mat = sp.coo_matrix((data.ravel(), (rows, cols.ravel())),
                            shape=self.shape)
        mat.sum_duplicates()
        mat = mat.tocsr()
        mat.eliminate_zeros()
        return mat
