"""The port's ELL (amg_tpu_torch/sparse/ell.py) against amg_tpu's on the
same scipy matrices, f64 on the CPU: ``from_scipy`` gives JAX's ``data``
and ``cols`` array for array (K, the padding convention and the slot
order), and the device ops agree within 1e-14."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from amg_tpu.sparse.ell import ELL as JELL
from amg_tpu_torch.models import poisson
from amg_tpu_torch.ops.transfer import (BilinearInterpolator2D,
                                        LinearInterpolator)
from amg_tpu_torch.sparse.ell import ELL

torch.set_num_threads(1)

RTOL = 1e-14


def _random_with_zeros_and_duplicates():
    """A rectangular COO matrix with duplicate entries and stored zeros."""
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 30, 200)
    cols = rng.integers(0, 20, 200)
    vals = rng.standard_normal(200)
    vals[::7] = 0.0
    return sp.coo_matrix((vals, (rows, cols)), shape=(30, 20))


def _galerkin_level(n, interp):
    A = poisson.laplacian_scipy(n)
    n_H = interp.coarse_size(n * n)
    P, R = interp.make_operators_scipy(n * n, n_H)
    return (R @ (A @ P)).tocsr()


MATRICES = {
    "laplacian": lambda: poisson.laplacian_scipy(7),
    "linear_P": lambda: LinearInterpolator().make_operators_scipy(49, 24)[0],
    "linear_R": lambda: LinearInterpolator().make_operators_scipy(50, 24)[1],
    "bilinear_P": lambda: BilinearInterpolator2D(7).make_operators_scipy(
        49, 9)[0],
    "bilinear_R_fw": lambda: BilinearInterpolator2D(
        7, full_weighting=True).make_operators_scipy(49, 9)[1],
    "galerkin_linear": lambda: _galerkin_level(9, LinearInterpolator()),
    "random": _random_with_zeros_and_duplicates,
}


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_from_scipy_equals_jax(name):
    M = MATRICES[name]()
    ref = JELL.from_scipy(M)
    got = ELL.from_scipy(M, device="cpu")
    assert got.shape == ref.shape and got.row_width == ref.row_width
    assert got.cols.dtype == torch.int64
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(ref.cols))
    assert got.nnz == ref.nnz


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=RTOL * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_ops_equal_jax(name):
    M = MATRICES[name]()
    ref = JELL.from_scipy(M)
    got = ELL.from_scipy(M, device="cpu")
    x = np.random.default_rng(1).standard_normal(M.shape[1])
    _close(got.matvec(torch.from_numpy(x)), ref.matvec(jnp.asarray(x)))
    _close(got.to_dense(), ref.to_dense())
    if M.shape[0] == M.shape[1]:
        _close(got.diag(), ref.diag())
        for g, r in zip(got.matvec_offdiag_and_diag(torch.from_numpy(x)),
                        ref.matvec_offdiag_and_diag(jnp.asarray(x))):
            _close(g, r)
    assert abs(got.to_scipy() - ref.to_scipy()).max() == 0.0


def test_from_coo_sums_duplicates_and_pads():
    got = ELL.from_coo([0, 0, 1, 2], [1, 1, 0, 2], [1.0, 2.0, 5.0, 0.0],
                       (3, 3), device="cpu")
    ref = JELL.from_coo([0, 0, 1, 2], [1, 1, 0, 2], [1.0, 2.0, 5.0, 0.0],
                        (3, 3))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(ref.cols))
    # row 2 holds only a stored zero: one padded slot, col = row, val 0
    assert got.cols[2, 0] == 2 and got.data[2, 0] == 0.0


def test_dtype_and_device_moves():
    E = poisson.laplacian(5, device="cpu")
    assert E.row_width == 5 and E.shape == (25, 25)
    F = E.astype(torch.float32)
    assert F.dtype == torch.float32 and F.cols is E.cols
    G = E.to("cpu", torch.float32)
    assert G.dtype == torch.float32 and G.device.type == "cpu"
    ref = JELL.from_scipy(poisson.laplacian_scipy(5))
    np.testing.assert_array_equal(E.data.numpy(), np.asarray(ref.data))


@pytest.mark.parametrize("n", [7, 35, 64])
def test_poisson_members_equal_jax(n):
    from amg_tpu.models import poisson as jpoisson

    A, b = poisson.poisson2d(n, device="cpu")
    jA, jb = jpoisson.poisson2d(n)
    np.testing.assert_array_equal(A.data.numpy(), np.asarray(jA.data))
    np.testing.assert_array_equal(A.cols.numpy(), np.asarray(jA.cols))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    # to f64 roundoff: the host rhs within JAX's own rhs_device tolerance,
    # so JAX's rhs_device within twice that
    bd = poisson.rhs_device(n, device="cpu")
    np.testing.assert_allclose(bd.numpy(), b.numpy(), rtol=1e-14, atol=0)
    np.testing.assert_allclose(bd.numpy(), np.asarray(jpoisson.rhs_device(n)),
                               rtol=2e-14, atol=0)
    assert poisson.laplacian(n, torch.float32, "cpu").dtype == torch.float32


INTERPOLATORS = {
    "linear_odd": (lambda m: m.LinearInterpolator(), 49),
    "linear_even": (lambda m: m.LinearInterpolator(), 50),
    "bilinear": (lambda m: m.BilinearInterpolator2D(7), 49),
    "bilinear_fw": (lambda m: m.BilinearInterpolator2D(
        7, full_weighting=True), 49),
}


@pytest.mark.parametrize("name", sorted(INTERPOLATORS))
def test_interpolators_equal_jax(name):
    from amg_tpu.ops import transfer as jtransfer

    from amg_tpu_torch.ops import transfer

    make, n_h = INTERPOLATORS[name]
    got, ref = make(transfer), make(jtransfer)
    n_H = got.coarse_size(n_h)
    assert n_H == ref.coarse_size(n_h)
    for g, r in zip(got.make_operators_scipy(n_h, n_H),
                    ref.make_operators_scipy(n_h, n_H)):
        assert g.shape == r.shape and abs(g - r).max() == 0.0
    got.make_operators(n_h, n_H, 0, device="cpu")
    ref.make_operators(n_h, n_H, 0)
    x = np.random.default_rng(2).standard_normal(n_H)
    y = np.random.default_rng(3).standard_normal(n_h)
    _close(got.prolongation(torch.from_numpy(x), 0),
           ref.prolongation(jnp.asarray(x), 0))
    _close(got.restriction(torch.from_numpy(y), 0),
           ref.restriction(jnp.asarray(y), 0))
    assert got.get_P(0).shape == (n_h, n_H) and got.get_R(0).shape == (n_H,
                                                                       n_h)


def test_bilinear_rejects_even_sides():
    with pytest.raises(ValueError, match="odd grid side"):
        BilinearInterpolator2D(8).coarse_size(64)
    with pytest.raises(ValueError, match="square"):
        BilinearInterpolator2D(7).coarse_size(50)


def test_entry_points_default_to_the_card(monkeypatch):
    """device None means "cuda": without a card the ELL constructors and
    the ELL pipeline's entry points raise instead of using the CPU."""
    from amg_tpu_torch import Multigrid, build_hierarchy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    M = poisson.laplacian_scipy(3)
    for call in (lambda: ELL.from_scipy(M), lambda: poisson.laplacian(3),
                 lambda: poisson.poisson2d(3), lambda: build_hierarchy(M, 2),
                 lambda: Multigrid(None, None, M, np.ones(9), 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
