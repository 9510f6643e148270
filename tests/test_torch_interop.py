"""The carry-across functions of amg_tpu_torch.interop place their tensors
as every entry point of the port does: ``device`` None means ``"cuda"``,
which raises without a CUDA device; ``device="cpu"`` builds on the CPU.
Bad inputs raise ValueError before any device is chosen.

The inputs are numpy arrays taken from the port's own CPU hierarchy, so no
JAX state is needed. CUDA is reported absent through monkeypatch, so the
checks hold on a machine with a card too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from amg_tpu_torch import interop
from amg_tpu_torch.models import poisson
from amg_tpu_torch.multigrid import Hierarchy, _map_tensors
from amg_tpu_torch.ops.transfer import LinearInterpolator
from amg_tpu_torch.parallel.ell_dist import ShardedOp
from amg_tpu_torch.parallel.structured_dist import DistConfig
from amg_tpu_torch.sparse.ell import ELL
from amg_tpu_torch.structured import build_stencil_hierarchy_device

torch.set_num_threads(1)

SIDE = 15


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _hier_arrays():
    h = build_stencil_hierarchy_device(SIDE, dtype=torch.float64,
                                       device="cpu")
    P1s = [getattr(h, f"P1_{l}").numpy() for l in range(h.n_levels - 1)]
    # the port keeps LAPACK's 1-based pivots; interop takes JAX's 0-based
    return (h.sides, list(h.w33s), h.coarse_lu.numpy(),
            h.coarse_piv.numpy() - 1, P1s)


def _planes():
    return np.random.default_rng(0).random((3, 3, SIDE, SIDE))


def _df():
    hi = np.random.default_rng(1).standard_normal((4, 8, 8)).astype(
        np.float32)
    return hi, (hi * 1e-8).astype(np.float32)


def _cfg():
    sides = (SIDE, 7, 3)
    return dataclasses.asdict(DistConfig(
        n_devices=2, sides=sides, blocks=(8,), n_sharded=1,
        w33s=(((0.0, -1.0, 0.0), (-1.0, 4.0, -1.0), (0.0, -1.0, 0.0)),)))


def _ell_arrays(M):
    E = ELL.from_scipy(M, device="cpu")
    return E.data.numpy(), E.cols.numpy().astype(np.int32), E.shape


def _ell_levels():
    """A two-level ELL hierarchy's arrays, int32 columns as JAX keeps them."""
    A = poisson.laplacian_scipy(5)
    P, R = LinearInterpolator().make_operators_scipy(25, 12)
    return [{"A": _ell_arrays(A), "P": _ell_arrays(P), "R": _ell_arrays(R)},
            {"A": _ell_arrays((R @ A @ P).tocsr())}]


CALLS = {
    "hierarchy_from_numpy":
        lambda **kw: interop.hierarchy_from_numpy(*_hier_arrays(), **kw),
    "dist_hierarchy_from_numpy":
        lambda **kw: interop.dist_hierarchy_from_numpy(
            _cfg(), *_hier_arrays(), **kw),
    "planes_from_numpy": lambda **kw: interop.planes_from_numpy(_planes(),
                                                                **kw),
    "df32_from_numpy": lambda **kw: interop.df32_from_numpy(*_df(), **kw),
    "ell_from_numpy": lambda **kw: interop.ell_from_numpy(
        *_ell_arrays(poisson.laplacian_scipy(4)), **kw),
    "ell_hierarchy_from_numpy":
        lambda **kw: interop.ell_hierarchy_from_numpy(_ell_levels(), **kw),
    "dist_planes_from_numpy": lambda **kw: interop.dist_planes_from_numpy(
        np.zeros((3, 3, 16, SIDE)), 2, **kw),
    "sharded_op_from_numpy": lambda **kw: interop.sharded_op_from_numpy(
        np.ones((8, 3)), np.zeros((8, 3), np.int32), 4, 4, 1, **kw),
}


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (ELL, ShardedOp)):
        return [out.data, out.cols]
    if isinstance(out, Hierarchy):
        ts = []
        _map_tensors((out.levels, out.coarse), ts.append)
        return ts
    if isinstance(out, torch.nn.Module):
        return list(out.buffers())
    if isinstance(out, tuple) and len(out) == 2 and isinstance(
            out[1], torch.nn.Module):
        return list(out[1].buffers())
    return [out.hi, out.lo]


@pytest.mark.parametrize("name", sorted(CALLS))
def test_no_device_means_cuda(name, no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CALLS[name]()


@pytest.mark.parametrize("name", sorted(CALLS))
def test_cpu_when_asked(name, no_cuda):
    ts = _tensors(CALLS[name](device="cpu"))
    assert ts and all(t.device.type == "cpu" for t in ts)


def test_bad_input_raises_before_the_device(no_cuda):
    with pytest.raises(ValueError):
        interop.planes_from_numpy(np.zeros((3, 3, 5, 4)))
    hi, lo = _df()
    with pytest.raises(ValueError):
        interop.df32_from_numpy(hi.astype(np.float64), lo)
    data, cols, shape = _ell_arrays(poisson.laplacian_scipy(4))
    with pytest.raises(ValueError):
        interop.ell_from_numpy(data, cols[:, :-1], shape)
    with pytest.raises(ValueError):
        interop.ell_from_numpy(data, cols.astype(np.float64), shape)
    with pytest.raises(ValueError):
        interop.dist_planes_from_numpy(np.zeros((3, 3, 15, SIDE)), 2)
    with pytest.raises(ValueError):
        interop.sharded_op_from_numpy(np.ones((8, 3)),
                                      np.full((8, 3), 6), 4, 4, 1)


def test_ell_hierarchy_keeps_the_arrays():
    levels = _ell_levels()
    h = interop.ell_hierarchy_from_numpy(levels, device="cpu")
    assert h.n_levels == 2 and h.levels[1].P is None
    for lev, spec in zip(h.levels, levels):
        data, cols, shape = spec["A"]
        assert lev.A.shape == shape and lev.A.cols.dtype == torch.int64
        np.testing.assert_array_equal(lev.A.data.numpy(), data)
        np.testing.assert_array_equal(lev.A.cols.numpy(), cols)
